"""Train-step factories for the training driver (counterpart of
``repro.launch.steps``).

The train step is loss and gradient -> global-norm clip -> optimizer
update -> health gate -> apply.  ``do_subspace_update`` is a Python bool
picked per step by the loop.  Where the JAX step returns new arrays, the
port works in place to stay inside one card's memory at llama-7b: the
clip scales the gradients in place, and the optimizer releases each
leaf's gradient (and tap) as soon as that leaf's update exists
(``update`` consumes them), so the updates take the bytes the
gradients give back and no tree of gradients is held beside them.

The gate is the JAX package's ``guarded_apply``: the update norm is summed
on the device, the :class:`~repro_torch.core.health.HealthReport` is read
to the host in one copy, and then the held updates are either added into
the parameters in place or dropped with the new optimizer state.  The
optimizer writes new M, V, S and ``lam_prev`` tensors and never its
inputs, so a quarantined step returns the old state whole: params, S, M,
V, ``lam_prev``, ``step`` and ``n_updates`` bit-identical.

With ``accum`` > 1 the batch is split into microbatches whose gradients
add into one fp32 accumulator, which the clip and the optimizer then take
as G.  With ``grad_fused`` the plain steps take the grad-fused backward:
the taggable matmuls emit each low-rank leaf's [A; colnorms] tap, which
feeds the clip and the optimizer.  ``inject`` (``repro_torch.core.health``
codes) scales the loss fed to the backward by NaN (nan-grad; on all three
backward routes, the taps with it) or multiplies every update by
``-LOSS_SPIKE_AMP`` before the gate (loss-spike).

Under a mesh (an optimizer built with ``mesh`` and ``param_specs``) every
rank takes the same batch and runs the forward and backward whole, so
the global-norm clip is local.  Each rank then hands the optimizer its
shard of each low-rank leaf's gradient (a view by the leaf's program
layout, ``optimizer.grad_specs``: no communication), the optimizer fires
only its programs' declared rounds, and the step all-gathers each
sharded leaf's update shards into the whole update (one gather per leaf,
outside the program: the port's counterpart of GSPMD's reshard around
the JAX package's ``shard_map``).  The gate's verdict is MAX-all-reduced
over the mesh before its one host read, so every rank applies or drops
the step alike.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import health as health_lib
from repro_torch.core import program as program_lib
from repro_torch.core.lowrank_adam import MatrixOptState
from repro_torch.core.subtrack import (GradientTransform, OptState,
                                       tree_leaves, tree_map)
from repro_torch.distributed import sharding
from repro_torch.models.api import ModelBundle
from repro_torch.models.common import tap_seed


GATE_RANGE = "health_gate"   # the profiler range around the step's gate


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def checkpoint_descriptors(params, optimizer: GradientTransform):
    """Per-param-leaf StateDescriptor tree for ``optimizer``'s state: the
    records a checkpoint embeds and the targets an elastic restore
    transposes onto (all dense for the rank-less baselines)."""
    return program_lib.state_leaf_descriptors(
        params, optimizer.config, mesh=optimizer.mesh,
        param_specs=optimizer.param_specs)


def _unflatten(like, leaves: list) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, accumulated in fp32."""
    total = sum(torch.linalg.vector_norm(x, dtype=torch.float32) ** 2
                for x in tree_leaves(tree))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, taps=None):
    """Scale every gradient by min(1, max_norm / ||grads||), in place.  A
    bf16 gradient is scaled in fp32 and rounded back, as the JAX package's
    ``(g.astype(f32) * scale).astype(g.dtype)``.  ``taps`` (a tree
    mirroring ``grads``, None at untapped leaves) lets a tapped leaf
    contribute ``sum(tap[..., -1, :])``, its ||G||_F^2 from the backward,
    instead of a reduction over G.  Returns (grads, norm)."""
    if taps is None:
        norm = global_norm(grads)
    else:
        sq = sum(torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
                 if t is None else t[..., -1, :].sum()
                 for g, t in zip(tree_leaves(grads), tree_leaves(taps)))
        norm = torch.sqrt(sq)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, norm


def _seeded(loss: torch.Tensor, gscale) -> torch.Tensor:
    """The loss fed to the backward: scaled by ``gscale`` (NaN under the
    nan-grad injection), so every gradient scales with it while the true
    loss still reaches the metrics."""
    return loss if gscale is None else loss * gscale


def value_and_grad(bundle: ModelBundle, params, batch, remat: str,
                   gscale=None):
    """(loss, metrics, grads) with grads mirroring ``params``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = bundle.loss(params, batch, remat=remat)
        grads = torch.autograd.grad(_seeded(loss, gscale), leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, _unflatten(params, list(grads))


def accumulated_grads(bundle: ModelBundle, params, batch, remat: str,
                      accum: int, gscale=None):
    """(loss, metrics, grads) over ``accum`` microbatches, the batch's
    leading axis split evenly (it must divide).  Each microbatch's
    gradient is added into an fp32 accumulator as ``acc += g.float() /
    accum``, the JAX package's order of rounding, and freed before the
    next backward; the loss is ``sum(loss_i / accum)``, the metrics the
    last microbatch's.  ``accum == 1`` is :func:`value_and_grad`.
    ``gscale`` seeds every microbatch's backward."""
    if accum == 1:
        return value_and_grad(bundle, params, batch, remat, gscale)
    rows = {v.shape[0] for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % accum:
        raise ValueError(f"batch of {sorted(rows)} rows does not split into "
                         f"{accum} microbatches")
    micro = {k: v.chunk(accum, dim=0) for k, v in batch.items()}
    acc: list = [None] * len(tree_leaves(params))
    loss = 0.0
    for i in range(accum):
        loss_i, metrics, g = value_and_grad(
            bundle, params, {k: v[i] for k, v in micro.items()}, remat,
            gscale)
        g = tree_leaves(g)
        for j in range(len(g)):
            x = g[j].float() / accum
            g[j] = None                           # this microbatch's, freed
            acc[j] = x if acc[j] is None else acc[j].add_(x)
        del g, x
        loss = loss + loss_i / accum
    return loss, metrics, _unflatten(params, acc)


# ---------------------------------------------------------------------------
# Grad-fused tap collection
# ---------------------------------------------------------------------------
#
# The taggable matmul sites of the decoder family
# (repro_torch.models.transformer): the per-layer attention and MLP
# projections plus the untied lm_head.  MLA attention and MoE blocks have
# no taggable dense path: their sites are absent, and so is a tied
# config's lm_head leaf (``_site_get`` finds none), as in the JAX package.


def _tap_paths(cfg) -> list[tuple[str, ...]]:
    paths: list[tuple[str, ...]] = []
    if getattr(cfg, "attn_type", None) != "mla":
        paths += [("layers", "attn", k) for k in ("wq", "wk", "wv", "wo")]
    if getattr(cfg, "moe", None) is None:
        paths += [("layers", "mlp", k) for k in ("w_gate", "w_up", "w_down")]
    paths.append(("lm_head",))
    return paths


def _site_get(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _site_set(tree, path, val):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = val


def _none_like(tree):
    """The same nested-dict skeleton with every leaf None: the
    all-untapped taps tree."""
    if isinstance(tree, dict):
        return {k: _none_like(v) for k, v in tree.items()}
    return None


def tapped_grads(bundle: ModelBundle, state: TrainState, batch,
                 remat: str, gscale=None):
    """(loss, metrics, grads, taps) from one backward over the params and
    the zero seeds: the seeds' gradients are the per-leaf [A; colnorms]
    panels (``tapped_matmul``).  ``taps`` mirrors the params, None at
    every untapped leaf; it is None when no site is a low-rank leaf.
    ``gscale`` seeds the backward, so the taps scale with the
    gradients."""
    sites = []
    for path in _tap_paths(bundle.cfg):
        p = _site_get(state.params, path)
        st = _site_get(state.opt.inner, path)
        if p is None or not isinstance(st, MatrixOptState):
            continue  # absent leaf or dense plan
        sites.append((path, st.S, st.M.shape[-1]))
    if not sites:
        return (*value_and_grad(bundle, state.params, batch, remat, gscale),
                None)

    seeds = [tap_seed(S.shape[-1], n, S.shape[:-2], S.device
                      ).requires_grad_() for _, S, n in sites]
    taps_in: dict = {}
    for (path, S, _), seed in zip(sites, seeds):
        _site_set(taps_in, path, (S, seed))
    leaves = tree_leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = bundle.loss_taps(state.params, batch, taps_in,
                                         remat=remat)
        out = torch.autograd.grad(_seeded(loss, gscale), leaves + seeds)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = _unflatten(state.params, list(out[:len(leaves)]))
    taps = _none_like(state.params)
    for (path, _, _), tap in zip(sites, out[len(leaves):]):
        _site_set(taps, path, tap)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads, taps


def _over_specs(fn, tree, specs):
    """Replace each leaf x of ``tree`` whose spec is not None by
    ``fn(x, spec)``, in place, one leaf at a time."""
    for k, x in tree.items():
        if isinstance(x, dict):
            _over_specs(fn, x, specs[k])
        elif x is not None and specs[k] is not None:
            tree[k] = fn(x, specs[k])


def apply_updates(params, updates) -> None:
    """Add each held update into its parameter in place (updates mirror
    the params; None where a leaf gets none), releasing each once added."""
    for k, u in updates.items():
        if isinstance(u, dict):
            apply_updates(params[k], u)
        elif u is not None:
            params[k].add_(u)
            updates[k] = None


def make_train_step(bundle: ModelBundle, optimizer: GradientTransform, *,
                    clip_norm: float = 1.0, accum: int = 1,
                    remat: str = "full", grad_fused: bool = False,
                    mesh=None):
    """train_step(state, batch, lr, *, do_subspace_update=False,
    inject=INJECT_NONE, eta_scale=1.0) -> (state, metrics).  A healthy
    step adds its updates into the parameters of ``state`` in place and
    returns them with the new optimizer state; a quarantined one returns
    ``state`` itself, untouched.  The metrics carry the true loss, the
    gradient norm, ``lr``, and the health report's entries
    (``health.report_metrics``: ``update_norm``, ``sigma``, ``theta``,
    ``theta_clamped``, ``geo_degenerate``, ``quarantined``), as CPU
    scalars from the gate's one host read.

    ``accum`` > 1 splits the batch into that many microbatches
    (:func:`accumulated_grads`); the optimizer then gets fp32 G.

    ``grad_fused`` runs the k-1-of-k plain steps through the grad-fused
    backward (:func:`tapped_grads`): the taps serve the global-norm clip
    and the optimizer's plain step in place of a projection pass over G.
    Tracking steps take the plain backward, and so does every step under
    ``accum`` > 1 (the taps are not additive across microbatches: sum_i
    ||G_i||^2 != ||sum_i G_i||^2), as in the JAX package.  A bundle without
    ``loss_taps`` raises rather than fall back.

    ``mesh`` (a :class:`~repro_torch.distributed.context.MeshContext`;
    the optimizer's own by default) is the mesh whose ranks run this step
    together: the gradient shards, the update gather and the one verdict
    of the module notes."""
    if grad_fused and bundle.loss_taps is None:
        raise NotImplementedError(f"{bundle.cfg.name} exposes no taggable "
                                  "matmuls for the grad-fused backward")
    use_taps = grad_fused and accum == 1
    mesh = mesh if mesh is not None else optimizer.mesh
    if (optimizer.mesh is not None and mesh is not None
            and optimizer.mesh != mesh):
        raise ValueError("the optimizer was built on another mesh")

    def train_step(state: TrainState, batch, lr: float, *,
                   do_subspace_update: bool = False,
                   inject: int = health_lib.INJECT_NONE,
                   eta_scale: float = 1.0):
        gscale = (float("nan") if inject == health_lib.INJECT_NAN_GRAD
                  else None)
        taps = None
        if use_taps and not do_subspace_update:
            loss, metrics, grads, taps = tapped_grads(bundle, state, batch,
                                                      remat, gscale)
        else:
            loss, metrics, grads = accumulated_grads(
                bundle, state.params, batch, remat, accum, gscale)
        grads, gnorm = clip_by_global_norm(grads, clip_norm, taps=taps)
        if taps is not None:
            # the clip scaled G by s: A scales by s, the squared column
            # norms by s^2 (in place)
            s = torch.clamp_max(clip_norm / torch.clamp_min(gnorm, 1e-12),
                                1.0)
            for t in tree_leaves(taps):
                if t is not None:
                    t[..., :-1, :].mul_(s)
                    t[..., -1, :].mul_(s * s)
        with torch.no_grad():
            specs = (optimizer.grad_specs(state.params)
                     if optimizer.param_specs is not None else None)
            if specs is not None:
                # this rank's shard of each sharded leaf: a view
                _over_specs(lambda g, sp: sharding.local_view(g, sp, mesh),
                            grads, specs)
            # the update frees grads and taps leaf by leaf: the held
            # updates take the gradients' place
            updates, opt, diag = optimizer.update(
                grads, state.opt, state.params, lr,
                do_subspace_update=do_subspace_update, taps=taps,
                with_health=True, eta_scale=eta_scale)
            del grads, taps
            if specs is not None:
                # the whole update from every rank's shard, leaf by leaf
                _over_specs(lambda u, sp: sharding.gather(u, sp, mesh),
                            updates, specs)
            held = [u for u in tree_leaves(updates) if u is not None]
            if inject == health_lib.INJECT_LOSS_SPIKE:
                for u in held:   # a bf16 u is scaled in fp32, rounded once
                    u.mul_(-health_lib.LOSS_SPIKE_AMP)
            # the gate: the update norm and one host read of the report
            # (a profiler range, so launch/profile_train.py can time it)
            with torch.profiler.record_function(GATE_RANGE):
                # one norm kernel per leaf: on an H100 torch._foreach_norm
                # ran 1.3x to ~90x slower on these large tensors (PERF.md)
                usq = torch.zeros((), dtype=torch.float32,
                                  device=loss.device)
                for u in held:
                    usq = usq + torch.linalg.vector_norm(
                        u, dtype=torch.float32) ** 2
                del held
                report = health_lib.report_to_host(health_lib.agree_over(
                    health_lib.make_report(loss, gnorm, torch.sqrt(usq),
                                           diag),
                    None if mesh is None else mesh.world))
            if report.ok:
                apply_updates(state.params, updates)
                state = TrainState(params=state.params, opt=opt)
            del updates, opt    # a quarantined step drops both
        metrics = dict(metrics, loss=report.loss, grad_norm=report.grad_norm,
                       lr=lr, **health_lib.report_metrics(report))
        return state, metrics

    return train_step


def make_warm_start(bundle: ModelBundle, optimizer: GradientTransform,
                    remat: str = "full"):
    """warm_start(state, batch) -> (state, loss): installs S_0 from the
    first gradient and surfaces the warm-start loss."""

    def warm(state: TrainState, batch):
        loss, _, grads = value_and_grad(bundle, state.params, batch, remat)
        with torch.no_grad():
            opt = optimizer.warm_start(state.opt, grads)
        return TrainState(params=state.params, opt=opt), loss

    return warm


def default_rank(d_model: int) -> int:
    """Rank ladder for archs without a paper rank (as the JAX package)."""
    if d_model >= 6144:
        return 1024
    if d_model >= 2048:
        return 512
    if d_model >= 1024:
        return 256
    return 128
