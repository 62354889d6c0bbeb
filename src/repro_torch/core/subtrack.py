"""SubTrack++ as a tree-level gradient transform, plus the low-rank
baselines the paper compares against, sharing the same machinery.

Counterpart of ``repro.core.subtrack`` on one device.  The protocol is the
JAX package's:

* ``init(params)`` — zero state per leaf (params: nested dicts of tensors);
* ``warm_start(state, grads)`` — installs S_0 from the first gradient
  (Alg. 1 line 1);
* ``update(grads, state, params, lr, do_subspace_update)`` — returns
  ``(updates, new_state)``, and the step's health diagnostic with
  ``with_health=True``; updates are added to the params.
  ``do_subspace_update`` is a Python bool picked per step by the loop.

Each low-rank leaf runs as ONE batched call over its stack dims (one kernel
launch per leaf with ``use_kernels``).  Same-shape leaves are not
concatenated into a bucket as the JAX package does: the concatenation
would copy every gradient, parameter and state of the bucket (tens of GB
at llama-7b), and per-matrix results are the same either way
(``bucket_leaves=True`` raises).

With ``mesh`` and ``param_specs`` every leaf runs its StepProgram
(``repro_torch.core.program``): replicated, column, row, row-rs or grass,
each rank on its own shards of G, S, M and V, the program's declared
rounds its only collectives.  ``method="grass"`` keeps a one-hot
row-selection basis, and its projection is the program's ``sel_gather``
round (a gather of G's rows), not a kernel.

Flag matrix (as the JAX package):
    SubTrack++           method=grassmann, projection_aware=True,  recovery=True
    Grassmannian-only    method=grassmann, projection_aware=False, recovery=False
    GaLore               method=svd,       projection_aware=False, recovery=False
    Fira                 method=svd,       projection_aware=False, recovery=True
    GoLore               method=random,    projection_aware=False, recovery=False
    OSD                  method=osd,       projection_aware=False, recovery=False
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import health as health_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import program as program_lib
from repro_torch.core import subspace as sub
from repro_torch.core.lowrank_adam import (AdamHP, MatrixOptState,
                                           dense_adam_step,
                                           init_dense_state,
                                           init_matrix_state,
                                           lowrank_adam_step,
                                           rotate_moments_dense,
                                           rotate_moments_rank1)
from repro_torch.distributed import sharding


@dataclass(frozen=True)
class LowRankConfig:
    """Everything that defines a low-rank optimizer variant."""

    rank: int = 128
    update_interval: int = 200          # paper Table 10 (k)
    eta: float = 10.0                   # SubTrack++ step size (Table 10)
    method: str = "grassmann"
    projection_aware: bool = True
    recovery: bool = True
    init: str = "svd"                   # subspace warm start (Eq. 1)
    rank1_rotation: bool = False        # O(rn) rotation on the torch path
    fused_tangent: bool = True
    power_iters: int = 24
    exact_top1: bool = False
    reorth_interval: int = 0            # QR scrub every N updates (0 = off)
    use_kernels: bool = False           # the fused kernel hot path
    # row-family Adam-state flavour: "replicated" M/V, "reduce-scatter"
    # n/g column slices, or "auto" by the modeled per-rank bytes
    # (repro_torch.core.program.pick_row_flavor)
    row_state: str = "auto"
    # same-shape bucketing: None or False (every leaf runs on its own);
    # True is not ported yet
    bucket_leaves: Optional[bool] = None
    osd_lr: float = 1e-2
    adam: AdamHP = field(default_factory=AdamHP)
    weight_decay: float = 0.0


class OptState(NamedTuple):
    step: int          # number of updates applied
    n_updates: int     # number of subspace refreshes done
    inner: Any         # dict tree of MatrixOptState / DenseOptState


class GradientTransform(NamedTuple):
    init: Callable[[Any], OptState]
    warm_start: Callable[[OptState, Any], OptState]
    update: Callable[..., tuple[Any, OptState]]
    state_bytes: Callable[[Any], int]
    config: Any
    # the mesh (a MeshContext) and hot-path specs the optimizer was built
    # with, and ``grad_specs(params)``: each leaf's gradient / update
    # layout (param orientation), None where the leaf is whole
    mesh: Any = None
    param_specs: Any = None
    grad_specs: Optional[Callable[[Any], Any]] = None


def _get_backend(cfg: LowRankConfig):
    if not cfg.use_kernels:
        return None
    from repro_torch.kernels import ops as kernel_ops

    return kernel_ops


def tree_map(fn, tree, *rest):
    """Map over nested dicts; everything that is not a dict is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in :func:`tree_map`'s order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Per-leaf step functions (batched over the leaf's stack dims)
# ---------------------------------------------------------------------------


def _plain_matrix_step(cfg: LowRankConfig, hp: AdamHP, G, st, step: int,
                       lr: float, param, out_dtype, exec=None, tap=None):
    """``tap``, when given, is the grad-fused (..., r+1, n) [A; colnorms]
    panel of the backward (``models.common.tapped_matmul``): rows [0:r]
    are S^T G, row r the per-column ||G||^2, handed down as the
    precomputed pair so the step never projects G for them."""
    pp = pg = None
    if tap is not None:
        pp, pg = tap[..., :-1, :], tap[..., -1, :]
    out = lowrank_adam_step(G, st, step, hp, recovery=cfg.recovery,
                            backend=_get_backend(cfg), lr=lr,
                            weight_decay=cfg.weight_decay, param=param,
                            out_dtype=out_dtype, precomputed_proj=pp,
                            precomputed_gsq=pg, exec=exec)
    return out.delta, out.state


def _refresh_subspace(cfg: LowRankConfig, G, st: MatrixOptState, step: int,
                      n_updates: int, backend=None, exec=None,
                      eta_scale: float = 1.0):
    """The new basis per the configured method: (S_new, rank1_info, gsq,
    proj, diag).  rank1_info = (cos_theta, v) where the rank-1 rotation
    applies; gsq the front end's ||G_:,j||^2; proj the global new-basis
    projection ``A_new`` of the gram schedule (None otherwise), which the
    epilogue consumes instead of projecting G again; diag the tracker's
    (..., 4) health vector (None for methods with no geodesic).  ``exec``
    carries the leaf's StepProgram: only the Grassmann tracker and the
    frozen subspace run sharded.  ``eta_scale`` multiplies the geodesic
    step size (1.0 but for the sigma-blowup fault injection)."""
    rank = st.S.shape[-1]
    if cfg.method == "grassmann":
        res = sub.track_subspace(st.S, G, eta=cfg.eta * eta_scale,
                                 fused_tangent=cfg.fused_tangent,
                                 exact_top1=cfg.exact_top1,
                                 power_iters=cfg.power_iters,
                                 backend=backend, exec=exec)
        if cfg.reorth_interval:
            S_new = res.S_new
            if n_updates % cfg.reorth_interval == cfg.reorth_interval - 1:
                S_new = sub.reorthonormalize(S_new)
            # the rank-1 identity does not survive a QR scrub
            return S_new, None, res.gsq, res.A_new, res.diag
        return res.S_new, (res.cos_theta, res.v), res.gsq, res.A_new, \
            res.diag
    if cfg.method == "svd":
        return _per_matrix(lambda g: sub.refresh_svd(g, rank), G), None, \
            None, None, None
    if cfg.method == "random":
        return sub.refresh_random(G, rank, step=step), None, None, None, None
    if cfg.method == "osd":
        G32 = G.float()
        GGS = G32 @ (G32.mT @ st.S)
        corr = GGS - st.S @ (st.S.mT @ GGS)
        return sub.reorthonormalize(st.S + cfg.osd_lr * corr).contiguous(), \
            None, None, None, None
    if cfg.method == "none":
        # the change of basis is exactly I, as the rank-1 identity (cos 1,
        # v 0), so the rotation stays shard-local under row programs
        lead = st.S.shape[:-2]
        return st.S, (torch.ones(lead, device=st.S.device),
                      torch.zeros(lead + (rank,), device=st.S.device)), \
            None, None, None
    if cfg.method == "grass":
        return _grass_basis(G, rank), None, None, None, None
    raise ValueError(f"unknown subspace method {cfg.method!r}")


def _tracking_matrix_step(cfg: LowRankConfig, hp: AdamHP, G, st, step: int,
                          n_updates: int, lr: float, param, out_dtype,
                          exec=None, eta_scale: float = 1.0):
    """The 1-of-k subspace-update step: the program's refresh -> rank-1
    (M, V) rotation -> the plain steps' epilogue on the new basis (the
    front end's column norms feed the Eq. 12 clip; the gram schedule also
    hands it the new basis's projection, so no ``project`` runs).  The
    rank-1 rotation is column-wise, so it runs on whatever M/V block the
    state layout holds.  Without kernels: the paper-literal unfused
    schedule.  Returns (delta, state, diag or None)."""
    backend = _get_backend(cfg)
    # the kernels cast per tile: no (m, n) fp32 copy on the kernel path
    Gc = G if backend is not None else G.float()
    S_new, rank1_info, gsq, proj, diag = _refresh_subspace(
        cfg, Gc, st, step, n_updates, backend, exec, eta_scale)
    rotated = None
    if cfg.projection_aware:
        if rank1_info is not None and (cfg.rank1_rotation
                                       or backend is not None):
            cos_t, v = rank1_info
            rotated = rotate_moments_rank1(cos_t, v, st.M, st.V, step, hp)
        else:
            Q = sub.change_of_basis(S_new, st.S)
            rotated = rotate_moments_dense(Q, st.M, st.V, step, hp)
    out = lowrank_adam_step(Gc, st, step, hp, rotated=rotated, S_new=S_new,
                            recovery=cfg.recovery, backend=backend, lr=lr,
                            weight_decay=cfg.weight_decay, param=param,
                            out_dtype=out_dtype, precomputed_proj=proj,
                            precomputed_gsq=gsq, exec=exec)
    return out.delta, out.state, diag


def _per_matrix(fn, G):
    """Apply a per-matrix function one matrix at a time over the stack,
    so a whole stack never needs an fp32 copy (the warm-start SVD)."""
    lead, (m, n) = G.shape[:-2], G.shape[-2:]
    outs = [fn(g) for g in G.reshape(-1, m, n)]
    return torch.stack(outs).reshape(lead + outs[0].shape)


def _grass_basis(G, rank: int) -> torch.Tensor:
    """Grass (arXiv:2406.17660): S (..., m, r) fp32 selects the ``rank``
    rows of G with the most energy sum_j G_ij^2 (in fp32), one one-hot
    column per row, in descending order of energy."""
    energy = _per_matrix(lambda g: (g.float() ** 2).sum(dim=-1), G)
    idx = torch.topk(energy, rank, dim=-1).indices
    return torch.nn.functional.one_hot(idx, G.shape[-2]).float().mT \
        .contiguous()


def _warm_basis(cfg: LowRankConfig, G, rank: int) -> torch.Tensor:
    """S_0 (..., m, r) from the first gradient (Alg. 1 line 1)."""
    if cfg.method == "grass":
        # one-hot from step 0: the grass programs assume S is always a row
        # selection, which an SVD warm start would break
        return _grass_basis(G, rank)
    return _per_matrix(lambda g: sub.init_subspace(g.float(), rank,
                                                   cfg.init), G).contiguous()


# ---------------------------------------------------------------------------
# The tree-level transform
# ---------------------------------------------------------------------------


def _leaf_init(plan: plan_lib.ParamPlan, p: torch.Tensor):
    if plan.mode == "dense":
        return init_dense_state(tuple(p.shape), device=p.device)
    return init_matrix_state(plan.m, plan.n, plan.rank,
                             stack=tuple(p.shape[:-2]), device=p.device)


def lowrank_optimizer(cfg: LowRankConfig, *, mesh=None,
                      param_specs=None) -> GradientTransform:
    """Build the SubTrack++ / GaLore / Fira / ... optimizer for a dict tree
    of parameters.

    ``mesh`` (a :class:`~repro_torch.distributed.context.MeshContext`) and
    ``param_specs`` (a tree of spec tuples mirroring the params, from
    ``distributed.sharding.hotpath_param_specs``) opt the fused hot path
    into the multi-GPU programs: per leaf,
    :func:`~repro_torch.core.program.build_program` classifies the
    canonical (m, n) sharding into a StepProgram, and the leaf's state is
    held in that program's layout: column (n sharded: one scalar clip sum
    per plain step, one (m, r) tangent sum per tracking step), row (m
    sharded, replicated M/V: one (r+1, n) [A; colnorms] sum, plus one
    (r, n + 3r) Gram sum when tracking), row-rs (M/V in n/g slices: a
    reduce-scatter and one epilogue all-gather, three collectives when
    tracking), or replicated.  ``mesh`` alone (no specs) keeps every leaf
    replicated but still shares rank 0's warm-start basis.

    Under a mesh ``init`` and ``warm_start`` take the whole params and
    gradients; ``update`` takes each leaf's gradient as this rank's shard
    by ``grad_specs(params)`` (a view of the whole gradient; the params
    and taps whole) and returns the update shards, which the train step
    gathers (``launch/steps.py``).  A tracking step whose program would
    hold another layout than the plain step's (the SVD / random / Oja
    refreshes, or a QR scrub on a row leaf) raises: that relayout is not
    ported yet."""
    hp = cfg.adam
    if cfg.bucket_leaves:
        raise NotImplementedError("bucket_leaves=True (same-shape "
                                  "bucketing) is not yet ported to "
                                  "repro_torch")
    run_mesh = mesh if param_specs is not None else None

    def plans_of(params):
        return plan_lib.make_plans(params, cfg.rank, specs=(
            param_specs if run_mesh is not None else None))

    def program_of(plan, tracking=False, tapped=False):
        return program_lib.build_program(plan, cfg, run_mesh,
                                         tracking=tracking, tapped=tapped)

    def local(x, spec):
        return x if run_mesh is None else sharding.local_view(x, spec,
                                                              run_mesh)

    def layouts(plan):
        """The leaf's plain-program layouts: (gradient spec, canonical;
        state specs), as every rank holds them between steps."""
        return program_lib.layout_specs(program_of(plan), plan.batch_dims)

    def leaf_spec(plan):
        """The gradient spec in the leaf's own orientation (the canonical
        transpose is its own inverse)."""
        gspec = layouts(plan)[0]
        return plan_lib.canonicalize_spec(gspec, len(gspec), plan.transpose)

    def init(params) -> OptState:
        def leaf(plan, p):
            st = _leaf_init(plan, p)
            if plan.mode == "dense" or run_mesh is None:
                return st
            return MatrixOptState(*(
                local(t, spec).clone(memory_format=torch.contiguous_format)
                for t, spec in zip(st, layouts(plan)[1])))

        return OptState(step=0, n_updates=0,
                        inner=tree_map(leaf, plans_of(params), params))

    def warm_start(state: OptState, grads) -> OptState:
        def leaf(plan, g, st):
            if plan.mode == "dense":
                return st
            g = plan_lib.canonical_grad(g, plan)
            rank = st.S.shape[-1]
            if mesh is None or mesh.world is None:
                return st._replace(S=_warm_basis(cfg, g, rank))
            # rank 0's basis everywhere: the SVDs of N processes need not
            # agree in sign
            S = (_warm_basis(cfg, g, rank) if mesh.rank == 0
                 else torch.empty(g.shape[:-2] + (plan.m, rank),
                                  device=g.device))
            sharding.broadcast(S, mesh)
            if run_mesh is not None:
                S = local(S, layouts(plan)[1].S).clone(
                    memory_format=torch.contiguous_format)
            return st._replace(S=S)

        return state._replace(inner=tree_map(leaf, plans_of(grads), grads,
                                             state.inner))

    def grad_specs(params):
        """Each leaf's gradient / update layout in the leaf's own
        orientation, None where the leaf is whole."""
        def leaf(plan):
            if plan.mode == "dense" or run_mesh is None:
                return None
            spec = leaf_spec(plan)
            return None if all(a is None for a in spec) else spec

        return tree_map(leaf, plans_of(params))

    def update(grads, state: OptState, params, lr: float,
               do_subspace_update: bool = False, *, taps=None,
               with_health: bool = False, eta_scale: float = 1.0):
        """(updates, new_state); updates are added to the params (in the
        parameter's dtype and layout).  ``grads`` and ``taps`` are
        consumed: each leaf's entry is set to None as soon as its update
        exists, so at llama-7b the updates take the bytes the gradients
        (13.5 GB) give back and the taps (6.6 GB) go leaf by leaf, and the
        caller holds the updates for its quarantine gate with no tree of
        gradients beside them.  ``state`` is never written, so the old
        state stays whole for a quarantined step.  Under a mesh each
        gradient (and each update returned) is this rank's shard by
        ``grad_specs(params)``; ``params`` and ``taps`` are whole.

        ``with_health=True`` returns (updates, new_state, diag): ``diag``
        the element-wise max of the (4,) health diagnostic over every
        low-rank leaf and its stack (zero on plain steps; the same on
        every rank).  ``eta_scale`` multiplies ``cfg.eta`` in the tracker
        (the sigma-blowup fault injection).

        ``taps`` (optional) mirrors ``grads`` with None or, at a tapped
        leaf, the grad-fused (..., r+1, n) [A; colnorms] panel of the
        backward (canonical orientation).  A tapped leaf's plain step
        consumes it (its column shard, under a column program) instead of
        projecting G, where its program declares the ``grad_tap`` round;
        row programs, tracking steps and dense leaves ignore it.

        Every rank walks the leaves in the same order and builds the same
        programs, so the collectives line up."""
        plans = plans_of(params)
        step, n_upd = state.step, state.n_updates
        lr32 = torch.tensor(lr, dtype=torch.float32)
        diags = []

        def leaf_update(plan, g, st, p, tap):
            if plan.mode == "dense":
                delta, new_st = dense_adam_step(g, st, step, hp)
                upd = (-lr32 * delta).to(p.dtype)
                if cfg.weight_decay:
                    upd = upd - (lr32 * cfg.weight_decay
                                 * p.float()).to(p.dtype)
                return upd, new_st
            prog = program_of(plan, tracking=do_subspace_update,
                              tapped=tap is not None)
            gspec = layouts(plan)[0]
            held = program_of(plan)
            if (prog.axes, prog.grad_layout, prog.state_layout) != (
                    held.axes, held.grad_layout, held.state_layout):
                raise NotImplementedError(
                    f"a {prog.regime} step on a leaf held in the "
                    f"{held.regime} layout (the relayout of the SVD, random "
                    "and Oja refreshes, or of a QR scrub on row shards) is "
                    "not yet ported to repro_torch")
            if prog.round("grad_tap") is None:
                tap = None
            elif tap is not None:
                tap = local(tap, gspec[:-2] + (None, gspec[-1]))
            g2 = plan_lib.canonical_grad(g, plan)
            p2 = (plan_lib.canonical_grad(local(p, leaf_spec(plan)), plan)
                  if cfg.weight_decay else None)
            exec = program_lib.executor(prog, run_mesh)
            if do_subspace_update:
                def fn(G, s, pp, _tap):
                    return _tracking_matrix_step(cfg, hp, G, s, step, n_upd,
                                                 lr, pp, p.dtype, exec,
                                                 eta_scale)
            else:
                def fn(G, s, pp, t):
                    return (*_plain_matrix_step(cfg, hp, G, s, step, lr, pp,
                                                p.dtype, exec, t), None)
            delta, new_st, diag = program_lib.lower(
                prog, fn, batch_dims=plan.batch_dims)(g2, st, p2, tap)
            if diag is not None:
                diags.append(health_lib.reduce_diag(diag))
            return plan_lib.uncanonical_update(delta, plan), new_st

        def walk(plans, grads, inner, params, taps):
            """(updates, new states) over one level of the trees."""
            updates, states = {}, {}
            for k, plan in plans.items():
                if isinstance(plan, dict):
                    updates[k], states[k] = walk(plan, grads[k], inner[k],
                                                 params[k], taps[k])
                    continue
                updates[k], states[k] = leaf_update(
                    plan, grads[k], inner[k], params[k], taps[k])
                grads[k] = taps[k] = None               # release them now
            return updates, states

        if taps is None:
            taps = tree_map(lambda _: None, plans)
        updates, inner = walk(plans, grads, state.inner, params, taps)
        new_state = OptState(step=step + 1,
                             n_updates=n_upd + int(do_subspace_update),
                             inner=inner)
        if not with_health:
            return updates, new_state
        diag = health_lib.zero_diag(tree_leaves(params)[0].device)
        for d in diags:
            diag = health_lib.merge_diag(diag, d)
        return updates, new_state, diag

    def state_bytes(params) -> int:
        plans = plan_lib.make_plans(params, cfg.rank)
        return sum(plan_lib.state_bytes(plan, tuple(p.shape))
                   for plan, p in zip(tree_leaves(plans),
                                      tree_leaves(params)))

    return GradientTransform(init=init, warm_start=warm_start, update=update,
                             state_bytes=state_bytes, config=cfg, mesh=mesh,
                             param_specs=param_specs, grad_specs=grad_specs)


# ---------------------------------------------------------------------------
# Named constructors for the paper's method zoo
# ---------------------------------------------------------------------------


def _build(overrides: dict) -> GradientTransform:
    """Split the distribution kwargs (mesh, param_specs) from the
    LowRankConfig fields, so every named constructor takes them."""
    mesh = overrides.pop("mesh", None)
    param_specs = overrides.pop("param_specs", None)
    return lowrank_optimizer(LowRankConfig(**overrides), mesh=mesh,
                             param_specs=param_specs)


def subtrack(**overrides) -> GradientTransform:
    """SubTrack++ (full): Grassmann tracking + projection-aware + recovery."""
    return _build(overrides)


def subtrack_fast(**overrides) -> GradientTransform:
    overrides.setdefault("rank1_rotation", True)
    overrides.setdefault("fused_tangent", True)
    return _build(overrides)


def grassmann_only(**overrides) -> GradientTransform:
    overrides.setdefault("projection_aware", False)
    overrides.setdefault("recovery", False)
    return _build(overrides)


def galore(**overrides) -> GradientTransform:
    overrides.setdefault("method", "svd")
    overrides.setdefault("projection_aware", False)
    overrides.setdefault("recovery", False)
    return _build(overrides)


def fira(**overrides) -> GradientTransform:
    overrides.setdefault("method", "svd")
    overrides.setdefault("projection_aware", False)
    overrides.setdefault("recovery", True)
    return _build(overrides)


def golore(**overrides) -> GradientTransform:
    overrides.setdefault("method", "random")
    overrides.setdefault("projection_aware", False)
    overrides.setdefault("recovery", False)
    overrides.setdefault("init", "randomized")
    return _build(overrides)


def osd(**overrides) -> GradientTransform:
    overrides.setdefault("method", "osd")
    overrides.setdefault("projection_aware", False)
    overrides.setdefault("recovery", False)
    return _build(overrides)


def apollo(**overrides) -> GradientTransform:
    """GoLore's subspace policy with the recovery scaling."""
    overrides.setdefault("method", "random")
    overrides.setdefault("projection_aware", False)
    overrides.setdefault("recovery", True)
    overrides.setdefault("init", "randomized")
    return _build(overrides)
