"""The multi-GPU optimizer step on the CPU: the port's StepPrograms over
threaded gloo groups (one thread per rank, each with its own
``ProcessGroupGloo`` over one shared store), against the port's
replicated step and against the JAX package's programs.

* Every regime (replicated, column, row, row-rs, grass) at 2 and 4 ranks,
  with weight decay,
  on small leaves inside both gates (m 256, n 512, r 8; a plain leaf, a
  transposed stack of 2 and a dense vector): one plain and one tracking
  step from the same state.  The gathered updates and the gathered S, M
  and V match the replicated step's within 1e-5 (plain) and 1e-3
  (tracking: gram against tangent schedule) of their largest entry, and
  are the same bits on every rank, as is the health vector.  The warm
  start on the mesh is rank 0's basis, bit for bit.
* Each rank's collectives, counted by kind at the group object, equal the
  sum of the leaves' ``program.collective_counts()`` on every step.
* Against the JAX package on the same numpy inputs: the port's row and
  row-rs programs at 2 ranks against the JAX row program on its smoke
  mesh, the port's column program at 2 ranks against the JAX column
  program, a plain and a tracking step each.
* ``A_new``: a gram tracking step calls no ``project`` (a spy on the
  backend) and equals the tangent schedule's step within 1e-3.
* The driver: ``train.run`` at the fp32 smoke config on a 2-rank mesh
  (layout auto) reproduces the one-rank run's losses, every rank holds
  the same parameters, and a ``nan-grad`` step is quarantined on both
  ranks with the state bit-identical.
"""

import datetime
import itertools
import threading
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.core import subtrack as jsub
from repro.core.lowrank_adam import MatrixOptState as JMatrixOptState
from repro.distributed.context import mesh_context
from repro.launch.mesh import smoke_context
from repro_torch.core import health as health_lib
from repro_torch.core import plan as tplan
from repro_torch.core import program as tprogram
from repro_torch.core import subtrack as tsub
from repro_torch.core.lowrank_adam import MatrixOptState
from repro_torch.core.subtrack import OptState, tree_leaves, tree_map
from repro_torch.distributed import sharding
from repro_torch.distributed.context import abstract_context
from repro_torch.kernels import ops
from repro_torch.launch.mesh import host_context
from torch_threads import one_thread  # noqa: F401


class CountingGroup:
    """A process group that counts the collectives issued on it, by
    kind; everything else passes through."""

    KINDS = {"allreduce": "all-reduce",
             "_reduce_scatter_base": "reduce-scatter",
             "_allgather_base": "all-gather", "broadcast": "broadcast"}

    def __init__(self, pg):
        self.pg = pg
        self.counts = Counter()

    def __getattr__(self, name):
        fn = getattr(self.pg, name)
        kind = self.KINDS.get(name)
        if kind is None:
            return fn

        def counted(*args, **kw):
            self.counts[kind] += 1
            return fn(*args, **kw)

        return counted


_GROUPS = itertools.count()


def on_ranks(g: int, fn):
    """``fn(ctx)`` on ``g`` threads, one per rank, each with the (1, g)
    host mesh over its own counting gloo group; the results in rank
    order.  The first error of any rank is raised (the others time out
    of their collectives)."""
    store = dist.HashStore()
    prefix = f"mesh{next(_GROUPS)}"
    out, errors = [None] * g, []

    def body(rank):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), rank,
                                       g, datetime.timedelta(seconds=60))
            out[rank] = fn(host_context(group=CountingGroup(pg)))
        except BaseException as e:           # noqa: BLE001 (re-raised)
            errors.append(e)

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(g)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    assert all(not t.is_alive() for t in threads), "a rank hung"
    return out


# ---------------------------------------------------------------------------
# Small leaves inside both gates
# ---------------------------------------------------------------------------

M, N, R, LR, ETA, WD = 256, 512, 8, 1e-2, 2.5, 0.1
SHAPES = {"a": (M, N), "b": (2, N, M), "v": (N,)}
# the canonical n dim of each leaf (its m dim is the other trailing one)
COLUMN = {"a": (None, "model"), "b": (None, "model", None), "v": ()}
ROW = {"a": ("model", None), "b": (None, None, "model"), "v": ()}
REPLICATED = {"a": (None, None), "b": (None, None, None), "v": ()}
REGIMES = {   # regime -> (specs, optimizer overrides)
    "replicated": (REPLICATED, {}),
    "column": (COLUMN, {}),
    "row": (ROW, {"row_state": "replicated"}),
    "row-rs": (ROW, {"row_state": "reduce-scatter"}),
    "grass": (COLUMN, {"method": "grass"}),
}


def _np_tree(seed: int, scale: float = 0.01) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch_tree(tree_np) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in tree_np.items()}


def _start_state(opt, params):
    """The replicated optimizer's warm start from gradient 0, with M and
    V moved off zero (a fresh Adam step divides by |Gt|), and step 3."""
    st = opt.warm_start(opt.init(params), _torch_tree(_np_tree(0)))
    rng = np.random.default_rng(7)

    def leaf(s):
        if not isinstance(s, MatrixOptState):
            return s
        M_ = torch.from_numpy(
            (1e-3 * rng.standard_normal(s.M.shape)).astype(np.float32))
        V_ = torch.from_numpy(
            (1e-5 * (1 + rng.random(s.V.shape))).astype(np.float32))
        return s._replace(M=M_, V=V_)

    return OptState(step=3, n_updates=1, inner=tree_map(leaf, st.inner))


def _state_specs(cfg, specs, params, ctx):
    """Canonical state specs of each low-rank leaf's plain program."""
    plans = tplan.make_plans(params, cfg.rank, specs=specs)
    return tree_map(lambda pl: None if pl.mode == "dense" else
                    tprogram.layout_specs(tprogram.build_program(
                        pl, cfg, ctx, tracking=False), pl.batch_dims)[1],
                    plans)


def _shard_state(state, sspecs, ctx):
    return state._replace(inner=tree_map(
        lambda st, sp: st if sp is None else MatrixOptState(*(
            sharding.local_view(t, s, ctx).contiguous()
            for t, s in zip(st, sp))), state.inner, sspecs))


def _gather_state(state, sspecs, ctx):
    return tree_map(lambda st, sp: tuple(st) if sp is None else tuple(
        sharding.gather(t, s, ctx) for t, s in zip(st, sp)),
        state.inner, sspecs)


def _expected_counts(cfg, specs, params, ctx, tracking) -> dict:
    plans = tplan.make_plans(params, cfg.rank, specs=specs)
    total = Counter()
    for pl in tree_leaves(plans):
        if pl.mode == "lowrank":
            total.update(tprogram.build_program(
                pl, cfg, ctx, tracking=tracking).collective_counts())
    return dict(total)


def _rel(got, want) -> float:
    scale = max(float(want.abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale


def _mesh_steps(ctx, regime):
    """One plain and one tracking step of ``regime`` on this rank, from
    the replicated optimizer's warm-started state, beside the replicated
    steps: per step the gathered updates, gathered state, health vector,
    the collectives this rank issued, and the programs' counts."""
    specs, over = REGIMES[regime]
    kw = dict(rank=R, update_interval=1, eta=ETA, use_kernels=True,
              weight_decay=WD, **over)
    params = _torch_tree(_np_tree(1, scale=0.1))
    ref = tsub.subtrack(**kw)
    opt = tsub.subtrack(**kw, mesh=ctx, param_specs=specs)
    sspecs = _state_specs(opt.config, specs, params, ctx)
    # the mesh's warm start is rank 0's basis
    warm = _gather_state(opt.warm_start(opt.init(params),
                                        _torch_tree(_np_tree(0))),
                         sspecs, ctx)
    start = _start_state(ref, params)
    ref_st, st = start, _shard_state(start, sspecs, ctx)
    gspecs = opt.grad_specs(params)
    steps = []
    for seed, tracking in ((2, False), (3, True)):
        grads = _torch_tree(_np_tree(seed))
        shards = tree_map(lambda g, sp: g if sp is None
                          else sharding.local_view(g, sp, ctx), grads, gspecs)
        ctx.world.counts.clear()
        upd, st, diag = opt.update(shards, st, params, LR, tracking,
                                   with_health=True)
        issued = dict(ctx.world.counts)
        upd = tree_map(lambda u, sp: u if sp is None
                       else sharding.gather(u, sp, ctx), upd, gspecs)
        ref_upd, ref_st, ref_diag = ref.update(
            _torch_tree(_np_tree(seed)), ref_st, params, LR, tracking,
            with_health=True)
        steps.append(dict(
            upd=upd, state=_gather_state(st, sspecs, ctx), diag=diag,
            ref_upd=ref_upd, ref_state=tree_map(tuple, ref_st.inner),
            ref_diag=ref_diag, issued=issued,
            want=_expected_counts(opt.config, specs, params, ctx,
                                  tracking)))
    return dict(warm=warm, start=tree_map(tuple, start.inner), steps=steps)


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_regime_matches_the_replicated_step(regime, g):
    runs = on_ranks(g, lambda ctx: _mesh_steps(ctx, regime))
    first = runs[0]
    for run in runs:
        # rank 0's warm-start basis everywhere, the same bits on each rank
        for got, want in zip(tree_leaves(run["warm"]),
                             tree_leaves(first["warm"])):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    sharded_kinds = Counter()
    for k, (step, tol) in enumerate(zip(first["steps"], (1e-5, 1e-3))):
        for run in runs:
            other = run["steps"][k]
            assert other["issued"] == other["want"]
            for a, b in zip(tree_leaves(other["upd"]),
                            tree_leaves(step["upd"])):
                assert torch.equal(a, b)
            assert torch.equal(other["diag"], step["diag"])
        sharded_kinds.update(step["want"])
        for got, want in zip(tree_leaves(step["upd"]),
                             tree_leaves(step["ref_upd"])):
            assert got.shape == want.shape
            assert _rel(got, want) <= tol, (regime, k)
        for got, want in zip(tree_leaves(step["state"]),
                             tree_leaves(step["ref_state"])):
            for name, a, b in zip(("S", "M", "V", "lam"), got, want):
                assert a.shape == b.shape, name
                assert _rel(a, b) <= tol, (regime, k, name)
        assert torch.allclose(step["diag"], step["ref_diag"], rtol=1e-3,
                              atol=1e-6)
    # a sharded regime issues rounds; the replicated and grass ones none
    assert bool(sharded_kinds) == (regime not in ("replicated", "grass"))
    # the tracking step moved the basis (grass re-selects rows instead)
    if regime != "grass":
        assert first["steps"][1]["diag"][health_lib.DIAG_THETA] > 0


def _tapped_step(ctx, regime):
    """A grad-fused plain step: every low-rank leaf's [S^T G; ||G_:,j||^2]
    tap, whole, beside its gradient shard."""
    specs, over = REGIMES[regime]
    kw = dict(rank=R, update_interval=1, eta=ETA, use_kernels=True,
              weight_decay=WD, **over)
    params = _torch_tree(_np_tree(1, scale=0.1))
    ref = tsub.subtrack(**kw)
    opt = tsub.subtrack(**kw, mesh=ctx, param_specs=specs)
    sspecs = _state_specs(opt.config, specs, params, ctx)
    start = _start_state(ref, params)
    plans = tplan.make_plans(params, R)

    def taps():
        return tree_map(lambda pl, g, st: None if pl.mode == "dense" else
                        torch.cat([st.S.mT @ tplan.canonical_grad(g, pl),
                                   (tplan.canonical_grad(g, pl) ** 2).sum(
                                       -2, keepdim=True)], dim=-2),
                        plans, _torch_tree(_np_tree(2)), start.inner)

    gspecs = opt.grad_specs(params)
    shards = tree_map(lambda g, sp: g if sp is None
                      else sharding.local_view(g, sp, ctx),
                      _torch_tree(_np_tree(2)), gspecs)
    ctx.world.counts.clear()
    upd, st = opt.update(shards, _shard_state(start, sspecs, ctx), params,
                         LR, taps=taps())
    issued = dict(ctx.world.counts)
    upd = tree_map(lambda u, sp: u if sp is None
                   else sharding.gather(u, sp, ctx), upd, gspecs)
    want, _ = ref.update(_torch_tree(_np_tree(2)), start, params, LR,
                         taps=taps())
    plain, _ = ref.update(_torch_tree(_np_tree(2)), start, params, LR)
    return upd, want, plain, issued


@pytest.mark.parametrize("regime", ["column", "row"])
def test_tapped_plain_step_takes_the_taps_column_shard(regime):
    """A column program consumes its column slice of the whole tap (the
    tap is column-separable); a row program drops the tap and projects
    its rows.  Both equal the replicated grad-fused step, which equals
    the untapped one."""
    for upd, want, plain, issued in on_ranks(2, lambda ctx: _tapped_step(
            ctx, regime)):
        assert issued == {"all-reduce": 2}
        for key in SHAPES:
            assert _rel(upd[key], want[key]) <= 1e-5, key
            assert _rel(want[key], plain[key]) <= 1e-5, key


# ---------------------------------------------------------------------------
# Against the JAX package's programs
# ---------------------------------------------------------------------------


def _jax_steps(specs):
    """The JAX package's row or column program on its smoke (1, 1) mesh:
    one plain and one tracking step from the same start."""
    params = {k: jnp.asarray(v) for k, v in _np_tree(1, scale=0.1).items()}
    start = _start_state(tsub.subtrack(rank=R, update_interval=1, eta=ETA,
                                       use_kernels=True, weight_decay=WD),
                         _torch_tree(_np_tree(1, scale=0.1)))
    ctx = smoke_context()
    opt = jsub.subtrack(rank=R, update_interval=1, eta=ETA,
                        use_kernels=True, weight_decay=WD, mesh=ctx.mesh,
                        param_specs={k: P(*v) for k, v in specs.items()})

    def conv(st):
        if isinstance(st, MatrixOptState):
            return JMatrixOptState(*(jnp.asarray(t.numpy()) for t in st))
        return type(opt.init(params).inner["v"])(
            *(jnp.asarray(t.numpy()) for t in st))

    state = jsub.OptState(step=jnp.int32(start.step),
                          n_updates=jnp.int32(start.n_updates),
                          inner={k: conv(v) for k, v in start.inner.items()})
    update = jax.jit(opt.update, static_argnames=("do_subspace_update",))
    out = []
    with mesh_context(ctx):
        for seed, tracking in ((2, False), (3, True)):
            grads = {k: jnp.asarray(v) for k, v in _np_tree(seed).items()}
            upd, state = update(grads, state, params, LR,
                                do_subspace_update=tracking)
            out.append(({k: torch.from_numpy(np.array(v))
                         for k, v in upd.items()},
                        {k: tuple(torch.from_numpy(np.array(t)) for t in v)
                         for k, v in state.inner.items()}))
    return out


def test_row_and_column_programs_match_the_jax_package():
    want = {"row": _jax_steps(ROW), "column": _jax_steps(COLUMN)}
    for regime, jax_regime in (("row", "row"), ("row-rs", "row"),
                               ("column", "column")):
        run = on_ranks(2, lambda ctx: _mesh_steps(ctx, regime))[0]
        for k, tol in enumerate((1e-5, 1e-3)):
            got = run["steps"][k]
            w_upd, w_state = want[jax_regime][k]
            for key in SHAPES:
                assert _rel(got["upd"][key], w_upd[key]) <= tol, \
                    (regime, k, key)
                for a, b in zip(got["state"][key], w_state[key]):
                    assert _rel(a, b) <= tol, (regime, k, key)


# ---------------------------------------------------------------------------
# A_new: the gram tracking step projects nothing
# ---------------------------------------------------------------------------


def test_gram_tracking_step_consumes_a_new_and_launches_no_project(
        monkeypatch):
    calls = Counter()
    for name in ("project", "project_colnorms", "tangent", "tangent_gram",
                 "project_tangent_colnorms", "adam_lowrank_norms",
                 "fused_update"):
        fn = getattr(ops, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(ops, name, spy)
    kw = dict(rank=R, update_interval=1, eta=ETA, use_kernels=True)
    params = _torch_tree(_np_tree(1, scale=0.1))
    grads = _np_tree(3)
    ctx = abstract_context((1, 1))
    row = tsub.subtrack(**kw, mesh=ctx, param_specs=ROW)
    rep = tsub.subtrack(**kw)
    start = _start_state(rep, params)
    got, _ = row.update(_torch_tree(grads), start, params, LR, True)
    gram = dict(calls)
    calls.clear()
    want, _ = rep.update(_torch_tree(grads), start, params, LR, True)
    leaves = 2
    assert gram == {"project_colnorms": leaves, "tangent": leaves,
                    "tangent_gram": leaves, "adam_lowrank_norms": leaves,
                    "fused_update": leaves}
    assert calls == {"project_tangent_colnorms": leaves, "project": leaves,
                     "adam_lowrank_norms": leaves, "fused_update": leaves}
    for key in SHAPES:
        assert _rel(got[key], want[key]) <= 1e-3


# ---------------------------------------------------------------------------
# The driver on a 2-rank mesh
# ---------------------------------------------------------------------------


def _smoke_driver(ctx):
    """Two steps (plain, tracking) of ``run`` at the fp32 smoke config,
    the optimizer built as ``--mesh host --hotpath-layout auto`` builds it
    (on the one-rank run: as ``--mesh smoke``), then a nan-grad step of
    the same train step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model

    cfg = get_config("llama-100m", smoke=True).with_(dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    kw = dict(rank=16, update_interval=1, eta=2e-5, use_kernels=True)
    if ctx is None:
        opt = tsub.subtrack(**kw)
    else:
        specs = sharding.hotpath_param_specs(params, ctx, 16)
        opt = tsub.subtrack(**kw, mesh=ctx, param_specs=specs)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=16, global_batch=2, seed=0))
    batches = [data.global_batch_at(s) for s in range(3)]
    out = ttrain.run(cfg, params, lambda s: batches[s], optimizer=opt,
                     steps=2, lr_at=lambda s: 1e-3, log_every=10,
                     mesh=ctx)
    state = out["state"]
    before = [t.clone() for t in _tensors(state)]
    step = make_train_step(build_model(cfg), opt, mesh=ctx)
    after, metrics = step(state, batches[2], 1e-3,
                          inject=health_lib.INJECT_NAN_GRAD)
    return dict(losses=[h["loss"] for h in out["history"]],
                specs=None if ctx is None else opt.grad_specs(params),
                params=[t.clone() for t in tree_leaves(state.params)],
                quarantined=bool(metrics["quarantined"]),
                same=all(torch.equal(a, b)
                         for a, b in zip(before, _tensors(after))))


def _tensors(state) -> list:
    return tree_leaves(state.params) + [
        t for st in tree_leaves(state.opt.inner) for t in st]


def test_driver_on_two_ranks_reproduces_the_one_rank_run():
    one = _smoke_driver(None)
    runs = on_ranks(2, _smoke_driver)
    # the auto layout sharded the leaves (column at this size)
    assert any(sp is not None for sp in tree_leaves(runs[0]["specs"]))
    for run in runs:
        np.testing.assert_allclose(run["losses"], one["losses"], rtol=0,
                                   atol=1e-5)
        assert run["losses"][0] == one["losses"][0]
        assert all(torch.equal(a, b)
                   for a, b in zip(run["params"], runs[0]["params"]))
        assert run["quarantined"] and run["same"]
    assert one["quarantined"] and one["same"]
