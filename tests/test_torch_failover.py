"""Elastic mesh failover and the sharded restore on the CPU: the port's
ranks as threads over gloo groups (one ``ProcessGroupGloo`` per rank over
one shared store, rebuilt groups from ``launch/mesh.py``'s
``store_group_factory``), held against the JAX package in the same
process.

* ``restore_targets``: the port's answer equals the JAX package's on a
  grid of records (dense, and low-rank at the gates' edges: n % g,
  n/g < 2r, m % g, m/g < 2r, the row flavour's pick) for g in 1, 2, 4, 8.
* A JAX checkpoint (written on its one device, with its state-program
  records) restored by the port onto 2 and 4 ranks under the row, row-rs
  and column layouts: every rank's leaves equal its slices of the JAX
  state, bit for bit.
* A port checkpoint written on 4 ranks with sharded state (each rank
  gathers, rank 0 writes) restored by the JAX package's manager and
  elastic loader, and by the port on 2 ranks: both equal the port's
  gathered state, bit for bit.
* The host-side pieces against the JAX package's on the cases of
  ``tests/test_failover.py``: ``_deadline``, ``SimulatedDeviceLoss``,
  ``parse_injections``' infrastructure kinds, ``HealthSentinel.mesh_lost``;
  ``degraded_context`` renumbers survivors and leaves the others out;
  the restore's spec tree equals the JAX package's state specs.
* Re-planning 4 -> 2 flips regimes and group sizes as both packages'
  ``restore_targets`` say.
* End to end: four ranks with ``--inject dev-loss@7 --survivors 2`` in
  raise and hang mode (a 4 s deadline) fail over once (a MESH_LOST
  verdict at 7, 4 -> 2, re-planned programs, the known-good step 6
  restored), the lost ranks return cleanly, and the losses after the
  failover equal, within rtol 1e-5, those of a ``--mesh-devices 2`` run
  (on a world of 4) resumed from a copy of step 6.  dev-loss then preempt
  resumes to completion; an exhausted ``--max-failovers`` and a run with
  no ``--checkpoint-dir`` raise ``MeshLostError``.
* The port's checkpoint inspector prints what ``tools/dump_ckpt.py``
  prints on the same checkpoint, and ``--verify`` names a damaged leaf.
"""

import contextlib
import datetime
import importlib.util
import io
import itertools
import shutil
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import transpose as jxp
from repro.configs.registry import get_config as jax_get_config
from repro.core.api import get_optimizer as jax_get_optimizer
from repro.core.lowrank_adam import MatrixOptState as JMatrixOptState
from repro.core.program import StateDescriptor as JStateDescriptor
from repro.distributed import sharding as jsh
from repro.launch import mesh as jmesh
from repro.launch import train as jtrain
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import checkpoint_descriptors as jax_descriptors
from repro.models.api import build_model as jax_build_model
import repro_torch.checkpoint.manager as manager_mod
from repro_torch.checkpoint import (CheckpointManager, elastic_loader,
                                    restore_targets, state_program_records)
from repro_torch.checkpoint import inspect as tinspect
from repro_torch.checkpoint import transpose as xp
from repro_torch.configs.registry import get_config
from repro_torch.core.api import get_optimizer
from repro_torch.core.program import state_leaf_descriptors
from repro_torch.core.subtrack import LowRankConfig, tree_leaves
from repro_torch.distributed import sharding
from repro_torch.distributed.context import abstract_context
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import (TrainState, checkpoint_descriptors,
                                      train_state_shardings)
from repro_torch.models.api import build_model
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
RANK = 8
TIMEOUT = datetime.timedelta(seconds=60)
_WORLDS = itertools.count()


def on_ranks(g: int, fn):
    """``fn(rank, group, new_group)`` on ``g`` threads, one per rank, each
    with its own gloo group over one shared store and the factory its
    failovers rebuild with; the results in rank order.  The first error
    of any rank is raised."""
    store = dist.HashStore()
    prefix = f"world{next(_WORLDS)}"
    out, errors = [None] * g, []

    def body(rank):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), rank,
                                       g, TIMEOUT)
            out[rank] = fn(rank, pg, tmesh.store_group_factory(
                store, f"{prefix}/rebuild", rank, TIMEOUT))
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


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy().tobytes()
    if isinstance(x, int):
        return np.int32(x).tobytes()
    return np.asarray(x).tobytes()


def _to_torch(a) -> torch.Tensor | int:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.ndim == 0 and a.dtype == np.int32:
        return int(a)
    return torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# restore_targets
# ---------------------------------------------------------------------------

RECORDS = {   # name -> state-program record (the gates' edges at g 2-8)
    "dense": {"kind": "dense"},
    "fits both": {"kind": "lowrank", "m": 256, "n": 512, "rank": 8},
    "n % g": {"kind": "lowrank", "m": 64, "n": 250, "rank": 8},
    "n/g < 2r": {"kind": "lowrank", "m": 24, "n": 64, "rank": 8},
    "m % g": {"kind": "lowrank", "m": 250, "n": 24, "rank": 4},
    "m/g < 2r": {"kind": "lowrank", "m": 32, "n": 1024, "rank": 8},
    "row flavour rs": {"kind": "lowrank", "m": 512, "n": 4096, "rank": 16},
    "row flavour rep": {"kind": "lowrank", "m": 512, "n": 100, "rank": 16},
}


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(RECORDS))
def test_restore_targets_matches_the_jax_package(name, g):
    rec = dict(RECORDS[name], path="p")
    assert restore_targets(rec, g) == jxp.restore_targets(rec, g)


def test_restore_targets_grid_reaches_every_answer():
    """The grid above meets every regime and every note the gates give."""
    seen = {x for g in (1, 2, 4, 8) for rec in RECORDS.values()
            for part in ("regimes", "notes")
            for x in restore_targets(rec, g)[part]}
    assert {"dense", "replicated", "column", "row", "row-rs"} <= seen
    for note in ("column: n=", "column: n/g=", "row: m=", "row: m/g="):
        assert any(x.startswith(note) for x in seen), note


# ---------------------------------------------------------------------------
# Checkpoints across frameworks and rank counts
# ---------------------------------------------------------------------------

LAYOUTS = {   # --hotpath-layout -> (regimes, optimizer row_state)
    "column": (("column",), "auto"),
    "row": (("row",), "replicated"),
    "row-rs": (("row-rs",), "reduce-scatter"),
    "auto": (("column", "row"), "auto"),
}


@pytest.fixture(scope="module")
def jax_state():
    """A smoke-llama JAX TrainState at rank 8 as numpy, in the shapes and
    dtypes of the JAX model's and optimizer's ``init`` (traced, never
    run), filled with seeded values, and its optimizer."""
    cfg = jax_get_config("llama-60m", smoke=True)
    opt = jax_get_optimizer("subtrack", rank=RANK)
    shapes = jax.eval_shape(lambda key: (lambda p: JTrainState(
        params=p, opt=opt.init(p)))(jax_build_model(cfg).init(key)),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)

    def leaf(x):
        if x.dtype == np.int32:
            return np.int32(rng.integers(1, 100))
        return rng.standard_normal(x.shape).astype(x.dtype)

    def node(st):
        if not isinstance(st, JMatrixOptState):
            return jax.tree.map(leaf, st)
        m, r = st.S.shape[-2:]
        q = np.linalg.qr(rng.standard_normal(st.S.shape[:-1] + (m,)))[0]
        return JMatrixOptState(S=q[..., :r].astype(np.float32),
                               M=leaf(st.M), V=np.abs(leaf(st.V)),
                               lam_prev=leaf(st.lam_prev))

    state = jax.tree.map(node, shapes,
                         is_leaf=lambda x: isinstance(x, JMatrixOptState))
    return state, opt


def _mesh_run(ctx, layout: str):
    """(like, descriptors, spec tree) of a rank-8 smoke-llama run on
    ``ctx`` whose optimizer shards by ``layout``."""
    cfg = get_config("llama-60m", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(1))
    regimes, row_state = LAYOUTS[layout]
    specs = sharding.hotpath_param_specs(params, ctx, RANK, regimes=regimes,
                                         row_state=row_state)
    opt = get_optimizer("subtrack", rank=RANK, use_kernels=True, mesh=ctx,
                        param_specs=specs, row_state=row_state)
    like = TrainState(params=params, opt=opt.init(params))
    descs = checkpoint_descriptors(params, opt)
    return like, descs, train_state_shardings(like, descs, ctx)


def _regimes(descs) -> set:
    return {d.regime for d in xp.descriptor_leaves(descs)
            if d.kind == "lowrank"}


def _restore_on_ranks(g: int, layout: str, root: Path, logical: list):
    """Restore ``root``'s newest step on ``g`` ranks under ``layout``;
    per rank: the regimes its programs hold, the step, how many leaves
    are sharded, and whether every leaf equals that rank's view of
    ``logical`` (the state's leaves in flatten order) bit for bit."""
    def rank_fn(rank, pg, new_group):
        ctx = tmesh.host_context(group=pg, new_group=new_group)
        like, descs, shardings = _mesh_run(ctx, layout)
        got, step = CheckpointManager(root, mesh=ctx).restore(
            like, shardings=shardings, loader=elastic_loader(descs, ctx))
        views = manager_mod.local_views(
            manager_mod.tree_unflatten(like, logical), shardings, ctx)
        leaves = manager_mod.tree_flatten(got)
        return {"regimes": _regimes(descs), "step": step,
                "sharded": sum(any(sp) for sp in manager_mod.leaf_specs(
                    like, shardings)),
                "same": [_bits(a) == _bits(b)
                         for a, b in zip(leaves, views)],
                "shapes_differ": any(np.shape(a) != np.shape(b)
                                     for a, b in zip(leaves, logical))}

    return on_ranks(g, rank_fn)


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("layout", ["row", "row-rs", "column"])
def test_jax_checkpoint_restores_onto_port_ranks_bit_for_bit(
        tmp_path, jax_state, layout, g):
    jstate, jopt = jax_state
    extra = jxp.state_program_records(jstate,
                                      jax_descriptors(jstate.params, jopt))
    assert {r.get("regime") for r in extra["state_programs"]} <= {
        None, "replicated"}                   # written on one device
    JCheckpointManager(tmp_path).save(9, jstate, blocking=True,
                                      extra_meta=extra, known_good=True)
    logical = [_to_torch(x) for x in jax.tree.leaves(jstate)]
    runs = _restore_on_ranks(g, layout, tmp_path, logical)
    for r in runs:
        assert r["step"] == 9 and all(r["same"])
        assert layout in r["regimes"] and r["sharded"] > 0
        assert r["shapes_differ"]             # the ranks hold shards


def test_port_checkpoint_on_four_ranks_restores_in_jax_and_on_two(
        tmp_path, jax_state):
    jstate, jopt = jax_state
    logical = [_to_torch(x) for x in jax.tree.leaves(jstate)]

    def writer(rank, pg, new_group):
        ctx = tmesh.host_context(group=pg, new_group=new_group)
        like, descs, shardings = _mesh_run(ctx, "auto")
        state = manager_mod.tree_unflatten(like, manager_mod.local_views(
            manager_mod.tree_unflatten(like, logical), shardings, ctx))
        mgr = CheckpointManager(tmp_path, mesh=ctx)
        mgr.save(4, state, blocking=True, known_good=True,
                 extra_meta=state_program_records(state, descs),
                 shardings=shardings)
        gathered = [sharding.gather(x, sp, ctx)
                    if isinstance(x, torch.Tensor) else x
                    for x, sp in zip(manager_mod.tree_flatten(state),
                                     manager_mod.leaf_specs(state,
                                                            shardings))]
        return {"regimes": _regimes(descs), "gathered": gathered,
                "wrote": bool(mgr.last_save)}

    runs = on_ranks(4, writer)
    assert [r["wrote"] for r in runs] == [True, False, False, False]
    assert {"column", "row", "row-rs"} & runs[0]["regimes"]
    gathered = runs[0]["gathered"]
    for r in runs:
        assert [_bits(a) for a in r["gathered"]] == \
            [_bits(a) for a in gathered]
    assert [_bits(a) for a in gathered] == [_bits(a) for a in logical]
    records = manager_mod.load_manifest(
        tmp_path / "step_0000000004")["extra"]["state_programs"]
    assert {r.get("shards") for r in records} >= {4}

    back, step = JCheckpointManager(tmp_path).restore(
        jstate, loader=jxp.elastic_loader(jax_descriptors(jstate.params,
                                                          jopt)))
    assert step == 4
    assert [np.asarray(x).tobytes() for x in jax.tree.leaves(back)] == \
        [_bits(a) for a in gathered]
    for r in _restore_on_ranks(2, "row-rs", tmp_path, gathered):
        assert r["step"] == 4 and all(r["same"]) and r["sharded"] > 0


# ---------------------------------------------------------------------------
# The host-side pieces, against the JAX package's
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except BaseException as e:           # noqa: BLE001 (compared)
        return (type(e).__name__, str(e))


DEADLINE_CASES = {
    "timeout": (lambda: time.sleep(1.0), 0.1),
    "value": (lambda: 41 + 1, 5.0),
    "raises": (lambda: (_ for _ in ()).throw(ValueError("boom")), 5.0),
    "inline": (lambda: "inline", 0.0),
}


@pytest.mark.parametrize("case", list(DEADLINE_CASES))
def test_deadline_matches_the_jax_package(case):
    fn, timeout = DEADLINE_CASES[case]
    got = _outcome(lambda: ttrain._deadline(fn, timeout, "unit drain"))
    want = _outcome(lambda: jtrain._deadline(fn, timeout, "unit drain"))
    assert got == want
    if case == "timeout":
        assert got[0] == "MeshLostError" and "deadline exceeded" in got[1]


def _simulate(mod, mode: str, hang_s: float = 0.05) -> list:
    """The outcomes of a simulator armed at step 5, checked at dispatch
    and drain from step 4 to 6, then disarmed."""
    sim = mod.SimulatedDeviceLoss()
    sim.arm(5, survivors=["d0", "d1"], mode=mode, hang_s=hang_s)
    out = []
    for step, where in [(4, "dispatch"), (4, "drain"), (5, "dispatch"),
                        (5, "drain"), (6, "drain")]:
        try:
            sim.check(step, where)
            out.append(None)
        except mod.MeshLostError as e:
            out.append((str(e), e.survivors, e.step))
    sim.disarm()
    sim.check(9, "dispatch")
    return out + [sim.armed]


@pytest.mark.parametrize("mode", ["raise", "hang"])
def test_simulated_device_loss_matches_the_jax_package(mode):
    t0 = time.perf_counter()
    got = _simulate(tmesh, mode)
    assert got == _simulate(jmesh, mode)
    assert got[-1] is False and got[0] is None and got[1] is None
    if mode == "hang":
        assert got[2] is None and got[3][2] == 5    # only the drain hangs
        assert time.perf_counter() - t0 >= 0.1
    else:
        assert got[2][1] == ["d0", "d1"] and got[2][2] == 5


@pytest.mark.parametrize("spec", ["dev-loss@15,preempt@30,slow-host@9",
                                  "rack-fire@3", ""])
def test_parse_injections_matches_the_jax_package(spec):
    assert _outcome(lambda: ttrain.parse_injections(spec)) == \
        _outcome(lambda: jtrain.parse_injections(spec))


def test_mesh_lost_verdict_matches_the_jax_package():
    out = []
    for mod in (ttrain, jtrain):
        s = mod.HealthSentinel()
        acts = [s.mesh_lost(7, "collective hung"),
                s.mesh_lost(3, "lost device"), s.strike(4, "nan")]
        out.append((acts, s.events, s.strikes, s.rollbacks,
                    s.lr_scale(5)))
    assert out[0] == out[1]
    assert out[0][0] == ["failover", "failover", "skip"]
    assert out[0][1][0]["verdict"] == ttrain.HealthSentinel.MESH_LOST


def test_degraded_context_renumbers_survivors_and_leaves_the_rest_out():
    def rank_fn(rank, pg, new_group):
        ctx = tmesh.host_context(group=pg, new_group=new_group)
        new = tmesh.degraded_context([3, 1], ctx)
        if new is None:
            return None
        t = torch.tensor([float(rank)])
        new.pg.allreduce([t]).wait()
        return (new.axis_sizes, new.rank, new.members, float(t))

    got = on_ranks(4, rank_fn)
    assert got == [None, ((1, 2), 0, (1, 3), 4.0), None,
                   ((1, 2), 1, (1, 3), 4.0)]
    with pytest.raises(ValueError, match="no surviving devices"):
        tmesh.degraded_context([], abstract_context((1, 2)))


def test_restore_spec_tree_is_the_jax_package_state_layout():
    """``train_state_shardings``' state specs equal the JAX package's
    ``descriptor_state_specs`` on every node of each layout; params,
    ``step`` and ``n_updates`` replicate (the train CLI's ranks hold the
    params whole)."""
    for layout in ("column", "row", "row-rs"):
        like, descs, specs = _mesh_run(abstract_context((1, 4)), layout)
        nodes = _state_nodes(specs.opt.inner)
        dlist = xp.descriptor_leaves(descs)
        assert len(nodes) == len(dlist)
        for d, node in zip(dlist, nodes):
            want = jsh.descriptor_state_specs(
                JStateDescriptor.from_dict(d.to_dict()))
            if want is None:
                assert all(sp == () for sp in node)
                continue
            assert [_norm(s) for s in node] == [_norm(tuple(w))
                                                for w in want]
        assert all(sp == () for sp in tree_leaves(specs.params))
        assert (specs.opt.step, specs.opt.n_updates) == ((), ())


def _state_nodes(inner) -> list:
    """The per-node spec tuples of a state spec tree, in flatten order."""
    if isinstance(inner, dict):
        return [x for k in sorted(inner) for x in _state_nodes(inner[k])]
    return [inner]


def _norm(spec) -> tuple:
    """A spec with every sharded entry as a 1-tuple of axis names."""
    return tuple(None if e is None else (e if isinstance(e, tuple) else (e,))
                 for e in spec)


# ---------------------------------------------------------------------------
# Re-planning on the smaller mesh
# ---------------------------------------------------------------------------


def test_replanning_four_to_two_flips_as_restore_targets_say():
    shapes = {"flip": torch.empty((48, 36), device="meta"),
              "wide": torch.empty((64, 256), device="meta")}
    cfg = LowRankConfig(rank=RANK, update_interval=4, use_kernels=True)

    def descs(g):
        ctx = abstract_context((1, g))
        return state_leaf_descriptors(
            shapes, cfg, mesh=ctx,
            param_specs=sharding.hotpath_param_specs(shapes, ctx, RANK))

    four, two = descs(4), descs(2)
    assert four["flip"].regime == "replicated"          # n/4, m/4 < 2r
    assert two["flip"].regime == "column" and two["flip"].shards == 2
    assert (four["wide"].regime, four["wide"].shards) == ("column", 4)
    assert (two["wide"].regime, two["wide"].shards) == ("column", 2)
    for name in shapes:
        rec = dict(four[name].to_dict(), path=name)
        both = restore_targets(rec, 2)
        assert both == jxp.restore_targets(rec, 2)
        assert two[name].regime in both["regimes"]
        assert four[name].regime in restore_targets(rec, 4)["regimes"]


# ---------------------------------------------------------------------------
# End to end through train()
# ---------------------------------------------------------------------------

ARGS = ["--arch", "llama-60m", "--smoke", "--batch", "4", "--seq", "32",
        "--update-interval", "4", "--rank", str(RANK), "--warmup", "2",
        "--log-every", "100", "--device", "cpu", "--use-kernels",
        "--eta", "2e-5", "--mesh", "host", "--steps", "10",
        "--checkpoint-every", "3", "--step-timeout", "60"]
# hang mode: a deadline that a healthy step of four loaded threaded ranks
# stays well inside, and a hang past it
MODES = {"raise": [], "hang": ["--step-timeout", "4", "--hang-s", "8"]}


def _train_on_ranks(g: int, argv: list) -> list:
    return on_ranks(g, lambda rank, pg, new_group: ttrain.train(
        argv, group=pg, new_group=new_group))


def _losses_by_step(summary) -> dict:
    """step -> loss, the last occurrence (replays append again)."""
    return {h["step"]: h["loss"] for h in summary["history"]
            if h.get("loss") is not None}


@pytest.fixture(scope="module")
def failovers(tmp_path_factory):
    """The 4-rank dev-loss runs of both modes, and the 2-rank reference
    resumed from a copy of the restored step."""
    root = tmp_path_factory.mktemp("failover")
    out = {}
    for mode, extra in MODES.items():
        ck = root / mode
        out[mode] = (ck, _train_on_ranks(4, ARGS + [
            "--checkpoint-dir", str(ck), "--inject", "dev-loss@7",
            "--survivors", "2", "--dev-loss-mode", mode] + extra))
    ref_ck = root / "ref"
    shutil.copytree(root / "raise" / "step_0000000006",
                    ref_ck / "step_0000000006")
    out["ref"] = (ref_ck, _train_on_ranks(4, ARGS + [
        "--checkpoint-dir", str(ref_ck), "--mesh-devices", "2"]))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_dev_loss_fails_over_and_matches_the_two_rank_run(failovers, mode):
    ck, runs = failovers[mode]
    for r, out in enumerate(runs):
        verdicts = [e for e in out["sentinel_events"]
                    if e.get("verdict") == "mesh-lost"]
        assert out["failovers"] == 1 and len(verdicts) == 1, \
            out["sentinel_events"]
        assert verdicts[0]["step"] == 7, out["sentinel_events"]
        ev = out["failover_events"][0]
        assert (ev["step"], ev["from_devices"], ev["to_devices"]) == (7, 4, 2)
        assert ev["aborted"] == "ProcessGroupGloo.abort"
        if r >= 2:                 # the lost ranks leave cleanly
            assert out["lost"] and not out["in_mesh"]
            assert out["final_loss"] is None
            continue
        assert out["in_mesh"] and out["mesh_devices"] == 2
        assert ev["program_changes"] >= 1
        assert (ev["restored_step"], ev["resume_step"]) == (6, 7)
        assert ev["rebuilt_group"] == "gloo"
        assert np.isfinite(out["final_loss"])
    # the same checkpoint as the reference resumed from
    assert (ck / "step_0000000006" / "data.bin").read_bytes() == \
        (failovers["ref"][0] / "step_0000000006" / "data.bin").read_bytes()
    ref = failovers["ref"][1]
    assert [o["in_mesh"] for o in ref] == [True, True, False, False]
    assert ref[0]["mesh_devices"] == 2 and ref[0]["start_step"] == 7
    for r in (0, 1):
        got, want = _losses_by_step(runs[r]), _losses_by_step(ref[r])
        steps = range(7, 10)
        np.testing.assert_allclose([got[s] for s in steps],
                                   [want[s] for s in steps], rtol=1e-5)
        assert runs[r]["launch_counts"] == ref[r]["launch_counts"]


def test_dev_loss_then_preempt_resumes_to_completion(tmp_path):
    """One rank on this (main) thread, where the preemption handler
    installs: a 1 -> 1 failover, then a clean preemption exit, then an
    automatic resume to the end."""
    ck = str(tmp_path / "ck")
    out = ttrain.train(ARGS + ["--checkpoint-dir", ck,
                               "--inject", "dev-loss@4,preempt@7"])
    assert out["failovers"] == 1 and out["preempted"] is True
    assert out["failover_events"][0]["restored_step"] == 3
    assert (tmp_path / "ck" / "RESUME").exists()
    assert 7 in CheckpointManager(ck).known_good_steps()
    resumed = ttrain.train(ARGS + ["--checkpoint-dir", ck])
    assert not (tmp_path / "ck" / "RESUME").exists()
    assert resumed["start_step"] == 8 and not resumed["preempted"]
    assert np.isfinite(resumed["final_loss"])


def test_exhausted_max_failovers_raises(tmp_path):
    with pytest.raises(tmesh.MeshLostError, match="after 1 failover"):
        ttrain.train(ARGS + ["--checkpoint-dir", str(tmp_path / "ck"),
                             "--inject", "dev-loss@4,dev-loss@8",
                             "--max-failovers", "1"])


def test_dev_loss_without_checkpoint_dir_raises():
    with pytest.raises(tmesh.MeshLostError, match="no --checkpoint-dir"):
        ttrain.train(ARGS + ["--inject", "dev-loss@2"])


# ---------------------------------------------------------------------------
# The checkpoint inspector
# ---------------------------------------------------------------------------


def _dump_ckpt():
    spec = importlib.util.spec_from_file_location(
        "dump_ckpt", ROOT / "tools" / "dump_ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_inspector_prints_what_dump_ckpt_prints(tmp_path, jax_state):
    jstate, _ = jax_state
    logical = [_to_torch(x) for x in jax.tree.leaves(jstate)]
    like, descs, _ = _mesh_run(abstract_context((1, 4)), "auto")
    state = manager_mod.tree_unflatten(like, logical)
    mgr = CheckpointManager(tmp_path)
    extra = state_program_records(state, descs)
    mgr.save(3, state, blocking=True, extra_meta=extra, known_good=True)
    mgr.save(5, state, blocking=True, extra_meta=extra)
    (tmp_path / "step_0000000006.tmp").mkdir()
    dump = _dump_ckpt()
    argv = [str(tmp_path), "--leaves", "--verify", "--target-mesh", "2",
            "--target-mesh", "8"]
    got, want = _printed(tinspect.main, argv), _printed(dump.main, argv)
    assert got == want and got[0] == 0
    text = got[1]
    assert "[3*, 5]" in text and "step_0000000006.tmp" in text
    assert "column" in text and "row" in text
    assert _printed(tinspect.main, argv + ["--step", "3"]) == \
        _printed(dump.main, argv + ["--step", "3"])
    # damage one leaf's bytes: --verify names it
    manifest = manager_mod.load_manifest(tmp_path / "step_0000000005")
    leaf = 7
    data = tmp_path / "step_0000000005" / "data.bin"
    raw = bytearray(data.read_bytes())
    raw[manifest["leaves"][leaf]["offset"]] ^= 0xFF
    data.write_bytes(bytes(raw))
    got, want = _printed(tinspect.main, argv), _printed(dump.main, argv)
    assert got == want and got[0] == 1
    assert f"LEAF {leaf} DAMAGED: crc32 mismatch" in got[1]
