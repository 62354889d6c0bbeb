"""The port's checkpoints against the JAX package's, on the CPU.

* The manifest codec against the ``msgpack`` package under hypothesis:
  the same bytes for the same value, and each reads the other's.
* Checkpoints across frameworks: the JAX package's ``CheckpointManager``
  saves a smoke-llama ``TrainState`` (bf16 params, fp32 S / M / V /
  ``lam_prev``, int32 ``step`` / ``n_updates``; made by the JAX
  optimizer's ``init`` and filled with seeded numpy values, no step
  compiled), with zstd leaves and with raw ones, and the port restores it
  bit for bit; the port's checkpoint loads with the JAX package's
  ``load_pytree`` and elastic loader bit for bit, and both write the same
  descriptor records.
* Transposes: ``transpose_matrix_state`` against the JAX package's on
  every row of its table (identity bitwise, the others within 1e-6), and
  a JAX checkpoint at rank 8 elastic-restores into the port at ranks 4
  and 12 as the JAX package's own elastic loader restores it.
* The manager: the JAX package's manager cases (``tests/test_checkpoint.py``)
  on the port's, with torch trees: round trips of every dtype and shape,
  damage fallbacks, retry, known-good tags and rollback, bounded waits,
  async interleavings, the resume marker, and a zstd leaf without
  ``zstandard``.
"""

import functools
import threading
import time

import jax
import msgpack
import numpy as np
import pytest
import torch

import repro.checkpoint.manager as jmanager
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import transpose as jxp
from repro.configs.registry import get_config as jax_get_config
from repro.core.api import get_optimizer as jax_get_optimizer
from repro.core.lowrank_adam import MatrixOptState as JMatrixOptState
from repro.core.program import StateDescriptor as JStateDescriptor
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import checkpoint_descriptors as jax_descriptors
from repro.models.api import build_model as jax_build_model
import repro_torch.checkpoint.manager as manager_mod
from repro_torch.checkpoint import (CheckpointManager, TransposeError,
                                    elastic_loader, load_manifest,
                                    load_pytree, save_pytree,
                                    state_program_records,
                                    transpose_matrix_state)
from repro_torch.checkpoint import msgpack_codec
from repro_torch.checkpoint import transpose as xp
from repro_torch.configs.registry import get_config
from repro_torch.core.api import get_optimizer
from repro_torch.core.lowrank_adam import MatrixOptState
from repro_torch.core.program import StateDescriptor
from repro_torch.launch.steps import TrainState, checkpoint_descriptors
from repro_torch.models.api import build_model
from torch_threads import one_thread  # noqa: F401


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


def test_codec_matches_msgpack_under_hypothesis():
    from hypothesis import given, settings, strategies as st

    scalars = (st.none() | st.booleans()
               | st.integers(-2 ** 63, 2 ** 64 - 1)
               | st.floats(allow_nan=False) | st.text() | st.binary())
    values = st.recursive(
        scalars, lambda inner: st.lists(inner, max_size=20)
        | st.dictionaries(st.text(), inner, max_size=20), max_leaves=60)

    @settings(max_examples=50, deadline=None)
    @given(values)
    def check(x):
        ours = msgpack_codec.packb(x)
        assert ours == msgpack.packb(x, use_bin_type=True)
        assert msgpack.unpackb(ours, raw=False) == x
        assert msgpack_codec.unpackb(ours) == x

    check()


@pytest.mark.parametrize("x", [
    "a" * 31, "a" * 32, "é" * 200, b"\x00" * 256, list(range(16)),
    {str(i): i for i in range(16)}, list(range(70000)), 2 ** 64 - 1,
    -2 ** 63, -33, -32, 127, 128, 1.5])
def test_codec_length_and_width_boundaries(x):
    packed = msgpack.packb(x, use_bin_type=True)
    assert msgpack_codec.packb(x) == packed
    assert msgpack_codec.unpackb(packed) == x


def test_codec_refuses_what_it_does_not_carry():
    with pytest.raises(TypeError):
        msgpack_codec.packb({"x": object()})
    with pytest.raises(OverflowError):
        msgpack_codec.packb(2 ** 64)
    with pytest.raises(ValueError, match="truncated"):
        msgpack_codec.unpackb(msgpack.packb([1, 2, 3])[:-1])
    with pytest.raises(ValueError, match="after"):
        msgpack_codec.unpackb(msgpack.packb(1) + b"\x01")


# ---------------------------------------------------------------------------
# Across frameworks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_state(rank: int):
    """A smoke-llama JAX TrainState at ``rank`` as numpy, in the shapes and
    dtypes of the JAX model's and optimizer's ``init`` (traced, never
    run), filled with seeded values: every basis S orthonormal, every V
    positive, ``step`` and ``n_updates`` int32."""
    cfg = jax_get_config("llama-60m", smoke=True)
    opt = jax_get_optimizer("subtrack", rank=rank)
    shapes = jax.eval_shape(lambda key: (lambda p: JTrainState(
        params=p, opt=opt.init(p)))(jax_build_model(cfg).init(key)),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(rank)

    def leaf(x):
        if x.dtype == np.int32:
            return np.int32(rng.integers(1, 100))
        return np.abs(rng.standard_normal(x.shape)).astype(x.dtype)

    def node(st):
        if not isinstance(st, JMatrixOptState):
            return jax.tree.map(leaf, st)
        m, r = st.S.shape[-2:]
        q = np.linalg.qr(rng.standard_normal(st.S.shape[:-1] + (m,)))[0]
        return JMatrixOptState(S=q[..., :r].astype(np.float32),
                               M=leaf(st.M), V=leaf(st.V),
                               lam_prev=leaf(st.lam_prev))

    state = jax.tree.map(node, shapes,
                         is_leaf=lambda x: isinstance(x, JMatrixOptState))
    return state, opt


def _port_like(rank: int):
    cfg = get_config("llama-60m", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(1))
    opt = get_optimizer("subtrack", rank=rank)
    return TrainState(params=params, opt=opt.init(params)), opt


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy().tobytes()
    if isinstance(x, int):
        return np.int32(x).tobytes()
    return np.asarray(x).tobytes()


def _same_bits(port_tree, jax_tree):
    got = manager_mod.tree_flatten(port_tree)
    want = jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(getattr(g, "shape", ())) == w.shape, i
        if isinstance(g, torch.Tensor):
            assert manager_mod._NAMES[g.dtype] == str(w.dtype), i
        assert _bits(g) == w.tobytes(), i


@pytest.mark.parametrize("zstd", [True, False], ids=["zstd", "raw"])
def test_jax_checkpoint_restores_into_the_port_bit_for_bit(
        tmp_path, monkeypatch, zstd):
    jstate, _ = _jax_state(32)
    monkeypatch.setattr(jmanager, "_HAS_ZSTD", zstd and jmanager._HAS_ZSTD)
    JCheckpointManager(tmp_path).save(7, jstate, blocking=True,
                                      known_good=True)
    leaves = load_manifest(tmp_path / "step_0000000007")["leaves"]
    assert all(m["compressed"] == (zstd and jmanager._HAS_ZSTD)
               for m in leaves)
    like, _ = _port_like(32)
    got, step = CheckpointManager(tmp_path).restore(like)
    assert step == 7 and isinstance(got, TrainState)
    assert isinstance(got.opt.step, int) and isinstance(got.opt.n_updates,
                                                        int)
    assert got.params["embed"].dtype == torch.bfloat16
    assert isinstance(got.opt.inner["layers"]["attn"]["wq"], MatrixOptState)
    _same_bits(got, jstate)
    assert CheckpointManager(tmp_path).rollback(like)[1] == 7


def test_port_checkpoint_loads_in_the_jax_package_bit_for_bit(tmp_path):
    jstate, jopt = _jax_state(32)
    like, opt = _port_like(32)
    src = manager_mod.tree_unflatten(like, [
        torch.from_numpy(np.array(x).view(np.int16)).view(torch.bfloat16)
        if np.asarray(x).dtype.name == "bfloat16"
        else int(x) if np.asarray(x).ndim == 0 and np.asarray(
            x).dtype == np.int32
        else torch.from_numpy(np.array(x)) for x in jax.tree.leaves(jstate)])
    descs = checkpoint_descriptors(src.params, opt)
    extra = state_program_records(src, descs)
    assert extra == jxp.state_program_records(
        jstate, jax_descriptors(jstate.params, jopt))
    CheckpointManager(tmp_path).save(3, src, blocking=True,
                                     extra_meta=extra)
    path = tmp_path / "step_0000000003"
    manifest = jmanager.load_manifest(path)
    assert manifest["format"] == "repro-ckpt-v1"
    assert not any(m["compressed"] for m in manifest["leaves"])
    for back in (jmanager.load_pytree(path, jstate),
                 jxp.elastic_loader(jax_descriptors(jstate.params, jopt))(
                     path, jstate, None)):
        _same_bits(src, back)
        for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_port_descriptors_match_jax():
    jstate, jopt = _jax_state(32)
    like, opt = _port_like(32)
    for name in ("subtrack", "adamw"):
        kw = {"rank": 32, "method": "grass"} if name == "subtrack" else {}
        got = xp.descriptor_leaves(checkpoint_descriptors(
            like.params, get_optimizer(name, **kw)))
        want = jxp.descriptor_leaves(jax_descriptors(
            jstate.params, jax_get_optimizer(name, **kw)))
        assert [d.to_dict() for d in got] == [d.to_dict() for d in want]


@pytest.mark.parametrize("rank", [4, 12])
def test_jax_rank_8_checkpoint_elastic_restores_at_rank(tmp_path, rank):
    jstate, jopt = _jax_state(8)
    extra = jxp.state_program_records(jstate,
                                      jax_descriptors(jstate.params, jopt))
    JCheckpointManager(tmp_path).save(5, jstate, blocking=True,
                                      extra_meta=extra)
    like, opt = _port_like(rank)
    got, step = CheckpointManager(tmp_path).restore(
        like, loader=elastic_loader(checkpoint_descriptors(like.params,
                                                           opt)))
    jlike, jopt_t = _jax_state(rank)
    want = jxp.elastic_loader(jax_descriptors(jlike.params, jopt_t))(
        tmp_path / "step_0000000005", jlike, None)
    assert step == 5
    for g, w in zip(manager_mod.tree_flatten(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16" or w.ndim == 0:
            assert _bits(g) == w.tobytes()
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
    S = got.opt.inner["layers"]["mlp"]["w_up"].S
    assert S.shape[-1] == rank
    eye = torch.eye(rank).expand(S.shape[:-2] + (rank, rank))
    torch.testing.assert_close(S.mT @ S, eye, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# Transposes, row by row
# ---------------------------------------------------------------------------


def _desc(cls, rank=16, method="grassmann", m=32, n=64, batch_dims=0):
    return cls(kind="lowrank", m=m, n=n, rank=rank, method=method,
               batch_dims=batch_dims)


def _mstate(m=32, n=64, r=16, lead=(), seed=0, one_hot=False):
    rng = np.random.default_rng(seed)
    S = (np.eye(m, r, dtype=np.float32) * np.ones(lead + (1, 1), np.float32)
         if one_hot else np.linalg.qr(rng.standard_normal(lead + (m, m)))[0]
         [..., :r].astype(np.float32))
    return [np.ascontiguousarray(S),
            rng.standard_normal(lead + (r, n)).astype(np.float32),
            rng.uniform(size=lead + (r, n)).astype(np.float32),
            np.ones(lead, np.float32)]


ROWS = {  # row -> (source rank, method, target rank, method, one-hot S)
    "identity": (16, "grassmann", 16, "grassmann", False),
    "truncate": (16, "grassmann", 8, "grassmann", False),
    "pad": (16, "grassmann", 24, "grassmann", False),
    "pad grass": (16, "grass", 20, "grass", True),
    "to grass": (16, "grassmann", 12, "grass", False),
    "grass to dense basis": (16, "grass", 16, "grassmann", True),
}


@pytest.mark.parametrize("lead", [(), (3,)], ids=["matrix", "stack"])
@pytest.mark.parametrize("row", list(ROWS))
def test_transpose_matrix_state_matches_jax(row, lead):
    r_s, m_s, r_t, m_t, one_hot = ROWS[row]
    arrays = _mstate(r=r_s, lead=lead, one_hot=one_hot)
    bd = len(lead)
    want = jxp.transpose_matrix_state(
        JMatrixOptState(*arrays), _desc(JStateDescriptor, r_s, m_s,
                                        batch_dims=bd),
        _desc(JStateDescriptor, r_t, m_t, batch_dims=bd))
    st = MatrixOptState(*(torch.from_numpy(a) for a in arrays))
    got = transpose_matrix_state(st, _desc(StateDescriptor, r_s, m_s,
                                           batch_dims=bd),
                                 _desc(StateDescriptor, r_t, m_t,
                                       batch_dims=bd))
    if row in ("identity", "grass to dense basis"):
        assert got is st
        return
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
        assert g.dtype == torch.float32


def test_inadmissible_transposes_raise():
    st = MatrixOptState(*(torch.from_numpy(a) for a in _mstate()))
    with pytest.raises(TransposeError, match=r"\(m, n\) changed"):
        transpose_matrix_state(st, _desc(StateDescriptor),
                               _desc(StateDescriptor, n=128))
    with pytest.raises(TransposeError, match="stack dims"):
        transpose_matrix_state(st, _desc(StateDescriptor),
                               _desc(StateDescriptor, batch_dims=1))
    with pytest.raises(TransposeError, match="mode changed"):
        transpose_matrix_state(st, _desc(StateDescriptor),
                               StateDescriptor(kind="dense"))
    with pytest.raises(TransposeError, match="does not match"):
        transpose_matrix_state(st, _desc(StateDescriptor, m=16),
                               _desc(StateDescriptor, 8, m=16))


def test_record_count_mismatch_raises(tmp_path):
    st = {"opt": MatrixOptState(*(torch.from_numpy(a) for a in _mstate()))}
    save_pytree(tmp_path / "ck", st, extra_meta=state_program_records(
        st, {"opt": _desc(StateDescriptor)}))
    with pytest.raises(Exception, match="count mismatch"):
        elastic_loader({"opt": _desc(StateDescriptor),
                        "opt2": _desc(StateDescriptor)})(tmp_path / "ck", st)


# ---------------------------------------------------------------------------
# The manager (the JAX package's cases on the port's)
# ---------------------------------------------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(32, 16, generator=g).bfloat16(),
                       "b": torch.arange(16, dtype=torch.float32)},
            "opt": {"m": torch.randn(8, 16, generator=g), "step": 42}}


def _equal(a, b):
    for x, y in zip(manager_mod.tree_flatten(a), manager_mod.tree_flatten(b)):
        assert type(x) is type(y)
        assert _bits(x) == _bits(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape


DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
          torch.int64, torch.int32, torch.int8, torch.uint8, torch.bool)
SHAPES = ((), (3,), (2, 5), (0, 3), (4, 0, 2))


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_every_dtype_and_shape_round_trips(tmp_path, shape):
    g = torch.Generator().manual_seed(0)
    tree = {f"{dt}": (torch.randn(shape, generator=g) * 10).to(dt)
            for dt in DTYPES}
    save_pytree(tmp_path / "ck", tree, extra_meta={"step": 12,
                                                   "nested": {"f": 0.5}})
    _equal(load_pytree(tmp_path / "ck", tree), tree)
    assert load_manifest(tmp_path / "ck")["extra"] == {"step": 12,
                                                       "nested": {"f": 0.5}}


def test_structure_mismatch_and_shape_mismatch_raise(tmp_path):
    save_pytree(tmp_path / "ck", _tree())
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(tmp_path / "ck", {"just": torch.zeros(3)})
    bad = _tree()
    bad["opt"]["m"] = torch.zeros(8, 15)
    with pytest.raises(ValueError, match="leaf shape"):
        load_pytree(tmp_path / "ck", bad)


def test_snapshot_is_taken_at_save(tmp_path):
    """The save copies the tree when called: an in-place update after the
    call (the trainer's next step) does not reach the checkpoint."""
    tree = _tree()
    want = {"params": {k: v.clone() for k, v in tree["params"].items()},
            "opt": dict(tree["opt"], m=tree["opt"]["m"].clone())}
    mgr = CheckpointManager(tmp_path)
    mgr.hang_next_save(0.2)
    mgr.save(1, tree)
    tree["params"]["w"].add_(1)
    tree["opt"]["m"].mul_(2)
    mgr.wait()
    _equal(mgr.restore(_tree())[0], want)
    assert mgr.last_save["bytes"] == 32 * 16 * 2 + 16 * 4 + 8 * 16 * 4 + 4


def test_async_save_restore_gc_and_backpressure(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 5, 9):
        mgr.save(s, _tree(seed=s))          # each waits on the last
    mgr.wait()
    assert mgr.steps() == [5, 9]
    back, step = mgr.restore(_tree())
    assert step == 9
    _equal(back, _tree(seed=9))
    assert CheckpointManager(tmp_path / "empty").restore(_tree()) is None


def _flip_byte(path, at=10):
    data = path.read_bytes()
    path.write_bytes(data[:at] + bytes([data[at] ^ 0xFF]) + data[at + 1:])


def _damage(tmp_path, how):
    if how == "orphaned tmp":
        crashed = tmp_path / "step_0000000009.tmp"
        crashed.mkdir()
        (crashed / "data.bin").write_bytes(b"\x00" * 100)
        return 7
    raw = tmp_path / "step_0000000007" / "data.bin"
    if how == "truncated":
        raw.write_bytes(raw.read_bytes()[:-7])
    elif how == "crc flip":
        _flip_byte(raw)
    elif how == "missing data":
        raw.unlink()
    return 3


@pytest.mark.parametrize("how", ["orphaned tmp", "truncated", "crc flip",
                                 "missing data"])
def test_damaged_newest_falls_back(tmp_path, how):
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(3, _tree(3), blocking=True)
    mgr.save(7, _tree(7), blocking=True)
    want = _damage(tmp_path, how)
    back, step = mgr.restore(_tree())
    assert step == want
    _equal(back, _tree(want))


def test_all_damaged_returns_none_and_explicit_step_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    for s in (3, 7):
        mgr.save(s, _tree(s), blocking=True)
    _flip_byte(tmp_path / "step_0000000007" / "data.bin")
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(_tree(), step=7)
    _flip_byte(tmp_path / "step_0000000003" / "data.bin")
    assert mgr.restore(_tree()) is None


def test_zstd_leaf_without_zstandard_raises(tmp_path, monkeypatch):
    """A leaf that says it is compressed needs ``zstandard``; without it
    the load raises the JAX package's IOError, never a silent skip."""
    tree = {"a": np.arange(6, dtype=np.float32)}
    jmanager.save_pytree(tmp_path / "ck", tree)
    if not load_manifest(tmp_path / "ck")["leaves"][0]["compressed"]:
        pytest.skip("zstandard is not installed beside the JAX package")
    like = {"a": torch.zeros(6)}
    torch.testing.assert_close(load_pytree(tmp_path / "ck", like)["a"],
                               torch.arange(6.0), atol=0, rtol=0)
    monkeypatch.setitem(__import__("sys").modules, "zstandard", None)
    with pytest.raises(IOError, match="zstandard is not installed"):
        load_pytree(tmp_path / "ck", like)


@pytest.mark.parametrize("fails,retries,blocking,lands", [
    (2, 3, True, True), (1, 2, False, True), (1, 0, False, False)])
def test_save_retry(tmp_path, fails, retries, blocking, lands):
    mgr = CheckpointManager(tmp_path, retries=retries, backoff_s=0.001)
    mgr.fail_next_saves(fails)
    if lands:
        mgr.save(1, _tree(), blocking=blocking)
        mgr.wait()
        assert mgr.steps() == [1]
        return
    mgr.save(1, _tree(), blocking=blocking)
    with pytest.raises(OSError, match="injected checkpoint I/O"):
        mgr.wait()
    assert mgr.steps() == []
    mgr.save(2, _tree(), blocking=True)     # raised once, then recovers
    assert mgr.steps() == [2]


def test_known_good_tags_and_rollback(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=10)
    for s, good in ((1, True), (2, False), (3, True), (4, False)):
        mgr.save(s, _tree(seed=s), blocking=True, known_good=good)
    assert mgr.known_good_steps() == [1, 3]
    assert not (tmp_path / "step_0000000002"
                / CheckpointManager.KNOWN_GOOD_MARKER).exists()
    tree, step = mgr.rollback(_tree())
    assert step == 3
    _equal(tree, _tree(seed=3))
    assert mgr.rollback(_tree(), before=3)[1] == 1
    (tmp_path / "step_0000000003" / "data.bin").unlink()
    assert mgr.rollback(_tree())[1] == 1
    untagged = CheckpointManager(tmp_path / "u")
    untagged.save(1, _tree(), blocking=True)
    assert untagged.rollback(_tree()) is None


def test_gc_preserves_newest_known_good(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(1, _tree(seed=1), blocking=True, known_good=True)
    for s in (2, 3, 4):
        mgr.save(s, _tree(seed=s), blocking=True)
    assert mgr.steps() == [1, 3, 4]
    mgr.save(5, _tree(seed=5), blocking=True, known_good=True)
    mgr.save(6, _tree(seed=6), blocking=True)
    assert 1 not in mgr.steps() and mgr.known_good_steps() == [5]


def test_bounded_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.hang_next_save(0.5)
    mgr.save(1, _tree())
    with pytest.raises(TimeoutError, match="presumed hung"):
        mgr.wait(timeout=0.05)
    mgr.wait()                    # joins the abandoned worker again
    assert mgr.steps() == [1]
    mgr.save(2, _tree())
    mgr.wait(timeout=30.0)
    failing = CheckpointManager(tmp_path / "f", retries=0)
    failing.fail_next_saves(1)
    failing.save(1, _tree())
    with pytest.raises(OSError, match="injected"):
        failing.wait(timeout=30.0)


def test_interleave_while_worker_mid_write(tmp_path, monkeypatch):
    """With the worker held mid-write: steps(), restore() and _gc() see
    only complete checkpoints, and a second save blocks until the first
    lands."""
    real = manager_mod.save_pytree
    gate, entered = threading.Event(), threading.Event()

    def held(path, tree, extra_meta=None, marker=None):
        entered.set()
        assert gate.wait(30), "test deadlock: gate never released"
        real(path, tree, extra_meta, marker=marker)

    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(1, _tree(1), blocking=True)
    monkeypatch.setattr(manager_mod, "save_pytree", held)
    mgr.save(2, _tree(2))
    assert entered.wait(30)
    assert mgr.steps() == [1]
    assert mgr.restore(_tree())[1] == 1
    mgr._gc()
    assert mgr.steps() == [1]
    threading.Timer(0.3, gate.set).start()
    t0 = time.time()
    mgr.save(3, _tree(3))
    assert time.time() - t0 >= 0.25
    mgr.wait()
    assert mgr.steps() == [1, 2, 3]


def test_wait_reraises_exactly_once(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, keep=5)

    def boom(path, tree, extra_meta=None, marker=None):
        raise RuntimeError("disk full")

    monkeypatch.setattr(manager_mod, "save_pytree", boom)
    mgr.save(1, _tree())
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()
    mgr.wait()
    mgr.save(2, _tree())
    monkeypatch.setattr(manager_mod, "save_pytree", save_pytree)
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.save(3, _tree())
    mgr.wait()


def test_resume_marker_round_trip_and_consume_once(tmp_path):
    mgr = CheckpointManager(tmp_path)
    assert mgr.consume_resume_marker() is None
    mgr.write_resume_marker(17, reason="preempted (signal 15)")
    rec = mgr.consume_resume_marker()
    assert (rec["step"], rec["reason"]) == (17, "preempted (signal 15)")
    assert mgr.consume_resume_marker() is None
    (tmp_path / CheckpointManager.RESUME_MARKER).write_text("not json")
    assert mgr.consume_resume_marker() == {}
    assert not (tmp_path / CheckpointManager.RESUME_MARKER).exists()
