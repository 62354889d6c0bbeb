"""The port's step health against the JAX package, on the CPU.

* ``make_report`` / ``step_ok`` / ``report_metrics`` over the finite and
  non-finite grid of the JAX package's own report tests, field for field.
* The host ladder: the port's ``HealthSentinel`` and the JAX driver's,
  fed one sequence of (loss, grad norm, quarantined), give the same
  actions, events, quarantined steps and lr backoff; ``parse_injections``
  gives the same tables and the same errors.
* The tracking step's health diagnostic: the port optimizer's
  ``update(..., with_health=True)`` against the JAX package's
  ``track_subspace`` diag on the same numpy S and G, within 1e-5, at a
  small eta, at eta x 1e6 (clamp flag set, theta = THETA_MAX) and on a
  NaN G (degenerate flag set, S stays finite); a plain step's is zero.
* Quarantine: a nan-grad step through ``make_train_step`` leaves every
  param and optimizer-state tensor ``torch.equal`` to its old self, and
  ``step`` / ``n_updates`` unchanged, on plain, tracking, grad-fused and
  ``accum`` 2 steps, for SubTrack++, AdamW and BAdam (the smoke llama,
  fp32, rank 32).  The optimizer writes new state tensors, never its
  inputs: a write into the old state fails these tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import health as jhealth
from repro.core import subspace as jsub
from repro.launch import train as jtrain
from repro_torch.configs.registry import get_config
from repro_torch.core import health
from repro_torch.core.api import get_optimizer
from repro_torch.core.subtrack import OptState, tree_leaves, tree_map
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import (TrainState, make_train_step,
                                      make_warm_start)
from repro_torch.models.api import build_model
from torch_threads import one_thread  # noqa: F401


M, N, RANK = 64, 256, 16

GRID = [(1.0, 2.0, 3.0), (np.nan, 1.0, 1.0), (1.0, np.nan, 1.0),
        (1.0, np.inf, 1.0), (1.0, 1.0, np.nan), (-np.inf, 1.0, 1.0)]


@pytest.mark.parametrize("loss,gnorm,unorm", GRID)
def test_report_matches_jax_on_the_finite_grid(loss, gnorm, unorm):
    diag = np.asarray([0.5, 0.25, 1.0, 0.0], np.float32)
    want = jhealth.make_report(jnp.float32(loss), jnp.float32(gnorm),
                               jnp.float32(unorm), jnp.asarray(diag))
    got = health.make_report(torch.tensor(loss, dtype=torch.float32),
                             torch.tensor(gnorm), torch.tensor(unorm),
                             torch.from_numpy(diag))
    assert bool(health.step_ok(got)) == bool(jhealth.step_ok(want))
    host = health.report_to_host(got)
    for name in health.HealthReport._fields:
        np.testing.assert_array_equal(np.asarray(getattr(host, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    jm, tm = jhealth.report_metrics(want), health.report_metrics(host)
    assert jm.keys() == tm.keys()
    for k in jm:
        np.testing.assert_array_equal(np.asarray(tm[k]), np.asarray(jm[k]),
                                      err_msg=k)


def test_diag_merge_reduce_and_constants_match_jax():
    a = np.asarray([1.0, 0.2, 0.0, 1.0], np.float32)
    b = np.asarray([0.5, np.nan, 1.0, 0.0], np.float32)
    stacked = np.stack([a, b, np.zeros(4, np.float32)])
    np.testing.assert_array_equal(
        health.merge_diag(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jhealth.merge_diag(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        health.reduce_diag(torch.from_numpy(stacked)).numpy(),
        np.asarray(jhealth.reduce_diag(jnp.asarray(stacked))))
    for name in ("DIAG_SIGMA", "DIAG_THETA", "DIAG_CLAMPED",
                 "DIAG_DEGENERATE", "DIAG_SIZE", "THETA_MAX",
                 "INJECT_NONE", "INJECT_NAN_GRAD", "INJECT_LOSS_SPIKE",
                 "LOSS_SPIKE_AMP"):
        assert getattr(health, name) == getattr(jhealth, name), name
    assert ttrain.BLOWUP_ETA_SCALE == jtrain.BLOWUP_ETA_SCALE
    assert ttrain.INJECT_KINDS == jtrain.INJECT_KINDS


def _drive(sentinel, feed):
    acts = []
    for step, (loss, gnorm, quarantined) in enumerate(feed):
        if loss is None:
            acts.append(sentinel.strike(step, "unusable batch (skip-marked)"))
        else:
            acts.append(sentinel.observe(step, loss, gnorm, quarantined))
        if acts[-1] == "rollback":
            sentinel.note_rollback(resume_step=step - 2)
    return acts


def test_sentinel_matches_the_jax_drivers():
    """One sequence through both ladders: warm-up, a quarantined step, a
    non-finite grad norm with a finite loss, a skip-marked batch, spikes
    climbing to rollback, recovery, then enough strikes to abort."""
    rng = np.random.default_rng(0)
    calm = [(6.0 + 0.05 * float(x), 1.0, False) for x in rng.normal(size=8)]
    feed = (calm + [(6.1, 1.0, True), (6.0, np.inf, False),
                    (None, None, None), (40.0, 1.0, False),
                    (41.0, 1.0, False)] + calm
            + [(60.0, 1.0, False)] * 7 + [(np.nan, 1.0, False)] * 3)
    want, got = jtrain.HealthSentinel(), ttrain.HealthSentinel()
    assert _drive(got, feed) == _drive(want, feed)
    assert got.events == want.events
    assert got.quarantined_steps == want.quarantined_steps == [8]
    assert got.rollbacks == want.rollbacks
    assert "abort" in [e["action"] for e in got.events]
    assert [got.lr_scale(s) for s in range(40)] == \
        [want.lr_scale(s) for s in range(40)]


@pytest.mark.parametrize("spec", [
    "", "nan-grad@13,loss-spike@31", "sigma-blowup@8, corrupt-batch@5",
    "preempt@3,slow-host@4,ckpt-io-error@2,dev-loss@9",
    "nan-grad@3,loss-spike@3", "bogus@3", "nan-grad", "nan-grad@x"])
def test_parse_injections_matches_the_jax_drivers(spec):
    def outcome(parse):
        try:
            return parse(spec)
        except BaseException as e:   # SystemExit on an unknown kind
            return type(e), str(e)

    assert outcome(ttrain.parse_injections) == outcome(jtrain.parse_injections)


# ---------------------------------------------------------------------------
# The tracking step's diag
# ---------------------------------------------------------------------------


def _tracking_diag(S, G, eta):
    """The port optimizer's health diag of one tracking step over the one
    leaf ``w`` (stack ``S.shape[:-2]``), and its new S."""
    opt = get_optimizer("subtrack", rank=RANK, eta=eta, use_kernels=True)
    params = {"w": torch.zeros(G.shape)}
    st = opt.init(params)
    st = st._replace(inner={"w": st.inner["w"]._replace(
        S=torch.from_numpy(S))})
    _, new, diag = opt.update({"w": torch.from_numpy(G)}, st, params, 1e-3,
                              do_subspace_update=True, with_health=True)
    return diag.numpy(), new.inner["w"].S.numpy()


def _jax_diag(S, G, eta):
    @jax.jit
    def diag(S, G):
        return jhealth.reduce_diag(jax.vmap(
            lambda s, g: jsub.track_subspace(s, g, eta=eta).diag)(S, G))
    return np.asarray(diag(S.reshape(-1, M, RANK), G.reshape(-1, M, N)))


@pytest.mark.parametrize("case", ["eta", "eta x 1e6", "nan G"])
def test_tracking_diag_matches_jax(case):
    rng = np.random.default_rng(3)
    S = np.linalg.qr(rng.standard_normal((2, M, M)))[0][..., :RANK]
    S = np.ascontiguousarray(S, np.float32)
    G = rng.standard_normal((2, M, N)).astype(np.float32)
    eta = 1e-3 * (1e6 if case == "eta x 1e6" else 1.0)
    if case == "nan G":
        G[1, 3, 5] = np.nan
    got, S_new = _tracking_diag(S, G, eta)
    want = _jax_diag(S, G, eta)
    first = 0
    if case == "nan G":
        # the raw sigma of the NaN matrix is NaN, and the max keeps it, as
        # in the JAX package's eager evaluation; its jit zeroes it
        assert np.isnan(got[health.DIAG_SIGMA])
        first = health.DIAG_THETA
    np.testing.assert_allclose(got[first:], want[first:], rtol=1e-5,
                               atol=1e-5)
    assert np.isfinite(S_new).all()
    if case == "eta":
        assert got[health.DIAG_CLAMPED] == 0 and got[health.DIAG_THETA] < 1
    elif case == "eta x 1e6":
        assert got[health.DIAG_CLAMPED] == 1
        assert got[health.DIAG_THETA] == pytest.approx(health.THETA_MAX)
    else:
        assert got[health.DIAG_DEGENERATE] == 1
        np.testing.assert_array_equal(S_new[1], S[1])   # no rotation


def test_plain_step_diag_is_zero():
    opt = get_optimizer("subtrack", rank=RANK, use_kernels=True)
    params = {"w": torch.zeros(M, N)}
    st = opt.warm_start(opt.init(params), {"w": torch.randn(M, N)})
    _, _, diag = opt.update({"w": torch.randn(M, N)}, st, params, 1e-3,
                            with_health=True)
    assert torch.equal(diag, health.zero_diag())


# ---------------------------------------------------------------------------
# Quarantine bit for bit
# ---------------------------------------------------------------------------


def _state_tensors(state: TrainState) -> list:
    return tree_leaves(state.params) + [
        t for st in tree_leaves(state.opt.inner) for t in st]


def _copy(state: TrainState) -> TrainState:
    return TrainState(
        params=tree_map(torch.clone, state.params),
        opt=OptState(step=state.opt.step, n_updates=state.opt.n_updates,
                     inner=tree_map(lambda st: type(st)(
                         *(t.clone() for t in st)), state.opt.inner)))


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("llama-100m", smoke=True).with_(dtype="float32")
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=32, global_batch=4, seed=0))
    return cfg, [data.global_batch_at(s) for s in range(2)]


@pytest.mark.parametrize("route", ["plain", "tracking", "grad-fused",
                                   "accum 2"])
@pytest.mark.parametrize("name", ["subtrack", "adamw", "badam"])
def test_nan_grad_step_is_quarantined_bit_for_bit(smoke, name, route):
    cfg, batches = smoke
    bundle = build_model(cfg)
    kw = ({"rank": 32, "update_interval": 2, "eta": 2e-5,
           "use_kernels": True} if name == "subtrack"
          else {"block_interval": 1, "n_blocks": 3} if name == "badam"
          else {})
    opt = get_optimizer(name, **kw)
    params = bundle.init(torch.Generator().manual_seed(0))
    state = TrainState(params=params, opt=opt.init(params))
    if name == "subtrack":
        state, _ = make_warm_start(bundle, opt)(state, batches[0])
    step = make_train_step(bundle, opt, accum=2 if route == "accum 2" else 1,
                           grad_fused=route == "grad-fused")
    tracking = route == "tracking"
    state, m0 = step(state, batches[0], 1e-3)       # moments non-zero
    assert not m0["quarantined"]
    before = _copy(state)
    after, m1 = step(state, batches[1], 1e-3, do_subspace_update=tracking,
                     inject=health.INJECT_NAN_GRAD)
    assert float(m1["quarantined"]) == 1.0 and np.isfinite(float(m1["loss"]))
    assert not np.isfinite(float(m1["grad_norm"]))
    assert (after.opt.step, after.opt.n_updates) == \
        (before.opt.step, before.opt.n_updates)
    for a, b in zip(_state_tensors(after), _state_tensors(before)):
        assert torch.equal(a, b)
    # the true loss reached the metrics: the same batch without the fault
    _, m2 = step(after, batches[1], 1e-3, do_subspace_update=tracking)
    assert float(m2["loss"]) == float(m1["loss"])
    assert not m2["quarantined"]


def test_loss_spike_scales_every_update_and_passes_the_gate(smoke):
    """loss-spike multiplies each update by -LOSS_SPIKE_AMP (a power of
    two: the update norm scales exactly) and the step is not
    quarantined: only the host ladder can catch it."""
    cfg, batches = smoke
    bundle = build_model(cfg)
    opt = get_optimizer("subtrack", rank=32, update_interval=2, eta=2e-5,
                        use_kernels=True)
    params = bundle.init(torch.Generator().manual_seed(0))
    state, _ = make_warm_start(bundle, opt)(
        TrainState(params=params, opt=opt.init(params)), batches[0])
    step = make_train_step(bundle, opt)
    base = _copy(state)
    _, ok = step(_copy(base), batches[1], 1e-3)
    spiked, bad = step(base, batches[1], 1e-3,
                       inject=health.INJECT_LOSS_SPIKE)
    assert not bad["quarantined"]
    assert float(bad["update_norm"]) == \
        health.LOSS_SPIKE_AMP * float(ok["update_norm"])
    assert spiked.opt.step == state.opt.step + 1
