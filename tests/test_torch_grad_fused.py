"""The port's grad-fused training step against the JAX package, on the CPU.

Same numpy inputs through both packages, at smoke size:

* the ``grad_tap`` oracle against the JAX oracle, and the Pallas kernel
  (interpret mode) against the port's oracle, b 64, m 256, n 512, r 32;
* ``tapped_matmul``'s backward against the JAX custom VJP, in both
  orientations, and its tap against ``project_colnorms_ref`` of the dW it
  emits;
* ``decoder_loss`` with every site tapped against the JAX ``loss_taps``
  (gradients and taps), and without taps the plain model, bit for bit;
* the grad-fused train step against the JAX ``make_train_step(
  grad_fused=True)`` from the JAX state copied over, with the clip idle
  and firing;
* the CLI with ``--grad-fused`` against the plain CLI.

Budgets: 1e-5 of the largest entry for fp32 (sums in another order; the
JAX package's own, ``tests/test_kernels.py`` and ``test_mesh_fused.py``),
2e-2 for the Pallas kernel on bf16 inputs (``test_kernels.py``), 1e-5 on a
plain train step and 1e-3 on and after a tracking step.  The smoke llama
runs in fp32 (rank 32, eta 2e-5 so theta stays O(1)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.api import get_optimizer as jax_get_optimizer
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.distributed.context import mesh_context
from repro.kernels import grassmann as jgrassmann
from repro.kernels import ref as jref
from repro.launch.mesh import smoke_context
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.steps import make_warm_start as jax_make_warm_start
from repro.models.api import build_model as jax_build_model
from repro.models.common import tapped_matmul as jax_tapped_matmul
from repro_torch.configs import registry as tregistry
from repro_torch.core.api import get_optimizer
from repro_torch.core.subtrack import tree_leaves
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import (TrainState, _site_get, _tap_paths,
                                      _site_set, make_train_step,
                                      value_and_grad)
from repro_torch.models.api import build_model
from repro_torch.models.common import tap_seed, tapped_matmul
from torch_threads import one_thread  # noqa: F401


B, M, N, R = 64, 256, 512, 32
RANK, K, ETA, SEQ, BATCH = 32, 4, 2e-5, 32, 4


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _tap_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, M)).astype(np.float32)
    dy = rng.standard_normal((B, N)).astype(np.float32)
    S = np.linalg.qr(rng.standard_normal((M, R)))[0].astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    return ((torch.tensor(x).to(tdt), torch.tensor(dy).to(tdt),
             torch.tensor(S)),
            (jnp.asarray(x, jdt), jnp.asarray(dy, jdt), jnp.asarray(S)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_tap_oracle_matches_jax_oracle(dtype):
    (x, dy, S), (jx, jdy, jS) = _tap_inputs(dtype)
    got = ref.grad_tap_ref(x, dy, S)
    want = jref.grad_tap_ref(jx, jdy, jS)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(_np(g), _np(w)) < 1e-5
    # the optional leading batch dim: one matrix per index
    stacked = ref.grad_tap_ref(torch.stack([x, 2 * x]),
                               torch.stack([dy, dy]), torch.stack([S, S]))
    for g, w in zip(stacked, got):
        np.testing.assert_array_equal(_np(g[0]), _np(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_grad_tap_matches_port_oracle(dtype):
    (x, dy, S), (jx, jdy, jS) = _tap_inputs(dtype, seed=1)
    got = jgrassmann.grad_tap(jx, jdy, jS, interpret=True)
    want = ref.grad_tap_ref(x, dy, S)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, w in zip(got, want):
        assert _rel(_np(g), _np(w)) < tol


def _matmul_case(transposed, seed=2):
    """x (2, 24, a) @ w (a, b); S spans the canonical (min) side."""
    rng = np.random.default_rng(seed)
    a, b = (96, 40) if transposed else (40, 96)
    m = min(a, b)
    x = rng.standard_normal((2, 24, a)).astype(np.float32)
    w = (rng.standard_normal((a, b)) / 8).astype(np.float32)
    dy = rng.standard_normal((2, 24, b)).astype(np.float32)
    S = np.linalg.qr(rng.standard_normal((m, 8)))[0].astype(np.float32)
    return x, w, dy, S, max(a, b)


@pytest.mark.parametrize("transposed", [False, True],
                         ids=["canonical", "transposed"])
def test_tapped_matmul_backward_matches_jax_vjp(transposed):
    x, w, dy, S, n = _matmul_case(transposed)
    seed = np.zeros((9, n), np.float32)
    out, vjp = jax.vjp(lambda x_, w_, s_: jax_tapped_matmul(
        x_, w_, jnp.asarray(S), s_), jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(seed))
    jdx, jdw, jtap = vjp(jnp.asarray(dy))

    tx, tw = (torch.tensor(t).requires_grad_() for t in (x, w))
    tseed = tap_seed(8, n).requires_grad_()
    tout = tapped_matmul(tx, tw, torch.tensor(S), tseed)
    np.testing.assert_array_equal(_np(tout), _np(torch.tensor(x) @
                                                 torch.tensor(w)))
    assert _rel(_np(tout), _np(out)) < 1e-5
    dx, dw, tap = torch.autograd.grad(tout, (tx, tw, tseed),
                                      torch.tensor(dy))
    assert dw.shape == w.shape and tap.shape == (9, n)
    for g, want in ((dx, jdx), (dw, jdw), (tap, jtap)):
        assert _rel(_np(g), _np(want)) < 1e-5
    # the tap holds the statistics of the dW it emitted
    G = dw.mT if transposed else dw
    A2, gsq2 = ref.project_colnorms_ref(torch.tensor(S), G)
    assert _rel(_np(tap[:-1]), _np(A2)) < 1e-5
    assert _rel(_np(tap[-1]), _np(gsq2)) < 1e-5


# ---------------------------------------------------------------------------
# The model and the train step (fp32 smoke llama)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("llama-100m", smoke=True).with_(dtype="float32")
    tcfg = tregistry.get_config("llama-100m",
                                smoke=True).with_(dtype="float32")
    kw = dict(rank=RANK, update_interval=K, eta=ETA, use_kernels=True)
    with mesh_context(smoke_context()):
        jbundle = jax_build_model(jcfg)
        jopt = jax_get_optimizer("subtrack", **kw)
        jparams = jbundle.init(jax.random.PRNGKey(0))
        data = JDataset(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH, seed=0))
        # batch_for_model's tokens for a decoder, drawn under one jit
        tokens_at = jax.jit(lambda s: data.global_batch_at(s)["tokens"])
        batches = [np.asarray(tokens_at(s)) for s in range(6)]
        jstate = JTrainState(params=jparams, opt=jax.jit(jopt.init)(jparams))
        jstate, _ = jax.jit(jax_make_warm_start(jbundle, jopt))(
            jstate, {"tokens": jnp.asarray(batches[0])})
        yield dict(jcfg=jcfg, tcfg=tcfg, jbundle=jbundle, jopt=jopt,
                   jstate=jstate, batches=batches,
                   topt=get_optimizer("subtrack", **kw))


def _tokens(a):
    return {"tokens": torch.tensor(a, dtype=torch.int64)}


def _port_state(jstate, tcfg):
    return TrainState(
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg),
        opt=opt_state_from_jax(jax.tree.map(np.asarray, jstate.opt)))


def test_decoder_loss_taps_match_jax(setup):
    """Every site tapped: gradients and the seeds' gradients (the taps)
    against the JAX ``loss_taps`` at 1e-5 of each leaf's largest entry."""
    jstate, batch = setup["jstate"], setup["batches"][1]
    with mesh_context(smoke_context()):
        jsites = []
        for path in _tap_paths(setup["tcfg"]):
            st = _site_get(jstate.opt.inner, path)
            if hasattr(st, "S"):
                jsites.append((path, st.S, st.M.shape[-1]))
        assert len(jsites) == 8        # 7 per-layer sites + lm_head

        def jloss(params, seeds):
            taps: dict = {}
            for (path, S, _), sd in zip(jsites, seeds):
                _site_set(taps, path, (S, sd))
            return setup["jbundle"].loss_taps(
                params, {"tokens": jnp.asarray(batch)}, taps)

        jseeds = [jnp.zeros(S.shape[:-2] + (S.shape[-1] + 1, n),
                            jnp.float32) for _, S, n in jsites]
        (jl, _), (jgrads, jtaps) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(jstate.params, jseeds)

    state = _port_state(jstate, setup["tcfg"])
    bundle = build_model(setup["tcfg"])
    leaves = tree_leaves(state.params)
    taps, seeds = {}, []
    for path, _, _ in jsites:
        st = _site_get(state.opt.inner, path)
        seeds.append(tap_seed(RANK, st.M.shape[-1],
                              st.S.shape[:-2]).requires_grad_())
        _site_set(taps, path, (st.S, seeds[-1]))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = bundle.loss_taps(state.params, _tokens(batch), taps)
    out = torch.autograd.grad(loss, leaves + seeds)
    for p in leaves:
        p.requires_grad_(False)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    for g, jg in zip(out[:len(leaves)], jax.tree.leaves(jgrads)):
        assert _rel(_np(g), _np(jg)) < 1e-5
    for tap, jtap in zip(out[len(leaves):], jtaps):
        assert tap.shape == jtap.shape
        assert _rel(_np(tap[..., :-1, :]), _np(jtap[..., :-1, :])) < 1e-5
        assert _rel(_np(tap[..., -1, :]), _np(jtap[..., -1, :])) < 1e-5


def test_decoder_loss_without_taps_is_the_plain_model(setup):
    """No taps: ``loss_taps(.., None)`` is ``loss`` bit for bit, and a
    tapped forward computes the same loss bit for bit (forward is x @ w)."""
    state = _port_state(setup["jstate"], setup["tcfg"])
    bundle = build_model(setup["tcfg"])
    batch = _tokens(setup["batches"][2])
    la, _, ga = value_and_grad(bundle, state.params, batch, "full")
    tapless = dataclasses.replace(bundle, loss=lambda p, b, remat="full":
                                  bundle.loss_taps(p, b, None, remat=remat))
    lb, _, gb = value_and_grad(tapless, state.params, batch, "full")
    assert torch.equal(la, lb)
    for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
        assert torch.equal(a, b)
    st = state.opt.inner["lm_head"]
    seed = tap_seed(RANK, st.M.shape[-1])
    lt, _ = bundle.loss_taps(state.params, batch,
                             {"lm_head": (st.S, seed)})
    assert torch.equal(lt, la)


def _compare_step(setup, step, clip_norm, do_update):
    """One grad-fused step of each package from the same JAX state."""
    jstate, batch = setup["jstate_at"], setup["batches"][step]
    jsteps = setup.setdefault("jsteps", {})
    with mesh_context(smoke_context()):
        if clip_norm not in jsteps:
            jsteps[clip_norm] = jax.jit(jax_make_train_step(
                setup["jbundle"], setup["jopt"], clip_norm=clip_norm,
                grad_fused=True), static_argnames=("do_subspace_update",))
        jnew, jm = jsteps[clip_norm](jstate, {"tokens": jnp.asarray(batch)},
                         jnp.float32(1e-3), do_subspace_update=do_update)
    tstate = _port_state(jstate, setup["tcfg"])
    tstep = make_train_step(build_model(setup["tcfg"]), setup["topt"],
                            clip_norm=clip_norm, grad_fused=True)
    ops.reset_launch_counts()
    tnew, tm = tstep(tstate, _tokens(batch), 1e-3,
                     do_subspace_update=do_update)
    assert all(v == 0 for v in ops.launch_counts().values())
    return jnew, jm, tnew, tm


def _assert_states_close(tnew, jnew, budget, where):
    """Params and every optimizer state field (S, M, V, lam_prev; M, V of
    the dense leaves) within ``budget`` of their largest entry."""
    tl = tree_leaves(tnew.params) + [
        f for st in tree_leaves(tnew.opt.inner) for f in st]
    jl = jax.tree.leaves(jnew.params) + jax.tree.leaves(jnew.opt.inner)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == tuple(b.shape)
        assert _rel(_np(a), _np(b)) < budget, (where, _rel(_np(a), _np(b)))


def test_grad_fused_train_steps_match_jax(setup):
    """Six steps, tracking at step 4, each from the JAX package's evolving
    state: params and grad norm within 1e-5 on plain steps, 1e-3 on and
    after the tracking step."""
    setup["jstate_at"] = setup["jstate"]
    tracked = False
    for s in range(6):
        do = s > 0 and s % K == 0
        jnew, jm, tnew, tm = _compare_step(setup, s, 1.0, do)
        tracked = tracked or do
        budget = 1e-3 if tracked else 1e-5
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=budget)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        _assert_states_close(tnew, jnew, budget, s)
        assert tnew.opt.step == int(jnew.opt.step)
        setup["jstate_at"] = jnew


def test_grad_fused_clip_firing_matches_jax(setup):
    """clip_norm 0.5 fires; the tap-fed norm and the rescaled taps (A s,
    gsq s^2) keep the step within the plain budget, the recovery norm
    lam_prev (fed by gsq) included."""
    setup["jstate_at"] = setup["jstate"]
    jnew, jm, tnew, tm = _compare_step(setup, 2, 0.5, False)
    assert float(jm["grad_norm"]) > 0.5
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    _assert_states_close(tnew, jnew, 1e-5, "clip")


def test_cli_grad_fused_matches_plain_cli(monkeypatch):
    """``--grad-fused --device cpu`` runs, and its fp32 loss history
    matches the plain CLI's: 1e-5 on plain steps, 1e-3 after the tracking
    step at 3."""
    real = tregistry.get_config
    monkeypatch.setattr(ttrain, "get_config", lambda arch, smoke=False:
                        real(arch, smoke=smoke).with_(dtype="float32"))
    argv = ["--arch", "llama-100m", "--smoke", "--rank", "32",
            "--update-interval", "3", "--steps", "5", "--batch", "2",
            "--seq", "16", "--use-kernels", "--eta", "2e-5", "--device",
            "cpu", "--log-every", "10"]
    plain = ttrain.train(argv)
    fused = ttrain.train(argv + ["--grad-fused"])
    assert fused["grad_fused"] and not plain["grad_fused"]
    assert all(v == 0 for v in fused["launch_counts"].values())
    for s, (a, b) in enumerate(zip(fused["losses"], plain["losses"])):
        assert a == pytest.approx(b, rel=1e-3 if s > 3 else 1e-5), s
