"""The port's training slice against the JAX package, on the CPU.

* ``decoder_loss`` and its gradients, from the JAX init copied over
  (``params_from_jax``), on the fp32 smoke llama, under each remat policy
  (the JAX package's ``dots`` is a selective checkpoint here): loss at
  1e-5 relative, each gradient leaf at 1e-5 of its largest entry (fp32;
  only summation order differs).  What each policy recomputes is counted
  in ``aten.mm`` calls, with and without the grad-fused taps.
* Gradient accumulation: one ``--accum 2`` step against the JAX
  package's ``make_train_step(accum=2)``; with ``--grad-fused`` it takes
  the plain backward, as the JAX driver does.
* The slice as a whole: ``--arch llama-100m --smoke --rank 32
  --update-interval 4 --steps 12 --use-kernels`` at eta 2e-5 (fp32, batch
  4 x 64 tokens for time's sake).  Both packages start from the same
  params and the JAX package's warm-started optimizer state (the SVD
  signs may differ; the warm starts themselves are compared by their
  projectors) and take the JAX package's batches as numpy; the JAX side
  runs its own ``make_warm_start`` and ``make_train_step``.  The 12-step
  loss histories agree within 1e-5 absolute (measured: 2.4e-6 at a loss
  of 6.5, a few fp32 ulps; the slice's own target was 1e-4).
* The CLI on the CPU, end to end.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.registry import get_config as jax_get_config
from repro.core.api import get_optimizer as jax_get_optimizer
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.distributed.context import mesh_context
from repro.launch.mesh import smoke_context
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.steps import make_warm_start as jax_make_warm_start
from repro.models.api import build_model as jax_build_model
from repro.optim.schedules import cosine_with_warmup as jax_cosine
from repro_torch.configs.registry import get_config
from repro_torch.core.api import get_optimizer
from repro_torch.core.subtrack import tree_leaves
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import (TrainState, _site_get, _tap_paths,
                                      _site_set, make_train_step,
                                      make_warm_start, value_and_grad)
from repro_torch.models.api import build_model
from repro_torch.models.common import tap_seed
from repro_torch.models.transformer import DOTS_SAVED_OPS
from repro_torch.optim.schedules import cosine_with_warmup
from torch_threads import one_thread  # noqa: F401


STEPS, BATCH, SEQ, RANK, K, ETA = 12, 4, 64, 32, 4, 2e-5
SLICE_KW = dict(rank=RANK, update_interval=K, eta=ETA, use_kernels=True)
# llama-1b's quirks small (tests/test_torch_llama1b.py): hd 21, q width 63
LLAMA_1B_SMALL = dict(n_layers=2, d_model=64, n_heads=3, n_kv_heads=3,
                      d_ff=171, vocab_size=512, vocab_round=64,
                      dtype="float32", q_block=32, kv_block=32)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("llama-100m", smoke=True).with_(dtype="float32")
    tcfg = get_config("llama-100m", smoke=True).with_(dtype="float32")
    with mesh_context(smoke_context()):
        jbundle = jax_build_model(jcfg)
        params_np = jax.tree.map(np.asarray,
                                 jax.jit(jbundle.init)(jax.random.PRNGKey(0)))
        data = JDataset(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH, seed=0))
        # batch_for_model's tokens for a decoder, drawn under one jit
        tokens_at = jax.jit(lambda s: data.global_batch_at(s)["tokens"])
        batches = [np.asarray(tokens_at(s)) for s in range(STEPS)]
        yield jcfg, jbundle, params_np, tcfg, batches


@pytest.fixture(scope="module")
def jax_warm(setup):
    """The JAX package's warm start of the slice's optimizer from batch 0:
    (its optimizer state as numpy, the warm-start loss)."""
    _, jbundle, params_np, _, batches = setup
    with mesh_context(smoke_context()):
        jopt = jax_get_optimizer("subtrack", **SLICE_KW)
        jparams = jax.tree.map(jnp.asarray, params_np)
        jstate, jwarm = jax.jit(jax_make_warm_start(jbundle, jopt))(
            JTrainState(params=jparams, opt=jax.jit(jopt.init)(jparams)),
            {"tokens": jnp.asarray(batches[0])})
    return jax.tree.map(np.asarray, jstate.opt), float(jwarm)


def _tokens(a):
    return {"tokens": torch.tensor(a, dtype=torch.int64)}


@pytest.fixture(scope="module")
def jax_loss_grads(setup):
    """The JAX package's loss and gradients on batch 1, as numpy (its
    default remat; no remat policy changes a value)."""
    _, jbundle, params_np, _, batches = setup
    with mesh_context(smoke_context()):
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jbundle.loss(p, {"tokens": jnp.asarray(batches[1])}),
            has_aux=True))(jax.tree.map(jnp.asarray, params_np))
    return float(jloss), jax.tree.map(np.asarray, jgrads)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_decoder_loss_and_grads_match_jax(setup, jax_loss_grads, remat):
    _, _, params_np, tcfg, batches = setup
    jloss, jgrads = jax_loss_grads
    tparams = params_from_jax(params_np, tcfg)
    loss, metrics, grads = value_and_grad(build_model(tcfg), tparams,
                                          _tokens(batches[1]), remat)
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert float(metrics["aux_loss"]) == 0.0
    assert not any(t.requires_grad for t in tree_leaves(tparams))

    def check(tg, jg, path=""):
        if isinstance(tg, dict):
            assert tg.keys() == jg.keys()
            for k in tg:
                check(tg[k], jg[k], f"{path}/{k}")
            return
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg,
                                   atol=1e-5 * np.abs(jg).max(), rtol=1e-5,
                                   err_msg=path)

    check(grads, jgrads)


class _CountMM(TorchDispatchMode):
    """Counts the 2-D products (``aten.mm``, ``aten.addmm``) dispatched
    while it is active: a product that a selective checkpoint hands back
    from its cache never reaches it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in DOTS_SAVED_OPS:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("tapped", [False, True])
@pytest.mark.parametrize("arch", ["smoke llama", "llama-1b quirks"])
def test_remat_dots_recomputes_no_projection(setup, arch, tapped):
    """2-D products dispatched during the backward, per remat policy.
    ``full`` recomputes each layer's projections up to the last one the
    backward needs: wq wk wv wo w_gate w_up (the non-reentrant checkpoint
    stops before w_down's product, whose output no backward reads), and
    with taps w_down's too (``tapped_matmul`` packs its saved input only
    once its forward, the product, has run).  ``dots`` recomputes none of
    them: it equals ``none``.  The same
    with the grad-fused taps (``tapped_matmul``), whose taps and gradients
    stay the same bits under every policy.  The llama-1b quirks (d 64,
    q width 63, d_ff 171) store its leaves off every tile."""
    _, _, params_np, tcfg, batches = setup
    if arch == "llama-1b quirks":
        tcfg = get_config("llama-100m", smoke=True).with_(**LLAMA_1B_SMALL)
        params = build_model(tcfg).init(torch.Generator().manual_seed(0))
    else:
        params = params_from_jax(params_np, tcfg)
    bundle = build_model(tcfg)
    batch = _tokens(batches[1][:, :32])
    opt = get_optimizer("subtrack", rank=16)
    state = TrainState(params=params, opt=opt.init(params))
    leaves = tree_leaves(params)
    counts, outs = {}, {}
    for remat in ("full", "dots", "none"):
        for p in leaves:
            p.requires_grad_(True)
        try:
            if tapped:
                sites = [(path, _site_get(state.opt.inner, path))
                         for path in _tap_paths(tcfg)]
                seeds = [tap_seed(st.S.shape[-1], st.M.shape[-1],
                                  st.S.shape[:-2]).requires_grad_()
                         for _, st in sites]
                taps: dict = {}
                for (path, st), seed in zip(sites, seeds):
                    _site_set(taps, path, (st.S, seed))
                loss, _ = bundle.loss_taps(params, batch, taps, remat=remat)
            else:
                seeds = []
                loss, _ = bundle.loss(params, batch, remat=remat)
            with _CountMM() as mm:
                outs[remat] = torch.autograd.grad(loss, leaves + seeds)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        counts[remat] = mm.n
    assert counts["full"] - counts["none"] == \
        (7 if tapped else 6) * tcfg.n_layers, counts
    assert counts["dots"] == counts["none"], counts
    for remat in ("full", "dots"):
        for a, b in zip(outs[remat], outs["none"]):
            assert torch.equal(a, b), remat


def test_accum_step_matches_jax(setup, jax_warm):
    """One plain step with the batch split in 2 microbatches, from the
    JAX warm-started state: the loss and the clipped norm at 1e-5
    relative; the parameters, and the new first moments (linear in the
    accumulated G), at 1e-5 of the largest entry."""
    jcfg, jbundle, params_np, tcfg, batches = setup
    jwarm_opt, _ = jax_warm
    lr = 1e-3                          # the train CLI's default --lr
    with mesh_context(smoke_context()):
        jopt = jax_get_optimizer("subtrack", **SLICE_KW)
        jstate = JTrainState(params=jax.tree.map(jnp.asarray, params_np),
                             opt=jax.tree.map(jnp.asarray, jwarm_opt))
        step = jax.jit(jax_make_train_step(jbundle, jopt, accum=2),
                       static_argnames=("do_subspace_update",))
        jstate, jm = step(jstate, {"tokens": jnp.asarray(batches[1])},
                          jnp.float32(lr), do_subspace_update=False)
        jnew = jax.tree.map(np.asarray, jstate.params)
        jM = {k: np.asarray(st.M) for k, st in
              jstate.opt.inner["layers"]["mlp"].items()}

    topt = get_optimizer("subtrack", **SLICE_KW)
    tparams = params_from_jax(params_np, tcfg)
    train_step = make_train_step(build_model(tcfg), topt, accum=2)
    state, m = train_step(TrainState(params=tparams,
                                     opt=opt_state_from_jax(jwarm_opt)),
                          _tokens(batches[1]), lr)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)

    def check(t, j, path=""):
        if isinstance(t, dict):
            for k in t:
                check(t[k], j[k], f"{path}/{k}")
            return
        np.testing.assert_allclose(t.numpy(), j, rtol=0, err_msg=path,
                                   atol=1e-5 * np.abs(j).max())

    check(state.params, jnew)
    check({k: st.M for k, st in state.opt.inner["layers"]["mlp"].items()},
          jM)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(build_model(tcfg), topt, accum=3)(
            state, _tokens(batches[1]), lr)


def test_accum_with_grad_fused_takes_the_plain_backward(setup, jax_warm,
                                                        capsys,
                                                        monkeypatch):
    """``run(grad_fused=True, accum=2)`` says it falls back (the JAX
    driver's line), calls grad_tap never, and equals ``accum=2`` without
    it bit for bit; ``accum=1`` does take the taps."""
    _, _, params_np, tcfg, batches = setup
    calls = []
    grad_tap = ops.grad_tap

    def counted(*a, **kw):
        calls.append(1)
        return grad_tap(*a, **kw)

    monkeypatch.setattr(ops, "grad_tap", counted)
    opt = get_optimizer("subtrack", **SLICE_KW)

    def go(grad_fused, accum):
        calls.clear()
        out = ttrain.run(tcfg, params_from_jax(params_np, tcfg),
                         lambda s: _tokens(batches[1][:, :16]),
                         optimizer=opt, steps=1, lr_at=lambda s: 1e-3,
                         opt_state=opt_state_from_jax(jax_warm[0]),
                         grad_fused=grad_fused, accum=accum)
        return [h["loss"] for h in out["history"]], len(calls)

    capsys.readouterr()
    fused, n_fused = go(True, 2)
    assert "falling back to the plain backward" in capsys.readouterr().out
    plain, n_plain = go(False, 2)
    assert fused == plain and n_fused == n_plain == 0
    assert go(True, 1)[1] > 0


def test_twelve_step_slice_matches_jax(setup, jax_warm):
    jcfg, jbundle, params_np, tcfg, batches = setup
    jwarm_opt, jwarm = jax_warm
    kw = SLICE_KW
    sched = jax_cosine(1e-3, STEPS, 100)
    with mesh_context(smoke_context()):
        jopt = jax_get_optimizer("subtrack", **kw)
        jstate = JTrainState(params=jax.tree.map(jnp.asarray, params_np),
                             opt=jax.tree.map(jnp.asarray, jwarm_opt))
        step = jax.jit(jax_make_train_step(jbundle, jopt),
                       static_argnames=("do_subspace_update",))
        jlosses = []
        for s in range(STEPS):
            jstate, m = step(jstate, {"tokens": jnp.asarray(batches[s])},
                             jnp.float32(sched(s)),
                             do_subspace_update=s > 0 and s % K == 0)
            jlosses.append(float(m["loss"]))
        jopt_state = jax.tree.map(np.asarray, jstate.opt)

    topt = get_optimizer("subtrack", **kw)
    # the port's own warm start spans the same subspaces
    tparams = params_from_jax(params_np, tcfg)
    twarm_state, twarm = make_warm_start(build_model(tcfg), topt)(
        TrainState(params=tparams, opt=topt.init(tparams)),
        _tokens(batches[0]))
    assert float(twarm) == pytest.approx(float(jwarm), rel=1e-5)
    for key in ("wq", "w_down"):
        grp = "attn" if key == "wq" else "mlp"
        tS = twarm_state.opt.inner["layers"][grp][key].S
        jS = np.asarray(jwarm_opt.inner["layers"][grp][key].S)
        np.testing.assert_allclose((tS @ tS.mT).numpy(),
                                   jS @ np.swapaxes(jS, -1, -2), atol=1e-4)

    # the trajectory, from the JAX warm-started state
    ops.reset_launch_counts()
    out = ttrain.run(tcfg, params_from_jax(params_np, tcfg),
                     lambda s: _tokens(batches[s]), optimizer=topt,
                     steps=STEPS, lr_at=cosine_with_warmup(1e-3, STEPS, 100),
                     opt_state=opt_state_from_jax(jwarm_opt))
    tlosses = [h["loss"] for h in out["history"]]
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-5, rtol=0)
    assert [h["subspace_update"] for h in out["history"]] == [
        s > 0 and s % K == 0 for s in range(STEPS)]
    assert all(v == 0 for v in ops.launch_counts().values())
    state = out["state"]
    assert state.opt.step == int(jopt_state.step) == STEPS
    assert state.opt.n_updates == int(jopt_state.n_updates) == 2
    S = state.opt.inner["layers"]["mlp"]["w_gate"].S
    jS = jopt_state.inner["layers"]["mlp"]["w_gate"].S
    assert np.abs(S.numpy() - jS).max() < 1e-4


def test_cli_trains_on_the_cpu(tmp_path):
    out_path = tmp_path / "m.json"
    summary = ttrain.train(["--arch", "llama-100m", "--smoke", "--rank", "32",
                            "--update-interval", "3", "--steps", "4",
                            "--batch", "2", "--seq", "16", "--use-kernels",
                            "--eta", "2e-5", "--device", "cpu",
                            "--metrics-out", str(out_path)])
    assert summary["device"] == "cpu" and summary["rank"] == 32
    assert all(np.isfinite(summary["losses"]))
    assert summary["warm_start_s"] > 0
    assert [h["subspace_update"] for h in summary["history"]] == [
        False, False, False, True]
    assert all(v == 0 for v in summary["launch_counts"].values())
    assert json.loads(out_path.read_text())["losses"] == summary["losses"]


def test_batches_are_validated_before_any_lookup():
    from repro_torch.data.pipeline import (BatchError, DataConfig,
                                           SyntheticLMDataset, fetch_batch,
                                           validate_batch)

    cfg = get_config("llama-100m", smoke=True)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=8, global_batch=2))
    batch, ok = fetch_batch(cfg, data, 3)
    assert ok and batch["tokens"].shape == (2, 8)

    def corrupt(b):
        toks = b["tokens"].clone()
        toks[0, 0] = cfg.vocab_size          # one past the table
        return {"tokens": toks}

    with pytest.raises(BatchError, match="outside"):
        validate_batch(corrupt(batch), cfg.vocab_size)
    with pytest.raises(BatchError, match="integral"):
        validate_batch({"tokens": batch["tokens"].float()}, cfg.vocab_size)
    assert fetch_batch(cfg, data, 3, retries=1, backoff_s=0.0,
                       mutate=corrupt) == (None, False)
