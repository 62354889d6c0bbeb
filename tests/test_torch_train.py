"""The port's training slice against the JAX package, on the CPU.

* ``decoder_loss`` and its gradients, from the JAX init copied over
  (``params_from_jax``), on the fp32 smoke llama: loss at 1e-5
  relative, each gradient leaf at 1e-5 of its largest entry (fp32;
  only summation order differs).
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

from repro.configs.registry import get_config as jax_get_config
from repro.core.api import get_optimizer as jax_get_optimizer
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.data.pipeline import batch_for_model as jax_batch_for_model
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
from repro_torch.launch.steps import TrainState, make_warm_start
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.api import build_model
from repro_torch.optim.schedules import cosine_with_warmup

STEPS, BATCH, SEQ, RANK, K, ETA = 12, 4, 64, 32, 4, 2e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("llama-100m", smoke=True).with_(dtype="float32")
    tcfg = get_config("llama-100m", smoke=True).with_(dtype="float32")
    with mesh_context(smoke_context()):
        jbundle = jax_build_model(jcfg)
        params_np = jax.tree.map(np.asarray,
                                 jbundle.init(jax.random.PRNGKey(0)))
        data = JDataset(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH, seed=0))
        batches = [np.asarray(jax_batch_for_model(jcfg, None, data, s)
                              ["tokens"]) for s in range(STEPS)]
        yield jcfg, jbundle, params_np, tcfg, batches


def _tokens(a):
    return {"tokens": torch.tensor(a, dtype=torch.int64)}


@pytest.mark.parametrize("remat", ["full", "none"])
def test_decoder_loss_and_grads_match_jax(setup, remat):
    jcfg, jbundle, params_np, tcfg, batches = setup
    with mesh_context(smoke_context()):
        (jloss, _), jgrads = jax.value_and_grad(
            lambda p: jbundle.loss(p, {"tokens": jnp.asarray(batches[1])}),
            has_aux=True)(jax.tree.map(jnp.asarray, params_np))
    tparams = params_from_jax(params_np, tcfg)
    loss, metrics, grads = value_and_grad(build_model(tcfg), tparams,
                                          _tokens(batches[1]), remat)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
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


def test_twelve_step_slice_matches_jax(setup):
    jcfg, jbundle, params_np, tcfg, batches = setup
    kw = dict(rank=RANK, update_interval=K, eta=ETA, use_kernels=True)
    sched = jax_cosine(1e-3, STEPS, 100)
    with mesh_context(smoke_context()):
        jopt = jax_get_optimizer("subtrack", **kw)
        jparams = jax.tree.map(jnp.asarray, params_np)
        jstate = JTrainState(params=jparams, opt=jopt.init(jparams))
        jstate, jwarm = jax.jit(jax_make_warm_start(jbundle, jopt))(
            jstate, {"tokens": jnp.asarray(batches[0])})
        jwarm_opt = jax.tree.map(np.asarray, jstate.opt)
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
