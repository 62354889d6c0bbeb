"""llama-1b's quirks in the port, against the JAX package on the CPU.

llama-1b (paper Table 10: 32 layers, d 2048, 24 heads, d_ff 5461) is the
first model on the port's training path with an odd head dim (2048 // 24
= 85, of which RoPE rotates 84), a q width below d_model (24 * 85 = 2040)
and a d_ff off every tile grid (5461).  The same quirks at a small size:
2 layers, d 64, 3 heads -> hd 21 (20 rotated), q width 63, d_ff 171,
vocab 512, rank 16.

* The config and the optimizer's canonical leaf shapes equal the JAX
  package's, at full size.
* 6 train steps with a tracking step at step 3 (eta pinned at 2e-5, the
  JAX warm-started state copied over): losses within 1e-5 of the JAX
  package on the plain steps before the tracking step and 1e-3 from it on
  (the reference budgets; fp32).
* Paged serving of the small odd-hd decoder: greedy tokens identical to
  the JAX paged engine's, whole-prompt and chunked prefill.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.api import get_optimizer as jax_get_optimizer
from repro.core.plan import make_plans as jax_make_plans
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.distributed.context import mesh_context
from repro.launch import serve as jserve
from repro.launch.mesh import smoke_context
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.steps import make_warm_start as jax_make_warm_start
from repro.models.api import build_model as jax_build_model
from repro.optim.schedules import cosine_with_warmup as jax_cosine
from repro_torch.configs.registry import PAPER_RANKS, get_config
from repro_torch.core.api import get_optimizer
from repro_torch.core.plan import plan_for_shape
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.api import build_model
from repro_torch.optim.schedules import cosine_with_warmup
from torch_threads import one_thread  # noqa: F401


SMALL = dict(n_layers=2, d_model=64, n_heads=3, n_kv_heads=3, d_ff=171,
             vocab_size=512, vocab_round=64, dtype="float32", q_block=32,
             kv_block=32)
STEPS, BATCH, SEQ, RANK, K, ETA = 6, 2, 32, 16, 3, 2e-5


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


def test_full_size_config_and_canonical_leaves_match_jax():
    tcfg, jcfg = get_config("llama-1b"), jax_get_config("llama-1b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "hd", "padded_vocab", "rope_pct"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert (tcfg.hd, tcfg.n_heads * tcfg.hd, PAPER_RANKS["llama-1b"]) == (
        85, 2040, 512)
    with mesh_context(smoke_context()):
        shapes = jax.eval_shape(jax_build_model(jcfg).init,
                                jax.random.PRNGKey(0))
    jplans = jax_make_plans(shapes, 512)
    leaves = {}
    for path, shape in _shapes(shapes).items():
        plan = plan_for_shape(shape, 512)
        node = jplans
        for k in path.strip("/").split("/"):
            node = node[k]
        assert (plan.mode, plan.transpose, plan.m, plan.n, plan.rank) == (
            node.mode, node.transpose, node.m, node.n, node.rank), path
        if plan.mode == "lowrank":
            leaves[path.rsplit("/", 1)[-1]] = (plan.m, plan.n)
    assert leaves == {"wq": (2040, 2048), "wk": (2040, 2048),
                      "wv": (2040, 2048), "wo": (2040, 2048),
                      "w_gate": (2048, 5461), "w_up": (2048, 5461),
                      "w_down": (2048, 5461), "embed": (2048, 32000),
                      "lm_head": (2048, 32000)}


@pytest.fixture(scope="module")
def small():
    jcfg = jax_get_config("llama-1b").with_(**SMALL)
    tcfg = get_config("llama-1b").with_(**SMALL)
    assert (tcfg.hd, tcfg.n_heads * tcfg.hd) == (21, 63)
    with mesh_context(smoke_context()):
        jbundle = jax_build_model(jcfg)
        params_np = jax.tree.map(np.asarray,
                                 jax.jit(jbundle.init)(jax.random.PRNGKey(0)))
        yield jcfg, jbundle, params_np, tcfg


def test_small_odd_head_dim_decoder_trains_like_jax(small):
    jcfg, jbundle, params_np, tcfg = small
    kw = dict(rank=RANK, update_interval=K, eta=ETA, use_kernels=True)
    sched = jax_cosine(1e-3, STEPS, 2)
    with mesh_context(smoke_context()):
        data = JDataset(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH, seed=0))
        # batch_for_model's tokens for a decoder, drawn under one jit
        tokens_at = jax.jit(lambda s: data.global_batch_at(s)["tokens"])
        batches = [np.asarray(tokens_at(s)) for s in range(STEPS)]
        jopt = jax_get_optimizer("subtrack", **kw)
        jparams = jax.tree.map(jnp.asarray, params_np)
        jstate = JTrainState(params=jparams, opt=jax.jit(jopt.init)(jparams))
        jstate, _ = jax.jit(jax_make_warm_start(jbundle, jopt))(
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

    ops.reset_launch_counts()
    out = ttrain.run(tcfg, params_from_jax(params_np, tcfg),
                     lambda s: {"tokens": torch.tensor(batches[s],
                                                       dtype=torch.int64)},
                     optimizer=get_optimizer("subtrack", **kw), steps=STEPS,
                     lr_at=cosine_with_warmup(1e-3, STEPS, 2),
                     opt_state=opt_state_from_jax(jwarm_opt))
    tlosses = [h["loss"] for h in out["history"]]
    assert [h["subspace_update"] for h in out["history"]] == [
        s > 0 and s % K == 0 for s in range(STEPS)]
    np.testing.assert_allclose(tlosses[:K], jlosses[:K], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tlosses[K:], jlosses[K:], atol=1e-3, rtol=0)
    assert all(v == 0 for v in ops.launch_counts().values())
    # the q projection's leaf is (2, 64, 63): canonical (63, 64), rank 16
    S = out["state"].opt.inner["layers"]["attn"]["wq"].S
    assert tuple(S.shape) == (2, 63, RANK)


def _queue(mod, prompts, max_new):
    q = mod.AdmissionQueue()
    for i, p in enumerate(prompts):
        q.submit(mod.Request(rid=i, prompt=p, max_new=max_new), now=1.0)
    return q


def test_small_odd_head_dim_decoder_serves_like_jax(small):
    jcfg, jbundle, params_np, tcfg = small
    P, GEN, BS = 9, 5, 4
    prompts = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, size=(3, P)).astype(np.int32)
    pool_blocks = 1 + 2 * -(-(P + GEN) // BS)
    kw = dict(batch=2, block_size=BS, pool_blocks=pool_blocks,
              max_context=P + GEN)
    with mesh_context(smoke_context()):
        jparams = jax.tree.map(jnp.asarray, params_np)
        want = {chunk: jserve.run_paged(
            jcfg, jbundle, jparams, _queue(jserve, prompts, GEN),
            prefill_chunk=chunk, **kw)["outputs"] for chunk in (0, 4)}
    bundle = build_model(tcfg)
    tparams = params_from_jax(params_np, tcfg, "cpu")
    ops.reset_launch_counts()
    for chunk in (0, 4):
        got = tserve.run_paged(tcfg, bundle, tparams,
                               _queue(tserve, prompts, GEN),
                               prefill_chunk=chunk, **kw)
        assert got["outputs"] == want[chunk]
        assert all(len(t) == GEN for t in got["outputs"].values())
    assert not any(ops.launch_counts().values())
