"""The encoder-decoder (seamless-m4t-large-v2) against the JAX package,
on the CPU.

Every comparison feeds the same numpy inputs to both packages (the
model's parameters through ``params_from_jax``).  The JAX side runs
inside ``mesh_context(smoke_context())``, and each JAX function is
compiled once (``jax.jit``) in a module-scoped fixture:

* ``blocked_attention(causal=False)`` with S != T (cross-attention's
  shape), GQA, with and without a window, in fp32 and bf16;
* the fp32 smoke model (2 encoder and 2 decoder layers) on 96 frames and
  64 tokens: the loss and every gradient under each remat policy at 2e-5
  of the largest entry; prefill (logits, the self K/V and their position
  tags, the cross K/V) and 3 decode steps at 2e-5;
* one plain (1e-5) and one tracking (1e-3) SubTrack++ step from one JAX
  state on the smoke tree;
* the config, its plans at the full width, the speech stub's frames in
  the port's batches, and the CLIs at smoke size (the grad-fused
  fallback line and the paged engine's refusal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.plan import make_plans as jax_make_plans
from repro.distributed.context import mesh_context
from repro.launch.mesh import smoke_context
from repro.launch.steps import default_rank as jax_default_rank
from repro.models import transformer as jtf
from repro.models.api import build_model as jax_build_model
from repro.models.attention import blocked_attention as jax_blocked
from repro_torch.configs.registry import get_config
from repro_torch.core.plan import make_plans
from repro_torch.core.subtrack import tree_leaves
from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                       batch_for_model)
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import default_rank
from repro_torch.models import encdec
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model
from repro_torch.models.attention import blocked_attention
from torch_compare import (TOL, check_optimizer_step, close, close_tree,
                           jax_optimizer_steps, t as _t,
                           unflatten)
from torch_threads import one_thread  # noqa: F401


ARCH = "seamless-m4t-large-v2"
B, S, S_ENC = 2, 64, 96         # the smoke model's loss batch
P, P_ENC, GEN = 13, 24, 3       # prefill tokens and frames, decode steps
MAX_LEN = 20


# ---------------------------------------------------------------------------
# Non-causal blocked attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 6])
def test_non_causal_blocked_attention_matches_jax(dtype, window):
    """12 queries over 20 keys in KV blocks of 5, 4 query heads on 2 KV
    heads: every key visible to every query (or the window's keys only),
    as the reference's ``causal=False``."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    want = jax.jit(lambda q, k, v: jax_blocked(
        q, k, v, causal=False, window=window, q_block=12, kv_block=5))(
            *(jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v)))
    got = blocked_attention(*(torch.tensor(a).to(getattr(torch, dtype))
                              for a in (q, k, v)),
                            causal=False, window=window, kv_block=5)
    tol = (dict(atol=2e-5, rtol=2e-5) if dtype == "float32"
           else dict(atol=3e-2, rtol=5e-2))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    if window is None and dtype == "float32":
        # no mask at all: a plain softmax over the T keys, K/V repeated
        kk, vv = (torch.tensor(a).repeat_interleave(2, dim=2) for a in (k, v))
        w = torch.softmax(torch.einsum("bshd,bthd->bhst", torch.tensor(q),
                                       kk) / 4.0, dim=-1)
        np.testing.assert_allclose(
            got.numpy(), torch.einsum("bhst,bthd->bshd", w, vv).numpy(),
            atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# The smoke model
# ---------------------------------------------------------------------------


def _configs(**kw):
    kw = dict(dtype="float32", **kw)
    return (jax_get_config(ARCH, smoke=True).with_(**kw),
            get_config(ARCH, smoke=True).with_(**kw))


def _jax_params(jcfg, seed):
    """Parameters of the JAX package's schema and shapes, drawn with
    numpy: fan-in scaled weights, 0.02 N(0, 1) embeddings, nonzero norm
    scales."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))

    def draw(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == "embed":
            a = 0.02 * rng.standard_normal(shape)
        elif len(shape) >= 3 or name == "lm_head":
            a = shape[-2] ** -0.5 * rng.standard_normal(shape)
        else:                                   # norms
            a = 0.1 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def model_runs():
    """From one set of numpy parameters: the JAX smoke model's loss and
    gradients (one compiled program), and its prefill of P_ENC frames and
    P tokens and GEN decode steps (one program each), every cache kept."""
    jcfg, tcfg = _configs()
    params_np = _jax_params(jcfg, seed=3)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    frames = (0.1 * rng.standard_normal((B, S_ENC, jcfg.d_model))).astype(
        np.float32)
    with mesh_context(smoke_context()):
        jb = jax_build_model(jcfg)
        jp = jax.tree.map(jnp.asarray, params_np)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jb.loss(p, {"tokens": jnp.asarray(tokens),
                                  "frames": jnp.asarray(frames)},
                              remat="none"), has_aux=True))(jp)
        logits, cache = jax.jit(jb.prefill, static_argnums=2)(
            jp, {"tokens": jnp.asarray(tokens[:, :P]),
                 "frames": jnp.asarray(frames[:, :P_ENC])}, MAX_LEN)
        steps = [(logits, cache)]
        decode = jax.jit(jb.decode_step)
        for i in range(GEN):
            logits, cache = decode(jp, cache, jnp.asarray(tokens[:, P + i]))
            steps.append((logits, cache))
    return dict(tcfg=tcfg, params_np=params_np, tokens=tokens, frames=frames,
                loss=float(loss), grads=jax.tree.map(np.asarray, grads),
                steps=[(np.asarray(lg), jax.tree.map(np.asarray, c))
                       for lg, c in steps])


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_encdec_loss_and_grads_match_jax(remat, model_runs):
    tcfg = model_runs["tcfg"]
    params = params_from_jax(model_runs["params_np"], tcfg)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, metrics = build_model(tcfg).loss(
        params, {"tokens": _t(model_runs["tokens"], torch.int64),
                 "frames": _t(model_runs["frames"])}, remat=remat)
    assert float(loss.detach()) == pytest.approx(model_runs["loss"], rel=TOL)
    assert float(metrics["aux_loss"]) == 0.0
    grads = torch.autograd.grad(loss, tree_leaves(params))
    close_tree(unflatten(params, grads), model_runs["grads"])


def _check_cache(c, jc, where):
    assert c.length == int(jc.length), where
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        close(getattr(c, name), getattr(jc, name), TOL, f"{where} {name}")
    np.testing.assert_array_equal(c.self_pos.numpy(), jc.self_pos,
                                  err_msg=where)


def _cache_from_jax(jc):
    return encdec.EncDecCache(
        self_k=_t(jc.self_k), self_v=_t(jc.self_v),
        self_pos=_t(jc.self_pos), cross_k=_t(jc.cross_k),
        cross_v=_t(jc.cross_v), length=int(jc.length))


def test_encdec_prefill_and_decode_match_jax(model_runs):
    """Prefill of P_ENC frames and P tokens into a cache of MAX_LEN: the
    logits and every cache tensor at 2e-5 of the largest entry, the
    position tags exactly (P slots, -1 beyond); then each of GEN decode
    steps from the JAX package's cache of the step before and the port's
    own chain, at 2e-5."""
    tcfg = model_runs["tcfg"]
    params = params_from_jax(model_runs["params_np"], tcfg)
    bundle = build_model(tcfg)
    toks = _t(model_runs["tokens"], torch.int64)
    steps = model_runs["steps"]
    with torch.no_grad():
        logits, cache = bundle.prefill(
            params, {"tokens": toks[:, :P],
                     "frames": _t(model_runs["frames"][:, :P_ENC])},
            MAX_LEN)
        close(logits, steps[0][0], TOL, "prefill logits")
        _check_cache(cache, steps[0][1], "prefill")
        assert cache.cross_k.shape[2] == P_ENC
        assert cache.self_pos[:, P:].eq(-1).all()
        for i in range(GEN):
            lg, c = bundle.decode_step(params, _cache_from_jax(steps[i][1]),
                                       toks[:, P + i])
            close(lg, steps[i + 1][0], TOL, f"decode {i} logits")
            _check_cache(c, steps[i + 1][1], f"decode {i}")
            logits, cache = bundle.decode_step(params, cache, toks[:, P + i])
            close(logits, steps[i + 1][0], TOL, f"chained decode {i}")
            _check_cache(cache, steps[i + 1][1], f"chained decode {i}")


# ---------------------------------------------------------------------------
# The optimizer on the encoder-decoder tree
# ---------------------------------------------------------------------------


OPT_KW = dict(rank=32, update_interval=2, eta=5.0)


@pytest.fixture(scope="module")
def opt_runs():
    jcfg, _ = _configs()
    return jax_optimizer_steps(_jax_params(jcfg, seed=6), OPT_KW, seed=5)


@pytest.mark.parametrize("tracking", [False, True])
def test_optimizer_step_on_the_encdec_tree_matches_jax(tracking, opt_runs):
    """One plain (1e-5) and one tracking (1e-3) step from one JAX state:
    every projection of both stacks and the cross-attention low-rank."""
    tstate = opt_state_from_jax(opt_runs["state_np"])
    assert tstate.inner["dec_layers"]["xattn"]["wk"].S.shape == (2, 128, 32)
    check_optimizer_step(opt_runs, _configs()[1], tracking)


# ---------------------------------------------------------------------------
# Config, plans, batches and the CLIs
# ---------------------------------------------------------------------------


def _plan_tuples(plans):
    return jax.tree.map(lambda p: (p.mode, p.transpose, p.m, p.n, p.rank),
                        plans, is_leaf=lambda p: hasattr(p, "mode"))


def test_encdec_config_and_plans_match_the_reference():
    """The config, its paging answer, default rank, init schema and cache
    spec equal the reference's; at the full width the plans are the
    reference's: 20 low-rank leaves at rank 256 (7 per encoder layer
    stack, 11 per decoder stack, the embedding and the head)."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    assert tcfg.__dict__ == jcfg.__dict__
    assert ttf.paged_supported(tcfg) == jtf.paged_supported(jcfg) == (
        False, "family 'encdec' has no paged cache layout")
    assert default_rank(tcfg.d_model) == jax_default_rank(jcfg.d_model) \
        == 256
    bundle = build_model(tcfg)
    assert bundle.loss_taps is None
    c = bundle.init_cache(2, 64, device="meta")
    assert c.cross_k.shape == (24, 2, 4096, 16, 64)
    assert c.self_k.shape == (24, 2, 64, 16, 64)
    assert c.self_k.dtype == torch.bfloat16 and c.length == 0
    jsmoke, tsmoke = jax_get_config(ARCH, smoke=True), get_config(ARCH,
                                                                  smoke=True)
    params = build_model(tsmoke).init(torch.Generator().manual_seed(0))
    with mesh_context(smoke_context()):
        jshapes = jax.eval_shape(jax_build_model(jsmoke).init,
                                 jax.random.PRNGKey(0))
        jfull = jax.eval_shape(jax_build_model(jcfg).init,
                               jax.random.PRNGKey(0))
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jshapes)
            == jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[1]),
                            params, is_leaf=torch.is_tensor))
    tplans = _plan_tuples(make_plans(jfull, 256))
    assert tplans == _plan_tuples(jax_make_plans(jfull, 256))
    low = [v for v in jax.tree.leaves(
        tplans, is_leaf=lambda v: isinstance(v, tuple)) if v[0] == "lowrank"]
    assert len(low) == 20 and max(v[2] for v in low) <= 2048


def test_encdec_batches_carry_the_frames_stub():
    """``batch_for_model`` adds (B, S, d) bf16 frames, 0.1 N(0, 1), a pure
    function of the step, beside the tokens."""
    cfg = get_config(ARCH, smoke=True)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=32, global_batch=2))
    b0, b0_again, b1 = (batch_for_model(cfg, None, data, s)
                        for s in (0, 0, 1))
    assert b0.keys() == {"tokens", "frames"}
    assert b0["frames"].shape == (2, 32, cfg.d_model)
    assert b0["frames"].dtype == torch.bfloat16
    assert torch.equal(b0["frames"], b0_again["frames"])
    assert not torch.equal(b0["frames"], b1["frames"])
    assert 0.08 < float(b0["frames"].float().std()) < 0.12


def test_encdec_clis_run_at_smoke_size(capsys):
    """``train --arch seamless-m4t-large-v2 --smoke --use-kernels
    --grad-fused``: the JAX package's fallback line, finite losses, the
    tracking step at 2 and no kernel launch on the CPU; ``serve``: the
    paged engine's refusal and every request through the dense engine,
    its prefill on zero frames."""
    out = ttrain.train(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "4", "--rank", "32", "--update-interval",
                        "2", "--use-kernels", "--batch", "2", "--seq", "32",
                        "--grad-fused"])
    said = capsys.readouterr().out
    assert ("--grad-fused requested but this model family exposes no "
            "taggable matmuls — falling back to the plain backward") in said
    assert all(np.isfinite(out["losses"]))
    assert [h["step"] for h in out["history"] if h["subspace_update"]] == [2]
    assert not any(h["quarantined"] for h in out["history"])
    assert not any(out["launch_counts"].values())
    assert ops.launch_counts() == out["launch_counts"]
    frames = tserve._prefill_inputs(get_config(ARCH, smoke=True),
                                    np.zeros((2, 8), np.int64), "cpu")
    assert frames["frames"].shape == (2, 8, 128)
    assert not frames["frames"].any()
    served = tserve.serve(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "3", "--batch", "2",
                           "--prompt-len", "8", "--gen", "3"])
    said = capsys.readouterr().out
    assert ("paged engine unavailable for seamless-m4t-large-v2: family "
            "'encdec' has no paged cache layout — falling back to "
            "dense") in said
    assert served["engine"] == "dense" and served["tokens"] == 9
    assert all(len(v) == 3 for v in served["outputs"].values())
