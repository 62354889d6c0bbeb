"""The decoder family's attention and embedding variants against the JAX
package, on the CPU.

Three smoke configs, fp32, from parameters of the JAX package's schema
drawn with numpy (every norm scale and bias nonzero) and carried over
with ``params_from_jax``, on the same numpy batch:

* gemma2-27b: local/global alternation with the window cut to 16 at S 64
  and blocks of 32, so the local mask bites in the forward and in decode;
  attention and final softcaps, sandwich norms, GeGLU, tied and scaled
  embeddings (no ``lm_head`` leaf);
* minicpm3-4b: MLA (the latent cache, the absorbed decode);
* qwen2-vl-2b: M-RoPE over distinct t / h / w streams, QKV bias, the
  vision embeddings spliced into the prefix.

For each, one module-scoped fixture runs the JAX package once: the
forward's logits, the loss (``remat="none"``) and its gradients, prefill
logits and cache, and 3 decode steps.  The port matches each at 2e-5 of
the largest entry.  Direct cases hold ``blocked_attention`` (window,
softcap, both), the MLA attention functions, ``apply_mrope``, ``softcap``
and ``gelu`` in fp32 (2e-5) and bf16 (2e-2, the dense tests' bf16
tolerance), ``_tap_paths`` and ``paged_supported`` against the
reference's, one SubTrack++ tracking step of the tied gemma2 smoke from
the JAX package's state at 1e-3, and the vision stub's batch and serving
inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.api import get_optimizer as jax_get_optimizer
from repro.distributed.context import mesh_context
from repro.launch.mesh import smoke_context
from repro.launch.steps import _tap_paths as jax_tap_paths
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.models.api import build_model as jax_build_model
from repro_torch.configs.registry import get_config
from repro_torch.core.api import get_optimizer
from repro_torch.core.subtrack import tree_leaves
from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                       batch_for_model)
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import _tap_paths
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model
from torch_compare import close, close_tree
from torch_threads import one_thread  # noqa: F401


TOL = 2e-5
BF16_TOL = 2e-2
ARCHS = ("gemma2-27b", "minicpm3-4b", "qwen2-vl-2b")
EXTRA = {"gemma2-27b": dict(sliding_window=16)}
B, S, MAX_LEN, DECODE_STEPS = 2, 64, 72, 3


def _jax_params(jcfg, seed):
    """Parameters of the JAX package's schema and shapes (its init traced
    for shapes only; its truncated normals cost seconds on the CPU), drawn
    with numpy: fan-in scaled weights, 0.02 N(0, 1) embeddings, and every
    norm scale and bias nonzero."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))

    def draw(path, sds):
        name = path[-1].key
        if name == "embed":
            std = 0.02
        elif name in ("w_uk", "w_uv"):           # (L, kvr, H, d): fan-in kvr
            std = sds.shape[1] ** -0.5
        elif len(sds.shape) >= 3 or name == "lm_head":
            std = sds.shape[-2] ** -0.5
        else:                                    # norms, biases
            std = 0.1
        return (std * rng.standard_normal(sds.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _configs(arch, dtype="float32"):
    kw = dict(dtype=dtype, **EXTRA.get(arch, {}))
    return (jax_get_config(arch, smoke=True).with_(**kw),
            get_config(arch, smoke=True).with_(**kw))


def _batch_np(cfg, seed):
    """Tokens, and for the vision config the stub's embeddings and
    distinct t / h / w position streams."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.vision_tokens:
        batch["vision_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
        t = np.arange(S)
        batch["mrope_positions"] = np.broadcast_to(
            np.stack([t, (t * 3) % 17, (t * 5) % 29]), (B, 3, S)
        ).astype(np.int32).copy()
    return batch


def _to_torch(batch):
    return {k: torch.tensor(v, dtype=torch.int64 if k == "tokens" else None)
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def variant(request):
    """Everything the model tests compare, from one run of the JAX
    package: forward logits, loss and gradients (one compiled program),
    prefill logits and cache, and 3 decode steps (one program each)."""
    arch = request.param
    jcfg, tcfg = _configs(arch)
    batch = _batch_np(jcfg, seed=len(arch))
    steps = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (DECODE_STEPS, B)).astype(np.int32)
    with mesh_context(smoke_context()):
        jb = jax_build_model(jcfg)
        params_np = _jax_params(jcfg, seed=2)
        jp = jax.tree.map(jnp.asarray, params_np)
        jbatch = jax.tree.map(jnp.asarray, batch)
        extras = {k: v for k, v in jbatch.items() if k != "tokens"}

        def loss_fn(p):
            logits, _ = jtf.decoder_forward(p, jbatch["tokens"], jcfg,
                                            extras, remat="none")
            labels, mask = jcommon.shift_labels(jbatch["tokens"])
            return jcommon.cross_entropy(logits, labels, mask,
                                         jcfg.vocab_size), logits

        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jp)
        lg, cache = jax.jit(lambda p, b: jb.prefill(p, b, MAX_LEN))(jp,
                                                                   jbatch)
        decode = jax.jit(jb.decode_step)
        served = [(lg, cache)]
        for tok in steps:
            lg, cache = decode(jp, cache, jnp.asarray(tok))
            served.append((lg, cache))
        want = {"loss": float(loss), "logits": np.asarray(logits),
                "grads": jax.tree.map(np.asarray, grads),
                "served": [(np.asarray(a), jax.tree.map(np.asarray, c))
                           for a, c in served]}
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, batch=batch, steps=steps,
                params_np=params_np, want=want)


def test_forward_loss_and_grads_match_jax(variant):
    tcfg, want = variant["tcfg"], variant["want"]
    params = params_from_jax(variant["params_np"], tcfg)
    assert ("lm_head" in params) == (not tcfg.tie_embeddings)
    batch = _to_torch(variant["batch"])
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    logits, aux = ttf.decoder_forward(params, batch["tokens"], tcfg, extras,
                                      remat="none")
    close(logits.detach(), want["logits"])
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, metrics = build_model(tcfg).loss(params, batch, remat="none")
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert float(loss.detach()) == pytest.approx(want["loss"], rel=TOL)
    assert float(metrics["aux_loss"]) == 0.0
    it = iter(grads)
    close_tree(jax.tree.map(lambda _: next(it), params,
                             is_leaf=torch.is_tensor),
                want["grads"])


def test_prefill_and_decode_match_jax(variant):
    tcfg, want = variant["tcfg"], variant["want"]
    params = params_from_jax(variant["params_np"], tcfg)
    bundle = build_model(tcfg)
    mla = tcfg.attn_type == "mla"
    fields = ("c_kv", "k_rope") if mla else ("k", "v", "positions")
    logits, cache = bundle.prefill(params, _to_torch(variant["batch"]),
                                   MAX_LEN)
    got = [(logits, [getattr(cache.kv, f).clone() for f in fields],
            cache.length)]
    for tok in variant["steps"]:
        logits, cache = bundle.decode_step(params, cache, torch.tensor(
            tok, dtype=torch.int64))
        got.append((logits, [getattr(cache.kv, f).clone() for f in fields],
                    cache.length))
    for i, ((lg, kv, length), (wlg, wc)) in enumerate(zip(got,
                                                          want["served"])):
        assert lg.shape == wlg.shape == (B, tcfg.padded_vocab), i
        close(lg, wlg, msg=f"logits {i}")
        for f, t in zip(fields, kv):
            close(t, getattr(wc.kv, f), msg=f"{f} {i}")
        assert length == int(wc.length) == S + i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(8, 0.0), (None, 5.0), (8, 5.0),
                                        (1 << 30, 5.0)])
def test_blocked_attention_window_softcap_matches_jax(window, cap, dtype):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 32, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    want = jattn.blocked_attention(
        *(jnp.asarray(a, dtype) for a in (q, k, v)), window=window,
        softcap=cap, q_block=16, kv_block=16)
    tdt = getattr(torch, dtype)
    got = tattn.blocked_attention(*(torch.tensor(a).to(tdt)
                                    for a in (q, k, v)), window=window,
                                  softcap=cap, kv_block=16)
    assert got.dtype == tdt
    close(got, want, TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_matches_jax(dtype):
    """The prefill's expanded form and the decode's absorbed form, and the
    decode against the prefill's last row at the same position."""
    rng = np.random.default_rng(1)
    Bm, T, H, dn, dr, dv, kvr = 2, 16, 4, 16, 8, 12, 24

    def rn(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    qn, qr = rn(Bm, T, H, dn), rn(Bm, T, H, dr)
    c, kr = rn(Bm, T, kvr), rn(Bm, T, dr)
    wuk, wuv = rn(kvr, H, dn, s=0.2), rn(kvr, H, dv, s=0.2)
    tdt = getattr(torch, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL

    def j(*a):
        return [jnp.asarray(x, dtype) for x in a]

    def t(*a):
        return [torch.tensor(x).to(tdt) for x in a]

    want = jattn.mla_prefill_attention(*j(qn, qr, c, kr, wuk, wuv),
                                       softcap=3.0, q_block=8, kv_block=8)
    got = tattn.mla_prefill_attention(*t(qn, qr, c, kr, wuk, wuv),
                                      softcap=3.0, kv_block=8)
    close(got, want, tol)
    pos = 9
    want_d = jattn.mla_decode_attention(
        *j(qn[:, pos], qr[:, pos], c, kr, wuk, wuv), pos, softcap=3.0)
    got_d = tattn.mla_decode_attention(
        *t(qn[:, pos], qr[:, pos], c, kr, wuk, wuv), pos, softcap=3.0)
    assert got_d.dtype == tdt
    close(got_d, want_d, tol)
    if dtype == "float32":   # absorbed == expanded, in exact arithmetic
        close(got_d, got[:, pos], 1e-5)


@pytest.mark.parametrize("streams", ["equal", "unequal"])
def test_apply_mrope_matches_jax(streams):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, 3, 32)).astype(np.float32)
    t = np.arange(10)
    pos = (np.stack([t, t, t]) if streams == "equal"
           else np.stack([t, 2 * t + 1, (7 * t) % 5]))
    pos = np.broadcast_to(pos, (2, 3, 10)).astype(np.int32)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                               (4, 6, 6))
    got = tcommon.apply_mrope(torch.tensor(x), torch.tensor(pos), 1e4,
                              (4, 6, 6))
    close(got, want)
    if streams == "equal":   # text positions: standard RoPE
        close(got, tcommon.apply_rope(torch.tensor(x),
                                       torch.tensor(pos[:, 0]), 1e4))
    with pytest.raises(ValueError, match="sections"):
        tcommon.apply_mrope(torch.tensor(x), torch.tensor(pos), 1e4,
                            (4, 6, 5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["softcap", "gelu"])
def test_softcap_and_gelu_match_jax(fn, dtype):
    x = (np.random.default_rng(3).standard_normal(257) * 40).astype(
        np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.tensor(x).to(getattr(torch, dtype))
    if fn == "softcap":
        want, got = jcommon.softcap(jx, 30.0), tcommon.softcap(tx, 30.0)
        assert tcommon.softcap(tx, 0.0) is tx
    else:
        want, got = jcommon.gelu(jx), tcommon.gelu(tx)
    assert got.dtype == tx.dtype
    close(got, want, TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_tap_paths_and_paged_supported_match_jax(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert _tap_paths(tcfg) == jax_tap_paths(jcfg)
    assert ttf.paged_supported(tcfg) == jtf.paged_supported(jcfg)
    assert ttf.paged_supported(tcfg)[0] is False
    jsmoke, tsmoke = _configs(arch)
    params = build_model(tsmoke).init(torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(jax_build_model(jsmoke).init,
                             jax.random.PRNGKey(0))
    assert (jax.tree.map(lambda a: tuple(a.shape), jshapes)
            == jax.tree.map(lambda t: tuple(t.shape), params,
                            is_leaf=torch.is_tensor))


def test_tracking_step_of_tied_gemma2_matches_jax():
    """One SubTrack++ tracking step on the tied gemma2 smoke's tree (8
    low-rank leaves, no lm_head), from one JAX optimizer state mid-run
    (orthonormal S, nonzero moments, step 1) copied over: the updates and
    the new S, M, V at 1e-3 of the largest entry; eta puts theta near 0.3.
    V is drawn away from zero, as a few Adam steps leave it: where V is
    ~1e-9 of its largest entry, Adam's 1/sqrt(V) amplifies the two
    packages' fp32 summation orders past 1e-3 (S, M and V still agree at
    ~1e-6)."""
    from repro.core.lowrank_adam import MatrixOptState as JMatrixState

    jcfg, tcfg = _configs("gemma2-27b")
    kw = dict(rank=32, update_interval=2, eta=5.0)
    rng = np.random.default_rng(4)
    params_np = _jax_params(jcfg, seed=5)
    grads_np = jax.tree.map(lambda a: (0.01 * rng.standard_normal(
        a.shape)).astype(np.float32), params_np)

    def mid_run(st):
        if not isinstance(st, JMatrixState):
            return st
        S = np.linalg.qr(rng.standard_normal(st.S.shape))[0]
        return st._replace(
            S=jnp.asarray(S, jnp.float32),
            M=jnp.asarray(0.01 * rng.standard_normal(st.M.shape),
                          jnp.float32),
            V=jnp.asarray(1e-4 * (0.5 + np.abs(rng.standard_normal(
                st.V.shape))), jnp.float32))

    with mesh_context(smoke_context()):
        jopt = jax_get_optimizer("subtrack", **kw)
        jp = jax.tree.map(jnp.asarray, params_np)
        state = jax.jit(jopt.init)(jp)
        state = state._replace(step=jnp.int32(1), inner=jax.tree.map(
            mid_run, state.inner,
            is_leaf=lambda x: isinstance(x, JMatrixState)))
        state_np = jax.tree.map(np.asarray, state)
        jupd, jnew, diag = jax.jit(lambda g, st, p: jopt.update(
            g, st, p, 1e-3, do_subspace_update=True, with_health=True))(
            jax.tree.map(jnp.asarray, grads_np), state, jp)
        jupd, jnew = jax.tree.map(np.asarray, (jupd, jnew))
    assert "lm_head" not in params_np
    assert 0.1 < float(diag[1]) < 1.0          # the applied theta
    topt = get_optimizer("subtrack", **kw)
    upd, new = topt.update(params_from_jax(grads_np, tcfg),
                           opt_state_from_jax(state_np),
                           params_from_jax(params_np, tcfg), 1e-3,
                           do_subspace_update=True)
    close_tree(upd, jupd, 1e-3)
    n_lowrank = 0
    for path, st in _leaves(new.inner):
        jst = _at(jnew.inner, path)
        for f in st._fields:
            close(getattr(st, f), getattr(jst, f), 1e-3, f"{path} {f}")
        n_lowrank += "S" in st._fields
    assert n_lowrank == 8


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_opt_state_from_jax_follows_each_leafs_plan():
    """One leaf, dense in one variant and low-rank in another: minicpm3's
    w_uk (L, kvr, H, dn) is dense at every rank (its trailing (H, dn) is
    small), qwen2-vl's wk (L, 128, 64) is dense at rank 64 and low-rank
    at rank 32; the copied state takes each leaf's own kind."""
    for arch, rank, path, kind in (
            ("minicpm3-4b", 8, ("layers", "attn", "w_uk"), "dense"),
            ("qwen2-vl-2b", 64, ("layers", "attn", "wk"), "dense"),
            ("qwen2-vl-2b", 32, ("layers", "attn", "wk"), "lowrank")):
        jcfg, tcfg = _configs(arch)
        params_np = _jax_params(jcfg, seed=6)
        with mesh_context(smoke_context()):
            state_np = jax.tree.map(   # the state's tree and shapes only
                lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
                    jax_get_optimizer("subtrack", rank=rank).init,
                    params_np))
        got = opt_state_from_jax(state_np)
        st = _at(got.inner, path)
        assert ("S" in st._fields) == (kind == "lowrank"), (arch, rank)
        want = _at(get_optimizer("subtrack", rank=rank).init(
            params_from_jax(params_np, tcfg)).inner, path)
        assert type(st) is type(want)
        for a, b in zip(st, want):
            assert a.shape == b.shape


def test_vision_batch_and_serving_inputs():
    """The vision stub's batch: bf16 0.02 N(0, 1) embeddings drawn per
    step, t = h = w positions; the dense engine's prefill inputs as the
    JAX driver's (zero embeddings); a prompt shorter than the vision
    tokens is refused."""
    cfg = get_config("qwen2-vl-2b", smoke=True)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=12, global_batch=2))
    b0, b1 = (batch_for_model(cfg, None, ds, s) for s in (0, 1))
    assert b0["vision_embeds"].shape == (2, cfg.vision_tokens, cfg.d_model)
    assert b0["vision_embeds"].dtype == torch.bfloat16
    assert 0.01 < float(b0["vision_embeds"].float().std()) < 0.03
    assert not torch.equal(b0["vision_embeds"], b1["vision_embeds"])
    assert torch.equal(b0["vision_embeds"],
                       batch_for_model(cfg, None, ds, 0)["vision_embeds"])
    pos = b0["mrope_positions"]
    assert pos.shape == (2, 3, 12) and pos.dtype == torch.int32
    assert torch.equal(pos, torch.arange(12, dtype=torch.int32).expand(
        2, 3, 12))
    llama = get_config("llama-100m", smoke=True)
    assert batch_for_model(llama, None, ds, 0).keys() == {"tokens"}
    toks = np.zeros((2, 12), np.int64)
    inp = tserve._prefill_inputs(cfg, toks, "cpu")
    assert not inp["vision_embeds"].any()
    assert torch.equal(inp["mrope_positions"], pos)
    with pytest.raises(ValueError, match="vision tokens"):
        tserve.run_dense(cfg, build_model(cfg), {"embed": torch.zeros(1)},
                         tserve.AdmissionQueue(), batch=1, prompt_len=4)


def test_wide_svd_reduction_keeps_the_basis():
    """The warm start's QR-first route for a gradient gesvd refuses on the
    card (gemma2's (4608, 256000) embedding): R^T of G^T = Q R has G's
    singular values and its top-r left singular vectors (projectors at
    1e-5), on a stacked wide G."""
    from repro_torch.core.subspace import r_factor_t

    G = torch.tensor(np.random.default_rng(7).standard_normal(
        (2, 48, 400)), dtype=torch.float32)
    R = r_factor_t(G)
    assert R.shape == (2, 48, 48)
    U, s, _ = torch.linalg.svd(G, full_matrices=False)
    U2, s2, _ = torch.linalg.svd(R, full_matrices=False)
    close(s2, s.numpy(), 1e-5)
    P, P2 = (u[..., :16] @ u[..., :16].mT for u in (U, U2))
    close(P2, P.numpy(), 1e-5)
