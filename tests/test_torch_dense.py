"""The port's dense serving programs against the JAX package, on the CPU.

* ``decode_attention`` in its four modes (plain, ring-buffer position
  tags, sliding window, logit softcap) on the same numpy inputs, fp32 at
  2e-5 and bf16 at a bf16 tolerance.
* The cache helpers: ``cache_write`` (ring and not), ``_fit_cache`` and
  ``_prefill_positions`` for S < T, S = T and S > T (exact).
* ``decoder_prefill`` (last-position logits and every cache entry) and
  three ``decoder_decode_step``s (logits, the written cache, the length),
  from the JAX init's parameters, on the fp32 smoke llama's GQA variant,
  at 2e-5 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.distributed.context import mesh_context
from repro.launch.mesh import smoke_context
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.api import build_model as jax_build_model
from repro_torch.configs.registry import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model
from torch_threads import one_thread  # noqa: F401


TOL = 2e-5


def _close(got, want, tol=TOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("mode", ["plain", "ring", "window", "softcap"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(mode, dtype):
    rng = np.random.default_rng(0)
    B, T, Hq, Hkv, hd = 2, 12, 6, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)))
    pos = 9
    kw = {}
    if mode == "ring":
        # slot i holds the latest position congruent to i (mod T) after
        # writing position 17; slots 6..11 hold 6..11, and 3 is empty
        tags = np.array([12, 13, 14, -1, 16, 17, 6, 7, 8, 9, 10, 11],
                        np.int32)
        pos = 17
        kw = dict(cache_positions=tags)
    elif mode == "window":
        kw = dict(window=4)
    elif mode == "softcap":
        kw = dict(softcap=5.0)
        q = 4.0 * q
    want = jattn.decode_attention(
        *(jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v)),
        jnp.int32(pos), **{key: jnp.asarray(val) if key == "cache_positions"
                           else val for key, val in kw.items()})
    tdt = getattr(torch, dtype)
    got = tattn.decode_attention(
        *(torch.tensor(a).to(tdt) for a in (q, k, v)), pos,
        **{key: torch.tensor(val) if key == "cache_positions" else val
           for key, val in kw.items()})
    assert got.dtype == tdt and got.shape == (B, Hq, hd)
    _close(got, want, TOL if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("ring,pos", [(False, 5), (True, 5), (True, 13),
                                      (False, 20)])
def test_cache_write_matches_jax(ring, pos):
    """One token into a (2, 8, 2, 4) layer cache: the slot (pos % T on a
    ring; a position past a plain cache lands in its last slot, as XLA
    clamps) and the position tag."""
    rng = np.random.default_rng(pos)
    kl, vl = (rng.standard_normal((2, 8, 2, 4)).astype(np.float32)
              for _ in range(2))
    tags = np.arange(8, dtype=np.int32)
    kn, vn = (rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
              for _ in range(2))
    want = jattn.cache_write(jnp.asarray(kl), jnp.asarray(vl),
                             jnp.asarray(tags), jnp.asarray(kn),
                             jnp.asarray(vn), jnp.int32(pos), ring)
    got = tattn.cache_write(torch.tensor(kl), torch.tensor(vl),
                            torch.tensor(tags), torch.tensor(kn),
                            torch.tensor(vn), pos, ring)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("S", [5, 8, 13, 16])
def test_fit_cache_and_prefill_positions_match_jax(S):
    T = 8
    arr = np.random.default_rng(S).standard_normal((2, S, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        ttf._fit_cache(torch.tensor(arr), T, S).numpy(),
        np.asarray(jtf._fit_cache(jnp.asarray(arr), T, S)))
    np.testing.assert_array_equal(ttf._prefill_positions(S, T).numpy(),
                                  np.asarray(jtf._prefill_positions(S, T)))
    np.testing.assert_array_equal(
        tattn.pad_to(torch.tensor(arr), max(S, T)).numpy(),
        np.asarray(jattn.pad_to(jnp.asarray(arr), max(S, T))))


def test_cache_len_and_init_match_jax():
    for name in ("llama-100m", "qwen1.5-4b"):
        for extra in ({}, {"sliding_window": 6},
                      {"sliding_window": 6, "local_global_period": 2}):
            jcfg = jax_get_config(name, smoke=True).with_(**extra)
            tcfg = get_config(name, smoke=True).with_(**extra)
            assert ttf._cache_len(tcfg, 10) == jtf._cache_len(jcfg, 10)
    tcfg = get_config("llama-100m", smoke=True)
    jcache = jtf.init_decoder_cache(jax_get_config("llama-100m", smoke=True),
                                    2, 10)
    tcache = build_model(tcfg).init_cache(2, 10, "cpu")
    for f in ("k", "v", "positions"):
        j, t = np.asarray(getattr(jcache.kv, f)), getattr(tcache.kv, f)
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))
    assert tcache.kv.k.dtype == torch.bfloat16 and tcache.length == 0
    # a pure sliding-window config's ring: the window's slots, all empty
    jring = jtf.init_decoder_cache(jax_get_config("llama-100m", smoke=True)
                                   .with_(sliding_window=6), 2, 10)
    tring = ttf.init_decoder_cache(tcfg.with_(sliding_window=6), 2, 10)
    for f in ("k", "v", "positions"):
        j, t = np.asarray(getattr(jring.kv, f)), getattr(tring.kv, f)
        assert tuple(t.shape) == j.shape and j.shape[2 if f != "positions"
                                                     else 1] == 6
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))


def _perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in tree.items()}
    if not np.any(tree):
        return (0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)
    return tree


def test_prefill_and_decode_steps_match_jax():
    """Prefill 9 tokens of a batch of 2 into a 16-slot cache, then 3 decode
    steps of fixed tokens: logits, cache contents, position tags and
    lengths as the JAX programs' at 2e-5 of the largest entry.  The GQA
    variant of the smoke llama (2 KV heads for 4 query heads, QKV bias,
    25% partial rotary, every zero-initialised weight perturbed) carries
    every feature the plain llama has; ``tests/test_torch_serve.py`` runs
    both through the dense engine."""
    extra = dict(n_kv_heads=2, qkv_bias=True, rope_pct=0.25)
    jcfg = jax_get_config("llama-100m", smoke=True).with_(dtype="float32",
                                                          **extra)
    tcfg = get_config("llama-100m", smoke=True).with_(dtype="float32",
                                                      **extra)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    steps = rng.integers(0, tcfg.vocab_size, (3, 2)).astype(np.int32)
    max_len = 16
    with mesh_context(smoke_context()):
        jb = jax_build_model(jcfg)
        params_np = _perturb(jax.tree.map(
            np.asarray, jax.jit(jb.init)(jax.random.PRNGKey(0))),
            np.random.default_rng(1))
        jp = jax.tree.map(jnp.asarray, params_np)
        jlogits, jcache = jax.jit(lambda p, b: jb.prefill(p, b, max_len))(
            jp, {"tokens": jnp.asarray(tokens)})
        want = [(jlogits, jcache)]
        decode = jax.jit(jb.decode_step)
        for tok in steps:
            jlogits, jcache = decode(jp, jcache, jnp.asarray(tok))
            want.append((jlogits, jcache))
        want = [(np.asarray(lg), jax.tree.map(np.asarray, c))
                for lg, c in want]

    tb = build_model(tcfg)
    tp = params_from_jax(params_np, tcfg)
    logits, cache = tb.prefill(tp, {"tokens": torch.tensor(
        tokens, dtype=torch.int64)}, max_len)
    got = [(logits, cache.kv.k.clone(), cache.kv.v.clone(),
            cache.kv.positions.clone(), cache.length)]
    for tok in steps:
        logits, cache = tb.decode_step(tp, cache, torch.tensor(
            tok, dtype=torch.int64))
        got.append((logits, cache.kv.k.clone(), cache.kv.v.clone(),
                    cache.kv.positions.clone(), cache.length))
    for i, ((lg, k, v, tags, length), (wlg, wc)) in enumerate(zip(got,
                                                                 want)):
        assert lg.shape == wlg.shape == (2, tcfg.padded_vocab), i
        _close(lg, wlg)
        _close(k, wc.kv.k)
        _close(v, wc.kv.v)
        np.testing.assert_array_equal(tags.numpy(), wc.kv.positions)
        assert length == int(wc.length) == 9 + i
    # the batch's other entries reach the model, which ignores vision
    # embeddings unless the config has vision tokens (as the JAX package's)
    logits_v, _ = tb.prefill(tp, {"tokens": torch.tensor(tokens),
                                  "vision_embeds": torch.ones(
                                      2, 1, tcfg.d_model)}, max_len)
    _close(logits_v, want[0][0])
