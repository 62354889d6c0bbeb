"""The port's paged prefill and decode programs against the JAX package.

Both packages start from the same parameters (the JAX init, copied over
with ``repro_torch.interop.params_from_jax``) and the same pool contents,
tokens, tables and lengths.  The JAX side runs as ``tests/test_serve.py``
runs it, under ``mesh_context(smoke_context())``; its decode reaches the
paged-attention oracle through ``repro.kernels.ops``, the port's through
``repro_torch.kernels.ops`` (the oracle too, on the CPU).

Tolerances: logits 1e-4 abs and the updated pool 1e-5 — fp32 throughout,
so only the summation order differs (the port's prefill also attends over
the gathered table as one KV block where the JAX program uses one block
per table word).

Two configs: the fp32 smoke llama-100m (2 layers, d 128, hd 32, vocab
512) and a GQA variant (n_kv_heads 2, so G = 2, with QKV bias and 25%
partial rotary).  Zero-initialised parameters (norm scales, biases) are
replaced by random values so the ``1 + scale`` and bias conventions are
exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.distributed.context import mesh_context
from repro.launch.mesh import smoke_context
from repro.models.api import build_model as jax_build_model
from repro.models.attention import PagedKV as JaxPagedKV
from repro_torch.configs.registry import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer
from repro_torch.models.api import build_model
from repro_torch.models.attention import PagedKV
from torch_threads import one_thread  # noqa: F401


GQA = dict(n_kv_heads=2, qkv_bias=True, rope_pct=0.25)
NB, BS = 12, 4


def _perturb_zero_inits(tree, rng):
    """Random values for every all-zero leaf (norm scales, biases)."""
    if isinstance(tree, dict):
        return {k: _perturb_zero_inits(v, rng) for k, v in tree.items()}
    if not np.any(tree):
        return (0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)
    return tree


@pytest.fixture(scope="module", params=["llama", "gqa"])
def models(request):
    """(JAX cfg, bundle, params), (port cfg, bundle, params)."""
    extra = GQA if request.param == "gqa" else {}
    jcfg = jax_get_config("llama-100m", smoke=True).with_(
        dtype="float32", **extra)
    tcfg = get_config("llama-100m", smoke=True).with_(
        dtype="float32", **extra)
    with mesh_context(smoke_context()):
        jbundle = jax_build_model(jcfg)
        params_np = jax.tree.map(np.asarray,
                                 jbundle.init(jax.random.PRNGKey(0)))
        params_np = _perturb_zero_inits(params_np, np.random.default_rng(1))
        jparams = jax.tree.map(jnp.asarray, params_np)
        prefill = jax.jit(jbundle.paged_prefill_chunk)
        decode = jax.jit(jbundle.paged_decode_step)
        yield ((jcfg, jparams, prefill, decode),
               (tcfg, build_model(tcfg), params_from_jax(params_np, tcfg)))


def _pools(cfg, seed):
    """The same random pool contents for both packages."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, NB, BS, cfg.n_kv_heads, cfg.hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return (JaxPagedKV(k=jnp.asarray(k), v=jnp.asarray(v)),
            PagedKV(k=torch.tensor(k), v=torch.tensor(v)))


def _close_pool(tpool, jpool):
    np.testing.assert_allclose(tpool.k.numpy(), np.asarray(jpool.k),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tpool.v.numpy(), np.asarray(jpool.v),
                               atol=1e-5, rtol=0)


def test_config_copies_agree():
    for name in ("llama-7b", "qwen1.5-4b", "stablelm-12b", "llama-100m"):
        for smoke in (False, True):
            assert (jax_get_config(name, smoke=smoke).__dict__.keys()
                    == get_config(name, smoke=smoke).__dict__.keys())
            assert repr(jax_get_config(name, smoke=smoke)) == repr(
                get_config(name, smoke=smoke))


def test_init_schema_matches_jax(models):
    (jcfg, jparams, _, _), (tcfg, bundle, _) = models
    own = bundle.init(torch.Generator().manual_seed(0))
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), own)
    assert jshapes == tshapes
    assert all(t.dtype == torch.float32
               for t in jax.tree.leaves(own))


def test_prefill_chunks_match_jax(models):
    """Two chunks of one prompt through a table with null padding: full-chunk
    logits and the whole updated pool (stale contents included)."""
    (jcfg, jparams, prefill, _), (tcfg, bundle, tparams) = models
    jpool, tpool = _pools(tcfg, seed=2)
    table = np.asarray([5, 2, 9, 0, 0], np.int32)       # 3 owned + null pad
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, 11)
    c = 6
    for start in (0, 6):
        chunk = np.zeros(c, np.int64)
        real = prompt[start:start + c]
        chunk[:len(real)] = real                         # padded final chunk
        jlogits, jpool = prefill(jparams, jpool,
                                 jnp.asarray(chunk[None], jnp.int32),
                                 jnp.asarray(table), jnp.int32(start))
        tlogits = bundle.paged_prefill_chunk(
            tparams, tpool, torch.tensor(chunk[None]), torch.tensor(table),
            start)
        assert tlogits.shape == (1, c, tcfg.padded_vocab)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=0)
        _close_pool(tpool, jpool)


def test_decode_wave_matches_jax(models):
    """One wave: mixed lengths (mid-block, block boundary), a lane whose
    next write opens a new table word, and a dead lane."""
    (jcfg, jparams, _, decode), (tcfg, bundle, tparams) = models
    jpool, tpool = _pools(tcfg, seed=4)
    tables = np.asarray([[3, 7, 0, 0], [1, 0, 0, 0], [4, 8, 11, 0],
                         [0, 0, 0, 0]], np.int32)
    lengths = np.asarray([6, 4, 9, 0], np.int32)       # lane 1 -> word 1
    tables[1, 1] = 10                                   # ... already owned
    live = np.asarray([True, True, True, False])
    token = np.asarray([17, 3, 500, 0], np.int64)
    jlogits, jpool = decode(jparams, jpool, jnp.asarray(token, jnp.int32),
                            jnp.asarray(lengths), jnp.asarray(tables),
                            jnp.asarray(live))
    tlogits = bundle.paged_decode_step(
        tparams, tpool, torch.tensor(token), torch.tensor(lengths),
        torch.tensor(tables), torch.tensor(live))
    assert tlogits.shape == (4, tcfg.padded_vocab)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    _close_pool(tpool, jpool)


def test_padded_final_chunk_past_table_leaves_owned_blocks(models):
    """P = 9, chunk 8, bs 4, a fully owned table of W = 3 words: the second
    chunk's pad tokens at positions 12..15 lie past W*bs and must land in
    the null block, not in table[W-1] (torch indexing does not clamp, and
    a clamped gather would alias real position 8)."""
    (jcfg, jparams, prefill, _), (tcfg, bundle, tparams) = models
    jpool, tpool = _pools(tcfg, seed=5)
    table = np.asarray([6, 2, 9], np.int32)
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab_size, 9)
    chunks = [prompt[:8], np.concatenate([prompt[8:], np.zeros(7, int)])]
    snapshots = []
    for start, chunk in zip((0, 8), chunks):
        jlogits, jpool = prefill(jparams, jpool,
                                 jnp.asarray(chunk[None], jnp.int32),
                                 jnp.asarray(table), jnp.int32(start))
        tlogits = bundle.paged_prefill_chunk(
            tparams, tpool, torch.tensor(chunk[None], dtype=torch.int64),
            torch.tensor(table), start)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=0)
        _close_pool(tpool, jpool)
        snapshots.append(tpool.k[:, table].reshape(
            tcfg.n_layers, 12, tcfg.n_kv_heads, tcfg.hd).clone())
    # real positions 0..7 are untouched by the overflowing second chunk
    torch.testing.assert_close(snapshots[1][:, :8], snapshots[0][:, :8],
                               atol=0, rtol=0)
    # position 8 holds the real token's K, not a pad token's: recompute it
    # with the whole prompt as one chunk into a fresh pool
    _, fresh = _pools(tcfg, seed=5)
    bundle.paged_prefill_chunk(tparams, fresh, torch.tensor(
        prompt[None], dtype=torch.int64), torch.tensor(table), 0)
    got = fresh.k[:, table].reshape(tcfg.n_layers, 12, tcfg.n_kv_heads,
                                    tcfg.hd)
    torch.testing.assert_close(snapshots[1][:, 8], got[:, 8],
                               atol=1e-5, rtol=0)


def test_decode_lane_past_its_table_writes_only_the_null_block(models):
    """A live lane whose next position lies past its table (an engine
    invariant break) must not alias table[W-1]: its write goes to the
    null block and every owned block keeps its contents."""
    _, (tcfg, bundle, tparams) = models
    _, tpool = _pools(tcfg, seed=7)
    before = tpool.k.clone()
    tables = torch.tensor([[3, 7]], dtype=torch.int32)
    bundle.paged_decode_step(tparams, tpool, torch.tensor([5]),
                             torch.tensor([2 * BS], dtype=torch.int32),
                             tables, torch.tensor([True]))
    changed = (tpool.k != before).flatten(2).any(-1).any(0)    # per block
    assert changed.nonzero().flatten().tolist() == [0]


@pytest.mark.parametrize("kv_block", [4, 8, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_attention_matches_jax(kv_block, dtype):
    """Causal GQA attention with a prefill offset (queries at positions
    13..18 over 24 keys), one KV block or several; tolerance as for the
    decode oracle: fp32 2e-5, bf16 atol 3e-2 / rtol 5e-2."""
    from repro.models.attention import blocked_attention as jax_blocked
    from repro_torch.models.attention import blocked_attention

    rng = np.random.default_rng(kv_block)
    q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    want = jax_blocked(*(jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v)),
                       causal=True, q_offset=13, q_block=6, kv_block=4)
    got = blocked_attention(*(torch.tensor(a).to(getattr(torch, dtype))
                              for a in (q, k, v)),
                            q_offset=13, kv_block=kv_block)
    tol = (dict(atol=2e-5, rtol=2e-5) if dtype == "float32"
           else dict(atol=3e-2, rtol=5e-2))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_paged_supported_matches_jax():
    from repro.models.transformer import paged_supported as jax_supported

    for name in ("llama-7b", "qwen1.5-4b", "stablelm-12b", "gemma2-27b",
                 "minicpm3-4b", "qwen2-vl-2b", "mixtral-8x22b",
                 "llama4-maverick-400b-a17b", "zamba2-7b", "xlstm-125m",
                 "seamless-m4t-large-v2"):
        assert transformer.paged_supported(get_config(name)) == \
            jax_supported(jax_get_config(name))
    # every arch id of the JAX package is ported: an unknown one raises
    # the JAX package's error
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")


def test_registry_and_configs_match_the_reference():
    """The port's registry holds exactly the JAX package's arch ids, each
    config (full and smoke) equal to the reference's field by field, and
    ``build_model`` raises the reference's error for an unknown family."""
    import dataclasses

    from repro.configs.registry import arch_names as jax_arch_names
    from repro_torch.configs.registry import arch_names
    from repro_torch.models.api import build_model

    assert arch_names() == jax_arch_names()
    for name in arch_names():
        for smoke in (False, True):
            assert dataclasses.asdict(get_config(name, smoke)) == \
                dataclasses.asdict(jax_get_config(name, smoke)), name
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(get_config("llama-60m").with_(family="rnn"))
