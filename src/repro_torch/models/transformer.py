"""Decoder-only transformer: the training forward, the dense serving
path and the paged serving path.

Counterpart of ``repro.models.transformer`` for the plain GQA decoder with
dense MLPs: init, the training forward and loss (``decoder_forward``,
``decoder_loss``), the dense serving programs (``decoder_prefill`` into a
per-slot cache, ``decoder_decode_step``), and the two paged programs (one
prefill chunk of one prompt; one decode wave over a batch) and their
blocks.  The parameter schema is the JAX package's: nested dicts with the
layer stack on a leading axis, weights ``(in, out)``.  The layer loop is a
Python loop over that axis where the JAX code scans.

Both caches are updated in place (the JAX programs return new ones).
Torch indexing does not clamp as XLA's does, so every index that could
leave its table is routed explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_rope, cross_entropy, dense_init,
                                       embed_init, maybe_tapped_matmul,
                                       rms_norm, shift_labels)
from repro_torch.models.config import ModelConfig


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_decoder(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random init on the generator's device, layers stacked on axis 0."""
    dtype = torch_dtype(cfg.dtype)
    L, d, hd, ff = cfg.n_layers, cfg.d_model, cfg.hd, cfg.d_ff
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=gen.device)

    def dense(*shape):
        return dense_init(gen, shape, dtype=dtype)

    a = {"wq": dense(L, d, Hq * hd), "wk": dense(L, d, Hkv * hd),
         "wv": dense(L, d, Hkv * hd), "wo": dense(L, Hq * hd, d)}
    if cfg.qkv_bias:
        a.update(bq=zeros(L, Hq * hd), bk=zeros(L, Hkv * hd),
                 bv=zeros(L, Hkv * hd))
    return {
        "embed": embed_init(gen, (cfg.padded_vocab, d), dtype),
        "layers": {
            "ln1": zeros(L, d), "ln2": zeros(L, d), "attn": a,
            "mlp": {"w_gate": dense(L, d, ff), "w_up": dense(L, d, ff),
                    "w_down": dense(L, ff, d)},
        },
        "final_norm": zeros(d),
        "lm_head": dense(d, cfg.padded_vocab),
    }


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer tree (views, no copies)."""
    def pick(tree):
        return ({k: pick(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[i])
    return pick(params["layers"])


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _rope_q_k(cfg: ModelConfig, q, k, positions):
    """Apply (partial) rotary embeddings to q and k: the first
    ``int(hd * rope_pct) // 2 * 2`` dims rotate, the rest pass through."""
    hd = q.shape[-1]
    rot = int(hd * cfg.rope_pct) // 2 * 2                # even # of rotary dims
    if rot < hd:
        q = torch.cat([apply_rope(q[..., :rot], positions, cfg.rope_theta),
                       q[..., rot:]], dim=-1)
        k = torch.cat([apply_rope(k[..., :rot], positions, cfg.rope_theta),
                       k[..., rot:]], dim=-1)
        return q, k
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _qkv(h, pa, cfg: ModelConfig, positions, taps=None):
    """Projections + bias + rotary: h (B, S, d) -> q (B, S, Hq, hd),
    k/v (B, S, Hkv, hd).  ``taps``: optional (S, seed) pairs by weight
    name (grad-fused training)."""
    B, S, _ = h.shape
    taps = taps or {}
    q, k, v = (maybe_tapped_matmul(h, pa[w], taps.get(w))
               for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + pa["bq"], k + pa["bk"], v + pa["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    q, k = _rope_q_k(cfg, q, k, positions)
    return q, k, v


def mlp_block(x, p, taps=None) -> torch.Tensor:
    """Dense SwiGLU; ``taps`` as in :func:`_qkv`."""
    taps = taps or {}

    def mm(h, w):
        return maybe_tapped_matmul(h, p[w], taps.get(w))

    return mm(F.silu(mm(x, "w_gate")) * mm(x, "w_up"), "w_down")


def _logits(params, x, tap=None) -> torch.Tensor:
    """Logits over the PADDED vocabulary (greedy argmax takes that width)."""
    return maybe_tapped_matmul(x, params["lm_head"], tap)


# ---------------------------------------------------------------------------
# Training forward (full sequence, under autograd)
# ---------------------------------------------------------------------------


def gqa_block(x, p, cfg: ModelConfig, positions, taps=None) -> torch.Tensor:
    """Causal GQA self-attention over the whole sequence -> (B, S, d).
    ``blocked_attention`` takes every query at once; the JAX package's
    query blocking changes no query's result.  ``taps`` as in
    :func:`_qkv`."""
    B, S, _ = x.shape
    q, k, v = _qkv(x, p, cfg, positions, taps)
    out = attn.blocked_attention(q, k, v, kv_block=cfg.kv_block)
    return maybe_tapped_matmul(out.reshape(B, S, cfg.n_heads * cfg.hd),
                               p["wo"], (taps or {}).get("wo"))


def _unstack_layers(tree) -> list[dict]:
    """The stacked layer tree as one dict of views per layer.  ``unbind``
    (not per-layer indexing) so the backward stacks each leaf's per-layer
    gradients once instead of scattering every layer into a zeroed
    full-stack buffer."""
    if isinstance(tree, dict):
        per_key = {k: _unstack_layers(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, dim=0))


def _unstack_taps(layer_taps: dict, n_layers: int) -> list[dict]:
    """The stacked per-layer taps ``{"attn": {"wq": (S, seed), ...},
    "mlp": {...}}`` as one dict of (S_i, seed_i) views per layer, each
    site unbound once, so each layer's backward emits its own panel into
    the stacked seed's gradient."""
    out: list[dict] = [{} for _ in range(n_layers)]
    for grp, sites in layer_taps.items():
        for name, (S, seed) in sites.items():
            for i, pair in enumerate(zip(S.unbind(0), seed.unbind(0))):
                out[i].setdefault(grp, {})[name] = pair
    return out


# ``remat="dots"``: the counterpart of JAX's
# ``dots_with_no_batch_dims_saveable``.  The projections x @ W are 2-D
# products (``matmul`` folds the batch into rows), so their outputs are
# saved; the attention's batched products (``bmm``) and all elementwise
# work are recomputed in the backward.
DOTS_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_context():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(
        list(DOTS_SAVED_OPS))


def decoder_forward(params, tokens: torch.Tensor, cfg: ModelConfig,
                    remat: str = "full", taps=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, Vp), aux loss ()).

    ``remat="full"`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant), as the JAX package's
    ``jax.checkpoint`` around the scanned block; ``"dots"`` keeps the
    outputs of the layer's projections and recomputes the rest (a
    selective checkpoint, :data:`DOTS_SAVED_OPS`); ``"none"`` keeps every
    activation.  Only the plain GQA decoder with dense MLPs is ported.

    ``taps`` (optional) mirrors the taggable part of ``params``:
    ``{"layers": {"attn": {"wq": (S, seed), ...}, "mlp": {...}},
    "lm_head": (S, seed)}``, layer entries stacked on axis 0.  Those
    matmuls run through :func:`repro_torch.models.common.tapped_matmul`,
    whose backward emits the SubTrack projection statistics as the seeds'
    gradients.  Without taps the model is the plain one."""
    ok, why = paged_supported(cfg)
    if not ok:
        raise NotImplementedError(f"training {cfg.name} is not yet ported "
                                  f"to repro_torch: {why}")
    if remat not in ("full", "dots", "none"):
        raise NotImplementedError(f"remat={remat!r} is not yet ported to "
                                  "repro_torch (full, dots, none)")
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :]

    def block(x, p, lt):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + gqa_block(h, p["attn"], cfg, positions, lt.get("attn"))
        return x + mlp_block(rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"],
                             lt.get("mlp"))

    x = params["embed"][tokens]
    taps = taps or {}
    per_layer = _unstack_layers(params["layers"])
    layer_taps = _unstack_taps(taps.get("layers", {}), len(per_layer))
    for p, lt in zip(per_layer, layer_taps):
        if remat == "full":
            x = torch.utils.checkpoint.checkpoint(block, x, p, lt,
                                                  use_reentrant=False)
        elif remat == "dots":
            x = torch.utils.checkpoint.checkpoint(block, x, p, lt,
                                                  use_reentrant=False,
                                                  context_fn=_dots_context)
        else:
            x = block(x, p, lt)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (_logits(params, x, taps.get("lm_head")),
            torch.zeros((), device=x.device))


def decoder_loss(params, batch: dict, cfg: ModelConfig,
                 remat: str = "full", taps=None):
    """(loss, {"ce_loss", "aux_loss"}): next-token cross entropy over the
    real vocabulary, the last position masked.  ``taps`` as in
    :func:`decoder_forward`."""
    tokens = batch["tokens"]
    logits, aux = decoder_forward(params, tokens, cfg, remat, taps)
    labels, mask = shift_labels(tokens)
    loss = cross_entropy(logits, labels, mask, cfg.vocab_size)
    return loss + aux, {"ce_loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Dense serving: prefill into a per-slot cache + single-token decode
# ---------------------------------------------------------------------------


@dataclass
class DecoderCache:
    """The dense serving cache.  ``kv`` is written in place by every
    program; ``length``, the number of valid positions, is a host int, so
    a decode step never reads it back from the device."""

    kv: attn.KVCache
    length: int


def _cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Ring-buffer length: pure sliding-window configs cap the cache at
    the window."""
    if cfg.sliding_window and not cfg.local_global_period:
        return min(max_len, cfg.sliding_window)
    return max_len


def _require_dense_ported(cfg: ModelConfig) -> None:
    ok, why = paged_supported(cfg)
    if not ok:
        raise NotImplementedError(f"dense serving of {cfg.name} is not yet "
                                  f"ported to repro_torch: {why}")


def init_decoder_cache(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device=None) -> DecoderCache:
    """An empty cache of ``_cache_len`` slots (bf16 by default, as the JAX
    package's)."""
    _require_dense_ported(cfg)
    kv = attn.init_kv_cache(cfg.n_layers, batch, _cache_len(cfg, max_len),
                            cfg.n_kv_heads, cfg.hd, dtype, device)
    return DecoderCache(kv=kv, length=0)


def _prefill_positions(S: int, T: int, device=None) -> torch.Tensor:
    """Position tags (T,) int32 after prefilling S tokens into a length-T
    (ring) cache."""
    slots = torch.arange(T, dtype=torch.int32, device=device)
    if S <= T:
        return torch.where(slots < S, slots, -1)
    # ring: slot i holds the latest position congruent to i (mod T)
    last_full = (S - 1) // T * T
    return torch.where(slots <= (S - 1) % T, last_full + slots,
                       last_full - T + slots)


def _fit_cache(arr: torch.Tensor, T: int, S: int) -> torch.Tensor:
    """Fit fresh per-layer K/V (B, S, ...) into a length-T cache buffer."""
    if S <= T:
        return attn.pad_to(arr, T)
    # S > T (ring): keep the last T entries, rolled so slot = pos % T
    return torch.roll(arr[:, S - T:], shifts=S % T, dims=1)


def decoder_prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
                    max_len: int) -> tuple[torch.Tensor, DecoderCache]:
    """Prefill S tokens of a batch -> (last-position logits (B, Vp), the
    populated cache).  The cache holds K/V in the activation dtype, as
    the JAX program's does."""
    _require_dense_ported(cfg)
    B, S = tokens.shape
    T = _cache_len(cfg, max_len)
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None, :]
    x = params["embed"][tokens]
    kv = attn.init_kv_cache(cfg.n_layers, B, T, cfg.n_kv_heads, cfg.hd,
                            x.dtype, dev)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(h, p["attn"], cfg, positions)
        kv.k[i] = _fit_cache(k, T, S)
        kv.v[i] = _fit_cache(v, T, S)
        out = attn.blocked_attention(q, k, v, kv_block=cfg.kv_block)
        x = x + out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
        x = x + mlp_block(rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"])
    # slot i holds absolute position i (the ring matters only once S > T)
    kv.positions.copy_(_prefill_positions(S, T, dev).expand(cfg.n_layers,
                                                            T))
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(params, x)[:, 0], DecoderCache(kv=kv, length=S)


def decoder_decode_step(params, cache: DecoderCache, token: torch.Tensor,
                        cfg: ModelConfig
                        ) -> tuple[torch.Tensor, DecoderCache]:
    """One decode step: token (B,) at position ``cache.length``.  Writes the
    token's K/V into the cache in place and returns (logits (B, Vp), the
    cache one position longer).  Sliding-window and softcap configs (a
    ring cache, per-layer windows) raise until the port's decoder builds
    them; ``attn.decode_attention`` and ``attn.cache_write`` already take
    ring tags, a window and a softcap."""
    _require_dense_ported(cfg)
    B = token.shape[0]
    pos = cache.length
    kv = cache.kv
    positions = torch.full((B, 1), pos, device=token.device)
    x = params["embed"][token][:, None, :]                         # (B, 1, d)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(h, p["attn"], cfg, positions)
        attn.cache_write(kv.k[i], kv.v[i], kv.positions[i], k, v, pos,
                         ring=False)
        out = attn.decode_attention(q[:, 0], kv.k[i], kv.v[i], pos,
                                    cache_positions=kv.positions[i])
        x = x + out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
        x = x + mlp_block(rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x)[:, 0], DecoderCache(kv=kv, length=pos + 1)


# ---------------------------------------------------------------------------
# Paged serving: block-table prefill chunks + batched decode
# ---------------------------------------------------------------------------


def paged_supported(cfg: ModelConfig) -> tuple[bool, str]:
    """Whether the paged serving path can run this config: the plain GQA
    decoder with dense MLPs (partial rotary and QKV bias included)."""
    if cfg.family != "decoder":
        return False, f"family {cfg.family!r} has no paged cache layout"
    if cfg.attn_type == "mla":
        return False, "MLA latent cache not yet paged"
    if cfg.mrope or cfg.vision_tokens:
        return False, "multimodal position handling not paged"
    if cfg.sliding_window or cfg.local_global_period:
        return False, "sliding-window masks not paged"
    if cfg.attn_softcap:
        return False, "logit softcap not fused into the paged kernel"
    if cfg.moe is not None:
        return False, "MoE layers not yet ported"
    if cfg.tie_embeddings or cfg.emb_scale:
        return False, "tied or scaled embeddings not yet ported"
    return True, ""


def _paged_scatter(kp, vp, k_new, v_new, blk, off) -> None:
    """Write per-token K/V into pool blocks, in place.

    kp/vp: (nb, bs, Hkv, hd); k_new/v_new: (N, Hkv, hd); blk/off: (N,)
    int64.  Duplicate (blk, off) pairs occur only for tokens aimed at the
    null block 0 (dead decode lanes, prefill pad tokens past the table);
    on CUDA which duplicate lands is unspecified, which is harmless only
    because block 0 is never read unmasked.
    """
    kp[blk, off] = k_new.to(kp.dtype)
    vp[blk, off] = v_new.to(vp.dtype)


def decoder_prefill_chunk_paged(params, pool: attn.PagedKV,
                                tokens: torch.Tensor, table: torch.Tensor,
                                ctx_len: int, cfg: ModelConfig
                                ) -> torch.Tensor:
    """Prefill one chunk of one prompt into the paged pool (in place).

    tokens: (1, c) int — the engine pads the last chunk to ``c``; table:
    (W,) int32, the request's block table padded with the null block;
    ``ctx_len``: tokens already prefilled.  Returns logits (1, c, Vp) over
    the whole chunk, so the host can read the last real prompt position of
    a padded final chunk.

    Attending over the whole gathered table is correct: gathered slot i
    holds absolute position i for every live slot, and every garbage slot
    (null-block padding, stale pool contents past the chunk's end) sits at
    a position past the last query, so the causal mask with
    ``q_offset=ctx_len`` removes it.  Writes need one guard the mask cannot
    give: a padded final chunk can run past the table (ceil(P/c)*c > W*bs),
    and those pad tokens are routed to the null block explicitly.
    """
    c = tokens.shape[1]
    W = table.shape[0]
    bs = pool.block_size
    dev = tokens.device
    p_abs = ctx_len + torch.arange(c, device=dev)                # (c,)
    word = p_abs // bs
    tbl = table.long()
    blk = torch.where(word < W, tbl[word.clamp(max=W - 1)],
                      torch.zeros_like(word))
    off = p_abs % bs
    positions = p_abs[None, :]                                   # (1, c)
    x = params["embed"][tokens]                                   # (1, c, d)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        kp, vp = pool.k[i], pool.v[i]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(h, p["attn"], cfg, positions)
        _paged_scatter(kp, vp, k[0], v[0], blk, off)
        kg = kp[tbl].reshape(1, W * bs, cfg.n_kv_heads, cfg.hd)
        vg = vp[tbl].reshape(1, W * bs, cfg.n_kv_heads, cfg.hd)
        # one KV block over the whole gathered table: the JAX program uses
        # kv_block=bs; only the summation order differs
        out = attn.blocked_attention(q, kg, vg, q_offset=ctx_len,
                                     kv_block=W * bs)
        x = x + out.reshape(1, c, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
        x = x + mlp_block(rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x)


def decoder_decode_step_paged(params, pool: attn.PagedKV,
                              token: torch.Tensor, lengths: torch.Tensor,
                              tables: torch.Tensor, live: torch.Tensor,
                              cfg: ModelConfig) -> torch.Tensor:
    """One decode wave over a batch of paged sequences (pool in place).

    token: (B,) int last sampled tokens; lengths: (B,) int32 tokens already
    in each sequence's cache (the new token's position); tables: (B, W)
    int32 block tables padded with the null block; live: (B,) bool — dead
    lanes write to the null block and attend over zero keys, so their
    attention output is exactly zero.  Returns logits (B, Vp).
    """
    B = token.shape[0]
    W = tables.shape[1]
    bs = pool.block_size
    dev = token.device
    lengths = lengths.int()
    word = (lengths // bs).long()
    # a lane past its table (the engine never sends one) writes to the null
    # block rather than aliasing table[W-1]; the kernel then outputs NaN
    # for it, since its length exceeds W*bs
    blk = torch.where(live & (word < W), tables.long()[
        torch.arange(B, device=dev), word.clamp(max=W - 1)], 0)
    off = torch.where(live, lengths % bs, 0).long()
    attend = torch.where(live, lengths + 1, 0).int()               # (B,)
    positions = lengths[:, None]                                   # (B, 1)
    x = params["embed"][token][:, None, :]                         # (B, 1, d)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        kp, vp = pool.k[i], pool.v[i]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(h, p["attn"], cfg, positions)
        _paged_scatter(kp, vp, k[:, 0], v[:, 0], blk, off)
        out = kernel_ops.paged_attention(q[:, 0].contiguous(), kp, vp,
                                         tables, attend)
        x = x + out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
        x = x + mlp_block(rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x)[:, 0]
