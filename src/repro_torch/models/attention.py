"""Attention for serving and training: blocked online-softmax attention
(causal or not, with an optional sliding window and logit softcap),
single-token decode against a dense (possibly ring-buffered) KV cache,
the paged KV pool, and MLA (multi-head latent attention: the latent
cache, its prefill and its absorbed decode).

Counterpart of ``repro.models.attention``.  ``blocked_attention``,
``decode_attention`` and the MLA functions are plain PyTorch (none is a
Pallas kernel in the JAX package either): the same fp32 logits and
softmax statistics, written with plain tensor ops rather than a library
attention call.  The dense caches are written in place (the JAX helpers
return new arrays).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

NEG_INF = -1e30


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      softcap: float = 0.0, q_offset: int = 0,
                      kv_block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks; returns (B, S, Hq, vd).

    q: (B, S, Hq, hd); k: (B, T, Hkv, hd); v: (B, T, Hkv, vd).  GQA folds
    query heads into (Hkv, G) so K/V are never repeated; query head
    ``h*G + g`` belongs to KV head ``h``.  ``causal`` keeps keys with
    ``k_pos <= q_pos``; without it (the encoder's self-attention, and
    cross-attention, where T may differ from S) only the window, if any,
    masks.  ``q_offset`` is the absolute
    position of q[0] (prefill continuation).  ``window`` (None = full)
    keeps keys with ``k_pos > q_pos - window``, the JAX package's
    arithmetic mask (gemma2's global layers pass ``1 << 30``); ``softcap``
    caps the scaled logits, ``cap * tanh(logits / cap)``, before the
    mask.  Logits and softmax
    statistics are fp32; as in the JAX package the probabilities are
    rounded to v's dtype before the PV product.  The whole query length is
    one block: the (B, Hkv, G, S, kv_block) fp32 logits of one KV block
    are the largest tensor it makes.
    """
    B, S, Hq, hd = q.shape
    _, T, Hkv, _ = k.shape
    vd = v.shape[-1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    kv_block = min(kv_block, T)
    if T % kv_block:
        raise ValueError(f"sequence {T} not divisible by block {kv_block}")

    qg = q.reshape(B, S, Hkv, G, hd).float()
    q_pos = torch.arange(S, device=q.device) + q_offset            # (S,)
    m = torch.full((B, Hkv, G, S), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, S), device=q.device)
    o = torch.zeros((B, Hkv, G, S, vd), device=q.device)
    for t0 in range(0, T, kv_block):
        kj = k[:, t0:t0 + kv_block].float()
        vj = v[:, t0:t0 + kv_block]
        logits = torch.einsum("bqkgh,bskh->bkgqs", qg, kj) * scale
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        if causal or window is not None:
            k_pos = torch.arange(t0, t0 + kv_block, device=q.device)
            keep = k_pos[None, :] <= q_pos[:, None] if causal else True
            if window is not None:                                 # (S, bk)
                keep = keep & (k_pos[None, :] > q_pos[:, None] - window)
            logits = torch.where(keep, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vj.dtype).float(),
                          vj.float())
        o = o * corr[..., None] + pv
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]                        # (B,Hkv,G,S,vd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, vd).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode (one new token against a dense cache)
# ---------------------------------------------------------------------------


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     cache_positions: torch.Tensor | None = None,
                     window: int | None = None,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-step attention; returns (B, Hq, vd).

    q: (B, Hq, hd), the new token's queries; k_cache: (B, T, Hkv, hd);
    v_cache: (B, T, Hkv, vd); ``pos``: the new token's absolute position.
    With ``cache_positions`` (T,) the cache is a ring buffer whose slot i
    holds absolute position cache_positions[i] (-1 = empty); otherwise
    slot i holds position i and is valid for i <= pos.  Logits and the
    softmax are fp32; the weights are rounded to v's dtype before the PV
    product, as in the JAX package.
    """
    B, T, Hkv, hd = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    vd = v_cache.shape[-1]
    scale = 1.0 / math.sqrt(hd)

    qg = q.reshape(B, Hkv, G, hd).float()
    logits = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    kp = (cache_positions if cache_positions is not None
          else torch.arange(T, device=q.device))
    valid = (kp >= 0) & (kp <= pos)
    if window is not None:
        valid &= kp > (pos - window)
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Hq, vd).to(q.dtype)


def pad_to(arr: torch.Tensor, T: int) -> torch.Tensor:
    """Pad the sequence axis (axis 1) of (B, S, ...) with zeros out to
    length T."""
    S = arr.shape[1]
    if S == T:
        return arr
    pad = arr.new_zeros((arr.shape[0], T - S) + tuple(arr.shape[2:]))
    return torch.cat([arr, pad], dim=1)


@dataclass
class KVCache:
    """Per-layer-stacked dense KV cache for GQA decoders.

    k, v: (L, B, T, Hkv, hd).  ``positions`` (L, T) int32 tags each slot's
    absolute position (-1 = empty; ring buffers for sliding-window layers
    reuse slots).  RoPE is applied at write time, so ring order is
    harmless.
    """

    k: torch.Tensor
    v: torch.Tensor
    positions: torch.Tensor


def init_kv_cache(n_layers: int, batch: int, max_len: int, n_kv: int,
                  hd: int, dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (n_layers, batch, max_len, n_kv, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        positions=torch.full((n_layers, max_len), -1, dtype=torch.int32,
                             device=device))


def cache_write(k_layer: torch.Tensor, v_layer: torch.Tensor,
                pos_layer: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, pos: int, ring: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write one token's K/V into a layer cache at ``pos`` (ring: pos % T),
    in place; returns the three (same) tensors.

    k_layer: (B, T, Hkv, hd); k_new: (B, 1, Hkv, hd); pos: host int.  A
    position past a non-ring cache lands in its last slot, as XLA's
    clamped ``dynamic_update_slice`` puts it there.
    """
    T = k_layer.shape[1]
    slot = pos % T if ring else min(pos, T - 1)
    k_layer[:, slot] = k_new[:, 0].to(k_layer.dtype)
    v_layer[:, slot] = v_new[:, 0].to(v_layer.dtype)
    pos_layer[slot] = pos
    return k_layer, v_layer, pos_layer


# ---------------------------------------------------------------------------
# Paged KV (block-table serving cache)
# ---------------------------------------------------------------------------


@dataclass
class PagedKV:
    """Global block-pool KV cache for the paged serving engine.

    k, v: (L, num_blocks, block_size, Hkv, hd).  There is no batch axis:
    every live sequence's tokens are scattered into pool blocks and
    addressed through a per-request block table (host side, see
    :class:`repro_torch.serve.kv_cache.BlockAllocator`).  Block 0 is the
    NULL block: padded table entries and dead decode lanes write/read
    there, and length masks keep it out of every softmax.  Unlike the JAX
    package's immutable pool, the port writes into these tensors in place.
    """

    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[2]


def init_paged_kv(n_layers: int, num_blocks: int, block_size: int,
                  n_kv: int, hd: int, dtype=torch.bfloat16,
                  device=None) -> PagedKV:
    """num_blocks INCLUDES the reserved null block 0."""
    shape = (n_layers, num_blocks, block_size, n_kv, hd)
    return PagedKV(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention): MiniCPM3 / DeepSeek-V2 style
# ---------------------------------------------------------------------------


@dataclass
class MLACache:
    """The compressed cache: the latent c_kv and the shared rope keys,
    (kv_rank + rope_dim) values per token instead of 2 * Hkv * hd.

    c_kv: (L, B, T, kv_rank); k_rope: (L, B, T, rope_dim).  Slot i holds
    position i."""

    c_kv: torch.Tensor
    k_rope: torch.Tensor


def init_mla_cache(n_layers: int, batch: int, max_len: int, kv_rank: int,
                   rope_dim: int, dtype=torch.bfloat16,
                   device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((n_layers, batch, max_len, kv_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((n_layers, batch, max_len, rope_dim),
                           dtype=dtype, device=device))


def mla_prefill_attention(q_nope, q_rope, c_kv, k_rope, w_uk, w_uv, *,
                          softcap: float = 0.0,
                          kv_block: int = 1024) -> torch.Tensor:
    """Prefill MLA: expand the latent into per-head K and V, then causal
    :func:`blocked_attention` -> (B, S, H, dv).

    q_nope: (B, S, H, dn); q_rope: (B, S, H, dr); c_kv: (B, T, kvr);
    k_rope: (B, T, dr) (one rope key shared by every head); w_uk:
    (kvr, H, dn); w_uv: (kvr, H, dv)."""
    B, T = c_kv.shape[:2]
    H = q_nope.shape[2]
    k_nope = torch.einsum("btc,chd->bthd", c_kv, w_uk)           # (B,T,H,dn)
    val = torch.einsum("btc,chd->bthd", c_kv, w_uv)              # (B,T,H,dv)
    k_rope_h = k_rope[:, :, None, :].expand(B, T, H, k_rope.shape[-1])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    return blocked_attention(q, k, val, softcap=softcap, kv_block=kv_block)


def mla_decode_attention(q_nope, q_rope, c_cache, kr_cache, w_uk, w_uv,
                         pos: int, *, softcap: float = 0.0) -> torch.Tensor:
    """Absorbed-matmul MLA decode -> (B, H, dv), in w_uv's dtype.

    Scores and values are formed in the latent space,
        score  = (q_nope W_uk)^T c + q_rope^T k_rope,
        out_h  = (softmax(score) c) W_uv[h],
    scaled by 1/sqrt(dn + dr), so each step reads kv_rank + rope_dim
    values a cached token.  Slots past ``pos`` are masked.

    q_nope: (B, H, dn); q_rope: (B, H, dr); c_cache: (B, T, kvr);
    kr_cache: (B, T, dr)."""
    dn, dr = q_nope.shape[-1], q_rope.shape[-1]
    T = c_cache.shape[1]
    scale = 1.0 / math.sqrt(dn + dr)
    q_lat = torch.einsum("bhd,chd->bhc", q_nope, w_uk)           # (B,H,kvr)
    s_lat = torch.einsum("bhc,btc->bht", q_lat.float(), c_cache.float())
    s_rope = torch.einsum("bhr,btr->bht", q_rope.float(), kr_cache.float())
    logits = (s_lat + s_rope) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    valid = torch.arange(T, device=c_cache.device) <= pos
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bht,btc->bhc", w.to(c_cache.dtype).float(),
                       c_cache.float())                           # (B,H,kvr)
    return torch.einsum("bhc,chd->bhd", ctx.to(w_uv.dtype), w_uv)
