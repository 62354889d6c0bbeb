"""Attention for the serving slice: blocked online-softmax prefill
attention and the paged KV pool.

Counterpart of ``repro.models.attention``.  ``blocked_attention`` is plain
PyTorch (it is not a Pallas kernel in the JAX package either): the same
online softmax over KV blocks with fp32 statistics, written with plain
tensor ops rather than a library attention call.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

NEG_INF = -1e30


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: int = 0, kv_block: int = 1024
                      ) -> torch.Tensor:
    """Causal online-softmax attention over KV blocks; returns
    (B, S, Hq, vd).

    q: (B, S, Hq, hd); k: (B, T, Hkv, hd); v: (B, T, Hkv, vd).  GQA folds
    query heads into (Hkv, G) so K/V are never repeated; query head
    ``h*G + g`` belongs to KV head ``h``.  ``q_offset`` is the absolute
    position of q[0] (prefill continuation).  Logits and softmax
    statistics are fp32; as in the JAX package the probabilities are
    rounded to v's dtype before the PV product.  The whole query length is
    one block (the paged prefill's only caller passes one chunk).
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
        k_pos = torch.arange(t0, t0 + kv_block, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]                    # (S, bk)
        logits = torch.where(mask, logits, NEG_INF)
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
