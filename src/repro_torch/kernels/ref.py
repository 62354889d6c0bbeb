"""Plain-PyTorch oracles for the port's hand-written kernels.

These are the semantics contract: the CPU tests hold them against the
JAX package's oracles (``repro.kernels.ref``) on the same inputs, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  On a
CPU tensor the dispatch in :mod:`repro_torch.kernels.ops` runs them; a
CUDA tensor never takes them.

Only the serving slice's oracle is here so far; the other oracles of
``repro.kernels.ref`` come with their kernels.
"""

from __future__ import annotations

import math

import torch


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Paged-attention decode oracle: gather K/V through the block table
    and run a masked single-token softmax.

    q: (B, Hq, hd) — one query token per sequence; k_pool/v_pool:
    (nb, bs, Hkv, hd) global block pools; block_tables: (B, W) int32
    (null block 0 pads unused entries); lengths: (B,) int32 — number of
    valid gathered positions per sequence (position i of the gathered
    sequence lives in table word i // bs at offset i % bs).  Query head
    ``h*G + g`` belongs to KV head ``h`` (G = Hq // Hkv).

    -> (B, Hq, hd) in q's dtype.  The softmax is the explicit masked form
    so a fully-masked lane (lengths[b] == 0) returns exactly zero instead
    of a uniform average over garbage.
    """
    B, Hq, hd = q.shape
    bs, Hkv = k_pool.shape[1], k_pool.shape[2]
    G = Hq // Hkv
    W = block_tables.shape[1]
    scale = 1.0 / math.sqrt(hd)
    tables = block_tables.long()
    qg = q.reshape(B, Hkv, G, hd).float()
    # (B, W, bs, Hkv, hd) -> (B, W*bs, Hkv, hd)
    kg = k_pool[tables].reshape(B, W * bs, Hkv, hd).float()
    vg = v_pool[tables].reshape(B, W * bs, Hkv, hd).float()
    logits = torch.einsum("bkgh,btkh->bkgt", qg, kg) * scale
    pos = torch.arange(W * bs, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]         # (B, T)
    logits = logits.masked_fill(~valid[:, None, None, :], -math.inf)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # dead lane
    p = torch.exp(logits - m)
    num = torch.einsum("bkgt,btkh->bkgh", p, vg)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (num / den).reshape(B, Hq, hd).to(q.dtype)
