"""Plain-PyTorch oracles for the port's hand-written kernels.

These are the semantics contract: the CPU tests hold them against the
JAX package's oracles (``repro.kernels.ref``) on the same inputs, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  On a
CPU tensor the dispatch in :mod:`repro_torch.kernels.ops` runs them; a
CUDA tensor never takes them.

Every optimizer oracle takes an optional leading batch dim (one matrix
per leading index, as the kernels' grid z), casts each operand to fp32
and follows the JAX oracle's order of operations.  Per-matrix scalars
(``coef``, ``clip``, ``wd_coef``) are Python floats or tensors of the
batch shape.
"""

from __future__ import annotations

import math

import torch


def _per_matrix(x, trailing: int):
    """A per-matrix scalar (float, 0-d or batch-shaped tensor) shaped to
    broadcast against ``trailing`` more dims."""
    if torch.is_tensor(x) and x.dim():
        return x.reshape(x.shape + (1,) * trailing)
    return x


def project_ref(S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """A = S^T G.  S: (..., m, r); G: (..., m, n) any float -> (..., r, n)."""
    return S.float().mT @ G.float()


SPLIT_R_PAD = 64    # the split's r pads to a multiple of this (wgmma's M)


def split3_ref(x: torch.Tensor) -> torch.Tensor:
    """x fp32 as three bf16 terms x = hi + mid + lo, each the
    round-to-nearest bf16 of what the terms before it left, stacked on a
    new dim -3 -> (..., 3, a, b).  Three 8-bit significands hold fp32's 24,
    so the terms add back to x exactly (for x in bf16's normal range; a lo
    term below it loses at most 2^-133 absolute): the tensor cores' operand
    for an fp32 factor."""
    x = x.float()
    hi = x.bfloat16()
    rest = x - hi.float()
    mid = rest.bfloat16()
    lo = (rest - mid.float()).bfloat16()
    return torch.stack([hi, mid, lo], dim=-3)


def split_bf16_ref(S: torch.Tensor) -> torch.Tensor:
    """S (..., m, r) fp32 split by ``split3_ref`` -> (..., 3, m, r_pad)
    with r padded to a multiple of ``SPLIT_R_PAD`` by zeros: the bf16
    projection's and fused update's operand."""
    m, r = S.shape[-2:]
    r_pad = -(-r // SPLIT_R_PAD) * SPLIT_R_PAD
    return split3_ref(torch.nn.functional.pad(S.float(), (0, r_pad - r)))


def split_direction_ref(Gto: torch.Tensor, Gt, phi, clip) -> torch.Tensor:
    """The fused update's right factor D = Gto - (phi * clip) Gt (Gto
    alone when Gt is None), each operation rounded in fp32, split by
    ``split3_ref`` -> (..., 3, r, n)."""
    D = Gto.float()
    if Gt is not None:
        phic = phi.float() * _per_matrix(clip, 1)
        D = D - phic[..., None, :] * Gt.float()
    return split3_ref(D)


# The term products (A term, B term) the fused update sums, smallest first
# (0 hi, 1 mid, 2 lo): the 6 of 9 whose order is >= 2^-16 of |S||D|.
UPDATE_PASSES = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def split_matmul_ref(A: torch.Tensor, B: torch.Tensor,
                     passes=UPDATE_PASSES, k_tile: int = 64) -> torch.Tensor:
    """The tensor cores' arithmetic for A (..., M, K) @ B (..., K, N), both
    fp32: each split in three bf16 terms, and per ``k_tile``-deep slice of K
    the products of the term pairs in ``passes`` (each exact in fp32)
    summed in fp32 into a fresh partial, which is then added into an fp32
    total.  An emulation for the accuracy argument: the kernel sums inside
    a slice in the tensor cores' order, not in this one."""
    a, b = split3_ref(A).float(), split3_ref(B).float()
    K = A.shape[-1]
    total = torch.zeros(A.shape[:-1] + B.shape[-1:], dtype=torch.float32)
    for k0 in range(0, K, k_tile):
        part = sum(a[..., i, :, k0:k0 + k_tile] @ b[..., j, k0:k0 + k_tile, :]
                   for i, j in passes)
        total = total + part
    return total


def backproject_ref(S: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """S @ X.  S: (..., m, r); X: (..., r, n) -> (..., m, n) fp32."""
    return S.float() @ X.float()


def recovery_ref(G: torch.Tensor, S: torch.Tensor, Gt: torch.Tensor,
                 phi: torch.Tensor) -> torch.Tensor:
    """Recovery-scaled residual Lam = (G - S Gt) * phi[..., None, :].
    G: (..., m, n); S: (..., m, r); Gt: (..., r, n); phi: (..., n)."""
    resid = G.float() - S.float() @ Gt.float()
    return resid * phi.float()[..., None, :]


def tangent_ref(G: torch.Tensor, A: torch.Tensor,
                S: torch.Tensor) -> torch.Tensor:
    """Grassmann tangent T = -2 G A^T + 2 S (A A^T) -> (..., m, r)."""
    G, A, S = G.float(), A.float(), S.float()
    return -2.0 * (G @ A.mT) + 2.0 * (S @ (A @ A.mT))


def project_colnorms_ref(S: torch.Tensor, G: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(A = S^T G, per-column ||G_:,j||^2) -> ((..., r, n), (..., n))."""
    G32 = G.float()
    return S.float().mT @ G32, (G32 * G32).sum(dim=-2)


def project_tangent_colnorms_ref(S: torch.Tensor, G: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Tracking-step front end: (A, ||G_:,j||^2, T) from one logical pass
    over G, T = -2 G A^T + 2 S (A A^T).  The kernel forms S (S^T W) with
    W = G A^T, equal to S (A A^T) up to the order of its sums."""
    A, gsq = project_colnorms_ref(S, G)
    return A, gsq, tangent_ref(G, A, S)


def tangent_gram_ref(S: torch.Tensor, T: torch.Tensor, G: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The gram schedule's sums over rows, all fp32:

        TtG = T^T G  (..., r, n)    u^T G = v^T TtG / sigma
        StT = S^T T  (..., r, r)    the stabiliser's in-subspace part
        C   = T^T T  (..., r, r)    the tangent Gram (top-1 triple)
        StS = S^T S  (..., r, r)    the orthonormality correction

    S, T: (..., m, r) fp32; G: (..., m, n) any float."""
    S32, T32 = S.float(), T.float()
    return T32.mT @ G.float(), S32.mT @ T32, T32.mT @ T32, S32.mT @ S32


def fused_update_ref(G, S, Gt, Gto, phi, coef, clip, *, out_dtype=None,
                     param=None, wd_coef=None) -> torch.Tensor:
    """upd = -coef * (S Gto + (G - S Gt) * phi * clip) [- wd_coef * param]
    in ``out_dtype``; ``G=None`` is the no-recovery variant
    ``-coef * S Gto``."""
    S32 = S.float()
    acc = S32 @ Gto.float()
    if G is not None:
        resid = G.float() - S32 @ Gt.float()
        acc = acc + resid * (phi.float() * _per_matrix(clip, 1))[..., None, :]
    upd = -_per_matrix(coef, 2) * acc
    if param is not None:
        upd = upd - _per_matrix(wd_coef, 2) * param.float()
    return upd.to(out_dtype or torch.float32)


def grad_tap_ref(x: torch.Tensor, dy: torch.Tensor, S: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grad-fused backward epilogue: the weight gradient and the
    plain step's projection statistics of it, all fp32.

        dW  = x^T dy            (..., m, n)
        A   = S^T dW            (..., r, n)
        gsq = sum_i dW[i, :]^2  (..., n)

    x: (..., b, m); dy: (..., b, n); S: (..., m, r)."""
    dW = x.float().mT @ dy.float()
    return dW, S.float().mT @ dW, (dW * dW).sum(dim=-2)


def adam_lowrank_ref(Gt, M, V, step, beta1: float, beta2: float, eps: float,
                     bias_correction: bool = True):
    """Low-rank Adam moments + direction -> (M', V', Gto), all fp32.
    ``step`` is the 0-based count; bias correction uses t = step + 1 in
    fp32."""
    Gt = Gt.float()
    M1 = beta1 * M + (1 - beta1) * Gt
    V1 = beta2 * V + (1 - beta2) * Gt * Gt
    if bias_correction:
        t = torch.as_tensor(step, dtype=torch.float32) + 1.0
        mh = M1 / (1.0 - beta1 ** t)
        vh = V1 / (1.0 - beta2 ** t)
    else:
        mh, vh = M1, V1
    return M1, V1, mh / (torch.sqrt(vh) + eps)


def adam_lowrank_norms_ref(Gt, M, V, step, beta1: float, beta2: float,
                           eps: float, bias_correction: bool = True):
    """``adam_lowrank_ref`` plus ||Gt_:,j||^2 and ||Gto_:,j||^2 ->
    (M', V', Gto, gt_sq (..., n), gto_sq (..., n))."""
    M1, V1, Gto = adam_lowrank_ref(Gt, M, V, step, beta1, beta2, eps,
                                   bias_correction)
    Gt32 = Gt.float()
    return (M1, V1, Gto, (Gt32 * Gt32).sum(dim=-2),
            (Gto * Gto).sum(dim=-2))


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


FLASH_MASKED = -1e30    # a masked logit, as the TPU kernel writes it


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Attention with the TPU flash kernel's semantics
    (``repro/kernels/flash_attention.py``), all in fp32.

    q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd); query head h reads KV head
    h // (Hq // Hkv).  logits = q.k / sqrt(hd), then ``softcap *
    tanh(logits / softcap)`` when softcap != 0, then the masks, with query
    and key positions both counted from 0 (top-left aligned when S != T):
    causal keeps k <= q, window > 0 keeps k > q - window.  A masked logit
    is -1e30, not -inf, so a row no key may see averages all T values, as
    the kernel's online softmax (started at -1e30) does.  P stays fp32
    for the P V product (the JAX ``blocked_attention`` rounds it to v's
    dtype; the kernel does not).  -> (B, S, Hq, hd) in q's dtype.  Query
    rows go in chunks, so the (S, T) logits never exist whole."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().transpose(1, 2)                               # (B, Hq, S, hd)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)   # (B, Hq, T, hd)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    out = torch.empty((B, Hq, S, hd), dtype=torch.float32, device=q.device)
    k_pos = torch.arange(T, device=q.device)
    chunk = max(1, (1 << 26) // max(1, B * Hq * T))
    for s0 in range(0, S, chunk):
        logits = (qf[:, :, s0:s0 + chunk] @ kf.mT) * scale
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        q_pos = torch.arange(s0, s0 + logits.shape[2], device=q.device)[:, None]
        mask = torch.ones_like(logits[0, 0], dtype=torch.bool)
        if causal:
            mask &= k_pos <= q_pos
        if window:
            mask &= k_pos > q_pos - window
        logits = torch.where(mask, logits, FLASH_MASKED)
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        out[:, :, s0:s0 + chunk] = (
            (p @ vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    return out.transpose(1, 2).to(q.dtype)


FLASH_P_TERMS = 2       # bf16 terms of P in the bf16 route's P V
FLASH_BK = 64           # keys per tile of the bf16 route


def flash_tanh_ref(x: torch.Tensor) -> torch.Tensor:
    """tanh as the bf16 flash route forms it: (e^2x - 1) / (e^2x + 1) in
    fp32, x clamped to [-10, 10] (tanh is 1 in fp32 beyond)."""
    t = torch.exp2(x.float().clamp(-10.0, 10.0) * (2.0 / math.log(2.0)))
    return (t - 1.0) / (t + 1.0)


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0,
                              terms: int = FLASH_P_TERMS,
                              rows=None) -> torch.Tensor:
    """The bf16 route's arithmetic (``csrc/flash_attention.cu``), on the
    CPU, for the accuracy argument: logits from q and k as given (the
    kernel's bf16 products are exact in fp32), scaled into the log2 domain
    (the softcap's tanh as the kernel forms it, ``flash_tanh_ref``),
    masked to -1e30 (-inf past T); per
    ``FLASH_BK``-key tile an online softmax (running max, ``exp2``
    corrections, fp32 running sum) and O = O corr + sum of P's ``terms``
    bf16 terms (each the round-to-nearest bf16 of what the terms before it
    left, the smallest added first) times V, each product exact in fp32.
    Tiles the kernel skips change nothing here (a fully masked tile adds
    exactly 0 to a row that has seen a key, and a row that has not is
    reset by its first visible key's correction), so every tile is visited.
    ``rows`` (an index tensor) restricts the query rows computed; rows are
    independent.  -> (B, S or len(rows), Hq, hd) fp32, before the output's
    rounding to q's dtype."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    log2e = 1.0 / math.log(2.0)
    scale = 1.0 / math.sqrt(hd)
    q_pos = torch.arange(S) if rows is None else torch.as_tensor(rows)
    qf = q.float()[:, q_pos].transpose(1, 2)                     # (B, Hq, R, hd)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)   # (B, Hq, T, hd)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    R = q_pos.numel()
    m = torch.full((B, Hq, R, 1), FLASH_MASKED)
    l = torch.zeros((B, Hq, R, 1))
    o = torch.zeros((B, Hq, R, hd))
    for k0 in range(0, T, FLASH_BK):
        s = qf @ kf[:, :, k0:k0 + FLASH_BK].mT
        if softcap:
            s = flash_tanh_ref(s * (scale / softcap)) * (softcap * log2e)
        else:
            s = s * (scale * log2e)
        k_pos = torch.arange(k0, min(k0 + FLASH_BK, T))[None]
        mask = torch.ones(s.shape[-2:], dtype=torch.bool)
        if causal:
            mask &= k_pos <= q_pos[:, None]
        if window:
            mask &= k_pos > q_pos[:, None] - window
        s = torch.where(mask, s, FLASH_MASKED)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        parts, rest = [], p
        for _ in range(terms):
            parts.append(rest.bfloat16().float())
            rest = rest - parts[-1]
        o = o * corr
        for part in reversed(parts):
            o = o + part @ vf[:, :, k0:k0 + FLASH_BK]
        m = m_new
    return (o / l.clamp_min(1e-30)).transpose(1, 2)
