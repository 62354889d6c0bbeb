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
batch shape.  The oracles of the kernels not on a ported path
(``tangent_gram``, ``adam_lowrank`` alone) come with their kernels.
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
