"""Shared building blocks: RMS norm, rotary embeddings, initializers and
the loss.

Counterpart of ``repro.models.common`` (the decoder's part of it; the
grad-fused ``tapped_matmul`` comes with its kernel).
Parameters are plain nested dicts of tensors, with the layer stack on a
leading axis as in the JAX package, and weights stored ``(in, out)`` for
``x @ w``.  Random init draws from an explicit ``torch.Generator`` where
the JAX code takes a key; the two give different numbers from one seed,
so the tests copy the JAX parameters over (:mod:`repro_torch.interop`).
"""

from __future__ import annotations

import math

import torch


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Truncated-normal fan-in init (LLaMA-style 1/sqrt(fan_in)), drawn in
    fp32 on the generator's device."""
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype=torch.bfloat16) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    w.normal_(0.0, 1.0, generator=gen)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """fp32 statistics; the learned scale enters as ``1 + scale`` over a
    zero-initialised weight, as in the JAX package."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,) fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Standard RoPE over split halves (not interleaved pairs).
    x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                        # (hd/2,)
    angles = positions[..., None].float() * inv                  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  vocab_size: int | None = None) -> torch.Tensor:
    """Token-mean cross entropy, fp32 statistics, vocab-padding-safe: the
    padded logit columns are masked to -1e30 so the logsumexp is exact."""
    logits = logits.float()
    vp = logits.shape[-1]
    if vocab_size is not None and vocab_size < vp:
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - label_logit
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def shift_labels(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token targets aligned with the full sequence: (labels, mask),
    the last position masked."""
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:]),
                      torch.zeros_like(tokens[:, :1])], dim=1)
    return labels, mask
