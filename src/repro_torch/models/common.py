"""Shared building blocks: RMS norm, softcap and GELU, rotary embeddings
(standard and M-RoPE), initializers and the loss.

Counterpart of ``repro.models.common`` (the decoder's part of it, and
the grad-fused ``tapped_matmul``).
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
    fp32 on the generator's device and scaled in place (one fp32
    transient the size of the leaf)."""
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype=torch.bfloat16) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    w.normal_(0.0, 1.0, generator=gen)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Grad-fused matmul tap
# ---------------------------------------------------------------------------
#
# ``tapped_matmul(x, w, s, seed)`` is exactly ``x @ w`` forward.  Its
# backward forms the weight gradient through the grad_tap epilogue
# (repro_torch.kernels.ops), which also emits A = S^T dW and the per-column
# ||dW||^2, and returns them as the gradient of ``seed``: a zero
# (r+1, n) fp32 tensor whose true gradient is zero.  One
# ``torch.autograd.grad`` over (params, seeds) thus returns the taps beside
# the gradients, and the optimizer's plain step consumes them instead of
# projecting the full-width gradient again.  Without a tap the call sites
# run the plain ``x @ w``.


def tap_seed(rank: int, n: int, stack: tuple = (),
             device=None) -> torch.Tensor:
    """The zero (*stack, rank+1, n) fp32 seed whose gradient carries the
    tap: rows [0:rank] are A = S^T G, row rank the per-column ||G||^2, in
    the leaf's canonical orientation.  An expanded scalar, so a stacked
    seed holds no memory; only its gradient does."""
    return torch.zeros((), dtype=torch.float32, device=device).expand(
        tuple(stack) + (rank + 1, n))


class _TappedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, s, seed):
        ctx.save_for_backward(x, w, s)
        return x @ w

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.kernels import ops  # kernels -> models stays acyclic

        x, w, s = ctx.saved_tensors
        dx = dy @ w.mT if ctx.needs_input_grad[0] else None
        x2 = x.reshape(-1, x.shape[-1])
        dy2 = dy.reshape(-1, dy.shape[-1])
        if s.shape[0] == w.shape[0]:
            # canonical orientation: G = dW (a, b)
            dw, tap = ops.grad_tap(x2, dy2, s, out_dtype=w.dtype)
        else:
            # transposed plan: G = dW^T (b, a).  Swap the operands so the
            # epilogue streams the canonical orientation, and store dW^T
            # into the leaf's own (a, b) memory
            dwT, tap = ops.grad_tap(dy2, x2, s, out_dtype=w.dtype,
                                    transposed_out=True)
            dw = dwT.mT
        return dx, dw, None, tap


def tapped_matmul(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                  seed: torch.Tensor) -> torch.Tensor:
    """``x @ w`` whose backward also emits the SubTrack projection tap.

    x: (..., a); w: (a, b); s: the leaf's (m, r) basis in canonical
    orientation (``s.shape[0]`` tells whether dW or dW^T is projected);
    seed: ``tap_seed(r, n)``.  dW reaches autograd in w's dtype; A and
    the norms come from the fp32 dW before that rounding."""
    return _TappedMatmul.apply(x, w, s, seed)


def maybe_tapped_matmul(x: torch.Tensor, w: torch.Tensor,
                        tap) -> torch.Tensor:
    """``x @ w``, grad-fused when ``tap`` is an (s, seed) pair, the plain
    product when it is None."""
    if tap is None:
        return x @ w
    s, seed = tap
    return tapped_matmul(x, w, s, seed)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """fp32 statistics; the learned scale enters as ``1 + scale`` over a
    zero-initialised weight, as in the JAX package."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap) in fp32, cast back
    to x's dtype; the identity when ``cap`` is 0."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU, as ``jax.nn.gelu``'s default."""
    return torch.nn.functional.gelu(x, approximate="tanh")


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE over 3-D (t, h, w) position ids.

    x: (..., S, H, hd); positions: (..., 3, S).  The hd/2 frequency slots
    are split into ``sections``, each rotated by its own position stream;
    text tokens carry t = h = w, which is standard RoPE."""
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    inv = rope_freqs(hd, theta, x.device)                        # (half,)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        pos_i = positions[..., i, :]                              # (..., S)
        parts.append(pos_i[..., None].float() * inv[start:start + sec])
        start += sec
    angles = torch.cat(parts, dim=-1)                             # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
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
