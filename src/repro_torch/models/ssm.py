"""Mamba2 (State Space Duality) blocks: the backbone of zamba2-7b.

Counterpart of ``repro.models.ssm``, function for function.  The
chunkwise-parallel SSD algorithm (Dao & Gu, 2024): within a chunk the
recurrence is a masked attention-like contraction, across chunks a loop
over the S/Q chunks carries the fp32 (B, H, P, N) state.  Every product
is a plain PyTorch contraction of two operands (the reference's
three-operand einsums are split in two), so no (B, nc, Q, H, P, N)
intermediate is formed; the largest tensor a layer makes is the fp32
(B, nc, H, Q, Q) decay mask.

Decode is the exact recurrence with a per-layer (state, conv-window)
cache: O(1) per token.  As in the reference, the conv window is bf16 in
every config, so decode differs from the full forward by that rounding.

One deliberate deviation, in :func:`_segsum_mask`: the reference takes
``exp`` of the whole Q x Q square of decay differences before it selects
the lower triangle, and above the diagonal the exponent is the chunk's
summed log-decay, which is positive.  Where that sum passes fp32's 88.7
the exponential is inf, and the backward of the selection multiplies its
zero cotangent by it: the gradient with respect to dt (and everything
upstream of it) is NaN although the forward is finite.  The port masks
the exponent to -inf before the ``exp``: the same forward, bit for bit,
and a finite gradient, equal to the reference's wherever that is finite.

The accumulation dtype is the wider of the input's and fp32 (fp32 for
bf16 and fp32 inputs, as the reference's ``astype(float32)``; fp64 for
fp64 inputs, which the CPU tests use as a high-precision yardstick).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.config import ModelConfig


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, n_heads, conv_dim) for the Mamba2 block."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, n_heads, conv_dim


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype=torch.bfloat16, stack: tuple = ()) -> dict:
    """One Mamba2 block's parameters, each leaf with the leading ``stack``
    dims (the layer axis).  ``in_proj`` emits [z (di), x (di), B (N), C
    (N), dt (H)].  ``A_log``, ``D`` and ``dt_bias`` are fp32 in every
    config, as the reference draws them: A = -exp(A_log) over
    linspace(1, 16, H), D = 1, and dt_bias the inverse softplus of a
    log-uniform draw in [1e-3, 1e-1].  The stacked matrices are drawn one
    matrix at a time, so the fp32 transient is one layer's."""
    s = cfg.ssm
    d = cfg.d_model
    di, H, conv_dim = ssm_dims(cfg)
    lead = tuple(stack)
    dev = gen.device

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=dev)

    def dense(m, n):
        w = torch.empty(lead + (m, n), dtype=dtype, device=dev)
        for mat in w.view(-1, m, n):
            mat.copy_(dense_init(gen, (m, n), dtype=dtype))
        return w

    u = torch.empty(lead + (H,), dtype=torch.float32, device=dev)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=dev))
    return {
        "ln": zeros(d),
        "in_proj": dense(d, 2 * di + 2 * s.d_state + H),
        # fan-in = the conv kernel's K taps (the reference's in_axis=0)
        "conv_w": dense(s.conv_kernel, conv_dim),
        "conv_b": zeros(conv_dim),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "norm": zeros(di),
        "out_proj": dense(di, d),
    }


def _acc_dtype(*ts: torch.Tensor) -> torch.dtype:
    """The wider of the inputs' dtypes and fp32."""
    acc = torch.float32
    for t in ts:
        acc = torch.promote_types(acc, t.dtype)
    return acc


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence: x (B, S, C); w (K, C).
    The sum of K shifted slices, no im2col."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _segsum_mask(a_cum: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(a_cum_i - a_cum_j) for i >= j, else 0.

    a_cum: (..., Q) inclusive cumulative log-decay.  The exponent is
    masked to -inf above the diagonal before the ``exp`` (the reference
    masks after it): below the diagonal the values are the reference's
    bit for bit, and the gradient stays finite where the reference's
    exp(positive sum) overflows and its backward makes 0 * inf = NaN."""
    diff = a_cum[..., :, None] - a_cum[..., None, :]              # (..., Q, Q)
    Q = a_cum.shape[-1]
    tril = torch.ones((Q, Q), dtype=torch.bool,
                      device=a_cum.device).tril()
    return torch.exp(torch.where(tril, diff, float("-inf")))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise SSD.  Shapes:
        x:  (B, S, H, P)   inputs per head
        dt: (B, S, H)      positive step sizes
        A:  (H,)           negative per-head decay rates
        Bm: (B, S, N)      input projections (one group, broadcast to heads)
        Cm: (B, S, N)      output projections
        h0: (B, H, P, N)   optional initial state
    Returns (y (B, S, H, P), final state (B, H, P, N)), in the
    accumulation dtype.  A sequence that is not a chunk multiple is padded
    with dt = 0 (decay exp(0) = 1 keeps the state, a zero dt * x adds
    nothing) and the padded outputs are sliced off."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        pad = Q - S % Q
        y, h = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                           F.pad(dt, (0, 0, 0, pad)), A,
                           F.pad(Bm, (0, 0, 0, pad)),
                           F.pad(Cm, (0, 0, 0, pad)), chunk, h0)
        return y[:, :S], h
    nc = S // Q
    acc = _acc_dtype(x, dt)

    a = (dt * A).to(acc)                                          # (B,S,H) <= 0
    xdt = (x * dt[..., None]).to(acc)                             # dt-weighted

    ac = a.reshape(B_, nc, Q, H)
    xc = xdt.reshape(B_, nc, Q, H, P)
    Bc = Bm.reshape(B_, nc, Q, N).to(acc)
    Cc = Cm.reshape(B_, nc, Q, N).to(acc)

    a_cum = torch.cumsum(ac, dim=2)                               # (B,nc,Q,H)
    a_total = a_cum[:, :, -1]                                     # (B,nc,H)

    # intra-chunk: attention-like, masked by the decay kernel
    L = _segsum_mask(a_cum.transpose(2, 3))                       # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)              # (B,nc,Q,Q)
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", L * scores[:, :, None],
                           xc)                                    # (B,nc,Q,H,P)

    # chunk summaries: each chunk's contribution to the state
    decay_to_end = torch.exp(a_total[:, :, None] - a_cum)         # (B,nc,Q,H)
    states = torch.einsum("bcshp,bcsn->bchpn",
                          xc * decay_to_end[..., None], Bc)       # (B,nc,H,P,N)

    # inter-chunk scan: the state before each chunk
    h = (torch.zeros((B_, H, P, N), dtype=acc, device=x.device)
         if h0 is None else h0.to(acc))
    chunk_decay = torch.exp(a_total)                              # (B,nc,H)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                          # (B,nc,H,P,N)

    # inter-chunk output: a decayed read of the carried state
    decay_in = torch.exp(a_cum)                                   # (B,nc,Q,H)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prev) \
        * decay_in[..., None]

    y = (y_intra + y_inter).reshape(B_, S, H, P)
    return y, h


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact recurrence for one token.
        x: (B, H, P)  dt: (B, H)  Bm, Cm: (B, N)  h: (B, H, P, N)
    Returns (y (B, H, P), h_new)."""
    acc = _acc_dtype(h)
    a = torch.exp(dt * A).to(acc)                                 # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", (x * dt[..., None]).to(acc),
                       Bm.to(acc))
    h_new = h * a[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm.to(acc))
    return y, h_new


@dataclass
class MambaState:
    """Per-layer decode cache: the SSD state and the causal-conv window."""

    h: torch.Tensor       # (..., B, H, P, N) fp32
    conv: torch.Tensor    # (..., B, K-1, conv_dim) bf16


def init_mamba_state(cfg: ModelConfig, batch: int,
                     device=None) -> MambaState:
    """A zero state: h fp32, the conv window bf16 (in every config, as the
    reference)."""
    s = cfg.ssm
    _, H, conv_dim = ssm_dims(cfg)
    return MambaState(
        h=torch.zeros((batch, H, s.head_dim, s.d_state),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, s.conv_kernel - 1, conv_dim),
                         dtype=torch.bfloat16, device=device))


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    """in_proj's output -> (z, x, B, C, dt), views."""
    s = cfg.ssm
    di, H, _ = ssm_dims(cfg)
    return torch.split(proj, [di, di, s.d_state, s.d_state, H], dim=-1)


def _mamba_forward(x: torch.Tensor, p: dict, cfg: ModelConfig
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole-sequence block -> (y (B, S, d), the final SSD state
    (B, H, P, N), the conv input (B, S, conv_dim))."""
    s = cfg.ssm
    di, H, _ = ssm_dims(cfg)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    proj = h @ p["in_proj"]
    z, _, _, _, dt = _split_proj(proj, cfg)
    conv_in = proj[..., di:2 * di + 2 * s.d_state]     # concat(x, B, C)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xin, Bm, Cm = torch.split(conv_out, [di, s.d_state, s.d_state], dim=-1)

    dt_pos = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(*xin.shape[:-1], H, s.head_dim)
    y, h_last = ssd_chunked(xh, dt_pos, A, Bm, Cm, s.chunk)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(*x.shape[:-1], di)
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], h_last, conv_in


def mamba_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Training / prefill Mamba2 block: x (B, S, d) -> (B, S, d)."""
    return _mamba_forward(x, p, cfg)[0]


def mamba_decode_block(x: torch.Tensor, p: dict, st: MambaState,
                       cfg: ModelConfig) -> tuple[torch.Tensor, MambaState]:
    """One-token Mamba2 block: x (B, 1, d) -> (y (B, 1, d), the new
    state).  The window holds the last K-1 conv inputs in bf16."""
    s = cfg.ssm
    di, H, _ = ssm_dims(cfg)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    proj = (h @ p["in_proj"])[:, 0]                               # (B, ...)
    z, _, _, _, dt = _split_proj(proj, cfg)
    conv_in = proj[:, di:2 * di + 2 * s.d_state]                  # (B, C)
    window = torch.cat([st.conv, conv_in[:, None, :].to(st.conv.dtype)],
                       dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            p["conv_w"].float()) + p["conv_b"]
    conv_out = F.silu(conv_out)
    xin, Bm, Cm = torch.split(conv_out, [di, s.d_state, s.d_state], dim=-1)

    dt_pos = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(-1, H, s.head_dim)
    y, h_new = ssd_decode_step(xh, dt_pos, A, Bm, Cm, st.h)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(-1, 1, di).to(x.dtype) * F.silu(z)[:, None, :]
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], MambaState(h=h_new, conv=window[:, 1:])
