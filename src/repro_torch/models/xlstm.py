"""xLSTM (Beck et al., 2024): mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, sequential) blocks: the model of xlstm-125m.

Counterpart of ``repro.models.xlstm``, function for function: the same
parameter schema (``mlstm_layers`` and ``slstm_layers`` stacked on axis
0), the same groups of (``slstm_every`` - 1) mLSTM blocks and one sLSTM
block, and the same serving cache.  The mLSTM's chunkwise schedule keeps
the reference's log-space gates, per-row running-max stabilisers and the
fp32 (C, n, m) state carried across chunks, with a Python loop over the
S/Q chunks where the reference scans.  The sLSTM is a Python loop over
time on the precomputed input projection, as the reference's
``lax.scan``.

One deliberate deviation, in :func:`mlstm_chunked`: the reference takes
``exp`` of the intra-chunk weight exponent ``g_j + b_i - m_i`` over the
whole Q x Q square before it zeroes the upper triangle.  Above the
diagonal that exponent is ``g_j - max(m, max_{j' <= i} g_j')``, which
the unbounded input-gate pre-activation can push past fp32's 88.7: the
exponential is inf, and the backward of the selection multiplies its
zero cotangent by it, so the gate gradients are NaN although the forward
is finite.  The port masks the exponent to -inf before the ``exp``: the
same forward, bit for bit, and a finite gradient, equal to the
reference's wherever that is finite.

The dtypes are the reference's on each path: the cell state and the
gates are fp32 (the accumulation dtype is the wider of the input's and
fp32, so fp64 inputs evaluate in fp64); the mLSTM's decode step forms
its conv output in fp32 from the bf16 conv window and so takes q and k
as fp32 products, where the chunked path's are in the params' dtype (JAX
promotes the mixed product, torch needs the cast).

The serving cache is preallocated and written in place: prefill fills
it, each decode step updates every layer's state; ``length`` is a host
int, as in the port's other caches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.common import (cross_entropy, dense_init, embed_init,
                                       rms_norm, shift_labels)
from repro_torch.models.config import ModelConfig
# the mLSTM's depthwise causal conv is the Mamba block's (K shifted slices)
from repro_torch.models.ssm import _acc_dtype, _causal_conv
from repro_torch.models.transformer import (_logits, _unstack_layers,
                                            torch_dtype)
from repro_torch.models.zamba import _grouped

NEG_BIG = -1e30     # the stabilisers' start: exp(-inf - -inf) would be NaN


def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    di = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    return di, di // cfg.n_heads          # (inner dim, per-head dim)


def _slstm_ff(cfg: ModelConfig) -> int:
    return int(cfg.xlstm.slstm_proj_factor * cfg.d_model)


def _stacked_dense(gen: torch.Generator, lead: tuple, m: int, n: int,
                   dtype) -> torch.Tensor:
    """(*lead, m, n) fan-in (m) init, drawn one matrix at a time so the
    fp32 transient is one matrix's."""
    w = torch.empty(lead + (m, n), dtype=dtype, device=gen.device)
    for mat in w.view(-1, m, n):
        mat.copy_(dense_init(gen, (m, n), dtype=dtype))
    return w


def init_mlstm_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype=torch.bfloat16, stack: tuple = ()) -> dict:
    """One mLSTM block's parameters with the leading ``stack`` dims.  The
    gate projections ``w_i``, ``w_f`` and their biases are fp32 in every
    config, as the reference draws them; ``b_f`` starts at 3 (open forget
    gates)."""
    d = cfg.d_model
    di, _ = _mlstm_dims(cfg)
    H = cfg.n_heads
    lead = tuple(stack)
    dev = gen.device

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=dev)

    def dense(m, n, dt=dtype):
        return _stacked_dense(gen, lead, m, n, dt)

    return {
        "ln": zeros(d),
        "w_up": dense(d, 2 * di),
        # fan-in = the conv kernel's K taps (the reference's in_axis=0)
        "conv_w": dense(cfg.xlstm.conv_kernel, di),
        "conv_b": zeros(di),
        "wq": dense(di, di),
        "wk": dense(di, di),
        "wv": dense(di, di),
        "w_i": dense(di, H, torch.float32),
        "b_i": zeros(H, dt=torch.float32),
        "w_f": dense(di, H, torch.float32),
        "b_f": torch.full(lead + (H,), 3.0, dtype=torch.float32, device=dev),
        "norm": zeros(di),
        "w_down": dense(di, d),
    }


def init_slstm_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype=torch.bfloat16, stack: tuple = ()) -> dict:
    """One sLSTM block's parameters with the leading ``stack`` dims.  The
    bias ``b`` (4d) is fp32 and laid out [i | f | z | o], each of width d,
    the forget block at 3; the cell splits the pre-activation by head
    first (:func:`_slstm_cell`), as the reference does.  ``R`` is the
    block-diagonal recurrence, (H, hd, 4 hd) per block, fan-in hd."""
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    ff = _slstm_ff(cfg)
    lead = tuple(stack)
    dev = gen.device

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)

    def dense(lead_, m, n):
        return _stacked_dense(gen, lead_, m, n, dtype)

    b = torch.cat([torch.zeros(d), torch.full((d,), 3.0),
                   torch.zeros(2 * d)]).to(dev)
    return {
        "ln": zeros(d),
        "W": dense(lead, d, 4 * d),
        "b": b.expand(lead + (4 * d,)).clone(),
        "R": dense(lead + (H,), hd, 4 * hd),
        "norm": zeros(d),
        "ln2": zeros(d),
        "w_gate": dense(lead, d, ff),
        "w_up": dense(lead, d, ff),
        "w_down": dense(lead, ff, d),
    }


def _n_groups(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.xlstm.slstm_every:
        raise ValueError("xlstm n_layers must be divisible by slstm_every")
    return cfg.n_layers // cfg.xlstm.slstm_every


def init_xlstm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random init on the generator's device, in the reference's schema
    and draw order (the embedding, the mLSTM stack, the sLSTM stack, the
    head)."""
    dtype = torch_dtype(cfg.dtype)
    G = _n_groups(cfg)
    every = cfg.xlstm.slstm_every
    d = cfg.d_model
    embed = embed_init(gen, (cfg.padded_vocab, d), dtype)
    mlstm = init_mlstm_params(gen, cfg, dtype, stack=(G * (every - 1),))
    slstm = init_slstm_params(gen, cfg, dtype, stack=(G,))
    return {
        "embed": embed,
        "mlstm_layers": mlstm,
        "slstm_layers": slstm,
        "final_norm": torch.zeros((d,), dtype=dtype, device=gen.device),
        "lm_head": dense_init(gen, (d, cfg.padded_vocab), dtype=dtype),
    }


# ---------------------------------------------------------------------------
# mLSTM cell: stabilised chunkwise
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    C: torch.Tensor    # (B, H, dk, dv) matrix memory
    n: torch.Tensor    # (B, H, dk) normaliser
    m: torch.Tensor    # (B, H) log-space stabiliser


def init_mlstm_state(batch: int, H: int, hd: int, device=None,
                     dtype=torch.float32) -> MLSTMState:
    """The empty state: C and n zero, m at -1e30 (not -inf)."""
    return MLSTMState(
        C=torch.zeros((batch, H, hd, hd), dtype=dtype, device=device),
        n=torch.zeros((batch, H, hd), dtype=dtype, device=device),
        m=torch.full((batch, H), NEG_BIG, dtype=dtype, device=device))


def mlstm_chunked(q, k, v, log_i, log_f, chunk: int,
                  state: MLSTMState | None = None
                  ) -> tuple[torch.Tensor, MLSTMState]:
    """q, k, v: (B, S, H, hd); log_i / log_f: (B, S, H) -> (h (B, S, H,
    hd) in the accumulation dtype, the final state).

    S is padded to a chunk multiple with log_f = 0 (f = 1 keeps the
    state) and log_i = -1e30 (i = 0 adds nothing), the padded outputs
    sliced off.  Within a chunk the weight of key j for query i is
    ``exp(g_j + b_i - m_i)`` for j <= i, its exponent masked to -inf
    above the diagonal before the ``exp`` (module docstring); across
    chunks a loop carries (C, n, m)."""
    B, S, H, hd = q.shape
    Q = min(chunk, S)
    if S % Q:
        pad = Q - S % Q
        y, st = mlstm_chunked(
            F.pad(q, (0, 0, 0, 0, 0, pad)), F.pad(k, (0, 0, 0, 0, 0, pad)),
            F.pad(v, (0, 0, 0, 0, 0, pad)),
            F.pad(log_i, (0, 0, 0, pad), value=NEG_BIG),
            F.pad(log_f, (0, 0, 0, pad)), chunk, state)
        return y[:, :S], st
    acc = _acc_dtype(q, k, v, log_i, log_f)
    scale = 1.0 / math.sqrt(hd)
    q = q.to(acc) * scale
    k = k.to(acc)
    v = v.to(acc)
    log_i = log_i.to(acc)
    log_f = log_f.to(acc)
    if state is None:
        state = init_mlstm_state(B, H, hd, q.device, acc)
    C, n, m = state
    tril = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    tril = tril[None, :, :, None]                             # (1, Qi, Qj, 1)
    hs = []
    # split, not a slice per chunk: one backward node per input
    for qb, kb, vb, li, lf in zip(*(x.split(Q, dim=1)
                                    for x in (q, k, v, log_i, log_f))):
        b = torch.cumsum(lf, dim=1)                           # inclusive
        g = li - b
        g_run = torch.cummax(g, dim=1).values                 # max_{j<=i} g_j
        m_row = b + torch.maximum(m[:, None, :], g_run)       # (B, Q, H)

        # intra-chunk weights, the exponent masked before the exp
        expo = g[:, None, :, :] + b[:, :, None, :] - m_row[:, :, None, :]
        wmat = torch.exp(torch.where(tril, expo, float("-inf")))  # (B,Qi,Qj,H)
        scores = torch.einsum("biht,bjht->bijh", qb, kb)
        num_intra = torch.einsum("bijh,bjhd->bihd", scores * wmat, vb)
        n_intra = torch.einsum("bijh,bjht->biht", wmat, kb)

        # the carried state, decayed by exp(m + b_i - m_row)
        dec = torch.exp(m[:, None, :] + b - m_row)            # (B, Q, H)
        num_inter = torch.einsum("biht,bhtd->bihd", qb, C) * dec[..., None]
        n_row = n[:, None, :, :] * dec[..., None] + n_intra
        num = num_intra + num_inter
        den = torch.maximum(
            torch.einsum("biht,biht->bih", qb, n_row).abs(),
            torch.exp(-m_row))
        hs.append(num / den[..., None])

        # the state across the chunk
        b_tot = b[:, -1]                                      # (B, H)
        m_new = b_tot + torch.maximum(m, g.amax(dim=1))
        carry_dec = torch.exp(m + b_tot - m_new)
        w_state = torch.exp(g + b_tot[:, None, :] - m_new[:, None, :])
        C = C * carry_dec[..., None, None] + torch.einsum(
            "bqht,bqhd->bhtd", kb * w_state[..., None], vb)
        n = n * carry_dec[..., None] + torch.einsum(
            "bqht,bqh->bht", kb, w_state)
        m = m_new
    return torch.cat(hs, dim=1), MLSTMState(C=C, n=n, m=m)


def mlstm_decode(q, k, v, log_i, log_f, state: MLSTMState
                 ) -> tuple[torch.Tensor, MLSTMState]:
    """One step.  q, k, v: (B, H, hd); log_i / log_f: (B, H) -> (h (B, H,
    hd), the new state), in the state's dtype."""
    hd = q.shape[-1]
    acc = state.C.dtype
    q = q.to(acc) / math.sqrt(hd)
    k = k.to(acc)
    v = v.to(acc)
    m_new = torch.maximum(log_f + state.m, log_i)
    f_p = torch.exp(log_f + state.m - m_new)
    i_p = torch.exp(log_i - m_new)
    C = state.C * f_p[..., None, None] + \
        i_p[..., None, None] * k[..., :, None] * v[..., None, :]
    n = state.n * f_p[..., None] + i_p[..., None] * k
    num = torch.einsum("bht,bhtd->bhd", q, C)
    den = torch.maximum(torch.einsum("bht,bht->bh", q, n).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], MLSTMState(C=C, n=n, m=m_new)


def mlstm_block(x, p, cfg: ModelConfig, state=None, decode: bool = False):
    """The mLSTM residual block -> (x + y, new state).  Train: x (B, S,
    d), ``state`` an optional :class:`MLSTMState`; decode: x (B, 1, d),
    ``state`` = (MLSTMState, the bf16 conv window (B, K-1, di)) and the
    new state likewise."""
    di, hd = _mlstm_dims(cfg)
    H = cfg.n_heads
    B = x.shape[0]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xm, z = (h @ p["w_up"]).chunk(2, dim=-1)                  # (B, S, di)
    if decode:
        st, conv_win = state
        win = torch.cat([conv_win, xm.to(conv_win.dtype)], dim=1)
        c = torch.einsum("bkc,kc->bc", win.float(),
                         p["conv_w"].float()) + p["conv_b"]
        c = F.silu(c)[:, None, :]                             # fp32
        conv_new = win[:, 1:]
    else:
        c = F.silu(_causal_conv(xm, p["conv_w"], p["conv_b"]))
    q = (c @ p["wq"].to(c.dtype)).reshape(B, -1, H, hd)
    k = (c @ p["wk"].to(c.dtype)).reshape(B, -1, H, hd)
    v = (xm @ p["wv"]).reshape(B, -1, H, hd)
    gate_in = xm.to(_acc_dtype(xm))
    log_i = gate_in @ p["w_i"].to(gate_in.dtype) + p["b_i"]   # (B, S, H)
    log_f = F.logsigmoid(gate_in @ p["w_f"].to(gate_in.dtype) + p["b_f"])
    if decode:
        y, st_new = mlstm_decode(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                 log_f[:, 0], st)
        y = y[:, None]
        new_state = (st_new, conv_new)
    else:
        y, new_state = mlstm_chunked(q, k, v, log_i, log_f, cfg.xlstm.chunk,
                                     state)
    y = y.reshape(B, -1, di).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps) * F.silu(z)
    return x + y @ p["w_down"], new_state


# ---------------------------------------------------------------------------
# sLSTM: the sequential scalar-memory cell
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    h: torch.Tensor    # (B, H, hd)
    c: torch.Tensor    # (B, H, hd)
    n: torch.Tensor    # (B, H, hd)
    m: torch.Tensor    # (B, H, hd)


def init_slstm_state(batch: int, H: int, hd: int, device=None,
                     dtype=torch.float32) -> SLSTMState:
    z = torch.zeros((batch, H, hd), dtype=dtype, device=device)
    return SLSTMState(h=z, c=z, n=z, m=torch.full_like(z, NEG_BIG))


def _slstm_cell(xw, st: SLSTMState, R) -> SLSTMState:
    """One time step.  xw: (B, 4d), the precomputed input projection;
    R: (H, hd, 4 hd) in the state's dtype.  The pre-activation is split by
    head first, then each head's row into i, f, z, o (the reference's
    reshape: the bias's [i | f | z | o] blocks of width d do not line up
    with it, so which gate a bias entry feeds depends on the head)."""
    B = xw.shape[0]
    H, hd = st.h.shape[1:]
    rec = torch.einsum("bht,htk->bhk", st.h, R)               # (B, H, 4hd)
    raw = xw.reshape(B, H, 4 * hd) + rec
    i_r, f_r, z_r, o_r = raw.chunk(4, dim=-1)
    log_i = i_r
    fm = F.logsigmoid(f_r) + st.m                             # log_f + m
    m_new = torch.maximum(fm, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(fm - m_new)
    c = f_p * st.c + i_p * torch.tanh(z_r)
    n = f_p * st.n + i_p
    h = torch.sigmoid(o_r) * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(h=h, c=c, n=n, m=m_new)


def slstm_block(x, p, cfg: ModelConfig, state: SLSTMState | None = None,
                decode: bool = False):
    """The sLSTM residual block and its post-FFN -> (x', final state).
    Sequential over time: a loop over the S steps of the precomputed
    (B, S, 4d) input projection, unbound once (one backward node, where a
    slice per step would zero-fill and add a (B, S, 4d) gradient each
    step)."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    hn = rms_norm(x, p["ln"], cfg.norm_eps)
    acc = _acc_dtype(hn)
    xw = hn.to(acc) @ p["W"].to(acc) + p["b"]                 # (B, S, 4d)
    if state is None:
        state = init_slstm_state(B, H, hd, x.device, acc)
    R = p["R"].to(state.h.dtype)
    if decode:
        st_new = _slstm_cell(xw[:, 0], state, R)
        hs = st_new.h[:, None]
    else:
        st_new, outs = state, []
        for xw_t in xw.unbind(1):
            st_new = _slstm_cell(xw_t, st_new, R)
            outs.append(st_new.h)
        hs = torch.stack(outs, dim=1)                         # (B, S, H, hd)
    y = rms_norm(hs.reshape(B, -1, d).to(x.dtype), p["norm"], cfg.norm_eps)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    f = F.silu(h2 @ p["w_gate"]) * (h2 @ p["w_up"])
    return x + f @ p["w_down"], st_new


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def xlstm_forward(params, tokens: torch.Tensor, cfg: ModelConfig,
                  remat: str = "full") -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, Vp), aux loss () = 0).
    ``remat`` "full" and "dots" both checkpoint each group (the reference
    puts one ``jax.checkpoint`` around the group for either), "none"
    keeps every activation."""
    if remat not in ("full", "dots", "none"):
        raise NotImplementedError(f"remat={remat!r} is not yet ported to "
                                  "repro_torch (full, dots, none)")
    G = _n_groups(cfg)

    def group(x, p_m, p_s):
        for p_l in p_m:
            x, _ = mlstm_block(x, p_l, cfg)
        x, _ = slstm_block(x, p_s, cfg)
        return x

    x = params["embed"][tokens]
    for p_m, p_s in zip(_grouped(params["mlstm_layers"], G),
                        _unstack_layers(params["slstm_layers"])):
        if remat == "none":
            x = group(x, p_m, p_s)
        else:
            x = torch.utils.checkpoint.checkpoint(group, x, p_m, p_s,
                                                  use_reentrant=False)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), torch.zeros((), device=x.device)


def xlstm_loss(params, batch: dict, cfg: ModelConfig, remat: str = "full"):
    """(ce, {"ce_loss", "aux_loss"}): next-token cross entropy over the
    real vocabulary, the last position masked."""
    tokens = batch["tokens"]
    logits, aux = xlstm_forward(params, tokens, cfg, remat)
    labels, mask = shift_labels(tokens)
    loss = cross_entropy(logits, labels, mask, cfg.vocab_size)
    return loss, {"ce_loss": loss, "aux_loss": aux}


@dataclass
class XLSTMCache:
    """The serving cache, written in place: the mLSTM states stacked over
    the G (every - 1) mLSTM layers (C (nm, B, H, hd, hd), n, m fp32), their
    conv windows (nm, B, K-1, di) bf16, and the sLSTM states stacked over
    the G groups ((h, c, n, m), each (G, B, H, hd) fp32).  Its size does
    not depend on the sequence's length; ``length`` is a host int."""

    mlstm: MLSTMState
    mlstm_conv: torch.Tensor
    slstm: SLSTMState
    length: int


def init_xlstm_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
                     device=None) -> XLSTMCache:
    """An empty cache (``max_len`` is unused: the states have no length
    axis)."""
    G = _n_groups(cfg)
    nm = G * (cfg.xlstm.slstm_every - 1)
    di, hd = _mlstm_dims(cfg)
    H = cfg.n_heads
    ms = init_mlstm_state(batch, H, hd, device)
    ss = init_slstm_state(batch, H, cfg.d_model // H, device)
    K = cfg.xlstm.conv_kernel
    return XLSTMCache(
        mlstm=MLSTMState(*(a.expand((nm,) + a.shape).clone() for a in ms)),
        mlstm_conv=torch.zeros((nm, batch, K - 1, di), dtype=torch.bfloat16,
                               device=device),
        slstm=SLSTMState(*(a.expand((G,) + a.shape).clone() for a in ss)),
        length=0)


def _write_state(dst: tuple, i: int, src: tuple) -> None:
    for d_, s_ in zip(dst, src):
        d_[i] = s_


def xlstm_prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
                  max_len: int = 0) -> tuple[torch.Tensor, XLSTMCache]:
    """Prefill S tokens -> (last-position logits (B, Vp), the cache): the
    chunked forward, collecting each mLSTM layer's final state and conv
    tail (its last K-1 conv inputs rounded to bf16, zero-padded on the
    left when S < K-1) and each sLSTM layer's final state."""
    G = _n_groups(cfg)
    B, S = tokens.shape
    K = cfg.xlstm.conv_kernel
    cache = init_xlstm_cache(cfg, B, device=tokens.device)
    conv = cache.mlstm_conv
    x = params["embed"][tokens]
    i = 0
    for g, (p_m, p_s) in enumerate(zip(
            _grouped(params["mlstm_layers"], G),
            _unstack_layers(params["slstm_layers"]))):
        for p_l in p_m:
            h = rms_norm(x, p_l["ln"], cfg.norm_eps)
            xm = (h @ p_l["w_up"]).chunk(2, dim=-1)[0]
            tail = xm[:, -(K - 1):]
            conv[i, :, K - 1 - tail.shape[1]:] = tail.to(conv.dtype)
            x, st = mlstm_block(x, p_l, cfg)
            _write_state(cache.mlstm, i, st)
            i += 1
        x, s_st = slstm_block(x, p_s, cfg)
        _write_state(cache.slstm, g, s_st)
    cache.length = S
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], cache


def xlstm_decode_step(params, cache: XLSTMCache, token: torch.Tensor,
                      cfg: ModelConfig) -> tuple[torch.Tensor, XLSTMCache]:
    """One decode step: token (B,) at position ``cache.length``.  Updates
    every layer's state in place and returns (logits (B, Vp), the cache
    one position longer: the same tensors, a new ``length``)."""
    G = _n_groups(cfg)
    x = params["embed"][token][:, None, :]
    ms, conv, ss = cache.mlstm, cache.mlstm_conv, cache.slstm
    i = 0
    for g, (p_m, p_s) in enumerate(zip(
            _grouped(params["mlstm_layers"], G),
            _unstack_layers(params["slstm_layers"]))):
        for p_l in p_m:
            x, (st, win) = mlstm_block(
                x, p_l, cfg, state=(MLSTMState(*(a[i] for a in ms)),
                                    conv[i]), decode=True)
            _write_state(ms, i, st)
            conv[i] = win
            i += 1
        x, s_st = slstm_block(x, p_s, cfg,
                              state=SLSTMState(*(a[g] for a in ss)),
                              decode=True)
        _write_state(ss, g, s_st)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], XLSTMCache(
        mlstm=ms, mlstm_conv=conv, slstm=ss, length=cache.length + 1)
