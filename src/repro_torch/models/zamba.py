"""Zamba2-style hybrid: a Mamba2 backbone with a *shared* attention + MLP
block woven in after every ``attn_every`` layers (one set of weights
applied G times).  The shared block consumes ``concat(original
embeddings, current hidden)`` through a 2d -> d projection.

Counterpart of ``repro.models.zamba``, function for function: the same
parameter schema (``mamba_layers`` stacked on axis 0, ``shared`` one
block), the same groups of ``attn_every`` Mamba layers followed by one
application of the shared block, and the same serving cache.  The scans
are Python loops over the layer axis, unbound once into views.  The
shared block's parameters receive one gradient summed over their G
applications, as the reference's closure over them gives.

The serving cache is preallocated and written in place: prefill fills
it, each decode step updates the Mamba states and appends one K/V entry
per group; ``length`` is a host int, as in the decoder's dense cache.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import (cross_entropy, dense_init, embed_init,
                                       rms_norm, shift_labels)
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (_logits, _rope_q_k,
                                            _unstack_layers, torch_dtype)


def _n_groups(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(
            f"zamba n_layers={cfg.n_layers} must be divisible by "
            f"attn_every={cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def init_zamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random init on the generator's device, in the reference's schema
    and draw order (the shared block, the embedding, the Mamba stack, the
    head)."""
    dtype = torch_dtype(cfg.dtype)
    d, hd = cfg.d_model, cfg.hd
    dev = gen.device

    def dense(*shape):
        return dense_init(gen, shape, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    shared = {
        "w_in": dense(2 * d, d),
        "ln1": zeros(d),
        "wq": dense(d, cfg.n_heads * hd),
        "wk": dense(d, cfg.n_kv_heads * hd),
        "wv": dense(d, cfg.n_kv_heads * hd),
        "wo": dense(cfg.n_heads * hd, d),
        "ln2": zeros(d),
        "w_gate": dense(d, cfg.d_ff),
        "w_up": dense(d, cfg.d_ff),
        "w_down": dense(cfg.d_ff, d),
    }
    embed = embed_init(gen, (cfg.padded_vocab, d), dtype)
    layers = ssm.init_mamba_params(gen, cfg, dtype, stack=(cfg.n_layers,))
    return {
        "embed": embed,
        "mamba_layers": layers,
        "shared": shared,
        "final_norm": zeros(d),
        "lm_head": dense(d, cfg.padded_vocab),
    }


def _shared_block(x, x0, p, cfg: ModelConfig, positions, kv_cache=None,
                  pos: int | None = None):
    """The weight-shared attention + MLP block -> (delta, kv).  Over the
    whole sequence (``kv_cache`` None) kv is the fresh (k, v); in decode
    ``kv_cache`` is one group's (k (B, T, Hkv, hd), v, positions (T,)),
    written in place at ``pos`` and returned."""
    B = x.shape[0]
    hd = cfg.hd
    h = torch.cat([x0, x], dim=-1) @ p["w_in"]
    h = rms_norm(h, p["ln1"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, -1, cfg.n_heads, hd)
    k = (h @ p["wk"]).reshape(B, -1, cfg.n_kv_heads, hd)
    v = (h @ p["wv"]).reshape(B, -1, cfg.n_kv_heads, hd)
    q, k = _rope_q_k(cfg, q, k, positions, {})
    if kv_cache is None:                                   # train / prefill
        out = attn.blocked_attention(q, k, v, kv_block=cfg.kv_block)
        kv = (k, v)
    else:
        k_c, v_c, pos_c = kv_cache
        attn.cache_write(k_c, v_c, pos_c, k, v, pos, ring=False)
        out = attn.decode_attention(q[:, 0], k_c, v_c, pos,
                                    cache_positions=pos_c)[:, None]
        kv = kv_cache
    a = out.reshape(B, -1, cfg.n_heads * hd) @ p["wo"]
    h2 = rms_norm(a, p["ln2"], cfg.norm_eps)
    f = F.silu(h2 @ p["w_gate"]) * (h2 @ p["w_up"])
    return a + f @ p["w_down"], kv


def _grouped(tree, G: int) -> list[list]:
    """Stacked layer params (L, ...) as G groups of L/G per-layer dicts of
    views (the reference reshapes to (G, L/G, ...)).  The stack is unbound
    once, so the backward stacks each leaf's gradient once."""
    per_layer = _unstack_layers(tree)
    Lg = len(per_layer) // G
    return [per_layer[g * Lg:(g + 1) * Lg] for g in range(G)]


def zamba_forward(params, tokens: torch.Tensor, cfg: ModelConfig,
                  remat: str = "full") -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, Vp), aux loss () = 0).
    ``remat`` "full" and "dots" both checkpoint each group (the reference
    puts one ``jax.checkpoint`` around the group for either), "none"
    keeps every activation."""
    if remat not in ("full", "dots", "none"):
        raise NotImplementedError(f"remat={remat!r} is not yet ported to "
                                  "repro_torch (full, dots, none)")
    G = _n_groups(cfg)
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :]
    x0 = params["embed"][tokens]
    shared = params["shared"]

    def group(x, p_group):
        for p_l in p_group:
            x = x + ssm.mamba_block(x, p_l, cfg)
        delta, _ = _shared_block(x, x0, shared, cfg, positions)
        return x + delta

    x = x0
    for p_group in _grouped(params["mamba_layers"], G):
        if remat == "none":
            x = group(x, p_group)
        else:
            x = torch.utils.checkpoint.checkpoint(group, x, p_group,
                                                  use_reentrant=False)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), torch.zeros((), device=x.device)


def zamba_loss(params, batch: dict, cfg: ModelConfig, remat: str = "full"):
    """(ce, {"ce_loss", "aux_loss"}): next-token cross entropy over the
    real vocabulary, the last position masked."""
    tokens = batch["tokens"]
    logits, aux = zamba_forward(params, tokens, cfg, remat)
    labels, mask = shift_labels(tokens)
    loss = cross_entropy(logits, labels, mask, cfg.vocab_size)
    return loss, {"ce_loss": loss, "aux_loss": aux}


@dataclass
class ZambaCache:
    """The serving cache, written in place.  ``mamba`` holds the
    L-stacked SSD states h (L, B, H, P, N) fp32 and conv windows (L, B,
    K-1, conv_dim) bf16; the shared block's K/V are per group, (G, B, T,
    Hkv, hd), with position tags (G, T) (-1 = empty); ``length`` is a
    host int."""

    mamba: ssm.MambaState
    shared_k: torch.Tensor
    shared_v: torch.Tensor
    shared_pos: torch.Tensor
    length: int


def init_zamba_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> ZambaCache:
    """An empty cache (K/V bf16 by default, as the reference's)."""
    G = _n_groups(cfg)
    st = ssm.init_mamba_state(cfg, batch, device)
    L = cfg.n_layers
    shape = (G, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return ZambaCache(
        mamba=ssm.MambaState(
            h=st.h.expand((L,) + st.h.shape).clone(),
            conv=st.conv.expand((L,) + st.conv.shape).clone()),
        shared_k=torch.zeros(shape, dtype=dtype, device=device),
        shared_v=torch.zeros(shape, dtype=dtype, device=device),
        shared_pos=torch.full((G, max_len), -1, dtype=torch.int32,
                              device=device),
        length=0)


def zamba_prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
                  max_len: int) -> tuple[torch.Tensor, ZambaCache]:
    """Prefill S tokens -> (last-position logits (B, Vp), the cache): the
    chunked forward, collecting each layer's final SSD state and conv
    tail (the last K-1 conv inputs, zero-padded on the left when S < K-1,
    in bf16) and each group's shared-block K/V (in the activation dtype,
    as the reference's)."""
    G = _n_groups(cfg)
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"{max_len}")
    dev = tokens.device
    K = cfg.ssm.conv_kernel
    positions = torch.arange(S, device=dev)[None, :]
    x0 = params["embed"][tokens]
    shared = params["shared"]
    cache = init_zamba_cache(cfg, B, max_len, x0.dtype, dev)
    hs, convs = cache.mamba.h, cache.mamba.conv
    x = x0
    for g, p_group in enumerate(_grouped(params["mamba_layers"], G)):
        for j, p_l in enumerate(p_group):
            i = g * len(p_group) + j
            y, h_last, conv_in = ssm._mamba_forward(x, p_l, cfg)
            hs[i] = h_last
            tail = conv_in[:, -(K - 1):]
            convs[i, :, K - 1 - tail.shape[1]:] = tail.to(convs.dtype)
            x = x + y
        delta, (k, v) = _shared_block(x, x0, shared, cfg, positions)
        cache.shared_k[g, :, :S] = k
        cache.shared_v[g, :, :S] = v
        x = x + delta
    slots = torch.arange(max_len, dtype=torch.int32, device=dev)
    cache.shared_pos.copy_(torch.where(slots < S, slots, -1).expand(
        G, max_len))
    cache.length = S
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], cache


def zamba_decode_step(params, cache: ZambaCache, token: torch.Tensor,
                      cfg: ModelConfig) -> tuple[torch.Tensor, ZambaCache]:
    """One decode step: token (B,) at position ``cache.length``.  Updates
    every layer's state and each group's K/V in place and returns (logits
    (B, Vp), the cache one position longer: the same tensors, a new
    ``length``)."""
    G = _n_groups(cfg)
    B = token.shape[0]
    pos = cache.length
    positions = torch.full((B, 1), pos, device=token.device)
    x0 = params["embed"][token][:, None, :]
    shared = params["shared"]
    hs, convs = cache.mamba.h, cache.mamba.conv
    x = x0
    for g, p_group in enumerate(_grouped(params["mamba_layers"], G)):
        for j, p_l in enumerate(p_group):
            i = g * len(p_group) + j
            y, st = ssm.mamba_decode_block(
                x, p_l, ssm.MambaState(h=hs[i], conv=convs[i]), cfg)
            hs[i] = st.h
            convs[i] = st.conv
            x = x + y
        delta, _ = _shared_block(
            x, x0, shared, cfg, positions,
            kv_cache=(cache.shared_k[g], cache.shared_v[g],
                      cache.shared_pos[g]), pos=pos)
        x = x + delta
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], ZambaCache(
        mamba=cache.mamba, shared_k=cache.shared_k, shared_v=cache.shared_v,
        shared_pos=cache.shared_pos, length=pos + 1)
