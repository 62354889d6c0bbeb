"""Encoder-decoder transformer: the model of seamless-m4t-large-v2.

Counterpart of ``repro.models.encdec``, function for function.  The
speech front end is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d).  Encoder: bidirectional
self-attention blocks.  Decoder: causal self-attention, then
cross-attention over the encoder's memory.  The layer stacks are the
reference's (``enc_layers``, ``dec_layers`` on axis 0), looped over in
Python where the reference scans.

Serving precomputes each decoder layer's cross-attention K/V from the
memory once, at prefill, and carries a self-attention KV cache laid out
as the decoder's dense one (slot i holds position i, -1 tags an empty
slot).  The cache is written in place; ``length`` is a host int.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.common import (cross_entropy, dense_init, embed_init,
                                       rms_norm, shift_labels)
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (_logits, _rope_q_k,
                                            _unstack_layers, torch_dtype)


def _init_attn(dense, cfg: ModelConfig, L: int) -> dict:
    d, hd = cfg.d_model, cfg.hd
    return {"wq": dense(L, d, cfg.n_heads * hd),
            "wk": dense(L, d, cfg.n_kv_heads * hd),
            "wv": dense(L, d, cfg.n_kv_heads * hd),
            "wo": dense(L, cfg.n_heads * hd, d)}


def _init_ffn(dense, cfg: ModelConfig, L: int) -> dict:
    return {"w_gate": dense(L, cfg.d_model, cfg.d_ff),
            "w_up": dense(L, cfg.d_model, cfg.d_ff),
            "w_down": dense(L, cfg.d_ff, cfg.d_model)}


def _init_enc_layer(dense, zeros, cfg: ModelConfig) -> dict:
    L, d = cfg.n_enc_layers, cfg.d_model
    return {"ln1": zeros(L, d), "attn": _init_attn(dense, cfg, L),
            "ln2": zeros(L, d), "mlp": _init_ffn(dense, cfg, L)}


def _init_dec_layer(dense, zeros, cfg: ModelConfig) -> dict:
    L, d = cfg.n_dec_layers, cfg.d_model
    return {"ln1": zeros(L, d), "attn": _init_attn(dense, cfg, L),
            "lnx": zeros(L, d), "xattn": _init_attn(dense, cfg, L),
            "ln2": zeros(L, d), "mlp": _init_ffn(dense, cfg, L)}


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random init on the generator's device, in the reference's schema
    and draw order (the embedding, the encoder stack, the decoder stack,
    the head).  Stacked matrices are drawn a matrix at a time."""
    dtype = torch_dtype(cfg.dtype)
    dev = gen.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def dense(L, m, n):
        w = torch.empty((L, m, n), dtype=dtype, device=dev)
        for mat in w:
            mat.copy_(dense_init(gen, (m, n), dtype=dtype))
        return w

    d = cfg.d_model
    embed = embed_init(gen, (cfg.padded_vocab, d), dtype)
    enc = _init_enc_layer(dense, zeros, cfg)
    dec = _init_dec_layer(dense, zeros, cfg)
    return {
        "embed": embed,
        "enc_layers": enc,
        "enc_norm": zeros(d),
        "dec_layers": dec,
        "final_norm": zeros(d),
        "lm_head": dense_init(gen, (d, cfg.padded_vocab), dtype=dtype),
    }


def _self_attn(h, p, cfg: ModelConfig, positions, causal: bool):
    """Self-attention over the whole sequence -> (out (B, S, d), (k, v))
    with q and k rotated."""
    B, S, _ = h.shape
    hd = cfg.hd
    q = (h @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (h @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (h @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    q, k = _rope_q_k(cfg, q, k, positions, {})
    out = attn.blocked_attention(q, k, v, causal=causal,
                                 kv_block=cfg.kv_block)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


def _memory_kv(memory, p, cfg: ModelConfig):
    """One decoder layer's cross-attention K/V from the memory (B, Tm,
    d): each (B, Tm, Hkv, hd), not rotated."""
    B, Tm, _ = memory.shape
    shape = (B, Tm, cfg.n_kv_heads, cfg.hd)
    return ((memory @ p["wk"]).reshape(shape),
            (memory @ p["wv"]).reshape(shape))


def _cross_attn(h, memory_kv, p, cfg: ModelConfig):
    """h: (B, S, d); memory_kv: the precomputed (k, v), each (B, Tm, Hkv,
    hd).  Every memory slot is visible to every query; neither q nor k
    rotates."""
    B, S, _ = h.shape
    q = (h @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k, v = memory_kv
    out = attn.blocked_attention(q, k, v, causal=False,
                                 kv_block=cfg.kv_block)
    return out.reshape(B, S, -1) @ p["wo"]


def _ffn(h, p):
    return (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]


def _check_remat(remat: str) -> None:
    if remat not in ("full", "dots", "none"):
        raise NotImplementedError(f"remat={remat!r} is not yet ported to "
                                  "repro_torch (full, dots, none)")


def _run_stack(block, x, layers, remat: str):
    """Apply ``block`` layer by layer; "full" and "dots" checkpoint each
    layer (the reference puts one ``jax.checkpoint`` around the scanned
    block for either)."""
    for p in layers:
        if remat == "none":
            x = block(x, p)
        else:
            x = torch.utils.checkpoint.checkpoint(block, x, p,
                                                  use_reentrant=False)
    return x


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           remat: str = "full") -> torch.Tensor:
    """frames: (B, S_enc, d) precomputed front-end embeddings -> the
    memory (B, S_enc, d) in the params' dtype."""
    _check_remat(remat)
    S = frames.shape[1]
    positions = torch.arange(S, device=frames.device)[None, :]
    x = frames.to(torch_dtype(cfg.dtype))

    def block(x, p):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = _self_attn(h, p["attn"], cfg, positions, causal=False)
        x = x + a
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + _ffn(h, p["mlp"])

    x = _run_stack(block, x, _unstack_layers(params["enc_layers"]), remat)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def decode_train(params, memory: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig, remat: str = "full") -> torch.Tensor:
    """The teacher-forced decoder forward -> logits (B, S_dec, Vp)."""
    _check_remat(remat)
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :]

    def block(x, p):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = _self_attn(h, p["attn"], cfg, positions, causal=True)
        x = x + a
        h = rms_norm(x, p["lnx"], cfg.norm_eps)
        mkv = _memory_kv(memory, p["xattn"], cfg)
        x = x + _cross_attn(h, mkv, p["xattn"], cfg)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + _ffn(h, p["mlp"])

    x = _run_stack(block, params["embed"][tokens],
                   _unstack_layers(params["dec_layers"]), remat)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)


def encdec_loss(params, batch: dict, cfg: ModelConfig, remat: str = "full"):
    """(ce, {"ce_loss", "aux_loss"}): encode ``batch["frames"]``, then
    next-token cross entropy of the decoder over ``batch["tokens"]``."""
    memory = encode(params, batch["frames"], cfg, remat)
    logits = decode_train(params, memory, batch["tokens"], cfg, remat)
    labels, mask = shift_labels(batch["tokens"])
    loss = cross_entropy(logits, labels, mask, cfg.vocab_size)
    return loss, {"ce_loss": loss,
                  "aux_loss": torch.zeros((), device=loss.device)}


@dataclass
class EncDecCache:
    """The serving cache, written in place.  Self-attention K/V (L, B, T,
    Hkv, hd) with position tags (L, T) (-1 = empty); the cross-attention
    K/V (L, B, Tm, Hkv, hd), precomputed from the memory; ``length`` a
    host int."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    self_pos: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    length: int


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      memory_len: int | None = None, dtype=torch.bfloat16,
                      device=None) -> EncDecCache:
    """An empty cache: the reference's spec sizes the cross K/V at
    ``cfg.enc_memory_len`` (``memory_len`` overrides it); bf16 by
    default."""
    L, hd, Hkv = cfg.n_dec_layers, cfg.hd, cfg.n_kv_heads
    Tm = cfg.enc_memory_len if memory_len is None else memory_len

    def z(T):
        return torch.zeros((L, batch, T, Hkv, hd), dtype=dtype,
                           device=device)

    return EncDecCache(
        self_k=z(max_len), self_v=z(max_len),
        self_pos=torch.full((L, max_len), -1, dtype=torch.int32,
                            device=device),
        cross_k=z(Tm), cross_v=z(Tm), length=0)


def encdec_prefill(params, frames: torch.Tensor, tokens: torch.Tensor,
                   cfg: ModelConfig, max_len: int
                   ) -> tuple[torch.Tensor, EncDecCache]:
    """Encode the frames, precompute each layer's cross K/V, and prefill
    the decoder with S tokens -> (last-position logits (B, Vp), the cache
    in the activations' dtype: self K/V in slots < S, tagged with their
    positions, -1 beyond)."""
    memory = encode(params, frames, cfg, remat="none")
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"{max_len}")
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None, :]
    x = params["embed"][tokens]
    cache = init_encdec_cache(cfg, B, max_len, memory.shape[1], x.dtype,
                              dev)
    for i, p in enumerate(_unstack_layers(params["dec_layers"])):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, (k, v) = _self_attn(h, p["attn"], cfg, positions, causal=True)
        cache.self_k[i] = attn.pad_to(k, max_len)
        cache.self_v[i] = attn.pad_to(v, max_len)
        x = x + a
        h = rms_norm(x, p["lnx"], cfg.norm_eps)
        mk, mv = _memory_kv(memory, p["xattn"], cfg)
        cache.cross_k[i] = mk
        cache.cross_v[i] = mv
        x = x + _cross_attn(h, (mk, mv), p["xattn"], cfg)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _ffn(h, p["mlp"])
    slots = torch.arange(max_len, dtype=torch.int32, device=dev)
    cache.self_pos.copy_(torch.where(slots < S, slots, -1).expand(
        cfg.n_dec_layers, max_len))
    cache.length = S
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], cache


def encdec_decode_step(params, cache: EncDecCache, token: torch.Tensor,
                       cfg: ModelConfig) -> tuple[torch.Tensor, EncDecCache]:
    """One decode step: token (B,) at position ``cache.length``.  Writes
    its self K/V in place and attends over every memory slot; returns
    (logits (B, Vp), the cache one position longer)."""
    B = token.shape[0]
    pos = cache.length
    positions = torch.full((B, 1), pos, device=token.device)
    hd = cfg.hd
    Tm = cache.cross_k.shape[2]
    x = params["embed"][token][:, None, :]
    for i, p in enumerate(_unstack_layers(params["dec_layers"])):
        pa, px = p["attn"], p["xattn"]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q = (h @ pa["wq"]).reshape(B, 1, cfg.n_heads, hd)
        k = (h @ pa["wk"]).reshape(B, 1, cfg.n_kv_heads, hd)
        v = (h @ pa["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
        q, k = _rope_q_k(cfg, q, k, positions, {})
        attn.cache_write(cache.self_k[i], cache.self_v[i], cache.self_pos[i],
                         k, v, pos, ring=False)
        a = attn.decode_attention(q[:, 0], cache.self_k[i], cache.self_v[i],
                                  pos, cache_positions=cache.self_pos[i])
        x = x + a.reshape(B, 1, -1) @ pa["wo"]
        h = rms_norm(x, p["lnx"], cfg.norm_eps)
        qx = (h @ px["wq"]).reshape(B, cfg.n_heads, hd)
        ax = attn.decode_attention(qx, cache.cross_k[i], cache.cross_v[i],
                                   Tm)
        x = x + ax.reshape(B, 1, -1) @ px["wo"]
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _ffn(h, p["mlp"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], EncDecCache(
        self_k=cache.self_k, self_v=cache.self_v, self_pos=cache.self_pos,
        cross_k=cache.cross_k, cross_v=cache.cross_v, length=pos + 1)
