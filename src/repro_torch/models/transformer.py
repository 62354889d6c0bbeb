"""Decoder-only transformer: the training forward, the dense serving
path and the paged serving path.

Counterpart of ``repro.models.transformer`` for the decoder family: GQA
attention (partial rotary, QKV bias, M-RoPE with the vision-embedding
splice), MLA (the latent cache and its absorbed decode), gemma2's
local/global sliding windows, logit softcaps, sandwich norms, GeGLU, tied
and scaled embeddings, MoE MLPs (:mod:`repro_torch.models.moe`, their aux
loss summed over the layers), and the ring cache of pure sliding-window
configs (mixtral) in dense serving.  It holds init, the training
forward and loss (``decoder_forward``, ``decoder_loss``), the dense
serving programs (``decoder_prefill`` into a per-slot cache,
``decoder_decode_step``), and the two paged programs (one prefill chunk
of one prompt; one decode wave over a batch) and their blocks.  The
parameter schema is the JAX package's: nested dicts with the layer stack
on a leading axis, weights ``(in, out)``.  The layer loop is a Python
loop over that axis where the JAX code scans.

Both caches are updated in place (the JAX programs return new ones).
Torch indexing does not clamp as XLA's does, so every index that could
leave its table is routed explicitly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (apply_mrope, apply_rope,
                                       cross_entropy, dense_init, embed_init,
                                       gelu, maybe_tapped_matmul, rms_norm,
                                       shift_labels, softcap)
from repro_torch.models.config import ModelConfig


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_attn(dense, zeros, cfg: ModelConfig) -> dict:
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    if cfg.attn_type == "mla":
        m = cfg.mla
        dqk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "w_dq": dense(L, d, m.q_lora_rank),
            "q_norm": zeros(L, m.q_lora_rank),
            "w_uq": dense(L, m.q_lora_rank, Hq * dqk),
            "w_dkv": dense(L, d, m.kv_lora_rank),
            "kv_norm": zeros(L, m.kv_lora_rank),
            "w_kr": dense(L, d, m.qk_rope_head_dim),
            # (kvr, H, d) per layer, fan-in kvr
            "w_uk": dense(L, m.kv_lora_rank, Hq, m.qk_nope_head_dim,
                          in_axis=1),
            "w_uv": dense(L, m.kv_lora_rank, Hq, m.v_head_dim, in_axis=1),
            "wo": dense(L, Hq * m.v_head_dim, d),
        }
    a = {"wq": dense(L, d, Hq * hd), "wk": dense(L, d, Hkv * hd),
         "wv": dense(L, d, Hkv * hd), "wo": dense(L, Hq * hd, d)}
    if cfg.qkv_bias:
        a.update(bq=zeros(L, Hq * hd), bk=zeros(L, Hkv * hd),
                 bv=zeros(L, Hkv * hd))
    return a


def init_decoder(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random init on the generator's device, layers stacked on axis 0.
    Softcap configs carry the sandwich norms ``ln1_post`` / ``ln2_post``;
    a tied config has no ``lm_head`` (the head is ``embed.T``); an MoE
    config's ``mlp`` is the router and expert bank (``init_moe_params``,
    the bank (L, tp, E_loc, d, f_loc))."""
    dtype = torch_dtype(cfg.dtype)
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=gen.device)

    def dense(*shape, in_axis=-2):
        return dense_init(gen, shape, in_axis=in_axis, dtype=dtype)

    a = _init_attn(dense, zeros, cfg)
    embed = embed_init(gen, (cfg.padded_vocab, d), dtype)
    if cfg.moe is not None:
        mlp = moe_lib.init_moe_params(gen, d, cfg.moe, dtype=dtype,
                                      stack=(L,))
    else:
        mlp = {"w_gate": dense(L, d, ff), "w_up": dense(L, d, ff),
               "w_down": dense(L, ff, d)}
    params = {
        "embed": embed,
        "layers": {"ln1": zeros(L, d), "ln2": zeros(L, d), "attn": a,
                   "mlp": mlp},
        "final_norm": zeros(d),
    }
    if cfg.attn_softcap:   # gemma2's sandwich norms travel with softcap
        params["layers"].update(ln1_post=zeros(L, d), ln2_post=zeros(L, d))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.padded_vocab)
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer tree (views, no copies)."""
    def pick(tree):
        return ({k: pick(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[i])
    return pick(params["layers"])


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _local_flags(cfg: ModelConfig) -> list[bool]:
    """Which layers use the sliding window (gemma2: the even layers)."""
    if cfg.local_global_period:
        return [i % cfg.local_global_period == 0
                for i in range(cfg.n_layers)]
    return [False] * cfg.n_layers


def _layer_window(cfg: ModelConfig, is_local: bool) -> int | None:
    """A layer's window: under gemma2-style alternation the window or
    ``1 << 30`` (unbounded) on global layers; the window for uniform
    sliding-window attention; None for full attention."""
    if cfg.local_global_period:
        return cfg.sliding_window if is_local else 1 << 30
    return cfg.sliding_window or None


def _rope_q_k(cfg: ModelConfig, q, k, positions, extras):
    """Apply rotary embeddings to q and k: M-RoPE over
    ``extras["mrope_positions"]`` (B, 3, S) for mrope configs, else the
    first ``int(hd * rope_pct) // 2 * 2`` dims rotate and the rest pass
    through."""
    if cfg.mrope:
        pos3 = extras["mrope_positions"]
        return (apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections))
    hd = q.shape[-1]
    rot = int(hd * cfg.rope_pct) // 2 * 2                # even # of rotary dims
    if rot < hd:
        q = torch.cat([apply_rope(q[..., :rot], positions, cfg.rope_theta),
                       q[..., rot:]], dim=-1)
        k = torch.cat([apply_rope(k[..., :rot], positions, cfg.rope_theta),
                       k[..., rot:]], dim=-1)
        return q, k
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _qkv(h, pa, cfg: ModelConfig, positions, extras=None, taps=None):
    """Projections + bias + rotary: h (B, S, d) -> q (B, S, Hq, hd),
    k/v (B, S, Hkv, hd).  ``taps``: optional (S, seed) pairs by weight
    name (grad-fused training)."""
    B, S, _ = h.shape
    taps = taps or {}
    q, k, v = (maybe_tapped_matmul(h, pa[w], taps.get(w))
               for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + pa["bq"], k + pa["bk"], v + pa["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    q, k = _rope_q_k(cfg, q, k, positions, extras or {})
    return q, k, v


def gqa_block(x, p, cfg: ModelConfig, positions, window=None, extras=None,
              taps=None):
    """Causal GQA self-attention over the whole sequence -> ((B, S, d),
    (k, v)).  ``blocked_attention`` takes every query at once; the JAX
    package's query blocking changes no query's result.  ``taps`` as in
    :func:`_qkv`."""
    B, S, _ = x.shape
    q, k, v = _qkv(x, p, cfg, positions, extras, taps)
    out = attn.blocked_attention(q, k, v, window=window,
                                 softcap=cfg.attn_softcap,
                                 kv_block=cfg.kv_block)
    return maybe_tapped_matmul(out.reshape(B, S, cfg.n_heads * cfg.hd),
                               p["wo"], (taps or {}).get("wo")), (k, v)


def _mla_q(h, p, cfg: ModelConfig, positions):
    """MLA queries: (q_nope (B, S, H, dn), q_rope (B, S, H, dr)) through
    the q_lora bottleneck, q_rope rotated."""
    B, S, _ = h.shape
    m = cfg.mla
    dn = m.qk_nope_head_dim
    cq = rms_norm(h @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(B, S, cfg.n_heads,
                                 dn + m.qk_rope_head_dim)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_kv(h, p, cfg: ModelConfig, positions):
    """MLA's cached entries: the normed latent c_kv (B, S, kvr) and the
    shared rotated rope key (B, S, dr)."""
    c_kv = rms_norm(h @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((h @ p["w_kr"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_block(x, p, cfg: ModelConfig, positions):
    """MLA self-attention over the whole sequence -> ((B, S, d),
    (c_kv, k_rope)): the latent expanded into per-head K and V."""
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(x, p, cfg, positions)
    c_kv, k_rope = _mla_kv(x, p, cfg, positions)
    out = attn.mla_prefill_attention(
        q_nope, q_rope, c_kv, k_rope, p["w_uk"], p["w_uv"],
        softcap=cfg.attn_softcap, kv_block=cfg.kv_block)
    out = out.reshape(B, S, cfg.n_heads * cfg.mla.v_head_dim)
    return out @ p["wo"], (c_kv, k_rope)


def mlp_block(x, p, cfg: ModelConfig, taps=None, serving: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (y, aux loss () fp32): the MoE layer for MoE configs (no tap
    site), else dense SwiGLU, or GeGLU (tanh GELU) for softcap (gemma2)
    configs, with a zero aux; ``taps`` as in :func:`_qkv`."""
    if cfg.moe is not None:
        return moe_lib.moe_layer(x, p, cfg.moe, serving=serving)
    taps = taps or {}
    act = gelu if cfg.attn_softcap else F.silu

    def mm(h, w):
        return maybe_tapped_matmul(h, p[w], taps.get(w))

    return (mm(act(mm(x, "w_gate")) * mm(x, "w_up"), "w_down"),
            torch.zeros((), device=x.device))


def _residual(x, a, p, cfg: ModelConfig, mlp_taps=None,
              serving: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The rest of a layer after its attention output ``a``: x + a, then
    the MLP half, each branch through its sandwich norm where the layer
    has one (``ln1_post``, ``ln2_post``) -> (x, the MLP's aux loss)."""
    if "ln1_post" in p:
        a = rms_norm(a, p["ln1_post"], cfg.norm_eps)
    x = x + a
    f, aux = mlp_block(rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"], cfg,
                       mlp_taps, serving)
    if "ln2_post" in p:
        f = rms_norm(f, p["ln2_post"], cfg.norm_eps)
    return x + f, aux


def _layer(x, p, cfg: ModelConfig, positions, window, extras, taps=None):
    """One whole-sequence layer -> (x, its fresh cache entries, aux)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    taps = taps or {}
    if cfg.attn_type == "mla":
        a, kv = mla_block(h, p["attn"], cfg, positions)
    else:
        a, kv = gqa_block(h, p["attn"], cfg, positions, window, extras,
                          taps.get("attn"))
    x, aux = _residual(x, a, p, cfg, taps.get("mlp"))
    return x, kv, aux


def _embed(params, tokens, cfg: ModelConfig, extras) -> torch.Tensor:
    """Token embeddings (B, S, d): scaled by sqrt(d_model) rounded to the
    params' dtype first (as ``jnp.asarray(math.sqrt(d), x.dtype)``: in
    bf16 sqrt(4608) = 67.88 becomes 68.0), then the vision stub's
    ``extras["vision_embeds"]`` (B, nv, d) over positions 0..nv-1."""
    x = params["embed"][tokens]
    if cfg.emb_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if cfg.vision_tokens and "vision_embeds" in extras:
        ve = extras["vision_embeds"].to(x.dtype)
        nv = ve.shape[1]
        if nv > x.shape[1]:
            raise ValueError(f"{nv} vision embeddings do not fit a "
                             f"sequence of {x.shape[1]} tokens")
        x = torch.cat([ve, x[:, nv:]], dim=1)
    return x


def _logits(params, x, cfg: ModelConfig, tap=None) -> torch.Tensor:
    """Logits over the PADDED vocabulary (greedy argmax takes that width):
    ``embed.T`` when tied (not a taggable leaf), then the final softcap."""
    head = params.get("lm_head")
    if head is None:
        logits = x @ params["embed"].mT
    else:
        logits = maybe_tapped_matmul(x, head, tap)
    return softcap(logits, cfg.final_softcap)


# ---------------------------------------------------------------------------
# Training forward (full sequence, under autograd)
# ---------------------------------------------------------------------------


def _unstack_layers(tree) -> list[dict]:
    """The stacked layer tree as one dict of views per layer.  ``unbind``
    (not per-layer indexing) so the backward stacks each leaf's per-layer
    gradients once instead of scattering every layer into a zeroed
    full-stack buffer."""
    if isinstance(tree, dict):
        per_key = {k: _unstack_layers(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, dim=0))


def _unstack_taps(layer_taps: dict, n_layers: int) -> list[dict]:
    """The stacked per-layer taps ``{"attn": {"wq": (S, seed), ...},
    "mlp": {...}}`` as one dict of (S_i, seed_i) views per layer, each
    site unbound once, so each layer's backward emits its own panel into
    the stacked seed's gradient."""
    out: list[dict] = [{} for _ in range(n_layers)]
    for grp, sites in layer_taps.items():
        for name, (S, seed) in sites.items():
            for i, pair in enumerate(zip(S.unbind(0), seed.unbind(0))):
                out[i].setdefault(grp, {})[name] = pair
    return out


# ``remat="dots"``: the counterpart of JAX's
# ``dots_with_no_batch_dims_saveable``.  The projections x @ W are 2-D
# products (``matmul`` folds the batch into rows), so their outputs are
# saved; the attention's batched products (``bmm``) and all elementwise
# work are recomputed in the backward.
DOTS_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_context():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(
        list(DOTS_SAVED_OPS))


def decoder_forward(params, tokens: torch.Tensor, cfg: ModelConfig,
                    extras=None, remat: str = "full", taps=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, Vp), aux loss () fp32, the
    MoE layers' summed over the stack; zero without MoE).

    ``extras``: the batch's other entries (``vision_embeds``,
    ``mrope_positions``).  ``remat="full"`` recomputes each layer in the
    backward (``torch.utils.checkpoint``, non-reentrant), as the JAX
    package's ``jax.checkpoint`` around the scanned block; ``"dots"``
    keeps the outputs of the layer's projections and recomputes the rest
    (a selective checkpoint, :data:`DOTS_SAVED_OPS`); ``"none"`` keeps
    every activation.

    ``taps`` (optional) mirrors the taggable part of ``params``:
    ``{"layers": {"attn": {"wq": (S, seed), ...}, "mlp": {...}},
    "lm_head": (S, seed)}``, layer entries stacked on axis 0.  Those
    matmuls run through :func:`repro_torch.models.common.tapped_matmul`,
    whose backward emits the SubTrack projection statistics as the seeds'
    gradients.  Without taps the model is the plain one."""
    if remat not in ("full", "dots", "none"):
        raise NotImplementedError(f"remat={remat!r} is not yet ported to "
                                  "repro_torch (full, dots, none)")
    extras = extras or {}
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :]

    def block(x, p, lt, window):
        x, _, aux_l = _layer(x, p, cfg, positions, window, extras, lt)
        return x, aux_l

    x = _embed(params, tokens, cfg, extras)
    aux = torch.zeros((), device=x.device)
    taps = taps or {}
    per_layer = _unstack_layers(params["layers"])
    layer_taps = _unstack_taps(taps.get("layers", {}), len(per_layer))
    for p, lt, local in zip(per_layer, layer_taps, _local_flags(cfg)):
        window = _layer_window(cfg, local)
        if remat == "full":
            x, aux_l = torch.utils.checkpoint.checkpoint(
                block, x, p, lt, window, use_reentrant=False)
        elif remat == "dots":
            x, aux_l = torch.utils.checkpoint.checkpoint(
                block, x, p, lt, window, use_reentrant=False,
                context_fn=_dots_context)
        else:
            x, aux_l = block(x, p, lt, window)
        aux = aux + aux_l
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg, taps.get("lm_head")), aux


def decoder_loss(params, batch: dict, cfg: ModelConfig,
                 remat: str = "full", taps=None):
    """(ce + aux, {"ce_loss", "aux_loss"}): next-token cross entropy over
    the real vocabulary, the last position masked, plus the forward's aux
    loss (MoE load balance and z losses).  The batch's entries other
    than ``tokens`` are the forward's extras; ``taps`` as in
    :func:`decoder_forward`."""
    tokens = batch["tokens"]
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    logits, aux = decoder_forward(params, tokens, cfg, extras, remat, taps)
    labels, mask = shift_labels(tokens)
    loss = cross_entropy(logits, labels, mask, cfg.vocab_size)
    return loss + aux, {"ce_loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Dense serving: prefill into a per-slot cache + single-token decode
# ---------------------------------------------------------------------------


@dataclass
class DecoderCache:
    """The dense serving cache.  ``kv`` (a KVCache, or an MLACache for
    MLA configs) is written in place by every program; ``length``, the
    number of valid positions, is a host int, so a decode step never
    reads it back from the device."""

    kv: attn.KVCache | attn.MLACache
    length: int


def _cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Ring-buffer length: pure sliding-window configs cap the cache at
    the window."""
    return min(max_len, cfg.sliding_window) if _uses_ring(cfg) else max_len


def _uses_ring(cfg: ModelConfig) -> bool:
    """Pure sliding-window configs (mixtral) serve from a ring buffer:
    decode writes position p into slot p % T."""
    return bool(cfg.sliding_window and not cfg.local_global_period)


def _init_cache(cfg: ModelConfig, batch: int, T: int, dtype, device):
    if cfg.attn_type == "mla":
        return attn.init_mla_cache(cfg.n_layers, batch, T,
                                   cfg.mla.kv_lora_rank,
                                   cfg.mla.qk_rope_head_dim, dtype, device)
    return attn.init_kv_cache(cfg.n_layers, batch, T, cfg.n_kv_heads,
                              cfg.hd, dtype, device)


def init_decoder_cache(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device=None) -> DecoderCache:
    """An empty cache of ``_cache_len`` slots (bf16 by default, as the JAX
    package's): K/V and position tags, or MLA's latent and rope keys."""
    kv = _init_cache(cfg, batch, _cache_len(cfg, max_len), dtype, device)
    return DecoderCache(kv=kv, length=0)


def _prefill_positions(S: int, T: int, device=None) -> torch.Tensor:
    """Position tags (T,) int32 after prefilling S tokens into a length-T
    (ring) cache."""
    slots = torch.arange(T, dtype=torch.int32, device=device)
    if S <= T:
        return torch.where(slots < S, slots, -1)
    # ring: slot i holds the latest position congruent to i (mod T)
    last_full = (S - 1) // T * T
    return torch.where(slots <= (S - 1) % T, last_full + slots,
                       last_full - T + slots)


def _fit_cache(arr: torch.Tensor, T: int, S: int) -> torch.Tensor:
    """Fit fresh per-layer K/V (B, S, ...) into a length-T cache buffer."""
    if S <= T:
        return attn.pad_to(arr, T)
    # S > T (ring): keep the last T entries, rolled so slot = pos % T
    return torch.roll(arr[:, S - T:], shifts=S % T, dims=1)


def decoder_prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
                    max_len: int, extras=None
                    ) -> tuple[torch.Tensor, DecoderCache]:
    """Prefill S tokens of a batch -> (last-position logits (B, Vp), the
    populated cache).  ``extras`` as in :func:`decoder_forward`.  The
    cache holds K/V (MLA: the latent and the rope keys) in the activation
    dtype, as the JAX program's does."""
    extras = extras or {}
    B, S = tokens.shape
    T = _cache_len(cfg, max_len)
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None, :]
    x = _embed(params, tokens, cfg, extras)
    kv = _init_cache(cfg, B, T, x.dtype, dev)
    dst = ((kv.c_kv, kv.k_rope) if cfg.attn_type == "mla"
           else (kv.k, kv.v))
    for i, local in enumerate(_local_flags(cfg)):
        x, fresh, _ = _layer(x, layer_params(params, i), cfg, positions,
                             _layer_window(cfg, local), extras)
        for buf, arr in zip(dst, fresh):
            buf[i] = _fit_cache(arr, T, S)
    if cfg.attn_type != "mla":
        # slot i holds absolute position i (the ring matters only once S > T)
        kv.positions.copy_(_prefill_positions(S, T, dev).expand(
            cfg.n_layers, T))
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], DecoderCache(kv=kv, length=S)


def _mla_decode(h, pa, cfg: ModelConfig, kv: attn.MLACache, i: int,
                positions, pos: int) -> torch.Tensor:
    """Layer ``i``'s MLA decode: write the token's latent and rope key at
    ``pos`` (past the cache, into its last slot, as XLA's clamped
    ``dynamic_update_slice``) and attend in the latent space."""
    B = h.shape[0]
    q_nope, q_rope = _mla_q(h, pa, cfg, positions)
    c_new, kr_new = _mla_kv(h, pa, cfg, positions)
    c_c, kr_c = kv.c_kv[i], kv.k_rope[i]
    slot = min(pos, c_c.shape[1] - 1)
    c_c[:, slot] = c_new[:, 0].to(c_c.dtype)
    kr_c[:, slot] = kr_new[:, 0].to(kr_c.dtype)
    out = attn.mla_decode_attention(q_nope[:, 0], q_rope[:, 0], c_c, kr_c,
                                    pa["w_uk"], pa["w_uv"], pos,
                                    softcap=cfg.attn_softcap)
    return out.reshape(B, 1, -1) @ pa["wo"]


def decoder_decode_step(params, cache: DecoderCache, token: torch.Tensor,
                        cfg: ModelConfig, extras=None
                        ) -> tuple[torch.Tensor, DecoderCache]:
    """One decode step: token (B,) at position ``cache.length``.  Writes the
    token's cache entries in place and returns (logits (B, Vp), the cache
    one position longer).  ``extras``: ``mrope_positions`` (B, 3, 1) for
    mrope configs.  Local layers attend over their window of the full
    cache; a pure sliding-window config writes its ring (slot pos % T)."""
    extras = extras or {}
    B = token.shape[0]
    pos = cache.length
    kv = cache.kv
    positions = torch.full((B, 1), pos, device=token.device)
    x = _embed(params, token[:, None], cfg, {})                    # (B, 1, d)
    for i, local in enumerate(_local_flags(cfg)):
        p = layer_params(params, i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if cfg.attn_type == "mla":
            a = _mla_decode(h, p["attn"], cfg, kv, i, positions, pos)
        else:
            q, k, v = _qkv(h, p["attn"], cfg, positions, extras)
            attn.cache_write(kv.k[i], kv.v[i], kv.positions[i], k, v, pos,
                             ring=_uses_ring(cfg))
            out = attn.decode_attention(
                q[:, 0], kv.k[i], kv.v[i], pos,
                cache_positions=kv.positions[i],
                window=_layer_window(cfg, local), softcap=cfg.attn_softcap)
            a = out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
        x, _ = _residual(x, a, p, cfg, serving=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], DecoderCache(kv=kv, length=pos + 1)


# ---------------------------------------------------------------------------
# Paged serving: block-table prefill chunks + batched decode
# ---------------------------------------------------------------------------


def paged_supported(cfg: ModelConfig) -> tuple[bool, str]:
    """Whether the paged serving path can run this config: the JAX
    package's answer (the plain GQA decoder, partial rotary, QKV bias and
    MoE MLPs included; features that change the attention pattern or the
    cache contents go to the dense path)."""
    if cfg.family != "decoder":
        return False, f"family {cfg.family!r} has no paged cache layout"
    if cfg.attn_type == "mla":
        return False, "MLA latent cache not yet paged (ROADMAP follow-up)"
    if cfg.mrope or cfg.vision_tokens:
        return False, "multimodal position handling not paged"
    if cfg.sliding_window or cfg.local_global_period:
        return False, "sliding-window masks not paged"
    if cfg.attn_softcap:
        return False, "logit softcap not fused into the paged kernel"
    return True, ""


def _paged_scatter(kp, vp, k_new, v_new, blk, off) -> None:
    """Write per-token K/V into pool blocks, in place.

    kp/vp: (nb, bs, Hkv, hd); k_new/v_new: (N, Hkv, hd); blk/off: (N,)
    int64.  Duplicate (blk, off) pairs occur only for tokens aimed at the
    null block 0 (dead decode lanes, prefill pad tokens past the table);
    on CUDA which duplicate lands is unspecified, which is harmless only
    because block 0 is never read unmasked.
    """
    kp[blk, off] = k_new.to(kp.dtype)
    vp[blk, off] = v_new.to(vp.dtype)


def decoder_prefill_chunk_paged(params, pool: attn.PagedKV,
                                tokens: torch.Tensor, table: torch.Tensor,
                                ctx_len: int, cfg: ModelConfig
                                ) -> torch.Tensor:
    """Prefill one chunk of one prompt into the paged pool (in place).

    tokens: (1, c) int — the engine pads the last chunk to ``c``; table:
    (W,) int32, the request's block table padded with the null block;
    ``ctx_len``: tokens already prefilled.  Returns logits (1, c, Vp) over
    the whole chunk, so the host can read the last real prompt position of
    a padded final chunk.

    Attending over the whole gathered table is correct: gathered slot i
    holds absolute position i for every live slot, and every garbage slot
    (null-block padding, stale pool contents past the chunk's end) sits at
    a position past the last query, so the causal mask with
    ``q_offset=ctx_len`` removes it.  Writes need one guard the mask cannot
    give: a padded final chunk can run past the table (ceil(P/c)*c > W*bs),
    and those pad tokens are routed to the null block explicitly.
    """
    c = tokens.shape[1]
    W = table.shape[0]
    bs = pool.block_size
    dev = tokens.device
    p_abs = ctx_len + torch.arange(c, device=dev)                # (c,)
    word = p_abs // bs
    tbl = table.long()
    blk = torch.where(word < W, tbl[word.clamp(max=W - 1)],
                      torch.zeros_like(word))
    off = p_abs % bs
    positions = p_abs[None, :]                                   # (1, c)
    x = _embed(params, tokens, cfg, {})                           # (1, c, d)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        kp, vp = pool.k[i], pool.v[i]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(h, p["attn"], cfg, positions)
        _paged_scatter(kp, vp, k[0], v[0], blk, off)
        kg = kp[tbl].reshape(1, W * bs, cfg.n_kv_heads, cfg.hd)
        vg = vp[tbl].reshape(1, W * bs, cfg.n_kv_heads, cfg.hd)
        # one KV block over the whole gathered table: the JAX program uses
        # kv_block=bs; only the summation order differs
        out = attn.blocked_attention(q, kg, vg, q_offset=ctx_len,
                                     kv_block=W * bs)
        x, _ = _residual(x, out.reshape(1, c, cfg.n_heads * cfg.hd)
                         @ p["attn"]["wo"], p, cfg, serving=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)


def decoder_decode_step_paged(params, pool: attn.PagedKV,
                              token: torch.Tensor, lengths: torch.Tensor,
                              tables: torch.Tensor, live: torch.Tensor,
                              cfg: ModelConfig) -> torch.Tensor:
    """One decode wave over a batch of paged sequences (pool in place).

    token: (B,) int last sampled tokens; lengths: (B,) int32 tokens already
    in each sequence's cache (the new token's position); tables: (B, W)
    int32 block tables padded with the null block; live: (B,) bool — dead
    lanes write to the null block and attend over zero keys, so their
    attention output is exactly zero.  Returns logits (B, Vp).
    """
    B = token.shape[0]
    W = tables.shape[1]
    bs = pool.block_size
    dev = token.device
    lengths = lengths.int()
    word = (lengths // bs).long()
    # a lane past its table (the engine never sends one) writes to the null
    # block rather than aliasing table[W-1]; the kernel then outputs NaN
    # for it, since its length exceeds W*bs
    blk = torch.where(live & (word < W), tables.long()[
        torch.arange(B, device=dev), word.clamp(max=W - 1)], 0)
    off = torch.where(live, lengths % bs, 0).long()
    attend = torch.where(live, lengths + 1, 0).int()               # (B,)
    positions = lengths[:, None]                                   # (B, 1)
    x = _embed(params, token[:, None], cfg, {})                    # (B, 1, d)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        kp, vp = pool.k[i], pool.v[i]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(h, p["attn"], cfg, positions)
        _paged_scatter(kp, vp, k[:, 0], v[:, 0], blk, off)
        out = kernel_ops.paged_attention(q[:, 0].contiguous(), kp, vp,
                                         tables, attend)
        x, _ = _residual(x, out.reshape(B, 1, cfg.n_heads * cfg.hd)
                         @ p["attn"]["wo"], p, cfg, serving=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0]
