"""Model factory: one bundle per model family (training loss, dense and
paged serving).

Counterpart of ``repro.models.api``, for every family of the reference:
the decoder's ``init``, ``loss``, ``loss_taps``, its dense serving fields
(``prefill``, ``decode_step``, ``init_cache``) and its three paged
fields; the zamba, xlstm and encoder-decoder families' ``init``,
``loss`` and dense serving fields (no ``loss_taps`` and no paged fields,
as in the reference: the grad-fused backward falls back to the plain one
and serving to the dense engine).  As in the JAX package, the decoder's
prefill passes every batch entry but the tokens to the model
(``vision_embeds``, ``mrope_positions``), an mrope config's decode step
rotates the new token by ``cache.length`` on all three position
streams, the encoder-decoder's prefill encodes ``batch["frames"]``, and
its ``init_cache`` sizes the cross-attention cache at
``cfg.enc_memory_len``.  An unknown family raises ``ValueError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models import attention as attn
from repro_torch.models import encdec, transformer, xlstm, zamba
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Any]        # (generator, device=None) -> params
    loss: Callable[..., Any] | None = None   # (params, batch, remat=) -> (loss, metrics)
    # (params, batch, taps, remat=) -> (loss, metrics), ``taps`` the
    # grad-fused (S, seed) tree of transformer.decoder_forward
    loss_taps: Callable[..., Any] | None = None
    # Dense serving path (per-slot KV cache, written in place)
    prefill: Callable[..., Any] | None = None      # (params, batch, max_len) -> (logits, cache)
    decode_step: Callable[..., Any] | None = None  # (params, cache, token) -> (logits, cache)
    init_cache: Callable[..., Any] | None = None   # (batch, max_len, device) -> cache
    # Paged serving path (block-table KV; repro_torch.serve).  None for
    # configs the paged cache does not cover (transformer.paged_supported).
    init_paged_cache: Callable[..., Any] | None = None   # (num_blocks, block_size, device) -> PagedKV
    paged_prefill_chunk: Callable[..., Any] | None = None  # (params, pool, tokens, table, ctx_len) -> logits
    paged_decode_step: Callable[..., Any] | None = None  # (params, pool, token, lengths, tables, live) -> logits


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _decoder_bundle(cfg: ModelConfig) -> ModelBundle:
    def init(gen: torch.Generator, device=None):
        """Draw on the generator's device, then move: one seed gives the
        same weights whichever device serves them."""
        params = transformer.init_decoder(gen, cfg)
        return params if device is None else _to(params, torch.device(device))

    paged: dict[str, Any] = {}
    if transformer.paged_supported(cfg)[0]:
        paged = {
            "init_paged_cache": lambda num_blocks, block_size, device=None:
                attn.init_paged_kv(cfg.n_layers, num_blocks, block_size,
                                   cfg.n_kv_heads, cfg.hd,
                                   transformer.torch_dtype(cfg.dtype),
                                   device),
            "paged_prefill_chunk": lambda params, pool, tokens, table,
                ctx_len: transformer.decoder_prefill_chunk_paged(
                    params, pool, tokens, table, ctx_len, cfg),
            "paged_decode_step": lambda params, pool, token, lengths,
                tables, live: transformer.decoder_decode_step_paged(
                    params, pool, token, lengths, tables, live, cfg),
        }
    def loss(params, batch, remat="full"):
        return transformer.decoder_loss(params, batch, cfg, remat)

    def loss_taps(params, batch, taps, remat="full"):
        return transformer.decoder_loss(params, batch, cfg, remat, taps)

    def prefill(params, batch, max_len):
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        return transformer.decoder_prefill(params, batch["tokens"], cfg,
                                           max_len, extras)

    def decode_step(params, cache, token):
        extras = {}
        if cfg.mrope:
            extras["mrope_positions"] = torch.full(
                (token.shape[0], 3, 1), cache.length, dtype=torch.int32,
                device=token.device)
        return transformer.decoder_decode_step(params, cache, token, cfg,
                                               extras)

    def init_cache(batch, max_len, device=None):
        return transformer.init_decoder_cache(cfg, batch, max_len,
                                              device=device)

    return ModelBundle(cfg=cfg, init=init, loss=loss, loss_taps=loss_taps,
                       prefill=prefill, decode_step=decode_step,
                       init_cache=init_cache, **paged)


def _dense_only_bundle(cfg: ModelConfig, init_fn, loss_fn, prefill_fn,
                       decode_fn, cache_fn) -> ModelBundle:
    """A family with no taggable matmul and no paged layout (zamba, xlstm,
    the encoder-decoder): ``init``, ``loss`` and the dense serving fields
    from its model module's functions, each taking ``cfg``."""
    def init(gen: torch.Generator, device=None):
        params = init_fn(gen, cfg)
        return params if device is None else _to(params, torch.device(device))

    return ModelBundle(
        cfg=cfg, init=init,
        loss=lambda params, batch, remat="full": loss_fn(params, batch, cfg,
                                                         remat),
        prefill=lambda params, batch, max_len: prefill_fn(params, batch, cfg,
                                                          max_len),
        decode_step=lambda params, cache, token: decode_fn(params, cache,
                                                           token, cfg),
        init_cache=lambda batch, max_len, device=None: cache_fn(
            cfg, batch, max_len, device=device))


def _zamba_bundle(cfg: ModelConfig) -> ModelBundle:
    return _dense_only_bundle(
        cfg, zamba.init_zamba, zamba.zamba_loss,
        lambda params, batch, cfg_, max_len: zamba.zamba_prefill(
            params, batch["tokens"], cfg_, max_len),
        zamba.zamba_decode_step, zamba.init_zamba_cache)


def _xlstm_bundle(cfg: ModelConfig) -> ModelBundle:
    return _dense_only_bundle(
        cfg, xlstm.init_xlstm, xlstm.xlstm_loss,
        lambda params, batch, cfg_, max_len: xlstm.xlstm_prefill(
            params, batch["tokens"], cfg_, max_len),
        xlstm.xlstm_decode_step, xlstm.init_xlstm_cache)


def _encdec_bundle(cfg: ModelConfig) -> ModelBundle:
    return _dense_only_bundle(
        cfg, encdec.init_encdec, encdec.encdec_loss,
        lambda params, batch, cfg_, max_len: encdec.encdec_prefill(
            params, batch["frames"], batch["tokens"], cfg_, max_len),
        encdec.encdec_decode_step, encdec.init_encdec_cache)


_BUNDLES = {"decoder": _decoder_bundle, "zamba": _zamba_bundle,
            "xlstm": _xlstm_bundle, "encdec": _encdec_bundle}


def build_model(cfg: ModelConfig) -> ModelBundle:
    try:
        ctor = _BUNDLES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r}; "
                         f"options: {sorted(_BUNDLES)}") from None
    return ctor(cfg)
