"""Synthetic LM token source: a Zipf marginal with a Markov skeleton.

Counterpart of ``repro.data.pipeline``: the serving driver's prompts and
the training driver's batches (with the vision stub's inputs for
vision configs and the speech stub's frames for the encoder-decoder),
with the host-side batch validation.  A
batch is a pure function of ``(seed, step)``: every draw comes from a
``torch.Generator`` seeded from
those two numbers, where the JAX package folds them into a threefry key.
So the structure is the same (Zipf-skewed marginal; with probability
``markov_strength`` token t+1 is a fixed function of token t) but the
tokens differ from the JAX package's.  Tokens are made on the CPU,
in bulk, and the caller moves them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1       # marginal skew
    markov_strength: float = 0.7  # P(next token = f(prev)) — learnable structure
    n_patterns: int = 4096        # size of the deterministic skeleton table


class SyntheticLMDataset:
    """Stateless synthetic corpus: ``global_batch_at(step)``."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # deterministic Markov successor table (the JAX package's, same seed)
        rng = np.random.RandomState(cfg.seed)
        self._succ = torch.as_tensor(
            rng.randint(0, cfg.vocab_size, size=(cfg.n_patterns,)),
            dtype=torch.int64)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_alpha)
        probs /= probs.sum()
        self._cdf = torch.as_tensor(np.cumsum(probs), dtype=torch.float32)

    def global_batch_at(self, step: int) -> dict:
        """Global batch ``step``: {"tokens": (global_batch, seq_len)}."""
        cfg = self.cfg
        shape = (cfg.global_batch, cfg.seq_len)
        gen = torch.Generator().manual_seed(cfg.seed * 1_000_003 + step)
        u = torch.rand(shape, generator=gen)
        base = torch.searchsorted(self._cdf, u).clamp_(max=cfg.vocab_size - 1)
        follow = torch.rand(shape, generator=gen) < cfg.markov_strength
        tokens = torch.empty_like(base)
        tokens[:, 0] = base[:, 0]
        for t in range(1, cfg.seq_len):
            succ = self._succ[tokens[:, t - 1] % cfg.n_patterns] \
                % cfg.vocab_size
            tokens[:, t] = torch.where(follow[:, t - 1], succ, base[:, t - 1])
        return {"tokens": tokens}


VISION_SEED = 7   # the JAX package folds each step into PRNGKey(7)
                  # for either stub


def batch_for_model(model_cfg, shape, dataset: SyntheticLMDataset,
                    step: int) -> dict:
    """The full train batch for a model: the tokens (all a decoder,
    zamba or xlstm config takes), and the modality stubs' inputs, from a
    ``torch.Generator`` seeded per step (other numbers than the JAX
    package's threefry draws, as the tokens are): for a vision config
    ``vision_embeds`` (B, vision_tokens, d), 0.02 N(0, 1) in bf16, and
    ``mrope_positions`` (B, 3, S) int32 with t = h = w = the text
    position; for the encoder-decoder ``frames`` (B, S, d), 0.1 N(0, 1)
    in bf16, the speech front end's stub."""
    batch = dataset.global_batch_at(step)
    B, S = batch["tokens"].shape
    gen = torch.Generator().manual_seed(VISION_SEED * 1_000_003 + step)
    if model_cfg.vision_tokens:
        batch["vision_embeds"] = (0.02 * torch.randn(
            (B, model_cfg.vision_tokens, model_cfg.d_model),
            generator=gen)).to(torch.bfloat16)
        pos = torch.arange(S, dtype=torch.int32).expand(B, S)
        batch["mrope_positions"] = torch.stack([pos, pos, pos], dim=1)
    if model_cfg.family == "encdec":
        batch["frames"] = (0.1 * torch.randn(
            (B, S, model_cfg.d_model), generator=gen)).to(torch.bfloat16)
    return batch


# ---------------------------------------------------------------------------
# Resilient batch fetch
# ---------------------------------------------------------------------------


class BatchError(RuntimeError):
    """A fetched batch failed validation (corrupt tokens)."""


def validate_batch(batch: dict, vocab_size: int) -> None:
    """Host-side gate before any embedding lookup: token ids must be
    integers in [0, vocab_size).  XLA clamps an out-of-range index
    silently; torch raises on the CPU and asserts on the device, so the
    check runs first, on the host copy."""
    toks = batch.get("tokens")
    if toks is None:
        raise BatchError("batch has no 'tokens' entry")
    if toks.is_floating_point() or toks.is_complex() \
            or toks.dtype == torch.bool:
        raise BatchError(f"tokens dtype {toks.dtype} is not integral")
    lo, hi = int(toks.min()), int(toks.max())
    if lo < 0 or hi >= vocab_size:
        raise BatchError(
            f"token ids outside [0, {vocab_size}): min={lo} max={hi}")


def fetch_batch(model_cfg, dataset: SyntheticLMDataset, step: int, *,
                retries: int = 3, backoff_s: float = 0.01,
                mutate=None) -> tuple[dict | None, bool]:
    """Fetch + validate global batch ``step`` with bounded retry.

    Returns ``(batch, ok)``; a batch that still fails after ``retries``
    retries (exponential backoff with jitter) returns ``(None, False)``,
    a skip marker for the loop.  ``mutate`` is applied to the assembled
    batch before validation on every attempt."""
    import random
    import time as _time

    err: Exception | None = None
    for attempt in range(retries + 1):
        try:
            batch = batch_for_model(model_cfg, None, dataset, step)
            if mutate is not None:
                batch = mutate(batch)
            validate_batch(batch, model_cfg.vocab_size)
            return batch, True
        except (BatchError, OSError, ValueError) as e:
            err = e
            if attempt < retries:
                _time.sleep(backoff_s * (2 ** attempt)
                            * (1.0 + random.random()))
    print(f"[data] batch {step} unusable after {retries + 1} attempts "
          f"({type(err).__name__}: {err}) — returning skip marker",
          flush=True)
    return None, False


def corrupt_tokens(batch: dict) -> dict:
    """The corrupt-batch injection: one token id pushed out of range."""
    bad = batch["tokens"].clone()
    bad[0, 0] = 2 ** 30
    return dict(batch, tokens=bad)
