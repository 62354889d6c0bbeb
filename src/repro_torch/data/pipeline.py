"""Synthetic LM token source: a Zipf marginal with a Markov skeleton.

Counterpart of ``repro.data.pipeline`` for what the serving driver draws
(``launch/serve.py`` prompts).  A batch is a pure function of
``(seed, step)``: every draw comes from a ``torch.Generator`` seeded from
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
