"""Token sampling for the serving engine.

Counterpart of ``repro.serve.sampling``.  Greedy is argmax over the full
(padded) vocabulary width, as in the JAX package, so greedy tokens can be
compared token for token.  Temperature sampling draws from a
``torch.Generator`` seeded per call from ``(seed, n_samples)`` — the
counterpart of folding the call count into a JAX key — so no two steps
reuse one draw and a run is reproducible.  Its draws differ from JAX's.
"""

from __future__ import annotations

import torch

_MIX = 0x9E3779B97F4A7C15          # 64-bit golden-ratio multiplier


def sample_tokens(logits: torch.Tensor, temperature: float, seed: int,
                  n_samples: int) -> torch.Tensor:
    """logits (B, V) -> (B,) int64.  temperature <= 0 is greedy argmax
    (seed unused); otherwise categorical at logits / temperature."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    gen = torch.Generator(device=logits.device)
    gen.manual_seed((seed * _MIX + n_samples) % (1 << 64))
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]
