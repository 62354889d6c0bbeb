"""Config registry: ``--arch <id>`` resolution for the port's launchers.

Holds the paper's Llama pre-training ladder (Table 10) and the assigned
decoder configs the port's decoder builds: ``qwen1.5-4b`` (QKV bias),
``stablelm-12b`` (GQA kv=8, 25% partial rotary, head dim 160), and, as
config modules of their own (copies of ``repro.configs``'), ``gemma2-27b``
(local/global windows, softcaps, sandwich norms, GeGLU, tied and scaled
embeddings), ``minicpm3-4b`` (MLA), ``qwen2-vl-2b`` (M-RoPE, QKV bias,
the vision stub), ``mixtral-8x22b`` (8 experts top-2, a 4096 window on
every layer), ``llama4-maverick-400b-a17b`` (128 experts top-1 and a
shared expert), the hybrid ``zamba2-7b`` (81 Mamba2 layers and one
weight-shared attention + MLP block after every 9), ``xlstm-125m`` (9
mLSTM and 3 sLSTM blocks) and the encoder-decoder
``seamless-m4t-large-v2`` (24 + 24 layers, the speech front end a stub
of frame embeddings).  The numbers and the arch ids are those of
``repro.configs.registry`` and its config modules; any other arch id
raises ``ValueError``, as there.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduce_for_smoke

# assigned architecture id -> module (exact configs from the assignment)
_ARCH_MODULES = {
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
}


def _llama(name, layers, d, heads, ff) -> ModelConfig:
    """Paper Table 10 Llama-based pre-training architectures."""
    return ModelConfig(
        name=name, family="decoder", n_layers=layers, d_model=d,
        n_heads=heads, n_kv_heads=heads, d_ff=ff, vocab_size=32000,
        rope_theta=10000.0, vocab_round=64)


# paper's pre-training ladder (hidden/intermediate/heads/layers, Table 10)
_PAPER_MODELS = {
    "llama-60m": _llama("llama-60m", 8, 512, 8, 1376),
    "llama-130m": _llama("llama-130m", 12, 768, 12, 2048),
    "llama-350m": _llama("llama-350m", 24, 1024, 16, 2736),
    "llama-1b": _llama("llama-1b", 32, 2048, 24, 5461),
    "llama-3b": _llama("llama-3b", 32, 2560, 32, 6848),
    "llama-7b": _llama("llama-7b", 32, 4096, 32, 11008),
    # ~100M model for the end-to-end example driver
    "llama-100m": _llama("llama-100m", 12, 640, 10, 1708),
}

# paper Table 10 low-rank ranks per model size
PAPER_RANKS = {
    "llama-60m": 128, "llama-130m": 256, "llama-350m": 256,
    "llama-1b": 512, "llama-3b": 512, "llama-7b": 1024,
    "llama-100m": 128,
}

# assigned decoder archs on the paged serving path
_ASSIGNED = {
    # hf:Qwen/Qwen1.5-4B
    "qwen1.5-4b": ModelConfig(
        name="qwen1.5-4b", family="decoder", n_layers=40, d_model=2560,
        n_heads=20, n_kv_heads=20, d_ff=6912, vocab_size=151936,
        qkv_bias=True, rope_theta=1000000.0),
    # hf:stabilityai/stablelm-2-12b, partial rotary (25%)
    "stablelm-12b": ModelConfig(
        name="stablelm-12b", family="decoder", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, d_ff=13824, vocab_size=100352,
        rope_pct=0.25, rope_theta=10000.0),
}


def arch_names() -> list[str]:
    return sorted(list(_ASSIGNED) + list(_ARCH_MODULES) + list(_PAPER_MODELS))


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    """Resolve an architecture id; ``smoke=True`` returns the reduced
    same-family config used by CPU smoke tests."""
    if name in _ARCH_MODULES:
        cfg = importlib.import_module(_ARCH_MODULES[name]).CONFIG
    else:
        cfg = _ASSIGNED.get(name) or _PAPER_MODELS.get(name)
    if cfg is None:
        raise ValueError(f"unknown arch {name!r}; options: {arch_names()}")
    return reduce_for_smoke(cfg) if smoke else cfg
