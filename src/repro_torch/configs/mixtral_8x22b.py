"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2
[arXiv:2401.04088; hf]  Window 4096 on every layer => ring-buffered decode
caches and long_500k eligibility.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="decoder",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384, capacity_factor=1.25),
    rope_theta=1000000.0,
)
