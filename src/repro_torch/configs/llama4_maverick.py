"""llama4-maverick-400b-a17b [moe] — 128-expert top-1 MoE + shared expert.
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Per the assignment line every layer is MoE (128 routed experts, top-1
sigmoid gate) with one always-on shared expert of the same width — the
Maverick routed/shared split.  Early-fusion multimodality is out of scope
for the text backbone (DESIGN.md §3).
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="decoder",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192,
                  n_shared_experts=1, shared_d_ff=8192,
                  capacity_factor=1.25),
    rope_theta=500000.0,
)
