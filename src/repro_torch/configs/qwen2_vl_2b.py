"""qwen2-vl-2b [vlm] — M-RoPE, dynamic-resolution vision (frontend STUB).
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
[arXiv:2409.12191; hf]

The vision tower is a stub: the batch (``data.pipeline.batch_for_model``)
supplies precomputed patch embeddings (1024 tokens/sample for the training shape, the dynamic-
resolution budget of the 2B release) merged into the prefix positions.
M-RoPE sections (16, 24, 24) over head_dim/2 = 64 frequency slots.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="decoder",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    vision_tokens=1024,
    rope_theta=1000000.0,
)
