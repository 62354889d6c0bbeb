"""gemma2-27b [dense] — local/global alternating attention, logit softcaps.
46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118; hf]  head_dim 128, window 4096 on local (even) layers,
attn softcap 50, final softcap 30, GeGLU, sandwich norms, sqrt(d) embed
scale.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="decoder",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_period=2,
    emb_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
)
