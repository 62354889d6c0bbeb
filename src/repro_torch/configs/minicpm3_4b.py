"""minicpm3-4b [dense] — MLA attention.
62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448
[hf:openbmb/MiniCPM3-4B; hf]  MLA dims follow the released config
(q_lora 768, kv_lora 256, nope 64 / rope 32 / v 64 per head).
"""

from repro_torch.models.config import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="decoder",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    head_dim=64,
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    rope_theta=10000.0,
)
