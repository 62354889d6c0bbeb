"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.
81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242; unverified]

81 Mamba2 layers with the weight-shared attention+MLP block applied every
9 layers (81 = 9 x 9 uniform groups; the released model interleaves two
shared blocks aperiodically).  The shared block consumes
concat(embeddings, hidden) through a 2d->d projection as in the paper.
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="zamba",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    attn_every=9,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk=128),
    rope_theta=10000.0,
)
