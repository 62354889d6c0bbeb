"""xlstm-125m [ssm] — sLSTM + mLSTM blocks.
12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304
[arXiv:2405.04517; unverified]

xLSTM[3:1] layout: every 4th block is an sLSTM (positions 3, 7, 11), the
rest are mLSTMs.  d_ff=0 per the assignment — blocks carry their own
projections (mLSTM pre-up x2, sLSTM post-FFN x4/3).
"""

from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="xlstm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=4, mlstm_proj_factor=2.0,
                      slstm_proj_factor=4.0 / 3.0, conv_kernel=4, chunk=64),
)
