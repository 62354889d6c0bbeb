"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.
24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206
[arXiv:2308.11596; hf]

24 encoder + 24 decoder layers (the assignment's 24L applies to each
stack).  The speech frontend is a STUB: the encoder takes precomputed
frame embeddings (B, S, d).  Decode shapes use a 4096-frame encoder
memory with the decoder-side KV cache at the shape's seq_len.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=48,
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    audio_frontend=True,
    enc_memory_len=4096,
)
