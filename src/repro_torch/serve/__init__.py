"""Paged serving engine: block-table KV cache + continuous batching.

Host-side policy lives here (allocator, engine loop, sampling); the
device programs it drives live in repro_torch.models.transformer and the
paged-attention CUDA kernel in repro_torch.kernels.
"""
