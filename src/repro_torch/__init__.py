"""PyTorch + CUDA port of the SubTrack++ system, for NVIDIA Hopper (H100).

It mirrors the layout of the JAX package ``repro`` (``models/``,
``serve/``, ``kernels/``, ``launch/``, ``data/``, ``configs/``) so each
counterpart is easy to find, but imports neither JAX nor ``repro``: the
JAX package is the reference the port is tested against, and only the
tests import both.

Ported so far: the paged serving path of the decoder family
(``python -m repro_torch.launch.serve``), with the paged-attention decode
kernel hand-written in CUDA C++ for ``sm_90a`` (``csrc/``).

Entry points run on CUDA unless the caller asks for the CPU; without a
card and without that request they raise instead of falling back.
"""
