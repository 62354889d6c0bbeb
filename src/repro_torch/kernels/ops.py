"""Dispatch over the port's hand-written kernels.

The rule is the tensor's device, nothing else: a CPU tensor runs the
kernel's plain-PyTorch oracle (:mod:`repro_torch.kernels.ref`); any other
tensor goes to the kernel wrapper, which launches the CUDA kernel or
raises.  A CUDA tensor never takes the oracle, and there is no shape gate.

Each kernel wrapper counts its launches in a plain integer
(``<wrapper>.launches``); :func:`launch_counts` reads them and
:func:`reset_launch_counts` zeroes them, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as paged
from repro_torch.kernels import ref

_WRAPPERS = {"paged_attention": paged.paged_attention}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Block-table decode attention -> (B, Hq, hd).  Kernel:
    ``csrc/paged_attention.cu``; oracle: ``ref.paged_attention_ref``."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                       lengths)
    return paged.paged_attention(q, k_pool, v_pool, block_tables, lengths)
