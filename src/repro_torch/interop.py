"""Parameters and optimizer state from the JAX package, as the port's
tensors.

The JAX package keeps parameters as a pytree of arrays with the layer
stack on axis 0 and weights stored ``(in, out)`` for ``x @ w``; the port
keeps the same schema (:func:`repro_torch.models.transformer.init_decoder`),
so the conversion is a tree map.  The caller hands over numpy arrays
(``jax.tree.map(np.asarray, params)``): this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import torch_dtype


def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    # numpy has no bfloat16 of its own (JAX's is ml_dtypes'): go via fp32,
    # which holds every bf16 value exactly
    t = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
    return t.to(device=device, dtype=dtype)


def params_from_jax(params_np, cfg: ModelConfig, device="cpu") -> dict:
    """JAX params (nested dicts of numpy arrays) -> port params on
    ``device``: a leaf whose JAX array is fp32 stays fp32 (an MoE router,
    Mamba's ``A_log``, ``D`` and ``dt_bias``, as the JAX package draws
    them), every other leaf takes ``cfg.dtype``."""
    dtype = torch_dtype(cfg.dtype)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree, torch.float32
                       if np.asarray(tree).dtype == np.float32 else dtype,
                       device)

    return conv(params_np)


def opt_state_from_jax(state_np, device="cpu"):
    """JAX ``OptState`` (step, n_updates, and a tree of per-leaf
    ``MatrixOptState`` / ``DenseOptState`` holding numpy arrays, e.g.
    ``jax.tree.map(np.asarray, state)``) -> the port's ``OptState``, fp32 on
    ``device``, so both packages can start from the same S, M and V."""
    from repro_torch.core.lowrank_adam import DenseOptState, MatrixOptState
    from repro_torch.core.subtrack import OptState

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        fields = getattr(node, "_fields", ())
        cls = MatrixOptState if "S" in fields else DenseOptState
        return cls(*(_tensor(getattr(node, f), torch.float32, device)
                     for f in cls._fields))

    return OptState(step=int(state_np.step),
                    n_updates=int(state_np.n_updates),
                    inner=conv(state_np.inner))
