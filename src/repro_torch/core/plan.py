"""Per-parameter planning: decide, from static shape alone, how each leaf of
the parameter tree is optimized.

Counterpart of ``repro.core.plan`` (its one-device part).  Layer stacks
are leading-axis-stacked tensors (``(L, m, n)``); every trailing 2-D slice
is an independent matrix with its own tracked subspace, and the optimizer
runs batched over the leading stack dims (the JAX package ``vmap``s).
The sharding-spec and regime helpers come with the multi-GPU slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ParamPlan:
    """Static optimization plan for one parameter leaf.

    mode:        "lowrank" (projected optimizer) or "dense" (plain Adam).
    transpose:   whether the trailing 2-D slice is transposed so that
                 m <= n (paper w.l.o.g. convention; left-projection).
    batch_dims:  number of leading stack dims.
    m, n:        post-transpose trailing matrix dims (m <= n).
    rank:        effective projection rank for this leaf.
    """

    mode: str
    transpose: bool
    batch_dims: int
    m: int
    n: int
    rank: int


def plan_for_shape(shape: tuple[int, ...], rank: int,
                   min_dim: int = 2) -> ParamPlan:
    """Scalars/vectors and any matrix whose smaller trailing dim is <= rank
    use dense Adam; larger trailing 2-D slices are projected at
    ``min(rank, smaller_dim)`` (GaLore's rule, which the paper adopts)."""
    if len(shape) < min_dim:
        return ParamPlan("dense", False, 0, 0, 0, 0)
    a, b = shape[-2], shape[-1]
    small = min(a, b)
    if small <= rank:
        return ParamPlan("dense", False, 0, 0, 0, 0)
    transpose = a > b
    m, n = (b, a) if transpose else (a, b)
    return ParamPlan(mode="lowrank", transpose=transpose,
                     batch_dims=len(shape) - 2, m=m, n=n,
                     rank=min(rank, small))


def make_plans(params, rank: int):
    """Tree of ParamPlan mirroring ``params`` (nested dicts of tensors)."""
    if isinstance(params, dict):
        return {k: make_plans(v, rank) for k, v in params.items()}
    return plan_for_shape(tuple(params.shape), rank)


def canonical_grad(g: torch.Tensor, plan: ParamPlan) -> torch.Tensor:
    """Orient the gradient so the trailing slice is (m, n) with m <= n.
    A transposed plan returns a strided view, not a copy."""
    return g.transpose(-1, -2) if plan.transpose else g


def uncanonical_update(u: torch.Tensor, plan: ParamPlan) -> torch.Tensor:
    """Undo :func:`canonical_grad` so the update matches the parameter."""
    return u.transpose(-1, -2) if plan.transpose else u


def matrix_count(plan: ParamPlan, shape: tuple[int, ...]) -> int:
    """Number of independent (m, n) matrices a leaf contributes."""
    if plan.batch_dims == 0:
        return 1
    return int(math.prod(shape[:plan.batch_dims]))


def state_bytes(plan: ParamPlan, shape: tuple[int, ...]) -> int:
    """fp32 optimizer-state bytes this leaf costs (paper Table 2)."""
    if plan.mode == "dense":
        return 2 * int(math.prod(shape)) * 4
    stack = int(math.prod(shape[:-2])) if plan.batch_dims else 1
    per_matrix = plan.m * plan.rank + 2 * plan.rank * plan.n + 1
    return stack * per_matrix * 4
