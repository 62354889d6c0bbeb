"""Per-parameter planning: decide, from static shape alone, how each leaf of
the parameter tree is optimized.

Counterpart of ``repro.core.plan`` (its one-device part).  Layer stacks
are leading-axis-stacked tensors (``(L, m, n)``); every trailing 2-D slice
is an independent matrix with its own tracked subspace, and the optimizer
runs batched over the leading stack dims (the JAX package ``vmap``s).

A leaf's sharding spec is a plain tuple with one entry per dim: a mesh
axis name, a tuple of names, or None (the JAX package uses a
``PartitionSpec``).  The plan keeps it in the canonical (m, n)
orientation, and the regime helpers read the StepProgram regime off it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

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
    spec:        the leaf's sharding spec in the canonical orientation
                 (lead..., m axes, n axes), each entry None, an axis name
                 or a tuple of names; None when the caller gave no specs.
    """

    mode: str
    transpose: bool
    batch_dims: int
    m: int
    n: int
    rank: int
    spec: Any = None


def canonicalize_spec(spec: Any, ndim: int, transpose: bool) -> Any:
    """A leaf's spec (its own layout) -> the canonical hashable tuple:
    padded to ``ndim`` entries, the trailing two swapped when the plan
    transposes, so ``result[-2]`` / ``result[-1]`` are always the
    canonical m / n axes."""
    if spec is None:
        return None
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if transpose:
        entries = entries[:-2] + (entries[-1], entries[-2])
    return entries


def plan_for_shape(shape: tuple[int, ...], rank: int,
                   min_dim: int = 2, spec: Any = None) -> ParamPlan:
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
                     rank=min(rank, small),
                     spec=canonicalize_spec(spec, len(shape), transpose))


def make_plans(params, rank: int, specs=None):
    """Tree of ParamPlan mirroring ``params`` (nested dicts of tensors, or
    of anything with a ``shape``); ``specs``, when given, mirrors it with
    each leaf's spec tuple, canonicalized into the plan."""
    if isinstance(params, dict):
        return {k: make_plans(v, rank, None if specs is None else specs[k])
                for k, v in params.items()}
    return plan_for_shape(tuple(params.shape), rank, spec=specs)


def canonical_grad(g: torch.Tensor, plan: ParamPlan) -> torch.Tensor:
    """Orient the gradient so the trailing slice is (m, n) with m <= n.
    A transposed plan returns a strided view, not a copy."""
    return g.transpose(-1, -2) if plan.transpose else g


def uncanonical_update(u: torch.Tensor, plan: ParamPlan) -> torch.Tensor:
    """Undo :func:`canonical_grad` so the update matches the parameter."""
    return u.transpose(-1, -2) if plan.transpose else u


def bucket_key(plan: ParamPlan, param_dtype) -> tuple:
    """Leaves sharing this key could run as one stacked batch: the same
    canonical (m, n, rank), parameter dtype and canonical (m, n) sharding
    (stacking two layouts would reshard one of them).  The port runs every
    leaf on its own (``repro_torch.core.subtrack``); the key is kept for
    the same-shape bucketing that is queued."""
    mn_spec = None if plan.spec is None else plan.spec[-2:]
    return (plan.m, plan.n, plan.rank,
            str(param_dtype).removeprefix("torch."), mn_spec)


def spec_lead_sharded(plan: ParamPlan) -> bool:
    """True when any leading stack dim of the leaf is sharded: such a leaf
    takes no sharded program."""
    if plan.spec is None:
        return False
    return any(a is not None for a in plan.spec[:plan.batch_dims])


def spec_column_axes(plan: ParamPlan):
    """The axes the canonical n (column) dim is sharded over, as a tuple of
    names, or None unless the leaf is in the column regime (n sharded, m
    and every lead dim replicated)."""
    if plan.spec is None or plan.mode != "lowrank":
        return None
    m_ax, n_ax = plan.spec[-2], plan.spec[-1]
    if n_ax is None or m_ax is not None or spec_lead_sharded(plan):
        return None
    return n_ax if isinstance(n_ax, tuple) else (n_ax,)


def spec_row_axes(plan: ParamPlan):
    """The axes the canonical m (row) dim is sharded over, or None unless
    the leaf is in the row regime (m sharded, n and every lead dim
    replicated): each shard holds S (m/g, r) and G (m/g, n), and A = S^T G
    contracts over the sharded rows."""
    if plan.spec is None or plan.mode != "lowrank":
        return None
    m_ax, n_ax = plan.spec[-2], plan.spec[-1]
    if m_ax is None or n_ax is not None or spec_lead_sharded(plan):
        return None
    return m_ax if isinstance(m_ax, tuple) else (m_ax,)


def spec_regime(plan: ParamPlan):
    """'column' | 'row' | None: the sharded regime the leaf's canonical
    (m, n) sharding falls into (a leaf with both dims sharded is in
    neither)."""
    if spec_column_axes(plan) is not None:
        return "column"
    if spec_row_axes(plan) is not None:
        return "row"
    return None


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
