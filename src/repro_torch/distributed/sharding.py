"""Sharded layouts of the optimizer's hot path, and the shard / gather of
a tensor by a spec.

Counterpart of the hot-path part of ``repro.distributed.sharding``:
:func:`hotpath_param_specs` picks each low-rank leaf's regime (column or
row sharding, the row family ranked by its cheaper state flavour) by the
modeled per-rank bytes of the traffic model, with the JAX package's
candidates, gates and tie-breaks.  A spec is a plain tuple with one entry
per dim (an axis name, a tuple of names, or None).

Where the JAX package places an array with a ``NamedSharding`` and GSPMD
moves the bytes, the port's ranks each hold their shard:
:func:`local_view` takes this rank's shard of a whole tensor (a view, no
communication) and :func:`gather` all-gathers shards back into the whole
tensor over the process group of each sharded dim's axes.  The forward's
tensor-parallel layout (``param_specs`` / ``spec_for_path``), the state
and batch specs and the cache specs are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core import plan as plan_lib
from repro_torch.core import program as program_lib
from repro_torch.distributed.context import MeshContext
from repro_torch.kernels import traffic


def _row_bytes(m: int, n: int, r: int, size: int, regimes: tuple,
               row_state: str) -> int | None:
    """Modeled per-rank plain-step bytes of the row flavour the program
    will run (:func:`repro_torch.core.program.pick_row_flavor`, the call
    ``build_program`` makes); None when ``regimes`` excludes that
    flavour."""
    flavor = program_lib.pick_row_flavor(m, n, r, size, row_state)
    if flavor == "row-rs":
        return traffic.sharded_row_rs_fused_step_bytes(m, n, r, size).total
    if "row" not in regimes:
        return None
    return traffic.sharded_row_fused_step_bytes(m, n, r, size).total


def hotpath_param_specs(params_shape: Any, ctx: MeshContext, rank: int,
                        regimes: tuple = ("column", "row"),
                        row_state: str = "auto") -> Any:
    """Regime-aware layout of the fused optimizer hot path: per low-rank
    leaf, COLUMN sharding (canonical n over a mesh axis) or ROW sharding
    (canonical m), whichever the traffic model charges fewer per-rank
    fused-step bytes.  A column axis is admissible while n/g >= 2r, a row
    axis while m/g >= 2r; row leaves are ranked by the state flavour
    :func:`~repro_torch.core.program.pick_row_flavor` selects.  Ties go to
    column, then to the candidate order (``model`` before the data axes).
    Dense leaves replicate (spec ``()``).

    ``params_shape`` is a dict tree of anything with a ``shape``;
    ``regimes`` restricts the candidates (``--hotpath-layout``): "row"
    admits both state flavours, "row-rs" only the reduce-scatter one;
    ``row_state`` is the optimizer's ``LowRankConfig.row_state``."""
    candidates = (ctx.model_axis,) + tuple(ctx.batch_axes)

    def leaf(p):
        shape = tuple(p.shape)
        plan = plan_lib.plan_for_shape(shape, rank)
        if plan.mode != "lowrank":
            return ()
        # the canonical (m, n) dims back through the transpose convention
        n_dim = len(shape) - 2 if plan.transpose else len(shape) - 1
        m_dim = len(shape) - 1 if plan.transpose else len(shape) - 2
        best = None   # (bytes, regime order, candidate order, dim, axis)
        for ci, ax in enumerate(candidates):
            size = ctx.shape[ax]
            if size <= 1:
                continue
            if "column" in regimes and traffic.in_column_regime(
                    plan.n, size, plan.rank):
                by = traffic.sharded_fused_step_bytes(
                    plan.m, plan.n, plan.rank, size).total
                cand = (by, 0, ci, n_dim, ax)
                best = cand if best is None else min(best, cand)
            if ("row" in regimes or "row-rs" in regimes) \
                    and traffic.in_row_regime(plan.m, size, plan.rank):
                by = _row_bytes(plan.m, plan.n, plan.rank, size, regimes,
                                row_state)
                if by is not None:
                    cand = (by, 1, ci, m_dim, ax)
                    best = cand if best is None else min(best, cand)
        spec: list = [None] * len(shape)
        if best is not None:
            _, _, _, dim, ax = best
            spec[dim] = ax
        return tuple(spec)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return leaf(tree)

    return walk(params_shape)


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def local_view(x: torch.Tensor, spec, ctx: MeshContext) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` under ``spec``: a view
    (``narrow`` along each sharded dim), no communication.  Rank i along
    a dim's axes holds block i."""
    for dim, entry in enumerate(spec or ()):
        if entry is None:
            continue
        size = math.prod(ctx.shape[a] for a in _axes(entry))
        if size == 1:
            continue
        if x.shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {size} shards")
        step = x.shape[dim] // size
        x = x.narrow(dim, ctx.axis_index(_axes(entry)) * step, step)
    return x


def gather(x: torch.Tensor, spec, ctx: MeshContext) -> torch.Tensor:
    """The whole tensor from every rank's shard ``x`` under ``spec``: one
    all-gather per sharded dim over the group of its axes, block i from
    rank i (the port's counterpart of ``device_put`` with a
    ``NamedSharding``).  A spec with no sharded dim returns ``x``."""
    for dim, entry in enumerate(spec or ()):
        if entry is None:
            continue
        group = ctx.group(_axes(entry))
        if group is None:
            continue
        xt = x.movedim(dim, 0).contiguous()
        out = torch.empty((xt.shape[0] * group.size(),) + xt.shape[1:],
                          dtype=x.dtype, device=x.device)
        group._allgather_base(out, xt).wait()
        x = out.movedim(0, dim)
    return x


def broadcast(x: torch.Tensor, ctx: MeshContext, root: int = 0) -> None:
    """Overwrite ``x`` in place with rank ``root``'s over the whole mesh
    (nothing on a one-rank mesh)."""
    if ctx.world is None:
        return
    opts = dist.BroadcastOptions()
    opts.rootRank = root
    ctx.world.broadcast([x], opts).wait()
