"""Checkpoint-facing state descriptors on one device.

Counterpart of the descriptor part of ``repro.core.program``: a
:class:`StateDescriptor` records how one optimizer-state leaf is laid out,
so a checkpoint written under one program (rank, method, regime) can be
transposed onto another on restore (``repro_torch.checkpoint.transpose``).
On one device every low-rank leaf runs the replicated program (the grass
basis its own ``grass`` regime, as in the JAX package), with one shard
and no collective; the StepProgram IR itself, its regimes and its rounds
come with the multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import plan as plan_lib


@dataclass(frozen=True)
class StateDescriptor:
    """Serializable per-leaf record of one optimizer-state leaf's layout.

    ``kind`` is "lowrank" (a MatrixOptState leaf) or "dense".  For
    low-rank leaves ``m, n, rank`` are the canonical (post-transpose)
    dims and ``method`` the refresh family (a dense basis, or "grass"'s
    one-hot row selection); the layout fields mirror the JAX package's
    StepProgram, and their defaults are what every regime on one device
    uses.  A descriptor is a leaf of the descriptor tree."""

    kind: str                     # "lowrank" | "dense"
    regime: str = "replicated"
    axes: tuple = ()
    shards: int = 1
    grad_layout: str = "replicated"
    state_layout: str = "inherit"
    schedule: str = "tangent"
    m: int = 0
    n: int = 0
    rank: int = 0
    batch_dims: int = 0
    method: str = "grassmann"

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "regime": self.regime,
            "axes": [str(a) for a in self.axes], "shards": int(self.shards),
            "grad_layout": self.grad_layout,
            "state_layout": self.state_layout, "schedule": self.schedule,
            "m": int(self.m), "n": int(self.n), "rank": int(self.rank),
            "batch_dims": int(self.batch_dims), "method": self.method,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StateDescriptor":
        return cls(kind=d["kind"], regime=d.get("regime", "replicated"),
                   axes=tuple(d.get("axes", ())),
                   shards=int(d.get("shards", 1)),
                   grad_layout=d.get("grad_layout", "replicated"),
                   state_layout=d.get("state_layout", "inherit"),
                   schedule=d.get("schedule", "tangent"),
                   m=int(d.get("m", 0)), n=int(d.get("n", 0)),
                   rank=int(d.get("rank", 0)),
                   batch_dims=int(d.get("batch_dims", 0)),
                   method=d.get("method", "grassmann"))


def descriptor_for(plan: plan_lib.ParamPlan, cfg) -> StateDescriptor:
    """One leaf's StateDescriptor on one device."""
    if plan.mode != "lowrank":
        return StateDescriptor(kind="dense")
    method = getattr(cfg, "method", "grassmann")
    regime = "grass" if method == "grass" else "replicated"
    return StateDescriptor(kind="lowrank", regime=regime, m=plan.m,
                           n=plan.n, rank=plan.rank,
                           batch_dims=plan.batch_dims, method=method)


def state_leaf_descriptors(params, cfg):
    """Tree mirroring ``params`` of per-leaf :class:`StateDescriptor`.
    ``cfg`` is any optimizer config; one without a ``rank`` (the dense
    baselines) gives all-dense descriptors."""
    rank = getattr(cfg, "rank", 0)

    def walk(p, plan):
        if isinstance(p, dict):
            return {k: walk(v, None if plan is None else plan[k])
                    for k, v in p.items()}
        return (StateDescriptor(kind="dense") if plan is None
                else descriptor_for(plan, cfg))

    return walk(params, plan_lib.make_plans(params, rank) if rank else None)
