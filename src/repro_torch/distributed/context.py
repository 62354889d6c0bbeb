"""Mesh context: the one piece of global distribution state.

Counterpart of ``repro.distributed.context``.  Where the JAX package holds
a ``jax.sharding.Mesh``, a :class:`MeshContext` here holds the mesh's axis
names and sizes, this rank's coordinate along each axis, and one
``torch.distributed`` process group per axis of size > 1 (plus one over
the whole mesh).  Launchers build it (``repro_torch.launch.mesh``); the
default is the one-rank (1, 1) mesh with no group at all.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class MeshContext:
    """A logical device mesh as this rank sees it.

    ``groups`` maps an axis name to the process group of the ranks that
    share every other coordinate with this one (None for an axis of size
    1, or everywhere on a context built only to plan layouts); ``world``
    is the group over every rank of the mesh (the warm start's broadcast,
    the health gate's verdict), None on one rank.  A host mesh also keeps
    that group at any size as ``pg`` (the checkpoints' step agreement,
    and what a failover aborts), the world ranks of its ranks in mesh
    order as ``members``, and the ``new_group(ranks)`` factory that builds
    a group over some of those world ranks (``launch/mesh.py``)."""

    axis_names: tuple = ("data", "model")
    axis_sizes: tuple = (1, 1)
    coords: tuple = (0, 0)
    batch_axes: tuple = ("data",)
    model_axis: str = "model"
    groups: dict = field(default_factory=dict, compare=False)
    world: Any = field(default=None, compare=False)
    pg: Any = field(default=None, compare=False)
    members: tuple = field(default=(), compare=False)
    new_group: Any = field(default=None, compare=False)

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def rank(self) -> int:
        """This rank's row-major index over the whole mesh."""
        return self.axis_index(self.axis_names)

    @property
    def tp(self) -> int:
        return self.shape[self.model_axis]

    @property
    def dp(self) -> int:
        return math.prod(self.shape[a] for a in self.batch_axes)

    def expert_layout(self, n_experts: int, d_ff: int) -> tuple[int, int, int]:
        """(ep, experts_per_rank, ff_shard) of the MoE bank's physical
        (tp, E_loc, d, f_loc) layout: ep = gcd(E, tp) expert groups of the
        model axis, each tensor-sharding its experts' hidden dim tp/ep
        ways.  Only tp = 1 is ported, where it is (1, E, d_ff); a larger
        model axis waits for the tensor-parallel forward."""
        if self.tp > 1:
            raise NotImplementedError(
                f"MoE layers over a model axis of {self.tp} ranks are not "
                "yet ported to repro_torch (the tensor-parallel forward)")
        ep = math.gcd(n_experts, self.tp)
        return ep, n_experts // ep, d_ff

    def batch_spec(self, *rest) -> tuple:
        """Spec with the batch dim over all pure-DP axes."""
        return (self.batch_axes,) + rest

    def axis_index(self, axes) -> int:
        """This rank's row-major index along ``axes`` (a name or a tuple)."""
        axes = axes if isinstance(axes, tuple) else (axes,)
        idx = 0
        for a in axes:
            i = self.axis_names.index(a)
            idx = idx * self.axis_sizes[i] + self.coords[i]
        return idx

    def group(self, axes):
        """The process group over ``axes`` (a name or a tuple).  Axes of
        size 1 add nothing; a group over two axes that both have more than
        one rank is not built by any context yet."""
        axes = axes if isinstance(axes, tuple) else (axes,)
        big = [a for a in axes if self.shape[a] > 1]
        if not big:
            return None
        if len(big) > 1:
            raise NotImplementedError(
                f"a process group over the axes {tuple(big)} together is "
                "not yet ported (no mesh of this slice has two axes of "
                "more than one rank)")
        group = self.groups.get(big[0])
        if group is None:
            raise ValueError(f"mesh axis {big[0]!r} of size "
                             f"{self.shape[big[0]]} has no process group "
                             "(a context built only for planning)")
        return group


def abstract_context(axis_sizes: tuple,
                     axis_names: tuple = ("data", "model"),
                     batch_axes: tuple = ("data",)) -> MeshContext:
    """A context with the mesh's shape and no process group: enough to
    plan layouts and programs (``hotpath_param_specs``, ``build_program``),
    as the JAX package's ``AbstractMesh``."""
    return MeshContext(axis_names=tuple(axis_names),
                       axis_sizes=tuple(axis_sizes),
                       coords=(0,) * len(axis_sizes),
                       batch_axes=tuple(batch_axes))


_CURRENT: MeshContext | None = None


def get_mesh_context() -> MeshContext:
    global _CURRENT
    if _CURRENT is None:
        _CURRENT = MeshContext()
    return _CURRENT


def set_mesh_context(ctx: MeshContext | None) -> None:
    global _CURRENT
    _CURRENT = ctx


@contextlib.contextmanager
def mesh_context(ctx: MeshContext):
    """Install ``ctx`` for the duration of a block."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx
    try:
        yield ctx
    finally:
        _CURRENT = prev


def shard(x, *spec):
    """The JAX package's sharding constraint: the identity here.  The
    port's forward and backward run whole on every rank (the data axis
    has size 1 and the tensor-parallel forward is not ported), so a model
    tensor has no layout to constrain."""
    del spec
    return x
