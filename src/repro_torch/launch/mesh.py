"""Mesh construction over ``torch.distributed``, and the failover's mesh
surgery.

Counterpart of ``repro.launch.mesh``.  The port is multi-controller:
``torchrun`` starts one process per rank, and the driver initialises the
default process group (NCCL on the card, gloo when the caller asks for
the CPU) before it builds a context here.  The CPU tests hand
:func:`host_context` a process group of their own instead (threads over
one store, :func:`store_group_factory`).

The failover pieces live here too: :class:`MeshLostError` (a collective
that raised or hung past the step deadline), :class:`SimulatedDeviceLoss`
(the ``--inject dev-loss`` fault surface), :func:`degraded_context` (the
``(1, n)`` host mesh rebuilt over the surviving ranks, so every
StepProgram's admissibility runs again on the smaller group) and
:func:`abort_group` (the old group is aborted before the new one is
built: work left queued on it, by a hung collective or an abandoned
step, must not block the survivors).

A "device" of the JAX package is a rank here.  A mesh's ranks carry
their world ranks (``MeshContext.members``); survivors are world ranks,
renumbered contiguously in the new mesh, and a rank outside them gets no
context (``None``): ``launch/train.py`` then leaves the run cleanly.  A
new group is never a collective over the old world, which holds the lost
rank: the context's ``new_group`` factory builds it from its members alone
(``dist.new_group(ranks, use_local_synchronization=True)`` on a torchrun
world, a fresh gloo group over a shared store in the threaded harness).
"""

from __future__ import annotations

import datetime
import itertools
import math
import time

import torch.distributed as dist

from repro_torch.distributed.context import MeshContext

PROD_SHAPE = (16, 16)
MULTIPOD_SHAPE = (2, 16, 16)


class MeshLostError(RuntimeError):
    """A rank left the mesh: a collective raised or hung past the step
    deadline.  Carries the surviving world ranks when the detector knows
    them (the simulator always does; a real runtime error leaves None and
    the failover takes a configured survivor count).  Distinct from the
    numerical fault ladder: the logical state is not suspect, only the
    topology is."""

    def __init__(self, message: str, survivors: list | None = None,
                 step: int | None = None):
        super().__init__(message)
        self.survivors = list(survivors) if survivors is not None else None
        self.step = step


class SimulatedDeviceLoss:
    """Host-side stand-in for a lost mesh participant (``--inject
    dev-loss@N``).  ``raise`` mode fails at dispatch (a dead participant
    surfaces as an error on the calling thread); ``hang`` mode blocks the
    drain (a collective that never completes), which the step deadline
    must turn into :class:`MeshLostError` on its own.  Every rank arms the
    same simulator, so survivors and lost ranks reach the same verdict at
    the same step.

    An armed loss stays armed (a lost rank stays lost) until the failover
    rebuilds the mesh from the survivors and calls :meth:`disarm`."""

    def __init__(self):
        self.fail_step: int | None = None
        self.survivors: list = []
        self.mode = "raise"
        self.hang_s = 30.0

    @property
    def armed(self) -> bool:
        return self.fail_step is not None

    def arm(self, step: int, survivors, mode: str = "raise",
            hang_s: float = 30.0) -> None:
        self.fail_step = step
        self.survivors = list(survivors)
        self.mode = mode
        self.hang_s = hang_s

    def disarm(self) -> None:
        self.fail_step = None

    def check(self, step: int, where: str) -> None:
        """Called at dispatch and drain; raises or hangs from the fault
        step on."""
        if self.fail_step is None or step < self.fail_step:
            return
        if self.mode == "hang":
            if where != "drain":
                return          # a hung collective only shows at the sync
            time.sleep(self.hang_s)
            raise MeshLostError(
                f"simulated hung collective at step {step} (device loss)",
                survivors=self.survivors, step=step)
        raise MeshLostError(
            f"simulated failed collective at step {step}: device subset "
            f"left the mesh ({len(self.survivors)} survivors)",
            survivors=self.survivors, step=step)


def world_group_factory(timeout: datetime.timedelta | None = None):
    """``new_group(ranks)`` on the initialised default world: a group over
    those world ranks that only they take part in building."""
    def new_group(ranks):
        kw = {} if timeout is None else {"timeout": timeout}
        return dist.new_group(sorted(ranks), use_local_synchronization=True,
                              **kw)

    return new_group


def store_group_factory(store, prefix: str, rank: int,
                        timeout: datetime.timedelta):
    """``new_group(ranks)`` for ranks that each build their own gloo group
    over one shared store (threads of one process: the CPU tests).  Every
    call takes a fresh key prefix; the members of a group call their
    factories in the same order, so they meet under the same prefix.
    ``rank`` is the calling rank's world rank."""
    calls = itertools.count()

    def new_group(ranks):
        ranks = sorted(ranks)
        return dist.ProcessGroupGloo(
            dist.PrefixStore(f"{prefix}/{next(calls)}", store),
            ranks.index(rank), len(ranks), timeout)

    return new_group


def abort_group(pg) -> str:
    """Abort a process group this rank is leaving behind, so that work
    queued on it cannot block the next one; the name of the call that did
    it.  A group the default world registered goes through
    ``distributed_c10d._abort_process_group`` (which also unregisters
    it), any other through its own ``abort``."""
    from torch.distributed import distributed_c10d as c10d

    if pg in c10d._world.pg_map:
        c10d._abort_process_group(pg)
        return "distributed_c10d._abort_process_group"
    pg.abort()
    return f"{type(pg).__name__}.abort"


def smoke_context() -> MeshContext:
    """The one-rank (1, 1) mesh."""
    return MeshContext()


def _host(n: int, rank: int, pg, members, new_group) -> MeshContext:
    return MeshContext(axis_sizes=(1, n), coords=(0, rank),
                       groups={"model": pg} if n > 1 else {},
                       world=pg if n > 1 else None, pg=pg,
                       members=tuple(members), new_group=new_group)


def host_context(limit: int | None = None, *, group=None,
                 new_group=None) -> MeshContext | None:
    """The (1, N) mesh: its ranks on the ``model`` axis, the ``data`` axis
    of size 1.  Built over ``group`` when one is given (any process group
    object), else over the initialised default world, where the mesh gets
    a group of its own (``new_group``, :func:`world_group_factory` by
    default) so that a failover can abort it and leave the world alone.
    ``limit`` (``--mesh-devices``) takes the first ``limit`` ranks only:
    a rank past them gets None.  A limit above the world raises."""
    if group is None:
        if not dist.is_initialized():
            raise RuntimeError("host_context: torch.distributed is not "
                               "initialised and no process group was given")
        size, rank = dist.get_world_size(), dist.get_rank()
        new_group = new_group or world_group_factory()
    else:
        size, rank = group.size(), group.rank()
    n = limit or size
    if n > size:
        raise ValueError(f"--mesh-devices {n} on a world of {size} ranks")
    if rank >= n:
        return None
    if group is None or n < size:
        if new_group is None:
            raise ValueError(f"a mesh over {n} of {size} ranks needs a "
                             "new_group factory")
        group = new_group(list(range(n)))
    return _host(n, rank, group, range(n), new_group)


def degraded_context(survivors, ctx: MeshContext) -> MeshContext | None:
    """Rebuild the ``(1, n)`` host mesh over the surviving world ranks
    after a :class:`MeshLostError`: the layout of :func:`host_context`, so
    re-planning (``hotpath_param_specs``, ``build_program``) runs the
    gates it ran at start-up on the smaller group, and the elastic
    restore places the logical state onto whatever programs come out.
    Survivors renumber contiguously in world-rank order.  None for a rank
    that is not a survivor.  ``ctx`` is the mesh being left: its group
    should be aborted first (:func:`abort_group`); its ``new_group``
    factory builds the new one."""
    survivors = sorted(survivors)
    if not survivors:
        raise ValueError("degraded_context: no surviving devices")
    me = ctx.members[ctx.rank] if ctx.members else ctx.rank
    if me not in survivors:
        return None
    if ctx.new_group is None:
        raise ValueError("degraded_context: the mesh has no new_group "
                         "factory to rebuild its group from")
    return _host(len(survivors), survivors.index(me),
                 ctx.new_group(survivors), survivors, ctx.new_group)


def make_context(*, multi_pod: bool = False) -> MeshContext:
    """The 16 x 16 (``data``, ``model``) or 2 x 16 x 16 (``pod``, ``data``,
    ``model``) production mesh over the initialised world, which must have
    exactly 256 or 512 ranks.  One process group per axis: the ranks that
    share every other coordinate (rank = row-major index)."""
    shape = MULTIPOD_SHAPE if multi_pod else PROD_SHAPE
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise NotImplementedError(
            f"--mesh {'multipod' if multi_pod else 'prod'} needs a world of "
            f"{need} ranks; this world has {world} (the production meshes "
            "on other worlds are not yet ported)")
    coords, rest = [], dist.get_rank()
    for size in reversed(shape):
        coords.append(rest % size)
        rest //= size
    coords = tuple(reversed(coords))
    groups = {names[ax]: _axis_group(shape, ax) for ax in range(len(shape))}
    return MeshContext(axis_names=names, axis_sizes=shape, coords=coords,
                       batch_axes=names[:-1], model_axis="model",
                       groups=groups, world=dist.group.WORLD)


def _axis_group(shape: tuple, ax: int):
    """This rank's group along axis ``ax`` of a row-major mesh over the
    default world: every rank enumerates all the axis's groups, as
    ``dist.new_subgroups_by_enumeration`` requires."""
    need = math.prod(shape)
    stride = math.prod(shape[ax + 1:])
    seen, lists = set(), []
    for r in range(need):
        base = r - ((r // stride) % shape[ax]) * stride
        if base in seen:
            continue
        seen.add(base)
        lists.append([base + i * stride for i in range(shape[ax])])
    group, _ = dist.new_subgroups_by_enumeration(lists)
    return group
