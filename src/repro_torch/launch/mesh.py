"""Mesh construction over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``.  The port is multi-controller:
``torchrun`` starts one process per rank, and the driver initialises the
default process group (NCCL on the card, gloo when the caller asks for
the CPU) before it builds a context here.  The CPU tests hand
:func:`host_context` a process group of their own instead (threads over
one store).  Failover (``MeshLostError``, ``SimulatedDeviceLoss``,
``degraded_context``) is not ported yet.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.distributed.context import MeshContext

PROD_SHAPE = (16, 16)
MULTIPOD_SHAPE = (2, 16, 16)


def smoke_context() -> MeshContext:
    """The one-rank (1, 1) mesh."""
    return MeshContext()


def host_context(limit: int | None = None, *, group=None) -> MeshContext:
    """The (1, N) mesh: every rank on the ``model`` axis, the ``data``
    axis of size 1.  Built over ``group`` when one is given (any process
    group object: N = its size), else over the initialised default world.
    ``limit`` (``--mesh-devices``) must be 0, None or N: a mesh over part
    of the world waits for failover."""
    if group is None:
        if not dist.is_initialized():
            raise RuntimeError("host_context: torch.distributed is not "
                               "initialised and no process group was given")
        group = dist.group.WORLD
        size, rank = dist.get_world_size(), dist.get_rank()
    else:
        size, rank = group.size(), group.rank()
    if limit and limit != size:
        raise NotImplementedError(
            f"--mesh-devices {limit} on a world of {size} ranks: a mesh over "
            "part of the world is not yet ported (it waits for failover)")
    return MeshContext(axis_sizes=(1, size), coords=(0, rank),
                       groups={"model": group} if size > 1 else {},
                       world=group if size > 1 else None)


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
