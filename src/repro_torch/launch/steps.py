"""Train-step factories for the training driver (counterpart of
``repro.launch.steps``, one device).

The train step is loss and gradient -> global-norm clip -> optimizer
update -> apply.  ``do_subspace_update`` is a Python bool picked per step
by the loop.  Where the JAX step returns new arrays, the port updates in
place to stay inside one card's memory at llama-7b: the clip scales the
gradients in place, and the optimizer adds each leaf's update into its
parameter as soon as it is computed (``update(..., apply=True)``), so no
tree of updates is ever held.  Not ported yet: gradient accumulation, the
grad-fused taps, fault injection and the quarantine gate
(``guarded_apply``) of the health runtime.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.subtrack import (GradientTransform, OptState,
                                       tree_leaves, tree_map)
from repro_torch.models.api import ModelBundle


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def _unflatten(like, leaves: list) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, accumulated in fp32."""
    total = sum(torch.linalg.vector_norm(x, dtype=torch.float32) ** 2
                for x in tree_leaves(tree))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / ||grads||), in place.  A
    bf16 gradient is scaled in fp32 and rounded back, as the JAX package's
    ``(g.astype(f32) * scale).astype(g.dtype)``.  Returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, norm


def value_and_grad(bundle: ModelBundle, params, batch, remat: str):
    """(loss, metrics, grads) with grads mirroring ``params``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = bundle.loss(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, _unflatten(params, list(grads))


def make_train_step(bundle: ModelBundle, optimizer: GradientTransform, *,
                    clip_norm: float = 1.0, remat: str = "full"):
    """train_step(state, batch, lr, *, do_subspace_update=False) ->
    (state, metrics).  The parameters of ``state`` are updated in place;
    the returned state carries them and the new optimizer state."""

    def train_step(state: TrainState, batch, lr: float, *,
                   do_subspace_update: bool = False):
        loss, metrics, grads = value_and_grad(bundle, state.params, batch,
                                              remat)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        with torch.no_grad():
            _, opt = optimizer.update(grads, state.opt, state.params, lr,
                                      do_subspace_update=do_subspace_update,
                                      apply=True)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return TrainState(params=state.params, opt=opt), metrics

    return train_step


def make_warm_start(bundle: ModelBundle, optimizer: GradientTransform,
                    remat: str = "full"):
    """warm_start(state, batch) -> (state, loss): installs S_0 from the
    first gradient and surfaces the warm-start loss."""

    def warm(state: TrainState, batch):
        loss, _, grads = value_and_grad(bundle, state.params, batch, remat)
        with torch.no_grad():
            opt = optimizer.warm_start(state.opt, grads)
        return TrainState(params=state.params, opt=opt), loss

    return warm


def default_rank(d_model: int) -> int:
    """Rank ladder for archs without a paper rank (as the JAX package)."""
    if d_model >= 6144:
        return 1024
    if d_model >= 2048:
        return 512
    if d_model >= 1024:
        return 256
    return 128
