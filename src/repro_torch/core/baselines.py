"""Full-rank and block-coordinate baselines (paper Tables 1/8/9).

Counterpart of ``repro.core.baselines``.  Both share the
:class:`repro_torch.core.subtrack.GradientTransform` protocol, including
``update(..., taps=, with_health=, eta_scale=)``,
so the training loop treats every optimizer alike; ``warm_start`` is a
no-op for both, their health diagnostic is always zero (no subspace), and
neither launches a kernel (dense Adam is plain array code in the JAX
package too).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.core import health as health_lib
from repro_torch.core.lowrank_adam import (AdamHP, dense_adam_step,
                                           init_dense_state)
from repro_torch.core.subtrack import (GradientTransform, OptState,
                                       tree_leaves, tree_map)


@dataclass(frozen=True)
class AdamWConfig:
    adam: AdamHP = field(default_factory=AdamHP)
    weight_decay: float = 0.0


@dataclass(frozen=True)
class BAdamConfig:
    adam: AdamHP = field(default_factory=AdamHP)
    weight_decay: float = 0.0
    block_interval: int = 100  # paper Table 10 "Block Switch Interval"
    n_blocks: int = 8


def _jax_leaf_sizes(tree, prefix=()) -> list[tuple[tuple, int]]:
    """(key path, element count) of every leaf, in the JAX package's
    flattening order, which sorts dict keys at every level (the port's
    trees keep insertion order).  BAdam numbers its blocks by this
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _jax_leaf_sizes(tree[k], prefix + (k,))]
    return [(prefix, tree.numel())]


def _dense_transform(cfg, is_active: Callable[[int, int], bool],
                     stored: Callable[[list[int]], int]
                     ) -> GradientTransform:
    """Dense Adam over the leaves ``is_active(jax_leaf_index, step)``
    picks; the others keep their moments and get a zero update (an exact
    rewrite of the JAX package's ``where``).  ``stored(sizes)``: the
    elements whose two fp32 moments the method must keep, ``sizes`` in the
    JAX leaf order."""
    hp = cfg.adam

    def init(params) -> OptState:
        return OptState(step=0, n_updates=0, inner=tree_map(
            lambda p: init_dense_state(tuple(p.shape), device=p.device),
            params))

    def warm_start(state: OptState, grads) -> OptState:
        return state

    def update(grads, state: OptState, params, lr: float,
               do_subspace_update: bool = False, *, taps=None,
               with_health: bool = False, eta_scale: float = 1.0):
        """(updates, new_state[, diag]); updates are added to the params,
        and an inactive leaf's is None (no update, where the JAX package
        adds zeros).  ``grads`` is consumed: each leaf's entry is set to
        None once its update exists.  ``state`` is never written.
        ``taps`` and ``eta_scale`` are accepted for the protocol and
        ignored (a dense leaf has nothing to tap and no subspace);
        ``with_health`` adds the all-zero diagnostic."""
        step = state.step
        lr32 = torch.tensor(lr, dtype=torch.float32)
        index = {path: i for i, (path, _) in
                 enumerate(_jax_leaf_sizes(params))}

        def leaf(path, g, st, p):
            if not is_active(index[path], step):
                return None, st
            delta, new_st = dense_adam_step(g, st, step, hp)
            upd = (-lr32 * delta).to(p.dtype)
            if cfg.weight_decay:
                upd = upd - (lr32 * cfg.weight_decay * p.float()).to(p.dtype)
            return upd, new_st

        def walk(prefix, grads, inner, params):
            updates, states = {}, {}
            for k, p in params.items():
                if isinstance(p, dict):
                    updates[k], states[k] = walk(prefix + (k,), grads[k],
                                                 inner[k], p)
                    continue
                updates[k], states[k] = leaf(prefix + (k,), grads[k],
                                             inner[k], p)
                grads[k] = None                     # release it now
            return updates, states

        updates, inner = walk((), grads, state.inner, params)
        new_state = OptState(step=step + 1, n_updates=state.n_updates,
                             inner=inner)
        if not with_health:
            return updates, new_state
        return updates, new_state, health_lib.zero_diag(
            tree_leaves(params)[0].device)

    def state_bytes(params) -> int:
        return 2 * 4 * stored([n for _, n in _jax_leaf_sizes(params)])

    return GradientTransform(init=init, warm_start=warm_start, update=update,
                             state_bytes=state_bytes, config=cfg)


def adamw(**overrides) -> GradientTransform:
    """Full-rank AdamW, the paper's "Full-Rank" row.  The GaLore-style
    ``AdamHP.scale`` does not apply here (plain AdamW)."""
    cfg = AdamWConfig(**overrides)
    return _dense_transform(cfg, lambda i, step: True, sum)


def badam(**overrides) -> GradientTransform:
    """BAdam-style block coordinate descent (Luo et al., 2024).

    Leaves are dealt round-robin into ``n_blocks`` blocks by their index in
    the JAX package's leaf order; every ``block_interval`` steps the active
    block advances, and only its leaves are updated and decay their
    moments.  As in the JAX package every block's moments stay allocated;
    ``state_bytes`` reports true BAdam's, which stores one block's."""
    cfg = BAdamConfig(**overrides)

    def is_active(i: int, step: int) -> bool:
        return i % cfg.n_blocks == (step // cfg.block_interval) % cfg.n_blocks

    def largest_block(sizes: list[int]) -> int:
        return max(sum(s for i, s in enumerate(sizes) if i % cfg.n_blocks == b)
                   for b in range(min(cfg.n_blocks, len(sizes))))

    return _dense_transform(cfg, is_active, largest_block)
