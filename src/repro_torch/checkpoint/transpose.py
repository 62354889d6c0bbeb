"""Layout-transposing checkpoint restore on one device.

Counterpart of ``repro.checkpoint.transpose`` (all but ``restore_targets``,
which restores sharded state and waits for the sharded restore).  Every
leaf is stored as its logical array, so a checkpoint written under one
program is portable to another: on save, :func:`state_program_records`
puts one :class:`~repro_torch.core.program.StateDescriptor` record per
optimizer-state node into the manifest's ``extra`` (key
``"state_programs"``, the source programs); on restore,
:func:`elastic_loader` lowers every (source, target) pair through
:func:`transpose_matrix_state`:

==============================  =========================================
pair                            work
==============================  =========================================
same method, same rank          identity, bit-exact (layout, regime and
                                group size never touch the arrays)
rank r_s -> r_t < r_s           truncate: the leading r_t basis columns
                                and their moment rows
rank r_s -> r_t > r_s           pad: complete the basis with the top
                                singular vectors of ``I - S S^T`` (grass:
                                one-hot columns of unselected rows); zero
                                moment rows
method * -> "grass"             S becomes the one-hot top-r_t row
                                selection by basis row energy, the
                                moments rotate with Q = S_new^T S_old
                                (paper Eq. 8-9)
method "grass" -> dense basis   identity
==============================  =========================================

Other pairs (canonical (m, n) changed, stack dims changed, a dense /
low-rank flip) raise :class:`TransposeError`, and
``CheckpointManager.restore`` falls back to the next restorable step.
The host math is numpy, as in the JAX package, on the same values.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import manager
from repro_torch.core.lowrank_adam import DenseOptState, MatrixOptState
from repro_torch.core.program import StateDescriptor

META_KEY = "state_programs"


class TransposeError(ValueError):
    """A (source program -> target program) pair with no lowering."""


def _is_state_node(x) -> bool:
    return isinstance(x, (MatrixOptState, DenseOptState))


def _state_nodes(tree, path=()) -> list[tuple[str, object]]:
    """(path, node) for every optimizer-state node of ``tree``, in JAX's
    flatten order (dict keys sorted, NamedTuple fields in order); the
    path is the JAX package's ``"opt/inner/layers/attn/wq"`` form."""
    if _is_state_node(tree):
        return [("/".join(path), tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _state_nodes(tree[k], path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree)
                for x in _state_nodes(v, path + (f,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _state_nodes(v, path + (str(i),))]
    return []


def descriptor_leaves(param_descs) -> list[StateDescriptor]:
    """The descriptors of a descriptor tree, in JAX's flatten order."""
    return [d for d in manager.tree_flatten(param_descs)
            if isinstance(d, StateDescriptor)]


def state_program_records(state_tree, param_descs) -> dict:
    """``extra_meta`` fragment recording each state node's source program:
    ``{"state_programs": [{"path": ..., **descriptor}, ...]}`` in node
    flatten order."""
    nodes = _state_nodes(state_tree)
    descs = descriptor_leaves(param_descs)
    if len(nodes) != len(descs):
        raise ValueError(
            f"{len(nodes)} optimizer-state nodes but {len(descs)} "
            "descriptors — descriptor tree does not mirror the params")
    return {META_KEY: [dict(path=path, **d.to_dict())
                       for (path, _), d in zip(nodes, descs)]}


def admissible(src: StateDescriptor, tgt: StateDescriptor) -> str | None:
    """None when (src -> tgt) lowers, else the human-readable reason."""
    if src.kind != tgt.kind:
        return (f"dense/low-rank mode changed ({src.kind} -> {tgt.kind}; "
                "a rank change crossed the dense gate)")
    if src.kind != "lowrank":
        return None
    if (src.m, src.n) != (tgt.m, tgt.n):
        return (f"canonical (m, n) changed: ({src.m}, {src.n}) -> "
                f"({tgt.m}, {tgt.n})")
    if src.batch_dims != tgt.batch_dims:
        return f"stack dims changed: {src.batch_dims} -> {tgt.batch_dims}"
    return None


# ---------------------------------------------------------------------------
# Per-leaf lowering
# ---------------------------------------------------------------------------


def _rotate_moments_np(Q, M, V):
    """Paper Eq. 8-9 with explicit Q = S_new^T S_old (no bias factor: a
    restore re-expresses the stored raw moments, it does not step)."""
    QM = Q @ M
    V_rot = np.abs((Q * Q) @ (V - M * M) + QM * QM)
    return QM, V_rot


def _grass_select(S, r_t: int):
    """One-hot top-``r_t`` row selection by basis row energy, descending."""
    m = S.shape[-2]
    energy = np.sum(S * S, axis=-1)                       # (..., m)
    idx = np.argsort(-energy, axis=-1, kind="stable")[..., :r_t]
    return np.swapaxes(np.eye(m, dtype=S.dtype)[idx], -1, -2)  # (..., m, r_t)


def _complete_basis(S, extra: int):
    """``extra`` orthonormal columns spanning the complement of S: the top
    singular vectors of ``I - S S^T``."""
    m = S.shape[-2]
    resid = np.eye(m, dtype=S.dtype) - S @ np.swapaxes(S, -1, -2)
    U = np.linalg.svd(resid)[0]
    return U[..., :extra]


def _pad_grass(S, extra: int):
    """One-hot columns for the lowest-index unselected rows (S stays a row
    selection)."""
    m = S.shape[-2]
    lead = S.shape[:-2]
    sel = np.argmax(S, axis=-2)                           # (..., r_s)
    out = np.zeros(lead + (m, extra), S.dtype)
    for li in np.ndindex(*lead) if lead else [()]:
        taken = set(int(i) for i in np.ravel(sel[li]))
        free = [i for i in range(m) if i not in taken][:extra]
        for j, i in enumerate(free):
            out[li + (i, j)] = 1.0
    return out


def transpose_matrix_state(st: MatrixOptState, src: StateDescriptor,
                           tgt: StateDescriptor) -> MatrixOptState:
    """Lower one MatrixOptState from its source program onto the target:
    the state itself (bit-exact) where the basis does not move, else new
    CPU tensors per the module table."""
    reason = admissible(src, tgt)
    if reason is not None:
        raise TransposeError(reason)
    S, M, V = (x.detach().cpu().numpy() for x in (st.S, st.M, st.V))
    lead = S.shape[:src.batch_dims]
    if S.shape != lead + (src.m, src.rank):
        raise TransposeError(
            f"stored S shape {S.shape} does not match its recorded "
            f"program (m={src.m}, r={src.rank}, lead={lead})")
    r_s, r_t = src.rank, tgt.rank
    to_grass = tgt.method == "grass" and src.method != "grass"
    if not to_grass and r_t == r_s:
        return st                                    # identity, bit-exact
    if to_grass:
        S_new = _grass_select(S, r_t)
        Q = np.swapaxes(S_new, -1, -2) @ S           # (..., r_t, r_s)
        M_new, V_new = _rotate_moments_np(Q, M, V)
    elif r_t < r_s:
        S_new = S[..., :, :r_t]
        M_new, V_new = M[..., :r_t, :], V[..., :r_t, :]
    else:
        pad = (_pad_grass(S, r_t - r_s) if tgt.method == "grass"
               else _complete_basis(S, r_t - r_s))
        S_new = np.concatenate([S, pad], axis=-1)
        zrows = np.zeros(M.shape[:-2] + (r_t - r_s, M.shape[-1]), M.dtype)
        M_new = np.concatenate([M, zrows], axis=-2)
        V_new = np.concatenate([V, zrows], axis=-2)
    return MatrixOptState(*(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (S_new, M_new, V_new)),
                          lam_prev=st.lam_prev)


def transpose_state(loaded, records: list[dict], param_descs):
    """Map every optimizer-state node of ``loaded`` (host tensors) from its
    recorded source program onto the target descriptors."""
    nodes = _state_nodes(loaded)
    descs = descriptor_leaves(param_descs)
    if not (len(nodes) == len(descs) == len(records)):
        raise TransposeError(
            f"state-node count mismatch: checkpoint records "
            f"{len(records)}, target descriptors {len(descs)}, "
            f"tree holds {len(nodes)}")
    new = {}
    for (_, leaf), rec, tgt in zip(nodes, records, descs):
        src = StateDescriptor.from_dict(rec)
        if isinstance(leaf, MatrixOptState):
            if src.kind != "lowrank" or tgt.kind != "lowrank":
                raise TransposeError(
                    f"node {rec.get('path')}: "
                    + (admissible(src, tgt) or "descriptor kind mismatch"))
            new[id(leaf)] = transpose_matrix_state(leaf, src, tgt)
        elif admissible(src, tgt) is not None:
            raise TransposeError(f"node {rec.get('path')}: "
                                 f"{admissible(src, tgt)}")

    def rebuild(x):
        if _is_state_node(x):
            return new.get(id(x), x)
        if isinstance(x, dict):
            return {k: rebuild(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(rebuild(v) for v in x))
        return x

    return rebuild(loaded)


def elastic_loader(param_descs):
    """``loader(path, like)`` for ``CheckpointManager.restore`` and
    ``rollback``: load on the host, transpose every state node from its
    recorded source program onto ``param_descs`` (the targets, from
    ``steps.checkpoint_descriptors`` for this run), check the result
    against ``like`` leaf for leaf, then place each leaf on the device of
    ``like``'s.  A checkpoint without records takes the plain
    identical-shape load."""

    def load(path, like):
        records = manager.load_manifest(path)["extra"].get(META_KEY)
        if records is None:
            return manager.load_pytree(path, like)
        host = manager.load_pytree(path, like, strict_shapes=False,
                                   host=True)
        tree = transpose_state(host, records, param_descs)
        got, want = manager.tree_flatten(tree), manager.tree_flatten(like)
        for g, w in zip(got, want):
            if manager._shape(g) != manager._shape(w):
                raise TransposeError(
                    f"transposed leaf shape {manager._shape(g)} != target "
                    f"{manager._shape(w)}")
        return manager.tree_unflatten(like, [
            g.to(w.device) if isinstance(g, torch.Tensor)
            and isinstance(w, torch.Tensor) else g
            for g, w in zip(got, want)])

    return load
