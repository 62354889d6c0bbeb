"""Helpers for the port's tests that hold it against the JAX package.

Comparisons are relative to the largest entry of the reference; the
optimizer helpers run the JAX package's plain and tracking SubTrack++
steps from one mid-run state (one compiled program) and hold the port's
steps, from the same state, against them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.api import get_optimizer as jax_get_optimizer
from repro.core.lowrank_adam import MatrixOptState as JMatrixState
from repro.distributed.context import mesh_context
from repro.launch.mesh import smoke_context
from repro_torch.core.api import get_optimizer
from repro_torch.interop import opt_state_from_jax, params_from_jax


TOL = 2e-5


def t(a, dtype=None) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype)


def close(got, want, tol=TOL, msg=""):
    """Every entry within ``tol`` of the largest entry of ``want``."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               err_msg=msg,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def close_tree(got, want, tol=TOL, path=""):
    if isinstance(got, dict):
        assert got.keys() == want.keys(), path
        for k in got:
            close_tree(got[k], want[k], tol, f"{path}/{k}")
        return
    close(got, want, tol, path)


def close_bf16(got, want, tol=TOL, msg=""):
    """bf16 values rounded from fp32 values that agree to ``tol`` of the
    largest: each entry within that of the reference's plus one bf16
    step (a value near a rounding boundary may land on either side)."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert (np.abs(g - w) <= step + tol * np.abs(w).max()).all(), msg


def unflatten(like, leaves):
    it = iter(leaves)
    return jax.tree.map(lambda _: next(it), like, is_leaf=torch.is_tensor)


def _mid_run(rng):
    """A JAX optimizer state mid-run: orthonormal S, nonzero moments, V
    away from zero."""
    def mid(st):
        if not isinstance(st, JMatrixState):
            return st
        S_ = np.linalg.qr(rng.standard_normal(st.S.shape))[0]
        return st._replace(
            S=jnp.asarray(S_, jnp.float32),
            M=jnp.asarray(0.01 * rng.standard_normal(st.M.shape),
                          jnp.float32),
            V=jnp.asarray(1e-4 * (0.5 + np.abs(rng.standard_normal(
                st.V.shape))), jnp.float32))
    return mid


def jax_optimizer_steps(params_np, opt_kw, seed) -> dict:
    """One JAX state mid-run on ``params_np``'s tree, and the JAX
    package's plain and tracking steps from it on 0.01 N(0, 1)
    gradients, at lr 1e-3 (one compiled program)."""
    rng = np.random.default_rng(seed)
    grads_np = jax.tree.map(lambda a: (0.01 * rng.standard_normal(
        a.shape)).astype(np.float32), params_np)
    with mesh_context(smoke_context()):
        jopt = jax_get_optimizer("subtrack", **opt_kw)
        jp = jax.tree.map(jnp.asarray, params_np)
        state = jax.jit(jopt.init)(jp)
        state = state._replace(step=jnp.int32(1), inner=jax.tree.map(
            _mid_run(rng), state.inner,
            is_leaf=lambda x: isinstance(x, JMatrixState)))

        def both(g, st, p):
            return tuple(jopt.update(g, st, p, 1e-3, do_subspace_update=t_)
                         for t_ in (False, True))

        steps = jax.jit(both)(jax.tree.map(jnp.asarray, grads_np), state,
                              jp)
    return dict(params_np=params_np, grads_np=grads_np, opt_kw=opt_kw,
                state_np=jax.tree.map(np.asarray, state),
                steps=jax.tree.map(np.asarray, steps))


def check_optimizer_step(runs, tcfg, tracking: bool):
    """The port's step from the JAX state of ``runs``
    (:func:`jax_optimizer_steps`): updates and every field of every
    leaf's new state at 1e-5 (plain) or 1e-3 (tracking) of the largest
    entry."""
    jupd, jnew = runs["steps"][int(tracking)]
    tol = 1e-3 if tracking else 1e-5
    tstate = opt_state_from_jax(runs["state_np"])
    upd, new = get_optimizer("subtrack", **runs["opt_kw"]).update(
        params_from_jax(runs["grads_np"], tcfg), tstate,
        params_from_jax(runs["params_np"], tcfg), 1e-3,
        do_subspace_update=tracking)
    close_tree(upd, jupd, tol)
    flat = jax.tree_util.tree_flatten_with_path(
        jnew.inner, is_leaf=lambda x: hasattr(x, "_fields"))[0]
    for path, jst in flat:
        st = new.inner
        for k in path:
            st = st[k.key]
        for f in st._fields:
            close(getattr(st, f), getattr(jst, f), tol,
                  f"{jax.tree_util.keystr(path)} {f}")
