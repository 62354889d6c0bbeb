"""The port's dense baselines (AdamW, BAdam) against the JAX package, on
the CPU.

Both packages take 4 steps from the same params and gradients, over a
nested tree whose insertion order differs from the sorted key order the
JAX package flattens by (BAdam numbers its blocks by that order).  BAdam
switches blocks every step (``block_interval=1``, ``n_blocks=3``), so
each leaf is active on some steps and frozen on others.  Updates, moments
and params at 1e-5 of the largest entry (fp32, dense Adam in both: only
the order of fp32 operations may differ); ``state_bytes`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import get_optimizer as jax_get_optimizer
from repro_torch.core.api import get_optimizer
from repro_torch.core.subtrack import tree_leaves, tree_map
from repro_torch.interop import opt_state_from_jax
from repro_torch.launch.steps import apply_updates
from torch_threads import one_thread  # noqa: F401


STEPS = 4


def _tree(rng, scale=1.0):
    """Insertion order z, layers/wq, layers/ln, a; sorted: a, layers/ln,
    layers/wq, z."""
    def rn(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"z": rn(3, 8, 6), "layers": {"wq": rn(2, 4, 6), "ln": rn(2, 6)},
            "a": rn(5)}


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _pairs(t, j, path=""):
    if isinstance(t, dict):
        for k in t:
            yield from _pairs(t[k], j[k], f"{path}/{k}")
    else:
        yield path, t, j


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", {"weight_decay": 0.1}),
    ("badam", {"block_interval": 1, "n_blocks": 3}),
    ("badam", {"block_interval": 1, "n_blocks": 3, "weight_decay": 0.1}),
])
def test_baseline_steps_match_jax(name, kw):
    jopt = jax_get_optimizer(name, **kw)
    topt = get_optimizer(name, **kw)
    params0 = _tree(np.random.default_rng(0), 0.1)
    jparams = jax.tree.map(jnp.asarray, params0)
    tparams = tree_map(torch.tensor, params0)
    jstate = jopt.init(jparams)
    tstate = topt.init(tparams)
    assert topt.state_bytes(tparams) == jopt.state_bytes(jparams)
    assert topt.warm_start(tstate, None) is tstate
    frozen = set()
    for s in range(STEPS):
        g = _tree(np.random.default_rng(10 + s), 1.0 + 0.3 * s)
        ju, jstate = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, g),
                                          jstate, jparams, 0.01)
        tu, tstate = topt.update(tree_map(torch.tensor, g), tstate,
                                 tparams, 0.01, do_subspace_update=False)
        for path, t, j in _pairs(tu, ju):
            if not np.any(np.asarray(j)):   # the port gives no update
                frozen.add((s, path))
                assert t is None, (s, path)
            else:
                assert _rel(t, j) < 1e-5, (s, path)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, ju)
        tparams = tree_map(_add, tparams, tu)
    assert tstate.step == int(jstate.step) == STEPS
    for path, t, j in _pairs(tstate.inner, jstate.inner):
        for f in ("M", "V"):
            assert _rel(getattr(t, f), getattr(j, f)) < 1e-5, (path, f)
    for path, t, j in _pairs(tparams, jparams):
        assert _rel(t, j) < 1e-5, path
    if name == "badam":   # step s updates JAX leaves i with i % 3 == s % 3
        order = ["/a", "/layers/ln", "/layers/wq", "/z"]
        assert frozen == {(s, p) for s in range(STEPS)
                          for i, p in enumerate(order) if i % 3 != s % 3}
    else:
        assert not frozen


def _add(p, u):
    return p if u is None else p + u


@pytest.mark.parametrize("name", ["adamw", "badam"])
def test_apply_in_place_matches_returned_updates(name):
    """``update`` releases the gradients and never writes the old state
    (a second update from it is bit-identical); ``apply_updates`` adds
    the held updates into the params in place and releases them.  The
    state continues from the JAX package's (``opt_state_from_jax``)."""
    kw = {"block_interval": 1, "n_blocks": 3} if name == "badam" else {}
    opt = get_optimizer(name, **kw)
    params0 = _tree(np.random.default_rng(1), 0.1)
    jopt = jax_get_optimizer(name, **kw)
    jstate = jopt.init(jax.tree.map(jnp.asarray, params0))
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    params = tree_map(torch.tensor, params0)
    g = tree_map(torch.tensor, _tree(np.random.default_rng(2)))
    upd, want = opt.update(tree_map(torch.clone, g), state, params, 0.01)
    held, got = opt.update(g, state, params, 0.01)
    assert all(v is None for v in (g["z"], g["a"], g["layers"]["wq"],
                                   g["layers"]["ln"]))
    assert (name == "badam") == any(u is None for u in tree_leaves(upd))
    applied = tree_map(torch.clone, params)
    apply_updates(applied, held)
    assert all(u is None for u in tree_leaves(held))
    for path, a, b in _pairs(applied, tree_map(_add, params, upd)):
        assert torch.equal(a, b), path
    for path, a, b in _pairs(got.inner, want.inner):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), path
