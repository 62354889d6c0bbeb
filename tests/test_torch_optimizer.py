"""The port's SubTrack++ optimizer against the JAX package, on the CPU.

Same numpy inputs through both packages.  The JAX side runs its fused
schedule in ref mode (``use_kernels=True`` without
``REPRO_FORCE_KERNELS``: the jnp oracles behind ``repro.kernels.ops``) or
its unfused schedule; the port runs ``repro_torch.kernels.ops`` (the
oracles, on the CPU) or its own unfused schedule.  The warm-start SVDs
of the two frameworks may pick other signs, so trajectories start from
the JAX state copied over (``repro_torch.interop.opt_state_from_jax``)
and the warm starts are compared by their projectors S S^T.

Budgets (the JAX package's own, ``tests/test_optimizer.py``): 1e-5
relative on a plain step, 1e-3 on a tracking step and after it (Adam's
normalization amplifies fp-level differences of the rotated second
moment).  eta = 2e-5 keeps theta = eta * sigma O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lowrank_adam as jla
from repro.core import subspace as jsub
from repro.core.api import get_optimizer as jax_get_optimizer
from repro.kernels import ops as jops
from repro_torch.core import lowrank_adam as tla
from repro_torch.core import subspace as tsub
from repro_torch.core.api import get_optimizer
from repro_torch.interop import opt_state_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.launch.steps import apply_updates
from torch_threads import one_thread  # noqa: F401


ETA, RANK = 2e-5, 16


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def test_rank1_rotation_matches_dense_rotation():
    rng = np.random.default_rng(0)
    r, n = 12, 40
    v = rng.standard_normal((3, r))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    cos_t = torch.tensor(np.cos([0.3, 1.1, 0.0]), dtype=torch.float32)
    v = torch.tensor(v, dtype=torch.float32)
    M = torch.tensor(rng.standard_normal((3, r, n)), dtype=torch.float32)
    V = torch.tensor(np.abs(rng.standard_normal((3, r, n))),
                     dtype=torch.float32)
    for hp in (tla.AdamHP(), tla.AdamHP(ldadam_bias_factor=True)):
        Q = tsub.change_of_basis_rank1(cos_t, v)
        dense = tla.rotate_moments_dense(Q, M, V, 5, hp)
        rank1 = tla.rotate_moments_rank1(cos_t, v, M, V, 5, hp)
        for a, b in zip(rank1, dense):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        # and the JAX package's rank-1 rotation, one matrix
        jM, jV = jla.rotate_moments_rank1(
            jnp.float32(cos_t[1]), jnp.asarray(_np(v[1])),
            jnp.asarray(_np(M[1])), jnp.asarray(_np(V[1])), jnp.int32(5),
            jla.AdamHP(ldadam_bias_factor=hp.ldadam_bias_factor))
        assert _rel(rank1[0][1], jM) < 1e-5 and _rel(rank1[1][1], jV) < 1e-5


def _matrix_case(seed=1, m=64, n=96):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((m, n)).astype(np.float32)
    S = np.linalg.qr(rng.standard_normal((m, RANK)))[0].astype(np.float32)
    Mo = (0.1 * rng.standard_normal((RANK, n))).astype(np.float32)
    Vo = (0.01 * np.abs(rng.standard_normal((RANK, n)))).astype(np.float32)
    return G, S, Mo, Vo


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("lam_prev", [0.0, 0.05])
def test_plain_lowrank_adam_step_matches_jax(kernels, lam_prev):
    """One plain step from the same state: update, M, V, lam at 1e-5; the
    limiter engages (clip < 1) with lam_prev = 0.05."""
    G, S, Mo, Vo = _matrix_case()
    jst = jla.MatrixOptState(S=jnp.asarray(S), M=jnp.asarray(Mo),
                             V=jnp.asarray(Vo), lam_prev=jnp.float32(lam_prev))
    tst = tla.MatrixOptState(S=torch.tensor(S), M=torch.tensor(Mo),
                             V=torch.tensor(Vo),
                             lam_prev=torch.tensor(lam_prev))
    kw = dict(lr=0.01, weight_decay=0.1, out_dtype=None)
    jout = jla.lowrank_adam_step(
        jnp.asarray(G), jst, jnp.int32(3), jla.AdamHP(),
        backend=jops if kernels else None, param=jnp.asarray(G * 0.1), **kw)
    tout = tla.lowrank_adam_step(
        torch.tensor(G), tst, 3, tla.AdamHP(),
        backend=tops if kernels else None, param=torch.tensor(G * 0.1), **kw)
    assert _rel(tout.delta, jout.delta) < 1e-5
    for f in ("M", "V", "lam_prev"):
        assert _rel(getattr(tout.state, f), getattr(jout.state, f)) < 1e-5
    if lam_prev:
        assert float(tout.state.lam_prev) == pytest.approx(1.01 * lam_prev)


@pytest.mark.parametrize("kernels", [True, False])
def test_tracking_step_matches_jax(kernels):
    """track_subspace then the tracking epilogue from the same state."""
    G, S, Mo, Vo = _matrix_case(seed=2)
    jres = jsub.track_subspace(jnp.asarray(S), jnp.asarray(G), eta=ETA,
                               backend=jops if kernels else None)
    tres = tsub.track_subspace(torch.tensor(S), torch.tensor(G), eta=ETA,
                               backend=tops if kernels else None)
    for f in ("S_new", "A", "cos_theta", "v", "diag"):
        assert _rel(getattr(tres, f), getattr(jres, f)) < 1e-3, f
    if kernels:
        assert _rel(tres.gsq, jres.gsq) < 1e-5
    assert float(tres.diag[1]) > 1e-3           # the basis really moved
    hp = tla.AdamHP()
    trot = tla.rotate_moments_rank1(tres.cos_theta, tres.v,
                                    torch.tensor(Mo), torch.tensor(Vo), 3, hp)
    jrot = jla.rotate_moments_rank1(jres.cos_theta, jres.v, jnp.asarray(Mo),
                                    jnp.asarray(Vo), jnp.int32(3),
                                    jla.AdamHP())
    tst = tla.MatrixOptState(S=torch.tensor(S), M=torch.tensor(Mo),
                             V=torch.tensor(Vo), lam_prev=torch.tensor(0.05))
    jst = jla.MatrixOptState(S=jnp.asarray(S), M=jnp.asarray(Mo),
                             V=jnp.asarray(Vo), lam_prev=jnp.float32(0.05))
    tout = tla.lowrank_adam_step(torch.tensor(G), tst, 3, hp, rotated=trot,
                                 S_new=tres.S_new, lr=0.01,
                                 backend=tops if kernels else None,
                                 precomputed_gsq=tres.gsq)
    jout = jla.lowrank_adam_step(jnp.asarray(G), jst, jnp.int32(3),
                                 jla.AdamHP(), rotated=jrot,
                                 S_new=jres.S_new, lr=jnp.float32(0.01),
                                 backend=jops if kernels else None,
                                 precomputed_gsq=jres.gsq)
    assert _rel(tout.delta, jout.delta) < 1e-3
    for f in ("M", "V"):
        assert _rel(getattr(tout.state, f), getattr(jout.state, f)) < 1e-3


# ---------------------------------------------------------------------------
# The whole optimizer over a small tree
# ---------------------------------------------------------------------------


def _tree(rng):
    """A stacked (3, 64, 96) leaf, a transposed (96, 64) leaf (canonical
    (64, 96): the JAX package buckets it with the stack) and a dense
    vector."""
    return {"stack": rng.standard_normal((3, 64, 96)).astype(np.float32),
            "tr": rng.standard_normal((96, 64)).astype(np.float32),
            "vec": rng.standard_normal((64,)).astype(np.float32)}


def _grads(s):
    """Gradients whose scale grows, so the Eq. 12 limiter engages."""
    g = _tree(np.random.default_rng(100 + s))
    return {k: (1.0 + 0.3 * s) * v for k, v in g.items()}


def _tmap(fn, tree):
    return {k: fn(v) for k, v in tree.items()}


@pytest.mark.parametrize("kernels,wd", [(True, 0.0), (True, 0.01),
                                        (False, 0.0)])
def test_optimizer_update_matches_jax(kernels, wd):
    """Seven steps (tracking at step 4), both packages free-running from
    the JAX warm-started state: per-step updates, then params, S, M, V."""
    kw = dict(rank=RANK, update_interval=4, eta=ETA, use_kernels=kernels,
              weight_decay=wd)
    jopt = jax_get_optimizer("subtrack", **kw)
    topt = get_optimizer("subtrack", **kw)
    params0 = _tmap(lambda a: 0.1 * a, _tree(np.random.default_rng(7)))
    jparams = _tmap(jnp.asarray, params0)
    tparams = _tmap(torch.tensor, params0)
    jstate = jopt.warm_start(jax.jit(jopt.init)(jparams), _tmap(jnp.asarray,
                                                       _grads(0)))
    tstate = opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert topt.state_bytes(tparams) == jopt.state_bytes(jparams)
    jupdate = jax.jit(jopt.update, static_argnames=("do_subspace_update",))
    clipped = False
    for s in range(7):
        do = s > 0 and s % 4 == 0
        g = _grads(s)
        ju, jstate = jupdate(_tmap(jnp.asarray, g), jstate, jparams, 0.03,
                             do_subspace_update=do)
        lam_before = tstate.inner["stack"].lam_prev.clone()
        tu, tstate = topt.update(_tmap(torch.tensor, g), tstate, tparams,
                                 0.03, do_subspace_update=do)
        budget = 1e-5 if s < 4 else 1e-3
        for k in ju:
            assert _rel(tu[k], ju[k]) < budget, (s, k)
        lam_after = tstate.inner["stack"].lam_prev
        clipped |= bool(((lam_before > 0)
                         & torch.isclose(lam_after, 1.01 * lam_before,
                                         rtol=1e-6)).any())
        jparams = jax.tree.map(lambda p, u: p + u, jparams, ju)
        tparams = {k: tparams[k] + tu[k] for k in tparams}
    assert clipped, "the Eq. 12 limiter never clipped (clip < 1)"
    assert tstate.step == int(jstate.step) == 7
    assert tstate.n_updates == int(jstate.n_updates) == 1
    for k in ("stack", "tr"):
        for f in ("S", "M", "V", "lam_prev"):
            assert _rel(getattr(tstate.inner[k], f),
                        getattr(jstate.inner[k], f)) < 1e-3, (k, f)
    for k in params0:
        assert _rel(tparams[k], jparams[k]) < 1e-5, k


def test_update_apply_in_place_matches_returned_updates():
    """On plain and tracking steps ``update`` releases each gradient and
    never writes the old state (a second update from it is bit-identical,
    state too); ``apply_updates`` adds the held updates into the params
    in place."""
    opt = get_optimizer("subtrack", rank=RANK, update_interval=2, eta=ETA,
                        use_kernels=True)
    params = _tmap(torch.tensor, _tree(np.random.default_rng(3)))
    state = opt.warm_start(opt.init(params), _tmap(torch.tensor, _grads(0)))
    for track in (False, True):
        g = _tmap(torch.tensor, _grads(1))
        upd, want = opt.update(_tmap(torch.clone, g), state, params, 0.01,
                               do_subspace_update=track)
        held, got = opt.update(g, state, params, 0.01,
                               do_subspace_update=track)
        assert all(v is None for v in g.values())
        applied = _tmap(torch.clone, params)
        apply_updates(applied, held)
        assert all(u is None for u in held.values())
        for k in params:
            torch.testing.assert_close(applied[k], params[k] + upd[k],
                                       atol=0, rtol=0)
        for k in want.inner:
            for x, y in zip(got.inner[k], want.inner[k]):
                assert torch.equal(x, y), (track, k)


def test_warm_start_matches_jax_by_projector():
    """S_0 from the SVD of the first gradient: the same subspace as the
    JAX package's, compared as projectors (the SVD signs may differ)."""
    jopt = jax_get_optimizer("subtrack", rank=RANK)
    topt = get_optimizer("subtrack", rank=RANK)
    params0 = _tree(np.random.default_rng(7))
    g0 = _grads(0)
    jst = jopt.warm_start(jax.jit(jopt.init)(_tmap(jnp.asarray, params0)),
                          _tmap(jnp.asarray, g0))
    tst = topt.warm_start(topt.init(_tmap(torch.tensor, params0)),
                          _tmap(torch.tensor, g0))
    assert isinstance(tst.inner["vec"], tla.DenseOptState)
    for k in ("stack", "tr"):
        tS = tst.inner[k].S
        jS = np.asarray(jst.inner[k].S)
        assert tuple(tS.shape) == jS.shape
        np.testing.assert_allclose(_np(tS @ tS.mT), jS @ np.swapaxes(jS, -1,
                                                                    -2),
                                   atol=1e-4)


def test_geodesic_step_matches_literal_eq5_and_stays_orthonormal():
    G, S, _, _ = _matrix_case(seed=4)
    S, G = torch.tensor(S), torch.tensor(G)
    triple = tsub.stabilize_triple(
        S, tsub.top1_eigh(tsub.tangent_naive(S, G, tsub.project(S, G))))
    for eta in (1e-4, 2e-3):
        step = tsub.geodesic_step(S, triple, eta)
        torch.testing.assert_close(step, tsub.geodesic_full(S, triple, eta),
                                   atol=1e-5, rtol=1e-5)
        eye = torch.eye(RANK)
        assert (step.mT @ step - eye).abs().max() < 1e-5
    # the fused and the paper-literal tangent agree
    A = tsub.project(S, G)
    torch.testing.assert_close(tsub.tangent_fused(S, G, A),
                               tsub.tangent_naive(S, G, A), atol=1e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("name,kw", [
    ("galore", {}), ("fira", {}), ("golore", {}), ("osd", {}),
    ("apollo", {}), ("grassmann_only", {}), ("subtrack_fast", {}),
    ("subtrack", {"reorth_interval": 1}), ("subtrack", {"method": "none"}),
    ("subtrack", {"init": "identity", "exact_top1": True}),
])
def test_method_zoo_steps_keep_bases_orthonormal(name, kw):
    """Every named variant over the small tree: plain, tracking (refresh)
    and plain steps give finite updates and orthonormal bases."""
    opt = get_optimizer(name, rank=RANK, update_interval=2, eta=ETA, **kw)
    params = _tmap(torch.tensor, _tree(np.random.default_rng(5)))
    state = opt.warm_start(opt.init(params), _tmap(torch.tensor, _grads(0)))
    for s in range(3):
        upd, state = opt.update(_tmap(torch.tensor, _grads(s)), state,
                                params, 0.01, do_subspace_update=s == 2)
        assert all(torch.isfinite(u).all() for u in upd.values())
    assert state.n_updates == 1
    for k in ("stack", "tr"):
        S = state.inner[k].S
        assert (S.mT @ S - torch.eye(RANK)).abs().max() < 1e-4, k


@pytest.mark.parametrize("kernels", [True, False])
def test_grass_method_matches_jax(kernels):
    """method="grass" on one device: the warm start's one-hot basis (the
    top-r rows of G by energy) equals the JAX package's exactly; then a
    plain step (1e-5) and a tracking step (1e-3: the refresh picks a new
    row set, and the moments rotate by the dense Q = S_new^T S) match it,
    and every basis stays a one-hot row selection."""
    kw = dict(rank=RANK, update_interval=2, eta=ETA, method="grass",
              use_kernels=kernels)
    jopt = jax_get_optimizer("subtrack", **kw)
    topt = get_optimizer("subtrack", **kw)
    params0 = _tmap(lambda a: 0.1 * a, _tree(np.random.default_rng(7)))
    jparams = _tmap(jnp.asarray, params0)
    tparams = _tmap(torch.tensor, params0)
    jstate = jopt.warm_start(jax.jit(jopt.init)(jparams), _tmap(jnp.asarray,
                                                       _grads(0)))
    tstate = topt.warm_start(topt.init(tparams), _tmap(torch.tensor,
                                                       _grads(0)))
    for k in ("stack", "tr"):
        np.testing.assert_array_equal(_np(tstate.inner[k].S),
                                      np.asarray(jstate.inner[k].S))
    jupdate = jax.jit(jopt.update, static_argnames=("do_subspace_update",))
    for s, do in ((1, False), (2, True)):
        g = _grads(s)
        S_before = tstate.inner["stack"].S
        ju, jstate = jupdate(_tmap(jnp.asarray, g), jstate, jparams, 0.03,
                             do_subspace_update=do)
        tu, tstate = topt.update(_tmap(torch.tensor, g), tstate, tparams,
                                 0.03, do_subspace_update=do)
        budget = 1e-3 if do else 1e-5
        for k in ju:
            assert _rel(tu[k], ju[k]) < budget, (s, k)
        for k in ("stack", "tr"):
            S = tstate.inner[k].S
            np.testing.assert_array_equal(_np(S), np.asarray(
                jstate.inner[k].S))
            assert set(torch.unique(S).tolist()) == {0.0, 1.0}
            assert torch.equal(S.sum(-2), torch.ones(S.shape[:-2] + (RANK,)))
            assert (S.sum(-1) <= 1).all()
            for f in ("M", "V"):
                assert _rel(getattr(tstate.inner[k], f),
                            getattr(jstate.inner[k], f)) < budget, (s, k, f)
        assert torch.equal(tstate.inner["stack"].S, S_before) == (not do)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, ju)
        tparams = {k: tparams[k] + tu[k] for k in tparams}
    assert tstate.n_updates == int(jstate.n_updates) == 1
