"""The port's fifth slice against the JAX package, on the CPU: the kernels
``adam_lowrank`` (#10) and ``tangent_gram`` (#8), and the gram tracking
schedule that runs ``tangent_gram`` (``track_subspace(schedule="gram")``,
group size 1).

* The port's dispatch (on the CPU: its oracles) against the Pallas kernels
  in interpret mode.  Adam: step 0 and 1000, bias correction on and off,
  rtol 1e-5, atol 1e-6.  tangent_gram: G fp32 and bf16, the JAX kernel
  test's tolerances (``tests/test_kernels.py``: 1e-4 fp32, 3e-2 bf16 of the
  largest entry; S^T T, analytically zero, judged against max |T|).
* The gram schedule against JAX ``subspace._track_gram_schedule`` with the
  null program (``program.NULL_EXEC``), from the same S (copied, never
  re-SVD'd) and G, eta pinned so theta = O(1), with and without
  ``backend=ops``: S_new, A_new, cos theta and v within 1e-5 (atol taken
  relative to the largest entry: fp32 sums in another order), and the
  health-guard path with a non-finite G.
* The gram schedule against the port's tangent schedule: the two S_new as
  projectors and A_new against S_new^T G, within 1e-3 of the largest entry
  (the tracking budget; the two differ by power-iteration and reassociation
  rounding only).

Same numpy inputs from a seed: a batch of 2 or 3 matrices, m = 256 or 512,
n = 512, r = 32 to 128.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import program as jprogram
from repro.core import subspace as jsub
from repro.kernels import grassmann as pallas
from repro.kernels import ops as jops
from repro_torch.core import subspace as tsub
from repro_torch.kernels import ops, ref
from torch_threads import one_thread  # noqa: F401


def _t(a, dtype="float32"):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32), jnp.dtype(dtype))


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _bf16_exact(a):
    """a rounded to bf16 (so both sides read the same values)."""
    return torch.tensor(a).bfloat16().float().numpy()


# ---------------------------------------------------------------------------
# adam_lowrank (#10)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1000])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_adam_lowrank_matches_the_pallas_kernel(step, bias_correction):
    rng = np.random.default_rng(step + 3 * bias_correction)
    B, r, n = 2, 128, 512
    Gt = rng.standard_normal((B, r, n)).astype(np.float32)
    M = 0.1 * rng.standard_normal((B, r, n)).astype(np.float32)
    V = 0.01 * np.abs(rng.standard_normal((B, r, n))).astype(np.float32)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8,
              bias_correction=bias_correction)
    got = ops.adam_lowrank(_t(Gt), _t(M), _t(V), step, **kw)
    want = jax.vmap(lambda g, m, v: pallas.adam_lowrank(
        g, m, v, jnp.int32(step), interpret=True, **kw))(
            _j(Gt), _j(M), _j(V))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# tangent_gram (#8)
# ---------------------------------------------------------------------------


def _gram_inputs(B, m, n, r, gdtype, seed):
    rng = np.random.default_rng(seed)
    S = np.linalg.qr(rng.standard_normal((B, m, r)))[0].astype(np.float32)
    G = rng.standard_normal((B, m, n)).astype(np.float32)
    if gdtype == "bfloat16":
        G = _bf16_exact(G)
    return S, G


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,r", [(256, 512, 32), (512, 512, 128)])
def test_tangent_gram_matches_the_pallas_kernel(gdtype, m, n, r):
    """m = 512 takes two of the TPU's m blocks, so its sum over the m grid
    axis and the Grams' j == 0 sweep are both exercised."""
    S, G = _gram_inputs(3, m, n, r, gdtype, seed=m + r)
    tS, tG = _t(S), _t(G, gdtype)
    A, _ = ref.project_colnorms_ref(tS, tG)
    T = ref.tangent_ref(tG, A, tS)
    got = ops.tangent_gram(tS, T, tG)
    want = jax.vmap(lambda s, t, g: pallas.tangent_gram(
        s, t, g, interpret=True))(_j(S), _j(T.numpy()), _j(G, gdtype))
    tol = 1e-4 if gdtype == "float32" else 3e-2
    tmax = float(T.abs().max())
    for name, g, w in zip(("TtG", "StT", "TtT", "StS"), got, want):
        w = np.asarray(w)
        denom = tmax if name == "StT" else float(np.abs(w).max())
        err = float(np.abs(_np(g) - w).max())
        assert err < tol * denom + 1e-6, (name, err, denom)


def test_cpu_dispatch_of_the_new_kernels_launches_nothing():
    S, G = (_t(a) for a in _gram_inputs(2, 64, 96, 8, "float32", seed=1))
    T = ref.tangent_ref(G, S.mT @ G, S)
    ops.reset_launch_counts()
    for got, want in zip(ops.tangent_gram(S, T, G),
                         ref.tangent_gram_ref(S, T, G)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    A = S.mT @ G
    for got, want in zip(ops.adam_lowrank(A, A, A.abs(), 3),
                         ref.adam_lowrank_ref(A, A, A.abs(), 3, 0.9, 0.999,
                                              1e-8)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not any(ops.launch_counts().values())


# ---------------------------------------------------------------------------
# The gram schedule at group size 1
# ---------------------------------------------------------------------------

B_, M_, N_, R_ = 2, 256, 512, 32


def _track_inputs(seed=0, nonfinite=False):
    rng = np.random.default_rng(seed)
    S = np.linalg.qr(rng.standard_normal((B_, M_, R_)))[0].astype(np.float32)
    G = rng.standard_normal((B_, M_, N_)).astype(np.float32)
    if nonfinite:
        G[1, 7, 11] = np.nan
    # theta = eta * sigma = 0.5 on matrix 0: O(1), far from the clamp
    T0 = ref.tangent_ref(_t(G[0]), _t(S[0]).mT @ _t(G[0]), _t(S[0]))
    eta = 0.5 / float(torch.linalg.matrix_norm(T0, ord=2))
    return S, G, eta


def _jax_gram(S, G, eta, backend):
    fn = functools.partial(jsub._track_gram_schedule, eta=eta,
                           fused_tangent=True, exact_top1=False,
                           power_iters=24, backend=backend,
                           exec=jprogram.NULL_EXEC)
    return jax.vmap(fn)(_j(S), _j(G))


def _close(got, want, rel=1e-5):
    got, want = _np(got), np.asarray(want, np.float32)
    scale = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 1.0
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("with_backend", [False, True])
def test_gram_schedule_matches_jax(with_backend):
    S, G, eta = _track_inputs(seed=5)
    got = tsub.track_subspace(_t(S), _t(G), eta=eta, schedule="gram",
                              backend=ops if with_backend else None)
    want = _jax_gram(S, G, eta, jops if with_backend else None)
    for name in ("S_new", "A", "A_new", "cos_theta", "v", "gsq", "diag"):
        _close(getattr(got, name), getattr(want, name))
    theta = np.arccos(_np(got.cos_theta))
    assert (theta > 0.1).all() and (theta < 1.4).all()


@pytest.mark.parametrize("with_backend", [False, True])
def test_gram_schedule_guards_a_non_finite_gradient_like_jax(with_backend):
    S, G, eta = _track_inputs(seed=6, nonfinite=True)
    got = tsub.track_subspace(_t(S), _t(G), eta=eta, schedule="gram",
                              backend=ops if with_backend else None)
    want = _jax_gram(S, G, eta, jops if with_backend else None)
    # matrix 1 is degenerate: S unchanged, v = 0, theta = 0, flagged
    assert torch.equal(got.S_new[1], _t(S[1]))
    assert not got.v[1].any() and float(got.cos_theta[1]) == 1.0
    assert _np(got.diag)[1, 3] == 1.0 and np.asarray(want.diag)[1, 3] == 1.0
    assert _np(got.diag)[0, 3] == 0.0
    for name in ("S_new", "A_new", "cos_theta", "v"):
        _close(getattr(got, name), getattr(want, name))
    # A_new carries G's NaN where JAX's does, and nowhere else
    np.testing.assert_array_equal(np.isnan(_np(got.A_new)),
                                  np.isnan(np.asarray(want.A_new)))


@pytest.mark.parametrize("with_backend", [False, True])
def test_gram_schedule_agrees_with_the_tangent_schedule(with_backend):
    S, G, eta = _track_inputs(seed=7)
    tS, tG = _t(S), _t(G)
    backend = ops if with_backend else None
    gram = tsub.track_subspace(tS, tG, eta=eta, schedule="gram",
                               backend=backend)
    tang = tsub.track_subspace(tS, tG, eta=eta, backend=backend)
    assert tang.A_new is None

    def proj(X):
        return X @ X.mT

    _close(proj(gram.S_new), proj(tang.S_new), rel=1e-3)
    _close(gram.A_new, tsub.project(tang.S_new, tG), rel=1e-3)
    _close(gram.A_new, tsub.project(gram.S_new, tG), rel=1e-3)
    _close(gram.cos_theta, tang.cos_theta, rel=1e-3)


def test_unknown_schedule_raises():
    S, G, eta = _track_inputs(seed=8)
    with pytest.raises(ValueError, match="schedule"):
        tsub.track_subspace(_t(S), _t(G), eta=eta, schedule="rows")
