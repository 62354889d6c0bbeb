"""The kernels of the port's fourth slice against the JAX package, on the
CPU: the tracking front end ``project_tangent_colnorms`` (#6) and the
unfused schedule's ``backproject`` (#2) and ``recovery`` (#4), then that
schedule itself (``lowrank_adam_step`` with ``lr=None``).

* The port's oracles (``repro_torch.kernels.ref``) against the JAX oracles
  (``repro.kernels.ref``), batched with ``jax.vmap``.
* The Pallas kernels in interpret mode (``interpret=True``, ``jax.vmap``
  over a batch of 3) against the port's oracles.
* One unfused ``lowrank_adam_step(lr=None)`` through ``kernels.ops`` (the
  oracles, on the CPU) against the JAX one with ``backend=ops``: with and
  without recovery, the limiter armed, on a plain step and on a step whose
  moments were rotated and whose basis moved.

Same numpy inputs from a seed: m = 256, n = 512, r = 32 and 128, G in fp32
and bf16.  Tolerance atol = rtol = 1e-5 (fp32 sums in another order), with
atol taken relative to the largest entry for T and Lam, whose terms
cancel, and for the step's direction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lowrank_adam as jla
from repro.kernels import grassmann as pallas
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import lowrank_adam as tla
from repro_torch.kernels import ops, ref
from torch_threads import one_thread  # noqa: F401


B, M_, N_ = 3, 256, 512


def _inputs(r, gdtype, seed=0):
    """S orthonormal (B, m, r), G (B, m, n) exactly representable in
    ``gdtype``, X / Gt (B, r, n), phi (B, n)."""
    rng = np.random.default_rng(seed + 7 * r)
    S = np.linalg.qr(rng.standard_normal((B, M_, r)))[0].astype(np.float32)
    G = rng.standard_normal((B, M_, N_)).astype(np.float32)
    if gdtype == "bfloat16":
        G = torch.tensor(G).bfloat16().float().numpy()
    X = rng.standard_normal((B, r, N_)).astype(np.float32)
    phi = np.abs(rng.standard_normal((B, N_))).astype(np.float32)
    return S, G, X, phi


def _t(a, dtype="float32"):
    return torch.tensor(a).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a, jnp.dtype(dtype))


def _close(got, want, scaled=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = 1e-5 * (np.abs(want).max() if scaled else 1.0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5)


R_G = pytest.mark.parametrize("r,gdtype", [(32, "float32"),
                                           (32, "bfloat16"),
                                           (128, "float32"),
                                           (128, "bfloat16")])


@R_G
def test_oracles_match_jax(r, gdtype):
    S, G, X, phi = _inputs(r, gdtype)
    tS, tG, tX, tphi = _t(S), _t(G, gdtype), _t(X), _t(phi)
    jS, jG, jX, jphi = _j(S), _j(G, gdtype), _j(X), _j(phi)
    for got, want, scaled in zip(
            ref.project_tangent_colnorms_ref(tS, tG),
            jax.vmap(jref.project_tangent_colnorms_ref)(jS, jG),
            (False, False, True)):
        _close(got, want, scaled)
    _close(ref.backproject_ref(tS, tX),
           jax.vmap(jref.backproject_ref)(jS, jX))
    _close(ref.recovery_ref(tG, tS, tX, tphi),
           jax.vmap(jref.recovery_ref)(jG, jS, jX, jphi), scaled=True)


def _pallas(fn, *args, **kw):
    return jax.vmap(lambda *a: fn(*a, interpret=True, **kw))(*args)


@R_G
def test_pallas_kernels_match_port_oracles(r, gdtype):
    S, G, X, phi = _inputs(r, gdtype, seed=1)
    tS, tG, tX, tphi = _t(S), _t(G, gdtype), _t(X), _t(phi)
    jS, jG, jX, jphi = _j(S), _j(G, gdtype), _j(X), _j(phi)
    for got, want, scaled in zip(
            _pallas(pallas.project_tangent_colnorms, jS, jG),
            ref.project_tangent_colnorms_ref(tS, tG), (False, False, True)):
        _close(got, want, scaled)
    _close(_pallas(pallas.backproject, jS, jX), ref.backproject_ref(tS, tX))
    _close(_pallas(pallas.recovery, jG, jS, jX, jphi),
           ref.recovery_ref(tG, tS, tX, tphi), scaled=True)


def test_cpu_dispatch_runs_the_oracles_and_launches_nothing():
    S, G, X, phi = (_t(a) for a in _inputs(32, "float32"))
    ops.reset_launch_counts()
    for got, want in zip(ops.project_tangent_colnorms(S, G),
                         ref.project_tangent_colnorms_ref(S, G)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(ops.backproject(S, X),
                               ref.backproject_ref(S, X), atol=0, rtol=0)
    torch.testing.assert_close(ops.recovery(S, G, X, phi),
                               ref.recovery_ref(G, S, X, phi), atol=0, rtol=0)
    assert all(v == 0 for v in ops.launch_counts().values())


# ---------------------------------------------------------------------------
# The unfused schedule: lowrank_adam_step(lr=None) through the backend
# ---------------------------------------------------------------------------


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.mark.parametrize("recovery", [True, False])
@pytest.mark.parametrize("rotated", [False, True])
def test_unfused_step_matches_jax(recovery, rotated):
    """One unfused step (project, Adam, backproject, phi, recovery, the
    limiter) from the same state; the limiter is armed (lam_prev > 0).  The
    rotated step moves the basis (S_new) and starts from rotated moments."""
    rng = np.random.default_rng(3)
    m, n, r = 96, 160, 16
    G = rng.standard_normal((m, n)).astype(np.float32)
    S = np.linalg.qr(rng.standard_normal((m, r)))[0].astype(np.float32)
    S_new = np.linalg.qr(S + 0.1 * rng.standard_normal((m, r)))[0].astype(
        np.float32)
    Mo = (0.1 * rng.standard_normal((r, n))).astype(np.float32)
    Vo = (0.01 * np.abs(rng.standard_normal((r, n)))).astype(np.float32)
    Mr = (0.1 * rng.standard_normal((r, n))).astype(np.float32)
    Vr = (0.01 * np.abs(rng.standard_normal((r, n)))).astype(np.float32)
    lam_prev = 0.5
    jst = jla.MatrixOptState(S=jnp.asarray(S), M=jnp.asarray(Mo),
                             V=jnp.asarray(Vo), lam_prev=jnp.float32(lam_prev))
    tst = tla.MatrixOptState(S=_t(S), M=_t(Mo), V=_t(Vo),
                             lam_prev=torch.tensor(lam_prev))
    jkw = dict(rotated=(jnp.asarray(Mr), jnp.asarray(Vr)),
               S_new=jnp.asarray(S_new)) if rotated else {}
    tkw = dict(rotated=(_t(Mr), _t(Vr)), S_new=_t(S_new)) if rotated else {}
    jout = jla.lowrank_adam_step(jnp.asarray(G), jst, jnp.int32(4),
                                 jla.AdamHP(), recovery=recovery,
                                 backend=jops, **jkw)
    ops.reset_launch_counts()
    tout = tla.lowrank_adam_step(_t(G), tst, 4, tla.AdamHP(),
                                 recovery=recovery, backend=ops, **tkw)
    assert all(v == 0 for v in ops.launch_counts().values())
    assert tout.delta.dtype == torch.float32 and tout.delta.shape == (m, n)
    assert _rel(tout.delta, jout.delta) < 1e-5
    for f in ("S", "M", "V", "lam_prev"):
        assert _rel(getattr(tout.state, f), getattr(jout.state, f)) < 1e-5, f
    if recovery:
        # the limiter engaged: the recovery norm was clipped to zeta * lam
        assert float(tout.state.lam_prev) == pytest.approx(1.01 * lam_prev)
    # and the port's plain-PyTorch unfused schedule gives the same step
    plain = tla.lowrank_adam_step(_t(G), tst, 4, tla.AdamHP(),
                                  recovery=recovery, **tkw)
    assert _rel(tout.delta, plain.delta) < 1e-5


def test_unfused_step_takes_a_bf16_gradient_and_a_stack():
    """The backend path widens G inside the kernels: a bf16 stack gives the
    step of its fp32 copy, matrix by matrix."""
    rng = np.random.default_rng(4)
    L, m, n, r = 2, 64, 96, 8
    G = _t(rng.standard_normal((L, m, n))).bfloat16()
    S = _t(np.linalg.qr(rng.standard_normal((L, m, r)))[0])
    st = tla.MatrixOptState(S=S, M=torch.zeros(L, r, n),
                            V=torch.zeros(L, r, n),
                            lam_prev=torch.tensor([0.0, 0.3]))
    out = tla.lowrank_adam_step(G, st, 0, tla.AdamHP(), backend=ops)
    for i in range(L):
        one = tla.MatrixOptState(*(t[i] for t in st))
        want = tla.lowrank_adam_step(G[i].float(), one, 0, tla.AdamHP(),
                                     backend=ops)
        assert _rel(out.delta[i], want.delta) < 1e-6
        assert _rel(out.state.lam_prev[i], want.state.lam_prev) < 1e-6
