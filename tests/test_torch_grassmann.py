"""The port's optimizer-kernel oracles against the JAX package.

Each of the six oracles of ``repro_torch.kernels.ref`` is held against
its JAX oracle (``repro.kernels.ref``), and each of the five kernels of
the training slice in its Pallas form, run in interpret mode on the CPU
(``repro.kernels.grassmann.*(interpret=True)``, batched with
``jax.vmap``), is held against the port's oracle, on the same numpy
inputs from a seed: m = 256, n = 512, r = 32 and 128, a batch dim of 3,
G in fp32 and bf16.  Per-matrix clips differ across the batch.

Tolerances: atol = rtol = 1e-5 on fp32 outputs (summation order differs
between XLA and PyTorch), taken relative to each output's largest entry
for the products whose entries cancel (the tangent and the update); one
bf16 ulp of the reference on a bf16 update, on top of the 1e-5 (of the
largest entry) that the fp32 value carries before its rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import grassmann as pallas
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from torch_threads import one_thread  # noqa: F401


B, M_, N_ = 3, 256, 512


def _inputs(r, gdtype, seed=0):
    """S orthonormal (B, m, r), G (B, m, n) in ``gdtype`` (values exactly
    representable in it), Adam states, phi, per-matrix clips."""
    rng = np.random.default_rng(seed + r)
    S = np.linalg.qr(rng.standard_normal((B, M_, r)))[0].astype(np.float32)
    G = rng.standard_normal((B, M_, N_)).astype(np.float32)
    if gdtype == "bfloat16":
        G = torch.tensor(G).bfloat16().float().numpy()
    Gt = rng.standard_normal((B, r, N_)).astype(np.float32)
    Mo = rng.standard_normal((B, r, N_)).astype(np.float32) * 0.1
    Vo = np.abs(rng.standard_normal((B, r, N_))).astype(np.float32) * 0.01
    phi = np.abs(rng.standard_normal((B, N_))).astype(np.float32)
    clip = np.asarray([1.0, 0.5, 0.125], np.float32)
    P = (rng.standard_normal((B, M_, N_)) * 0.1).astype(np.float32)
    P = torch.tensor(P).bfloat16().float().numpy()
    return dict(S=S, G=G, Gt=Gt, M=Mo, V=Vo, phi=phi, clip=clip, P=P)


def _t(a, dtype="float32"):
    return torch.tensor(a).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a, jnp.dtype(dtype))


def _close(got, want, scaled=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = 1e-5 * (np.abs(want).max() if scaled else 1.0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5)


def _within_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor):
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    _, exp = torch.frexp(w)
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      torch.ldexp(torch.ones_like(w), exp - 8))
    # the fp32 value carries its own 1e-5 (of the largest entry) before
    # the rounding, which decides entries that cancel to near zero
    bad = (g - w).abs() > ulp + 1e-5 * w.abs().max()
    assert not bad.any(), f"{int(bad.sum())} entries differ by > 1 ulp"


R_G = pytest.mark.parametrize("r,gdtype", [(32, "float32"),
                                           (32, "bfloat16"),
                                           (128, "float32"),
                                           (128, "bfloat16")])


# ---------------------------------------------------------------------------
# The port's oracles against the JAX oracles
# ---------------------------------------------------------------------------


@R_G
def test_projection_oracles_match_jax(r, gdtype):
    x = _inputs(r, gdtype)
    S, G = _t(x["S"]), _t(x["G"], gdtype)
    jS, jG = _j(x["S"]), _j(x["G"], gdtype)
    _close(ref.project_ref(S, G), jax.vmap(jref.project_ref)(jS, jG))
    A, gsq = ref.project_colnorms_ref(S, G)
    jA, jgsq = jax.vmap(jref.project_colnorms_ref)(jS, jG)
    _close(A, jA)
    _close(gsq, jgsq)
    _close(ref.tangent_ref(G, A, S), jax.vmap(jref.tangent_ref)(jG, jA, jS),
           scaled=True)
    for got, want in zip(ref.project_tangent_colnorms_ref(S, G),
                         jax.vmap(jref.project_tangent_colnorms_ref)(jS, jG)):
        _close(got, want, scaled=True)


@pytest.mark.parametrize("r", [32, 128])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_adam_oracles_match_jax(r, bias_correction):
    x = _inputs(r, "float32")
    args = (_t(x["Gt"]), _t(x["M"]), _t(x["V"]))
    jargs = (_j(x["Gt"]), _j(x["M"]), _j(x["V"]))
    got = ref.adam_lowrank_norms_ref(*args, 6, 0.9, 0.999, 1e-8,
                                     bias_correction)
    want = jax.vmap(lambda g, m, v: jref.adam_lowrank_norms_ref(
        g, m, v, jnp.int32(6), 0.9, 0.999, 1e-8, bias_correction))(*jargs)
    for g, w in zip(got, want):
        _close(g, w)
    for g, w in zip(ref.adam_lowrank_ref(*args, 6, 0.9, 0.999, 1e-8,
                                         bias_correction),
                    jref.adam_lowrank_ref(*jargs, jnp.int32(6), 0.9, 0.999,
                                          1e-8, bias_correction)):
        _close(g, w)


@R_G
@pytest.mark.parametrize("recovery", [True, False])
@pytest.mark.parametrize("decay", [True, False])
def test_fused_update_oracle_matches_jax(r, gdtype, recovery, decay):
    """All four variants, bf16 output, per-matrix clips."""
    x = _inputs(r, gdtype)
    Gto = x["Gt"] * 0.5
    clip, coef, wd = x["clip"], 0.003, 1e-4

    def jax_one(G, S, Gt, Gto, phi, c, P):
        return jref.fused_update_ref(
            G if recovery else None, S, Gt if recovery else None, Gto,
            phi if recovery else None, jnp.float32(coef), c,
            out_dtype=jnp.bfloat16, param=P if decay else None,
            wd_coef=jnp.float32(wd) if decay else None)

    want = jax.vmap(jax_one)(_j(x["G"], gdtype), _j(x["S"]), _j(x["Gt"]),
                             _j(Gto), _j(x["phi"]), _j(clip),
                             _j(x["P"], "bfloat16"))
    got = ref.fused_update_ref(
        _t(x["G"], gdtype) if recovery else None, _t(x["S"]),
        _t(x["Gt"]) if recovery else None, _t(Gto),
        _t(x["phi"]) if recovery else None, coef,
        _t(clip) if recovery else 1.0, out_dtype=torch.bfloat16,
        param=_t(x["P"], "bfloat16") if decay else None,
        wd_coef=wd if decay else None)
    _within_one_bf16_ulp(got, _t(np.asarray(want, np.float32), "bfloat16"))


# ---------------------------------------------------------------------------
# The Pallas kernels (interpret mode) against the port's oracles
# ---------------------------------------------------------------------------


def _pallas(fn, *args, **kw):
    return jax.vmap(lambda *a: fn(*a, interpret=True, **kw))(*args)


@R_G
def test_pallas_projection_kernels_match_port_oracles(r, gdtype):
    x = _inputs(r, gdtype)
    S, G = _t(x["S"]), _t(x["G"], gdtype)
    jS, jG = _j(x["S"]), _j(x["G"], gdtype)
    _close(_pallas(pallas.project, jS, jG), ref.project_ref(S, G))
    A, gsq = ref.project_colnorms_ref(S, G)
    pA, pgsq = _pallas(pallas.project_colnorms, jS, jG)
    _close(pA, A)
    _close(pgsq, gsq)
    _close(_pallas(pallas.tangent, jG, _j(A.numpy()), jS),
           ref.tangent_ref(G, A, S), scaled=True)


@pytest.mark.parametrize("r", [32, 128])
def test_pallas_adam_norms_matches_port_oracle(r):
    x = _inputs(r, "float32")
    want = ref.adam_lowrank_norms_ref(_t(x["Gt"]), _t(x["M"]), _t(x["V"]),
                                      4, 0.9, 0.999, 1e-8)
    got = jax.vmap(lambda g, m, v: pallas.adam_lowrank_norms(
        g, m, v, jnp.int32(4), interpret=True))(
            _j(x["Gt"]), _j(x["M"]), _j(x["V"]))
    for g, w in zip(got, want):
        _close(g, w)


@R_G
@pytest.mark.parametrize("recovery", [True, False])
@pytest.mark.parametrize("decay", [True, False])
def test_pallas_fused_update_matches_port_oracle(r, gdtype, recovery, decay):
    x = _inputs(r, gdtype)
    Gto = x["Gt"] * 0.5
    coef, wd = 0.003, 1e-4

    def one(G, S, Gt, Gto, phi, c, P):
        return pallas.fused_update(
            G if recovery else None, S, Gt if recovery else None, Gto,
            phi if recovery else None, jnp.float32(coef), c,
            out_dtype=jnp.bfloat16, param=P if decay else None,
            wd_coef=jnp.float32(wd) if decay else None, interpret=True)

    got = jax.vmap(one)(_j(x["G"], gdtype), _j(x["S"]), _j(x["Gt"]), _j(Gto),
                        _j(x["phi"]), _j(x["clip"]), _j(x["P"], "bfloat16"))
    want = ref.fused_update_ref(
        _t(x["G"], gdtype) if recovery else None, _t(x["S"]),
        _t(x["Gt"]) if recovery else None, _t(Gto),
        _t(x["phi"]) if recovery else None, coef,
        _t(x["clip"]) if recovery else 1.0, out_dtype=torch.bfloat16,
        param=_t(x["P"], "bfloat16") if decay else None,
        wd_coef=wd if decay else None)
    _within_one_bf16_ulp(_t(np.asarray(got, np.float32), "bfloat16"), want)


# ---------------------------------------------------------------------------
# CPU dispatch
# ---------------------------------------------------------------------------


def test_cpu_dispatch_runs_the_oracles_and_launches_nothing():
    x = _inputs(32, "float32")
    S, G = _t(x["S"]), _t(x["G"])
    ops.reset_launch_counts()
    A, gsq, T = ops.project_tangent_colnorms(S, G)
    for got, want in zip((A, gsq, T), ref.project_tangent_colnorms_ref(S, G)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(ops.project(S, G), ref.project_ref(S, G),
                               atol=0, rtol=0)
    ops.adam_lowrank_norms(A, A, A.abs(), 0)
    ops.fused_update(G, S, A, A, gsq, 0.1, 1.0)
    assert all(v == 0 for v in ops.launch_counts().values())


# ---------------------------------------------------------------------------
# The bf16 tensor-core route of project / project_colnorms: S in three
# bf16 terms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,r", [(256, 32), (256, 128), (200, 70),
                                 (1000, 129), (64, 64)])
def test_split_bf16_ref_reconstructs_orthonormal_S_bit_for_bit(m, r):
    """S_hi + S_mid + S_lo == S exactly (in either order of the adds),
    each term bf16, r padded to a multiple of 64 by zeros."""
    rng = np.random.default_rng(m + r)
    S = _t(np.linalg.qr(rng.standard_normal((B, m, r)))[0].astype(
        np.float32))
    split = ref.split_bf16_ref(S)
    r_pad = -(-r // 64) * 64
    assert split.dtype == torch.bfloat16
    assert tuple(split.shape) == (B, 3, m, r_pad)
    hi, mid, lo = (split[:, k].float() for k in range(3))
    assert torch.equal((hi + mid + lo)[..., :r], S)
    assert torch.equal((hi + (mid + lo))[..., :r], S)
    assert not split[..., r:].float().any()
    # each term is the rounding of what the terms before it left
    assert torch.equal(split[:, 0, :, :r], S.bfloat16())
    assert (lo.abs() <= mid.abs()).all() and (mid.abs() <= hi.abs()).all()


@pytest.mark.parametrize("m,n,r", [(256, 512, 32), (1000, 777, 129),
                                   (2048, 96, 64)])
def test_three_bf16_passes_with_bf16_G_hold_fp32_accuracy(m, n, r):
    """sum_k S_k^T G in fp32 (the products exact, as in the tensor cores)
    is within 2e-5 of the largest entry of the fp64 product: the budget
    of the bf16 route (``OPT_REL`` / ``REL``)."""
    rng = np.random.default_rng(n)
    S64 = np.linalg.qr(rng.standard_normal((2, m, r)))[0]
    S = _t(S64.astype(np.float32))
    G = _t(rng.standard_normal((2, m, n)).astype(np.float32), "bfloat16")
    split = ref.split_bf16_ref(S)[..., :r].float()
    A = sum(split[:, k].mT @ G.float() for k in range(3))
    want = S.double().mT @ G.double()
    rel = ((A.double() - want).abs().max() / want.abs().max()).item()
    assert rel < 2e-5
    # one bf16 term alone is far outside that budget
    one = (split[:, 0].mT @ G.float()).double()
    assert ((one - want).abs().max() / want.abs().max()).item() > 2e-4


def test_split_bf16_wrapper_needs_the_card():
    from repro_torch.kernels import grassmann as gk
    S = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match="CUDA device"):
        gk.split_bf16(S)
