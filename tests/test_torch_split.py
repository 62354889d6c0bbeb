"""The bf16 three-term split of fp32 factors, the tensor-core kernels'
arithmetic, on the CPU.

``fused_update`` (both factors fp32) and ``grad_tap``'s bf16 route (S and
P = x S fp32) run on the bf16 tensor cores over factors split into three
exact bf16 terms (``ref.split3_ref``) and sum a chosen set of term
products per 64-deep k-tile into an fp32 total.  Here, without a card:

* the split rebuilds a general fp32 tensor (the update's direction D, not
  only an orthonormal S) bit for bit over magnitudes 1e-6 to 1e30, and the
  direction's split oracle is that split of D;
* the update's 6 term products (``ref.UPDATE_PASSES``) differ from the
  fp64 product by at most 2e-8 of the largest entry at r = 1024 (6.0e-9
  measured), where the 3 largest alone differ by more than 1e-6 (a
  quarter of the 2e-5 budget before any accumulation error); the kernel's
  fp32 arithmetic (``ref.split_matmul_ref``) stays within 1e-6;
* that arithmetic, run through each kernel's schedule, matches the JAX
  package's oracles (``repro.kernels.ref``) on the same numpy inputs within
  their 1e-5 of the largest entry: the update in all four variants, and
  grad_tap's dW, A = (x S)^T dy and column norms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref


def _rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got, np.float64))
    want = torch.as_tensor(np.asarray(want, np.float64))
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("magnitude", [1e-6, 1e-3, 1.0, 1e3, 1e10, 1e20,
                                       1e30])
def test_split3_rebuilds_general_fp32_bit_for_bit(magnitude):
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((96, 130)) * magnitude,
                     dtype=torch.float32)
    terms = ref.split3_ref(x)
    assert terms.dtype == torch.bfloat16 and terms.shape == (3, 96, 130)
    hi, mid, lo = terms.float()
    assert torch.equal((hi + mid) + lo, x)
    assert torch.equal(hi, x.bfloat16().float())
    # each term holds what the terms before it left, to within its rounding
    assert (mid.abs() <= (x - hi).abs() * (1 + 2 ** -8)).all()


def test_split3_loses_at_most_a_subnormal_ulp_of_bf16_far_below_one():
    """Where the lo term falls below bf16's normal range (|x| < ~1e-33)
    it rounds to a subnormal: at most half its spacing, 2^-134, is lost."""
    x = torch.logspace(-36, -30, 500, dtype=torch.float64).float()
    x = torch.stack([x, -x])
    hi, mid, lo = ref.split3_ref(x).double()
    assert ((hi + mid + lo) - x.double()).abs().max().item() <= 2.0 ** -134


@pytest.mark.parametrize("recovery", [True, False])
def test_split_direction_is_the_split_of_the_direction(recovery):
    rng = np.random.default_rng(2)
    Gto, Gt = (torch.tensor(rng.standard_normal((3, 40, 70)),
                            dtype=torch.float32) for _ in range(2))
    phi = torch.tensor(np.abs(rng.standard_normal((3, 70))),
                       dtype=torch.float32)
    clip = torch.tensor([1.0, 0.5, 0.125])
    got = ref.split_direction_ref(Gto, Gt if recovery else None,
                                  phi if recovery else None, clip)
    D = Gto - (phi * clip[:, None])[:, None, :] * Gt if recovery else Gto
    assert got.shape == (3, 3, 40, 70)
    assert torch.equal(got, ref.split3_ref(D))
    assert torch.equal(got.float().sum(-3), D)


@pytest.fixture(scope="module")
def factors_r1024():
    """An orthonormal S (1200, 1024) and a general D (1024, 300) in fp32,
    and their product in fp64."""
    rng = np.random.default_rng(3)
    S = torch.tensor(np.linalg.qr(rng.standard_normal((1200, 1024)))[0],
                     dtype=torch.float32)
    D = torch.tensor(rng.standard_normal((1024, 300)), dtype=torch.float32)
    return S, D, S.double() @ D.double()


@pytest.mark.parametrize("passes,bound", [
    (ref.UPDATE_PASSES, 2e-8),                  # the kernel's 6 products
    (((1, 0), (0, 1), (0, 0)), None),           # the 3 largest alone
])
def test_update_pass_set_against_fp64_at_r_1024(factors_r1024, passes,
                                                 bound):
    S, D, exact = factors_r1024
    s, d = ref.split3_ref(S).double(), ref.split3_ref(D).double()
    err = _rel(sum(s[i] @ d[j] for i, j in passes), exact)
    if bound is not None:
        assert err < bound
    else:   # not taken: a quarter of OPT_REL's 2e-5 before accumulation
        assert err > 1e-6


def test_kernel_arithmetic_against_fp64_at_r_1024(factors_r1024):
    """fp32 sums per 64-deep k-tile of exact term products, flushed into an
    fp32 total: within 1e-6 of the largest entry, as good as an fp32 GEMM."""
    S, D, exact = factors_r1024
    got = ref.split_matmul_ref(S, D)
    assert got.dtype == torch.float32
    assert _rel(got, exact) < 1e-6
    assert _rel(got, exact) < 2 * _rel(S @ D, exact)


# ---------------------------------------------------------------------------
# The kernels' schedules on the emulated arithmetic, against JAX
# ---------------------------------------------------------------------------

M_, N_, R_ = 200, 150, 96


@pytest.mark.parametrize("recovery", [True, False])
@pytest.mark.parametrize("decay", [True, False])
def test_emulated_update_matches_jax(recovery, decay):
    """S D (6 term products, per-k-tile flush) + G phi clip, scaled by -coef,
    minus wd param: the fused update's kernel schedule, in fp32 out."""
    rng = np.random.default_rng(4)
    S = np.linalg.qr(rng.standard_normal((M_, R_)))[0].astype(np.float32)
    G = rng.standard_normal((M_, N_)).astype(np.float32)
    Gt = rng.standard_normal((R_, N_)).astype(np.float32)
    Gto = (0.5 * rng.standard_normal((R_, N_))).astype(np.float32)
    phi = np.abs(rng.standard_normal(N_)).astype(np.float32)
    P = (0.1 * rng.standard_normal((M_, N_))).astype(np.float32)
    coef, clip, wd = 0.003, 0.5, 1e-3
    t = torch.tensor
    D = ref.split_direction_ref(t(Gto), t(Gt) if recovery else None,
                                t(phi) if recovery else None, clip)
    D = D.float().sum(-3)
    acc = ref.split_matmul_ref(t(S), D)
    if recovery:
        acc = acc + t(G) * (t(phi) * clip)
    got = -coef * acc
    if decay:
        got = got - wd * t(P)
    want = jref.fused_update_ref(
        jnp.asarray(G) if recovery else None, jnp.asarray(S),
        jnp.asarray(Gt) if recovery else None, jnp.asarray(Gto),
        jnp.asarray(phi) if recovery else None, jnp.float32(coef),
        jnp.float32(clip), param=jnp.asarray(P) if decay else None,
        wd_coef=jnp.float32(wd) if decay else None)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("b", [64, 130])
def test_emulated_grad_tap_matches_jax(b):
    """grad_tap's bf16 route: dW = x^T dy in one exact pass, P = x S over
    S's three terms, P split again, A = P^T dy over P's three terms; the
    norms from the fp32 dW."""
    rng = np.random.default_rng(5 + b)
    x = torch.tensor(rng.standard_normal((b, M_))).bfloat16().float()
    dy = torch.tensor(rng.standard_normal((b, N_))).bfloat16().float()
    S = torch.tensor(np.linalg.qr(rng.standard_normal((M_, R_)))[0],
                     dtype=torch.float32)
    split_a = ((2, 0), (1, 0), (0, 0))   # three terms of S or P, one of x or dy
    dW = ref.split_matmul_ref(x.mT.contiguous(), dy, ((0, 0),))
    P_T = ref.split_matmul_ref(S.mT.contiguous(), x.mT.contiguous(), split_a)
    A = ref.split_matmul_ref(P_T, dy, split_a)
    gsq = (dW * dW).sum(0)
    jdW, jA, jgsq = jref.grad_tap_ref(jnp.asarray(x.numpy()),
                                      jnp.asarray(dy.numpy()),
                                      jnp.asarray(S.numpy()))
    for got, want in ((dW, jdW), (A, jA), (gsq, jgsq)):
        assert _rel(got, jax.device_get(want)) < 1e-5
