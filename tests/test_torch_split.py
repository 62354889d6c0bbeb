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
  grad_tap's dW, A = (x S)^T dy and column norms;
* the tracking front end's two kernels with bf16 G: ``tangent`` (G exact
  against A's three terms; A A^T and S (2C) over 6 term products) and
  ``project_tangent_colnorms`` (S's terms against G per 128-row rank, the
  ranks summed in order, G against A re-split; S^T W and S (2C) over 6
  term products), each against fp64 at r =
  1024 and against the JAX Pallas kernels in interpret mode (T within 1e-4
  of its largest entry, A and the norms within 2e-5);
* the unfused schedule's ``backproject`` (#2) and ``recovery`` (#4), one
  main loop (S and X or Gt split, 6 term products) with two epilogues:
  against fp64 at r = 512, G's residual and phi too (within 1e-6 of the
  largest entry), and against the JAX Pallas kernels (within 1e-5);
* ``tangent_gram`` (#8): T^T G over T's three terms against G's one (bf16
  G) and the three Grams over 6 term products, against fp64 at r = 1024
  (within 1e-6; S^T T, analytically zero, judged against max |T|) and
  against the JAX Pallas kernel in interpret mode (within 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import grassmann as jgrassmann
from repro.kernels import ref as jref
from repro_torch.kernels import ref
from torch_threads import one_thread  # noqa: F401


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


# ---------------------------------------------------------------------------
# The tracking step's front end on the tensor cores: tangent (#3) and
# project_tangent_colnorms (#6), bf16 G
# ---------------------------------------------------------------------------

# one exact bf16 term of G against A's three: lo, mid, hi
G_PASSES = ((0, 2), (0, 1), (0, 0))


def _passes(total, a, b, passes, k_tile=64):
    """``total`` plus the products of the term pairs ``passes`` of a (terms,
    M, K) and b (terms, K, N): per ``k_tile``-deep slice of K a fresh fp32
    sum, added into the fp32 total (the kernels' flush)."""
    for k0 in range(0, a.shape[-1], k_tile):
        total = total + sum(a[i, :, k0:k0 + k_tile] @ b[j, k0:k0 + k_tile]
                            for i, j in passes)
    return total


def _emulated_tangent(G, A, S):
    """tangent's bf16 route: W = G A^T over n (G one exact term, A's three),
    C = A A^T (6 products of A's terms), then -2 W + S (2C) (6 products of
    S's and 2C's terms) on the same total."""
    (m, r), a = S.shape, ref.split3_ref(A).float()
    W = _passes(torch.zeros(m, r), G[None], a.mT, G_PASSES)
    C = _passes(torch.zeros(r, r), a, a.mT, ref.UPDATE_PASSES)
    return _passes(-2.0 * W, ref.split3_ref(S).float(),
                   ref.split3_ref(2.0 * C).float(), ref.UPDATE_PASSES)


def _emulated_front(G, S, rows=128, n_tile=128):
    """project_tangent_colnorms' bf16 route: per 128-row rank one fp32 sum
    A^k = S_k^T G_k over S's three terms, the ranks (and their column
    norms) added in rank order; W += G A^T per 128-column n-tile over A's
    three terms; the tail: C = S^T W (6 products of S's and W's terms),
    then S (2C) (6 products of S's and 2C's terms) - 2 W."""
    (m, n), r = G.shape, S.shape[1]
    s = ref.split3_ref(S).float()
    A, gsq = torch.zeros(r, n), torch.zeros(n)
    for i0 in range(0, m, rows):
        Gk = G[i0:i0 + rows]
        A = A + sum(s[t, i0:i0 + rows].mT @ Gk for t in (2, 1, 0))
        gsq = gsq + (Gk * Gk).sum(0)
    W = _passes(torch.zeros(m, r), G[None], ref.split3_ref(A).float().mT,
                G_PASSES, k_tile=n_tile)
    C = _passes(torch.zeros(r, r), s.mT, ref.split3_ref(W).float(),
                ref.UPDATE_PASSES)
    T = _passes(torch.zeros(m, r), s, ref.split3_ref(2.0 * C).float(),
                ref.UPDATE_PASSES)
    return A, gsq, T - 2.0 * W


@pytest.fixture(scope="module")
def front_r1024(factors_r1024):
    """The orthonormal S (1200, 1024), a bf16-exact G (1200, 300) and A =
    S^T G in fp32, with G, S and the exact T in fp64."""
    S = factors_r1024[0]
    rng = np.random.default_rng(6)
    G = torch.tensor(rng.standard_normal((1200, 300))).bfloat16().float()
    A = S.mT @ G
    G64, S64, A64 = G.double(), S.double(), A.double()
    T64 = -2.0 * G64 @ A64.mT + 2.0 * S64 @ (A64 @ A64.mT)
    return G, S, A, T64


@pytest.mark.parametrize("product", ["G A^T", "A A^T", "S (2C)"])
def test_tangent_pass_sets_against_fp64_at_r_1024(front_r1024, product):
    """G x A's 3 terms drops nothing (G is exact in one term); A A^T and
    S (2C) over the 6 products of order >= 2^-16 stay within 2e-8 of the
    largest entry."""
    G, S, A, _ = front_r1024
    a = ref.split3_ref(A).double()
    if product == "G A^T":
        got, want, bound = sum(G.double() @ a[j].mT for _, j in G_PASSES), \
            G.double() @ A.double().mT, 1e-12
    elif product == "A A^T":
        got = sum(a[i] @ a[j].mT for i, j in ref.UPDATE_PASSES)
        want, bound = A.double() @ A.double().mT, 2e-8
    else:
        C2 = 2.0 * (A @ A.mT)
        s, c = ref.split3_ref(S).double(), ref.split3_ref(C2).double()
        got = sum(s[i] @ c[j] for i, j in ref.UPDATE_PASSES)
        want, bound = S.double() @ C2.double(), 2e-8
    assert _rel(got, want) < bound


def test_emulated_tangent_against_fp64_at_r_1024(front_r1024):
    """The whole bf16 route in fp32 with its per-k-tile flushes: within 1e-5
    of T's largest entry (budget 1e-4), no worse than twice the plain fp32
    expression."""
    G, S, A, T64 = front_r1024
    got = _emulated_tangent(G, A, S)
    assert got.dtype == torch.float32
    assert _rel(got, T64) < 1e-5
    assert _rel(got, T64) < 2 * _rel(ref.tangent_ref(G, A, S), T64)


def test_emulated_front_against_fp64_at_r_1024(front_r1024):
    """#6's bf16 route: A and the norms within 1e-6 of their largest entry
    (budget 2e-5), T within 1e-5 (budget 1e-4)."""
    G, S, A, T64 = front_r1024
    A_got, gsq, T = _emulated_front(G, S)
    assert _rel(A_got, S.double().mT @ G.double()) < 1e-6
    assert _rel(gsq, (G.double() ** 2).sum(0)) < 1e-6
    assert _rel(T, T64) < 1e-5


def _front_case(m, n, r, seed):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((m, n)).astype(np.float32)
    G = torch.tensor(G).bfloat16().float().numpy()        # bf16 G, exactly
    S = np.linalg.qr(rng.standard_normal((m, r)))[0].astype(np.float32)
    return G, S


@pytest.mark.parametrize("m,n,r", [(256, 512, 96), (256, 256, 130)])
def test_emulated_tangent_matches_jax(m, n, r):
    """The emulated route against the JAX Pallas kernel in interpret mode on
    the same numpy inputs: T within 1e-4 of its largest entry."""
    G, S = _front_case(m, n, r, 7 + r)
    A = S.T @ G
    want = jax.device_get(jgrassmann.tangent(
        jnp.asarray(G), jnp.asarray(A), jnp.asarray(S), interpret=True))
    got = _emulated_tangent(torch.tensor(G), torch.tensor(A), torch.tensor(S))
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("m,n,r", [(256, 512, 96), (300, 512, 70)])
def test_emulated_front_matches_jax(m, n, r):
    """#6's emulated route (2 or 3 ranks, a ragged last one) against the JAX
    Pallas kernel in interpret mode: A and the norms within 2e-5 of their
    largest entry, T within 1e-4."""
    G, S = _front_case(m, n, r, 8 + m)
    want = jax.device_get(jgrassmann.project_tangent_colnorms(
        jnp.asarray(S), jnp.asarray(G), interpret=True))
    got = _emulated_front(torch.tensor(G), torch.tensor(S))
    for g, w, tol in zip(got, want, (2e-5, 2e-5, 1e-4)):
        assert _rel(g, w) < tol


# ---------------------------------------------------------------------------
# backproject (#2) on the engine: S and X split, 6 term products
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def backproject_r512():
    """llama-1b's rank: an orthonormal S (1200, 512), a general X (512,
    300) in fp32, and S X in fp64."""
    rng = np.random.default_rng(9)
    S = torch.tensor(np.linalg.qr(rng.standard_normal((1200, 512)))[0],
                     dtype=torch.float32)
    X = torch.tensor(rng.standard_normal((512, 300)), dtype=torch.float32)
    return S, X, S.double() @ X.double()


@pytest.mark.parametrize("passes,bound", [
    (ref.UPDATE_PASSES, 2e-8),                  # the kernel's 6 products
    (((1, 0), (0, 1), (0, 0)), None),           # the 3 largest alone
])
def test_backproject_pass_set_against_fp64_at_r_512(backproject_r512,
                                                    passes, bound):
    S, X, exact = backproject_r512
    s, x = ref.split3_ref(S).double(), ref.split3_ref(X).double()
    err = _rel(sum(s[i] @ x[j] for i, j in passes), exact)
    if bound is not None:
        assert err < bound
    else:   # not taken: past a twentieth of FRONT_REL's 2e-5
        assert err > 1e-6


def _recovery_case(S, seed, gt=None):
    """A bf16-exact G (m, 300) and phi (300,) for S (m, r), and Gt: the
    given one, or S^T G (the unfused step's, whose residual G - S Gt is
    G's part off S's span)."""
    rng = np.random.default_rng(seed)
    G = torch.tensor(rng.standard_normal((S.shape[0], 300))).bfloat16().float()
    phi = torch.tensor(np.abs(rng.standard_normal(300)), dtype=torch.float32)
    return G, S.mT @ G if gt is None else gt, phi


@pytest.mark.parametrize("epilogue", ["backproject", "recovery",
                                      "recovery of S^T G"])
def test_backproject_arithmetic_against_fp64_at_r_512(backproject_r512,
                                                      epilogue):
    """The engine's fp32 sums per 64-deep k-tile of the 6 exact term
    products, flushed into an fp32 total: within 1e-6 of the largest entry
    (budget 2e-5), no worse than twice a plain fp32 product.  recovery's
    epilogue (g - total) * phi_j, fp32 as the kernel rounds it, holds the
    same against (G - S Gt) * phi in fp64, for a general Gt and for the
    unfused step's Gt = S^T G."""
    S, X, exact = backproject_r512
    if epilogue == "backproject":
        got, plain = ref.split_matmul_ref(S, X), S @ X
    else:
        G, Gt, phi = _recovery_case(
            S, 13, gt=X if epilogue == "recovery" else None)
        got = (G - ref.split_matmul_ref(S, Gt)) * phi
        plain = (G - S @ Gt) * phi
        exact = (G.double() - S.double() @ Gt.double()) * phi.double()
    assert _rel(got, exact) < 1e-6
    assert _rel(got, exact) < 2 * _rel(plain, exact)


@pytest.mark.parametrize("kernel", ["backproject", "recovery fp32",
                                    "recovery bf16"])
@pytest.mark.parametrize("m,n,r", [(256, 512, 96), (512, 256, 70)])
def test_emulated_backproject_matches_jax(m, n, r, kernel):
    """The emulated route against the JAX Pallas kernel in interpret mode on
    the same numpy inputs: within 1e-5 of the largest entry.  recovery: the
    same main loop with (g - total) * phi_j after it, G in fp32 or bf16
    (G enters only the epilogue, widened to fp32)."""
    rng = np.random.default_rng(10 + r)
    S = np.linalg.qr(rng.standard_normal((m, r)))[0].astype(np.float32)
    X = rng.standard_normal((r, n)).astype(np.float32)
    total = ref.split_matmul_ref(torch.tensor(S), torch.tensor(X))
    if kernel == "backproject":
        want = jax.device_get(jgrassmann.backproject(
            jnp.asarray(S), jnp.asarray(X), interpret=True))
        assert _rel(total, want) < 1e-5
        return
    G = rng.standard_normal((m, n)).astype(np.float32)
    phi = np.abs(rng.standard_normal(n)).astype(np.float32)
    jG = jnp.asarray(G, jnp.bfloat16 if kernel.endswith("bf16") else
                     jnp.float32)
    want = jax.device_get(jgrassmann.recovery(
        jG, jnp.asarray(S), jnp.asarray(X), jnp.asarray(phi), interpret=True))
    g = torch.tensor(np.asarray(jG.astype(jnp.float32)))
    got = (g - total) * torch.tensor(phi)
    assert _rel(got, want) < 1e-5


# ---------------------------------------------------------------------------
# tangent_gram (#8) on the engine: T^T G over T's three terms, the Grams
# over 6 term products
# ---------------------------------------------------------------------------

# T's lo, mid, hi against G's one exact bf16 term
TTG_PASSES = ((2, 0), (1, 0), (0, 0))


def _emulated_tangent_gram(S, T, G, bf16_g=True):
    """tangent_gram's routes: T^T G over T's three terms against bf16 G's
    one (fp32 G: the CUDA cores' plain fp32 product), the Grams S^T T, T^T
    T, S^T S over 6 term products, per 64-deep k-tile of m a fresh fp32
    sum flushed into an fp32 total."""
    TtG = (ref.split_matmul_ref(T.mT, G, TTG_PASSES) if bf16_g
           else T.mT @ G)
    return (TtG, *(ref.split_matmul_ref(X.mT, Y)
                   for X, Y in ((S, T), (T, T), (S, S))))


def _gram_rel(got, want, T) -> list[float]:
    """Each output's error over its largest entry; S^T T, analytically
    zero, over max |T| (as tests/test_kernels.py judges the TPU kernel)."""
    tmax = float(np.abs(np.asarray(T, np.float64)).max())
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        errs.append(float(np.abs(g - w).max())
                    / (tmax if i == 1 else float(np.abs(w).max())))
    return errs


def test_tangent_gram_arithmetic_against_fp64_at_r_1024(front_r1024):
    """T^T G (bf16 G exact in one term: only the fp32 sums round) and the
    three Grams (6 term products) at r = 1024 over m = 1200: each within
    1e-6 of its largest entry (budget 2e-5), S^T T of max |T|."""
    G, S, _, T64 = front_r1024
    T = T64.float()
    got = _emulated_tangent_gram(S, T, G)
    Sd, Td, Gd = S.double(), T.double(), G.double()
    exact = (Td.mT @ Gd, Sd.mT @ Td, Td.mT @ Td, Sd.mT @ Sd)
    errs = _gram_rel(got, exact, T)
    assert max(errs) < 1e-6, errs


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,r", [(256, 512, 96), (512, 256, 70)])
def test_emulated_tangent_gram_matches_jax(m, n, r, gdtype):
    """The emulated routes against the JAX Pallas kernel in interpret mode
    on the same numpy inputs (m = 512: two of its m blocks): every output
    within 2e-5 of its largest entry, S^T T of max |T|."""
    G, S = _front_case(m, n, r, 14 + m + r)
    if gdtype == "float32":
        G = np.random.default_rng(m).standard_normal((m, n)).astype(np.float32)
    T = ref.tangent_ref(torch.tensor(G), torch.tensor(S.T @ G),
                        torch.tensor(S))
    want = jax.device_get(jgrassmann.tangent_gram(
        jnp.asarray(S), jnp.asarray(T.numpy()), jnp.asarray(G),
        interpret=True))
    got = _emulated_tangent_gram(torch.tensor(S), T, torch.tensor(G),
                                 bf16_g=gdtype == "bfloat16")
    errs = _gram_rel(got, want, T)
    assert max(errs) < 2e-5, errs


# ---------------------------------------------------------------------------
# flash_attention's bf16 route (#13): P split in bf16 terms for P V
# ---------------------------------------------------------------------------


def _attention64(q, k, v, rows, causal, window, softcap):
    """Attention in fp64 for the query rows ``rows``: the exact values the
    bf16 route is held to.  q (B, S, Hq, hd), k and v (B, T, Hkv, hd)."""
    Hq, Hkv, hd = q.shape[2], k.shape[2], q.shape[3]
    qd = q.double()[:, rows].transpose(1, 2)
    kd = k.double().repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
    vd = v.double().repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
    s = (qd @ kd.mT) / np.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    k_pos, q_pos = torch.arange(k.shape[1])[None], rows[:, None]
    mask = torch.ones(s.shape[-2:], dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return ((p @ vd) / p.sum(dim=-1, keepdim=True)).transpose(1, 2)


def _bf16_excess(got, want) -> float:
    """chip_smoke.py's bf16 budget (FLASH_TOL): the largest (|error| -
    allowed) / allowed, allowed one bf16 ulp of ``want`` plus 1e-5 (1 +
    |want|); <= 0 holds."""
    g, w = got.bfloat16().double(), want.double()
    _, e = torch.frexp(w)
    allowed = (torch.where(w == 0, torch.zeros_like(w),
                           torch.ldexp(torch.ones_like(w), e - 8))
               + 1e-5 * (1 + w.abs()))
    return (((g - w).abs() - allowed) / allowed).max().item()


# (B, S = T, Hq, Hkv, hd, causal, window, softcap), heads cut from 32 to 2;
# gemma2's 8192 query rows cut to every 32nd and the last 64 (rows are
# independent: each still sees its whole key range)
FLASH_SPLIT_CASES = {
    "llama-7b prefill": (1, 2048, 2, 2, 128, True, 0, 0.0),
    "gemma2-27b local": (1, 8192, 2, 1, 128, True, 4096, 50.0),
}


@pytest.mark.parametrize("case", list(FLASH_SPLIT_CASES))
@pytest.mark.parametrize("terms", [1, 2, 3])
def test_flash_p_terms_against_fp64(case, terms):
    """One bf16 term of P (SDPA's P) breaks the bf16 budget against the
    exact output many times over; two terms (what is left is at most 2^-17
    of p) stay within 1e-5 absolute of fp64 and hold the budget, as three
    do.  The kernel takes two."""
    B, S, Hq, Hkv, hd, causal, window, softcap = FLASH_SPLIT_CASES[case]
    rng = np.random.default_rng(11)
    q, k, v = (torch.tensor(rng.standard_normal((B, S, h, hd)),
                            dtype=torch.float32).bfloat16()
               for h in (Hq, Hkv, Hkv))
    rows = (torch.arange(S) if S <= 2048
            else torch.cat([torch.arange(0, S - 64, 32),
                            torch.arange(S - 64, S)]))
    kw = dict(causal=causal, window=window, softcap=softcap)
    exact = _attention64(q, k, v, rows, **kw)
    got = ref.flash_attention_split_ref(q, k, v, terms=terms, rows=rows, **kw)
    if terms == 1:
        assert _bf16_excess(got, exact) > 10
    else:
        assert (got.double() - exact).abs().max().item() < 1e-5
        assert _bf16_excess(got, exact) <= 0
    assert ref.FLASH_P_TERMS == 2


# ---------------------------------------------------------------------------
# The unfused step's CUDA-vs-CPU budget (tests/test_torch_kernels_cuda.py)
# ---------------------------------------------------------------------------


def test_unfused_step_fp32_chain_against_fp64():
    """The CUDA test ``test_unfused_step_launches_project_backproject_
    recovery`` holds the card's unfused step against the same step in fp64
    at 2e-5 of the largest entry.  The chain's one ill-conditioned stage is
    Adam's 1/(sqrt(V) + eps) where Gt and V are both small; over 100 draws
    of that test's inputs (S orthonormal (300, 32), bf16 G (300, 500), M =
    0.1 N(0, 1), V = 0.01 |N(0, 1)|, lam_prev [0, 0.5], step 3; a batch of
    200 matrices) the fp32 chain stays within 1e-5 of fp64 in delta and in
    lam_prev: half that budget."""
    from repro_torch.core import lowrank_adam as tla
    from repro_torch.kernels import ops
    from repro_torch.launch.probe_unfused import Fp64Backend

    draws = 100
    rng = np.random.default_rng(12)
    S = torch.tensor(np.linalg.qr(rng.standard_normal((2 * draws, 300, 32)))[0],
                     dtype=torch.float32)
    G = torch.tensor(rng.standard_normal((2 * draws, 300, 500)),
                     dtype=torch.float32).bfloat16()
    M = 0.1 * torch.tensor(rng.standard_normal((2 * draws, 32, 500)),
                           dtype=torch.float32)
    V = 0.01 * torch.tensor(np.abs(rng.standard_normal((2 * draws, 32, 500))),
                            dtype=torch.float32)
    st = tla.MatrixOptState(S=S, M=M, V=V,
                            lam_prev=torch.tensor([0.0, 0.5]).repeat(draws))
    out = tla.lowrank_adam_step(G, st, 3, tla.AdamHP(), backend=ops)
    exact = tla.lowrank_adam_step(G, tla.MatrixOptState(*(t.double() for t in st)),
                                  3, tla.AdamHP(), backend=Fp64Backend())
    for got, want in ((out.delta, exact.delta),
                      (out.state.lam_prev, exact.state.lam_prev)):
        err = ((got.double() - want).abs().reshape(draws, -1).amax(1)
               / want.abs().reshape(draws, -1).amax(1))
        assert 0 < err.max().item() < 1e-5
