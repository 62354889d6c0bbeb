"""Grassmannian gradient-subspace tracking — the geometric core of SubTrack++.

Counterpart of ``repro.core.subspace``.  Every function takes a gradient
``G (..., m, n)`` with ``m <= n`` and an orthonormal basis ``S (..., m,
r)``; leading stack dims run batched (the JAX package ``vmap``s one
matrix).  In paper order: the warm-start inits (Eq. 1), the closed-form
projection (Eq. 2-3), the Grassmann tangent (Eq. 4) in its fused form
``-2 G A^T + 2 S (A A^T)``, the top singular triple of the tangent by a
Gram power iteration, and the rank-1 geodesic step (Eq. 5).

``track_subspace`` runs the schedule of the leaf's StepProgram
(``repro_torch.core.program``): the tangent schedule of the replicated and
column programs, or the gram schedule of the row-family programs, whose
collective rounds the program's :class:`~repro_torch.core.program.Exec`
issues by name.  Random draws take an explicit ``torch.Generator``; they
differ from the JAX package's ``jax.random`` draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import program as program_lib
from repro_torch.core.health import THETA_MAX

_TINY = 1e-30


class Rank1Triple(NamedTuple):
    """Top singular triple of the Grassmann tangent ``T (..., m, r)``."""

    sigma: torch.Tensor  # (...,)
    u: torch.Tensor      # (..., m)
    v: torch.Tensor      # (..., r)


# ---------------------------------------------------------------------------
# Subspace initialization (Eq. 1)
# ---------------------------------------------------------------------------


# cuSOLVER's gesvd refuses gemma2-27b's (4608, 256000) embedding gradient
# (CUSOLVER_STATUS_INVALID_VALUE from its workspace query) while it takes
# llama-7b's and qwen2-vl's vocabulary matrices (at most 2.4e8 elements):
# matrices of at least this many elements reduce to their R factor first
GESVD_MAX_ELEMENTS = 1 << 30


def init_subspace_svd(G: torch.Tensor, rank: int) -> torch.Tensor:
    """S_0 = U[:, :r] of the thin SVD of the first gradient (Eq. 1).
    Singular-vector signs may differ from ``jnp.linalg.svd``'s: compare
    bases by their projectors S S^T.

    On CUDA the SVD runs cuSOLVER's QR-based ``gesvd``: the default
    (Jacobi) driver leaves U orthonormal only to ~2e-3, and the faster
    ``gesvda`` fails to converge on a rank-deficient gradient, which every
    gradient of a batch with fewer tokens than m is (``chip_smoke.py``
    times and checks the drivers on the card; numbers in PERF.md).  A
    wide matrix of ``GESVD_MAX_ELEMENTS`` or more, which gesvd refuses,
    first takes the R factor of G^T = Q R (R is m x m): G = R^T Q^T, so
    G's left singular vectors are R^T's, and gesvd factors R^T.  LAPACK's
    gesvd takes the same QR-first path for such shapes."""
    G = G.float()
    driver = None
    if G.device.type == "cuda":
        driver = "gesvd"
        m, n = G.shape[-2:]
        if n > m and m * n >= GESVD_MAX_ELEMENTS:
            G = r_factor_t(G)
    U, _, _ = torch.linalg.svd(G, full_matrices=False, driver=driver)
    return U[..., :rank].contiguous()


def r_factor_t(G: torch.Tensor) -> torch.Tensor:
    """R^T (..., m, m) of the thin QR G^T = Q R of a wide G (..., m, n):
    it has G's left singular vectors and singular values."""
    return torch.linalg.qr(G.mT, mode="r")[1].mT


def init_subspace_randomized(G: torch.Tensor, rank: int, *, seed: int = 0,
                             oversample: int = 8,
                             n_iter: int = 2) -> torch.Tensor:
    """Randomized range finder: orth((G G^T)^q G Omega)[:, :r], with Omega
    drawn from a ``torch.Generator`` seeded by ``seed``."""
    m, n = G.shape[-2:]
    G = G.float()
    k = min(rank + oversample, m)
    gen = torch.Generator(device=G.device).manual_seed(seed)
    omega = torch.randn((n, k), generator=gen, device=G.device)
    Y = G @ omega
    for _ in range(n_iter):
        Y = G @ (G.mT @ Y)
    Q, _ = torch.linalg.qr(Y)
    return Q[..., :rank].contiguous()


def init_subspace_identity(G: torch.Tensor, rank: int) -> torch.Tensor:
    """The first r canonical basis vectors (ablation / bad start)."""
    m = G.shape[-2]
    eye = torch.eye(m, rank, dtype=torch.float32, device=G.device)
    return eye.expand(G.shape[:-2] + (m, rank)).contiguous()


_INIT_METHODS = {
    "svd": init_subspace_svd,
    "randomized": init_subspace_randomized,
    "identity": init_subspace_identity,
}


def init_subspace(G: torch.Tensor, rank: int,
                  method: str = "svd") -> torch.Tensor:
    try:
        fn = _INIT_METHODS[method]
    except KeyError:
        raise ValueError(f"unknown subspace init {method!r}; options: "
                         f"{sorted(_INIT_METHODS)}") from None
    return fn(G, rank)


# ---------------------------------------------------------------------------
# Least-squares projection + Grassmann tangent (Eq. 2-4)
# ---------------------------------------------------------------------------


def project(S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """A* = argmin_A ||S A - G||_F = S^T G (S orthonormal) -> (..., r, n)."""
    return S.mT @ G.float()


def tangent_naive(S, G, A) -> torch.Tensor:
    """Paper-literal tangent: R = G - S A; dF = -2 R A^T (reference)."""
    R = G.float() - S @ A
    return -2.0 * (R @ A.mT)


def tangent_fused(S, G, A) -> torch.Tensor:
    """dF = -2 G A^T + 2 S (A A^T): the residual is never formed."""
    GA = G.float() @ A.mT
    AA = A @ A.mT
    return -2.0 * GA + 2.0 * (S @ AA)


def _top1_gram_power(C: torch.Tensor, *, n_iter: int = 24):
    """(sigma, v) from the (..., r, r) Gram C = T^T T: fixed-count power
    iteration from the uniform start vector, sigma by the Rayleigh
    quotient."""
    r = C.shape[-1]
    v = torch.full(C.shape[:-1], 1.0 / math.sqrt(r), dtype=torch.float32,
                   device=C.device)
    for _ in range(n_iter):
        w = (C @ v[..., None])[..., 0]
        v = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=-1,
                                                         keepdim=True), _TINY)
    sigma2 = (v * (C @ v[..., None])[..., 0]).sum(dim=-1)
    return torch.sqrt(torch.clamp_min(sigma2, 0.0)), v


def _top1_gram_eigh(C: torch.Tensor):
    """Exact (sigma, v) via eigh of the Gram (test oracle)."""
    evals, evecs = torch.linalg.eigh(C)
    return torch.sqrt(torch.clamp_min(evals[..., -1], 0.0)), evecs[..., -1]


def _triple(T, sigma, v) -> Rank1Triple:
    u = (T @ v[..., None])[..., 0] / torch.clamp_min(sigma, _TINY)[..., None]
    return Rank1Triple(sigma=sigma, u=u, v=v)


def top1_power(T: torch.Tensor, *, n_iter: int = 24) -> Rank1Triple:
    """Top singular triple of T via power iteration on the r x r Gram."""
    T = T.float()
    sigma, v = _top1_gram_power(T.mT @ T, n_iter=n_iter)
    return _triple(T, sigma, v)


def top1_eigh(T: torch.Tensor) -> Rank1Triple:
    """Exact top singular triple via eigh of the Gram (test oracle)."""
    T = T.float()
    sigma, v = _top1_gram_eigh(T.mT @ T)
    return _triple(T, sigma, v)


# ---------------------------------------------------------------------------
# Rank-1 Grassmann geodesic step (Eq. 5)
# ---------------------------------------------------------------------------


def guard_geodesic(triple: Rank1Triple, eta: float):
    """Health guards: a non-finite triple becomes the exact identity
    (sigma = 0, u = v = 0), and theta = eta * sigma is clamped to
    ``THETA_MAX``.  Returns (guarded triple, theta, diag) with diag the
    (..., 4) vector [raw sigma, applied theta, clamped, degenerate]."""
    sigma_raw = triple.sigma
    finite = (torch.isfinite(sigma_raw)
              & torch.isfinite(triple.u).all(dim=-1)
              & torch.isfinite(triple.v).all(dim=-1))
    sigma_f = torch.where(finite, sigma_raw, 0.0)
    guarded = Rank1Triple(
        sigma=sigma_f,
        u=torch.where(finite[..., None], triple.u, 0.0),
        v=torch.where(finite[..., None], triple.v, 0.0))
    theta_raw = sigma_f * eta
    theta = torch.clamp_max(theta_raw, THETA_MAX)
    diag = torch.stack([sigma_raw.float(), theta.float(),
                        (theta_raw > THETA_MAX).float(), (~finite).float()],
                       dim=-1)
    return guarded, theta, diag


def geodesic_step(S, triple: Rank1Triple, eta: float, theta=None):
    """S_new = S + (S v)(cos(theta) - 1) v^T + u sin(theta) v^T (Eq. 5 for
    the rank-1 tangent), theta = sigma * eta unless given."""
    if theta is None:
        theta = triple.sigma * eta
    Sv = (S @ triple.v[..., None])[..., 0]
    p = (Sv * (torch.cos(theta) - 1.0)[..., None]
         + triple.u * torch.sin(theta)[..., None])
    return S + p[..., :, None] * triple.v[..., None, :]


def geodesic_full(S, triple: Rank1Triple, eta: float):
    """Literal Eq. 5 in matrix form (test oracle for geodesic_step)."""
    v = triple.v[..., :, None]
    u = triple.u[..., :, None]
    theta = triple.sigma * eta
    left = torch.cat([S @ v, u], dim=-1)
    mid = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)[..., None]
    r = S.shape[-1]
    eye = torch.eye(r, dtype=S.dtype, device=S.device)
    return left @ (mid * v.mT) + S @ (eye - v @ v.mT)


def reorthonormalize(S: torch.Tensor) -> torch.Tensor:
    """Sign-fixed QR re-orthonormalization (scrubs accumulated fp drift)."""
    Q, R = torch.linalg.qr(S)
    signs = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    signs = torch.where(signs == 0, 1.0, signs)
    return Q * signs[..., None, :]


def stabilize_triple(S, triple: Rank1Triple,
                     rel_tol: float = 1e-6) -> Rank1Triple:
    """Project u onto the orthogonal complement of S and zero the step
    (sigma = 0) where that leaves a negligible u."""
    u_perp = triple.u - (S @ (S.mT @ triple.u[..., None]))[..., 0]
    nu = torch.linalg.vector_norm(u_perp, dim=-1)
    ok = (nu > rel_tol).float()
    u = ok[..., None] * u_perp / torch.clamp_min(nu, _TINY)[..., None]
    return Rank1Triple(sigma=triple.sigma * ok, u=u, v=triple.v)


def change_of_basis(S_new, S_old) -> torch.Tensor:
    """Dense Q = S_new^T S_old (r x r): the paper-faithful path."""
    return S_new.mT @ S_old


def change_of_basis_rank1(cos_theta, v) -> torch.Tensor:
    """Closed-form Q = I + (cos(theta) - 1) v v^T of the rank-1 geodesic."""
    r = v.shape[-1]
    eye = torch.eye(r, dtype=v.dtype, device=v.device)
    return eye + (cos_theta - 1.0)[..., None, None] * (v[..., :, None]
                                                       * v[..., None, :])


# ---------------------------------------------------------------------------
# One subspace-tracking update (Alg. 1 "if t mod k == 0" block)
# ---------------------------------------------------------------------------


class TrackResult(NamedTuple):
    S_new: torch.Tensor          # (..., m, r) updated orthonormal basis
    A: torch.Tensor              # (..., r, n) projection on the old basis
    cos_theta: torch.Tensor      # (...,) cos(theta) of the rank-1 rotation
    v: torch.Tensor              # (..., r) right singular vector
    gsq: Optional[torch.Tensor] = None   # (..., n) ||G_:,j||^2 (kernel path)
    A_new: Optional[torch.Tensor] = None  # (..., r, n) S_new^T G, gram schedule
    diag: Optional[torch.Tensor] = None   # (..., 4) health diagnostics


def _track_tangent_schedule(S, G, *, eta, fused_tangent, exact_top1,
                            power_iters, backend, exec) -> TrackResult:
    """The tangent schedule (replicated and column programs): the (m, r)
    tangent on every shard, its top-1 triple, the stabilizer, the guards
    and the geodesic.  Under a column program the round "tangent_psum"
    sums the shards' tangents: T = -2 G A^T + 2 S (A A^T) is a sum over
    columns (A A^T = S^T W with W = G A^T), so the shard-local tangents
    add up to the global one.  A and gsq stay per column, on the shard."""
    if backend is not None:
        A, gsq, T = backend.project_tangent_colnorms(S, G)
    else:
        G = G.float()
        A = project(S, G)
        gsq = None
        T = (tangent_fused if fused_tangent else tangent_naive)(S, G, A)
    T = exec.collective("tangent_psum", T)
    triple = (top1_eigh(T) if exact_top1
              else top1_power(T, n_iter=power_iters))
    # DESCENT: follow -grad F (the printed Alg. 1 ascends; see the JAX
    # module).  The sign enters only through u.
    triple = triple._replace(u=-triple.u)
    triple = stabilize_triple(S, triple)
    triple, theta, diag = guard_geodesic(triple, eta)
    S_new = geodesic_step(S, triple, eta, theta=theta)
    return TrackResult(S_new=S_new, A=A, cos_theta=torch.cos(theta),
                       v=triple.v, gsq=gsq, diag=diag)


def _track_gram_schedule(S, G, *, eta, fused_tangent, exact_top1,
                         power_iters, backend, exec) -> TrackResult:
    """The gram schedule of the row-family programs (``repro/core/
    subspace.py`` ``_track_gram_schedule``): S and G arrive as (m/g, r) and
    (m/g, n) row shards, and two collective rounds make everything after
    them replicated algebra plus row-local panel math.  At group size 1
    both rounds are identities.

    Round "proj" sums the stacked [A; ||G_:,j||^2] over the row shards.
    Given the global A, the tangent T = -2 G A^T + 2 S (A A^T) is row-local.

    Round "gram_psum" sums [T^T G | S^T T | T^T T | S^T S] over the row
    shards.  From them alone, (r,)- and (r, n)-sized: (sigma, v) from the
    Gram C = T^T T; with u = -T v / sigma, S^T u = -(S^T T) v / sigma,
    ||u||^2 = v^T C v / sigma^2 and the norm of the stabiliser's
    orthogonal-complement scrub ||u_perp||^2 = ||u||^2 - 2 ||S^T u||^2 +
    (S^T u)^T (S^T S) (S^T u); and the new basis's projection A_new =
    S_new^T G = A + v (p^T G) without another pass over G, with p^T G =
    (cos theta - 1) v^T A + sin theta u_hat^T G and u^T G = -v^T (T^T G) /
    sigma.  With ``backend`` that is three launches: project_colnorms,
    tangent, tangent_gram.  In real arithmetic it equals the tangent
    schedule."""
    del fused_tangent  # the gram schedule always takes the fused form
    rel_tol = 1e-6     # stabilize_triple's
    if backend is not None:
        A, gsq = backend.project_colnorms(S, G)
    else:
        G = G.float()
        A = S.mT @ G
        gsq = (G * G).sum(dim=-2)
    if exec.has("proj"):
        # round "proj": [A; gsq] summed over the row shards
        stacked = exec.collective("proj", torch.cat([A, gsq[..., None, :]],
                                                    dim=-2))
        A, gsq = stacked[..., :-1, :].contiguous(), stacked[..., -1, :]
    n, r = G.shape[-1], S.shape[-1]
    if backend is not None:
        T = backend.tangent(G, A, S)     # this shard's rows of the tangent
        TtG, StT, C, StS = backend.tangent_gram(S, T, G)
    else:
        T = tangent_fused(S, G, A)
        TtG, StT, C, StS = T.mT @ G, S.mT @ T, T.mT @ T, S.mT @ S
    if exec.has("gram_psum"):
        # round "gram_psum": [TtG | StT | C | StS] summed over the shards
        payload = exec.collective("gram_psum",
                                  torch.cat([TtG, StT, C, StS], dim=-1))
        TtG, StT, C, StS = (payload[..., :n], payload[..., n:n + r],
                            payload[..., n + r:n + 2 * r],
                            payload[..., n + 2 * r:])

    def mv(X, x):                        # (..., a, b) @ (..., b) -> (..., a)
        return (X @ x[..., None])[..., 0]

    def dot(x, y):
        return (x * y).sum(dim=-1)

    sigma_raw, v = (_top1_gram_eigh(C) if exact_top1
                    else _top1_gram_power(C, n_iter=power_iters))
    denom = torch.clamp_min(sigma_raw, _TINY)[..., None]
    # DESCENT sign, as in the tangent schedule: u = -T v / sigma
    u = -mv(T, v) / denom                          # (..., m) this shard's rows
    Stu = -mv(StT, v) / denom                      # (..., r) S^T u
    u_sq = dot(v, mv(C, v)) / (denom * denom)[..., 0]
    perp_sq = u_sq - 2.0 * dot(Stu, Stu) + dot(Stu, mv(StS, Stu))
    nu = torch.sqrt(torch.clamp_min(perp_sq, 0.0))[..., None]
    ok = (nu > rel_tol).float()
    uhat = ok * (u - mv(S, Stu)) / torch.clamp_min(nu, _TINY)
    sigma = sigma_raw * ok[..., 0]

    # health guards on the replicated scalars: a non-finite G anywhere
    # reaches sigma and v through the Gram; theta clamps inside pi/2
    finite = torch.isfinite(sigma) & torch.isfinite(v).all(dim=-1)
    fin = finite[..., None]
    sigma_f = torch.where(finite, sigma, 0.0)
    v = torch.where(fin, v, 0.0)
    uhat = torch.where(fin, uhat, 0.0)
    theta_raw = sigma_f * eta
    theta = torch.clamp_max(theta_raw, THETA_MAX)
    diag = torch.stack([sigma_raw.float(), theta.float(),
                        (theta_raw > THETA_MAX).float(), (~finite).float()],
                       dim=-1)

    cos_t, sin_t = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    p = mv(S, v) * (cos_t - 1.0) + uhat * sin_t
    S_new = S + p[..., :, None] * v[..., None, :]

    # A_new = A + v (p^T G), replicated: no further pass over G
    vA = (v[..., None, :] @ A)[..., 0, :]          # (..., n) v^T A
    utG = -(v[..., None, :] @ TtG)[..., 0, :] / denom
    uhatG = ok * (utG - (Stu[..., None, :] @ A)[..., 0, :]) / torch.clamp_min(
        nu, _TINY)
    uhatG = torch.where(fin, uhatG, 0.0)
    ptG = (cos_t - 1.0) * vA + sin_t * uhatG
    A_new = A + v[..., :, None] * ptG[..., None, :]
    return TrackResult(S_new=S_new, A=A, cos_theta=cos_t[..., 0], v=v,
                       gsq=gsq, A_new=A_new, diag=diag)


_SCHEDULES = {"tangent": _track_tangent_schedule,
              "gram": _track_gram_schedule}


def track_subspace(S, G, *, eta: float, fused_tangent: bool = True,
                   exact_top1: bool = False, power_iters: int = 24,
                   backend=None, exec=None,
                   schedule: Optional[str] = None) -> TrackResult:
    """Grassmannian subspace-tracking update.  Returns the new basis and
    the (cos_theta, v) pair that fixes Q = S_new^T S_old = I + (cos - 1)
    v v^T, so the moments rotate in O(rn).  With ``backend``
    (:mod:`repro_torch.kernels.ops`) the front end runs the kernels and G
    is never upcast to an (m, n) fp32 copy.

    ``exec`` is the :class:`~repro_torch.core.program.Exec` of the leaf's
    StepProgram: the program's schedule picks the pipeline ("tangent" for
    the replicated and column programs, "gram" for the row family, which
    also returns the new basis's projection ``A_new``), and its declared
    rounds are the only collectives issued.  Without one the null program
    applies (identity rounds, the tangent schedule).  ``schedule``
    overrides the program's, for a caller with no program (the kernel
    checks run the gram schedule on one device)."""
    exec = exec if exec is not None else program_lib.NULL_EXEC
    schedule = schedule or exec.schedule
    try:
        fn = _SCHEDULES[schedule]
    except KeyError:
        raise ValueError(f"unknown tracking schedule {schedule!r}; options: "
                         f"{sorted(_SCHEDULES)}") from None
    return fn(S, G, eta=eta, fused_tangent=fused_tangent,
              exact_top1=exact_top1, power_iters=power_iters, backend=backend,
              exec=exec)


# ---------------------------------------------------------------------------
# Baseline subspace refresh rules (GaLore / Fira / GoLore)
# ---------------------------------------------------------------------------


def refresh_svd(G: torch.Tensor, rank: int) -> torch.Tensor:
    """GaLore/Fira refresh: top-r left singular vectors of the gradient."""
    return init_subspace_svd(G, rank)


def refresh_random(G: torch.Tensor, rank: int, *, step: int) -> torch.Tensor:
    """GoLore refresh: a fresh random orthonormal basis per matrix, from a
    ``torch.Generator`` seeded by 17 and the step."""
    m = G.shape[-2]
    gen = torch.Generator(device=G.device).manual_seed(17 * 1_000_003
                                                       + int(step))
    gauss = torch.randn(G.shape[:-2] + (m, rank), generator=gen,
                        device=G.device)
    Q, _ = torch.linalg.qr(gauss)
    return Q.contiguous()
