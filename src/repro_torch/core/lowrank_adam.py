"""Low-rank Adam machinery: projected moments, projection-aware rotation,
recovery scaling — SubTrack++ Alg. 1 minus the subspace geometry (which
lives in :mod:`repro_torch.core.subspace`).

Counterpart of ``repro.core.lowrank_adam``.  Every function takes a
gradient ``G (..., m, n)`` with ``m <= n`` and its per-matrix state with
the same leading stack dims: the JAX package ``vmap``s one matrix, the
port runs the stack batched (one kernel launch per leaf).  fp32
throughout.  Every cross-rank interaction of the step is a named round of
the leaf's StepProgram, issued (or skipped) by its
:class:`~repro_torch.core.program.Exec`.

The default rotation is the raw-moment form

    V <- beta2 * |Q^2 (V - M^2) + (Q M)^2| + (1 - beta2) * G~^2

which reduces exactly to Eq. (7) at Q = I; ``ldadam_bias_factor=True``
gives the literal Eq. (9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.core import program as program_lib

_TINY = 1e-30
# Relative noise floor for the closed-form residual energy ||G_:,j||^2 -
# ||Gt_:,j||^2: exact in real arithmetic, a catastrophic cancellation in
# fp32 when the column lies inside the subspace.  Columns below the floor
# drop their recovery contribution (repro/core/lowrank_adam.py:44).
_RESID_REL_FLOOR = 1e-5


@dataclass(frozen=True)
class AdamHP:
    """Scalar hyperparameters shared by every low-rank optimizer variant."""

    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    scale: float = 0.25          # GaLore-style update scale (Table 10)
    zeta: float = 1.01           # recovery-growth limiter (Eq. 12)
    bias_correction: bool = True
    ldadam_bias_factor: bool = False


class MatrixOptState(NamedTuple):
    """Per-matrix optimizer state, stacked over the leaf's stack dims."""

    S: torch.Tensor         # (..., m, r) orthonormal basis
    M: torch.Tensor         # (..., r, n) first moment, raw
    V: torch.Tensor         # (..., r, n) second moment, raw
    lam_prev: torch.Tensor  # (...,) previous recovery norm (Eq. 12)


def init_matrix_state(m: int, n: int, rank: int, stack: tuple = (),
                      device=None) -> MatrixOptState:
    """Zero state; S is a placeholder basis until the warm start installs
    the SVD of the first gradient (Alg. 1 line 1)."""
    eye = torch.eye(m, rank, dtype=torch.float32, device=device)
    return MatrixOptState(
        S=eye.expand(tuple(stack) + (m, rank)).contiguous(),
        M=torch.zeros(tuple(stack) + (rank, n), device=device),
        V=torch.zeros(tuple(stack) + (rank, n), device=device),
        lam_prev=torch.zeros(tuple(stack), device=device))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _ldadam_factor(step: int, hp: AdamHP) -> torch.Tensor:
    return 1.0 - hp.beta2 ** _f32(float(max(step, 1)))


# ---------------------------------------------------------------------------
# Projection-aware moment rotation (Eq. 8-9)
# ---------------------------------------------------------------------------


def rotate_moments_dense(Q, M, V, step: int, hp: AdamHP):
    """M_rot = Q M;  V_rot = |Q∘Q (V - M∘M) + (Q M)∘(Q M)|.  O(r^2 n)."""
    QM = Q @ M
    central = V - M * M
    V_rot = torch.abs((Q * Q) @ central + QM * QM)
    if hp.ldadam_bias_factor:
        V_rot = _ldadam_factor(step, hp) * V_rot
    return QM, V_rot


def rotate_moments_rank1(cos_theta, v, M, V, step: int, hp: AdamHP):
    """O(rn) rotation for Q = I + c v v^T, c = cos(theta) - 1:

        Q M      = M + c v (v^T M)
        (Q∘Q) X  = (1 + 2c v^2) ⊙ X + c^2 v^2 ((v^2)^T X)

    cos_theta (...,); v (..., r); M, V (..., r, n)."""
    c = cos_theta - 1.0
    v2 = v * v
    vM = (v[..., None, :] @ M)[..., 0, :]                    # (..., n)
    QM = M + c[..., None, None] * (v[..., :, None] * vM[..., None, :])
    central = V - M * M
    v2c = (v2[..., None, :] @ central)[..., 0, :]
    QQc = ((1.0 + 2.0 * c[..., None] * v2)[..., :, None] * central
           + (c * c)[..., None, None] * (v2[..., :, None] * v2c[..., None, :]))
    V_rot = torch.abs(QQc + QM * QM)
    if hp.ldadam_bias_factor:
        V_rot = _ldadam_factor(step, hp) * V_rot
    return QM, V_rot


# ---------------------------------------------------------------------------
# The per-matrix optimizer step (Alg. 1 body)
# ---------------------------------------------------------------------------


class MatrixStepOut(NamedTuple):
    """``delta``: the fp32 descent direction when ``lr`` was not given
    (``W <- W - lr * delta``), else the final-dtype update
    (``W <- W + delta``)."""

    delta: torch.Tensor
    state: MatrixOptState


def _limiter(lam_norm, lam_prev, zeta: float):
    """Eq. 12 recovery-growth limiter: (clip_scale, lam_new), per matrix.
    Inactive until ``lam_prev`` is populated."""
    limit = zeta * lam_prev
    do_clip = (lam_prev > 0.0) & (lam_norm > limit)
    scale = torch.where(do_clip, limit / torch.clamp_min(lam_norm, _TINY),
                        1.0)
    lam_new = torch.where(lam_prev > 0.0, torch.minimum(lam_norm, limit),
                          lam_norm)
    return scale, lam_new


def _fused_step(G, st, step, hp, rotated, S, recovery, backend, lr,
                weight_decay, param, out_dtype, exec, gsq=None,
                proj=None) -> MatrixStepOut:
    """Single-pass hot-path schedule:

        project_colnorms     Gt = S^T G (+ ||G_:,j||^2)
        [round "proj"]       the stacked [Gt; gsq] made global, or this
                             shard's state slice of it
        adam_lowrank_norms   M', V', Gto (+ ||Gt_:,j||^2, ||Gto_:,j||^2)
        [round "clip" / "epilogue_gather"]
        fused_update         upd = -lr*scale*(S Gto + (G - S Gt) phi clip)

    The Eq. 12 clip is known before the epilogue from the exact identity
    ||Lam||^2 = sum_j phi_j^2 (||G_:,j||^2 - ||Gt_:,j||^2).  Per regime:
    replicated programs declare no round; column programs the scalar
    "clip" sum; row programs "proj" as an all-reduce, after which Adam,
    phi and the clip run redundantly on replicated inputs and
    ``fused_update`` writes the local rows; row-rs programs "proj" as a
    reduce-scatter (each shard gets its (r, n/g) column slice, Adam runs
    on the sliced M/V) and one "epilogue_gather" of the stacked [Gt; Gto;
    phi; clip partials] back to full width before the epilogue.  The
    grass program's "sel_gather": S is a one-hot row selection, so A is a
    gather of G's rows.

    A tangent-schedule tracking step passes ``gsq`` (harvested by its
    front end; basis-independent), and the projection onto the new basis
    runs through ``project``.  A gram-schedule tracking step passes
    ``proj`` too, the global new-basis projection its rounds already
    assembled (``A_new``), which the state layout only slices: no
    projection pass.  A grad-fused plain step passes both from the
    backward's tap."""
    n = G.shape[-1]
    if proj is not None:
        # already-global new-basis projection, or a row slice of the tap:
        # the kernels take it contiguous
        Gt_full = proj.contiguous()
        Gt = exec.state_slice(Gt_full)
        gsq_st = exec.state_slice(gsq)
    elif gsq is None:
        if exec.has("sel_gather"):
            idx = S.argmax(dim=-2)                         # (..., r)
            Gt = torch.gather(G, -2, idx[..., None].expand(
                idx.shape + (n,))).float()
            gsq_st = torch.linalg.vector_norm(G, dim=-2,
                                              dtype=torch.float32) ** 2
        else:
            Gt, gsq_st = backend.project_colnorms(S, G)
        if exec.has("proj"):
            stacked = exec.collective(
                "proj", torch.cat([Gt, gsq_st[..., None, :]], dim=-2))
            Gt, gsq_st = (stacked[..., :-1, :].contiguous(),
                          stacked[..., -1, :])
        # the reduce-scatter flavour never materializes the global panel
        Gt_full = Gt if Gt.shape[-1] == n else None
        if Gt.shape[-1] != exec.state_width(n):
            # an invariant guard no program reaches: a full-width round
            # paired with sliced state takes this shard's block locally
            Gt = exec.state_slice(Gt)
            gsq_st = exec.state_slice(gsq_st)
    else:
        Gt = backend.project(S, G)
        gsq_st = gsq
        Gt_full = Gt
    M_prev, V_prev = (st.M, st.V) if rotated is None else rotated
    M, V, Gto, gtsq, gtosq = backend.adam_lowrank_norms(
        Gt, M_prev, V_prev, step, beta1=hp.beta1, beta2=hp.beta2,
        eps=hp.eps, bias_correction=hp.bias_correction)

    lr32 = _f32(lr)
    coef = float(lr32 * hp.scale)
    wd_param = param if (weight_decay and param is not None) else None
    wd_coef = float(lr32 * weight_decay) if wd_param is not None else None
    if recovery:
        # phi_j = ||Gto_:,j|| / ||Gt_:,j|| (Eq. 11), zeroed below the fp32
        # cancellation floor of the column's residual energy
        resid_sq = torch.clamp_min(gsq_st - gtsq, 0.0)
        keep = (resid_sq > _RESID_REL_FLOOR * gsq_st).float()
        phi = keep * torch.sqrt(gtosq) / torch.clamp_min(torch.sqrt(gtsq),
                                                         _TINY)
        lam_part = phi * phi * resid_sq                    # (..., n_state)
        if exec.has("epilogue_gather"):
            # full width for the write-back: [Gt, where the scatter left
            # it sliced; Gto; phi; clip partials] gathered in one round
            pieces = ([] if Gt_full is not None else [Gt]) + [
                Gto, phi[..., None, :], lam_part[..., None, :]]
            full = exec.collective("epilogue_gather",
                                   torch.cat(pieces, dim=-2))
            r = Gto.shape[-2]
            if Gt_full is None:
                Gt_full, full = full[..., :r, :].contiguous(), \
                    full[..., r:, :]
            Gto = full[..., :r, :].contiguous()
            phi = full[..., r, :].contiguous()
            lam_sq = full[..., r + 1, :].sum(dim=-1)
        else:
            lam_sq = exec.collective("clip", lam_part.sum(dim=-1))
        clip, lam_new = _limiter(torch.sqrt(lam_sq), st.lam_prev, hp.zeta)
        upd = backend.fused_update(G, S, Gt_full, Gto, phi, coef, clip,
                                   out_dtype=out_dtype, param=wd_param,
                                   wd_coef=wd_coef)
    else:
        lam_new = st.lam_prev
        Gto = exec.collective("epilogue_gather", Gto)
        upd = backend.fused_update(None, S, None, Gto, None, coef, 1.0,
                                   out_dtype=out_dtype, param=wd_param,
                                   wd_coef=wd_coef)
    return MatrixStepOut(delta=upd, state=MatrixOptState(S=S, M=M, V=V,
                                                         lam_prev=lam_new))


def lowrank_adam_step(G, st: MatrixOptState, step: int, hp: AdamHP, *,
                      rotated=None, S_new=None, recovery: bool = True,
                      precomputed_proj=None, backend=None,
                      lr: Optional[float] = None, weight_decay: float = 0.0,
                      param=None, out_dtype=None,
                      precomputed_gsq=None, exec=None) -> MatrixStepOut:
    """One Alg. 1 iteration for a (stack of) matrices.

    When the subspace just moved, callers pass ``S_new`` plus the rotated
    (M_rot, V_rot); otherwise the plain Adam rules (Eq. 6-7) apply.  With
    ``lr=None`` returns the fp32 direction ``delta`` (``W <- W - lr *
    delta``); with ``lr`` the final-dtype update, lr, scale, clip and
    decoupled weight decay folded in.  With ``backend``
    (:mod:`repro_torch.kernels.ops`) and ``lr`` this is the fused schedule
    (:func:`_fused_step`); otherwise the paper-literal unfused schedule,
    whose (m, n) products run through the backend's ``project``,
    ``backproject`` and ``recovery`` when one is given (the JAX package's
    legacy contract) and in plain PyTorch when not.  ``step`` is the
    Python int count of updates applied so far.

    ``precomputed_proj`` (S^T G) and ``precomputed_gsq`` (||G_:,j||^2)
    together are the grad-fused plain step's tap, or a gram-schedule
    tracking step's new-basis projection and harvested norms;
    ``precomputed_gsq`` alone is the tangent schedule's harvested norms.
    ``exec`` is the :class:`~repro_torch.core.program.Exec` of the leaf's
    StepProgram, whose declared rounds are the only collectives issued
    (the null program's by default: identities)."""
    S = st.S if S_new is None else S_new
    out_dtype = out_dtype or torch.float32
    exec = exec if exec is not None else program_lib.NULL_EXEC
    if backend is not None and lr is not None:
        proj = (precomputed_proj
                if (exec.schedule == "gram" or precomputed_gsq is not None)
                else None)
        return _fused_step(G, st, step, hp, rotated, S, recovery, backend,
                           lr, weight_decay, param, out_dtype, exec,
                           gsq=precomputed_gsq, proj=proj)

    # the kernels widen G per tile (exactly, as the JAX package's fp32 copy
    # does), so G keeps its dtype on the backend's path
    G = G if backend is not None else G.float()
    if precomputed_proj is not None:
        Gt = precomputed_proj
    else:
        Gt = backend.project(S, G) if backend is not None else S.mT @ G
        if exec.rows_sharded:                  # A contracts over the rows
            Gt = exec.psum(Gt)
    M_prev, V_prev = (st.M, st.V) if rotated is None else rotated
    M = hp.beta1 * M_prev + (1.0 - hp.beta1) * Gt
    V = hp.beta2 * V_prev + (1.0 - hp.beta2) * (Gt * Gt)
    if hp.bias_correction:
        t = _f32(float(step)) + 1.0
        m_hat = M / (1.0 - hp.beta1 ** t)
        v_hat = V / (1.0 - hp.beta2 ** t)
    else:
        m_hat, v_hat = M, V
    Gto = m_hat / (torch.sqrt(v_hat) + hp.eps)
    Ghat = backend.backproject(S, Gto) if backend is not None else S @ Gto

    lam_new = st.lam_prev
    if recovery:
        num = torch.linalg.vector_norm(Gto, dim=-2)
        den = torch.linalg.vector_norm(Gt, dim=-2)
        phi = num / torch.clamp_min(den, _TINY)
        if backend is not None:
            Lam = backend.recovery(S, G, Gt.contiguous(), phi)
        else:
            Lam = (G - S @ Gt) * phi[..., None, :]
        # the ||Lam||^2 partial is shard-local under either sharded
        # layout (columns or rows of Lam): one raw sum either way
        lam_norm = torch.sqrt(exec.psum((Lam * Lam).sum(dim=(-2, -1))))
        scale, lam_new = _limiter(lam_norm, st.lam_prev, hp.zeta)
        Lam = Lam * scale[..., None, None]
        delta = hp.scale * (Ghat + Lam)
    else:
        delta = hp.scale * Ghat

    new_state = MatrixOptState(S=S, M=M, V=V, lam_prev=lam_new)
    if lr is None:
        return MatrixStepOut(delta=delta, state=new_state)
    lr32 = _f32(lr)
    upd = -lr32 * delta
    if weight_decay and param is not None:
        upd = upd - (lr32 * weight_decay) * param.float()
    return MatrixStepOut(delta=upd.to(out_dtype), state=new_state)


# ---------------------------------------------------------------------------
# Dense Adam (1-D params and matrices at or below the rank)
# ---------------------------------------------------------------------------


class DenseOptState(NamedTuple):
    M: torch.Tensor
    V: torch.Tensor


def init_dense_state(shape, device=None) -> DenseOptState:
    return DenseOptState(M=torch.zeros(shape, device=device),
                         V=torch.zeros(shape, device=device))


def dense_adam_step(G, st: DenseOptState, step: int, hp: AdamHP):
    """Standard Adam direction -> (delta fp32, new state)."""
    G = G.float()
    M = hp.beta1 * st.M + (1.0 - hp.beta1) * G
    V = hp.beta2 * st.V + (1.0 - hp.beta2) * (G * G)
    if hp.bias_correction:
        t = _f32(float(step)) + 1.0
        m_hat = M / (1.0 - hp.beta1 ** t)
        v_hat = V / (1.0 - hp.beta2 ** t)
    else:
        m_hat, v_hat = M, V
    return m_hat / (torch.sqrt(v_hat) + hp.eps), DenseOptState(M=M, V=V)
