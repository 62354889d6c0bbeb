"""Dispatch over the port's hand-written kernels.

The rule is the tensor's device, nothing else: a CPU tensor runs the
kernel's plain-PyTorch oracle (:mod:`repro_torch.kernels.ref`); any other
tensor goes to the kernel wrapper, which launches the CUDA kernel or
raises.  A CUDA tensor never takes the oracle, and there is no shape gate.

The optimizer's fused hot path (``repro_torch.core.lowrank_adam``) runs
three launches per low-rank leaf on a plain step:

    project_colnorms(S, G)       -> (A (r, n), ||G_:,j||^2)  one read of G
    adam_lowrank_norms(...)      -> (M', V', Gto, ||Gt||^2, ||Gto||^2)
    fused_update(...)            -> the update in the parameter dtype

and four on a tracking step: ``project_tangent_colnorms`` (one launch
for m <= ``grassmann.MAX_FRONT_M`` = 2048, else the two launches
``project_colnorms`` + ``tangent``: five in all), then ``project`` with
the new basis, ``adam_lowrank_norms`` and ``fused_update``.  Every
argument may carry leading stack dims: one launch covers a layer stack.

The unfused schedule (``lowrank_adam_step`` with ``lr=None``, the fp32
descent direction) runs ``project``, then ``backproject`` and
``recovery``: three launches per leaf.

The grad-fused backward (``repro_torch.models.common.tapped_matmul``)
calls :func:`grad_tap` once per tapped matmul; on such a plain step the
optimizer skips ``project_colnorms`` for the tapped leaves.

The gram tracking schedule of the row-family StepPrograms
(``repro_torch.core.program``) runs ``project_colnorms``, ``tangent`` and
``tangent_gram``, and its new-basis projection replaces the epilogue's
``project``: five launches per leaf on such a tracking step.
``adam_lowrank`` and ``flash_attention`` are on no path of the JAX
package; their entry points are the functions here.

Each kernel wrapper counts its launches in a plain integer
(``<wrapper>.launches``); :func:`launch_counts` reads them and
:func:`reset_launch_counts` zeroes them, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import grassmann
from repro_torch.kernels import paged_attention as paged
from repro_torch.kernels import ref

_WRAPPERS = {
    "paged_attention": paged.paged_attention,
    "project": grassmann.project,
    "project_colnorms": grassmann.project_colnorms,
    "tangent": grassmann.tangent,
    "tangent_gram": grassmann.tangent_gram,
    "project_tangent_colnorms": grassmann.project_tangent_colnorms,
    "backproject": grassmann.backproject,
    "recovery": grassmann.recovery,
    "adam_lowrank_norms": grassmann.adam_lowrank_norms,
    "adam_lowrank": grassmann.adam_lowrank,
    "fused_update": grassmann.fused_update,
    "grad_tap": grassmann.grad_tap,
    "flash_attention": flash.flash_attention,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Block-table decode attention -> (B, Hq, hd).  Kernel:
    ``csrc/paged_attention.cu``; oracle: ``ref.paged_attention_ref``."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                       lengths)
    return paged.paged_attention(q, k_pool, v_pool, block_tables, lengths)


def project(S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """A = S^T G (Eq. 2-3) -> (..., r, n) fp32.  Kernel:
    ``csrc/grassmann_project.cu``; oracle: ``ref.project_ref``."""
    if G.device.type == "cpu":
        return ref.project_ref(S, G)
    return grassmann.project(S, G)


def project_colnorms(S: torch.Tensor, G: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(A = S^T G, ||G_:,j||^2).  Kernel: ``csrc/grassmann_project.cu``
    (norm switch on); oracle: ``ref.project_colnorms_ref``."""
    if G.device.type == "cpu":
        return ref.project_colnorms_ref(S, G)
    return grassmann.project_colnorms(S, G)


def tangent(G: torch.Tensor, A: torch.Tensor,
            S: torch.Tensor) -> torch.Tensor:
    """Grassmann tangent T = -2 G A^T + 2 S (A A^T) (Eq. 4) -> (..., m, r).
    Kernel: ``csrc/grassmann_tangent.cu``; oracle: ``ref.tangent_ref``."""
    if G.device.type == "cpu":
        return ref.tangent_ref(G, A, S)
    return grassmann.tangent(G, A, S)


def tangent_gram(S: torch.Tensor, T: torch.Tensor, G: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """The gram schedule's sums over rows (T^T G, S^T T, T^T T, S^T S).
    Kernel: ``csrc/grassmann_tangent_gram.cu``; oracle:
    ``ref.tangent_gram_ref``."""
    if G.device.type == "cpu":
        return ref.tangent_gram_ref(S, T, G)
    return grassmann.tangent_gram(S, T, G)


def project_tangent_colnorms(S: torch.Tensor, G: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Tracking-step front end (A, ||G_:,j||^2, T).  Kernel:
    ``csrc/grassmann_tangent_front.cu``, one launch for m <=
    ``grassmann.MAX_FRONT_M`` (= 2048: a cluster of 16 CTAs holds the m
    extent, 128 rows each); taller matrices (llama-7b's m = 4096) take the
    ``project_colnorms`` + ``tangent`` composite, as the JAX package's do
    past its own (VMEM) limit.  Oracle: ``ref.project_tangent_colnorms_ref``."""
    if G.device.type == "cpu":
        return ref.project_tangent_colnorms_ref(S, G)
    if G.shape[-2] <= grassmann.MAX_FRONT_M:
        return grassmann.project_tangent_colnorms(S, G)
    A, gsq = grassmann.project_colnorms(S, G)
    return A, gsq, grassmann.tangent(G, A, S)


def backproject(S: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Ghat = S X (Eq. 10) -> (..., m, n) fp32.  Kernel:
    ``csrc/grassmann_backproject.cu``; oracle: ``ref.backproject_ref``."""
    if X.device.type == "cpu":
        return ref.backproject_ref(S, X)
    return grassmann.backproject(S, X)


def recovery(S: torch.Tensor, G: torch.Tensor, Gt: torch.Tensor,
             phi: torch.Tensor) -> torch.Tensor:
    """Lam = (G - S Gt) * phi (Eq. 10-11) -> (..., m, n) fp32.  Kernel:
    ``csrc/grassmann_backproject.cu`` (recovery switch on); oracle:
    ``ref.recovery_ref``."""
    if G.device.type == "cpu":
        return ref.recovery_ref(G, S, Gt, phi)
    return grassmann.recovery(S, G, Gt, phi)


def adam_lowrank_norms(Gt: torch.Tensor, M: torch.Tensor, V: torch.Tensor,
                       step: int, *, beta1: float = 0.9, beta2: float = 0.999,
                       eps: float = 1e-8, bias_correction: bool = True):
    """(M', V', Gto, ||Gt_:,j||^2, ||Gto_:,j||^2).  Kernel:
    ``csrc/adam_lowrank_norms.cu``; oracle: ``ref.adam_lowrank_norms_ref``."""
    if Gt.device.type == "cpu":
        return ref.adam_lowrank_norms_ref(Gt, M, V, step, beta1, beta2, eps,
                                          bias_correction)
    return grassmann.adam_lowrank_norms(Gt, M, V, step, beta1=beta1,
                                        beta2=beta2, eps=eps,
                                        bias_correction=bias_correction)


def adam_lowrank(Gt: torch.Tensor, M: torch.Tensor, V: torch.Tensor,
                 step: int, *, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, bias_correction: bool = True):
    """(M', V', Gto) (Eq. 6-7).  Kernel: ``csrc/adam_lowrank_norms.cu``,
    its norms compiled out; oracle: ``ref.adam_lowrank_ref``."""
    if Gt.device.type == "cpu":
        return ref.adam_lowrank_ref(Gt, M, V, step, beta1, beta2, eps,
                                    bias_correction)
    return grassmann.adam_lowrank(Gt, M, V, step, beta1=beta1, beta2=beta2,
                                  eps=eps, bias_correction=bias_correction)


def fused_update(G, S, Gt, Gto, phi, coef, clip, *, out_dtype=None,
                 param=None, wd_coef=None) -> torch.Tensor:
    """The hot-path epilogue, written in ``out_dtype``.  Kernel:
    ``csrc/fused_update.cu``; oracle: ``ref.fused_update_ref``."""
    if S.device.type == "cpu":
        return ref.fused_update_ref(G, S, Gt, Gto, phi, coef, clip,
                                    out_dtype=out_dtype, param=param,
                                    wd_coef=wd_coef)
    return grassmann.fused_update(G, S, Gt, Gto, phi, coef, clip,
                                  out_dtype=out_dtype, param=param,
                                  wd_coef=wd_coef)


def grad_tap(x: torch.Tensor, dy: torch.Tensor, S: torch.Tensor, *,
             out_dtype: torch.dtype = torch.float32,
             transposed_out: bool = False):
    """Grad-fused backward epilogue: (dW = x^T dy in ``out_dtype``, the
    (r+1, n) fp32 tap [A = S^T dW; ||dW_:,j||^2] from the fp32 dW).
    Kernel: ``csrc/grad_tap.cu``; oracle: ``ref.grad_tap_ref``.  The JAX
    dispatch falls back to a dW matmul + ``project_colnorms`` past the
    TPU's ``MAX_GRAD_TAP_B`` or off its tile grid; the CUDA kernel streams
    any b and masks ragged tiles, so there is no such case here.
    ``transposed_out`` asks the kernel for dW stored as (n, m); on the CPU
    the layout is the oracle's."""
    if x.device.type == "cpu":
        dW, A, gsq = ref.grad_tap_ref(x, dy, S)
        return dW.to(out_dtype), torch.cat([A, gsq[None, :]], dim=0)
    return grassmann.grad_tap(x, dy, S, out_dtype=out_dtype,
                              transposed_out=transposed_out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Flash attention in the JAX kernel's layout and semantics: q (B, S,
    Hq, hd), k and v (B, T, Hkv, hd) -> (B, S, Hq, hd) in q's dtype.
    Kernel: ``csrc/flash_attention.cu``; oracle:
    ``ref.flash_attention_ref``."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    return flash.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
