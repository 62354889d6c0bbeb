"""Step-health reporting for the training runtime.

Counterpart of ``repro.core.health``.  Every train step assembles a small
fp32 :class:`HealthReport` from reductions it already has: the loss, the
global gradient norm of the clip, the norm of the updates, and the
subspace tracker's (sigma, theta) diagnostics.  ``launch/steps.py`` gates
the apply on :func:`step_ok`: an unhealthy step is quarantined (params,
M, V, S, ``lam_prev`` and the step counts stay bit-identical).  The host
ladder in ``launch/train.py`` escalates from there (skip -> forced
refresh -> rollback -> abort).

The subspace diagnostics travel as one ``(DIAG_SIZE,)`` fp32 vector per
leaf, merged by element-wise max over leaves and over a leaf's stack.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

# Indices into the per-leaf subspace diagnostic vector.
DIAG_SIGMA = 0        # raw top singular value of the tangent (pre-clamp)
DIAG_THETA = 1        # rotation angle actually applied (post clamp/guard)
DIAG_CLAMPED = 2      # 1.0 when eta*sigma wrapped past the clamp
DIAG_DEGENERATE = 3   # 1.0 when a non-finite geodesic was zeroed
DIAG_SIZE = 4

# The geodesic rotation angle is injective only on (-pi/2, pi/2): past
# it, eta*sigma wraps around the circle and the step direction inverts.
# Clamp slightly inside the boundary so cos(theta) stays away from 0.
THETA_MAX = (math.pi / 2.0) * (1.0 - 1e-3)


def zero_diag(device=None) -> torch.Tensor:
    """The all-healthy diagnostic vector (plain steps, dense leaves)."""
    return torch.zeros((DIAG_SIZE,), dtype=torch.float32, device=device)


def merge_diag(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise max: the worst sigma / theta and sticky flags.  A NaN
    in either propagates, as ``jnp.maximum`` does."""
    return torch.maximum(a, b)


def reduce_diag(diag: torch.Tensor) -> torch.Tensor:
    """Collapse a stacked (..., DIAG_SIZE) diagnostic block to one vector
    (NaN propagates, as ``jnp.max`` does)."""
    return diag.reshape(-1, DIAG_SIZE).amax(dim=0)


class HealthReport(NamedTuple):
    """Per-step health scalars, fp32 () tensors; ``ok`` a () bool tensor.

    ``ok`` is the quarantine gate: finite loss AND finite global grad
    norm AND finite update norm.  A non-finite grad norm with a finite
    loss fails the gate: the clip scale itself is poisoned."""

    loss: torch.Tensor
    grad_norm: torch.Tensor
    update_norm: torch.Tensor
    sigma: torch.Tensor          # worst tracked sigma (0 on plain steps)
    theta: torch.Tensor          # worst applied rotation angle
    theta_clamped: torch.Tensor  # 1.0 if any leaf hit the theta clamp
    geo_degenerate: torch.Tensor  # 1.0 if any leaf zeroed its geodesic
    ok: torch.Tensor             # () bool: the apply gate


def make_report(loss: torch.Tensor, grad_norm: torch.Tensor,
                update_norm: torch.Tensor,
                diag: Optional[torch.Tensor] = None) -> HealthReport:
    """Assemble the step report from already-computed () reductions, all
    on one device."""
    loss, grad_norm, update_norm = (x.float() for x in (loss, grad_norm,
                                                        update_norm))
    if diag is None:
        diag = zero_diag(loss.device)
    ok = (torch.isfinite(loss) & torch.isfinite(grad_norm)
          & torch.isfinite(update_norm))
    return HealthReport(
        loss=loss, grad_norm=grad_norm, update_norm=update_norm,
        sigma=diag[DIAG_SIGMA], theta=diag[DIAG_THETA],
        theta_clamped=diag[DIAG_CLAMPED],
        geo_degenerate=diag[DIAG_DEGENERATE], ok=ok)


def step_ok(report: HealthReport) -> torch.Tensor:
    """The quarantine gate (``report.ok``)."""
    return report.ok


def agree_over(report: HealthReport, group) -> HealthReport:
    """One verdict over a mesh: the gate and the two guard flags
    MAX-all-reduced over ``group`` (a quarantine anywhere quarantines
    every rank), so no replica applies a step another dropped.  The
    values (loss, norms, sigma, theta) are the same on every rank by
    construction: the forward runs whole on each, the update norm is
    taken over the gathered updates, and the tracker's diagnostics
    derive from summed quantities.  ``group`` None (one rank) returns
    ``report``."""
    if group is None:
        return report
    flags = torch.stack([(~report.ok).float(), report.theta_clamped.float(),
                         report.geo_degenerate.float()])
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.MAX
    group.allreduce([flags], opts).wait()
    return report._replace(theta_clamped=flags[1], geo_degenerate=flags[2],
                           ok=flags[0] == 0)


def report_to_host(report: HealthReport) -> HealthReport:
    """The report as CPU () tensors, read in ONE device-to-host copy (the
    gate's single host read per step)."""
    vals = torch.stack([x.float() for x in report]).cpu()
    return HealthReport(*vals[:-1].unbind(), ok=vals[-1] > 0)


def report_metrics(report: HealthReport) -> dict:
    """The report as the step's metric entries."""
    return {
        "update_norm": report.update_norm,
        "sigma": report.sigma,
        "theta": report.theta,
        "theta_clamped": report.theta_clamped,
        "geo_degenerate": report.geo_degenerate,
        "quarantined": (~report.ok).float(),
    }


# ---------------------------------------------------------------------------
# Fault-injection codes (--inject, launch/train.py)
# ---------------------------------------------------------------------------
#
# nan-grad scales the loss fed to the backward by NaN (the true loss still
# reaches the metrics); loss-spike multiplies every update by
# -LOSS_SPIKE_AMP before the gate.  sigma-blowup is an eta multiplier on
# one tracking step (launch/train.py BLOWUP_ETA_SCALE).

INJECT_NONE = 0
INJECT_NAN_GRAD = 1
INJECT_LOSS_SPIKE = 2

# Negated update amplification for INJECT_LOSS_SPIKE: a huge ascent step,
# so the next steps' losses spike past the sentinel's EMA gate while
# staying finite (the finite-but-wrecked model that only the host ladder
# can catch).
LOSS_SPIKE_AMP = 4096.0
