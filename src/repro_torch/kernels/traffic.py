"""Analytic HBM-traffic model for the optimizer's per-step cost: both the
k-1-of-k non-tracking steps (which dominate SubTrack++'s wall time) and
the 1-of-k Grassmannian tracking step (the subspace update — the wall-time
spike in one-shot-refresh baselines like GaLore).

The port's copy of ``repro.kernels.traffic``, whole and with its charges
unchanged: the regime gates (:func:`in_column_regime`,
:func:`in_row_regime`) and the byte comparisons behind the row-state
flavour and the hot-path layout (``repro_torch.core.program.
pick_row_flavor``, ``repro_torch.distributed.sharding.
hotpath_param_specs``) must pick the reference's regime leaf for leaf.
The charges were derived for the TPU kernels' schedules (VMEM-resident
panels below); re-deriving them for the Hopper kernels is queued.

Accounting rules (what counts as a read / a write)
--------------------------------------------------
Counts *ideal* bytes moved per matrix per step:

* every operand is charged one read per pass it participates in, and
  every result one write — at its storage dtype (fp32 optimizer state;
  gradient and parameter dtypes configurable, so bf16 training halves the
  G-read and update-write terms);
* VMEM-resident panel re-fetches inside a pass are NOT charged (standard
  roofline accounting, matching repro.distributed.hlo_analysis): a tiled
  kernel that keeps S and an (r, bn) panel on-chip while sweeping G pays
  for S once, G once and its outputs once;
* O(r^2) and scalar traffic (Gram matrices, the clip scalar, limiter
  state) is ignored — at r <= 1024 it is noise next to the r*n terms;
* fusion is what changes the model: a fused pass charges its inputs and
  outputs once, while the same math as separate XLA ops charges every
  materialized (m, n) intermediate a write + a re-read.

Non-tracking step (functions ``unfused_step_bytes`` / ``fused_step_bytes``)
---------------------------------------------------------------------------
``unfused`` — the seed schedule (separate project, moments, phi,
backproject, recovery, ||Lam||, combine + lr-scale + cast passes).  The
(m, n) stream is touched ~8x: G is read twice, Ghat and Lam are each
written then re-read (Lam twice: once for its norm, once for the
combine), and the final scale/cast pass writes the update.

``fused`` — the single-pass pipeline (project_colnorms ->
adam_lowrank_norms -> fused_update): G is read twice (projection pass +
epilogue pass), the update is written once in the parameter dtype, and
everything else stays in (r, n) or O(n).  The Eq. 12 clip scalar comes
from the closed-form ||Lam||^2 = sum_j phi_j^2 (||G_:,j||^2 -
||Gt_:,j||^2), so no (m, n) intermediate exists at all.

Why the non-tracking ratio lands at 0.34-0.49x: the mn-stream terms drop
from ~8 passes to 3 (ratio ~0.37 at fp32; the exact value moves with
grad/param dtype — bf16 G-reads shrink both sides' read terms but the
unfused schedule keeps its five fp32 (m, n) intermediate passes — and
with the r*n state traffic, which is identical-ish in both schedules and
dilutes the win as r/m grows).

Tracking step (functions ``tracking_unfused_step_bytes`` /
``tracking_fused_step_bytes``)
------------------------------
``unfused`` — the paper-literal schedule: project (old basis) for A, the
fused-form tangent (one more read of G; the *naive* tangent would add two
more mn passes, so this is generous to the baseline), then after the
geodesic step a fresh projection onto S_new inside the optimizer step,
the dense O(r^2 n) moment rotation, and the same backproject / recovery /
||Lam|| / combine / cast epilogue as the unfused plain step: 4 reads of G
plus 5 fp32 (m, n) intermediate passes plus the update write.

``fused`` — project_tangent_colnorms harvests A, the column norms AND the
tangent from one read of G (single launch for m <= MAX_FUSED_TANGENT_M,
see repro.kernels.grassmann); the geodesic step and the O(rn) rank-1
moment rotation never touch (m, n) data; the epilogue re-projects onto
S_new (one read — the norms are basis-independent and reused, so it is a
plain project) and fused_update makes the last read + the only write:
3 reads of G + 1 final-dtype write, no (m, n) intermediates.  The second
projection is irreducible: Gt_new = S_new^T G = A + v (p^T G) needs
p^T G, itself a full pass over G — same traffic, more moving parts.
"""

from __future__ import annotations

from dataclasses import dataclass

F32 = 4


@dataclass(frozen=True)
class HotPathTraffic:
    """Byte totals for one optimizer hot-path step over one matrix."""

    schedule: str
    mn_bytes: int        # traffic touching (m, n)-sized streams
    rn_bytes: int        # traffic touching (r, n) state
    mr_bytes: int        # S panel reads
    n_bytes: int         # per-column vectors (phi, norms)

    @property
    def total(self) -> int:
        return self.mn_bytes + self.rn_bytes + self.mr_bytes + self.n_bytes


def unfused_step_bytes(m: int, n: int, r: int, *, grad_bytes: int = F32,
                       param_bytes: int = F32) -> HotPathTraffic:
    """Seed schedule: project -> moments -> phi -> backproject ->
    recovery -> ||Lam|| -> (Ghat + Lam * clip) * -lr, cast.

    The trailing combine/scale/cast is charged as one fused XLA pass
    (2 mn reads + 1 write) — generous to the baseline."""
    mn = (
        2 * m * n * grad_bytes    # G read by project and by recovery
        + m * n * F32             # Ghat write (backproject)
        + m * n * F32             # Lam write (recovery)
        + m * n * F32             # Lam read  (||Lam|| reduction)
        + 2 * m * n * F32         # Ghat + Lam read (combine pass)
        + m * n * param_bytes     # update write (lr-scale + cast)
    )
    rn = (
        r * n * F32               # Gt write (project)
        + 6 * r * n * F32         # moments: Gt, M, V read; M, V, Gto write
        + 2 * r * n * F32         # phi: Gt, Gto column norms
        + r * n * F32             # Gto read (backproject)
        + r * n * F32             # Gt read (recovery)
    )
    mr = 3 * m * r * F32          # S read by project, backproject, recovery
    nb = 2 * n * F32              # phi write + read
    return HotPathTraffic("unfused", mn, rn, mr, nb)


def fused_step_bytes(m: int, n: int, r: int, *, grad_bytes: int = F32,
                     param_bytes: int = F32) -> HotPathTraffic:
    """Fused pipeline: project_colnorms -> adam_lowrank_norms ->
    fused_update.  ~2 x mn reads + 1 x mn final-dtype write."""
    mn = (
        2 * m * n * grad_bytes    # G read by project_colnorms and epilogue
        + m * n * param_bytes     # update write (final dtype, once)
    )
    rn = (
        r * n * F32               # Gt write (project_colnorms)
        + 6 * r * n * F32         # adam_lowrank_norms: 3 reads + 3 writes
        + 2 * r * n * F32         # Gt, Gto read (fused_update panels)
    )
    mr = 2 * m * r * F32          # S read by project_colnorms + epilogue
    nb = 6 * n * F32              # gsq/gtsq/gtosq writes + phi write/read
    return HotPathTraffic("fused", mn, rn, mr, nb)


def _tap_panel_bytes(m: int, n: int, r: int) -> int:
    """One pass (write or read) over the stacked [A; ||G_:,j||^2] tap
    panel, charged off the StepProgram's declared ``grad_tap`` round —
    the byte model reads the payload shape from the same IR the runtime
    lowers, so it can never drift from what the tapped backward emits."""
    from repro_torch.core.program import regime_rounds  # lazy: program builds
    #                                               on this module's models

    for rnd in regime_rounds("replicated", m, n, r, 1, tracking=False,
                             tapped=True):
        if rnd.name == "grad_tap":
            return rnd.rows * rnd.cols * rnd.dtype_bytes
    raise ValueError("replicated tapped program declares no grad_tap round")


def gradfused_step_bytes(m: int, n: int, r: int, *, grad_bytes: int = F32,
                         param_bytes: int = F32,
                         recovery: bool = True) -> HotPathTraffic:
    """Grad-fused plain step: the backward's tap epilogue emits the
    stacked (r+1, n) [A = S^T G; per-column ||G||^2] panel while forming
    dW, so the optimizer never runs a projection pass over the full-width
    gradient.  Charged here is everything EXTRA beyond the vanilla
    backward (which computes and writes dW either way): the tap panel
    write + the S read inside the backward epilogue, then the optimizer's
    consumption — adam_lowrank_norms straight off the tapped A (its Gt
    read IS the tap read), and the fused_update epilogue.

    ``recovery=True`` (Fira recovery scaling on): the epilogue still
    needs one read of G for the residual Lam = phi * (G - S Gt) — 1 read
    + 1 write on the (m, n) stream vs the current fused path's 2 + 1.

    ``recovery=False``: the update is -lr * S Gt^O — NO pass over the
    full-width gradient at all; the only (m, n) traffic left is the
    update write, and fused_update drops its Gt panel read too."""
    tap = _tap_panel_bytes(m, n, r)
    mn = (
        (m * n * grad_bytes if recovery else 0)  # G read by the epilogue
        #                                          (residual pass only)
        + m * n * param_bytes     # update write (final dtype, once)
    )
    rn = (
        tap                       # tap panel write (backward epilogue)
        + 6 * r * n * F32         # adam_lowrank_norms: 3 reads + 3 writes
        #                           (the Gt read comes off the tap panel)
        + (2 if recovery else 1) * r * n * F32  # fused_update reads Gto,
        #                           plus Gt only for the residual
    )
    mr = (
        m * r * F32               # S read by the backward tap epilogue
        + m * r * F32             # S read by fused_update
    )
    nb = (6 if recovery else 2) * n * F32  # gsq (tapped) read + gtsq/gtosq
    #                                        + phi write/read; recovery off
    #                                        keeps only the tapped gsq row
    return HotPathTraffic("gradfused", mn, rn, mr, nb)


def gradfused_traffic_ratio(m: int, n: int, r: int, *,
                            grad_bytes: int = F32, param_bytes: int = F32,
                            recovery: bool = True) -> float:
    """grad-fused / unfused total-byte ratio, same paper-literal
    denominator as :func:`traffic_ratio` so the two are comparable.
    Strictly below the fused ratio everywhere (it saves one full G read);
    target <= 0.30 with recovery scaling off (zero mn reads remain)."""
    gf = gradfused_step_bytes(m, n, r, grad_bytes=grad_bytes,
                              param_bytes=param_bytes, recovery=recovery)
    unfused = unfused_step_bytes(m, n, r, grad_bytes=grad_bytes,
                                 param_bytes=param_bytes)
    return gf.total / unfused.total


def traffic_ratio(m: int, n: int, r: int, *, grad_bytes: int = F32,
                  param_bytes: int = F32) -> float:
    """fused / unfused total-byte ratio (< 1 is a win; target <= 0.5)."""
    fused = fused_step_bytes(m, n, r, grad_bytes=grad_bytes,
                             param_bytes=param_bytes)
    unfused = unfused_step_bytes(m, n, r, grad_bytes=grad_bytes,
                                 param_bytes=param_bytes)
    return fused.total / unfused.total


# ---------------------------------------------------------------------------
# Tracking step (1-of-k): the Grassmannian subspace update + optimizer step
# ---------------------------------------------------------------------------


def tracking_unfused_step_bytes(m: int, n: int, r: int, *,
                                grad_bytes: int = F32,
                                param_bytes: int = F32) -> HotPathTraffic:
    """Paper-literal tracking schedule: project (old basis) -> fused-form
    tangent -> top1/geodesic -> dense rotation -> project (new basis) ->
    moments -> phi -> backproject -> recovery -> ||Lam|| -> combine/cast.

    Charges the *fused-form* tangent (one read of G); the naive
    residual-materializing tangent would add 2 more mn fp32 passes —
    generous to the baseline, like the plain-step model."""
    mn = (
        4 * m * n * grad_bytes    # G read by project(S_old), tangent,
                                  # project(S_new) and recovery
        + m * n * F32             # Ghat write (backproject)
        + m * n * F32             # Lam write (recovery)
        + m * n * F32             # Lam read  (||Lam|| reduction)
        + 2 * m * n * F32         # Ghat + Lam read (combine pass)
        + m * n * param_bytes     # update write (lr-scale + cast)
    )
    rn = (
        r * n * F32               # A write (project, old basis)
        + 2 * r * n * F32         # A read twice (G A^T and A A^T in tangent)
        + r * n * F32             # Gt write (project, new basis)
        + 4 * r * n * F32         # dense rotation: M, V read; M', V' write
        + 6 * r * n * F32         # moments: Gt, M, V read; M, V, Gto write
        + 2 * r * n * F32         # phi: Gt, Gto column norms
        + r * n * F32             # Gto read (backproject)
        + r * n * F32             # Gt read (recovery)
    )
    mr = (
        4 * m * r * F32           # S read by project, tangent (x2: G A^T
                                  # term + S(AA^T) term charged once each
                                  # pass), project(new)
        + 2 * m * r * F32         # T write + T read (top1 Gram / T v)
        + 3 * m * r * F32         # geodesic: S read, S v, S_new write
        + 2 * m * r * F32         # S_new read by backproject + recovery
    )
    nb = 2 * n * F32              # phi write + read
    return HotPathTraffic("tracking_unfused", mn, rn, mr, nb)


def tracking_fused_step_bytes(m: int, n: int, r: int, *,
                              grad_bytes: int = F32,
                              param_bytes: int = F32) -> HotPathTraffic:
    """Fused tracking pipeline: project_tangent_colnorms -> top1/geodesic
    -> rank-1 rotation (O(rn), no (r, r) matrix) -> project(S_new) ->
    adam_lowrank_norms -> fused_update.  3 reads of G + 1 final-dtype
    write; no (m, n) intermediate ever exists."""
    mn = (
        3 * m * n * grad_bytes    # G read by project_tangent_colnorms,
                                  # project(S_new) and fused_update
        + m * n * param_bytes     # update write (final dtype, once)
    )
    rn = (
        r * n * F32               # A write (project_tangent_colnorms)
        + 4 * r * n * F32         # rank-1 rotation: M, V read; M', V' write
        + r * n * F32             # Gt write (project, new basis)
        + 6 * r * n * F32         # adam_lowrank_norms: 3 reads + 3 writes
        + 2 * r * n * F32         # Gt, Gto read (fused_update panels)
    )
    mr = (
        2 * m * r * F32           # S read + T write (project_tangent_...)
        + 2 * m * r * F32         # T read (top1 Gram / T v)
        + 3 * m * r * F32         # geodesic: S read, S v, S_new write
        + 2 * m * r * F32         # S_new read by project + fused_update
    )
    nb = 5 * n * F32              # gsq/gtsq/gtosq writes + phi write/read
    return HotPathTraffic("tracking_fused", mn, rn, mr, nb)


def tracking_traffic_ratio(m: int, n: int, r: int, *,
                           grad_bytes: int = F32,
                           param_bytes: int = F32) -> float:
    """fused / unfused tracking-step byte ratio (acceptance: <= 0.7)."""
    fused = tracking_fused_step_bytes(m, n, r, grad_bytes=grad_bytes,
                                      param_bytes=param_bytes)
    unfused = tracking_unfused_step_bytes(m, n, r, grad_bytes=grad_bytes,
                                          param_bytes=param_bytes)
    return fused.total / unfused.total


# ---------------------------------------------------------------------------
# Per-shard byte model: the mesh-native (shard_map'd) hot path
# ---------------------------------------------------------------------------
#
# Under the column-sharded layout (G, M, V, phi sharded over n; S, lam
# replicated) every pass of both schedules is shard-local on an
# (m, n/shards) panel, plus collectives:
#
#   plain step     — one scalar all-reduce (the Eq. 12 clip closed form);
#   tracking step  — one (m, r) all-reduce of the tangent accumulator
#                    (T is linear in W = G A^T, so psumming the
#                    shard-local tangents yields the global one) plus the
#                    same clip scalar.
#
# Collective wire bytes use the ring model (matching
# repro.distributed.hlo_analysis), charged on top of the local HBM bytes:
# ICI and HBM are different resources, but a single conservative "total"
# (local + wire) is what the per-shard ratio below compares, and the
# collectives are O(1) / O(mr) against O(mn/g) local terms, so they
# vanish at production shapes.  The paper-literal baseline is charged the
# SAME collectives (its ||Lam|| reduction / tangent Gram need identical
# cross-shard sums) — generous, since the unfused schedule would
# realistically also re-gather intermediates.
#
# The per-regime collective SET is not defined here: every sharded model
# below charges exactly the CollectiveRounds of the regime's StepProgram
# (repro.core.program.regime_rounds — the same single source of truth the
# runtime executes and tests/test_mesh_fused.py pins compiled HLO
# against), via :func:`program_collective_bytes`.  The byte model can
# therefore never drift from what the lowered step actually sends.


def program_collective_bytes(regime: str, m: int, n: int, r: int,
                             shards: int, *, tracking: bool,
                             recovery: bool = True) -> int:
    """Per-device ring-model wire bytes of one step's collectives, read
    off the regime's declared StepProgram rounds."""
    from repro_torch.core.program import regime_rounds  # lazy: program builds
    #                                               on this module's models

    return sum(rnd.wire_bytes(shards)
               for rnd in regime_rounds(regime, m, n, r, shards,
                                        tracking=tracking,
                                        recovery=recovery))


@dataclass(frozen=True)
class ShardedHotPathTraffic:
    """Per-device byte totals for one column-sharded optimizer step."""

    schedule: str
    shards: int
    local: HotPathTraffic     # shard-local HBM bytes on the (m, n/g) panel
    collective_bytes: int     # ring-model wire bytes per device

    @property
    def total(self) -> int:
        return self.local.total + self.collective_bytes


def allreduce_wire_bytes(payload_bytes: int, group: int) -> int:
    """Ring all-reduce per-device wire bytes (hlo_analysis formula)."""
    if group <= 1:
        return 0
    return int(2.0 * (group - 1) / group * payload_bytes)


def in_column_regime(n: int, shards: int, r: int) -> bool:
    """The deployment rule for column-sharding a leaf over ``shards``
    devices: the shard count must divide n AND the local column count
    must stay >= 2r.  Below that the (r, n/g) state passes and the
    (m, r) tangent psum stop shrinking relative to the gradient panel
    and the fused-vs-literal ratio decays toward 1 — shard a different
    axis (or replicate) instead.  Single source of truth for the layout
    choice (distributed/sharding.py), the benches and the tests.
    """
    return shards >= 1 and n % shards == 0 and n // shards >= 2 * r


def _shard_cols(n: int, shards: int) -> int:
    if shards < 1 or n % shards:
        raise ValueError(f"n={n} not divisible by shards={shards}")
    return n // shards


def sharded_fused_step_bytes(m: int, n: int, r: int, shards: int, *,
                             grad_bytes: int = F32,
                             param_bytes: int = F32) -> ShardedHotPathTraffic:
    """Mesh-native fused plain step: local fused pipeline on n/shards
    columns + the scalar clip all-reduce."""
    local = fused_step_bytes(m, _shard_cols(n, shards), r,
                             grad_bytes=grad_bytes, param_bytes=param_bytes)
    coll = program_collective_bytes("column", m, n, r, shards,
                                    tracking=False)
    return ShardedHotPathTraffic("sharded_fused", shards, local, coll)


def sharded_unfused_step_bytes(m: int, n: int, r: int, shards: int, *,
                               grad_bytes: int = F32,
                               param_bytes: int = F32
                               ) -> ShardedHotPathTraffic:
    """Paper-literal plain step distributed the same way (the baseline the
    per-shard ratio compares against)."""
    local = unfused_step_bytes(m, _shard_cols(n, shards), r,
                               grad_bytes=grad_bytes,
                               param_bytes=param_bytes)
    coll = program_collective_bytes("column", m, n, r, shards,
                                    tracking=False)
    return ShardedHotPathTraffic("sharded_unfused", shards, local, coll)


def sharded_tracking_fused_step_bytes(m: int, n: int, r: int, shards: int, *,
                                      grad_bytes: int = F32,
                                      param_bytes: int = F32
                                      ) -> ShardedHotPathTraffic:
    """Mesh-native fused tracking step: local fused pipeline + the (m, r)
    tangent all-reduce + the clip scalar."""
    local = tracking_fused_step_bytes(m, _shard_cols(n, shards), r,
                                      grad_bytes=grad_bytes,
                                      param_bytes=param_bytes)
    coll = program_collective_bytes("column", m, n, r, shards,
                                    tracking=True)
    return ShardedHotPathTraffic("sharded_tracking_fused", shards, local,
                                 coll)


def sharded_tracking_unfused_step_bytes(m: int, n: int, r: int, shards: int,
                                        *, grad_bytes: int = F32,
                                        param_bytes: int = F32
                                        ) -> ShardedHotPathTraffic:
    """Paper-literal tracking step distributed the same way (same two
    collectives charged — generous to the baseline)."""
    local = tracking_unfused_step_bytes(m, _shard_cols(n, shards), r,
                                        grad_bytes=grad_bytes,
                                        param_bytes=param_bytes)
    coll = program_collective_bytes("column", m, n, r, shards,
                                    tracking=True)
    return ShardedHotPathTraffic("sharded_tracking_unfused", shards, local,
                                 coll)


# ---------------------------------------------------------------------------
# Row-sharded (m) regime: the second mesh-native layout
# ---------------------------------------------------------------------------
#
# Under the row-sharded layout (G, S, params and the update sharded over m;
# M, V, phi and all per-column vectors replicated) the projection A = S^T G
# contracts over the sharded rows, so it is the collective:
#
#   plain step     — ONE stacked (r+1, n) all-reduce ([A; ||G_:,j||^2]
#                    psum'd together).  After it, A and the column norms
#                    are replicated, so the Adam pass, phi, and the Eq. 12
#                    clip closed form are all computed redundantly per
#                    shard with NO further collective (the clip sums
#                    replicated per-column quantities) and the epilogue
#                    writes the local (m/g, n) update rows.
#   tracking step  — the same stacked psum, plus ONE fused (r, n + 3r)
#                    all-reduce of [T^T G | S^T T | T^T T | S^T S].  The
#                    tangent itself is row-local given global A (T_loc =
#                    -2 G_loc A^T + 2 S_loc (A A^T) is exactly the global
#                    tangent's row slice — no (m, r) psum, unlike the
#                    column regime), but the top-1 triple needs the Gram
#                    C = T^T T, which contracts over the sharded rows and
#                    is QUADRATIC in the first psum's result — it cannot
#                    be folded into a single linear collective round.
#                    Given that second payload the geodesic scalars, the
#                    stabilizer, the rank-1 (M, V) rotation and even the
#                    new-basis projection (Gt_new = A + v (p^T G), with
#                    p^T G assembled from v^T T^T G) are replicated, so
#                    the epilogue again runs collective-free.
#
# Local G passes: plain = the unchanged fused pipeline on the (m/g, n)
# panel (2 reads + 1 write).  Tracking = 4 reads + 1 write: the
# project_colnorms pass, the tangent pass (global A), the tangent_gram
# pass (T^T G), and the fused_update pass — one more read than the column
# regime's 3, bought back by the absent (m, r) tangent psum and the
# replicated-geometry epilogue.  The (r, n) state traffic is NOT divided
# by g (M/V replicate across the row group — the memory cost of this
# regime, which is why the layout choice prefers column sharding when
# both regimes are admissible).


def in_row_regime(m: int, shards: int, r: int) -> bool:
    """The deployment rule for row-sharding a leaf over ``shards``
    devices: the shard count must divide m AND the local row count must
    stay >= 2r.  Below that the S_loc/T_loc panels and the (r+1, n)
    stacked psum stop shrinking relative to the local gradient panel and
    the fused-vs-literal ratio decays toward 1 — shard a different axis
    (or replicate) instead.  Mirror of :func:`in_column_regime`; single
    source of truth for the layout choice, the benches and the tests.
    """
    return shards >= 1 and m % shards == 0 and m // shards >= 2 * r


def _shard_rows(m: int, shards: int) -> int:
    if shards < 1 or m % shards:
        raise ValueError(f"m={m} not divisible by shards={shards}")
    return m // shards


def sharded_row_fused_step_bytes(m: int, n: int, r: int, shards: int, *,
                                 grad_bytes: int = F32,
                                 param_bytes: int = F32
                                 ) -> ShardedHotPathTraffic:
    """Mesh-native fused plain step, row regime: the unchanged fused
    pipeline on the local (m/g, n) panel (full-width (r, n) state passes
    — M/V replicate across the row group) + the stacked (r+1, n) psum."""
    local = fused_step_bytes(_shard_rows(m, shards), n, r,
                             grad_bytes=grad_bytes, param_bytes=param_bytes)
    return ShardedHotPathTraffic(
        "sharded_row_fused", shards, local,
        program_collective_bytes("row", m, n, r, shards, tracking=False))


def sharded_row_unfused_step_bytes(m: int, n: int, r: int, shards: int, *,
                                   grad_bytes: int = F32,
                                   param_bytes: int = F32
                                   ) -> ShardedHotPathTraffic:
    """Paper-literal plain step distributed over the same row sharding
    (charged the same stacked psum — its projection needs the identical
    cross-row sum; generous to the baseline, as in the column model)."""
    local = unfused_step_bytes(_shard_rows(m, shards), n, r,
                               grad_bytes=grad_bytes,
                               param_bytes=param_bytes)
    return ShardedHotPathTraffic(
        "sharded_row_unfused", shards, local,
        program_collective_bytes("row", m, n, r, shards, tracking=False))


def row_tracking_fused_step_bytes(m_loc: int, n: int, r: int, *,
                                  grad_bytes: int = F32,
                                  param_bytes: int = F32) -> HotPathTraffic:
    """Local bytes of the row-regime fused tracking step on an (m_loc, n)
    panel: project_colnorms -> [psum] -> tangent (global A) ->
    tangent_gram -> [psum] -> replicated geometry (top1/geodesic/rank-1
    rotation/Gt_new via the rank-1 identity, all O(rn + r^2)) ->
    adam_lowrank_norms -> fused_update.  4 reads of the local G + 1
    final-dtype write; no (m, n) intermediates."""
    mn = (
        4 * m_loc * n * grad_bytes  # G read by project_colnorms, tangent,
                                    # tangent_gram and fused_update
        + m_loc * n * param_bytes   # update write (final dtype, once)
    )
    rn = (
        r * n * F32               # A write (project_colnorms)
        + 2 * r * n * F32         # A read by tangent + tangent_gram epochs
        + 2 * r * n * F32         # T^T G write + read (Gt_new assembly)
        + r * n * F32             # Gt_new write (rank-1 identity, O(rn))
        + 4 * r * n * F32         # rank-1 rotation: M, V read; M', V' write
        + 6 * r * n * F32         # adam_lowrank_norms: 3 reads + 3 writes
        + 2 * r * n * F32         # Gt, Gto read (fused_update panels)
    )
    mr = (
        3 * m_loc * r * F32       # S read by project_colnorms, tangent,
                                  # tangent_gram
        + 2 * m_loc * r * F32     # T write (tangent) + T read (tangent_gram)
        + 2 * m_loc * r * F32     # T read (u = T v) + geodesic S read
        + m_loc * r * F32         # S_new write
        + m_loc * r * F32         # S_new read (fused_update)
    )
    nb = 5 * n * F32              # gsq/gtsq/gtosq + phi write/read
    return HotPathTraffic("row_tracking_fused", mn, rn, mr, nb)


def sharded_row_tracking_fused_step_bytes(m: int, n: int, r: int,
                                          shards: int, *,
                                          grad_bytes: int = F32,
                                          param_bytes: int = F32
                                          ) -> ShardedHotPathTraffic:
    """Mesh-native fused tracking step, row regime: local 4-read pipeline
    + the two documented psums (stacked (r+1, n); fused (r, n+3r) Gram)."""
    local = row_tracking_fused_step_bytes(
        _shard_rows(m, shards), n, r, grad_bytes=grad_bytes,
        param_bytes=param_bytes)
    return ShardedHotPathTraffic(
        "sharded_row_tracking_fused", shards, local,
        program_collective_bytes("row", m, n, r, shards, tracking=True))


def sharded_row_tracking_unfused_step_bytes(m: int, n: int, r: int,
                                            shards: int, *,
                                            grad_bytes: int = F32,
                                            param_bytes: int = F32
                                            ) -> ShardedHotPathTraffic:
    """Paper-literal tracking step distributed over the same row sharding
    (same two collectives charged — its projections and tangent Gram need
    the identical cross-row sums; generous to the baseline)."""
    local = tracking_unfused_step_bytes(_shard_rows(m, shards), n, r,
                                        grad_bytes=grad_bytes,
                                        param_bytes=param_bytes)
    return ShardedHotPathTraffic(
        "sharded_row_tracking_unfused", shards, local,
        program_collective_bytes("row", m, n, r, shards, tracking=True))


# ---------------------------------------------------------------------------
# Row-reduce-scatter (row-rs) regime: sharded Adam states on row shards
# ---------------------------------------------------------------------------
#
# The reduce-scatter flavour of the row regime (StepProgram "row-rs"):
# instead of psumming the stacked (r+1, n) [A; colnorms] panel to every
# row shard and recomputing the full-width (r, n) Adam pass redundantly
# (replicated M/V — the row regime's honest memory cost), the panel is
# reduce-SCATTERED so each shard owns only its (r, n/g) column slice of
# M/V:
#
#   plain step     — the reduce-scatter (half an all-reduce's wire), the
#                    Adam pass + phi + clip partials on the n/g slice,
#                    then ONE all-gather of the stacked (2r+2, n/g)
#                    [G~; G~^O; phi; clip-partials] panel restores full
#                    width (and the global clip sum) right before
#                    fused_update writes the local (m/g, n) rows.  Two
#                    collectives; the sliced 6 r n / g Adam traffic beats
#                    the extra (r+1, n)-ring gather wire for every g >= 2
#                    (6r(1-1/g) > (r+1)(g-1)/g termwise), so inside the
#                    row gate the rs flavour is byte-cheaper everywhere
#                    n divides — on top of cutting per-device M/V memory
#                    by the group factor.
#   tracking step  — the front end keeps the row regime's TWO all-reduce
#                    rounds unchanged (the tangent needs global A; the
#                    Gram is quadratic in it), the rank-1 (M, V) rotation
#                    and the Adam pass then run on the n/g slices of the
#                    already-global new-basis projection, and one
#                    (r+2, n) all-gather of [G~^O; phi; partials] feeds
#                    the epilogue (G~ itself is already global via the
#                    rank-1 identity — never re-gathered).  Three
#                    collectives.
#
# Local G passes match the row regime (plain 2 reads + 1 write; tracking
# 4 reads + 1 write); only the (r, n)-state and rotation terms divide by
# g.  All collective terms are read off the "row-rs" StepProgram rounds.


def in_row_rs_regime(m: int, n: int, shards: int, r: int) -> bool:
    """Admissibility of the reduce-scatter row flavour: the row gate
    (m divisible, m/g >= 2r) plus n divisible by the group (the scatter
    slices columns evenly)."""
    return in_row_regime(m, shards, r) and n % shards == 0


def sharded_row_rs_fused_step_bytes(m: int, n: int, r: int, shards: int, *,
                                    grad_bytes: int = F32,
                                    param_bytes: int = F32
                                    ) -> ShardedHotPathTraffic:
    """Mesh-native fused plain step, row-rs regime: the fused pipeline on
    the local (m/g, n) row panel with the Adam pass on the (r, n/g)
    state slice + the program's reduce-scatter/all-gather rounds."""
    m_loc = _shard_rows(m, shards)
    n_sl = n // shards
    mn = (
        2 * m_loc * n * grad_bytes  # G read by project_colnorms + epilogue
        + m_loc * n * param_bytes   # update write (final dtype, once)
    )
    rn = (
        r * n * F32               # A_loc write (pre-scatter projection)
        + 6 * r * n_sl * F32      # adam_lowrank_norms on the (r, n/g) slice
        + 2 * r * n * F32         # Gt, Gto full-width reads (fused_update)
    )
    mr = 2 * m_loc * r * F32      # S read by project_colnorms + epilogue
    nb = 6 * n_sl * F32 + 2 * n * F32   # slice byproducts + gathered phi r/w
    local = HotPathTraffic("row_rs_fused", mn, rn, mr, nb)
    return ShardedHotPathTraffic(
        "sharded_row_rs_fused", shards, local,
        program_collective_bytes("row-rs", m, n, r, shards, tracking=False))


def sharded_row_rs_unfused_step_bytes(m: int, n: int, r: int, shards: int,
                                      *, grad_bytes: int = F32,
                                      param_bytes: int = F32
                                      ) -> ShardedHotPathTraffic:
    """Paper-literal plain step distributed over the same row sharding
    (full-width state passes — the literal schedule cannot slice its
    moments; charged the same program collectives, generous as ever)."""
    local = unfused_step_bytes(_shard_rows(m, shards), n, r,
                               grad_bytes=grad_bytes,
                               param_bytes=param_bytes)
    return ShardedHotPathTraffic(
        "sharded_row_rs_unfused", shards, local,
        program_collective_bytes("row-rs", m, n, r, shards, tracking=False))


def row_rs_tracking_fused_local_bytes(m_loc: int, n: int, r: int,
                                      shards: int, *,
                                      grad_bytes: int = F32,
                                      param_bytes: int = F32
                                      ) -> HotPathTraffic:
    """Local bytes of the row-rs fused tracking step on an (m_loc, n)
    panel: the row regime's 4-read pipeline with the rank-1 rotation and
    the Adam pass on the (r, n/g) state slices."""
    n_sl = n // shards
    mn = (
        4 * m_loc * n * grad_bytes  # G read by project_colnorms, tangent,
                                    # tangent_gram and fused_update
        + m_loc * n * param_bytes   # update write (final dtype, once)
    )
    rn = (
        r * n * F32               # A write (project_colnorms)
        + 2 * r * n * F32         # A read by tangent + tangent_gram epochs
        + 2 * r * n * F32         # T^T G write + read (Gt_new assembly)
        + r * n * F32             # Gt_new write (rank-1 identity, O(rn))
        + 4 * r * n_sl * F32      # rank-1 rotation on the (r, n/g) slices
        + 6 * r * n_sl * F32      # adam_lowrank_norms on the slices
        + 2 * r * n * F32         # Gt, Gto read (fused_update panels)
    )
    mr = (
        3 * m_loc * r * F32       # S read by project_colnorms, tangent,
                                  # tangent_gram
        + 2 * m_loc * r * F32     # T write (tangent) + T read (tangent_gram)
        + 2 * m_loc * r * F32     # T read (u = T v) + geodesic S read
        + m_loc * r * F32         # S_new write
        + m_loc * r * F32         # S_new read (fused_update)
    )
    nb = 5 * n_sl * F32 + 2 * n * F32   # slice byproducts + gathered phi
    return HotPathTraffic("row_rs_tracking_fused", mn, rn, mr, nb)


def sharded_row_rs_tracking_fused_step_bytes(m: int, n: int, r: int,
                                             shards: int, *,
                                             grad_bytes: int = F32,
                                             param_bytes: int = F32
                                             ) -> ShardedHotPathTraffic:
    """Mesh-native fused tracking step, row-rs regime: local 4-read
    pipeline with sliced state passes + the three program rounds."""
    local = row_rs_tracking_fused_local_bytes(
        _shard_rows(m, shards), n, r, shards, grad_bytes=grad_bytes,
        param_bytes=param_bytes)
    return ShardedHotPathTraffic(
        "sharded_row_rs_tracking_fused", shards, local,
        program_collective_bytes("row-rs", m, n, r, shards, tracking=True))


def sharded_row_rs_tracking_unfused_step_bytes(m: int, n: int, r: int,
                                               shards: int, *,
                                               grad_bytes: int = F32,
                                               param_bytes: int = F32
                                               ) -> ShardedHotPathTraffic:
    """Paper-literal tracking step over the same row sharding (full-width
    state; the same three program collectives charged)."""
    local = tracking_unfused_step_bytes(_shard_rows(m, shards), n, r,
                                        grad_bytes=grad_bytes,
                                        param_bytes=param_bytes)
    return ShardedHotPathTraffic(
        "sharded_row_rs_tracking_unfused", shards, local,
        program_collective_bytes("row-rs", m, n, r, shards, tracking=True))


_REGIME_MODEL_FNS = {
    ("column", False): (sharded_fused_step_bytes,
                        sharded_unfused_step_bytes),
    ("column", True): (sharded_tracking_fused_step_bytes,
                       sharded_tracking_unfused_step_bytes),
    ("row", False): (sharded_row_fused_step_bytes,
                     sharded_row_unfused_step_bytes),
    ("row", True): (sharded_row_tracking_fused_step_bytes,
                    sharded_row_tracking_unfused_step_bytes),
    ("row-rs", False): (sharded_row_rs_fused_step_bytes,
                        sharded_row_rs_unfused_step_bytes),
    ("row-rs", True): (sharded_row_rs_tracking_fused_step_bytes,
                       sharded_row_rs_tracking_unfused_step_bytes),
}


def sharded_traffic_ratio(m: int, n: int, r: int, shards: int, *,
                          tracking: bool = False, regime: str = "column",
                          grad_bytes: int = F32,
                          param_bytes: int = F32) -> float:
    """Per-shard fused / paper-literal total-byte ratio (target <= 0.7:
    the single-chip fusion win must survive distribution).  ``regime``
    selects the column- (n-sharded), row- (m-sharded, replicated M/V) or
    row-rs (m-sharded, reduce-scattered M/V) layout model — the same
    regime names the StepProgram IR uses."""
    try:
        fus_fn, unf_fn = _REGIME_MODEL_FNS[(regime, tracking)]
    except KeyError:
        raise ValueError(f"unknown sharding regime {regime!r}") from None
    fus = fus_fn(m, n, r, shards, grad_bytes=grad_bytes,
                 param_bytes=param_bytes)
    unf = unf_fn(m, n, r, shards, grad_bytes=grad_bytes,
                 param_bytes=param_bytes)
    return fus.total / unf.total


# --- serving: decode-attention cache traffic (dense vs paged) -------------


def decode_dense_bytes(batch: int, max_len: int, n_kv: int, hd: int, *,
                       kv_bytes: int = 2) -> int:
    """HBM bytes one dense-cache decode step streams through attention:
    the full (B, max_len) K and V buffers, regardless of how many tokens
    each sequence actually holds (the static buffer is sized for the
    worst case and read end to end every step)."""
    return 2 * batch * max_len * n_kv * hd * kv_bytes


def decode_paged_bytes(batch: int, context: int, block_size: int,
                       n_kv: int, hd: int, *, kv_bytes: int = 2) -> int:
    """HBM bytes one paged decode step streams: only the blocks each
    sequence OWNS (ceil(context / bs) of them, last one partially
    garbage) plus the int32 table words that address them."""
    blocks = -(-context // block_size)
    kv = 2 * batch * blocks * block_size * n_kv * hd * kv_bytes
    table = batch * blocks * 4
    return kv + table


def decode_attention_flops(batch: int, context: int, n_q: int,
                           hd: int) -> int:
    """MAC-counted flops of one decode step's attention: QK^T plus PV,
    2 * (B * Hq * ctx * hd) each."""
    return 4 * batch * n_q * context * hd
