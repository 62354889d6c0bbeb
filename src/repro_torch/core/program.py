"""StepProgram IR: the per-leaf execution plan of the optimizer step and
the executor that runs its collectives over ``torch.distributed``.

Counterpart of ``repro.core.program``.  :func:`build_program` classifies a
leaf's :class:`~repro_torch.core.plan.ParamPlan` (with the config and the
mesh) into a :class:`StepProgram`: the regime, the mesh axes, the
gradient and Adam-state layouts, the tracking schedule and the full list
of :class:`CollectiveRound`\\ s the step may execute.
:func:`regime_rounds` is the one source of the collective structure: the
traffic model (``repro_torch.kernels.traffic``) charges wire bytes off
these rounds, the tests count each rank's collectives against
:meth:`StepProgram.collective_counts`, and :class:`Exec` fires only the
rounds the program declares, by name.

The five regimes
----------------
========== ============ =============== ======================================
regime     G/S layout   M/V layout      collectives (plain / tracking)
========== ============ =============== ======================================
replicated whole leaf   whole leaf      none
column     n sharded    n sharded       clip scalar AR / + (m, r) tangent AR
row        m sharded    replicated      (r+1, n) proj AR / + (r, n+3r) Gram AR
row-rs     m sharded    n/g slice       (r+1, n) proj RS + epilogue AG /
                                        proj AR + Gram AR + epilogue AG
grass      whole leaf   whole leaf      local ``sel_gather`` round only: S is
                                        a one-hot row selection, A = S^T G a
                                        gather of G's rows
========== ============ =============== ======================================

Grad-fused plain steps declare a local ``grad_tap`` round in the
replicated, column and grass regimes: the (r+1, n) [A; colnorms] panel of
the backward replaces the optimizer's own projection.  Local rounds move
no bytes between ranks and issue no collective.

The port is multi-controller: every rank runs its own process (or, in the
CPU tests, its own thread) and already holds its shards, so where the JAX
package wraps the step in ``shard_map``, :func:`lower` here only checks
the shard shapes against the program's layouts.  :class:`Exec` issues the
rounds on the process group of the program's axes (``allreduce``,
``_reduce_scatter_base``, ``_allgather_base`` on the group object), every
rank in the same order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core import plan as plan_lib

F32 = 4

REGIMES = ("replicated", "column", "row", "row-rs", "grass")

# collective kinds (the JAX package's HLO opcode names)
ALL_REDUCE = "all-reduce"
REDUCE_SCATTER = "reduce-scatter"
ALL_GATHER = "all-gather"
# a local round: a declared data-flow edge of the step (the grad-fused
# tap panel, the Grass row gather) with no wire bytes and no collective
GRAD_FUSED = "grad-fused"


@dataclass(frozen=True)
class CollectiveRound:
    """One declared collective of a step program.

    ``rows, cols`` are the logical 2-D payload shape: the pre-collective
    per-rank operand for all-reduce / reduce-scatter, the gathered panel
    for all-gather."""

    name: str          # the label the executor invokes it by
    kind: str          # ALL_REDUCE | REDUCE_SCATTER | ALL_GATHER | GRAD_FUSED
    rows: int
    cols: int
    dtype_bytes: int = F32

    @property
    def payload_bytes(self) -> int:
        return self.rows * self.cols * self.dtype_bytes

    def wire_bytes(self, group: int) -> int:
        """Per-rank ring-model wire bytes: AR = 2(g-1)/g * payload, RS and
        AG = (g-1)/g * payload."""
        if self.kind == GRAD_FUSED or group <= 1:
            return 0
        ring = (group - 1) / group
        if self.kind == ALL_REDUCE:
            return int(2.0 * ring * self.payload_bytes)
        if self.kind in (REDUCE_SCATTER, ALL_GATHER):
            return int(ring * self.payload_bytes)
        raise ValueError(f"unknown collective kind {self.kind!r}")


def regime_rounds(regime: str, m: int, n: int, r: int, group: int, *,
                  tracking: bool, recovery: bool = True,
                  tapped: bool = False) -> tuple[CollectiveRound, ...]:
    """The collective rounds of one optimizer step.  Round names:

    * ``proj``            — makes the stacked (r+1, n) [A; colnorms] panel
                            global (row regimes: A contracts over rows);
    * ``tangent_psum``    — (m, r) tangent sum (column tracking; T is a
                            sum over the column shards);
    * ``gram_psum``       — the fused (r, n + 3r) [T^T G | S^T T | T^T T |
                            S^T S] sum (row-family tracking);
    * ``clip``            — the Eq. 12 scalar sum (column);
    * ``epilogue_gather`` — row-rs: all-gather of the per-column epilogue
                            panel back to full width before fused_update;
    * ``grad_tap``        — grad-fused plain steps: the backward's (r+1, n)
                            panel (local);
    * ``sel_gather``      — Grass: A = S^T G is a gather of G's rows
                            (local)."""
    tap = ((CollectiveRound("grad_tap", GRAD_FUSED, r + 1, n),)
           if tapped and not tracking else ())
    if regime == "grass":
        # the tap subsumes the gather (it is the gathered rows + norms)
        return tap if tap else (
            CollectiveRound("sel_gather", GRAD_FUSED, r, n),)
    if group <= 1 or regime == "replicated":
        return tap
    if regime == "column":
        rounds = list(tap)
        if tracking:
            rounds.append(CollectiveRound("tangent_psum", ALL_REDUCE, m, r))
        if recovery:
            rounds.append(CollectiveRound("clip", ALL_REDUCE, 1, 1))
        return tuple(rounds)
    if regime == "row":
        rounds = [CollectiveRound("proj", ALL_REDUCE, r + 1, n)]
        if tracking:
            rounds.append(CollectiveRound("gram_psum", ALL_REDUCE,
                                          r, n + 3 * r))
        return tuple(rounds)
    if regime == "row-rs":
        if tracking:
            # AR front end (the tangent needs global A), sliced rotation
            # and Adam, then gather [G~^O; phi; partials]: G~ (the
            # new-basis projection) is already global, so not re-gathered
            gathered = (r + 2) if recovery else r
            return (CollectiveRound("proj", ALL_REDUCE, r + 1, n),
                    CollectiveRound("gram_psum", ALL_REDUCE, r, n + 3 * r),
                    CollectiveRound("epilogue_gather", ALL_GATHER,
                                    gathered, n))
        gathered = (2 * r + 2) if recovery else r
        return (CollectiveRound("proj", REDUCE_SCATTER, r + 1, n),
                CollectiveRound("epilogue_gather", ALL_GATHER, gathered, n))
    raise ValueError(f"unknown regime {regime!r}")


@dataclass(frozen=True)
class StepProgram:
    """Declarative description of one leaf's optimizer step.  ``axes``
    empty means the unsharded path: every round an identity."""

    regime: str                 # one of REGIMES
    axes: tuple                 # mesh axes of the sharded dim; () unsharded
    shards: int                 # group size over ``axes``
    m: int
    n: int
    rank: int
    tracking: bool              # which step kind this program describes
    tracks: bool                # does the refresh move the basis?  False
    #                             for plain steps and for tracking steps
    #                             of frozen-subspace methods, which declare
    #                             the plain rounds
    recovery: bool
    rounds: tuple               # tuple[CollectiveRound, ...]
    grad_layout: str            # "replicated" | "column" | "row"
    state_layout: str           # M/V: "inherit" | "column" | "replicated"
    #                             | "slice" (n/g column slice per row shard)
    schedule: str               # tracking geometry: "tangent" | "gram"

    def round(self, name: str) -> Optional[CollectiveRound]:
        for rnd in self.rounds:
            if rnd.name == name:
                return rnd
        return None

    def collective_counts(self) -> dict[str, int]:
        """{collective kind: count} of the rounds that communicate (local
        rounds issue no collective)."""
        counts: dict[str, int] = {}
        for rnd in self.rounds:
            if rnd.kind not in (ALL_REDUCE, REDUCE_SCATTER, ALL_GATHER):
                continue
            counts[rnd.kind] = counts.get(rnd.kind, 0) + 1
        return counts

    def collective_wire_bytes(self) -> int:
        """Per-rank ring-model wire bytes of all rounds."""
        return sum(rnd.wire_bytes(self.shards) for rnd in self.rounds)


_GRAD_LAYOUT = {"replicated": "replicated", "column": "column",
                "row": "row", "row-rs": "row", "grass": "replicated"}
_STATE_LAYOUT = {"replicated": "inherit", "column": "column",
                 "row": "replicated", "row-rs": "slice", "grass": "inherit"}
_SCHEDULE = {"replicated": "tangent", "column": "tangent",
             "row": "gram", "row-rs": "gram", "grass": "tangent"}


def pick_row_flavor(m: int, n: int, r: int, group: int,
                    row_state: str = "auto") -> str:
    """The row-family state flavour: replicated M/V ("row") or the
    reduce-scatter slice layout ("row-rs").  ``row_state`` forces one
    ("replicated" / "reduce-scatter"); "auto" takes the one with fewer
    modeled per-rank plain-step bytes.  row-rs needs n divisible by the
    group (a forced "reduce-scatter" degrades to "row" otherwise).  Shared
    by :func:`build_program` and ``distributed.sharding._row_bytes``, so the
    layout ranking and the executed flavour cannot drift."""
    if row_state == "replicated" or n % group != 0:
        return "row"
    if row_state == "reduce-scatter":
        return "row-rs"
    from repro_torch.kernels import traffic  # lazy: traffic reads our rounds

    rs = traffic.sharded_row_rs_fused_step_bytes(m, n, r, group).total
    rep = traffic.sharded_row_fused_step_bytes(m, n, r, group).total
    return "row-rs" if rs < rep else "row"


def build_program(plan: plan_lib.ParamPlan, cfg, mesh, *,
                  tracking: bool, tapped: bool = False) -> StepProgram:
    """Classify one leaf into its StepProgram (``mesh`` is a
    :class:`~repro_torch.distributed.context.MeshContext` or None).

    A leaf takes a sharded regime only when the optimizer was built with a
    mesh and specs, runs the fused kernels, and, on tracking steps, uses a
    shardable refresh ("grassmann" / "none"); row-family regimes also route
    QR-scrubbing tracking steps away.  Grass never shards (its top-r row
    selection contracts over all columns).  Everything else is replicated.
    ``tapped`` marks a grad-fused plain step; only the replicated, column
    and grass regimes may consume the tap."""
    m, n, r = plan.m, plan.n, plan.rank
    method = getattr(cfg, "method", "grassmann")
    regime, axes = "replicated", ()
    if plan.mode == "lowrank" and method == "grass":
        regime = "grass"
    elif (mesh is not None and getattr(cfg, "use_kernels", False)
            and plan.mode == "lowrank"
            and not (tracking and cfg.method not in ("grassmann", "none"))):
        col = plan_lib.spec_column_axes(plan)
        row = plan_lib.spec_row_axes(plan)
        if col is not None:
            regime, axes = "column", col
        elif row is not None and not (tracking and cfg.method == "grassmann"
                                      and cfg.reorth_interval):
            regime, axes = "row", row
    shards = math.prod(mesh.shape[a] for a in axes) if axes else 1
    if regime == "row":
        regime = pick_row_flavor(m, n, r, shards,
                                 getattr(cfg, "row_state", "auto"))
    recovery = bool(getattr(cfg, "recovery", True))
    tapped = tapped and not tracking and regime in ("replicated", "column",
                                                   "grass")
    # the rounds follow the effective geometry: a tracking step of a
    # frozen-subspace method declares the plain rounds
    tracks = tracking and method in ("grassmann", "grass")
    return StepProgram(
        regime=regime, axes=tuple(axes), shards=shards, m=m, n=n, rank=r,
        tracking=tracking, tracks=tracks, recovery=recovery,
        rounds=regime_rounds(regime, m, n, r, shards, tracking=tracks,
                             recovery=recovery, tapped=tapped),
        grad_layout=_GRAD_LAYOUT[regime],
        state_layout=_STATE_LAYOUT[regime],
        schedule=_SCHEDULE[regime])


# ---------------------------------------------------------------------------
# Checkpoint-facing descriptors: the serializable face of a StepProgram
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StateDescriptor:
    """Serializable per-leaf record of one optimizer-state leaf's layout,
    so a checkpoint written under one program (rank, method, regime) can
    be transposed onto another on restore
    (``repro_torch.checkpoint.transpose``).

    ``kind`` is "lowrank" (a MatrixOptState leaf) or "dense".  For
    low-rank leaves ``m, n, rank`` are the canonical (post-transpose)
    dims and ``method`` the refresh family (a dense basis, or "grass"'s
    one-hot row selection); the layout fields mirror :class:`StepProgram`.
    A descriptor is a leaf of the descriptor tree."""

    kind: str                     # "lowrank" | "dense"
    regime: str = "replicated"
    axes: tuple = ()
    shards: int = 1
    grad_layout: str = "replicated"
    state_layout: str = "inherit"
    schedule: str = "tangent"
    m: int = 0
    n: int = 0
    rank: int = 0
    batch_dims: int = 0
    method: str = "grassmann"

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "regime": self.regime,
            "axes": [str(a) for a in self.axes], "shards": int(self.shards),
            "grad_layout": self.grad_layout,
            "state_layout": self.state_layout, "schedule": self.schedule,
            "m": int(self.m), "n": int(self.n), "rank": int(self.rank),
            "batch_dims": int(self.batch_dims), "method": self.method,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StateDescriptor":
        return cls(kind=d["kind"], regime=d.get("regime", "replicated"),
                   axes=tuple(d.get("axes", ())),
                   shards=int(d.get("shards", 1)),
                   grad_layout=d.get("grad_layout", "replicated"),
                   state_layout=d.get("state_layout", "inherit"),
                   schedule=d.get("schedule", "tangent"),
                   m=int(d.get("m", 0)), n=int(d.get("n", 0)),
                   rank=int(d.get("rank", 0)),
                   batch_dims=int(d.get("batch_dims", 0)),
                   method=d.get("method", "grassmann"))


def descriptor_for(plan: plan_lib.ParamPlan, cfg,
                   mesh=None) -> StateDescriptor:
    """One leaf's StateDescriptor, from the same ``build_program``
    classification the plain step runs under."""
    if plan.mode != "lowrank":
        return StateDescriptor(kind="dense")
    prog = build_program(plan, cfg, mesh, tracking=False)
    return StateDescriptor(
        kind="lowrank", regime=prog.regime, axes=prog.axes,
        shards=prog.shards, grad_layout=prog.grad_layout,
        state_layout=prog.state_layout, schedule=prog.schedule,
        m=prog.m, n=prog.n, rank=prog.rank, batch_dims=plan.batch_dims,
        method=getattr(cfg, "method", "grassmann"))


def state_leaf_descriptors(params, cfg, mesh=None, param_specs=None):
    """Tree mirroring ``params`` of per-leaf :class:`StateDescriptor`.
    ``cfg`` is any optimizer config; one without a ``rank`` (the dense
    baselines) gives all-dense descriptors."""
    rank = getattr(cfg, "rank", 0)

    def walk(p, plan):
        if isinstance(p, dict):
            return {k: walk(v, None if plan is None else plan[k])
                    for k, v in p.items()}
        return (StateDescriptor(kind="dense") if plan is None
                else descriptor_for(plan, cfg, mesh))

    return walk(params, plan_lib.make_plans(params, rank, specs=param_specs)
                if rank else None)


# ---------------------------------------------------------------------------
# Layouts: the shard each rank holds under a program
# ---------------------------------------------------------------------------


def layout_specs(program: StepProgram, batch_dims: int):
    """The program's canonical-orientation specs: (gradient spec,
    MatrixOptState of the state's specs).  The gradient, parameter and
    update follow ``grad_layout``; S shards with the gradient rows; M and V
    follow ``state_layout`` ("column" and "slice" both shard the (r, n)
    state along n); ``lam_prev`` is replicated.  A spec entry is the
    program's axes (a tuple) or None."""
    from repro_torch.core.lowrank_adam import MatrixOptState

    lead = (None,) * batch_dims
    ax = program.axes or None
    if program.grad_layout == "column":
        g, s = lead + (None, ax), lead + (None, None)
    elif program.grad_layout == "row":
        g, s = lead + (ax, None), lead + (ax, None)
    else:
        g = s = lead + (None, None)
    mv = (lead + (None, ax) if program.state_layout in ("column", "slice")
          else lead + (None, None))
    return g, MatrixOptState(S=s, M=mv, V=mv, lam_prev=lead)


def shard_shape(shape, spec, shards: int) -> tuple:
    """The per-rank shape of a tensor of ``shape`` under ``spec``: every
    sharded dim divided by the group size (which must divide it)."""
    out = []
    for d, ax in zip(shape, spec):
        if ax is not None and d % shards:
            raise ValueError(f"dim {d} does not split into {shards} shards")
        out.append(d // shards if ax is not None else d)
    return tuple(out)


# ---------------------------------------------------------------------------
# Runtime execution: named-round collectives over torch.distributed
# ---------------------------------------------------------------------------


class Exec:
    """Runtime face of a StepProgram inside the per-leaf step.

    The math in ``subspace`` / ``lowrank_adam`` is written once against
    this interface: collectives are invoked by round name and are
    identities unless the program declares them; layout questions
    (``state_slice``, ``state_width``) answer from the program's declared
    layouts.  ``mesh`` supplies the process group of the program's axes
    and this rank's index along them; the unsharded singleton
    :data:`NULL_EXEC` serves every caller with no program."""

    def __init__(self, program: StepProgram, mesh=None):
        self.program = program
        sharded = bool(program.axes) and program.shards > 1
        if sharded and mesh is None:
            raise ValueError(f"a {program.regime} program over "
                             f"{program.axes} needs the mesh it runs on")
        self.group = mesh.group(program.axes) if sharded else None
        self.index = mesh.axis_index(program.axes) if sharded else 0

    # --- program data reads -------------------------------------------
    @property
    def schedule(self) -> str:
        return self.program.schedule

    @property
    def rows_sharded(self) -> bool:
        return self.program.grad_layout == "row"

    def has(self, name: str) -> bool:
        return self.program.round(name) is not None

    def state_width(self, n: int) -> int:
        """Columns of the Adam-state block this shard owns."""
        if self.program.state_layout == "slice":
            return n // self.program.shards
        return n

    # --- communication primitives -------------------------------------
    def collective(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Execute round ``name`` on ``x``: identity when the program does
        not declare it (or the program is unsharded).  All-reduce sums;
        reduce-scatter and all-gather act on the last dim, tiled (rank i
        gets or gives column block i), as the JAX package's
        ``psum_scatter`` / ``all_gather(axis=ndim-1, tiled=True)``."""
        rnd = self.program.round(name)
        if rnd is None or rnd.kind == GRAD_FUSED or self.group is None:
            return x
        if rnd.kind == ALL_REDUCE:
            return self.psum(x)
        g = self.program.shards
        # the tensor collectives split dim 0: bring the column dim first
        xt = x.movedim(-1, 0).contiguous()
        if rnd.kind == REDUCE_SCATTER:
            out = torch.empty((xt.shape[0] // g,) + xt.shape[1:],
                              dtype=x.dtype, device=x.device)
            self.group._reduce_scatter_base(out, xt).wait()
        elif rnd.kind == ALL_GATHER:
            out = torch.empty((xt.shape[0] * g,) + xt.shape[1:],
                              dtype=x.dtype, device=x.device)
            self.group._allgather_base(out, xt).wait()
        else:
            raise ValueError(f"unknown collective kind {rnd.kind!r}")
        return out.movedim(0, -1).contiguous()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the program's group (identity when unsharded): the
        all-reduce rounds, and the unfused schedule's raw sums."""
        if self.group is None:
            return x
        y = x.contiguous().clone()
        self.group.allreduce([y]).wait()
        return y

    def state_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's Adam-state column block of a full-width tensor
        (identity unless the state layout is "slice")."""
        if self.program.state_layout != "slice" or self.group is None:
            return x
        n_loc = x.shape[-1] // self.program.shards
        return x[..., self.index * n_loc:(self.index + 1) * n_loc] \
            .contiguous()


NULL_PROGRAM = StepProgram(
    regime="replicated", axes=(), shards=1, m=0, n=0, rank=0,
    tracking=False, tracks=False, recovery=True, rounds=(),
    grad_layout="replicated", state_layout="inherit", schedule="tangent")

NULL_EXEC = Exec(NULL_PROGRAM)


def executor(program: StepProgram, mesh=None) -> Exec:
    # unsharded programs share the null executor, but one that declares
    # rounds at group 1 (the grass gather, grad-fused taps) gets its own,
    # so has() answers from its rounds
    if not program.axes and not program.rounds:
        return NULL_EXEC
    return Exec(program, mesh)


# ---------------------------------------------------------------------------
# Lowering: program -> the shard-local per-leaf runner
# ---------------------------------------------------------------------------


def lower(program: StepProgram, fn: Callable, *, batch_dims: int
          ) -> Callable:
    """The per-leaf runner ``runner(g, st, p=None, tap=None)`` of the
    stacked step ``fn(g, st, p, tap) -> (delta, st', diag)``.

    Every rank already holds its shards (the JAX package's ``shard_map``
    has nothing left to do), so the runner checks each shard's shape
    against the program's declared layouts (:func:`layout_specs`) and
    calls ``fn``: a gradient that is not this program's shard raises
    rather than run another regime.  The health vector ``fn`` returns is
    replicated: sigma, theta and the guard flags derive from summed
    quantities, so every shard holds the same values under both tracking
    schedules."""
    gspec, stspec = layout_specs(program, batch_dims)
    g = program.shards

    def check(name, t, spec, last2):
        if t is None:
            return
        want = shard_shape(tuple(t.shape[:batch_dims]) + last2,
                           spec, g)
        if tuple(t.shape) != want:
            raise ValueError(f"{program.regime} program: {name} shard "
                             f"{tuple(t.shape)}, expected {want}")

    m, n, r = program.m, program.n, program.rank

    def runner(grad, st, p=None, tap=None):
        check("G", grad, gspec, (m, n))
        check("param", p, gspec, (m, n))
        check("S", st.S, stspec.S, (m, r))
        check("M", st.M, stspec.M, (r, n))
        check("V", st.V, stspec.V, (r, n))
        if tap is not None:
            check("tap", tap, gspec[:-2] + (None, gspec[-1]), (r + 1, n))
        return fn(grad, st, p, tap)

    return runner
