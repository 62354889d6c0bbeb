"""Training driver: SubTrack++ on one GPU or a mesh of them, with the
fault-tolerant runtime.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama-1b --optimizer subtrack --use-kernels [--grad-fused] \\
        --steps 4 --update-interval 2 --warmup 2 --batch 4 --seq 512 \\
        [--checkpoint-dir D] [--inject nan-grad@3,loss-spike@9]
    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train \\
        --arch llama-1b --use-kernels --mesh host [--hotpath-layout row]

Counterpart of ``repro.launch.train``: the warm start
installs every subspace from the step-0 gradients (Alg. 1 line 1), then
each step runs the plain or the tracking train step, with the JAX
package's rule ``do_update = k and step > 0 and step % k == 0``.  With
``--use-kernels`` the optimizer runs the fused hot path through the
hand-written CUDA kernels (``repro_torch.kernels.ops``).  With
``--grad-fused`` the plain steps take the grad-fused backward: every
taggable matmul forms its weight gradient through the ``grad_tap`` kernel,
which also emits the [A; colnorms] panel that the clip and the
optimizer's plain step consume in place of a projection pass (a model
family with no taggable matmul, zamba, xlstm or the encoder-decoder,
says so and takes the plain backward, as the JAX package does).  Weights are random, drawn from
``--seed``; batches come from the synthetic Zipf + Markov stream and are
validated on the host before any embedding lookup.

``--accum N`` splits each batch into N microbatches whose gradients add
into an fp32 accumulator (the grad-fused backward then falls back to the
plain one, as in the JAX driver); ``--remat dots`` keeps each layer's
projection outputs and recomputes the rest.  The dense baselines
``--optimizer adamw`` and ``badam`` have no subspace: no warm start, no
tracking step, no kernel.

The runtime around the step, as the JAX driver's:

* **quarantine**: every step's health report gates its apply
  (``launch/steps.py``): a non-finite loss, gradient norm or update norm
  leaves the whole train state bit-identical;
* **the escalation ladder**: :class:`HealthSentinel` folds the device's
  verdict, a non-finite drain, a loss spike against its EMA, and
  skip-marked batches into strikes: skip -> forced subspace refresh ->
  rollback to the newest known-good checkpoint with lr backoff -> abort;
* **checkpoints** (``--checkpoint-dir``): an async save every
  ``--checkpoint-every`` steps, tagged known-good only after the step's
  verdict is OK, and a blocking save at the end, in the JAX package's
  format; on start the newest restorable checkpoint (this package's or
  the JAX package's, elastic across ranks by default) resumes the run
  with no warm start;
* **preemption**: SIGTERM / SIGINT finishes the step under way, writes a
  bounded known-good save and a ``RESUME`` marker, and returns;
* **injections** (``--inject kind@step``, each consumed once):
  nan-grad, loss-spike, sigma-blowup, corrupt-batch, ckpt-io-error,
  dev-loss, preempt and slow-host; ``--fail-at-step`` raises mid-run;
* **elastic mesh failover**: a deadline on each step (``--step-timeout``:
  its compute, collectives and drain), and any raising collective, turn a
  hung or lost rank into a ``MESH_LOST`` verdict, distinct from the
  numerical ladder.  Every rank aborts the old group; the survivors
  rebuild the mesh (``launch/mesh.py`` ``degraded_context``), re-plan
  every leaf's StepProgram on it (regimes and group sizes flip where the
  gates say so), elastic-restore the newest known-good checkpoint onto
  the new programs and resume, bounded by ``--max-failovers``; a rank
  outside the survivors returns a summary that says it was lost.
  ``--inject dev-loss@N`` simulates the loss (``--dev-loss-mode`` raise
  or hang, ``--survivors``, ``--hang-s``).

Unlike the JAX driver's loop, which drains step t's metrics after
dispatching step t + 1, this loop is synchronous: each step is drained
(one device sync) before the next starts, so the sentinel acts on the
step it judged.  Where the JAX driver rolls back it discards the step it
had already dispatched, and with it any injection of that step; here
that step was never run, so its injection fires on the replay.

``--mesh host`` runs the (1, N) mesh over the first ``--mesh-devices``
ranks (0: all) that ``torchrun`` started, each rank on its own card (a
rank past them returns at once): the default process group is NCCL on
CUDA and gloo when ``--device cpu`` asks for the CPU (a plain ``python
-m`` start is a world of one), and the mesh runs on a group of its own.
:func:`train` also runs on a process group its caller hands it (``group=``,
with a ``new_group`` factory for the rebuilds: the CPU tests' threaded
ranks).  Every rank takes the same batch and runs the forward and
backward whole; with ``--use-kernels`` each low-rank leaf's optimizer
step runs the StepProgram of its ``--hotpath-layout`` (auto, column,
row, row-rs, or off for none) on this rank's shards, and the step
gathers the updates (``launch/steps.py``).  Checkpoints on a mesh hold
the logical arrays: every rank gathers its state shards, rank 0 writes,
and a restore keeps each rank's shards under the run's programs
(``checkpoint/``).  Only rank 0 prints the step lines.

The driver runs on CUDA unless ``--device cpu`` asks for the CPU; with no
card and no such request it raises.  ``--mesh prod`` / ``multipod`` on a
world of other than 256 / 512 ranks raise: not ported yet.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import transpose as ckpt_transpose
from repro_torch.configs.registry import PAPER_RANKS, get_config
from repro_torch.core import health as health_lib
from repro_torch.core.api import get_optimizer
from repro_torch.core.subtrack import LowRankConfig, tree_leaves
from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                       batch_for_model, corrupt_tokens,
                                       fetch_batch, validate_batch)
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import MeshLostError, SimulatedDeviceLoss
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import (TrainState, checkpoint_descriptors,
                                      default_rank, make_train_step,
                                      make_warm_start,
                                      train_state_shardings)
from repro_torch.models.api import build_model
from repro_torch.optim.schedules import cosine_with_warmup


class StragglerWatchdog:
    """Per-step wall-time anomaly detector (EMA mean/var, 6-sigma gate)."""

    def __init__(self, alpha: float = 0.05, warmup: int = 5,
                 sigma: float = 6.0):
        self.alpha, self.warmup, self.sigma = alpha, warmup, sigma
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            self.mean = dt if self.n == 1 else \
                (self.mean * (self.n - 1) + dt) / self.n
            return False
        thresh = self.mean + self.sigma * math.sqrt(max(self.var, 1e-12))
        slow = dt > thresh and dt > self.mean * 1.5
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        if slow:
            self.flagged.append((step, dt))
            print(f"[watchdog] step {step} took {dt:.3f}s "
                  f"(mean {self.mean:.3f}s) — straggler suspected; "
                  f"pid={os.getpid()}", flush=True)
        return slow


class HealthSentinel:
    """Host-side health gate driving the escalation ladder.

    One verdict per drained step, from three strike sources folded into
    one counter: the device's quarantine verdict, a non-finite drained
    loss or grad norm, and an EMA loss-spike gate (loss > mean +
    sigma*sqrt(var) AND loss > mean*factor: the finite-but-wrecked model
    quarantine cannot see).  Consecutive strikes climb the ladder: 1 ->
    skip, 2 -> force a subspace refresh on the next step, >= 3 -> roll
    back to the newest known-good checkpoint with lr backoff for a
    cooldown window.  A healthy step resets the counter; more than
    ``max_rollbacks`` rollbacks abort the run.

    Infrastructure faults take a separate door: :meth:`mesh_lost` is the
    ``MESH_LOST`` verdict for a hung or raising collective.  It never
    touches the strike counter (the logical state is not suspect, the
    topology is) and escalates straight to ``FAILOVER``, with no lr
    backoff: the model was healthy."""

    OK, SKIP, REFRESH, ROLLBACK, ABORT = \
        "ok", "skip", "refresh", "rollback", "abort"
    MESH_LOST, FAILOVER = "mesh-lost", "failover"

    def __init__(self, alpha: float = 0.05, warmup: int = 5,
                 sigma: float = 4.0, factor: float = 1.25,
                 strikes_to_rollback: int = 3, max_rollbacks: int = 2,
                 lr_backoff: float = 0.5, cooldown: int = 10):
        self.alpha, self.warmup, self.sigma, self.factor = \
            alpha, warmup, sigma, factor
        self.strikes_to_rollback = strikes_to_rollback
        self.max_rollbacks = max_rollbacks
        self.lr_backoff = lr_backoff
        self.cooldown = cooldown
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.strikes = 0
        self.rollbacks = 0
        self.backoff_until = -1
        self.quarantined_steps: list[int] = []
        self.events: list[dict] = []

    def lr_scale(self, step: int) -> float:
        return self.lr_backoff if step < self.backoff_until else 1.0

    def _spiked(self, loss: float) -> bool:
        if self.n < self.warmup:
            return False
        thresh = self.mean + self.sigma * math.sqrt(max(self.var, 1e-12))
        return loss > thresh and loss > self.mean * self.factor

    def observe(self, step: int, loss: float, grad_norm: float,
                quarantined: bool) -> str:
        if quarantined:
            self.quarantined_steps.append(step)
            return self.strike(step, "step quarantined in-graph")
        if not (np.isfinite(loss) and np.isfinite(grad_norm)):
            return self.strike(
                step, f"non-finite drain (loss={loss}, gnorm={grad_norm})")
        if self._spiked(loss):
            return self.strike(
                step, f"loss spike ({loss:.4f} vs EMA {self.mean:.4f})")
        self.n += 1
        if self.n <= self.warmup:
            self.mean = loss if self.n == 1 else \
                (self.mean * (self.n - 1) + loss) / self.n
        else:
            d = loss - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.strikes = 0
        return self.OK

    def strike(self, step: int, reason: str) -> str:
        self.strikes += 1
        if self.strikes == 1:
            action = self.SKIP
        elif self.strikes < self.strikes_to_rollback:
            action = self.REFRESH
        else:
            self.strikes = 0
            self.rollbacks += 1
            action = (self.ABORT if self.rollbacks > self.max_rollbacks
                      else self.ROLLBACK)
        self.events.append({"step": step, "reason": reason,
                            "action": action})
        print(f"[sentinel] step {step}: {reason} — "
              f"strike -> {action}", flush=True)
        return action

    def note_rollback(self, resume_step: int) -> None:
        self.backoff_until = resume_step + self.cooldown

    def mesh_lost(self, step: int, reason: str) -> str:
        """The infrastructure verdict: record it and escalate straight to
        failover."""
        self.events.append({"step": step, "reason": reason,
                            "action": self.FAILOVER,
                            "verdict": self.MESH_LOST})
        print(f"[sentinel] step {step}: {reason} — verdict "
              f"{self.MESH_LOST} -> {self.FAILOVER}", flush=True)
        return self.FAILOVER


INJECT_KINDS = ("nan-grad", "loss-spike", "sigma-blowup", "corrupt-batch",
                "ckpt-io-error", "dev-loss", "preempt", "slow-host")

# eta multiplier for --inject sigma-blowup: with the default eta = 10 this
# drives eta*sigma far past pi/2 on the injected tracking step, so the
# theta clamp (repro_torch.core.health.THETA_MAX) must hold.
BLOWUP_ETA_SCALE = 1e6

_INJECT_CODES = {None: health_lib.INJECT_NONE,
                 "nan-grad": health_lib.INJECT_NAN_GRAD,
                 "loss-spike": health_lib.INJECT_LOSS_SPIKE,
                 "sigma-blowup": health_lib.INJECT_NONE}


def parse_injections(spec: str) -> dict[int, str]:
    """``kind@step[,kind@step...]`` -> {step: kind}."""
    out: dict[int, str] = {}
    if not spec:
        return out
    for part in spec.split(","):
        kind, _, at = part.strip().rpartition("@")
        if kind not in INJECT_KINDS:
            raise SystemExit(
                f"--inject: unknown kind {kind!r} (choose from "
                f"{', '.join(INJECT_KINDS)})")
        out[int(at)] = kind
    return out


def _parse_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--optimizer", default="subtrack")
    ap.add_argument("--rank", type=int, default=0,
                    help="0 = the paper's rank for the arch")
    ap.add_argument("--update-interval", type=int, default=200)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eta", type=float, default=10.0)
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--mesh", default="smoke",
                    choices=["smoke", "host", "prod", "multipod"],
                    help="smoke: one rank; host: (1, N) over the ranks "
                         "torchrun started; prod / multipod: the 16x16 / "
                         "2x16x16 meshes (a world of 256 / 512 ranks)")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="with --mesh host: build the (1, N) mesh over "
                         "only the first N ranks (0 = all; the others "
                         "return at once): how the failover tests run "
                         "uninjected degraded-mesh reference runs")
    ap.add_argument("--hotpath-layout", default="auto",
                    choices=["auto", "column", "row", "row-rs", "off"],
                    help="the sharded optimizer layout under a mesh: auto "
                         "picks column or row per leaf by the modeled "
                         "per-rank bytes (repro_torch.kernels.traffic); "
                         "column / row restrict to one regime (row still "
                         "picks its state flavour); row-rs forces the "
                         "reduce-scatter flavour; off keeps every leaf "
                         "replicated")
    ap.add_argument("--step-timeout", type=float, default=300.0,
                    help="deadline (s) on each step's compute, collectives "
                         "and drain; exceeding it is a MESH_LOST verdict "
                         "(a collective presumed hung) and triggers "
                         "failover.  0 disables")
    ap.add_argument("--survivors", type=int, default=0,
                    help="rank count the mesh shrinks to on failover when "
                         "the fault does not name survivors (0 = half the "
                         "mesh, min 1); also the subset --inject dev-loss "
                         "leaves alive")
    ap.add_argument("--dev-loss-mode", default="raise",
                    choices=["raise", "hang"],
                    help="--inject dev-loss flavour: raise surfaces a "
                         "failed collective at dispatch; hang blocks the "
                         "step's drain so the --step-timeout deadline "
                         "must catch it")
    ap.add_argument("--hang-s", type=float, default=30.0,
                    help="how long the simulated hung collective blocks "
                         "(dev-loss hang mode; keep it above "
                         "--step-timeout so the deadline fires first)")
    ap.add_argument("--max-failovers", type=int, default=2,
                    help="mesh rebuilds allowed before a MESH_LOST "
                         "verdict is re-raised to the operator")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-fused", action="store_true",
                    help="plain steps take the grad-fused backward")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", default="elastic",
                    choices=["elastic", "strict", "off"],
                    help="elastic (default) transposes the newest "
                         "checkpoint's state onto this run's programs "
                         "(another rank or method restores here); strict "
                         "requires identical state shapes; off starts "
                         "fresh (checkpoints are still written)")
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="failure injection: raise at this step")
    ap.add_argument("--inject", default="",
                    help="fault injection: comma-separated kind@step with "
                         f"kind in {{{', '.join(INJECT_KINDS)}}}, each "
                         "consumed once.  Infrastructure kinds: dev-loss "
                         "(a rank subset leaves the mesh at step N and "
                         "stays lost until failover: --survivors, "
                         "--dev-loss-mode), preempt (SIGTERM to self), "
                         "slow-host (a --stall-s stall the straggler "
                         "watchdog must flag)")
    ap.add_argument("--stall-s", type=float, default=0.75,
                    help="--inject slow-host stall duration (s)")
    ap.add_argument("--save-timeout", type=float, default=60.0,
                    help="bound (s) on the checkpoint waits of the "
                         "preemption drain and the failover")
    ap.add_argument("--resume-marker", default="on", choices=["on", "off"],
                    help="write a RESUME marker on preemption and consume "
                         "it on the next start; off disables both")
    return ap.parse_args(argv)


def _group_timeout(args: argparse.Namespace) -> datetime.timedelta:
    """The process groups' own timeout: above the step deadline, so that
    the deadline (not NCCL's watchdog) judges a hung collective."""
    return datetime.timedelta(seconds=max(600.0, 2 * args.step_timeout))


def open_mesh(args: argparse.Namespace, group=None, new_group=None):
    """The run's MeshContext (None for ``--mesh smoke``, and for a rank
    past ``--mesh-devices``) and whether this call initialised the default
    process group (the caller then destroys it).  ``group`` (with its
    ``new_group`` factory) is a process group the caller hands the run;
    otherwise the world comes from ``torchrun``'s environment, and a
    plain start is a world of one.  NCCL on CUDA, gloo on the CPU."""
    if args.mesh == "smoke":
        return None, False
    if group is not None:
        if args.mesh != "host":
            raise ValueError(f"--mesh {args.mesh} runs on the default world, "
                             "not on a group handed to train()")
        return mesh_lib.host_context(args.mesh_devices or None, group=group,
                                     new_group=new_group), False
    owned = False
    timeout = _group_timeout(args)
    if not torch.distributed.is_initialized():
        device = resolve_device(args.device)
        if device.type == "cuda" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            torch.distributed.init_process_group(backend, timeout=timeout)
        else:
            torch.distributed.init_process_group(
                backend, store=torch.distributed.HashStore(), rank=0,
                world_size=1, timeout=timeout)
        owned = True
    try:
        if args.mesh == "host":
            return mesh_lib.host_context(
                args.mesh_devices or None,
                new_group=mesh_lib.world_group_factory(timeout)), owned
        return mesh_lib.make_context(multi_pod=args.mesh == "multipod"), \
            owned
    except BaseException:
        if owned:
            torch.distributed.destroy_process_group()
        raise


@dataclass
class Runtime:
    """Host state of the runtime around the step, which outlives a mesh
    rebuild (each attempt of :func:`train` rebuilds everything
    mesh-derived; this carries over): the consumed-once injection table,
    the sentinel and watchdog, the history of every attempt, the
    checkpoint manager with this attempt's descriptor records, target
    spec tree and elastic loader, the preemption flag its signal handler
    sets, and the failover session: the armed device-loss simulator, the
    step deadline, the failover count and events, the previous
    attempt's programs (the re-planning ledger) and whether the next
    attempt restores through a rollback.  The default is a run with no
    injection, no checkpoint and no deadline."""

    injections: dict = field(default_factory=dict)
    sentinel: HealthSentinel = field(default_factory=HealthSentinel)
    watchdog: StragglerWatchdog = field(default_factory=StragglerWatchdog)
    history: list = field(default_factory=list)
    ckpt: CheckpointManager | None = None
    ckpt_extra: dict = field(default_factory=dict)
    shardings: object = None
    loader: Callable | None = None
    checkpoint_every: int = 50
    fail_at_step: int = -1
    stall_s: float = 0.75
    save_timeout: float = 60.0
    resume_marker: bool = True
    preempt: bool = False
    preempt_signum: int | None = None
    dev_loss: SimulatedDeviceLoss = field(default_factory=SimulatedDeviceLoss)
    step_timeout: float = 0.0
    survivors: int = 0
    dev_loss_mode: str = "raise"
    hang_s: float = 30.0
    max_failovers: int = 2
    failovers: int = 0
    failover_events: list = field(default_factory=list)
    prev_programs: list | None = None
    resume_via_rollback: bool = False
    failover_t0: float | None = None

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "Runtime":
        return cls(injections=parse_injections(args.inject),
                   ckpt=(CheckpointManager(args.checkpoint_dir)
                         if args.checkpoint_dir else None),
                   checkpoint_every=args.checkpoint_every,
                   fail_at_step=args.fail_at_step, stall_s=args.stall_s,
                   save_timeout=args.save_timeout,
                   resume_marker=args.resume_marker == "on",
                   step_timeout=args.step_timeout, survivors=args.survivors,
                   dev_loss_mode=args.dev_loss_mode, hang_s=args.hang_s,
                   max_failovers=args.max_failovers)


def _install_preempt_handlers(rt: Runtime):
    """SIGTERM / SIGINT -> the preemption drain.  Handlers install only
    from the main thread; the previous ones are returned for
    :func:`_restore_preempt_handlers`."""
    if threading.current_thread() is not threading.main_thread():
        return None
    prev = {}

    def handler(signum, frame):
        rt.preempt = True
        rt.preempt_signum = signum
        print(f"[train] caught signal {signum} — preemption: finishing "
              "the step under way, saving known-good, exiting cleanly",
              flush=True)

    for sig in (signal.SIGTERM, signal.SIGINT):
        prev[sig] = signal.signal(sig, handler)
    return prev


def _restore_preempt_handlers(prev) -> None:
    for sig, h in (prev or {}).items():
        signal.signal(sig, h)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _deadline(fn, timeout: float, what: str, device=None):
    """Run ``fn`` under a wall-clock deadline.  A step that never returns
    (a hung collective, a dead participant) becomes a
    :class:`MeshLostError` after ``timeout`` seconds; the runner thread
    cannot be cancelled and is abandoned (daemon), as a host gives up on a
    wedged device.  ``timeout <= 0`` runs inline.  On a CUDA ``device`` the
    runner makes it its current device first: the current device is per
    thread, and a fresh thread's is card 0."""
    if not timeout or timeout <= 0:
        return fn()
    box: dict = {}

    def run():
        try:
            if device is not None and device.type == "cuda" \
                    and device.index is not None:
                torch.cuda.set_device(device)
            box["ok"] = fn()
        except BaseException as e:  # re-raised on the caller's thread
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise MeshLostError(
            f"step deadline exceeded ({timeout:.1f}s) during {what} — "
            "device compute or a collective presumed hung")
    if "err" in box:
        raise box["err"]
    return box.get("ok")


def resolve_grad_fused(bundle, grad_fused: bool, accum: int,
                       chatty: bool = True) -> bool:
    """Whether the plain steps take the grad-fused backward.  Not for a
    family whose bundle exposes no taggable matmuls (no ``loss_taps``:
    zamba, xlstm, the encoder-decoder) nor under gradient accumulation: it then says so (when
    ``chatty``) and the plain backward runs, as in the JAX package."""
    if grad_fused and (bundle.loss_taps is None or accum > 1):
        if chatty:
            print("[train] --grad-fused requested but "
                  + ("this model family exposes no taggable matmuls"
                     if bundle.loss_taps is None
                     else "gradient accumulation is on (taps are not "
                          "additive across microbatches)")
                  + " — falling back to the plain backward", flush=True)
        return False
    return grad_fused


def run(cfg, params, batch_at: Callable, *, optimizer, steps: int,
        lr_at: Callable[[int], float], remat: str = "full",
        log_every: int = 10, opt_state=None, grad_fused: bool = False,
        accum: int = 1, start_step: int = 0,
        runtime: Runtime | None = None, mesh=None) -> dict:
    """Warm start from batch 0, then train steps ``start_step`` ..
    ``steps - 1`` on the device the params live on.  ``batch_at(step)``
    returns a validated batch dict of token tensors (moved to the device
    here), or None for a batch to step over; ``batch_at(step, mutate)``
    applies ``mutate`` first (the corrupt-batch injection).
    ``opt_state``, when given, replaces the warm start: a restored
    checkpoint's state (with ``start_step`` its step + 1), or a test's
    hand-over of the JAX package's warm-started state.  ``grad_fused``
    runs the plain steps through the grad-fused backward, unless ``accum``
    > 1 or the model family has no taggable matmuls (the run then says so
    and takes the plain backward, :func:`resolve_grad_fused`).  A dense
    baseline (``adamw``, ``badam``) has no warm
    start and no tracking step.  ``runtime`` carries the injections,
    sentinel, watchdog, checkpoints and the failover session (none by
    default); with its ``step_timeout`` each step runs under
    :func:`_deadline`, and an armed ``dev-loss`` raises
    :class:`MeshLostError` out of the run (at dispatch, or from the
    drain in hang mode).  ``mesh`` (a
    :class:`~repro_torch.distributed.context.MeshContext`, the
    optimizer's by default) runs the step on its ranks together
    (``launch/steps.py``); only its rank 0 prints the step lines.

    Returns the history (the runtime's: one record per step taken, with
    its loss, grad norm, lr, wall time ending in a device sync, and the
    ``quarantined`` and ``theta_clamped`` flags; a rollback's or a
    failover's replayed steps appear again), the warm start's loss and
    time, the final train state, and whether a preemption ended the
    run."""
    rt = runtime if runtime is not None else Runtime()
    device = tree_leaves(params)[0].device
    bundle = build_model(cfg)
    baseline = not isinstance(optimizer.config, LowRankConfig)
    mesh = mesh if mesh is not None else optimizer.mesh
    chatty = mesh is None or mesh.rank == 0
    # dense baselines have no projection to tap
    grad_fused = resolve_grad_fused(bundle, grad_fused and not baseline,
                                    accum, chatty)
    train_step = make_train_step(bundle, optimizer, accum=accum, remat=remat,
                                 grad_fused=grad_fused, mesh=mesh)
    k = getattr(optimizer.config, "update_interval", 0)

    def on_device(batch):
        return {key: v.to(device) for key, v in batch.items()}

    warm_loss = warm_s = None
    if opt_state is None and baseline:
        opt_state = optimizer.init(params)     # no subspace to warm-start
    if opt_state is not None:
        state = TrainState(params=params, opt=opt_state)
        opt_state = None    # hold the starting moments no longer than step 0
    else:
        state = TrainState(params=params, opt=optimizer.init(params))
        warm = make_warm_start(bundle, optimizer, remat=remat)
        t0 = time.perf_counter()
        state, warm_loss = warm(state, on_device(batch_at(0)))
        warm_loss = float(warm_loss)
        _sync(device)
        warm_s = time.perf_counter() - t0
        if chatty:
            print(f"[train] warm-started subspaces from step-0 gradients "
                  f"(loss {warm_loss:.4f}, {warm_s:.2f}s)", flush=True)

    sentinel, ckpt, dev_loss = rt.sentinel, rt.ckpt, rt.dev_loss
    history = rt.history
    pending_refresh = False

    def apply_action(act: str, at_step: int, cur_state):
        """Execute a sentinel verdict: (state, resume step) on rollback,
        None otherwise; raises on abort."""
        nonlocal pending_refresh
        if act in (HealthSentinel.OK, HealthSentinel.SKIP):
            return None
        if act == HealthSentinel.REFRESH:
            pending_refresh = True
            return None
        if act == HealthSentinel.ABORT:
            raise FloatingPointError(
                f"[sentinel] aborting at step {at_step}: escalation "
                f"ladder exhausted after {sentinel.max_rollbacks} "
                "rollbacks")
        res = (ckpt.rollback(cur_state, shardings=rt.shardings,
                             loader=rt.loader)
               if ckpt is not None else None)
        if res is None:
            raise FloatingPointError(
                f"[sentinel] unrecoverable at step {at_step}: rollback "
                "requested but no known-good checkpoint is available")
        tree, ck_step = res
        sentinel.note_rollback(resume_step=ck_step + 1)
        pending_refresh = False
        print(f"[sentinel] rolled back to known-good checkpoint step "
              f"{ck_step}; resuming at {ck_step + 1} with lr x"
              f"{sentinel.lr_backoff} for {sentinel.cooldown} steps",
              flush=True)
        return tree, ck_step + 1

    last_act = HealthSentinel.OK
    step = start_step
    while step < steps:
        if rt.preempt:
            break                                  # the drain below
        if step == rt.fail_at_step:
            if ckpt:
                ckpt.wait()
            raise RuntimeError(f"[failure-injection] simulated node "
                               f"failure at step {step}")
        kind = rt.injections.pop(step, None)       # consumed once
        stall_s = 0.0
        if kind == "ckpt-io-error":
            if ckpt:
                # the next save's first attempts raise OSError; the
                # bounded retry in CheckpointManager.save absorbs them
                ckpt.fail_next_saves(2)
            kind = None
        elif kind == "preempt":
            # self-delivered SIGTERM: the handler sets the flag, this
            # step still runs, the next loop top drains
            print(f"[inject] step {step}: preempt (SIGTERM to self)",
                  flush=True)
            os.kill(os.getpid(), signal.SIGTERM)
            kind = None
        elif kind == "slow-host":
            stall_s = rt.stall_s
            print(f"[inject] step {step}: slow-host (+{stall_s:.2f}s "
                  "stall)", flush=True)
            kind = None
        elif kind == "dev-loss":
            # from this step on the mesh has lost all but the survivors;
            # the simulator stays armed until the failover disarms it
            size = 1 if mesh is None else mesh.size
            members = (list(mesh.members) if mesh is not None
                       and mesh.members else list(range(size)))
            keep = rt.survivors or max(1, size // 2)
            dev_loss.arm(step, members[:keep], mode=rt.dev_loss_mode,
                         hang_s=rt.hang_s)
            if chatty:
                print(f"[inject] step {step}: dev-loss ({size} -> {keep} "
                      f"devices, mode={rt.dev_loss_mode})", flush=True)
            kind = None
        if dev_loss.armed:
            # raise mode surfaces at dispatch, on every rank alike
            dev_loss.check(step, "dispatch")
        if kind == "corrupt-batch":
            print(f"[inject] step {step}: corrupt-batch", flush=True)
            batch, kind = batch_at(step, corrupt_tokens), None
        else:
            batch = batch_at(step)
        if batch is None:
            # a skip-marked batch: one strike, and the step is not taken
            history.append({"step": step, "loss": None,
                            "skipped_batch": True})
            act = sentinel.strike(step, "unusable batch (skip-marked)")
            rb = apply_action(act, step, state)
            if rb is not None:
                state, step = rb
            else:
                step += 1
            continue
        do_update = bool(k) and step > 0 and step % k == 0 and not baseline
        if not baseline and (pending_refresh or kind == "sigma-blowup"):
            if pending_refresh:
                print(f"[sentinel] step {step}: forcing subspace refresh",
                      flush=True)
            do_update = True
        pending_refresh = False
        lr = float(lr_at(step)) * sentinel.lr_scale(step)
        if kind:
            print(f"[inject] step {step}: {kind}", flush=True)

        def step_and_drain():
            out = train_step(
                state, on_device(batch), lr, do_subspace_update=do_update,
                inject=_INJECT_CODES[kind],
                eta_scale=BLOWUP_ETA_SCALE if kind == "sigma-blowup"
                else 1.0)
            if stall_s:
                time.sleep(stall_s)    # host-side only: the watchdog's case
            dev_loss.check(step, "drain")
            _sync(device)
            return out

        t0 = time.perf_counter()
        try:
            # the deadline covers the step's compute, its collectives and
            # the drain: the gate's host read blocks on all of them
            state, metrics = _deadline(step_and_drain, rt.step_timeout,
                                       f"step {step}", device)
        except MeshLostError as e:
            if e.step is None:
                e.step = step
            raise
        dt = time.perf_counter() - t0
        rec = {"step": step, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]), "lr": lr,
               "subspace_update": do_update,
               "quarantined": bool(metrics["quarantined"]),
               "theta_clamped": bool(metrics["theta_clamped"]), "dt": dt}
        history.append(rec)
        rt.watchdog.observe(step, dt)
        if rt.failover_t0 is not None:
            # detection to the end of the first step on the rebuilt mesh
            rt.failover_events[-1]["to_first_step_s"] = \
                time.perf_counter() - rt.failover_t0
            rt.failover_t0 = None
        if chatty and (step % log_every == 0 or step == steps - 1
                       or rec["quarantined"]):
            print(f"[train] step {step:5d}  loss {rec['loss']:8.4f}  lr "
                  f"{lr:.2e}  {dt:6.2f}s"
                  f"{'  [subspace update]' if do_update else ''}"
                  f"{'  [QUARANTINED]' if rec['quarantined'] else ''}",
                  flush=True)
        act = last_act = sentinel.observe(step, rec["loss"],
                                          rec["grad_norm"],
                                          rec["quarantined"])
        rb = apply_action(act, step, state)
        if rb is not None:
            state, step = rb
            continue
        if ckpt and step and step % rt.checkpoint_every == 0:
            # only a step the sentinel passed (on the verdict every rank
            # agreed) is tagged known-good
            ckpt.save(step, state, extra_meta=rt.ckpt_extra,
                      known_good=act == HealthSentinel.OK,
                      shardings=rt.shardings)
        step += 1

    preempted = rt.preempt
    if preempted:
        # the step under way has finished and been judged: a bounded
        # blocking save, the RESUME marker, and out (a hung filesystem
        # must not turn a preemption into a kill)
        save_step = history[-1]["step"] if history \
            else max(start_step - 1, 0)
        if ckpt is not None:
            try:
                ckpt.wait(timeout=rt.save_timeout)
                ckpt.save(save_step, state, extra_meta=rt.ckpt_extra,
                          known_good=last_act == HealthSentinel.OK,
                          shardings=rt.shardings)
                ckpt.wait(timeout=rt.save_timeout)
            except OSError as e:
                print(f"[train] preemption save did not land ({e}) — the "
                      "previous checkpoint is the resume point", flush=True)
            if rt.resume_marker:
                ckpt.write_resume_marker(
                    save_step,
                    reason=f"preempted (signal {rt.preempt_signum})")
        print(f"[train] preemption drain complete at step {save_step} — "
              "exiting cleanly for restart", flush=True)
    elif ckpt:
        ckpt.save(steps - 1, state, blocking=True, extra_meta=rt.ckpt_extra,
                  known_good=last_act == HealthSentinel.OK,
                  shardings=rt.shardings)
    return {"history": history, "warm_loss": warm_loss,
            "warm_start_s": warm_s, "state": state, "preempted": preempted}


def prepare(args: argparse.Namespace, mesh=None, params=None):
    """The CLI's run from its parsed flags: (config, rank, optimizer,
    batch_at, device); ``batch_at(step, mutate=None)`` validates each
    batch on the host and returns None for one to step over.  Under a
    ``mesh`` the low-rank optimizer is built on it, with the hot-path
    layout ``--hotpath-layout`` picks for ``params`` (whole, as every
    rank holds them)."""
    if (args.mesh != "smoke") != (mesh is not None):
        raise ValueError(f"--mesh {args.mesh} runs on the MeshContext "
                         f"open_mesh builds; got {mesh}")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    rank = args.rank or PAPER_RANKS.get(args.arch, default_rank(cfg.d_model))
    baseline = args.optimizer in ("adamw", "badam")
    layout = None
    if not baseline:
        opt_kw = dict(rank=rank, update_interval=args.update_interval,
                      eta=args.eta, weight_decay=args.weight_decay,
                      use_kernels=args.use_kernels)
        if mesh is not None:
            # every rank shares rank 0's warm start; the sharded layout
            # needs the kernels (the JAX driver's rule)
            opt_kw.update(mesh=mesh)
            if args.use_kernels and mesh.size > 1 \
                    and args.hotpath_layout != "off":
                layout = args.hotpath_layout
                regimes = (("column", "row") if layout == "auto"
                           else (layout,))
                row_state = ("reduce-scatter" if layout == "row-rs"
                             else "auto")
                if layout == "row-rs":
                    opt_kw.update(row_state=row_state)
                opt_kw.update(param_specs=sharding.hotpath_param_specs(
                    params, mesh, rank, regimes=regimes,
                    row_state=row_state))
    else:
        opt_kw = ({"weight_decay": args.weight_decay}
                  if args.weight_decay else {})
    optimizer = get_optimizer(args.optimizer, **opt_kw)
    if args.use_kernels and not baseline and (mesh is None
                                              or mesh.rank == 0):
        where = (f"sharded over {mesh.size} ranks, layout {layout}"
                 if layout else "replicated")
        print(f"[train] optimizer hot path: fused kernels [{where}] "
              "(project_colnorms -> adam_lowrank_norms -> fused_update)",
              flush=True)
    if args.grad_fused and not baseline and args.accum == 1 \
            and build_model(cfg).loss_taps is not None \
            and (mesh is None or mesh.rank == 0):
        print("[train] grad-fused backward: taggable leaves emit "
              "[A; colnorms] from the weight-gradient epilogue; plain "
              "optimizer steps skip their projection read of G", flush=True)
    data = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))

    def batch_at(step: int, mutate=None):
        if step == 0 and mutate is None:
            batch = batch_for_model(cfg, None, data, 0)
            validate_batch(batch, cfg.vocab_size)
            return batch
        batch, ok = fetch_batch(cfg, data, step, mutate=mutate)
        return batch if ok else None

    return cfg, rank, optimizer, batch_at, device


def _restore(args, rt: Runtime, mesh, optimizer, params):
    """Set up this attempt's checkpoints on ``mesh`` (the descriptor
    records every save embeds, the target spec tree and the elastic
    loader restores and rollbacks use, the re-planning ledger) and restore:
    after a failover the newest known-good step through a rollback, else
    the newest checkpoint unless ``--resume off``.  (params, opt_state,
    start step), the opt_state None when nothing was restored."""
    like = TrainState(params=params, opt=optimizer.init(params))
    descs = checkpoint_descriptors(params, optimizer)
    ckpt = rt.ckpt
    ckpt.mesh = mesh
    rt.ckpt_extra = ckpt_transpose.state_program_records(like, descs)
    rt.shardings = train_state_shardings(
        like, descs, mesh if optimizer.param_specs is not None else None)
    rt.loader = ckpt_transpose.elastic_loader(descs, mesh)
    chatty = mesh is None or mesh.rank == 0
    # the re-planning ledger: after a failover the descriptors were
    # rebuilt on the smaller mesh; diff them against the lost mesh's
    progs = [(d.regime, int(d.shards), d.state_layout, int(d.rank))
             for d in ckpt_transpose.descriptor_leaves(descs)
             if d.kind == "lowrank"]
    size = 1 if mesh is None else mesh.size
    if rt.resume_via_rollback and rt.prev_programs is not None:
        changed = sum(1 for a, b in zip(rt.prev_programs, progs) if a != b)
        if rt.failover_events:
            rt.failover_events[-1]["program_changes"] = changed
        if chatty:
            print(f"[failover] re-planned StepPrograms on the {size}-device "
                  f"mesh: {changed} of {len(progs)} low-rank leaves changed "
                  "regime/group/state-layout", flush=True)
    rt.prev_programs = progs
    if rt.resume_marker and ckpt.writer:
        marker = ckpt.consume_resume_marker()
        if marker:
            print(f"[train] resume marker found (step {marker.get('step')}, "
                  f"{marker.get('reason')}) — auto-resuming", flush=True)
    if rt.resume_via_rollback:
        # the newest known-good step, transposed onto the re-planned
        # programs and kept as this rank's shards of the new mesh
        t0 = time.perf_counter()
        res = ckpt.rollback(like, shardings=rt.shardings, loader=rt.loader)
        if res is None:
            raise RuntimeError("[failover] unrecoverable: mesh lost but no "
                               "known-good checkpoint restores onto the "
                               "degraded mesh")
        (params, opt_state), ck_step = res
        rt.resume_via_rollback = False
        if rt.failover_events:
            rt.failover_events[-1].update(
                restored_step=ck_step, resume_step=ck_step + 1,
                restore_s=time.perf_counter() - t0)
        if chatty:
            print(f"[failover] restored known-good step {ck_step} onto "
                  f"{size} devices; resuming at step {ck_step + 1}",
                  flush=True)
        return params, opt_state, ck_step + 1
    restored = None
    if args.resume != "off":
        restored = ckpt.restore(
            like, shardings=rt.shardings,
            loader=rt.loader if args.resume == "elastic" else None)
    if restored is None:
        return params, None, 0
    (params, opt_state), ck_step = restored
    if chatty:
        print(f"[train] resumed from checkpoint step {ck_step} "
              f"({args.resume} restore); no warm start", flush=True)
    return params, opt_state, ck_step + 1


def _failover(args, rt: Runtime, mesh, err: MeshLostError):
    """Handle a MESH_LOST verdict on this rank: record it, abort the old
    group, pick the survivors and rebuild the mesh over them, and flag the
    next attempt to elastic-restore the newest known-good checkpoint onto
    the re-planned programs.  Returns the new mesh (None on the one-rank
    smoke mesh) and whether this rank is among the survivors.  Re-raises
    when failover cannot help (no checkpoint dir, budget exhausted)."""
    t0 = time.perf_counter()
    step = err.step if err.step is not None else \
        (rt.history[-1]["step"] if rt.history else -1)
    rt.sentinel.mesh_lost(step, str(err))
    rt.failovers += 1
    if rt.ckpt is None:
        raise MeshLostError("mesh lost with no --checkpoint-dir: nothing to "
                            "fail over from") from err
    if rt.failovers > rt.max_failovers:
        raise MeshLostError(f"mesh lost again after {rt.max_failovers} "
                            "failover(s) — giving up") from err
    if mesh is not None and mesh.pg is None:
        raise MeshLostError("mesh lost on a mesh with no group to rebuild "
                            "from (the production meshes)") from err
    # absorb an in-flight save (bounded: a hung filesystem must not hang
    # the failover too); the rollback targets steps that landed
    try:
        rt.ckpt.wait(timeout=rt.save_timeout)
    except OSError as e:
        print(f"[failover] pending checkpoint save abandoned ({e})",
              flush=True)
    size = 1 if mesh is None else mesh.size
    members = (list(mesh.members) if mesh is not None and mesh.members
               else list(range(size)))
    survivors = err.survivors or members[:rt.survivors or max(1, size // 2)]
    rt.dev_loss.disarm()        # the lost ranks are out of the mesh
    rt.resume_via_rollback = True
    fresh = StragglerWatchdog()  # new topology, new timing statistics
    fresh.flagged = rt.watchdog.flagged
    rt.watchdog = fresh
    event = {"step": step, "from_devices": size,
             "to_devices": len(survivors)}
    rt.failover_events.append(event)
    new = None
    if mesh is not None and mesh.pg is not None:
        # work queued on the old group (an abandoned step, a hung
        # collective) must not block the new one
        event["aborted"] = mesh_lib.abort_group(mesh.pg)
        new = mesh_lib.degraded_context(survivors, mesh)
        if new is None:
            return None, False
        event["rebuilt_group"] = new.pg.name()
    rt.failover_t0 = t0
    if mesh is None or mesh.rank == 0:
        print(f"[failover] rebuilding mesh {size} -> {len(survivors)} "
              "devices; re-planning StepPrograms and elastic-restoring the "
              "newest known-good checkpoint", flush=True)
    return new, True


def _run(args, mesh, rt: Runtime) -> dict:
    """One attempt of the run on ``mesh``: everything mesh-derived (the
    parameters from ``--seed``, the optimizer and its programs, the
    checkpoint layout) built afresh, the restore, the steps, and the
    summary."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(args.seed))
    cfg, rank, optimizer, batch_at, device = prepare(args, mesh, params)
    opt_state, start_step = None, 0
    if rt.ckpt is not None:
        params, opt_state, start_step = _restore(args, rt, mesh, optimizer,
                                                 params)
    ops.reset_launch_counts()
    out = run(cfg, params, batch_at, optimizer=optimizer, steps=args.steps,
              lr_at=cosine_with_warmup(args.lr, args.steps, args.warmup),
              remat=args.remat, log_every=args.log_every,
              opt_state=opt_state, grad_fused=args.grad_fused,
              accum=args.accum, start_step=start_step, runtime=rt, mesh=mesh)
    history = out["history"]
    taken = [h for h in history if h["loss"] is not None]
    return {
        "arch": cfg.name, "optimizer": args.optimizer, "rank": rank,
        "grad_fused": args.grad_fused, "accum": args.accum,
        "remat": args.remat,
        "steps": args.steps, "start_step": start_step,
        "device": str(device),
        "tokens_per_step": args.batch * args.seq,
        "final_loss": taken[-1]["loss"] if taken else None,
        "losses": [h["loss"] for h in history],
        "step_s": [h.get("dt") for h in history],
        "warm_start_s": out["warm_start_s"], "warm_loss": out["warm_loss"],
        "state_bytes": optimizer.state_bytes(out["state"].params),
        "launch_counts": ops.launch_counts(),
        "skipped_batches": [h["step"] for h in history
                            if h.get("skipped_batch")],
        "quarantined_steps": rt.sentinel.quarantined_steps,
        "rollbacks": rt.sentinel.rollbacks,
        "sentinel_events": rt.sentinel.events,
        "stragglers": rt.watchdog.flagged,
        "preempted": out["preempted"],
        "failovers": rt.failovers,
        "failover_events": rt.failover_events,
        "mesh_devices": 1 if mesh is None else mesh.size,
        "lost": False, "in_mesh": True,
        "history": history,
        "state": out["state"],
    }


def _left_summary(args, rt: Runtime, lost: bool) -> dict:
    """The summary of a rank that is not in the mesh: lost in a failover
    (``lost``), or past ``--mesh-devices`` from the start."""
    return {"arch": args.arch, "optimizer": args.optimizer,
            "steps": args.steps, "lost": lost, "in_mesh": False,
            "final_loss": None, "preempted": False,
            "failovers": rt.failovers, "failover_events": rt.failover_events,
            "sentinel_events": rt.sentinel.events, "history": rt.history,
            "mesh_devices": (rt.failover_events[-1]["to_devices"]
                             if lost else args.mesh_devices)}


def train(argv=None, *, group=None, new_group=None) -> dict:
    """The CLI: returns the run's summary (loss history, step times,
    warm-start time, kernel launch counts of the last attempt, the
    runtime's quarantines, rollbacks, failovers, events and stragglers,
    the mesh's size) and, under ``state``, the final train state (not
    written to ``--metrics-out``).  ``group`` runs it on a process group
    the caller hands it, ``new_group`` the factory its failovers rebuild
    with (``launch/mesh.py``).  A rank that leaves the mesh (lost in a
    failover, or past ``--mesh-devices``) returns a summary with
    ``in_mesh`` False and ``lost`` saying which."""
    args = _parse_args(argv)
    mesh, owned = open_mesh(args, group, new_group)
    rt = Runtime.from_args(args)
    t_start = time.time()
    prev_handlers = _install_preempt_handlers(rt)
    try:
        if args.mesh != "smoke" and mesh is None:
            return _left_summary(args, rt, lost=False)
        while True:
            try:
                summary = _run(args, mesh, rt)
                break
            except MeshLostError as e:
                mesh, alive = _failover(args, rt, mesh, e)
            except torch.distributed.DistBackendError as e:
                # a real raising collective or a dead backend: the same
                # MESH_LOST door, bounded by the same budget
                mesh, alive = _failover(args, rt, mesh, MeshLostError(
                    f"runtime error treated as mesh loss: {e}"))
            if not alive:
                return _left_summary(args, rt, lost=True)
    finally:
        _restore_preempt_handlers(prev_handlers)
        if owned:
            torch.distributed.destroy_process_group()
    summary["wall_time_s"] = time.time() - t_start
    if mesh is not None and mesh.rank != 0:
        return summary                             # rank 0 reports
    if args.metrics_out:
        Path(args.metrics_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.metrics_out).write_text(json.dumps(
            {k: v for k, v in summary.items() if k != "state"}, indent=2))
    if not summary["preempted"]:
        print(f"[train] done: {args.steps} steps, final loss "
              f"{summary['final_loss']}", flush=True)
    return summary


if __name__ == "__main__":
    train()
