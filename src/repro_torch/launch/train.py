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
  preempt and slow-host; ``--fail-at-step`` raises mid-run.

Unlike the JAX driver's loop, which drains step t's metrics after
dispatching step t + 1, this loop is synchronous: each step is drained
(one device sync) before the next starts, so the sentinel acts on the
step it judged.  Where the JAX driver rolls back it discards the step it
had already dispatched, and with it any injection of that step; here
that step was never run, so its injection fires on the replay.

``--mesh host`` runs the (1, N) mesh over every rank ``torchrun``
started (``--mesh-devices`` 0 or N), each rank on its own card: the
process group is NCCL on CUDA and gloo when ``--device cpu`` asks for the
CPU (a plain ``python -m`` start is a world of one).  Every rank takes
the same batch and runs the forward and backward whole; with
``--use-kernels`` each low-rank leaf's optimizer step runs the
StepProgram of its ``--hotpath-layout`` (auto, column, row, row-rs, or
off for none) on this rank's shards, and the step gathers the updates
(``launch/steps.py``).  Only rank 0 prints the step lines.

The driver runs on CUDA unless ``--device cpu`` asks for the CPU; with no
card and no such request it raises.  Not ported yet, and raising with
what they wait for: ``--inject dev-loss`` and ``--step-timeout`` (mesh
failover), ``--checkpoint-dir`` on a mesh of more than one rank (the
sharded restore), and ``--mesh prod`` / ``multipod`` on a world of
other than 256 / 512 ranks.
"""

from __future__ import annotations

import argparse
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
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import (TrainState, checkpoint_descriptors,
                                      default_rank, make_train_step,
                                      make_warm_start)
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
    ``max_rollbacks`` rollbacks abort the run.  (The JAX driver's
    mesh-lost verdict waits for failover.)"""

    OK, SKIP, REFRESH, ROLLBACK, ABORT = \
        "ok", "skip", "refresh", "rollback", "abort"

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
                    help="with --mesh host: 0 or the world size (a mesh "
                         "over part of the world waits for failover)")
    ap.add_argument("--hotpath-layout", default="auto",
                    choices=["auto", "column", "row", "row-rs", "off"],
                    help="the sharded optimizer layout under a mesh: auto "
                         "picks column or row per leaf by the modeled "
                         "per-rank bytes (repro_torch.kernels.traffic); "
                         "column / row restrict to one regime (row still "
                         "picks its state flavour); row-rs forces the "
                         "reduce-scatter flavour; off keeps every leaf "
                         "replicated")
    ap.add_argument("--step-timeout", type=float, default=0.0,
                    help="a deadline (s) on each step (not yet ported: "
                         "it waits for mesh failover; 0 = off)")
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
                         "consumed once (dev-loss is not ported yet)")
    ap.add_argument("--stall-s", type=float, default=0.75,
                    help="--inject slow-host stall duration (s)")
    ap.add_argument("--save-timeout", type=float, default=60.0,
                    help="bound (s) on the checkpoint waits of the "
                         "preemption drain")
    ap.add_argument("--resume-marker", default="on", choices=["on", "off"],
                    help="write a RESUME marker on preemption and consume "
                         "it on the next start; off disables both")
    return ap.parse_args(argv)


def _reject_unported(args: argparse.Namespace, mesh=None) -> None:
    if args.step_timeout:
        raise NotImplementedError("--step-timeout is not yet ported to "
                                  "repro_torch.launch.train (it waits for "
                                  "mesh failover)")
    if args.checkpoint_dir and mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            "--checkpoint-dir on a mesh of more than one rank is not yet "
            "ported to repro_torch.launch.train (it waits for the sharded "
            "restore, restore_targets)")


def open_mesh(args: argparse.Namespace):
    """The run's MeshContext (None for ``--mesh smoke``) and whether this
    call initialised the default process group (the caller then destroys
    it).  Under ``torchrun`` the world comes from its environment; a
    plain start is a world of one.  NCCL on CUDA, gloo on the CPU."""
    from repro_torch.launch import mesh as mesh_lib

    if args.mesh == "smoke":
        return None, False
    owned = False
    if not torch.distributed.is_initialized():
        device = resolve_device(args.device)
        if device.type == "cuda" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            torch.distributed.init_process_group(backend)
        else:
            torch.distributed.init_process_group(
                backend, store=torch.distributed.HashStore(), rank=0,
                world_size=1)
        owned = True
    try:
        if args.mesh == "host":
            return mesh_lib.host_context(args.mesh_devices or None), owned
        return mesh_lib.make_context(multi_pod=args.mesh == "multipod"), \
            owned
    except BaseException:
        if owned:
            torch.distributed.destroy_process_group()
        raise


@dataclass
class Runtime:
    """Host state of the runtime around the step: the consumed-once
    injection table, the sentinel and watchdog, the checkpoint manager
    with this run's descriptor records and elastic loader, and the
    preemption flag its signal handler sets.  The default is a run with
    no injection and no checkpoint."""

    injections: dict = field(default_factory=dict)
    sentinel: HealthSentinel = field(default_factory=HealthSentinel)
    watchdog: StragglerWatchdog = field(default_factory=StragglerWatchdog)
    ckpt: CheckpointManager | None = None
    ckpt_extra: dict = field(default_factory=dict)
    loader: Callable | None = None
    checkpoint_every: int = 50
    fail_at_step: int = -1
    stall_s: float = 0.75
    save_timeout: float = 60.0
    resume_marker: bool = True
    preempt: bool = False
    preempt_signum: int | None = None

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "Runtime":
        injections = parse_injections(args.inject)
        if "dev-loss" in injections.values():
            raise NotImplementedError(
                "--inject dev-loss is not yet ported to "
                "repro_torch.launch.train (mesh failover)")
        return cls(injections=injections,
                   ckpt=(CheckpointManager(args.checkpoint_dir)
                         if args.checkpoint_dir else None),
                   checkpoint_every=args.checkpoint_every,
                   fail_at_step=args.fail_at_step, stall_s=args.stall_s,
                   save_timeout=args.save_timeout,
                   resume_marker=args.resume_marker == "on")


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
    sentinel, watchdog and checkpoints (none by default).  ``mesh`` (a
    :class:`~repro_torch.distributed.context.MeshContext`, the
    optimizer's by default) runs the step on its ranks together
    (``launch/steps.py``); only its rank 0 prints the step lines.

    Returns the history (one record per step taken, with its loss, grad
    norm, lr, wall time ending in a device sync, and the ``quarantined``
    and ``theta_clamped`` flags; a rollback's replayed steps appear
    again), the warm start's loss and time, the final train state, and
    whether a preemption ended the run."""
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

    sentinel, ckpt = rt.sentinel, rt.ckpt
    history: list[dict] = []
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
        res = (ckpt.rollback(cur_state, loader=rt.loader)
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
        t0 = time.perf_counter()
        state, metrics = train_step(
            state, on_device(batch), lr, do_subspace_update=do_update,
            inject=_INJECT_CODES[kind],
            eta_scale=BLOWUP_ETA_SCALE if kind == "sigma-blowup" else 1.0)
        if stall_s:
            time.sleep(stall_s)    # host-side only: the watchdog's case
        _sync(device)
        dt = time.perf_counter() - t0
        rec = {"step": step, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]), "lr": lr,
               "subspace_update": do_update,
               "quarantined": bool(metrics["quarantined"]),
               "theta_clamped": bool(metrics["theta_clamped"]), "dt": dt}
        history.append(rec)
        rt.watchdog.observe(step, dt)
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
            # only a step the sentinel passed is tagged known-good
            ckpt.save(step, state, extra_meta=rt.ckpt_extra,
                      known_good=act == HealthSentinel.OK)
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
                          known_good=last_act == HealthSentinel.OK)
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
                  known_good=last_act == HealthSentinel.OK)
    return {"history": history, "warm_loss": warm_loss,
            "warm_start_s": warm_s, "state": state, "preempted": preempted}


def prepare(args: argparse.Namespace, mesh=None, params=None):
    """The CLI's run from its parsed flags: (config, rank, optimizer,
    batch_at, device); ``batch_at(step, mutate=None)`` validates each
    batch on the host and returns None for one to step over.  Under a
    ``mesh`` the low-rank optimizer is built on it, with the hot-path
    layout ``--hotpath-layout`` picks for ``params`` (whole, as every
    rank holds them)."""
    _reject_unported(args, mesh)
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


def _resume(args, rt: Runtime, optimizer, params):
    """Set up the run's checkpoints (the descriptor records every save
    embeds, the elastic loader rollbacks use) and restore the newest
    checkpoint unless ``--resume off``: (params, opt_state, start step),
    the opt_state None when nothing was restored."""
    like = TrainState(params=params, opt=optimizer.init(params))
    descs = checkpoint_descriptors(params, optimizer)
    rt.ckpt_extra = ckpt_transpose.state_program_records(like, descs)
    rt.loader = ckpt_transpose.elastic_loader(descs)
    if rt.resume_marker:
        marker = rt.ckpt.consume_resume_marker()
        if marker:
            print(f"[train] resume marker found (step {marker.get('step')}, "
                  f"{marker.get('reason')}) — auto-resuming", flush=True)
    restored = None
    if args.resume != "off":
        restored = rt.ckpt.restore(
            like, loader=rt.loader if args.resume == "elastic" else None)
    if restored is None:
        return params, None, 0
    (params, opt_state), ck_step = restored
    print(f"[train] resumed from checkpoint step {ck_step} ({args.resume} "
          "restore); no warm start", flush=True)
    return params, opt_state, ck_step + 1


def train(argv=None) -> dict:
    """The CLI: returns the run's summary (loss history, step times,
    warm-start time, kernel launch counts, the runtime's quarantines,
    rollbacks, events and stragglers) and, under ``state``, the final
    train state (not written to ``--metrics-out``)."""
    args = _parse_args(argv)
    _reject_unported(args)
    mesh, owned = open_mesh(args)
    try:
        device = resolve_device(args.device)
        cfg = get_config(args.arch, smoke=args.smoke)
        params = build_model(cfg).init(
            torch.Generator(device=device).manual_seed(args.seed))
        cfg, rank, optimizer, batch_at, device = prepare(args, mesh, params)
        rt = Runtime.from_args(args)
        t_start = time.time()
        prev_handlers = _install_preempt_handlers(rt)
        try:
            opt_state, start_step = None, 0
            if rt.ckpt is not None:
                params, opt_state, start_step = _resume(args, rt, optimizer,
                                                        params)
            ops.reset_launch_counts()
            out = run(cfg, params, batch_at, optimizer=optimizer,
                      steps=args.steps,
                      lr_at=cosine_with_warmup(args.lr, args.steps,
                                               args.warmup),
                      remat=args.remat, log_every=args.log_every,
                      opt_state=opt_state, grad_fused=args.grad_fused,
                      accum=args.accum, start_step=start_step, runtime=rt,
                      mesh=mesh)
        finally:
            _restore_preempt_handlers(prev_handlers)
    finally:
        if owned:
            torch.distributed.destroy_process_group()
    launches = ops.launch_counts()
    history = out["history"]
    taken = [h for h in history if h["loss"] is not None]
    summary = {
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
        "wall_time_s": time.time() - t_start,
        "state_bytes": optimizer.state_bytes(out["state"].params),
        "launch_counts": launches,
        "skipped_batches": [h["step"] for h in history
                            if h.get("skipped_batch")],
        "quarantined_steps": rt.sentinel.quarantined_steps,
        "rollbacks": rt.sentinel.rollbacks,
        "sentinel_events": rt.sentinel.events,
        "stragglers": rt.watchdog.flagged,
        "preempted": out["preempted"],
        "history": history,
    }
    if mesh is not None and mesh.rank != 0:
        return dict(summary, state=out["state"])     # rank 0 reports
    if args.metrics_out:
        Path(args.metrics_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.metrics_out).write_text(json.dumps(summary, indent=2))
    if not out["preempted"]:
        print(f"[train] done: {args.steps} steps, final loss "
              f"{summary['final_loss']}", flush=True)
    return dict(summary, state=out["state"])


if __name__ == "__main__":
    train()
