"""Training driver: SubTrack++ on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama-7b --optimizer subtrack --use-kernels [--grad-fused] \\
        --steps 4 --update-interval 2 --warmup 2 --batch 2 --seq 512

Counterpart of ``repro.launch.train`` on one device: the warm start
installs every subspace from the step-0 gradients (Alg. 1 line 1), then
each step runs the plain or the tracking train step, with the JAX
package's rule ``do_update = k and step > 0 and step % k == 0``.  With
``--use-kernels`` the optimizer runs the fused hot path through the
hand-written CUDA kernels (``repro_torch.kernels.ops``).  With
``--grad-fused`` the plain steps take the grad-fused backward: every
taggable matmul forms its weight gradient through the ``grad_tap`` kernel,
which also emits the [A; colnorms] panel that the clip and the
optimizer's plain step consume in place of a projection pass.  Weights are
random, drawn from ``--seed``; batches come from the synthetic Zipf +
Markov stream and are validated on the host before any embedding lookup.

``--accum N`` splits each batch into N microbatches whose gradients add
into an fp32 accumulator (the grad-fused backward then falls back to the
plain one, as in the JAX driver); ``--remat dots`` keeps each layer's
projection outputs and recomputes the rest.  The dense baselines
``--optimizer adamw`` and ``badam`` have no subspace: no warm start, no
tracking step, no kernel.

The driver runs on CUDA unless ``--device cpu`` asks for the CPU; with no
card and no such request it raises.  Not ported yet, and raising:
``--mesh`` other than the one-device default, ``--checkpoint-dir`` and
``--inject`` (with the health sentinel and checkpoints of later slices).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable

import torch

from repro_torch.configs.registry import PAPER_RANKS, get_config
from repro_torch.core.api import get_optimizer
from repro_torch.core.subtrack import LowRankConfig, tree_leaves
from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                       batch_for_model, fetch_batch,
                                       validate_batch)
from repro_torch.kernels import ops
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import (TrainState, default_rank,
                                      make_train_step, make_warm_start)
from repro_torch.models.api import build_model
from repro_torch.optim.schedules import cosine_with_warmup


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
    # flags of the JAX driver whose machinery is not ported yet
    ap.add_argument("--mesh", default="smoke")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--inject", default="")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-fused", action="store_true",
                    help="plain steps take the grad-fused backward")
    return ap.parse_args(argv)


def _reject_unported(args: argparse.Namespace) -> None:
    unported = {"--mesh": args.mesh != "smoke",
                "--checkpoint-dir": bool(args.checkpoint_dir),
                "--inject": bool(args.inject)}
    for flag, given in unported.items():
        if given:
            raise NotImplementedError(f"{flag} is not yet ported to "
                                      "repro_torch.launch.train")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, params, batch_at: Callable[[int], dict | None], *, optimizer,
        steps: int, lr_at: Callable[[int], float], remat: str = "full",
        log_every: int = 10, opt_state=None, grad_fused: bool = False,
        accum: int = 1) -> dict:
    """Warm start from batch 0, then ``steps`` train steps on the device
    the params live on (updated in place).  ``batch_at(step)`` returns a
    validated batch dict of token tensors (moved to the device here), or
    None for a batch to step over.  ``opt_state``, when given, replaces
    the warm start (a test hands over the JAX package's warm-started
    state, whose SVD signs the port's need not share).  ``grad_fused``
    runs the plain steps through the grad-fused backward, unless ``accum``
    > 1 splits each batch into microbatches (the driver then says so and
    takes the plain backward, as the JAX driver does).  A dense baseline
    (``adamw``, ``badam``) has no warm start and no tracking step.
    Returns the loss history, per-step wall times (each ends in a device
    sync), the warm-start time and the final train state."""
    device = tree_leaves(params)[0].device
    bundle = build_model(cfg)
    baseline = not isinstance(optimizer.config, LowRankConfig)
    if baseline:
        grad_fused = False  # dense baselines have no projection to tap
    if grad_fused and accum > 1:
        print("[train] --grad-fused requested but gradient accumulation is "
              "on (taps are not additive across microbatches) — falling "
              "back to the plain backward", flush=True)
        grad_fused = False
    train_step = make_train_step(bundle, optimizer, accum=accum, remat=remat,
                                 grad_fused=grad_fused)
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
        print(f"[train] warm-started subspaces from step-0 gradients (loss "
              f"{warm_loss:.4f}, {warm_s:.2f}s)", flush=True)

    history: list[dict] = []
    for step in range(steps):
        batch = batch_at(step)
        if batch is None:
            history.append({"step": step, "loss": None,
                            "skipped_batch": True})
            continue
        batch = on_device(batch)
        do_update = bool(k) and step > 0 and step % k == 0
        lr = float(lr_at(step))
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, lr,
                                    do_subspace_update=do_update)
        loss = float(metrics["loss"])
        grad_norm = float(metrics["grad_norm"])
        _sync(device)
        dt = time.perf_counter() - t0
        history.append({"step": step, "loss": loss, "grad_norm": grad_norm,
                        "lr": lr, "subspace_update": do_update, "dt": dt})
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d}  loss {loss:8.4f}  lr {lr:.2e}  "
                  f"{dt:6.2f}s{'  [subspace update]' if do_update else ''}",
                  flush=True)
    return {"history": history, "warm_loss": warm_loss,
            "warm_start_s": warm_s, "state": state}


def prepare(args: argparse.Namespace):
    """The CLI's run from its parsed flags: (config, rank, optimizer,
    batch_at, device); ``batch_at(step)`` validates each batch on the host
    and returns None for one to step over."""
    _reject_unported(args)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    rank = args.rank or PAPER_RANKS.get(args.arch, default_rank(cfg.d_model))
    baseline = args.optimizer in ("adamw", "badam")
    if not baseline:
        opt_kw = dict(rank=rank, update_interval=args.update_interval,
                      eta=args.eta, weight_decay=args.weight_decay,
                      use_kernels=args.use_kernels)
    else:
        opt_kw = ({"weight_decay": args.weight_decay}
                  if args.weight_decay else {})
    optimizer = get_optimizer(args.optimizer, **opt_kw)
    if args.use_kernels and not baseline:
        print("[train] optimizer hot path: fused kernels (project_colnorms "
              "-> adam_lowrank_norms -> fused_update)", flush=True)
    if args.grad_fused and not baseline and args.accum == 1:
        print("[train] grad-fused backward: taggable leaves emit "
              "[A; colnorms] from the weight-gradient epilogue; plain "
              "optimizer steps skip their projection read of G", flush=True)
    data = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))

    def batch_at(step: int):
        if step == 0:
            batch = batch_for_model(cfg, None, data, 0)
            validate_batch(batch, cfg.vocab_size)
            return batch
        batch, ok = fetch_batch(cfg, data, step)
        return batch if ok else None

    return cfg, rank, optimizer, batch_at, device


def train(argv=None) -> dict:
    """The CLI: returns the run's summary (loss history, step times,
    warm-start time, kernel launch counts) and, under ``state``, the final
    train state (not written to ``--metrics-out``)."""
    args = _parse_args(argv)
    cfg, rank, optimizer, batch_at, device = prepare(args)
    t_start = time.time()
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(args.seed))
    ops.reset_launch_counts()
    out = run(cfg, params, batch_at, optimizer=optimizer, steps=args.steps,
              lr_at=cosine_with_warmup(args.lr, args.steps, args.warmup),
              remat=args.remat, log_every=args.log_every,
              grad_fused=args.grad_fused, accum=args.accum)
    launches = ops.launch_counts()
    history = out["history"]
    taken = [h for h in history if h["loss"] is not None]
    summary = {
        "arch": cfg.name, "optimizer": args.optimizer, "rank": rank,
        "grad_fused": args.grad_fused, "accum": args.accum,
        "remat": args.remat,
        "steps": args.steps, "device": str(device),
        "tokens_per_step": args.batch * args.seq,
        "final_loss": taken[-1]["loss"] if taken else None,
        "losses": [h["loss"] for h in history],
        "step_s": [h.get("dt") for h in history],
        "warm_start_s": out["warm_start_s"], "warm_loss": out["warm_loss"],
        "wall_time_s": time.time() - t_start,
        "state_bytes": optimizer.state_bytes(params),
        "launch_counts": launches,
        "skipped_batches": [h["step"] for h in history
                            if h.get("skipped_batch")],
        "history": history,
    }
    if args.metrics_out:
        Path(args.metrics_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.metrics_out).write_text(json.dumps(summary, indent=2))
    print(f"[train] done: {args.steps} steps, final loss "
          f"{summary['final_loss']}", flush=True)
    return dict(summary, state=out["state"])


if __name__ == "__main__":
    train()
