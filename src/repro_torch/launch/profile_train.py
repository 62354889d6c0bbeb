"""Where a training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        --arch llama-1b --optimizer subtrack --use-kernels \\
        --update-interval 2 --batch 4 --seq 512

Takes the training CLI's flags (:mod:`repro_torch.launch.train`), warm-
starts the subspaces, runs one plain and one tracking step to warm up, then
runs one of each again under ``torch.profiler`` recording device activity
only.  Prints one JSON object per profiled step: the step's wall time (host
clock around a step that ends in a device sync), the summed duration of
its device activity (one stream: the sum is the time the card was busy),
the busy and idle shares, the device time of the port's own kernels (by
CUDA function name) and of the rest, and the top kernels by name.  Then
one plain and one tracking step more under a profiler that also records
host activity, for the health gate alone (``steps.GATE_RANGE``: the
update-norm pass and the report's one host read): its device time and
its top kernels by name, its host time (which includes the wait for the
device to finish the optimizer), and the stall the read leaves on the
card (from the end of the report's device-to-host copy to the next device
activity, the first apply), added to the same JSON objects as
``gate_device_s``, ``gate_top_kernels_s``, ``gate_host_s`` and
``gate_stall_s``.  Each object also carries its steps' losses and
whether the health gate quarantined them (``quarantined``,
``gate_quarantined``): a quarantined step applies nothing, so its stall
is None, as it is where the trace holds no device activity inside the
gate's host range or after it.  Needs a CUDA device; raises if the
profiler saw no device activity.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch.steps import GATE_RANGE, make_train_step
from repro_torch.launch.train import (_parse_args, prepare,
                                      resolve_grad_fused, run)
from repro_torch.models.api import build_model

# CUDA function names of the port's optimizer kernels (csrc/*.cu)
PORT_KERNELS = ("project_kernel", "project_wgmma_kernel", "split_bf16_kernel",
                "tangent_kernel", "tangent_wgmma_kernel", "gram_wgmma_kernel",
                "front_kernel", "front_wgmma_kernel", "stw_wgmma_kernel",
                "front_t_wgmma_kernel", "backproject_wgmma_kernel",
                "ttg_kernel", "tangent_gram_wgmma_kernel", "adam_norms_kernel",
                "fused_update_wgmma_kernel", "split_direction_kernel",
                "xs_kernel", "tap_kernel", "tap_p_dw_kernel", "tap_a_kernel")


def main(argv=None) -> list[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a CUDA device")
    args = _parse_args(argv)
    cfg, rank, optimizer, batch_at, device = prepare(args)
    if device.type != "cuda":
        raise RuntimeError("profile_train measures the card: --device cuda")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(args.seed))
    state = run(cfg, params, batch_at, optimizer=optimizer, steps=0,
                lr_at=lambda s: args.lr, remat=args.remat)["state"]
    step = make_train_step(bundle, optimizer, accum=args.accum,
                           remat=args.remat, grad_fused=resolve_grad_fused(
                               bundle, args.grad_fused, args.accum))
    batch = {k: v.to(device) for k, v in batch_at(1).items()}
    out = []
    for profiled in (False, True):
        for tracking in (False, True):
            if not profiled:
                state, _ = step(state, batch, args.lr,
                                do_subspace_update=tracking)
                torch.cuda.synchronize()
                continue
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, metrics = step(state, batch, args.lr,
                                      do_subspace_update=tracking)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            by_name: dict[str, float] = defaultdict(float)
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA:
                    by_name[ev.name] += ev.device_time_total   # microseconds
            busy = sum(by_name.values()) / 1e6
            if busy <= 0:
                raise RuntimeError("the profiler recorded no device activity")
            port = sum(t for n, t in by_name.items()
                       if any(k in n for k in PORT_KERNELS)) / 1e6
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
            res = {"device": torch.cuda.get_device_name(0), "arch": cfg.name,
                   "optimizer": args.optimizer, "rank": rank,
                   "accum": args.accum, "remat": args.remat,
                   "tokens": args.batch * args.seq,
                   "step": "tracking" if tracking else "plain",
                   "loss": float(metrics["loss"]),
                   "quarantined": bool(metrics["quarantined"]),
                   "wall_s": wall, "device_busy_s": busy,
                   "busy_share": busy / wall, "idle_share": 1 - busy / wall,
                   "port_kernels_s": port, "other_device_s": busy - port,
                   "top_kernels_s": [[n[:120], t / 1e6] for n, t in top]}
            out.append(res)
    for res in out:                   # the gate, with host activity on
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, metrics = step(state, batch, args.lr,
                                  do_subspace_update=res["step"] == "tracking")
            torch.cuda.synchronize()
        res["gate_quarantined"] = bool(metrics["quarantined"])
        gate = [ev for ev in prof.events() if ev.name == GATE_RANGE
                and ev.device_type == DeviceType.CPU]
        if len(gate) != 1:
            raise RuntimeError(f"{len(gate)} {GATE_RANGE} ranges profiled")
        res["gate_device_s"] = gate[0].device_time_total / 1e6
        kern: dict[str, float] = defaultdict(float)   # the gate's kernels
        todo = list(gate[0].cpu_children)
        while todo:
            ev = todo.pop()
            todo.extend(ev.cpu_children)
            for k in ev.kernels:
                kern[k.name] += k.duration             # microseconds
        res["gate_top_kernels_s"] = [
            [n[:120], t / 1e6]
            for n, t in sorted(kern.items(), key=lambda kv: -kv[1])[:6]]
        res["gate_host_s"] = gate[0].cpu_time_total / 1e6
        span = gate[0].time_range
        dev = sorted((ev.time_range for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA),
                     key=lambda r: r.start)
        inside = [r for r in dev if span.start <= r.start <= span.end]
        after = [r.start for r in dev
                 if inside and r.start >= inside[-1].end]
        res["gate_stall_s"] = ((min(after) - inside[-1].end) / 1e6
                               if after else None)
        print(json.dumps(res), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
