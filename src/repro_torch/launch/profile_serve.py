"""Where a serving run's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch llama-7b --batch 8 --requests 8 --prompt-len 512 --gen 64 \\
        --prefill-chunk 128 --block-size 16

Takes the serving CLI's flags (:mod:`repro_torch.launch.serve`), builds the
model once, serves the requests once to warm up (kernel build, library
handles, the caching allocator), then serves them again under
``torch.profiler`` recording device activity only.  Prints the card and
one JSON object: the profiled run's wall time (host clock around a run
that ends in a device sync), the summed duration of the device activity
(kernels, copies and fills on one stream do not overlap, so the sum is
the time the card was busy), the busy and idle shares, and the device
time of the top kernels by name.  Needs a CUDA device; raises if the
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

from repro_torch.launch.serve import prepare


def main(argv=None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serve needs a CUDA device")
    run = prepare(argv)
    run()                                              # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        summary = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] += ev.device_time_total   # microseconds
    busy = sum(by_name.values()) / 1e6
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    paged = sum(t for n, t in by_name.items() if "paged_attention" in n) / 1e6
    out = {
        "device": torch.cuda.get_device_name(0), "engine": summary["engine"],
        "wall_s": wall, "device_busy_s": busy,
        "busy_share": busy / wall, "idle_share": 1 - busy / wall,
        "paged_attention_s": paged, "paged_attention_share_of_busy":
            paged / busy,
        "decode_calls": summary["decode_calls"],
        "prefill_chunks": summary.get("kv", {}).get("prefill_chunks"),
        "tokens": summary["tokens"],
        "top_kernels_s": [[name[:120], t / 1e6] for name, t in top],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
