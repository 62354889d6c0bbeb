#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. print the card's name and power limit as nvidia-smi gives them;
2. build every CUDA kernel of the serving path from ``src/repro_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all at once) and print the
   build time and the compiler's register report;
3. hold each kernel against its plain-PyTorch version on the card, in fp32
   (atol = rtol = 2e-5) and bf16 (atol 3e-2, rtol 5e-2), at the llama-7b
   decode shape (B 8, Hq = Hkv = 32, hd 128, bs 16, length 576),
   stablelm-12b's (Hq 32 / Hkv 8, hd 160), and a batch with a dead lane
   (exactly 0 out) and partial blocks;
4. time each kernel with CUDA events at the llama-7b shape in bf16, beside
   its bound, its plain version, and ``scaled_dot_product_attention`` over
   the same K/V already gathered (a yardstick the port never calls);
5. serve the fp32 smoke llama through ``run_paged`` on CUDA and on the CPU
   from the same weights: greedy tokens must be identical, and the CUDA run
   must have launched the kernel;
6. serve llama-7b (random bf16 weights from the seed) through the CLI entry
   point ``repro_torch.launch.serve.serve``: 8 requests of 512 + 64 tokens,
   batch 8, chunked prefill 128, block size 16; every request must finish
   with 64 tokens and the kernel must have launched once per layer per
   decode wave;
7. print the kernels line, then ``{"ok": true, "device": {...}}`` last.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=5e-2)}
SEED = 0


def _paged_case(B, Hq, Hkv, hd, bs, lengths, dtype, seed):
    """Random q and pools on the card; tables over distinct non-null
    blocks, null-padded past each lane's length."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    W = -(-max(lengths) // bs)
    nb = 1 + B * W

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, kp, vp = randn(B, Hq, hd), randn(nb, bs, Hkv, hd), randn(nb, bs, Hkv,
                                                               hd)
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[:B * W].reshape(B, W).int()
    for b, n in enumerate(lengths):
        tables[b, -(-n // bs):] = 0
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables.contiguous(), lens


def _time_ms(fn, iters, repeats=5) -> float:
    """Median over ``repeats`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def phase_device() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build(["paged_attention"])
    for name, r in report.items():
        regs = [ln.strip() for ln in r["ptxas"].splitlines() if "Used" in ln]
        print(f"[build] {name}.cu: nvcc {r['seconds']:.1f}s; {regs}",
              flush=True)
    print(f"[build] all kernels ready in {time.perf_counter() - t0:.1f}s "
          f"({len(report)} compiled, sm_90a)", flush=True)


def phase_check_paged_attention() -> float:
    """Kernel vs oracle at every case; returns the max abs error at the
    llama-7b bf16 shape (the one timed)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention

    cases = {
        "llama-7b": (8, 32, 32, 128, 16, [576] * 8),
        "stablelm-12b": (8, 32, 8, 160, 16, [576] * 8),
        "dead-lane+partial": (4, 32, 8, 128, 16, [0, 1, 300, 576]),
    }
    err_7b = math.nan
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (B, Hq, Hkv, hd, bs, lens)) in enumerate(cases.items()):
            args = _paged_case(B, Hq, Hkv, hd, bs, lens, dtype, SEED + i)
            got = paged_attention(*args)
            torch.cuda.synchronize()
            want = ref.paged_attention_ref(*args)
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[dtype])
            err = (got.float() - want.float()).abs().max().item()
            if 0 in lens:
                dead = lens.index(0)
                if torch.count_nonzero(got[dead]).item():
                    raise AssertionError("dead lane is not exactly 0")
            if name == "llama-7b" and dtype == torch.bfloat16:
                err_7b = err
            print(f"[check] paged_attention {name} {dtype}: max abs err "
                  f"{err:.3e} (atol {TOL[dtype]['atol']:g}, rtol "
                  f"{TOL[dtype]['rtol']:g})", flush=True)
    return err_7b


def phase_time_paged_attention() -> dict:
    """Kernel, plain version and the SDPA yardstick at the llama-7b decode
    shape in bf16; the bound from this run's inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention

    B, Hq, Hkv, hd, bs, L = 8, 32, 32, 128, 16, 576
    dtype = torch.bfloat16
    args = _paged_case(B, Hq, Hkv, hd, bs, [L] * B, dtype, SEED)
    q, kp, vp, tables, lens = args
    ms = _time_ms(lambda: paged_attention(*args), iters=200)
    plain_ms = _time_ms(lambda: ref.paged_attention_ref(*args), iters=20)
    # yardstick: the same attention over K/V gathered beforehand (not timed)
    W = tables.shape[1]
    kg = kp[tables.long()].reshape(B, W * bs, Hkv, hd)[:, :L].transpose(
        1, 2).contiguous()
    vg = vp[tables.long()].reshape(B, W * bs, Hkv, hd)[:, :L].transpose(
        1, 2).contiguous()
    q4 = q[:, :, None, :]
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(q4, kg, vg), iters=200)
    torch.testing.assert_close(
        F.scaled_dot_product_attention(q4, kg, vg)[:, :, 0].float(),
        ref.paged_attention_ref(*args).float(), **TOL[dtype])

    # least time: each input read once, the output written once
    n_pos = int(lens.sum())
    esize = q.element_size()
    words = sum(-(-int(n) // bs) for n in lens.tolist())
    nbytes = (q.numel() * esize + 2 * n_pos * Hkv * hd * esize
              + 4 * words + 4 * B + q.numel() * esize)
    flops = 4 * Hq * hd * n_pos            # q.k and p.v, fp32 CUDA cores
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes}
    print(f"[time] paged_attention llama-7b decode bf16: kernel {ms:.4f} ms, "
          f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}, "
          f"{nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms, sdpa over "
          f"gathered K/V {library_ms:.4f} ms", flush=True)
    return out


def phase_serve_smoke() -> None:
    """fp32 smoke llama on CUDA and on the CPU from the same weights."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import AdmissionQueue, Request, run_paged
    from repro_torch.models.api import build_model

    cfg = get_config("llama-100m", smoke=True).with_(dtype="float32")
    bundle = build_model(cfg)
    prompts = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=6,
        seed=SEED)).global_batch_at(0)["tokens"].numpy()
    # mixed prompt and output lengths, so lanes die at different waves
    plens, gens = [32, 20, 27, 9, 32, 14], [16, 9, 12, 16, 5, 11]

    def run(device):
        params = bundle.init(torch.Generator().manual_seed(SEED),
                             device=device)
        q = AdmissionQueue()
        for i, (p, g) in enumerate(zip(plens, gens)):
            q.submit(Request(rid=i, prompt=prompts[i, :p], max_new=g))
        ops.reset_launch_counts()
        out = run_paged(cfg, bundle, params, q, batch=4, block_size=8,
                        pool_blocks=1 + 4 * 6, max_context=48,
                        prefill_chunk=16)
        return out, ops.launch_counts()["paged_attention"]

    cuda_out, cuda_launches = run("cuda")
    cpu_out, cpu_launches = run("cpu")
    if cuda_out["outputs"] != cpu_out["outputs"]:
        raise AssertionError(f"greedy tokens differ: cuda "
                             f"{cuda_out['outputs']} cpu {cpu_out['outputs']}")
    if [len(cuda_out["outputs"][i]) for i in range(6)] != gens:
        raise AssertionError("smoke requests did not all finish")
    if cuda_launches != cuda_out["decode_calls"] * cfg.n_layers \
            or cpu_launches:
        raise AssertionError(f"launches cuda {cuda_launches} (decode calls "
                             f"{cuda_out['decode_calls']}), cpu "
                             f"{cpu_launches}")
    print(f"[smoke] fp32 smoke llama: greedy tokens identical on CUDA and "
          f"CPU ({sum(gens)} tokens, 6 requests); kernel launches "
          f"{cuda_launches} = {cuda_out['decode_calls']} decode waves x "
          f"{cfg.n_layers} layers", flush=True)


def phase_serve_7b() -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve

    n_layers, gen, requests = 32, 64, 8
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve(["--arch", "llama-7b", "--batch", "8", "--requests",
                 str(requests), "--prompt-len", "512", "--gen", str(gen),
                 "--prefill-chunk", "128", "--block-size", "16",
                 "--seed", str(SEED)])
    total_s = time.perf_counter() - t0
    launches = ops.launch_counts()["paged_attention"]
    lens = sorted(len(t) for t in out["outputs"].values())
    if out["requests"] != requests or lens != [gen] * requests:
        raise AssertionError(f"llama-7b: {out['requests']} requests done, "
                             f"output lengths {lens}")
    if launches != out["decode_calls"] * n_layers:
        raise AssertionError(f"llama-7b: {launches} kernel launches for "
                             f"{out['decode_calls']} decode waves")
    if not all(0 <= t < 32000 for toks in out["outputs"].values()
               for t in toks):
        raise AssertionError("llama-7b: token id out of the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] llama-7b bf16: {out['requests']} requests, "
          f"{out['tokens']} tokens in {out['wall_s']:.3f}s serving "
          f"({total_s:.1f}s with init): {out['tok_per_s']:.1f} tok/s, TTFT "
          f"p50 {out['ttft_p50_s'] * 1e3:.1f} ms, mean decode wave "
          f"{out['decode_wave_ms_mean']:.3f} ms over {out['decode_calls']} "
          f"waves, {out['kv']['prefill_chunks']} prefill chunks, peak "
          f"memory {peak / 2**30:.2f} GiB, kernel launches {launches}",
          flush=True)
    return {"launches": launches, "decode_calls": out["decode_calls"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops  # noqa: F401  (fails outside a checkout)

    phase_device()
    phase_build()
    err = phase_check_paged_attention()
    timing = phase_time_paged_attention()
    phase_serve_smoke()
    served = phase_serve_7b()
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:87",
        "launches": served["launches"],
        "launches_per_decode_wave": served["launches"]
        / served["decode_calls"],
        "max_abs_err": err, "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
