"""Where the unfused optimizer step's CUDA-vs-CPU gap comes from.

    PYTHONPATH=src python -m repro_torch.launch.probe_unfused [--runs 20] [--poison]

Runs ``lowrank_adam_step(lr=None, backend=ops)`` on the CUDA test's inputs
(``tests/test_torch_kernels_cuda.py``,
``test_unfused_step_launches_project_backproject_recovery``: 2 matrices,
(300, 500), r 32, bf16 G, ``lam_prev = [0, 0.5]``, step 3) ``--runs``
times in one process on the card, recording every intermediate of the
chain: Gt = S^T G (#1), M', V', Gto, Ghat = S Gto (#2), Lam (#4, before
the limiter), the limiter's clip, delta and lam_prev.  For each it prints
one JSON line:

* whether every run gave the same bits as the first (a kernel whose result
  changes from one call to the next would show here), and a hash of the
  first run's bits (to compare processes);
* its error against the CPU's fp32 run and against an fp64 run of the same
  step, each as max |error| over the largest entry, and whether a second
  CPU run from the same inputs gave the CPU's first bits (on the card's
  host the first CPU evaluation in a process has come out wrong);
* for every stage after Gt, its error against the fp64 step evaluated from
  the card's own Gt (the chain after #1, without Gt's rounding amplified
  by Adam).

With ``--poison`` every run first fills the caching allocator's free
blocks with NaN (as a long test session leaves them full of old data), so a
kernel that reads memory it never wrote shows as NaN or as bits that
differ from the unpoisoned runs.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import torch

from repro_torch.core import lowrank_adam as tla
from repro_torch.kernels import ops

STAGES = ("Gt", "M", "V", "Gto", "Ghat", "Lam", "clip", "delta", "lam_prev")


class Fp64Backend:
    """The unfused step's three products in fp64 (the kernels' contract)."""

    @staticmethod
    def project(S, G):
        return S.double().mT @ G.double()

    @staticmethod
    def backproject(S, X):
        return S.double() @ X.double()

    @staticmethod
    def recovery(S, G, Gt, phi):
        return (G.double() - S.double() @ Gt.double()) * phi.double()[..., None, :]


class Recorder:
    """Wraps a backend and keeps what its three products saw and gave."""

    def __init__(self, backend):
        self.backend, self.log = backend, {}

    def project(self, S, G):
        self.log["Gt"] = out = self.backend.project(S, G)
        return out

    def backproject(self, S, X):
        self.log["Gto"] = X
        self.log["Ghat"] = out = self.backend.backproject(S, X)
        return out

    def recovery(self, S, G, Gt, phi):
        self.log["Lam"] = out = self.backend.recovery(S, G, Gt, phi)
        return out


def inputs(device):
    """The CUDA test's inputs, drawn in its order from its seed."""
    gen = torch.Generator(device=device).manual_seed(4)

    def rn(*s):
        return torch.randn(*s, generator=gen, device=device)

    S = torch.linalg.qr(rn(2, 300, 32))[0].contiguous()
    G = rn(2, 300, 500).to(torch.bfloat16)
    st = tla.MatrixOptState(S=S, M=0.1 * rn(2, 32, 500),
                            V=0.01 * rn(2, 32, 500).abs(),
                            lam_prev=torch.tensor([0.0, 0.5], device=device))
    return G, st


def step(G, st, backend, **kw):
    """One unfused step through ``backend``: every stage of STAGES."""
    rec = Recorder(backend)
    if "precomputed_proj" in kw:
        rec.log["Gt"] = kw["precomputed_proj"]
    out = tla.lowrank_adam_step(G, st, 3, tla.AdamHP(), backend=rec, **kw)
    log = dict(rec.log, M=out.state.M, V=out.state.V, delta=out.delta,
               lam_prev=out.state.lam_prev)
    lam_norm = torch.sqrt((log["Lam"] * log["Lam"]).sum(dim=(-2, -1)))
    log["clip"], _ = tla._limiter(lam_norm, st.lam_prev, tla.AdamHP().zeta)
    return {k: log[k].detach().to("cpu", torch.float64) for k in STAGES}


def poison_allocator() -> None:
    """Hand the caching allocator blocks of every size full of NaN."""
    junk = [torch.full((1 << 30,), float("nan"), device="cuda")]
    junk += [torch.full((n,), float("nan"), device="cuda")
             for n in (256, 1024, 4096, 16384, 65536, 1 << 18) for _ in range(64)]
    del junk


def rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-300)).item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--poison", action="store_true",
                    help="fill the allocator's free blocks with NaN first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_unfused: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    G, st = inputs("cuda")
    runs = []
    for _ in range(args.runs):
        if args.poison:
            poison_allocator()
        runs.append(step(G, st, ops))
        torch.cuda.synchronize()
    G_cpu = G.cpu()
    st_cpu = tla.MatrixOptState(*(t.cpu() for t in st))
    cpu = step(G_cpu, st_cpu, ops)
    cpu_again = step(G_cpu, st_cpu, ops)
    st64 = tla.MatrixOptState(*(t.double() for t in st_cpu))
    fp64 = step(G_cpu, st64, Fp64Backend())
    from_card_gt = step(G_cpu, st64, Fp64Backend(),
                        precomputed_proj=runs[0]["Gt"])
    for k in STAGES:
        first = runs[0][k]
        line = {"stage": k,
                "same_bits_every_run": all(torch.equal(r[k], first)
                                           for r in runs),
                "sha1": hashlib.sha1(first.numpy().tobytes()).hexdigest()[:12],
                "runs": len(runs),
                "vs_cpu_fp32": [rel(r[k], cpu[k]) for r in runs],
                "vs_fp64": rel(first, fp64[k]),
                "cpu_fp32_vs_fp64": rel(cpu[k], fp64[k]),
                "cpu_repeat_same_bits": torch.equal(cpu[k], cpu_again[k])}
        if k not in ("Gt",):
            line["vs_fp64_from_card_gt"] = rel(first, from_card_gt[k])
        line["vs_cpu_fp32"] = max(line["vs_cpu_fp32"])
        print(json.dumps(line), flush=True)
    # where delta's largest errors sit: Adam's terms there
    d = (runs[0]["delta"] - cpu["delta"]).abs()
    i = int(d.flatten().argmax())
    b, row, col = torch.unravel_index(torch.tensor(i), d.shape)
    j = (b, slice(None), col)
    gt_c, gt_g = runs[0]["Gt"][j], cpu["Gt"][j]
    print(json.dumps({
        "worst_delta_entry": [int(b), int(row), int(col)],
        "delta_err": float(d.max()), "delta_max": float(cpu["delta"].abs().max()),
        "column_gt_abs_min": float(gt_g.abs().min()),
        "column_gt_err_max": float((gt_c - gt_g).abs().max()),
        "column_v_min": float(cpu["V"][j].min()),
        "column_gto_err_max": float((runs[0]["Gto"][j] - cpu["Gto"][j]).abs().max()),
        "column_gto_abs_max": float(cpu["Gto"][j].abs().max()),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
