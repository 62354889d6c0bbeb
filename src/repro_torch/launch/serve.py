"""Serving driver: paged continuous batching (default) or dense waves,
on CUDA.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama-7b --batch 8 --requests 8 --prompt-len 512 --gen 64 \\
        --prefill-chunk 128 --block-size 16 [--engine dense]

Counterpart of ``repro.launch.serve``, with its two engines:

``--engine paged`` (default where the config supports it) runs
:class:`repro_torch.serve.engine.PagedEngine`: a global pool of fixed-size
KV blocks, per-request block tables, chunked prefill interleaved with
decode waves, decode batches assembled per wave from the live sequences.
KV exhaustion degrades through the admission queue (shed /
deferred-then-expired) instead of crashing.

``--engine dense`` is the static-batch baseline (:func:`run_dense`): one
prefill per wave of up to ``--batch`` requests into per-slot dense
caches, then decode until the wave's longest request is done; slots
without a live request emit nothing.  Where the paged engine cannot take
the config, the driver says so and falls back to the dense one, as the
JAX driver does.

Weights are random, drawn from ``--seed``.  The driver runs on CUDA
unless ``--device cpu`` asks for the CPU; with no card and no such
request it raises.  Multi-device meshes (``--mesh``) are not ported yet
and raise.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.models.api import build_model
from repro_torch.models.transformer import paged_supported
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.sampling import sample_tokens


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out_tokens: list = field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    status: str = "queued"    # queued | done | expired | shed


class AdmissionQueue:
    """Bounded FIFO admission with per-request queue deadlines.

    Pure host-side policy, so overload behaviour is unit-testable:
    ``submit`` sheds beyond ``max_queue`` pending entries, ``take_wave``
    first expires entries whose queue wait exceeds ``deadline_s`` and then
    hands out up to ``batch`` survivors in FIFO order.  ``max_queue=0`` /
    ``deadline_s=0`` disable the respective limit.  Rejected requests are
    kept (with their status marker) on the ``shed`` / ``expired`` lists.

    The paged engine adds two verbs for its KV-pool OOM policy:
    ``shed_now`` (request can never fit — reject outright) and ``defer``
    (request does not fit *yet* — requeue at the FRONT with its original
    ``t_submit``, so under sustained pressure the deadline expires it).
    """

    def __init__(self, max_queue: int = 0, deadline_s: float = 0.0):
        self.max_queue = max_queue
        self.deadline_s = deadline_s
        self.pending: list[Request] = []
        self.shed: list[Request] = []
        self.expired: list[Request] = []

    def __len__(self) -> int:
        return len(self.pending)

    def submit(self, req: Request, now: float | None = None) -> bool:
        """Admit ``req`` (True) or shed it (False) when the queue is full."""
        if req.t_submit == 0.0:
            req.t_submit = time.time() if now is None else now
        if self.max_queue and len(self.pending) >= self.max_queue:
            req.status = "shed"
            self.shed.append(req)
            return False
        req.status = "queued"
        self.pending.append(req)
        return True

    def shed_now(self, req: Request) -> None:
        """Reject a request the engine cannot ever serve (KV OOM-shed)."""
        req.status = "shed"
        self.shed.append(req)

    def defer(self, req: Request) -> None:
        """Requeue at the front, keeping t_submit (deadline still ticking)."""
        req.status = "queued"
        self.pending.insert(0, req)

    def _expire(self, now: float) -> None:
        if not self.deadline_s:
            return
        keep = []
        for r in self.pending:
            if now - r.t_submit > self.deadline_s:
                r.status = "expired"
                self.expired.append(r)
            else:
                keep.append(r)
        self.pending = keep

    def take_wave(self, batch: int, now: float | None = None
                  ) -> list[Request]:
        """Expire overdue entries, then pop up to ``batch`` requests."""
        self._expire(time.time() if now is None else now)
        wave = self.pending[:batch]
        del self.pending[:batch]
        return wave


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asked for
    the CPU.  Never falls back: CUDA without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return dev


def run_dense(cfg, bundle, params, queue: AdmissionQueue, *,
              batch: int, prompt_len: int, temperature: float = 0.0,
              seed: int = 0) -> dict:
    """Wave-at-a-time serving against dense per-slot KV caches, on the
    device ``params`` live on.

    A wave's requests share one prefill (prompts must share
    ``prompt_len``; free slots are zero rows); the wave then decodes until
    its longest request is done, not to a fixed step count, and slots
    whose request is done (or that were padding) emit nothing.  Each
    decode step ends in one device sync, the sampled tokens' read.  As
    in the JAX driver, a vision config's prefill gets zero vision
    embeddings (so a prompt must hold at least ``vision_tokens`` tokens)
    and an mrope config's text positions on all three streams.
    """
    device = params["embed"].device
    if prompt_len < cfg.vision_tokens:
        raise ValueError(f"{cfg.name}: a prompt of {prompt_len} tokens "
                         f"cannot hold {cfg.vision_tokens} vision tokens")
    max_new_cap = max((r.max_new for r in queue.pending), default=1)
    max_len = prompt_len + max_new_cap + 8
    done: list[Request] = []
    B = batch
    t0 = time.time()
    n_decode_calls = 0
    n_samples = 0
    decode_s = 0.0

    def sample(logits) -> list[int]:
        nonlocal n_samples
        toks = sample_tokens(logits, temperature, seed, n_samples)
        n_samples += 1
        return toks.tolist()

    while len(queue):
        wave = queue.take_wave(B)
        if not wave:
            break
        toks = np.zeros((B, prompt_len), np.int64)
        for i, r in enumerate(wave):
            toks[i] = r.prompt
        logits, cache = bundle.prefill(
            params, _prefill_inputs(cfg, toks, device), max_len)
        tok = sample(logits)
        now = time.time()
        for i, r in enumerate(wave):
            r.t_first = now
            r.out_tokens.append(tok[i])
        while any(len(r.out_tokens) < r.max_new for r in wave):
            t_step = time.perf_counter()
            logits, cache = bundle.decode_step(
                params, cache, torch.as_tensor(tok).to(device))
            tok = sample(logits)
            decode_s += time.perf_counter() - t_step
            n_decode_calls += 1
            for i, r in enumerate(wave):
                if len(r.out_tokens) < r.max_new:
                    r.out_tokens.append(tok[i])
        del cache
        now = time.time()
        for r in wave:
            r.t_done = now
            r.status = "done"
            done.append(r)

    wall = time.time() - t0
    out = _summary("dense", done, queue, wall, n_decode_calls, temperature)
    out["decode_step_ms_mean"] = (1e3 * decode_s / n_decode_calls
                                  if n_decode_calls else 0.0)
    out["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else None)
    return out


def _prefill_inputs(cfg, toks: np.ndarray, device) -> dict:
    """The dense prefill's batch: the tokens, zero vision embeddings
    (bf16) for a vision config, t = h = w text positions for an mrope
    config, and zero frames (B, S, d) in bf16 for the encoder-decoder, as
    the JAX driver passes."""
    B, S = toks.shape
    batch = {"tokens": torch.as_tensor(toks).to(device)}
    if cfg.vision_tokens:
        batch["vision_embeds"] = torch.zeros(
            (B, cfg.vision_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    if cfg.mrope:
        pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
        batch["mrope_positions"] = torch.stack([pos] * 3, dim=1)
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, S, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)
    return batch


def run_paged(cfg, bundle, params, queue: AdmissionQueue, *,
              batch: int, block_size: int, pool_blocks: int,
              max_context: int, prefill_chunk: int,
              temperature: float = 0.0, seed: int = 0) -> dict:
    """Serve everything in ``queue`` on the device ``params`` live on."""
    engine = PagedEngine(bundle, params, queue, batch=batch,
                         block_size=block_size, pool_blocks=pool_blocks,
                         max_context=max_context,
                         prefill_chunk=prefill_chunk,
                         temperature=temperature, seed=seed)
    t0 = time.time()
    stats = engine.run()
    wall = time.time() - t0
    out = _summary("paged", engine.done, queue, wall,
                   stats["decode_calls"], temperature)
    out["decode_wave_ms_mean"] = stats["decode_wave_ms_mean"]
    out["kv"] = {k: stats[k] for k in
                 ("prefill_chunks", "oom_shed", "oom_deferrals",
                  "kv_occupancy_mean", "kv_occupancy_peak")}
    return out


def _summary(engine: str, done, queue: AdmissionQueue, wall: float,
             decode_calls: int, temperature: float) -> dict:
    total_new = sum(len(r.out_tokens) for r in done)
    ttfts = [r.t_first - r.t_submit for r in done]
    ttft = float(np.mean(ttfts)) if done else 0.0
    ttft_p50 = float(np.median(ttfts)) if done else 0.0
    print(f"[serve:{engine}] {len(done)} requests, {total_new} tokens in "
          f"{wall:.2f}s  ({total_new / max(wall, 1e-9):.1f} tok/s, "
          f"mean TTFT {ttft:.2f}s, {decode_calls} decode calls, "
          f"temperature {temperature:g})", flush=True)
    if queue.shed or queue.expired:
        print(f"[serve:{engine}] degraded: {len(queue.shed)} shed, "
              f"{len(queue.expired)} expired", flush=True)
    return {"engine": engine, "requests": len(done), "tokens": total_new,
            "wall_s": wall, "tok_per_s": total_new / max(wall, 1e-9),
            "ttft_mean_s": ttft, "ttft_p50_s": ttft_p50,
            "decode_calls": decode_calls, "temperature": temperature,
            "outputs": {r.rid: list(r.out_tokens) for r in done},
            "shed": [r.rid for r in queue.shed],
            "expired": [r.rid for r in queue.expired]}


def prepare(argv=None) -> Callable[[], dict]:
    """Parse the CLI flags and build the model once.  The returned function
    serves the flags' requests afresh each time it is called (a new queue,
    a new pool) and returns the run's summary."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--mesh", default="smoke",
                    help="only the one-device default is ported")
    ap.add_argument("--engine", default="paged", choices=["paged", "dense"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-queue", type=int, default=0,
                    help="shed request submissions beyond this many "
                         "pending entries (0 = unbounded)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="expire requests that wait in the queue longer "
                         "than this before admission (0 = none)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="total pool blocks incl. the null block (0 = "
                         "sized for --batch full sequences)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prompt tokens prefilled per engine tick (0 = "
                         "whole prompt at once)")
    args = ap.parse_args(argv)

    if args.mesh != "smoke":
        raise NotImplementedError("--mesh (serving over a mesh) is not yet "
                                  "ported to repro_torch.launch.serve")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    engine = args.engine
    if engine == "paged":
        ok, why = paged_supported(cfg)
        if not ok:
            print(f"[serve] paged engine unavailable for {args.arch}: "
                  f"{why} — falling back to dense", flush=True)
            engine = "dense"
    bundle = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = bundle.init(gen)
    data = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.prompt_len,
        global_batch=args.requests, seed=args.seed))
    prompts = data.global_batch_at(0)["tokens"].numpy()
    max_context = args.prompt_len + args.gen
    pool_blocks = args.pool_blocks or (
        1 + args.batch * -(-max_context // args.block_size))

    def run() -> dict:
        queue = AdmissionQueue(max_queue=args.max_queue,
                               deadline_s=args.deadline_s)
        for i in range(args.requests):
            queue.submit(Request(rid=i, prompt=prompts[i],
                                 max_new=args.gen, t_submit=time.time()))
        if engine == "dense":
            return run_dense(cfg, bundle, params, queue, batch=args.batch,
                             prompt_len=args.prompt_len,
                             temperature=args.temperature, seed=args.seed)
        return run_paged(cfg, bundle, params, queue, batch=args.batch,
                         block_size=args.block_size,
                         pool_blocks=pool_blocks, max_context=max_context,
                         prefill_chunk=args.prefill_chunk,
                         temperature=args.temperature, seed=args.seed)

    return run


def serve(argv=None) -> dict:
    """The CLI: build the model and serve the requests once."""
    return prepare(argv)()


if __name__ == "__main__":
    serve()
