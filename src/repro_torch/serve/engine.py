"""PagedEngine: continuous batching over the block-table KV cache.

Counterpart of ``repro.serve.engine``.  The engine owns the device pool
(:class:`repro_torch.models.attention.PagedKV`), the host allocator
(:class:`repro_torch.serve.kv_cache.BlockAllocator`) and drives two
programs of the model bundle:

    paged_prefill_chunk(params, pool, tokens (1, c), table (W,), ctx)
    paged_decode_step(params, pool, token (B,), lengths (B,),
                      tables (B, W), live (B,))

``step(now)`` is one scheduler tick: admit from the AdmissionQueue while
KV reservations fit, run AT MOST ONE prefill chunk, then one decode wave
assembled from every live decoding sequence (continuous batching: a
freshly admitted request joins the next wave, and a long prompt enters
one ``prefill_chunk`` tokens at a time).  Decode lanes without a live
sequence are masked dead: they write to the null block and attend over
zero keys.

OOM policy (pool exhaustion) degrades through the queue: a request that
can NEVER fit (prompt + max_new over the pool or the table width) is shed
at once; one that merely does not fit NOW is deferred to the queue front,
where the deadline machinery expires it if pressure persists.

The programs update the pool in place.  The JAX engine instead donates
the pool buffer to each jitted call (``repro/serve/engine.py``) to keep
one copy resident; writing in place gives the port the same residency.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from repro_torch.serve.kv_cache import BlockAllocator
from repro_torch.serve.sampling import sample_tokens


def _clock(now: float | None) -> float:
    return time.time() if now is None else now


class _Seq:
    """One live sequence: its request plus cache-fill progress."""

    __slots__ = ("req", "length", "next_token", "phase")

    def __init__(self, req):
        self.req = req
        self.length = 0          # tokens written to the pool so far
        self.next_token = -1     # last sampled, not yet written token
        self.phase = "prefill"   # "prefill" -> "decode"


class PagedEngine:
    def __init__(self, bundle, params, queue, *, batch: int = 4,
                 block_size: int = 16, pool_blocks: int = 64,
                 max_context: int = 256, prefill_chunk: int = 0,
                 temperature: float = 0.0, seed: int = 0):
        if bundle.paged_decode_step is None:
            raise ValueError("config has no paged path "
                             "(see transformer.paged_supported)")
        self.bundle = bundle
        self.params = params
        self.device = params["embed"].device
        self.queue = queue
        self.batch = batch
        self.prefill_chunk = prefill_chunk
        self.temperature = temperature
        self.seed = seed
        self.max_context = max_context
        self.alloc = BlockAllocator(pool_blocks, block_size)
        self.table_width = -(-max_context // block_size)
        self.pool = bundle.init_paged_cache(pool_blocks, block_size,
                                            self.device)
        self.seqs: list[_Seq] = []
        self.done: list[Any] = []
        self.token_stamps: dict[int, list[float]] = {}
        self._n_samples = 0
        # oom_deferrals counts unique deferred REQUESTS, not the ticks a
        # head-of-line request spends re-deferring under pressure
        self._deferred_rids: set[int] = set()
        self.stats = {"decode_calls": 0, "prefill_chunks": 0,
                      "oom_shed": 0, "oom_deferrals": 0,
                      "decode_wall_s": 0.0, "occupancy": []}

    # -- scheduling --------------------------------------------------------

    def _admit(self, now: float | None) -> None:
        while len(self.seqs) < self.batch and len(self.queue):
            wave = self.queue.take_wave(1, now=now)
            if not wave:
                return                      # everything pending expired
            req = wave[0]
            total = len(req.prompt) + req.max_new
            if (total > self.max_context
                    or self.alloc.blocks_needed(total) > self.alloc.capacity):
                self.queue.shed_now(req)    # can never fit: OOM-shed
                self.stats["oom_shed"] += 1
                continue
            if not self.alloc.reserve(req.rid, total):
                self.queue.defer(req)       # doesn't fit NOW: back to front
                if req.rid not in self._deferred_rids:
                    self._deferred_rids.add(req.rid)
                    self.stats["oom_deferrals"] += 1
                return
            self.seqs.append(_Seq(req))
            self.token_stamps[req.rid] = []

    def _sample(self, logits) -> list[int]:
        """Sample on the device; the host read is the wave's one sync."""
        toks = sample_tokens(logits, self.temperature, self.seed,
                             self._n_samples)
        self._n_samples += 1
        return toks.tolist()

    def _tensor(self, array, dtype) -> torch.Tensor:
        return torch.as_tensor(array, dtype=dtype).to(self.device)

    def _emit(self, seq: _Seq, token: int, now: float | None) -> None:
        seq.req.out_tokens.append(token)
        seq.next_token = token
        self.token_stamps[seq.req.rid].append(_clock(now))

    def _retire(self, seq: _Seq, now: float | None) -> None:
        seq.req.t_done = _clock(now)
        seq.req.status = "done"
        self.alloc.free(seq.req.rid)
        self.seqs.remove(seq)
        self.done.append(seq.req)

    def _prefill_step(self, now: float | None) -> bool:
        seq = next((s for s in self.seqs if s.phase == "prefill"), None)
        if seq is None:
            return False
        prompt = seq.req.prompt
        P = len(prompt)
        c = self.prefill_chunk or P
        start = seq.length
        chunk = np.asarray(prompt[start:start + c], np.int64)
        take = len(chunk)
        if take < c:                    # pad the final partial chunk so every
            chunk = np.pad(chunk, (0, c - take))  # chunk has one shape
        if not self.alloc.ensure(seq.req.rid, start + take):
            raise RuntimeError("KV reservation invariant broken for rid "
                               f"{seq.req.rid}")
        table = self._tensor(
            self.alloc.padded_table(seq.req.rid, self.table_width),
            torch.int32)
        logits = self.bundle.paged_prefill_chunk(
            self.params, self.pool, self._tensor(chunk[None, :], torch.int64),
            table, start)
        self.stats["prefill_chunks"] += 1
        seq.length = start + take
        if seq.length >= P:                  # prompt complete: first token
            (tok,) = self._sample(logits[:, (P - 1) - start])
            seq.req.t_first = _clock(now)
            seq.phase = "decode"
            self._emit(seq, tok, now)
            if len(seq.req.out_tokens) >= seq.req.max_new:
                self._retire(seq, now)
        return True

    def _decode_wave(self, now: float | None) -> bool:
        wave = [s for s in self.seqs if s.phase == "decode"][:self.batch]
        if not wave:
            return False
        t0 = time.perf_counter()
        B, W = self.batch, self.table_width
        tok = np.zeros((B,), np.int64)
        lengths = np.zeros((B,), np.int32)
        tables = np.zeros((B, W), np.int32)
        live = np.zeros((B,), bool)
        for i, s in enumerate(wave):
            if not self.alloc.ensure(s.req.rid, s.length + 1):
                raise RuntimeError("KV reservation invariant broken for "
                                   f"rid {s.req.rid}")
            tok[i] = s.next_token
            lengths[i] = s.length
            tables[i] = self.alloc.padded_table(s.req.rid, W)
            live[i] = True
        logits = self.bundle.paged_decode_step(
            self.params, self.pool, self._tensor(tok, torch.int64),
            self._tensor(lengths, torch.int32),
            self._tensor(tables, torch.int32), self._tensor(live, torch.bool))
        self.stats["decode_calls"] += 1
        toks = self._sample(logits)
        self.stats["decode_wall_s"] += time.perf_counter() - t0
        for i, s in enumerate(wave):
            s.length += 1
            self._emit(s, toks[i], now)
            if len(s.req.out_tokens) >= s.req.max_new:
                self._retire(s, now)
        self.stats["occupancy"].append(self.alloc.occupancy)
        return True

    def step(self, now: float | None = None) -> bool:
        """One tick: admit, one prefill chunk, one decode wave.  Returns
        whether any device work ran (False = idle).

        With ``now`` given (a synthetic clock, as the tests drive it) every
        stamp of the tick is ``now``, as in the JAX engine.  Without it each
        token is stamped with the wall clock when it reaches the host, so
        TTFT includes the compute that produced the token."""
        self._admit(now)
        did = self._prefill_step(now)
        did |= self._decode_wave(now)
        return did

    def run(self) -> dict:
        """Drain everything already submitted to the queue."""
        while True:
            did = self.step()
            if not did and not len(self.queue) and not self.seqs:
                return self.summary()

    def summary(self) -> dict:
        occ = self.stats["occupancy"]
        calls = self.stats["decode_calls"]
        return {
            "requests": len(self.done),
            "tokens": sum(len(r.out_tokens) for r in self.done),
            "decode_calls": calls,
            "prefill_chunks": self.stats["prefill_chunks"],
            "oom_shed": self.stats["oom_shed"],
            "oom_deferrals": self.stats["oom_deferrals"],
            "decode_wave_ms_mean": (1e3 * self.stats["decode_wall_s"] / calls
                                    if calls else 0.0),
            "kv_occupancy_mean": float(np.mean(occ)) if occ else 0.0,
            "kv_occupancy_peak": float(np.max(occ)) if occ else 0.0,
        }
