#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases (run in this order, except that 13-15 and 17-19, the kernel checks
of the llama-1b slice and of the last three kernels, run right after phase
10, before the long training runs, 23 right after phase 11, and 24-28
and then 20-22 right after phase 16); any failure raises and the script
exits non-zero:

1. print the card's name and power limit as nvidia-smi gives them;
2. build every CUDA kernel of the ported paths from ``src/repro_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all at once) and print the
   build time and the compiler's register report;
3. hold the split-K paged-attention kernel against its plain-PyTorch
   version on the card, in fp32 (atol = rtol = 2e-5) and bf16 (atol 3e-2,
   rtol 5e-2), at the wrapper's split count: the llama-7b decode shape (B
   8, Hq = Hkv = 32, hd 128, bs 16, length 576), stablelm-12b's (Hq 32 /
   Hkv 8, hd 160), llama-1b's (Hq = Hkv = 24, hd 85: the element-load
   ring), a batch with a dead lane (exactly 0 out) and partial blocks; and
   at forced split counts: lengths across split ranges, one short sequence
   among long ones, more splits than blocks; a broken table word and a
   length past the table give NaN in their lanes only;
4. time it at the llama-7b shape in bf16 beside its bound, its plain
   version, and ``scaled_dot_product_attention`` over the same K/V already
   gathered (a yardstick the port never calls): the kernel and SDPA alike
   in a CUDA graph of 200 calls (the reported time) and by the profiler's
   device time, the eager loop printed beside them; forced split counts
   timed too;
5. serve the fp32 smoke llama through ``run_paged`` on CUDA and on the CPU
   from the same weights: greedy tokens must be identical, and the CUDA run
   must have launched the kernel;
6. serve llama-7b (random bf16 weights from the seed) through the CLI entry
   point ``repro_torch.launch.serve.serve``: 8 requests of 512 + 64 tokens,
   batch 8, chunked prefill 128, block size 16; every request must finish
   with 64 tokens and the kernel must have launched once per layer per
   decode wave;
7. hold each optimizer kernel (project, project_colnorms, tangent,
   adam_lowrank_norms, fused_update) against its plain version on the card
   at the three llama-7b matrix shapes (m, n) = (4096, 4096), (4096,
   11008), (4096, 32000), rank 1024, a batch of 2 matrices, G in fp32 and
   bf16 (the update in G's dtype, all four variants: recovery x decay),
   with the tolerances of ``OPT_REL`` (max error over the largest entry:
   fp32 sums of 4096 to 32000 terms in another order), the tangent also
   on the same G stored transposed (its MN-major route); project,
   project_colnorms, tangent and fused_update also at ``PROJ_SHAPES``
   (llama-1b's (2048, 5461, r 512) and a ragged (1000, 777, r 129), as
   plain and transposed views, so both producers of the bf16 routes run),
   printing each call's route (bf16 G must take wgmma, fp32 G the CUDA
   cores; fused_update wgmma for every dtype), and the bf16 splits of S and
   of the update's direction D bit for bit against ``ref.split_bf16_ref``
   and ``ref.split_direction_ref``;
8. time each optimizer kernel at (4096, 11008, r 1024) with bf16 G beside
   its bound (bytes and operations written out; for the tensor-core
   kernels their bf16 passes at the tensor cores' peak, ``_tc_work``: 3
   for project and project_colnorms, 6 for fused_update, 3 for tangent's
   G A^T and 6 for its S (2C) and its Gram C = A A^T, with the fp32 bound
   of their first designs beside it), its plain version and, where one
   exists, the PyTorch expression for the same product with TF32 off (a
   yardstick the port never calls; for fused_update
   ``torch.baddbmm(G.float() * phic, S, D)``), by CUDA events over eager
   calls; on a line of its own the fp32 ``torch.matmul`` that formed
   tangent's Gram before its tensor-core route, beside the new call, and
   the call's kernels by name (profiler); project_colnorms also at
   llama-1b's (2048, 5461, r 512) on both producers;
9. hold grad_tap against its plain version at llama-7b's tapped shapes (b
   1024, r 1024; (m, n) = (4096, 4096), (4096, 11008), (4096, 32000) and
   w_down's swapped orientation with dW stored in the leaf's layout), a
   ragged case and b = 4096, x/dy fp32 and bf16 (``TAP_REL``), printing the
   route (bf16 on the tensor cores, fp32 on the CUDA cores), and time it
   at (4096, 11008) beside its bound (dW's one pass and P's and A's three
   at the bf16 tensor cores' peak, the norms' squares at the fp32 peak; the
   first design's mixed bound beside it), its plain version and the
   PyTorch expression ``x.float().T @ dy.float()``, ``S.T @ dW``,
   ``(dW*dW).sum(0)``; time P = x S alone too, beside its own bound;
10. train the fp32 smoke llama 6 steps (rank 32, update interval 3, kernels
   on) through ``run`` on CUDA and on the CPU from the same params,
   warm-started state and batches, plain and grad-fused: loss histories
   within ``SMOKE_LOSS_ATOL`` of each other (CUDA vs CPU, and grad-fused vs
   plain on CUDA); exact launch counts on CUDA, none on the CPU;
11. time one SVD of a (4096, 4096) and a (4096, 11008) fp32 matrix per
   cuSOLVER routine (the warm start uses gesvd), then train llama-7b at
   full width and ``LAYERS_7B`` = 8 of its 32 layers (58 warm-start
   SVDs) through ``run``, what the CLI runs (phase 16 drives the CLI): 4
   steps, update interval 2: plain steps 0, 1, 3 and a tracking step at
   2; rank 1024, remat full, batch 2 x 512, the CLI's schedule and
   batches: finite losses, launches from the plans (3 per low-rank leaf
   per plain step and 5 per tracking step);
12. continue from that run's state for 4 grad-fused llama-7b steps through
   ``run(..., grad_fused=True)`` (plain 0, 1, 3; tracking 2): finite
   losses, launches from the plans: per plain step 57 grad_tap calls
   (7 sites x 8 layers + lm_head; the count is of calls), 1
   project_colnorms, 9 adam_lowrank_norms and 9 fused_update, the plain
   path's 45 on the tracking step;
13. hold the tracking front end ``project_tangent_colnorms`` and the unfused
   schedule's ``backproject`` and ``recovery`` against their plain versions
   at llama-1b's three canonical shapes (2040, 2048), (2048, 5461) and
   (2048, 32000), rank 512, 2 matrices, G fp32 and bf16 (``FRONT_REL``),
   a ragged case (the three routes printed: the front end with bf16 G on
   wgmma, fp32 G on the CUDA cores; backproject and recovery on wgmma
   always), and llama-7b's (4096, 11008, r 1024), where the front
   end's dispatch takes the project_colnorms + tangent composite (m past
   the kernel's 2048);
14. time the three at (2048, 5461, r 512), bf16 G, 2 matrices, beside their
   bounds (the front end's: A = S^T G and W = G A^T at 3 bf16 passes each,
   its tail's S^T W and S (2C) at 6, its norms in fp32; backproject's and
   recovery's 6 bf16 passes, recovery's epilogue in fp32; the fp32 bound
   beside each), plain versions and PyTorch
   expressions (TF32 off), and the
   front end's single launch against the two-launch composite
   (project_colnorms + the tensor-core tangent) there, on G by element
   loads (w_gate) and by TMA (w_down's
   transposed view) and on a stack of 32; one n-tile and the tail alone;
   the composite at llama-7b's shape;
15. run the unfused ``lowrank_adam_step(lr=None, backend=ops)`` at
   (2048, 5461, r 512) on CUDA and on the CPU from the same state: the same
   step (``UNFUSED_REL``), exactly 1 project, 1 backproject and 1 recovery
   launch on CUDA and none on the CPU;
16. train llama-1b (full width and depth: 32 layers, d 2048, hd 85, d_ff
   5461, rank 512, bf16) through ``repro_torch.launch.train.train``: 4
   steps, update interval 2 (plain 0, 1, 3; tracking 2), batch 4 x 512,
   remat full, eta 10; finite losses, 3 launches per low-rank leaf per plain
   step and 4 on the tracking step (the single-launch front end, then
   project, adam_lowrank_norms, fused_update); warm start, step times,
   tokens/s and peak memory printed;
17. hold ``adam_lowrank`` and ``tangent_gram`` against their plain versions
   at llama-7b's shapes (Adam (1024, 11008) and (1024, 32000), 2 matrices;
   the Gram kernel at (4096, 11008, r 1024) and the row shard (2048, 11008,
   r 1024), 2 matrices, G fp32 and bf16, and a ragged transposed case;
   ``GRAM_REL``; its route printed: the Grams on wgmma always, bf16 G's
   T^T G on wgmma, fp32 G's on the CUDA cores; a second launch gives the
   same bits and T^T T, S^T S are exactly symmetric), drive
   ``ops.adam_lowrank`` once for its launch count, and time both, 2
   matrices (the Gram kernel at (4096, 11008, r 1024), bf16 G, beside its
   bound at 3 + 6 + 6 bf16 passes and its first design's fp32 bound; Adam
   at (1024, 11008)), beside their bounds and plain versions (the Gram
   kernel's plain version is the four torch.matmul expressions with TF32
   off; neither has a single PyTorch call for the library column);
18. run ``track_subspace(schedule="gram", backend=ops)`` at (4096, 11008, r
   1024), bf16 G, 2 matrices: exactly 1 project_colnorms, 1 tangent and 1
   tangent_gram launch; within ``TRACK_REL`` of the CPU's run from the same
   S and G, and of the tangent schedule on the card (S_new as projectors,
   A_new against S_new^T G); both schedules timed;
19. drive ``ops.flash_attention`` at llama-7b's prefill (B 4, S = T = 2048,
   Hq = Hkv = 32, hd 128, causal) and gemma2-27b's local layer (B 1, S = T =
   8192, Hq 32, Hkv 16, hd 128, window 4096, softcap 50) in bf16 and hold it
   against its plain version there and at stablelm-12b's heads (Hq 32, Hkv
   8, hd 160, S = T = 1024), llama-1b's (Hq = Hkv = 24, hd 85), non-causal, S
   512 against T 2048, a ragged S, and one fp32 shape (``FLASH_TOL``),
   the route of each call printed (bf16 on wgmma, fp32 on the CUDA cores);
   time it at the two driven shapes beside its one-pass bound and the
   route's own (Q K^T once, P V once per bf16 term of P), gemma2's also
   without its softcap (the tanh's share), its plain version and one
   PyTorch call held against the plain version (``LIB_TOL``):
   ``scaled_dot_product_attention(is_causal=True)`` at llama-7b's and, at
   gemma2's, ``flex_attention`` compiled with a softcap ``score_mod`` and a
   causal sliding-window block mask;
20. serve phase 6's llama-7b load (the serve CLI's parameters from the
   seed, its prompts) through the dense engine ``run_dense`` and through
   ``run_paged``: every request 64 tokens, no kernel launch in the dense
   engine, the same first token in both, their prefill logits (one 512-token
   pass against four 128-token chunks) within ``DENSE_LOGIT_REL`` of the
   largest with the same argmax; the length of the token prefix on which
   the engines agree printed, not asserted; tok/s, TTFT p50, mean decode
   step and peak memory beside phase 6's;
21. time the fp32-G routes of project, project_colnorms and the front end
   (the CUDA cores) at llama-1b's (2048, 5461, r 512) x 2 and on a
   32-stack, beside their bounds; then, from copies of phase 16's final
   params and state, 4 llama-1b steps (plain 0, 1, 3; tracking 2) each of:
   (a) ``--accum 2 --grad-fused`` through ``run``: the JAX driver's
   fallback line, no grad_tap launch, phase 16's exact launch counts and
   the fp32 routes named; and on one batch accum 2 against accum 1 (loss
   and gradient norm within ``ACCUM_LOSS_REL`` / ``ACCUM_GNORM_REL``);
   (b) remat full, dots and none: exact launch counts, step 0's loss of
   dots within ``REMAT_LOSS_REL`` of full's, step times and peaks
   printed; (c) ``method="grass"`` with its own warm start: S one-hot in
   every low-rank leaf after the warm start and after the tracking step,
   2 launches per leaf on every step (adam_lowrank_norms, fused_update:
   its projection is the grass program's ``sel_gather`` round, a gather
   of G's rows); (d) AdamW and BAdam: no launch,
   peaks and ``state_bytes`` beside the low-rank run's;
22. the runtime around llama-1b's step, from phase 16's final state (after
   its step 3), in a temporary directory whose free disk is printed first
   and which is deleted at the end (each checkpoint ~7.9 GB): (a) save it
   as a known-good checkpoint (snapshot, write and restore seconds and
   bytes printed) and restore it bit for bit; (b) one plain and one
   tracking step with ``nan-grad``: quarantined, every param and state
   tensor ``torch.equal``, launch counts those of a healthy step; (c) a
   tracking step with sigma-blowup: theta clamped to ``THETA_MAX``, not
   quarantined (the eta-10 step's health printed beside it); (a, d, f) one
   CLI run (``--steps 14``) resuming from the checkpoint with no warm
   start, ``--inject ckpt-io-error@4,loss-spike@9``: exactly one rollback,
   to step 3, a finite final loss, the final save landing after two failed
   attempts, exact launch counts for the steps run; (e) a run failed at
   step 6 (a checkpoint at 5) and restarted: steps 6-9 within
   ``RESTART_RTOL`` of (d)'s uninterrupted losses; the phase's time
   printed;
23. the multi-GPU StepPrograms at group size 1 on a one-rank NCCL group
   (NCCL refuses two ranks on one device, so every round is an identity
   here; runs of 2 and 4 ranks are held on the CPU over gloo), from phase
   11's final llama-7b state, which phase 12 then continues: from one
   clipped gradient of the stream's next batch, (a) the row programs
   (every low-rank leaf's canonical m on the ``model`` axis), (b) row-rs
   and (c) column, one plain and one tracking optimizer step each at eta
   ``MESH_ETA``, leaf by leaf beside the replicated program's on the same
   state: exact launch counts (a row-family tracking step launches
   tangent_gram once per leaf and project never), updates and S, M, V
   within ``MESH_REL``, step times beside the replicated program's and
   phase 11's, tangent_gram's share; (d) the bf16 smoke llama through
   ``torchrun --nproc-per-node 1 -m repro_torch.launch.train --mesh
   host`` and through ``--mesh smoke``: the same losses and launches; the
   phase's time printed;
24. the decoder family's variants, gemma2-27b (local/global windows,
   softcaps, sandwich norms, GeGLU, tied and scaled embeddings),
   minicpm3-4b (MLA) and qwen2-vl-2b (M-RoPE, QKV bias, the vision stub):
   (a) hold project_colnorms, tangent, project, adam_lowrank_norms and
   fused_update at gemma2's embedding (4608, 256000, r 512, its G a
   transposed view) and w_gate stack (4608, 36864, r 512) x 2, the front
   end at minicpm3's (768, 2560 / 3840, r 512) x 2 and qwen2-vl's
   embedding (1536, 152064, r 256), and grad_tap at gemma2's w_gate with
   b 5120, bf16 G, against their plain versions (``OPT_REL``,
   ``FRONT_REL``, ``TAP_REL``), each timed beside its bound and its plain
   version, and time the warm start's SVD of the embedding (QR to its R
   factor first: gesvd refuses the whole matrix); (b) train each fp32
   smoke config 4 steps (rank 32, interval 2) through ``run`` on CUDA and
   on the CPU from the same params, warm state and batches, plain and
   grad-fused: losses within ``SMOKE_LOSS_ATOL``, exact launch counts
   from the plans (``_plan_launches``); (c) each config at full width and
   ``VARIANT_LAYERS`` layers (the cut printed; gemma2 one local and one
   global layer, 2.31 B params) through ``run``, 4 steps at interval 2,
   default rank, kernels on, eta pinned: gemma2 batch 1 x 5120 (past its
   4096 window), minicpm3 2 x 512, qwen2-vl 2 x 2048: finite losses,
   exact launch counts from the plans, warm start, step times, tok/s and
   peak printed; (d) serve each from its trained weights through
   ``run_dense``, 2 requests of the prompt length above + 16 tokens, then
   teacher-force 16 tokens after the prompt and hold the decode logits
   against the full forward's on the card with the JAX package's
   criteria (``tests/test_models.py``: argmax agreement >= 0.9, p90
   |delta| < 0.12 scale + 0.12); tok/s, TTFT and the phase's time
   printed;
25. the Mixture-of-Experts configs, mixtral-8x22b (8 experts top-2, the
   4096 window on every layer, served from the ring cache) and
   llama4-maverick-400b-a17b (128 experts top-1 and a shared expert): the
   optimizer kernels (project_colnorms, tangent, project,
   adam_lowrank_norms, fused_update) at mixtral's expert stacks, 8 x
   (6144, 16384, r 1024) for w_gate / w_up and w_down's transposed view,
   bf16 G, against their plain versions (``OPT_REL``) and timed beside
   their bounds; (a) each fp32 smoke config on CUDA against the CPU from
   the same params: the loss and every gradient within ``MOE_GRAD_REL``,
   4 steps through ``run`` plain and grad-fused (``SMOKE_LOSS_ATOL``,
   exact launches from the plans), and mixtral's dense decode through a
   ring cut to 16 slots against the full forward (``MOE_DECODE_REL``);
   (b) mixtral at full width and ``MOE_LAYERS`` layer (the cut printed)
   through ``run``, batch 1 x 6144, 4 steps at interval 2, default rank
   1024, eta pinned: exact launches from the plans, warm start, step
   times, tok/s, peak, the aux loss and the token slots dropped at
   capacity; (c) its weights through ``run_dense``, one request of 4200 +
   16 (past T = 4096: the ring's roll) and one of 512 + 16, then the long
   one teacher-forced against the full forward with phase 24's criteria
   where no choice of a position was dropped at capacity (the positions
   left out printed), and beside it the same weights and tokens at
   capacity factor E / top_k (C = N: no slot drops, asserted) with the
   ring decode's logits held against the full forward at every position;
   (d) llama4-maverick at full width and one layer
   (36.8 GB bf16; its full depth's training does not fit the card, which
   is printed) through the paged and the dense engine on one set of
   weights: paged_attention launched once per layer per decode wave, the
   same first token on both engines wherever neither prefill dropped the
   prompt's last position, tok/s, TTFT, decode ms and peaks printed; and
   paged_attention timed at maverick's decode shape beside its bound;
26. zamba2-7b (81 Mamba2 layers with the SSD, a weight-shared attention
   + MLP block after every 9): (a) project_colnorms, tangent, project,
   adam_lowrank_norms and fused_update at its in_proj stack 18 x (3584,
   14576, r 512) and out_proj's, stored (7168, 3584) and taken as its
   transposed view, bf16 G, against their plain versions (``OPT_REL``),
   timed beside their bounds, plain versions and phase 8's PyTorch
   yardsticks; (b) the fp32 smoke config on CUDA against the CPU from
   the same params: the loss and every gradient within
   ``ZAMBA_SMOKE_REL``, 4 steps through ``run`` (``--grad-fused`` asked
   for: the JAX package's fallback) within ``SMOKE_LOSS_ATOL`` with exact
   launches from the plans, prefill within ``ZAMBA_SMOKE_REL`` and 3
   decode steps, each from the CPU's cache, within it where the new conv
   entries round to the same bf16 values, else ``ZAMBA_DECODE_REL``; (c)
   full width and ``ZAMBA_LAYERS`` = 18 layers (2 groups, 1.86 B params)
   through ``run``: 4 steps at interval 2, default rank 512, eta pinned,
   batch 1 x 4096: finite, unquarantined, exact launches from the plans,
   warm start (46 SVDs), step times, tok/s and peak printed; (d) its
   trained weights through ``run_dense``: 2 requests of 2048 + 16 and 1
   of 8192 + 16 (decode ms and the cache's bytes printed: the Mamba
   states, the same at any length, and the shared K/V, which grow), the
   2048 + 16 teacher-forced against ``zamba_forward`` (phase 24's
   criteria) and the SSD states of prefill(2048) + 16 decode steps
   against prefill(2064)'s (``ZAMBA_STATE_REL``);
27. xlstm-125m (9 mLSTM and 3 sLSTM blocks): (a) project_colnorms, the
   single-launch front end project_tangent_colnorms, project,
   adam_lowrank_norms and fused_update at the sLSTM's R stack, 3 x 4 x
   (192, 768, r 128) (m not a multiple of the 128-row tiles), and the
   embedding's (768, 50432, r 128) view, bf16 G, against their plain
   versions (``OPT_REL``, ``FRONT_REL``), timed beside their bounds,
   plain versions and phase 8's PyTorch yardsticks; (b) the fp32 smoke
   config on CUDA against the CPU from the same params: the loss and
   every gradient within ``XLSTM_GRAD_REL``, 4 steps through ``run`` at
   rank 16 (``--grad-fused`` asked for: the fallback) within
   ``SMOKE_LOSS_ATOL`` with exact launches from the plans, prefill and 3
   decode steps, each from the CPU's cache, within ``FAMILY_SMOKE_REL``
   where the new conv entries round to the same bf16 values, else
   ``XLSTM_DECODE_REL``, and the bf16 smoke (the served dtype) the same
   way within ``XLSTM_BF16_PREFILL_REL`` and ``XLSTM_BF16_DECODE_REL``;
   planted faults (the sLSTM bias in the other layout, a conv window not
   advanced, an mLSTM stabiliser off by one) read past each budget;
   (c) full width and depth (12 blocks, 0.19 B params) through ``run``:
   4 steps at interval 2, default rank 128, eta pinned, batch 4 x 1024:
   finite, unquarantined, exact launches from the plans, warm start, step
   times, tok/s and peak printed, and the sLSTM's sequential loop timed
   alone beside the step; (d) its trained weights through ``run_dense``:
   2 requests of 2048 + 16 (decode ms and the cache's bytes, the same at
   any length), and the bf16 decode teacher-forced against
   ``xlstm_forward`` (agreement ``XLSTM_AGREE``, phase 24's p90) with the
   states of prefill(2048) + 16 decode steps against prefill(2064)'s,
   each stabilised pair at one stabiliser, within ``XLSTM_STATE_REL``;
   the planted faults must fail these;
28. seamless-m4t-large-v2 (24 + 24 layers, the speech front end a stub
   of frame embeddings): (a) the same five kernels at the embedding's
   (1024, 256256, r 256) view and the w_gate stack, ``SEAMLESS_LAYERS``
   x (1024, 8192, r 256), bf16 G, as 27 (a), and the warm start's SVD of
   the embedding timed; (b) the fp32 smoke config as 27 (b) at rank 32,
   the loss and gradients within ``FAMILY_SMOKE_REL``, prefill and
   decode within ``FAMILY_SMOKE_REL``; (c) full width and
   ``SEAMLESS_LAYERS`` = 6 encoder + 6 decoder layers (0.90 B params)
   through ``run``: 4 steps at interval 2, default rank 256, eta pinned,
   batch 2 x 2048 frames and tokens, the checks and prints of 27 (c);
   (d) its trained weights through ``run_dense``: 2 requests of 1024 +
   16 on zero frames (the self and cross K/V bytes printed),
   teacher-forced against ``encode`` + ``decode_train`` (phase 24's
   criteria);
29. print the kernels line (project, project_colnorms and the front end
   with their fp32 routes' times as ``fp32_ms``; tangent_gram's launches
   those of phase 23's row tracking step; each kernel's phase-24 to -28
   shapes and its launches in those phases' runs), then
   ``{"ok": true, "device": {...}}`` last.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the compiled flex_attention yardstick (phase 19) keeps its caches in the
# checkout's git-ignored build directory and compiles in this process
for _var, _val in (("TORCHINDUCTOR_CACHE_DIR", ROOT / "build" / "inductor"),
                   ("TRITON_CACHE_DIR", ROOT / "build" / "triton"),
                   ("TORCHINDUCTOR_COMPILE_THREADS", 1)):
    os.environ.setdefault(_var, str(_val))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 on the tensor cores
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


def _graph_ms(fn, iters, repeats=5) -> float:
    """Median over ``repeats`` of the mean time of ``iters`` calls captured
    in one CUDA graph and replayed, by CUDA events: the device's time for
    the calls without the host's (Python, ctypes) between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(times)[len(times) // 2]


def _profiler_ms(fn, iters) -> float:
    """Device time of ``iters`` eager calls per call: the sum of the CUDA
    kernels' durations in a ``torch.profiler`` trace (no gaps between
    them, whoever launched them)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / iters


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
    report = build.build(["paged_attention", "grassmann_project",
                          "grassmann_tangent", "adam_lowrank_norms",
                          "fused_update", "grad_tap",
                          "grassmann_tangent_front", "grassmann_backproject",
                          "grassmann_tangent_gram", "flash_attention"])
    for name, r in report.items():
        regs = [ln.strip() for ln in r["ptxas"].splitlines() if "Used" in ln]
        print(f"[build] {name}.cu: nvcc {r['seconds']:.1f}s; {regs}",
              flush=True)
    print(f"[build] all kernels ready in {time.perf_counter() - t0:.1f}s "
          f"({len(report)} compiled, sm_90a)", flush=True)


def phase_check_paged_attention() -> float:
    """Kernel vs oracle at every case, at the wrapper's split count and at
    forced ones; returns the max abs error at the llama-7b bf16 shape (the
    one timed)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention

    # name -> (B, Hq, Hkv, hd, bs, lengths, forced split count or None)
    cases = {
        "llama-7b": (8, 32, 32, 128, 16, [576] * 8, None),
        "stablelm-12b": (8, 32, 8, 160, 16, [576] * 8, None),
        "llama-1b hd 85": (8, 24, 24, 85, 16, [576] * 8, None),
        "dead-lane+partial": (4, 32, 8, 128, 16, [0, 1, 300, 576], None),
        # 3 splits of 12 words = 192 positions: no length a multiple of it
        "lengths across split ranges": (4, 32, 8, 128, 16,
                                        [500, 333, 575, 129], 3),
        "one short among long": (8, 32, 32, 128, 16, [576] * 7 + [17], 4),
        "more splits than blocks": (4, 24, 24, 85, 16, [100, 5, 0, 64], 11),
        "llama-7b, 5 splits": (8, 32, 32, 128, 16, [576] * 8, 5),
    }
    err_7b = math.nan
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (B, Hq, Hkv, hd, bs, lens, splits)) in enumerate(
                cases.items()):
            args = _paged_case(B, Hq, Hkv, hd, bs, lens, dtype, SEED + i)
            got = paged_attention(*args, splits=splits)
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
            print(f"[check] paged_attention {name} {dtype}, splits "
                  f"{splits or 'chosen'}: max abs err {err:.3e} (atol "
                  f"{TOL[dtype]['atol']:g}, rtol {TOL[dtype]['rtol']:g})",
                  flush=True)
    # a broken table word (one lane) and a length past the table (another)
    # give NaN there and only there, whichever split meets them
    for splits in (None, 1, 2, 3):
        q, kp, vp, tables, lens = _paged_case(3, 32, 8, 128, 16, [200] * 3,
                                              torch.bfloat16, SEED)
        tables[1, 9] = kp.shape[0]                  # one past the pool
        lens[2] = tables.shape[1] * 16 + 1
        out = paged_attention(q, kp, vp, tables, lens, splits=splits)
        torch.cuda.synchronize()
        if not (torch.isnan(out[1:].float()).all()
                and torch.isfinite(out[0].float()).all()):
            raise AssertionError(f"paged_attention, splits {splits}: a "
                                 "broken table or length is not NaN")
    print("[check] paged_attention broken table word and length past the "
          "table: NaN in their lanes only (splits chosen, 1, 2, 3)",
          flush=True)
    return err_7b


def _paged_times(B, Hq, Hkv, hd, bs, L, label) -> dict:
    """paged_attention, its plain version and the SDPA yardstick at one
    decode shape in bf16 (every lane at length L); the bound from this
    run's inputs.  Printed under ``label``."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention

    dtype = torch.bfloat16
    args = _paged_case(B, Hq, Hkv, hd, bs, [L] * B, dtype, SEED)
    q, kp, vp, tables, lens = args
    W = tables.shape[1]
    splits = pa.choose_splits(B, Hkv, W, bs, pa._capacity(1, hd, 1, 0))
    # yardstick: the same attention over K/V gathered beforehand (not timed)
    kg = kp[tables.long()].reshape(B, W * bs, Hkv, hd)[:, :L].transpose(
        1, 2).contiguous()
    vg = vp[tables.long()].reshape(B, W * bs, Hkv, hd)[:, :L].transpose(
        1, 2).contiguous()
    q4 = q[:, :, None, :]

    def kernel():
        return paged_attention(*args)

    def sdpa():
        return F.scaled_dot_product_attention(q4, kg, vg,
                                              enable_gqa=Hq != Hkv)

    got = kernel()
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    err = (got.float() - want.float()).abs().max().item()
    # at tens of microseconds a launch, an eager loop times the host: the
    # kernel and SDPA are timed alike, in a CUDA graph of 200 calls (the
    # table's method) and by the profiler's device time; eager for reference
    ms, library_ms = _graph_ms(kernel, iters=200), _graph_ms(sdpa, iters=200)
    dev_ms, dev_lib = _profiler_ms(kernel, 200), _profiler_ms(sdpa, 200)
    eager_ms, eager_lib = _time_ms(kernel, 200), _time_ms(sdpa, 200)
    plain_ms = _time_ms(lambda: ref.paged_attention_ref(*args), iters=20)
    torch.testing.assert_close(sdpa()[:, :, 0].float(), want.float(),
                               **TOL[dtype])

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
           "bytes": nbytes, "splits": splits, "timing": "cuda graph",
           "profiler_ms": dev_ms, "library_profiler_ms": dev_lib,
           "max_abs_err": err, "shape": [B, Hq, Hkv, hd, bs, L]}
    print(f"[time] paged_attention {label} bf16 (B {B}, Hq {Hq} / Hkv "
          f"{Hkv}, hd {hd}, length {L}), {splits} splits: kernel {ms:.4f} "
          f"ms (CUDA graph of 200; profiler device time {dev_ms:.4f}, eager "
          f"loop {eager_ms:.4f}), bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}, {nbytes / 1e6:.1f} MB), plain "
          f"{plain_ms:.4f} ms (eager), sdpa over gathered K/V "
          f"{library_ms:.4f} ms (CUDA graph; profiler {dev_lib:.4f}, eager "
          f"{eager_lib:.4f}); max abs err {err:.3e}", flush=True)
    return out


def phase_time_paged_attention() -> dict:
    """Kernel, plain version and the SDPA yardstick at the llama-7b decode
    shape in bf16; the bound from this run's inputs."""
    from repro_torch.kernels.paged_attention import paged_attention

    B, Hq, Hkv, hd, bs, L = 8, 32, 32, 128, 16, 576
    out = _paged_times(B, Hq, Hkv, hd, bs, L, "llama-7b decode")
    args = _paged_case(B, Hq, Hkv, hd, bs, [L] * B, torch.bfloat16, SEED)
    for forced in (1, 2, 4, 6):
        print(f"[time] paged_attention llama-7b decode bf16, {forced} splits "
              f"forced: {_graph_ms(lambda: paged_attention(*args, splits=forced), 200):.4f} ms "
              "(CUDA graph)", flush=True)
    # the same bytes with one KV head (B 256): each table block is 4 KB of
    # contiguous rows instead of 256-byte rows 8 KB apart
    one = _paged_case(B * Hkv, 1, 1, hd, bs, [L] * B * Hkv, torch.bfloat16,
                      SEED)
    print(f"[time] paged_attention, the same bytes as (B 256, Hkv 1): "
          f"{_graph_ms(lambda: paged_attention(*one), 200):.4f} ms (CUDA "
          "graph)", flush=True)
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
    return {"launches": launches, "decode_calls": out["decode_calls"],
            "tok_per_s": out["tok_per_s"], "ttft_p50_s": out["ttft_p50_s"],
            "decode_wave_ms_mean": out["decode_wave_ms_mean"],
            "peak_gib": peak / 2**30}


# ---------------------------------------------------------------------------
# The training slice: optimizer kernels and the train step
# ---------------------------------------------------------------------------

OPT_KERNELS = {   # name -> (CUDA source, def line of the TPU kernel)
    "project": ("grassmann_project.cu", 117),
    "project_colnorms": ("grassmann_project.cu", 274),
    "tangent": ("grassmann_tangent.cu", 192),
    "adam_lowrank_norms": ("adam_lowrank_norms.cu", 696),
    "fused_update": ("fused_update.cu", 558),
}
# max |kernel - plain| over max |plain|: fp32 sums of 4096 to 32000 terms in
# another order; the tangent's two terms cancel.  A bf16 update may also
# differ by one bf16 ulp where the two fp32 values round apart.
OPT_REL = {"project": 2e-5, "project_colnorms": 2e-5, "tangent": 1e-4,
           "adam_lowrank_norms": 2e-5, "fused_update": 2e-5}
OPT_SHAPES = [(4096, 4096), (4096, 11008), (4096, 32000)]
PROJ_SHAPES = {   # name -> (m, n, r, G a transposed view): both producers
    "llama-1b w_gate (2048, 5461, r 512)": (2048, 5461, 512, False),
    "llama-1b w_down view (2048, 5461, r 512)": (2048, 5461, 512, True),
    "ragged (1000, 777, r 129)": (1000, 777, 129, False),
    "ragged view (1000, 777, r 129)": (1000, 777, 129, True),
}
PROJ_PASSES = 3   # bf16 G: S_hi, S_mid, S_lo through the tensor cores


def _tc_work(name, m, n, r, b):
    """The tensor-core kernels' operations at (m, n, r) x b: ([(bf16 passes,
    operations of one pass)], operations left on the fp32 CUDA cores).  The
    projections: 3 passes (S's terms against G), their norms' squares in
    fp32; the fused update: 6 (the term products of S and D of order >=
    2^-16), its epilogue in fp32; the tangent: W = G A^T 3 passes (G
    against A's terms), S (2C) and C = A A^T 6 each, C's upper triangle
    only (r (r + 1) n: symmetric, mirrored); the front end: A = S^T G and
    W = G A^T 3 passes each, its tail's S^T W and S (2C) 6 each, its norms
    and -2 W in fp32; backproject: 6 (S's and X's terms), its epilogue a
    store; recovery: backproject's 6, its epilogue (g - s) phi in fp32;
    tangent_gram: T^T G 3 passes (T's terms against bf16 G), S^T T and the
    upper triangles of T^T T and S^T S (2 m r (r + 1) together) 6 each."""
    mma = b * 2 * r * m * n
    return {"project": ([(PROJ_PASSES, mma)], 0),
            "backproject": ([(6, mma)], 0),
            "recovery": ([(6, mma)], b * 2 * m * n),
            "tangent_gram": ([(3, mma), (6, b * 2 * m * r * r),
                              (6, b * 2 * m * r * (r + 1))], 0),
            "project_tangent_colnorms": ([(3, mma), (3, mma),
                                          (6, b * 2 * m * r * r),
                                          (6, b * 2 * m * r * r)],
                                         b * (2 * m * n + 2 * m * r)),
            "project_colnorms": ([(PROJ_PASSES, mma)], b * 2 * m * n),
            "fused_update": ([(6, mma)], b * (2 * r * n + 3 * m * n)),
            "tangent": ([(3, mma), (6, b * 2 * m * r * r),
                         (6, b * r * (r + 1) * n)], 0)}.get(name)


def _kernel_ms_by_name(fn, iters=3) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches, by name,
    from a ``torch.profiler`` trace of ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}
UPDATE_VARIANTS = [(True, False), (True, True), (False, False),
                   (False, True)]   # (recovery, decay); the first is timed
RANK_7B = 1024
# phases 11, 12 and 23 train llama-7b at full width and this many of its 32
# layers (the warm start's SVDs, 7 per layer and 2, dominate the script)
LAYERS_7B = 8
TIMED = (4096, 11008)
SMOKE_LOSS_ATOL = 1e-4   # fp32 smoke llama, 6 steps, CUDA vs CPU sum orders
N_LOWRANK_LEAVES = 9     # wq wk wv wo w_gate w_up w_down embed lm_head
N_UNTAPPED_LOWRANK = 1   # embed: a lookup, not a matmul the backward can tap


def _opt_inputs(m, n, r, gdtype, seed, transposed=False):
    """A batch of 2 matrices: orthonormal S, G in ``gdtype`` (a transposed
    view of (2, n, m) storage if asked), Adam states, phi and two different
    per-matrix clips, all on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return dict(S=torch.linalg.qr(rn(2, m, r))[0].contiguous(),
                G=(rn(2, n, m).to(gdtype).mT if transposed
                   else rn(2, m, n).to(gdtype)), M=0.1 * rn(2, r, n),
                V=0.01 * rn(2, r, n).abs(), phi=rn(2, n).abs(),
                clip=torch.tensor([0.9, 0.25], device="cuda"))


def _opt_calls(x, impl):
    """name -> zero-argument call of ``impl`` (the kernel wrappers or the
    plain versions) on the inputs ``x``; A and Gto come from the plain
    versions so every kernel sees the same operands."""
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ref

    S, G, M, V, phi, clip = (x[k] for k in ("S", "G", "M", "V", "phi",
                                            "clip"))
    A, _ = ref.project_colnorms_ref(S, G)
    Gto = ref.adam_lowrank_norms_ref(A, M, V, 3, 0.9, 0.999, 1e-8)[2]
    if impl == "kernel":
        return {
            "project": lambda: gk.project(S, G),
            "project_colnorms": lambda: gk.project_colnorms(S, G),
            "tangent": lambda: gk.tangent(G, A, S),
            "adam_lowrank_norms": lambda: gk.adam_lowrank_norms(A, M, V, 3),
            "fused_update": lambda: gk.fused_update(
                G, S, A, Gto, phi, 0.01, clip, out_dtype=G.dtype)}
    return {
        "project": lambda: ref.project_ref(S, G),
        "project_colnorms": lambda: ref.project_colnorms_ref(S, G),
        "tangent": lambda: ref.tangent_ref(G, A, S),
        "adam_lowrank_norms": lambda: ref.adam_lowrank_norms_ref(
            A, M, V, 3, 0.9, 0.999, 1e-8),
        "fused_update": lambda: ref.fused_update_ref(
            G, S, A, Gto, phi, 0.01, clip, out_dtype=G.dtype)}


def _update_calls(x, recovery, decay):
    """(kernel call, plain call) of fused_update on ``x`` in one variant:
    the update in G's dtype; with decay a parameter of that dtype, stored
    like G (a transposed view when G is one), and per-matrix decays."""
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ref

    S, G, M, V, phi, clip = (x[k] for k in ("S", "G", "M", "V", "phi",
                                            "clip"))
    A, _ = ref.project_colnorms_ref(S, G)
    Gto = ref.adam_lowrank_norms_ref(A, M, V, 3, 0.9, 0.999, 1e-8)[2]
    param = (torch.empty_like(G).copy_(0.1 * G.float().flip(-1))
             if decay else None)
    kw = dict(out_dtype=G.dtype, param=param,
              wd_coef=torch.tensor([1e-3, 5e-3], device="cuda")
              if decay else None)
    args = ((G, S, A, Gto, phi, 0.01, clip) if recovery
            else (None, S, None, Gto, None, 0.01, 1.0))
    return (lambda: gk.fused_update(*args, **kw),
            lambda: ref.fused_update_ref(*args, **kw))


def _opt_error(got, want) -> tuple[float, float]:
    """(max abs error, max error over the largest entry); for a bf16 output
    the first bf16 ulp of each entry is forgiven in the second."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_err, rel = 0.0, 0.0
    for g, w in zip(got, want):
        bf16 = g.dtype == torch.bfloat16
        g, w = g.float(), w.float()
        d = (g - w).abs()
        abs_err = max(abs_err, d.max().item())
        if bf16:
            _, e = torch.frexp(w)
            ulp = torch.where(w == 0, torch.zeros_like(w),
                              torch.ldexp(torch.ones_like(w), e - 8))
            d = torch.clamp_min(d - ulp, 0.0)
        rel = max(rel, (d.max() / w.abs().max().clamp_min(1e-30)).item())
    return abs_err, rel


def _want_route(name, dtype, route):
    """bf16 G takes the tensor cores, fp32 G the CUDA cores; the fused
    update, backproject and recovery take the tensor cores for every
    dtype (tangent_gram's fp32 route ``cuda-cores-ttg`` names its T^T G
    tiles; its Grams run on the tensor cores)."""
    want = ("wgmma" if dtype == torch.bfloat16
            or name in ("fused_update", "backproject", "recovery")
            else "cuda-cores")
    if not route.startswith(want):
        raise AssertionError(f"{name} with {dtype} G took route {route}")


def _check_updates(x, label, dtype, variants) -> list[str]:
    """fused_update in each of ``variants`` against its plain version on
    ``x``, route printed; raises past ``OPT_REL``."""
    from repro_torch.kernels import grassmann as gk

    line = []
    for recovery, decay in variants:
        kern, plain = _update_calls(x, recovery, decay)
        got = kern()
        torch.cuda.synchronize()
        route = gk.fused_update.route
        _want_route("fused_update", dtype, route)
        abs_err, rel = _opt_error(got, plain())
        if rel > OPT_REL["fused_update"]:
            raise AssertionError(
                f"fused_update (recovery {recovery}, decay {decay}) at "
                f"{label} {dtype}: error {rel:.3e} of the largest entry > "
                f"{OPT_REL['fused_update']:g}")
        line.append(f"update{'+rec' if recovery else ''}"
                    f"{'+wd' if decay else ''} {abs_err:.2e} ({rel:.1e})")
        del got
    return line + [f"update route {route}"]


def phase_check_optimizer() -> dict:
    """Every optimizer kernel against its plain version at the three 7b
    matrix shapes, G fp32 and bf16 (the update in G's dtype, all four
    variants); project, project_colnorms and fused_update also at
    ``PROJ_SHAPES`` (both producers of the projections' bf16 route), and
    the bf16 splits of S and of the update's direction D bit for bit.
    Returns name -> max abs error at the timed shape in bf16."""
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ref

    errs = {}
    for i, (m, n) in enumerate(OPT_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x = _opt_inputs(m, n, RANK_7B, dtype, SEED + i)
            kern, plain = _opt_calls(x, "kernel"), _opt_calls(x, "plain")
            line = []
            for name in OPT_KERNELS:
                got = kern[name]()
                torch.cuda.synchronize()
                abs_err, rel = _opt_error(got, plain[name]())
                if rel > OPT_REL[name]:
                    raise AssertionError(
                        f"{name} at ({m}, {n}, r {RANK_7B}) {dtype}: error "
                        f"{rel:.3e} of the largest entry > {OPT_REL[name]:g}")
                if (m, n) == TIMED and dtype == torch.bfloat16:
                    errs[name] = abs_err
                line.append(f"{name} {abs_err:.2e} ({rel:.1e})")
            for name in ("project", "project_colnorms", "tangent",
                         "fused_update"):
                _want_route(name, dtype, getattr(gk, name).route)
            line += _check_updates(x, f"({m}, {n}, r {RANK_7B})", dtype,
                                   UPDATE_VARIANTS[1:])
            # the tangent on the same G stored transposed (a canonical
            # w_down or wo view: the MN-major route for bf16 G)
            S, Gv = x["S"], x["G"].mT.contiguous().mT
            A = ref.project_ref(S, Gv)
            got = gk.tangent(Gv, A, S)
            torch.cuda.synchronize()
            route = gk.tangent.route
            _want_route("tangent", dtype, route)
            abs_err, rel = _opt_error(got, ref.tangent_ref(Gv, A, S))
            if rel > OPT_REL["tangent"]:
                raise AssertionError(
                    f"tangent at ({m}, {n}, r {RANK_7B}) {dtype}, G a "
                    f"transposed view ({route}): error {rel:.3e} of the "
                    f"largest entry > {OPT_REL['tangent']:g}")
            line.append(f"tangent on a transposed view {abs_err:.2e} "
                        f"({rel:.1e}) by {route}")
            del x, kern, plain, S, Gv, A, got
            print(f"[check] ({m}, {n}, r {RANK_7B}) x2 {dtype}: max abs err "
                  f"(of largest entry) " + ", ".join(line) + "; project "
                  f"route {gk.project.route}", flush=True)
    for i, (label, (m, n, r, transposed)) in enumerate(PROJ_SHAPES.items()):
        for dtype in (torch.float32, torch.bfloat16):
            x = _opt_inputs(m, n, r, dtype, SEED + 10 + i, transposed)
            S, G = x["S"], x["G"]
            line = []
            for name in ("project", "project_colnorms"):
                got = getattr(gk, name)(S, G)
                torch.cuda.synchronize()
                route = getattr(gk, name).route
                _want_route(name, dtype, route)
                abs_err, rel = _opt_error(
                    got, getattr(ref, f"{name}_ref")(S, G))
                if rel > OPT_REL[name]:
                    raise AssertionError(
                        f"{name} at {label} {dtype} ({route}): error "
                        f"{rel:.3e} of the largest entry > {OPT_REL[name]:g}")
                line.append(f"{name} {abs_err:.2e} ({rel:.1e}) by {route}")
            A = ref.project_ref(S, G)
            got = gk.tangent(G, A, S)
            torch.cuda.synchronize()
            route = gk.tangent.route
            _want_route("tangent", dtype, route)
            abs_err, rel = _opt_error(got, ref.tangent_ref(G, A, S))
            if rel > OPT_REL["tangent"]:
                raise AssertionError(
                    f"tangent at {label} {dtype} ({route}): error {rel:.3e} "
                    f"of the largest entry > {OPT_REL['tangent']:g}")
            line.append(f"tangent {abs_err:.2e} ({rel:.1e}) by {route}")
            del got, A
            line += _check_updates(x, label, dtype, UPDATE_VARIANTS)
            if dtype == torch.bfloat16:
                if not torch.equal(gk.split_bf16(S), ref.split_bf16_ref(S)):
                    raise AssertionError(f"split_bf16 at {label}: not bit "
                                         "for bit its plain version")
                D = (x["M"], 0.5 * x["M"].flip(-1).contiguous(), x["phi"],
                     x["clip"])
                for args in (D, (D[0], None, None, D[3])):
                    if not torch.equal(gk.split_direction(*args),
                                       ref.split_direction_ref(*args)):
                        raise AssertionError(
                            f"split_direction at {label}: not bit for bit "
                            "its plain version")
            del x, S, G
            print(f"[check] {label} x2 {dtype}: max abs err (of largest "
                  f"entry) " + ", ".join(line)
                  + ("; splits of S and D bit for bit"
                     if dtype == torch.bfloat16 else ""), flush=True)
    return errs


def phase_time_optimizer() -> dict:
    """Each optimizer kernel at (4096, 11008, r 1024), 2 matrices, bf16 G,
    beside its bound, its plain version and the PyTorch yardstick (all by
    CUDA events over eager calls).  project, project_colnorms, tangent and
    fused_update run on the bf16 tensor cores: their bound counts their
    bf16 products at the bf16 peak (``_tc_work``; the fp32 CUDA-core bound
    of their first designs is kept beside it); the fp32 Gram that tangent's
    first design formed is timed beside it; project_colnorms is also timed
    at llama-1b's (2048, 5461, r 512) on both producers."""
    from repro_torch.kernels import grassmann as gk

    m, n = TIMED
    r, b, g = RANK_7B, 2, 2          # matrices, bytes per bf16 element
    x = _opt_inputs(m, n, r, torch.bfloat16, SEED)
    kern, plain = _opt_calls(x, "kernel"), _opt_calls(x, "plain")
    S, G = x["S"], x["G"]
    A = plain["project"]()
    # the update's product as one PyTorch call: baddbmm(G phi clip, S, D)
    # with D = Gto - (phi clip) Gt formed beforehand (TF32 off)
    phic = x["phi"] * x["clip"][:, None]
    Gto = _opt_calls(x, "plain")["adam_lowrank_norms"]()[2]
    D = Gto - phic[:, None, :] * A
    Gphic = G.float() * phic[:, None, :]
    library = {"project": lambda: S.mT @ G.float(),
               "tangent": lambda: -2.0 * (G.float() @ A.mT)
               + 2.0 * (S @ (A @ A.mT)),
               "fused_update": lambda: torch.baddbmm(Gphic, S, D)}
    # bytes each function must move (inputs once, outputs once) and the
    # fp32 operations it needs, per the whole batch
    work = {
        "project": (b * (4 * m * r + g * m * n + 4 * r * n),
                    b * 2 * r * m * n),
        "project_colnorms": (b * (4 * m * r + g * m * n + 4 * r * n + 4 * n),
                             b * (2 * r * m * n + 2 * m * n)),
        "tangent": (b * (g * m * n + 4 * r * n + 8 * m * r),
                    b * (2 * r * m * n + 2 * r * r * n + 2 * m * r * r)),
        "adam_lowrank_norms": (b * (24 * r * n + 8 * n), b * 16 * r * n),
        "fused_update": (b * (2 * g * m * n + 4 * m * r + 8 * r * n + 4 * n
                              + 12),
                         b * (2 * r * m * n + 2 * r * n + 3 * m * n)),
    }
    out = {}
    for name in OPT_KERNELS:
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = t_fp32 = flops / FP32_FLOPS * 1e3
        tc = _tc_work(name, m, n, r, b)
        if tc:  # the products on the bf16 tensor cores, the rest in fp32
            t_ops = (sum(p * f for p, f in tc[0]) / BF16_FLOPS
                     + tc[1] / FP32_FLOPS) * 1e3
        res = {"ms": _time_ms(kern[name], iters=10, repeats=3),
               "plain_ms": _time_ms(plain[name], iters=10, repeats=3),
               "library_ms": (_time_ms(library[name], iters=10, repeats=3)
                              if name in library else None),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops}
        out[name] = res
        lib = ("-" if res["library_ms"] is None
               else f"{res['library_ms']:.4f} ms")
        how = f"{flops / 1e9:.1f} GFLOP fp32"
        if tc:
            route = getattr(gk, name).route
            if not route.startswith("wgmma-tma"):
                raise AssertionError(f"timed {name} took route {route}")
            res["bound_fp32_ms"] = max(t_bytes, t_fp32)
            res["kernel_route"] = route
            how = (" + ".join(f"{p} x {f / 1e9:.1f}" for p, f in tc[0])
                   + f" GFLOP in bf16 passes at the bf16 peak, "
                   f"{tc[1] / 1e9:.2f} fp32; fp32 CUDA-core bound "
                   f"{res['bound_fp32_ms']:.4f} ms; route {route}")
        print(f"[time] {name} ({m}, {n}, r {r}) x{b} bf16 G: kernel "
              f"{res['ms']:.4f} ms (CUDA events, eager), bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB, {how}), plain {res['plain_ms']:.4f} "
              f"ms, torch yardstick {lib}", flush=True)
    # the tangent's Gram: the fp32 torch.matmul that formed 2 A A^T before
    # the tensor-core route (fp32 G keeps it) beside the whole new call, and
    # the call's kernels by name (the splits, the Gram tiles, the T tiles)
    gram_ms = _time_ms(lambda: 2.0 * (A @ A.mT), iters=10, repeats=3)
    parts = _kernel_ms_by_name(kern["tangent"])
    out["tangent"].update(gram_matmul_ms=gram_ms, parts_ms=parts)
    print(f"[time] tangent's C = A A^T ({m}, {n}, r {r}) x{b} by the fp32 "
          f"torch.matmul of its first design (fp32 G's route): {gram_ms:.4f} "
          f"ms, {gram_ms / out['tangent']['ms']:.2f} of the new call's "
          f"{out['tangent']['ms']:.4f} ms; the call's kernels (profiler, ms a "
          f"call): " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
              parts.items(), key=lambda kv: -kv[1])), flush=True)
    del x, kern, plain, S, G, A, Gto, D, Gphic
    for label in list(PROJ_SHAPES)[:2]:
        m1, n1, r1, transposed = PROJ_SHAPES[label]
        x = _opt_inputs(m1, n1, r1, torch.bfloat16, SEED, transposed)
        S, G = x["S"], x["G"]
        ms = _time_ms(lambda: gk.project_colnorms(S, G), iters=10, repeats=3)
        bound = max(b * (4 * m1 * r1 + g * m1 * n1 + 4 * r1 * n1 + 4 * n1)
                    / HBM_BYTES_PER_S,
                    PROJ_PASSES * b * 2 * r1 * m1 * n1 / BF16_FLOPS) * 1e3
        print(f"[time] project_colnorms {label} x{b} bf16 G: kernel "
              f"{ms:.4f} ms (CUDA events), bound {bound:.4f} ms, route "
              f"{gk.project_colnorms.route}", flush=True)
        del x, S, G
    return out


# ---------------------------------------------------------------------------
# The grad-fused slice: grad_tap
# ---------------------------------------------------------------------------

TAP_REL = 2e-5     # fp32 sums of b (dW) or of b and m (A) in another order
TAP_CASES = {      # name -> (b, m, n, r): llama-7b's sites and edge cases
    "wq (4096, 4096)": (1024, 4096, 4096, RANK_7B),
    "w_gate (4096, 11008)": (1024, 4096, 11008, RANK_7B),
    "lm_head (4096, 32000)": (1024, 4096, 32000, RANK_7B),
    "ragged (1000, 4001, 3001, 1000)": (1000, 4001, 3001, 1000),
    "b 4096 (4096, 4096)": (4096, 4096, 4096, RANK_7B),
}


def _tap_inputs(b, m, n, r, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return (rn(b, m).to(dtype), rn(b, n).to(dtype),
            torch.linalg.qr(rn(m, r))[0].contiguous())


TAP_PASSES = 3     # bf16 x/dy: P = x S and A = P^T dy over three terms; dW 1


def phase_check_grad_tap() -> float:
    """grad_tap against its plain version at llama-7b's tapped shapes (w_down
    swapped, its dW stored in the leaf's layout), a ragged case and b = 4096,
    x/dy fp32 and bf16 (dW in the same dtype); the route printed (bf16 on
    the tensor cores, fp32 on the CUDA cores).  Returns the max abs error
    at the timed shape in bf16."""
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ref

    cases = dict(TAP_CASES)
    cases["w_down swapped (11008 -> 4096)"] = (1024, 4096, 11008, RANK_7B)
    err_timed = 0.0
    for i, (name, (b, m, n, r)) in enumerate(cases.items()):
        for dtype in (torch.float32, torch.bfloat16):
            x, dy, S = _tap_inputs(b, m, n, r, dtype, SEED + i)
            if name.startswith("w_down"):
                # the leaf is (11008, 4096); the backward calls
                # grad_tap(dy, x) and asks for dW^T in the leaf's layout
                got = gk.grad_tap(x, dy, S, out_dtype=dtype,
                                  transposed_out=True)
                if not got[0].mT.is_contiguous():
                    raise AssertionError("w_down dW not in the leaf layout")
            else:
                got = gk.grad_tap(x, dy, S, out_dtype=dtype)
            torch.cuda.synchronize()
            route = gk.grad_tap.route
            if not route.startswith("wgmma" if dtype == torch.bfloat16
                                    else "cuda-cores"):
                raise AssertionError(f"grad_tap {name} {dtype}: route {route}")
            dW, tap = got
            want = ref.grad_tap_ref(x, dy, S)
            line = []
            for part, g, w in zip(("dW", "A", "gsq"),
                                  (dW, tap[:-1], tap[-1]), want):
                abs_err, rel = _opt_error(g, w)
                if rel > TAP_REL:
                    raise AssertionError(
                        f"grad_tap {name} {dtype} {part}: error {rel:.3e} "
                        f"of the largest entry > {TAP_REL:g}")
                if name.startswith("w_gate") and dtype == torch.bfloat16:
                    err_timed = max(err_timed, abs_err)
                line.append(f"{part} {abs_err:.2e} ({rel:.1e})")
            del x, dy, S, got, dW, tap, want
            print(f"[check] grad_tap {name} b {b} r {r} {dtype}: max abs err "
                  f"(of largest entry) " + ", ".join(line) + f"; route "
                  f"{route}", flush=True)
    return err_timed


def phase_time_grad_tap() -> dict:
    """grad_tap at one (4096, 11008) site, b 1024, r 1024, bf16 x/dy and
    dW, beside its bound, its plain version and the PyTorch expression; and
    P = x S alone (S's split and the P tiles) beside its own bound."""
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ref

    b, m, n, r = TAP_CASES["w_gate (4096, 11008)"]
    x, dy, S = _tap_inputs(b, m, n, r, torch.bfloat16, SEED)

    def library():
        dW = x.float().T @ dy.float()
        return dW, S.T @ dW, (dW * dW).sum(0)

    # bytes the function must move: x, dy, S read once; dW (bf16), A and
    # gsq written once.  Operations, each at the card's peak for the type
    # it runs in: on the tensor cores dW = x^T dy (bf16 x bf16, one pass),
    # P = x S and A = P^T dy (``TAP_PASSES`` passes over split fp32
    # factors); the squares of the norms on the fp32 CUDA cores.  The
    # first design's bound (all but dW at the fp32 peak) is kept beside it.
    nbytes = 2 * b * m + 2 * b * n + 4 * m * r + 2 * m * n + 4 * r * n + 4 * n
    flops_dw = 2 * b * m * n
    flops_pa = 2 * b * m * r + 2 * b * r * n
    flops_norms = 2 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ((flops_dw + TAP_PASSES * flops_pa) / BF16_FLOPS
             + flops_norms / FP32_FLOPS) * 1e3
    t_mixed = (flops_dw / BF16_FLOPS
               + (flops_pa + flops_norms) / FP32_FLOPS) * 1e3
    res = {"ms": _time_ms(lambda: gk.grad_tap(x, dy, S,
                                              out_dtype=torch.bfloat16),
                          iters=10, repeats=3),
           "xs_ms": _time_ms(lambda: gk.grad_tap_xs(x, dy, S), iters=10,
                             repeats=3),
           "plain_ms": _time_ms(lambda: ref.grad_tap_ref(x, dy, S),
                                iters=10, repeats=3),
           "library_ms": _time_ms(library, iters=10, repeats=3),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_mixed_ms": max(t_bytes, t_mixed),
           "kernel_route": gk.grad_tap.route}
    if not res["kernel_route"].startswith("wgmma-tma"):
        raise AssertionError(f"timed grad_tap took route {res['kernel_route']}")
    xs_bound = max((2 * b * m + 4 * m * r + 6 * b * r) / HBM_BYTES_PER_S,
                   TAP_PASSES * 2 * b * m * r / BF16_FLOPS) * 1e3
    res["xs_bound_ms"] = xs_bound
    print(f"[time] grad_tap ({m}, {n}, b {b}, r {r}) bf16 x/dy/dW: kernel "
          f"{res['ms']:.4f} ms (route {res['kernel_route']}), bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}: {nbytes / 1e6:.1f} "
          f"MB, {flops_dw / 1e9:.1f} GFLOP dW + {TAP_PASSES} x "
          f"{flops_pa / 1e9:.1f} GFLOP P and A at the bf16 peak, "
          f"{flops_norms / 1e9:.2f} GFLOP fp32 norms; first design's mixed "
          f"bound {res['bound_mixed_ms']:.4f} ms), plain "
          f"{res['plain_ms']:.4f} ms, torch expression "
          f"{res['library_ms']:.4f} ms; of it P = x S alone "
          f"{res['xs_ms']:.4f} ms (bound {xs_bound:.4f} ms, {TAP_PASSES} x "
          f"{2 * b * m * r / 1e9:.1f} GFLOP bf16)", flush=True)
    return res


def _state_to(state, device):
    from repro_torch.core.subtrack import OptState, tree_map

    return OptState(step=state.step, n_updates=state.n_updates,
                    inner=tree_map(lambda st: type(st)(
                        *(t.to(device) for t in st)), state.inner))


def _launches_want(steps: int, tracking: int, tapped_sites: int = 0,
                   single_front: bool = False) -> dict:
    """Exact launch counts of ``steps`` train steps, ``tracking`` of them
    tracking steps: 3 launches per low-rank leaf on a plain step; on a
    tracking step 5 where the front end is the project_colnorms + tangent
    composite (m > 2048: llama-7b), 4 where it is the single launch
    (``single_front``: llama-1b, and the smoke llama).  A grad-fused plain
    step (``tapped_sites`` > 0) launches grad_tap once per tapped matmul
    and project_colnorms only for the untapped low-rank leaf (embed)."""
    plain = steps - tracking
    composite = 0 if single_front else N_LOWRANK_LEAVES * tracking
    return {"paged_attention": 0, "tangent_gram": 0, "adam_lowrank": 0,
            "flash_attention": 0,
            "project_colnorms": composite
            + (N_UNTAPPED_LOWRANK if tapped_sites else N_LOWRANK_LEAVES)
            * plain,
            "tangent": composite,
            "project_tangent_colnorms": N_LOWRANK_LEAVES * tracking
            if single_front else 0,
            "backproject": 0, "recovery": 0,
            "project": N_LOWRANK_LEAVES * tracking,
            "adam_lowrank_norms": N_LOWRANK_LEAVES * steps,
            "fused_update": N_LOWRANK_LEAVES * steps,
            "grad_tap": tapped_sites * plain}


def phase_train_smoke() -> None:
    """fp32 smoke llama on CUDA and on the CPU from the same params,
    warm-started state and batches, through ``run`` (what the CLI runs),
    plain and with the grad-fused backward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import get_optimizer
    from repro_torch.core.subtrack import tree_map
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import TrainState, make_warm_start
    from repro_torch.launch.train import run
    from repro_torch.models.api import build_model
    from repro_torch.optim.schedules import cosine_with_warmup

    steps, k = 6, 3
    cfg = get_config("llama-100m", smoke=True).with_(dtype="float32")
    bundle = build_model(cfg)
    opt = get_optimizer("subtrack", rank=32, update_interval=k, eta=2e-5,
                        use_kernels=True)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=64, global_batch=4,
                                         seed=SEED))
    batches = [data.global_batch_at(s) for s in range(steps)]
    params = bundle.init(torch.Generator().manual_seed(SEED))
    warm, _ = make_warm_start(bundle, opt)(
        TrainState(params=params, opt=opt.init(params)), batches[0])

    def go(device, grad_fused):
        ops.reset_launch_counts()
        out = run(cfg, tree_map(lambda t: t.to(device, copy=True), params),
                  lambda s: batches[s], optimizer=opt, steps=steps,
                  lr_at=cosine_with_warmup(1e-3, steps, 2), log_every=steps,
                  opt_state=_state_to(warm.opt, device),
                  grad_fused=grad_fused)
        return [h["loss"] for h in out["history"]], ops.launch_counts()

    tracking = sum(1 for s in range(steps) if s and s % k == 0)
    sites = 7 * cfg.n_layers + 1
    runs = {}
    for grad_fused in (False, True):
        cuda_losses, cuda_counts = go("cuda", grad_fused)
        cpu_losses, cpu_counts = go("cpu", grad_fused)
        runs[grad_fused] = cuda_losses
        diff = max(abs(a - b) for a, b in zip(cuda_losses, cpu_losses))
        name = "grad-fused" if grad_fused else "plain"
        if not diff <= SMOKE_LOSS_ATOL:
            raise AssertionError(f"smoke training ({name}): CUDA "
                                 f"{cuda_losses} vs CPU {cpu_losses} (max "
                                 f"diff {diff:.3e})")
        want = _launches_want(steps, tracking, sites if grad_fused else 0,
                              single_front=True)
        if cuda_counts != want or any(cpu_counts.values()):
            raise AssertionError(f"smoke training ({name}) launches: CUDA "
                                 f"{cuda_counts} (want {want}), CPU "
                                 f"{cpu_counts}")
        print(f"[smoke] fp32 smoke llama {name}, {steps} steps "
              f"({steps - tracking} plain, {tracking} tracking): losses CUDA "
              f"vs CPU max diff {diff:.2e} (budget {SMOKE_LOSS_ATOL:g}); "
              f"CUDA launches {cuda_counts}", flush=True)
    diff = max(abs(a - b) for a, b in zip(runs[True], runs[False]))
    if not diff <= SMOKE_LOSS_ATOL:
        raise AssertionError(f"smoke training on CUDA: grad-fused "
                             f"{runs[True]} vs plain {runs[False]}")
    print(f"[smoke] fp32 smoke llama on CUDA: grad-fused vs plain losses max "
          f"diff {diff:.2e} (budget {SMOKE_LOSS_ATOL:g})", flush=True)


def phase_time_svd() -> None:
    """One warm-start SVD per cuSOLVER driver at two llama-7b matrix
    shapes, full rank and of rank 1024 (a gradient of 1024 tokens): wall
    time and the orthonormality of U.  The warm start uses gesvd."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for m, n in ((4096, 4096), (4096, 11008)):
        full = torch.randn(m, n, generator=gen, device="cuda")
        low = (torch.randn(m, RANK_7B, generator=gen, device="cuda")
               @ torch.randn(RANK_7B, n, generator=gen, device="cuda"))
        eye = torch.eye(m, device="cuda")
        for kind, X in (("full rank", full), (f"rank {RANK_7B}", low)):
            for driver in (None, "gesvd", "gesvda"):
                torch.linalg.svd(full[:256, :512], full_matrices=False,
                                 driver=driver)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    U = torch.linalg.svd(X, full_matrices=False,
                                         driver=driver)[0]
                    torch.cuda.synchronize()
                except torch.linalg.LinAlgError as e:
                    if driver == "gesvd":
                        raise
                    print(f"[svd] ({m}, {n}) {kind} driver {driver}: "
                          f"failed ({str(e)[:60]})", flush=True)
                    continue
                dt = time.perf_counter() - t0
                orth = (U.mT @ U - eye).abs().max().item()
                print(f"[svd] ({m}, {n}) fp32 {kind} driver "
                      f"{driver or 'default'}: {dt:.3f} s, max |U^T U - I| "
                      f"{orth:.1e}", flush=True)
        del full, low, U


def _cfg_7b():
    """llama-7b at full width and ``LAYERS_7B`` of its layers."""
    from repro_torch.configs.registry import get_config

    return get_config("llama-7b").with_(n_layers=LAYERS_7B)


def phase_train_7b() -> dict:
    """llama-7b at full width and ``LAYERS_7B`` layers through ``run``
    (what the CLI runs; phase 16 drives the CLI itself): 4 steps at
    update interval 2, rank 1024, eta 10, batch 2 x 512, remat full, the
    CLI's schedule and batches; exact launches from the plans."""
    from repro_torch.core.api import get_optimizer
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                           batch_for_model, validate_batch)
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run
    from repro_torch.models.api import build_model
    from repro_torch.optim.schedules import cosine_with_warmup

    steps, k, batch, seq = 4, 2, 2, 512
    cfg = _cfg_7b()
    gc.collect()
    torch.cuda.empty_cache()          # the earlier phases' blocks
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(SEED))
    opt = get_optimizer("subtrack", rank=RANK_7B, update_interval=k,
                        eta=10.0, use_kernels=True)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq, global_batch=batch,
                                         seed=SEED))

    def batch_at(step, mutate=None):
        b = batch_for_model(cfg, None, data, step)
        validate_batch(b, cfg.vocab_size)
        return b

    want = _plan_launches(cfg, params, RANK_7B, steps, 1)
    ops.reset_launch_counts()
    out = run(cfg, params, batch_at, optimizer=opt, steps=steps,
              lr_at=cosine_with_warmup(1e-3, steps, 2), log_every=1)
    del params
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if not all(x is not None and math.isfinite(x) for x in losses):
        raise AssertionError(f"llama-7b: losses {losses}")
    tracking = [h["step"] for h in hist if h["subspace_update"]]
    if tracking != [2]:
        raise AssertionError(f"llama-7b: tracking steps {tracking}")
    if launches != want or launches != _launches_want(steps, 1):
        raise AssertionError(f"llama-7b launches {launches}, want {want} "
                             f"(3 per leaf per plain step, 5 per tracking)")
    plain_s = [h["dt"] for h in hist if not h["subspace_update"]]
    track_s = [h["dt"] for h in hist if h["subspace_update"]][0]
    print(f"[train] llama-7b bf16 cut to size: 32 -> {cfg.n_layers} layers "
          f"at full width, rank {RANK_7B}, batch {batch} x {seq}: warm start "
          f"{out['warm_start_s']:.2f}s ({7 * cfg.n_layers + 2} SVDs; loss "
          f"{out['warm_loss']:.4f}); losses {losses}; plain steps "
          f"{[round(t, 3) for t in plain_s]} s (step 0 cold), tracking step "
          f"{track_s:.3f} s; "
          f"{batch * seq / (sum(plain_s[1:]) / len(plain_s[1:])):.1f}"
          f" tok/s on warm plain steps; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}", flush=True)
    return {"launches": launches, "plain_steps": steps - 1,
            "tracking_steps": 1, "plain_s": plain_s, "tracking_s": track_s,
            "state": out["state"]}


def phase_train_7b_grad_fused(trained: dict) -> dict:
    """Four more llama-7b steps with the grad-fused backward, through
    ``run`` (what the CLI runs with --grad-fused), from phase 10's own
    warm-started and trained state and the next batches of its stream:
    plain steps 0, 1 and 3, tracking step 2.  Exact launches from the
    plans: per plain step grad_tap 57 (7 sites x 8 layers + lm_head),
    project_colnorms 1 (embed), adam_lowrank_norms 9, fused_update 9; a
    tracking step takes the plain backward and its 45 launches."""
    from repro_torch.core.api import get_optimizer
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                           fetch_batch)
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run
    from repro_torch.optim.schedules import cosine_with_warmup

    steps, k, done, batch, seq = 4, 2, 4, 2, 512
    cfg = _cfg_7b()
    opt = get_optimizer("subtrack", rank=RANK_7B, update_interval=k,
                        eta=10.0, use_kernels=True)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq, global_batch=batch,
                                         seed=SEED))
    # where the peak falls: device memory peaks of each step's forward,
    # backward and clip (up to the optimizer call) and of its optimizer
    mem: list[dict] = []

    def update(*args, **kw):
        mem.append({"backward": torch.cuda.max_memory_allocated(),
                    "at_update": torch.cuda.memory_allocated()})
        torch.cuda.reset_peak_memory_stats()
        res = opt.update(*args, **kw)
        mem[-1]["update"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return res

    def batch_at(s):
        b, ok = fetch_batch(cfg, data, done + s)
        if not ok:
            raise AssertionError(f"llama-7b: batch {done + s} rejected")
        return b

    sched = cosine_with_warmup(1e-3, done + steps, 2)
    # take phase 10's state out of ``trained`` and keep no reference to its
    # moments here: ``run`` frees them after the first step (12.5 GiB)
    state = trained.pop("state")
    params, opt_state = state.params, [state.opt]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = run(cfg, params, batch_at, optimizer=opt._replace(update=update),
              steps=steps,
              lr_at=lambda s: sched(done + s), log_every=1,
              opt_state=opt_state.pop(), grad_fused=True)
    launches = ops.launch_counts()
    peak = max(max(m["backward"], m["update"]) for m in mem)
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if not all(x is not None and math.isfinite(x) for x in losses):
        raise AssertionError(f"llama-7b grad-fused: losses {losses}")
    tracking = [h["step"] for h in hist if h["subspace_update"]]
    if tracking != [2]:
        raise AssertionError(f"llama-7b grad-fused: tracking steps {tracking}")
    if out["state"].opt.step != done + steps:
        raise AssertionError(f"optimizer step {out['state'].opt.step}")
    want = _plan_launches(cfg, out["state"].params, RANK_7B, steps, 1,
                          tapped=True)
    if launches != want or launches != _launches_want(
            steps, 1, 7 * cfg.n_layers + 1):
        raise AssertionError(f"llama-7b grad-fused launches {launches}, want "
                             f"{want}")
    plain_s = [h["dt"] for h in hist if not h["subspace_update"]]
    track_s = [h["dt"] for h in hist if h["subspace_update"]][0]
    warm = plain_s[1:]
    tok_s = batch * seq / (sum(warm) / len(warm))
    print(f"[train] llama-7b bf16 grad-fused, rank {RANK_7B}, batch {batch} x "
          f"{seq}, continuing phase 10's state at step {done}: losses "
          f"{losses}; plain steps {[round(t, 3) for t in plain_s]} s (step 0 "
          f"cold), tracking step {track_s:.3f} s; {tok_s:.1f} tok/s on warm "
          f"plain steps; peak memory {peak / 2**30:.2f} GiB; launches "
          f"{launches}", flush=True)
    gib = 2**30
    for h, m in zip(hist, mem):
        print(f"[memory] grad-fused step {h['step']}"
              f"{' (tracking)' if h['subspace_update'] else ''}: peak "
              f"{m['backward'] / gib:.2f} GiB up to the optimizer (forward, "
              f"backward, clip), {m['at_update'] / gib:.2f} GiB held on "
              f"entering it, peak {m['update'] / gib:.2f} GiB in it",
              flush=True)
    return {"launches": launches, "plain_s": plain_s, "tracking_s": track_s,
            "tok_s": tok_s, "peak_gib": peak / 2**30}


# ---------------------------------------------------------------------------
# The multi-GPU StepPrograms at group size 1 (phase 23)
# ---------------------------------------------------------------------------

# a program's step against the replicated program's on the same state, of
# the largest entry (bf16 updates: the first ulp of each entry forgiven):
# a plain step runs the same kernels on the same inputs; a tracking step
# of the row family runs the gram schedule against the tangent schedule
MESH_REL = {False: 1e-5, True: 1e-3}
# the clip holds each leaf's ||G|| <= 1, so sigma <= 2 ||G - S A|| ||A|| <= 2
# and theta = eta sigma <= 1: O(1), inside the clamp.  At phase 11's eta 10
# theta clamps at ~pi/2, the rotation all but zeroes the moments of the
# basis's turned direction, and the next Adam step divides by |Gt| there:
# 1e-6 of difference in the new projection flips signs (6.1e-3 of the
# largest entry of lm_head's update, measured on the H100)
MESH_ETA = 0.5
MESH_PROGRAMS = {   # name -> (sharded canonical dim, row_state)
    "row": ("m", "auto"), "row-rs": ("m", "reduce-scatter"),
    "column": ("n", "auto")}


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _nested(path, leaf) -> dict:
    for k in reversed(path):
        leaf = {k: leaf}
    return leaf


def _program_specs(params, rank: int, dim: str) -> dict:
    """Every low-rank leaf's canonical m (``dim`` "m") or n dim on the
    ``model`` axis; dense leaves replicated."""
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.subtrack import tree_map

    def leaf(p):
        plan = plan_lib.plan_for_shape(tuple(p.shape), rank)
        if plan.mode != "lowrank":
            return ()
        spec = [None] * p.dim()
        n_dim = p.dim() - 2 if plan.transpose else p.dim() - 1
        spec[(2 * p.dim() - 3 - n_dim) if dim == "m" else n_dim] = "model"
        return tuple(spec)

    return tree_map(leaf, params)


def _mesh_steps(opt, replicated, grads, params, opt_state, lr: float,
                tracking: bool) -> dict:
    """One optimizer step of ``opt``'s programs over every low-rank leaf,
    leaf by leaf (a single-leaf tree each: the whole tree's new moments
    and updates beside the model and its gradients would not fit), each
    beside the replicated program's step on the same leaf and state.
    Returns the summed step times (each leaf's call between two device
    syncs), ``opt``'s launch counts, the worst errors, and the device time
    of ``tangent_gram`` (CUDA events around each call)."""
    from collections import Counter

    from repro_torch.core.lowrank_adam import MatrixOptState
    from repro_torch.core.subtrack import OptState
    from repro_torch.kernels import ops

    counts, errs = Counter(), {}
    t_prog = t_rep = theta = 0.0
    events = []
    tangent_gram = ops.tangent_gram

    def timed_gram(*args, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = tangent_gram(*args, **kw)
        ev[1].record()
        events.append(ev)
        return out

    for path, st in _leaf_paths(opt_state.inner):
        if not isinstance(st, MatrixOptState):
            continue

        def step(o):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            upd, new, diag = o.update(
                _nested(path, _at(grads, path)),
                OptState(opt_state.step, opt_state.n_updates,
                         _nested(path, st)),
                _nested(path, _at(params, path)), lr, tracking,
                with_health=True)
            torch.cuda.synchronize()
            return _at(upd, path), _at(new.inner, path), diag, \
                time.perf_counter() - t0

        ops.reset_launch_counts()
        ops.tangent_gram = timed_gram
        try:
            upd, new, diag, dt = step(opt)
        finally:
            ops.tangent_gram = tangent_gram
        counts.update(ops.launch_counts())
        t_prog += dt
        theta = max(theta, diag[1].item())
        upd_r, new_r, _, dt = step(replicated)
        t_rep += dt
        name = path[-1]
        errs[f"{name} update"] = _stack_rel(upd, upd_r)
        for field, a, b in zip(("S", "M", "V", "lam"), new, new_r):
            if a.shape != b.shape:
                raise AssertionError(f"{name} {field}: {tuple(a.shape)} vs "
                                     f"{tuple(b.shape)}")
            errs[f"{name} {field}"] = _stack_rel(a, b)
        del upd, new, upd_r, new_r
        torch.cuda.empty_cache()      # the next leaf's blocks, unfragmented
    gram_ms = sum(a.elapsed_time(b) for a, b in events)
    return {"s": t_prog, "replicated_s": t_rep, "launches": dict(counts),
            "err": max(errs.values()), "worst": max(errs, key=errs.get),
            "tangent_gram_ms": gram_ms, "theta": theta}


def _stack_rel(got, want) -> float:
    """``_opt_error``'s relative error, one matrix of a stack at a time:
    fp32 copies of a whole 7b stack would not fit beside the model."""
    if got.dim() < 3:
        return _opt_error(got, want)[1]
    worst = scale = 0.0
    for g, w in zip(got, want):
        w_max = w.float().abs().max().item()
        worst = max(worst, _opt_error(g, w)[1] * w_max)
        scale = max(scale, w_max)
    return worst / max(scale, 1e-30)


def phase_mesh_programs(trained: dict) -> dict:
    """Phase 23, right after phase 11 and from its final llama-7b state
    (rank 1024, full width; no new warm start), which it leaves as it
    found it for phase 12: the multi-GPU StepPrograms at group size 1 on
    a one-rank NCCL group.  NCCL refuses two ranks on one device, so on
    this card the layouts, the gram schedule and its kernels are real and
    every collective round is an identity; runs of two and four ranks are
    held on the CPU over gloo (tests/test_torch_mesh.py).

    From one gradient of the stream's next batch (clipped as the train
    step clips it), for (a) the row programs (every low-rank leaf's
    canonical m on the ``model`` axis), (b) row-rs (``row_state=
    "reduce-scatter"``) and (c) column (canonical n), one plain and one
    tracking optimizer step, leaf by leaf beside the replicated
    program's on copies of the same state: exact launch counts (a
    row-family tracking step launches tangent_gram once per leaf and
    project never), updates and S, M, V within ``MESH_REL``, and the step
    times (summed over the leaves) beside the replicated program's and
    phase 11's whole train steps, with tangent_gram's share.  (d) The
    driver: the smoke config through ``torchrun --nproc-per-node 1 -m
    repro_torch.launch.train --mesh host`` (its NCCL initialisation) and
    through ``--mesh smoke``: the same losses."""
    import torch.distributed as dist

    from repro_torch.core.api import get_optimizer
    from repro_torch.core.program import build_program
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.subtrack import tree_leaves
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                           fetch_batch)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import host_context
    from repro_torch.launch.steps import clip_by_global_norm, value_and_grad
    from repro_torch.models.api import build_model

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    results = {}
    try:
        one = torch.ones(1, device="cuda")
        dist.all_reduce(one)
        torch.cuda.synchronize()
        if one.item() != 1.0:
            raise AssertionError(f"one-rank NCCL all-reduce gave {one}")
        ctx = host_context()
        cfg = _cfg_7b()
        state = trained["state"]
        params, opt_state = state.params, state.opt
        del state
        data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                             seq_len=512, global_batch=2,
                                             seed=SEED))
        batch, ok = fetch_batch(cfg, data, 4)
        if not ok:
            raise AssertionError("llama-7b: batch 4 rejected")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, _, grads = value_and_grad(build_model(cfg), params,
                                     {k: v.cuda() for k, v in batch.items()},
                                     "full")
        with torch.no_grad():
            grads, _ = clip_by_global_norm(grads, 1.0)
            kw = dict(rank=RANK_7B, update_interval=2, eta=MESH_ETA,
                      use_kernels=True)
            replicated = get_optimizer("subtrack", **kw)
            zero = {k: 0 for k in ops.launch_counts()}
            for name, (dim, row_state) in MESH_PROGRAMS.items():
                specs = _program_specs(params, RANK_7B, dim)
                opt = get_optimizer("subtrack", **kw, mesh=ctx,
                                    param_specs=specs, row_state=row_state)
                plans = [p for p in tree_leaves(plan_lib.make_plans(
                    params, RANK_7B, specs=specs)) if p.mode == "lowrank"]
                progs = {build_program(p, opt.config, ctx, tracking=True)
                         .regime for p in plans}
                if progs != {name}:
                    raise AssertionError(f"{name}: programs {progs}")
                for tracking in (False, True):
                    res = _mesh_steps(opt, replicated, grads, params,
                                      opt_state, 1e-3, tracking)
                    leaves = N_LOWRANK_LEAVES
                    front = (("tangent", "tangent_gram") if dim == "m"
                             else ("tangent", "project"))
                    want = dict(zero, project_colnorms=leaves,
                                adam_lowrank_norms=leaves,
                                fused_update=leaves,
                                **({k: leaves for k in front}
                                   if tracking else {}))
                    kind = "tracking" if tracking else "plain"
                    if res["launches"] != want:
                        raise AssertionError(
                            f"{name} {kind} launches {res['launches']}, "
                            f"want {want}")
                    if tracking and not 0.0 < res["theta"] < 1.2:
                        raise AssertionError(f"{name}: largest theta "
                                             f"{res['theta']}")
                    if not res["err"] <= MESH_REL[tracking]:
                        raise AssertionError(
                            f"{name} {kind}: {res['worst']} off the "
                            f"replicated program's by {res['err']:.2e}")
                    results[(name, kind)] = res
                    p11 = trained["tracking_s" if tracking else "plain_s"]
                    p11 = ([round(t, 3) for t in p11]
                           if isinstance(p11, list) else round(p11, 3))
                    share = (f"; largest theta {res['theta']:.4f}"
                             if tracking else "")
                    share += (f"; tangent_gram {res['tangent_gram_ms']:.2f} "
                             f"ms, {res['tangent_gram_ms'] / 10 / res['s']:.1f}"
                             "% of it" if res["tangent_gram_ms"] else "")
                    print(f"[mesh] llama-7b {name} programs at group 1, "
                          f"{kind} step: optimizer {res['s']:.3f} s over the "
                          f"{leaves} low-rank leaves (replicated program "
                          f"{res['replicated_s']:.3f} s; phase 11's whole "
                          f"{kind} train steps {p11} s){share}; worst error "
                          f"{res['err']:.2e} ({res['worst']}, budget "
                          f"{MESH_REL[tracking]:g}); launches "
                          f"{ {k: v for k, v in res['launches'].items() if v} }",
                          flush=True)
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"[mesh] peak memory {peak:.2f} GiB", flush=True)
        del grads, params, opt_state
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the driver: torchrun's one rank on NCCL against --mesh smoke
        argv = ["-m", "repro_torch.launch.train", "--arch", "llama-100m",
                "--smoke", "--rank", "32", "--update-interval", "2",
                "--steps", "4", "--batch", "4", "--seq", "64",
                "--use-kernels", "--eta", "2e-5", "--seed", str(SEED),
                "--log-every", "1"]
        build = ROOT / "build"
        build.mkdir(exist_ok=True)
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        runs = {}
        for mesh, launch in (
                ("host", [sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc-per-node", "1"]),
                ("smoke", [sys.executable])):
            out = build / f"mesh_{mesh}.json"
            cmd = launch + argv + ["--mesh", mesh, "--metrics-out", str(out)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                  text=True, timeout=600)
            if proc.returncode:
                raise AssertionError(f"{' '.join(cmd)} exited "
                                     f"{proc.returncode}:\n{proc.stdout[-3000:]}"
                                     f"\n{proc.stderr[-3000:]}")
            runs[mesh] = json.loads(out.read_text())
            out.unlink()
            print(f"[mesh] --mesh {mesh}: losses {runs[mesh]['losses']} "
                  f"({time.perf_counter() - t0:.1f} s with the start-up)",
                  flush=True)
        if runs["host"]["losses"] != runs["smoke"]["losses"] \
                or runs["host"]["launch_counts"] \
                != runs["smoke"]["launch_counts"] \
                or not any(runs["host"]["launch_counts"].values()):
            raise AssertionError(f"--mesh host {runs['host']} vs --mesh "
                                 f"smoke {runs['smoke']}")
    finally:
        dist.destroy_process_group()
    print(f"[mesh] phase 23: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": results[("row", "tracking")]["launches"],
            "results": results}


# ---------------------------------------------------------------------------
# The llama-1b slice: the tracking front end, the unfused schedule, training
# ---------------------------------------------------------------------------

FRONT_KERNELS = {   # name -> (CUDA source, def line of the TPU kernel)
    "project_tangent_colnorms": ("grassmann_tangent_front.cu", 347),
    "backproject": ("grassmann_backproject.cu", 149),
    "recovery": ("grassmann_backproject.cu", 230),
}
# max |kernel - plain| over max |plain|, per output: sums over m = 2048 or
# n up to 32000 (A, the norms, W) or over r (backproject, recovery) in
# another order; T's two terms cancel, and the kernel forms S (S^T W)
# where the plain version forms S (A A^T)
FRONT_REL = {"A": 2e-5, "gsq": 2e-5, "T": 1e-4, "backproject": 2e-5,
             "recovery": 2e-5}
RANK_1B = 512
FRONT_SHAPES = {   # name -> (m, n, r, G a transposed view)
    "wq..wo (2040, 2048)": (2040, 2048, RANK_1B, True),
    "w_gate, w_up (2048, 5461)": (2048, 5461, RANK_1B, False),
    "embed (2048, 32000)": (2048, 32000, RANK_1B, True),
    "ragged (1000, 777, r 129)": (1000, 777, 129, True),
}
TIMED_1B = (2048, 5461)
UNFUSED_REL = 1e-4   # the step's direction, CUDA vs CPU: Adam divides by sqrt(V)
ROUTED_FRONT = ("project_tangent_colnorms", "backproject",  # report a route
                "recovery")


def _front_inputs(m, n, r, gdtype, seed, transposed=False):
    """A batch of 2: orthonormal S, G in ``gdtype`` (an (n, m) buffer seen
    as (m, n) when ``transposed``: a canonical w_down or embed), X / Gt and
    phi, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    G = rn(2, n, m).to(gdtype).mT if transposed else rn(2, m, n).to(gdtype)
    return dict(S=torch.linalg.qr(rn(2, m, r))[0].contiguous(), G=G,
                X=rn(2, r, n), phi=rn(2, n).abs())


def _front_calls(x, impl):
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ref

    S, G, X, phi = x["S"], x["G"], x["X"], x["phi"]
    if impl == "kernel":
        return {"project_tangent_colnorms": lambda: gk.project_tangent_colnorms(S, G),
                "backproject": lambda: gk.backproject(S, X),
                "recovery": lambda: gk.recovery(S, G, X, phi)}
    return {"project_tangent_colnorms": lambda: ref.project_tangent_colnorms_ref(S, G),
            "backproject": lambda: ref.backproject_ref(S, X),
            "recovery": lambda: ref.recovery_ref(G, S, X, phi)}


def phase_check_front() -> dict:
    """The three kernels against their plain versions at llama-1b's shapes
    and a ragged one, G fp32 and bf16; the front end's dispatch at llama-7b's
    m = 4096 (the composite).  Returns name -> max abs error at the timed
    shape in bf16."""
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ops, ref

    if gk._lib("grassmann_tangent_front").tangent_front_max_m() \
            != gk.MAX_FRONT_M:
        raise AssertionError("MAX_FRONT_M differs from the kernel's limit")
    errs = {}
    for i, (name, (m, n, r, tr)) in enumerate(FRONT_SHAPES.items()):
        for dtype in (torch.float32, torch.bfloat16):
            x = _front_inputs(m, n, r, dtype, SEED + i, tr)
            kern, plain = _front_calls(x, "kernel"), _front_calls(x, "plain")
            line = []
            for kname in FRONT_KERNELS:
                got = kern[kname]()
                torch.cuda.synchronize()
                want = plain[kname]()
                parts = (zip(("A", "gsq", "T"), got, want)
                         if kname == "project_tangent_colnorms"
                         else [(kname, got, want)])
                if kname in ROUTED_FRONT:
                    route = getattr(gk, kname).route
                    _want_route(kname, dtype, route)
                    line.append(f"{kname} route {route}")
                for part, g, w in parts:
                    abs_err, rel = _opt_error(g, w)
                    if rel > FRONT_REL[part]:
                        raise AssertionError(
                            f"{kname} {part} at {name} {dtype}: error "
                            f"{rel:.3e} of the largest entry > "
                            f"{FRONT_REL[part]:g}")
                    if (m, n) == TIMED_1B and dtype == torch.bfloat16:
                        errs[kname] = max(errs.get(kname, 0.0), abs_err)
                    line.append(f"{part} {abs_err:.2e} ({rel:.1e})")
            del x, kern, plain
            print(f"[check] {name} r {r} x2 {dtype}: max abs err (of "
                  f"largest entry) " + ", ".join(line), flush=True)
    # llama-7b: m = 4096 is past the single launch; the dispatch composes
    x = _front_inputs(4096, 11008, RANK_7B, torch.bfloat16, SEED)
    try:
        gk.project_tangent_colnorms(x["S"], x["G"])
    except ValueError:
        pass
    else:
        raise AssertionError("the single launch took m = 4096")
    ops.reset_launch_counts()
    got = ops.project_tangent_colnorms(x["S"], x["G"])
    counts = ops.launch_counts()
    if (counts["project_tangent_colnorms"], counts["project_colnorms"],
            counts["tangent"]) != (0, 1, 1):
        raise AssertionError(f"llama-7b front end launches {counts}")
    line = []
    for part, g, w in zip(("A", "gsq", "T"), got,
                          ref.project_tangent_colnorms_ref(x["S"], x["G"])):
        abs_err, rel = _opt_error(g, w)
        if rel > FRONT_REL[part]:
            raise AssertionError(f"llama-7b front end {part}: {rel:.3e}")
        line.append(f"{part} {abs_err:.2e} ({rel:.1e})")
    print(f"[check] front end at llama-7b (4096, 11008, r {RANK_7B}) x2 bf16 "
          f"(m past {gk.MAX_FRONT_M}: project_colnorms + tangent): "
          + ", ".join(line), flush=True)
    return errs


def phase_time_front() -> dict:
    """The three kernels at (2048, 5461, r 512), 2 matrices, bf16 G, beside
    their bounds, plain versions and PyTorch expressions; the front end's
    single launch against its two-launch composite, there and (composite
    only, m past the limit) at llama-7b's (4096, 11008, r 1024)."""
    from repro_torch.kernels import grassmann as gk

    m, n = TIMED_1B
    r, b, g = RANK_1B, 2, 2            # matrices, bytes per bf16 element
    x = _front_inputs(m, n, r, torch.bfloat16, SEED)
    kern, plain = _front_calls(x, "kernel"), _front_calls(x, "plain")
    S, G, X, phi = x["S"], x["G"], x["X"], x["phi"]

    def library_front():
        G32 = G.float()
        A = S.mT @ G32
        W = G32 @ A.mT
        return A, (G32 * G32).sum(-2), -2.0 * W + 2.0 * (S @ (A @ A.mT))

    library = {"project_tangent_colnorms": library_front,
               "backproject": lambda: S @ X,
               "recovery": lambda: (G.float() - S @ X) * phi[..., None, :]}
    # bytes each function must move (inputs once, outputs once) and the
    # fp32 operations it needs, per the whole batch
    work = {
        "project_tangent_colnorms": (
            b * (4 * m * r + g * m * n + 4 * r * n + 4 * n + 4 * m * r),
            b * (4 * m * n * r + 4 * m * r * r + 2 * m * n + 2 * m * r)),
        "backproject": (b * (4 * m * r + 4 * r * n + 4 * m * n),
                        b * 2 * m * n * r),
        "recovery": (b * (4 * m * r + g * m * n + 4 * r * n + 4 * n
                          + 4 * m * n),
                     b * (2 * m * n * r + 2 * m * n)),
    }
    out = {}
    for name in FRONT_KERNELS:
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = t_fp32 = flops / FP32_FLOPS * 1e3
        tc = _tc_work(name, m, n, r, b)
        if tc:  # the products on the bf16 tensor cores, the rest in fp32
            t_ops = (sum(p * f for p, f in tc[0]) / BF16_FLOPS
                     + tc[1] / FP32_FLOPS) * 1e3
        res = {"ms": _time_ms(kern[name], iters=10, repeats=3),
               "plain_ms": _time_ms(plain[name], iters=10, repeats=3),
               "library_ms": _time_ms(library[name], iters=10, repeats=3),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        out[name] = res
        how = f"{flops / 1e9:.1f} GFLOP fp32"
        if tc:
            res["bound_fp32_ms"] = max(t_bytes, t_fp32)
            res["kernel_route"] = getattr(gk, name).route
            how = (" + ".join(f"{p} x {f / 1e9:.1f}" for p, f in tc[0])
                   + f" GFLOP in bf16 passes at the bf16 peak, "
                   f"{tc[1] / 1e9:.2f} fp32; fp32 CUDA-core bound "
                   f"{res['bound_fp32_ms']:.4f} ms; route "
                   f"{res['kernel_route']}")
        print(f"[time] {name} ({m}, {n}, r {r}) x{b} bf16 G: kernel "
              f"{res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}: {nbytes / 1e6:.1f} MB, {how}), plain "
              f"{res['plain_ms']:.4f} ms, torch expression "
              f"{res['library_ms']:.4f} ms", flush=True)

    def composite(S, G):
        A, gsq = gk.project_colnorms(S, G)
        return A, gsq, gk.tangent(G, A, S)

    comp_ms = _time_ms(lambda: composite(S, G), iters=10, repeats=3)
    out["project_tangent_colnorms"]["composite_ms"] = comp_ms
    clusters = gk._lib("grassmann_tangent_front").tangent_front_active_clusters(m)
    print(f"[time] front end ({m}, {n}, r {r}) x{b} bf16 G: single launch "
          f"{out['project_tangent_colnorms']['ms']:.4f} ms, project_colnorms "
          f"+ tangent {comp_ms:.4f} ms (single / composite "
          f"{out['project_tangent_colnorms']['ms'] / comp_ms:.2f}); "
          f"{b * -(-r // 128)} clusters of {-(-m // 128)} CTAs, {clusters} "
          f"resident at once; route {gk.project_tangent_colnorms.route}",
          flush=True)
    del x, kern, plain, S, G, X, phi
    # the same against w_down's transposed view (G by TMA)
    xt = _front_inputs(m, n, r, torch.bfloat16, SEED, transposed=True)
    single_t = _time_ms(lambda: gk.project_tangent_colnorms(xt["S"], xt["G"]),
                        iters=10, repeats=3)
    route_t = gk.project_tangent_colnorms.route
    comp_t = _time_ms(lambda: composite(xt["S"], xt["G"]), iters=10,
                      repeats=3)
    out["project_tangent_colnorms"].update(transposed_ms=single_t,
                                           transposed_composite_ms=comp_t)
    print(f"[time] front end ({m}, {n}, r {r}) x{b} bf16 G, w_down's "
          f"transposed view: single launch {single_t:.4f} ms ({route_t}), "
          f"project_colnorms + tangent {comp_t:.4f} ms (single / composite "
          f"{single_t / comp_t:.2f})", flush=True)
    del xt
    # one n-tile and the tail (S^T W, then T, on the engine) alone
    x1 = _front_inputs(m, 128, r, torch.bfloat16, SEED)
    tail_ms = _time_ms(lambda: gk.project_tangent_colnorms(x1["S"], x1["G"]),
                       iters=10, repeats=3)
    out["project_tangent_colnorms"]["one_tile_and_tail_ms"] = tail_ms
    print(f"[time] front end ({m}, 128, r {r}) x{b} bf16 G (one n-tile of "
          f"{-(-n // 128)}, then the tail): {tail_ms:.4f} ms", flush=True)
    del x1
    # a whole layer stack, as the llama-1b tracking step launches it
    x32 = _front_inputs(m, n, r, torch.bfloat16, SEED)
    S32 = x32["S"].repeat(16, 1, 1)
    G32 = x32["G"].repeat(16, 1, 1)
    del x32
    single32 = _time_ms(lambda: gk.project_tangent_colnorms(S32, G32),
                        iters=2, repeats=3)
    comp32 = _time_ms(lambda: composite(S32, G32), iters=2, repeats=3)
    out["project_tangent_colnorms"].update(stack32_ms=single32,
                                           stack32_composite_ms=comp32)
    print(f"[time] front end ({m}, {n}, r {r}) x32 (one llama-1b leaf) bf16 "
          f"G: single launch {single32:.4f} ms, project_colnorms + tangent "
          f"{comp32:.4f} ms (single / composite {single32 / comp32:.2f})",
          flush=True)
    del S32, G32
    x7 = _front_inputs(4096, 11008, RANK_7B, torch.bfloat16, SEED)
    comp7 = _time_ms(lambda: composite(x7["S"], x7["G"]), iters=5, repeats=3)
    out["project_tangent_colnorms"]["composite_7b_ms"] = comp7
    print(f"[time] front end (4096, 11008, r {RANK_7B}) x2 bf16 G: "
          f"project_colnorms + tangent {comp7:.4f} ms; the single launch "
          f"takes m <= {gk.MAX_FRONT_M} only", flush=True)
    return out


def phase_unfused_step() -> dict:
    """lowrank_adam_step(lr=None, backend=ops) at (2048, 5461, r 512), 2
    matrices, bf16 G, on CUDA and on the CPU from the same state."""
    from repro_torch.core import lowrank_adam as tla
    from repro_torch.kernels import ops

    m, n = TIMED_1B
    r = RANK_1B
    x = _front_inputs(m, n, r, torch.bfloat16, SEED + 7)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    st = tla.MatrixOptState(
        S=x["S"], M=0.1 * torch.randn(2, r, n, generator=gen, device="cuda"),
        V=0.01 * torch.randn(2, r, n, generator=gen, device="cuda").abs(),
        lam_prev=torch.tensor([0.0, 1.0], device="cuda"))
    runs = {}
    for dev in ("cuda", "cpu"):
        ops.reset_launch_counts()
        out = tla.lowrank_adam_step(
            x["G"].to(dev), tla.MatrixOptState(*(t.to(dev) for t in st)), 3,
            tla.AdamHP(), backend=ops)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = (out, ops.launch_counts())
    (cuda_out, cuda_counts), (cpu_out, cpu_counts) = runs["cuda"], runs["cpu"]
    want = {k: int(k in ("project", "backproject", "recovery"))
            for k in cuda_counts}
    if cuda_counts != want or any(cpu_counts.values()):
        raise AssertionError(f"unfused step launches: CUDA {cuda_counts}, "
                             f"CPU {cpu_counts}")
    _, rel = _opt_error(cuda_out.delta.cpu(), cpu_out.delta)
    _, rel_lam = _opt_error(cuda_out.state.lam_prev.cpu(),
                            cpu_out.state.lam_prev)
    if not (rel <= UNFUSED_REL and rel_lam <= UNFUSED_REL
            and torch.isfinite(cuda_out.delta).all()):
        raise AssertionError(f"unfused step: CUDA vs CPU {rel:.3e}, "
                             f"lam {rel_lam:.3e}")
    print(f"[unfused] lowrank_adam_step(lr=None, backend=ops) at ({m}, {n}, "
          f"r {r}) x2 bf16 G: direction CUDA vs CPU {rel:.2e} of the largest "
          f"entry (budget {UNFUSED_REL:g}), lam {rel_lam:.2e}; CUDA launches "
          f"project 1, backproject 1, recovery 1; CPU none", flush=True)
    return cuda_counts


def phase_train_1b() -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train

    steps, k, batch, seq = 4, 2, 4, 512
    gc.collect()
    torch.cuda.empty_cache()          # the earlier phases' blocks
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train(["--arch", "llama-1b", "--optimizer", "subtrack",
                 "--use-kernels", "--steps", str(steps), "--update-interval",
                 str(k), "--warmup", "2", "--batch", str(batch), "--seq",
                 str(seq), "--eta", "10", "--remat", "full", "--seed",
                 str(SEED), "--log-every", "1"])
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    if out["rank"] != RANK_1B:
        raise AssertionError(f"llama-1b rank {out['rank']}")
    if not all(h["loss"] is not None and math.isfinite(h["loss"])
               for h in hist):
        raise AssertionError(f"llama-1b: losses {out['losses']}")
    tracking = [h["step"] for h in hist if h["subspace_update"]]
    if tracking != [2]:
        raise AssertionError(f"llama-1b: tracking steps {tracking}")
    want = _launches_want(steps, 1, single_front=True)
    if launches != want:
        raise AssertionError(f"llama-1b launches {launches}, want {want} "
                             f"(3 per leaf per plain step, 4 per tracking)")
    plain_s = [h["dt"] for h in hist if not h["subspace_update"]]
    track_s = [h["dt"] for h in hist if h["subspace_update"]][0]
    tok_s = batch * seq / (sum(plain_s[1:]) / len(plain_s[1:]))
    print(f"[train] llama-1b bf16, rank {out['rank']}, batch {batch} x "
          f"{seq}: warm start {out['warm_start_s']:.2f}s (loss "
          f"{out['warm_loss']:.4f}); losses {out['losses']}; plain steps "
          f"{[round(t, 3) for t in plain_s]} s (step 0 cold), tracking step "
          f"{track_s:.3f} s; {tok_s:.1f} tok/s on warm plain steps; peak "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    return {"launches": launches, "state": out["state"],
            "state_bytes": out["state_bytes"]}


# ---------------------------------------------------------------------------
# The last three kernels: adam_lowrank, tangent_gram (the gram schedule) and
# flash_attention
# ---------------------------------------------------------------------------

# max |kernel - plain| over max |plain|: fp32 sums over m = 2048 to 4096 in
# another order; S^T T is analytically zero, so its error is judged against
# max |T| (as tests/test_kernels.py judges the TPU kernel)
GRAM_REL = 2e-5
GRAM_SHAPES = {   # name -> (m, n, r, G a transposed view)
    "llama-7b (4096, 11008, r 1024)": (4096, 11008, RANK_7B, False),
    "row shard (2048, 11008, r 1024)": (2048, 11008, RANK_7B, False),
    "ragged (1000, 777, r 129)": (1000, 777, 129, True),
}
ADAM_SHAPES = [(RANK_7B, 11008), (RANK_7B, 32000)]
# the gram schedule against the CPU and the tangent schedule: the tracking
# budget (power iteration over a Gram summed in another order)
TRACK_REL = 1e-3


def _gram_calls(S, T, G):
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ref

    return {"kernel": lambda: gk.tangent_gram(S, T, G),
            "plain": lambda: ref.tangent_gram_ref(S, T, G)}


def _gram_rel(got, want, T) -> tuple[float, float]:
    abs_err, rel = 0.0, 0.0
    tmax = T.abs().max().item()
    for i, (g, w) in enumerate(zip(got, want)):
        d = (g - w).abs().max().item()
        abs_err = max(abs_err, d)
        rel = max(rel, d / (tmax if i == 1 else w.abs().max().item()))
    return abs_err, rel


def phase_check_gram_adam() -> dict:
    """adam_lowrank and tangent_gram against their plain versions at
    llama-7b's shapes; ``ops.adam_lowrank`` driven once for its launch
    count.  Returns the max abs errors at the timed shapes (bf16 G) and the
    launch count."""
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ops, ref

    out = {}
    for i, (r, n) in enumerate(ADAM_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 20 + i)
        Gt, M = (torch.randn(2, r, n, generator=gen, device="cuda")
                 for _ in range(2))
        V = 0.01 * torch.rand(2, r, n, generator=gen, device="cuda")
        for step, bc in ((0, True), (1000, True), (3, False)):
            got = gk.adam_lowrank(Gt, M, V, step, bias_correction=bc)
            torch.cuda.synchronize()
            abs_err, rel = _opt_error(got, ref.adam_lowrank_ref(
                Gt, M, V, step, 0.9, 0.999, 1e-8, bc))
            if rel > OPT_REL["adam_lowrank_norms"]:
                raise AssertionError(f"adam_lowrank at ({r}, {n}) step "
                                     f"{step}: error {rel:.3e}")
            if (r, n) == (RANK_7B, TIMED[1]) and step == 0:
                out["adam_lowrank"] = abs_err
            print(f"[check] adam_lowrank ({r}, {n}) x2 step {step} bias "
                  f"correction {bc}: max abs err {abs_err:.2e} (of largest "
                  f"entry {rel:.1e})", flush=True)
        if (r, n) == (RANK_7B, TIMED[1]):
            ops.reset_launch_counts()
            ops.adam_lowrank(Gt, M, V, 3)
            out["adam_lowrank_launches"] = ops.launch_counts()["adam_lowrank"]
        del Gt, M, V, got
    for i, (name, (m, n, r, tr)) in enumerate(GRAM_SHAPES.items()):
        for dtype in (torch.float32, torch.bfloat16):
            x = _front_inputs(m, n, r, dtype, SEED + 30 + i, tr)
            S, G = x["S"], x["G"]
            T = ref.tangent_ref(G, ref.project_ref(S, G), S)
            calls = _gram_calls(S, T, G)
            got = calls["kernel"]()
            route = gk.tangent_gram.route
            _want_route("tangent_gram", dtype, route)
            torch.cuda.synchronize()
            abs_err, rel = _gram_rel(got, calls["plain"](), T)
            again = calls["kernel"]()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"tangent_gram at {name}: not "
                                     f"deterministic")
            if not all(torch.equal(g, g.mT) for g in got[2:]):
                raise AssertionError(f"tangent_gram at {name}: T^T T or "
                                     f"S^T S not exactly symmetric")
            if rel > GRAM_REL:
                raise AssertionError(f"tangent_gram at {name} {dtype}: error "
                                     f"{rel:.3e} > {GRAM_REL:g}")
            if (m, n) == TIMED and dtype == torch.bfloat16:
                out["tangent_gram"] = abs_err
            print(f"[check] tangent_gram {name} x2 {dtype}: max abs err "
                  f"{abs_err:.2e} (of largest entry, S^T T of max |T|: "
                  f"{rel:.1e}); route {route}; a second launch gives the "
                  f"same bits; T^T T, S^T S exactly symmetric", flush=True)
            del x, S, G, T, calls, got, again
    return out


def phase_time_gram_adam() -> dict:
    """tangent_gram at (4096, 11008, r 1024), bf16 G, and adam_lowrank at
    (1024, 11008), 2 matrices each, beside their bounds (tangent_gram's at
    its bf16 passes, ``_tc_work``, the fp32 CUDA-core bound of its first
    design beside it) and plain versions.  No single PyTorch call computes
    either (tangent_gram's plain version is already its four torch.matmul
    expressions), so neither has a library time."""
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ref

    m, n = TIMED
    r, b, g = RANK_7B, 2, 2          # matrices, bytes per bf16 element
    x = _front_inputs(m, n, r, torch.bfloat16, SEED)
    S, G = x["S"], x["G"]
    T = ref.tangent_ref(G, ref.project_ref(S, G), S)
    calls = _gram_calls(S, T, G)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    Gt, M = (torch.randn(b, r, n, generator=gen, device="cuda")
             for _ in range(2))
    V = 0.01 * torch.rand(b, r, n, generator=gen, device="cuda")
    # bytes each function must move (inputs once, outputs once) and the fp32
    # operations it needs, per the whole batch; T^T T and S^T S are symmetric,
    # so each needs m r (r + 1) (its upper triangle)
    work = {"tangent_gram": (b * (8 * m * r + g * m * n + 4 * r * n
                                  + 12 * r * r),
                             b * (2 * m * r * n + 2 * m * r * r
                                  + 2 * m * r * (r + 1))),
            "adam_lowrank": (b * 24 * r * n, b * 14 * r * n)}
    timed = {"tangent_gram": (calls["kernel"], calls["plain"]),
             "adam_lowrank": (lambda: gk.adam_lowrank(Gt, M, V, 3),
                              lambda: ref.adam_lowrank_ref(
                                  Gt, M, V, 3, 0.9, 0.999, 1e-8))}
    out = {}
    for name, (kern, plain) in timed.items():
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = t_fp32 = flops / FP32_FLOPS * 1e3
        tc = _tc_work(name, m, n, r, b)
        if tc:  # the products on the bf16 tensor cores, the rest in fp32
            t_ops = (sum(p * f for p, f in tc[0]) / BF16_FLOPS
                     + tc[1] / FP32_FLOPS) * 1e3
        res = {"ms": _time_ms(kern, iters=10, repeats=3),
               "plain_ms": _time_ms(plain, iters=10, repeats=3),
               "library_ms": None,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        out[name] = res
        how = f"{flops / 1e9:.1f} GFLOP fp32"
        if tc:
            res["bound_fp32_ms"] = max(t_bytes, t_fp32)
            res["kernel_route"] = getattr(gk, name).route
            how = (" + ".join(f"{p} x {f / 1e9:.1f}" for p, f in tc[0])
                   + f" GFLOP in bf16 passes at the bf16 peak; fp32 "
                   f"CUDA-core bound {res['bound_fp32_ms']:.4f} ms; route "
                   f"{res['kernel_route']}")
        shape = (f"({m}, {n}, r {r}) x{b} bf16 G" if name == "tangent_gram"
                 else f"({r}, {n}) x{b}")
        print(f"[time] {name} {shape}: kernel "
              f"{res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}: {nbytes / 1e6:.1f} MB, {how}), plain "
              f"{res['plain_ms']:.4f} ms, no single PyTorch call",
              flush=True)
    return out


def phase_gram_schedule() -> dict:
    """track_subspace(schedule="gram", backend=ops) at (4096, 11008, r
    1024), 2 matrices, bf16 G, eta pinned so theta = 0.5 on matrix 0:
    exactly three launches, the CPU's result from the same S and G, the
    tangent schedule on the card; both schedules timed."""
    from repro_torch.core import subspace as tsub
    from repro_torch.kernels import ops, ref

    m, n = TIMED
    x = _front_inputs(m, n, RANK_7B, torch.bfloat16, SEED + 50)
    S, G = x["S"], x["G"]
    T0 = ref.tangent_ref(G[0], ref.project_ref(S[0], G[0]), S[0])
    eta = 0.5 / torch.linalg.matrix_norm(T0, ord=2).item()
    del T0

    def gram(S, G):
        return tsub.track_subspace(S, G, eta=eta, schedule="gram",
                                   backend=ops)

    def tangent(S, G):
        return tsub.track_subspace(S, G, eta=eta, backend=ops)

    ops.reset_launch_counts()
    got = gram(S, G)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {k: int(k in ("project_colnorms", "tangent", "tangent_gram"))
            for k in counts}
    if counts != want:
        raise AssertionError(f"gram schedule launches {counts}")
    cpu = gram(S.cpu(), G.cpu())
    tang = tangent(S, G)
    errs = {name: _opt_error(getattr(got, name).cpu(), getattr(cpu, name))[1]
            for name in ("S_new", "A_new", "cos_theta", "v")}
    errs["projector vs tangent"] = _opt_error(
        got.S_new @ got.S_new.mT, tang.S_new @ tang.S_new.mT)[1]
    errs["A_new vs S_new^T G"] = _opt_error(
        got.A_new, ref.project_ref(got.S_new, G))[1]
    errs["A_new vs tangent's S_new^T G"] = _opt_error(
        got.A_new, ref.project_ref(tang.S_new, G))[1]
    bad = {k: v for k, v in errs.items() if not v <= TRACK_REL}
    theta = torch.arccos(got.cos_theta).tolist()
    if bad or not all(0.1 < t < 1.4 for t in theta) \
            or not torch.isfinite(got.A_new).all():
        raise AssertionError(f"gram schedule: errors {errs}, theta {theta}")
    gram_ms = _time_ms(lambda: gram(S, G), iters=3, repeats=3)
    tangent_ms = _time_ms(lambda: tangent(S, G), iters=3, repeats=3)
    print(f"[gram] track_subspace(schedule='gram', backend=ops) at ({m}, {n}, "
          f"r {RANK_7B}) x2 bf16 G: launches project_colnorms 1, tangent 1, "
          f"tangent_gram 1; theta {[round(t, 4) for t in theta]}; errors of "
          f"the largest entry (budget {TRACK_REL:g}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; gram schedule {gram_ms:.4f} ms, tangent schedule "
          f"{tangent_ms:.4f} ms (its A_new is a project launch more)",
          flush=True)
    return {"launches": counts["tangent_gram"], "gram_ms": gram_ms,
            "tangent_ms": tangent_ms}


# fp32 inputs: sums over hd and T in another order, expf and tanhf against
# PyTorch's.  bf16 inputs: one bf16 rounding of the output plus 1e-5 (both
# compute in fp32 from the same bf16 values; near-zero outputs cancel)
FLASH_TOL = 2e-5
FLASH_CASES = {   # name -> (B, S, T, Hq, Hkv, hd, causal, window, softcap)
    "llama-7b prefill": (4, 2048, 2048, 32, 32, 128, True, 0, 0.0),
    "gemma2-27b local": (1, 8192, 8192, 32, 16, 128, True, 4096, 50.0),
    "stablelm-12b": (2, 1024, 1024, 32, 8, 160, True, 0, 0.0),
    "llama-1b hd 85": (2, 1024, 1024, 24, 24, 85, True, 0, 0.0),
    "non-causal": (1, 1024, 1024, 32, 32, 128, False, 0, 0.0),
    "S 512, T 2048": (1, 512, 2048, 32, 32, 128, True, 0, 0.0),
    "ragged S = T = 1000": (1, 1000, 1000, 8, 2, 128, True, 0, 0.0),
}
FLASH_TIMED = ("llama-7b prefill", "gemma2-27b local")
# the library calls against the plain version: both round P to bf16 for P V
# (the plain version keeps it fp32) and return bf16; outputs here are
# averages of unit normals (|o| < ~4)
LIB_TOL = 5e-2


def _flash_inputs(case, dtype, seed):
    B, S, T, Hq, Hkv, hd = FLASH_CASES[case][:6]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((B, S, Hq, hd), (B, T, Hkv, hd),
                               (B, T, Hkv, hd)))


def _flash_err(got, want) -> tuple[float, float]:
    """(max abs error, max of |error| - allowed over the allowed): <= 0
    passes.  Allowed: FLASH_TOL (1 + |want|) in fp32; one bf16 ulp of want
    plus 1e-5 (1 + |want|) in bf16."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    allowed = FLASH_TOL * (1 + w.abs())
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(w)
        allowed = (torch.where(w == 0, torch.zeros_like(w),
                               torch.ldexp(torch.ones_like(w), e - 8))
                   + 1e-5 * (1 + w.abs()))
    return d.max().item(), ((d - allowed) / allowed).max().item()


def _flash_library(case, q, k, v):
    """The one PyTorch call that computes a timed case's attention, on views
    of q, k, v in its (B, H, S, hd) layout, and its name: SDPA at llama-7b's
    prefill (causal, MHA); at gemma2's local layer ``flex_attention``,
    compiled, with the softcap as its ``score_mod`` and the causal window as
    its block mask (every row sees its own key, so its -inf masking agrees
    with the plain version's -1e30)."""
    import torch.nn.functional as F
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    _, S, T, Hq, Hkv, _, causal, window, softcap = FLASH_CASES[case]
    assert causal and bool(window) == bool(softcap), case
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if not softcap:
        return "sdpa(is_causal=True)", lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, q_idx, kv_idx):
        return (kv_idx <= q_idx) & (kv_idx > q_idx - window)

    mask = create_block_mask(mask_mod, None, None, S, T, device="cuda")
    flex = torch.compile(flex_attention, dynamic=False)
    return "flex_attention (compiled)", lambda: flex(
        qh, kh, vh, score_mod=score_mod, block_mask=mask,
        enable_gqa=Hq != Hkv)


def phase_flash() -> dict:
    """Drive ops.flash_attention at the two timed shapes (the launches of
    that run are the kernel line's count), hold the kernel against its plain
    version at every case, and time it at the two timed shapes beside its
    plain version and a PyTorch call."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops, ref

    def kw(case):
        causal, window, softcap = FLASH_CASES[case][6:]
        return dict(causal=causal, window=window, softcap=softcap)

    out = {}
    for i, case in enumerate(FLASH_CASES):
        for dtype in ((torch.bfloat16, torch.float32)
                      if case == "non-causal" else (torch.bfloat16,)):
            q, k, v = _flash_inputs(case, dtype, SEED + 60 + i)
            if case in FLASH_TIMED:
                ops.reset_launch_counts()
                got = ops.flash_attention(q, k, v, **kw(case))
                torch.cuda.synchronize()
                out.setdefault("launches", 0)
                out["launches"] += ops.launch_counts()["flash_attention"]
            else:
                got = fk.flash_attention(q, k, v, **kw(case))
                torch.cuda.synchronize()
            route = fk.flash_attention.route
            if route.startswith("wgmma") != (dtype == torch.bfloat16):
                raise AssertionError(f"flash_attention {case} {dtype} took "
                                     f"route {route}")
            abs_err, excess = _flash_err(got, ref.flash_attention_ref(
                q, k, v, **kw(case)))
            if not excess <= 0:
                raise AssertionError(f"flash_attention {case} {dtype}: max "
                                     f"abs err {abs_err:.3e} past its "
                                     f"tolerance")
            if case == FLASH_TIMED[0]:
                out["max_abs_err"] = abs_err
            print(f"[check] flash_attention {case} {FLASH_CASES[case][:6]} "
                  f"{kw(case)} {dtype}: route {route}, max abs err "
                  f"{abs_err:.2e} (within tolerance)", flush=True)
            del q, k, v, got
    if out["launches"] != len(FLASH_TIMED):
        raise AssertionError(f"flash_attention launches {out['launches']}")
    for case in FLASH_TIMED:
        B, S, T, Hq, Hkv, hd, causal, window, softcap = FLASH_CASES[case]
        q, k, v = _flash_inputs(case, torch.bfloat16, SEED + 70)
        # visible (query, key) pairs of this run's masks
        qp = torch.arange(S, device="cuda")
        hi = qp.clamp_max(T - 1) if causal else torch.full_like(qp, T - 1)
        lo = (qp - window + 1).clamp_min(0) if window else torch.zeros_like(qp)
        pairs = B * Hq * int((hi - lo + 1).clamp_min(0).sum())
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        flops = 4 * hd * pairs            # q.k and p.v at the bf16 peak
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        # the bf16 route's own work: Q K^T once, P V once per term of P
        design_ms = max(t_bytes, 2 * hd * pairs * (1 + ref.FLASH_P_TERMS)
                        / BF16_FLOPS * 1e3)
        iters = 3 if case == FLASH_TIMED[1] else 5
        lib_name, library = _flash_library(case, q, k, v)
        t0 = time.perf_counter()
        lib_out = library()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        lib_err = (lib_out.transpose(1, 2).float() - ref.flash_attention_ref(
            q, k, v, **kw(case)).float()).abs().max().item()
        del lib_out
        if not lib_err <= LIB_TOL:
            raise AssertionError(f"{lib_name} at {case}: max abs err "
                                 f"{lib_err:.3e} from the plain version")
        res = {"ms": _time_ms(lambda: fk.flash_attention(q, k, v, **kw(case)),
                              iters=iters, repeats=3),
               "plain_ms": _time_ms(lambda: ref.flash_attention_ref(
                   q, k, v, **kw(case)), iters=iters, repeats=3),
               "library_ms": _time_ms(library, iters=4 * iters, repeats=3),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "design_bound_ms": design_ms,
               "kernel_route": fk.flash_attention.route}
        if softcap:   # the same masks without the cap: the tanh's share
            res["no_softcap_ms"] = _time_ms(lambda: fk.flash_attention(
                q, k, v, causal=causal, window=window), iters=iters,
                repeats=3)
        out[case] = res
        lib = (f"{lib_name} {res['library_ms']:.4f} ms (max abs err from the "
               f"plain version {lib_err:.2e}; first call {first_s:.1f} s)")
        cap = (f"; without the softcap {res['no_softcap_ms']:.4f} ms"
               if softcap else "")
        print(f"[time] flash_attention {case} bf16 {FLASH_CASES[case]}: "
              f"kernel {res['ms']:.4f} ms (route {res['kernel_route']}{cap}), "
              f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB, {pairs} visible pairs, "
              f"{flops / 1e9:.1f} GFLOP at the bf16 peak), the route's own "
              f"bound {design_ms:.4f} ms (Q K^T once, P V {ref.FLASH_P_TERMS} "
              f"times), plain {res['plain_ms']:.4f} ms, {lib}", flush=True)
        del q, k, v
    return out


# ---------------------------------------------------------------------------
# The one-device leftovers: the dense serving engine (phase 20) and the
# llama-1b training options (phase 21)
# ---------------------------------------------------------------------------

# dense vs paged prefill logits of llama-7b in bf16, max |dense - paged|
# over max |paged|: the two programs may round their bf16 activations
# after different GEMM shapes and attention blockings (one 512-token pass
# against four 128-token chunks); a few bf16 ulps of the largest logit
DENSE_LOGIT_REL = 1e-2
# accum 2 against accum 1 on one llama-1b batch, bf16 gradients: the loss
# (fp32 means of the same per-token losses, the forward at batch 2 against
# 4) and the global gradient norm (an fp32 sum of two bf16 half-batch
# gradients against one bf16 gradient), relative
ACCUM_LOSS_REL = 1e-3
ACCUM_GNORM_REL = 1e-2
REMAT_LOSS_REL = 1e-6    # step 0's loss: the same forward under every remat


def _prefix_len(a: list, b: list) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def phase_serve_dense(paged_7b: dict) -> None:
    """Phase 20: phase 6's llama-7b load through ``run_dense`` and
    ``run_paged``, on one set of parameters (the serve CLI's, from the
    seed) and the same prompts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (AdmissionQueue, Request, run_dense,
                                          run_paged)
    from repro_torch.models.api import build_model

    requests, batch, P, gen, bs, chunk = 8, 8, 512, 64, 16, 128
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama-7b")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(SEED))
    prompts = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=P, global_batch=requests,
        seed=SEED)).global_batch_at(0)["tokens"].numpy()
    W = -(-(P + gen) // bs)

    def queue():
        q = AdmissionQueue()
        for i in range(requests):
            q.submit(Request(rid=i, prompt=prompts[i], max_new=gen,
                             t_submit=time.time()))
        return q

    runs, counts = {}, {}
    for engine in ("dense", "paged"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        if engine == "dense":
            runs[engine] = run_dense(cfg, bundle, params, queue(),
                                     batch=batch, prompt_len=P, seed=SEED)
        else:
            runs[engine] = run_paged(cfg, bundle, params, queue(),
                                     batch=batch, block_size=bs,
                                     pool_blocks=1 + batch * W,
                                     max_context=P + gen,
                                     prefill_chunk=chunk, seed=SEED)
            runs[engine]["peak_memory_bytes"] = \
                torch.cuda.max_memory_allocated()
        counts[engine] = ops.launch_counts()
    dense, paged = runs["dense"], runs["paged"]
    lens = sorted(len(t) for t in dense["outputs"].values())
    if dense["requests"] != requests or lens != [gen] * requests:
        raise AssertionError(f"dense llama-7b: {dense['requests']} requests "
                             f"done, output lengths {lens}")
    if any(counts["dense"].values()):
        raise AssertionError(f"the dense engine launched {counts['dense']}")
    if counts["paged"]["paged_attention"] \
            != paged["decode_calls"] * cfg.n_layers:
        raise AssertionError(f"paged llama-7b launches {counts['paged']}")
    firsts = [(dense["outputs"][i][0], paged["outputs"][i][0])
              for i in range(requests)]
    if any(a != b for a, b in firsts):
        raise AssertionError(f"dense and paged first tokens differ: "
                             f"{firsts}")
    prefix = [_prefix_len(dense["outputs"][i], paged["outputs"][i])
              for i in range(requests)]

    # the prefill logits of both programs, as each engine forms them
    with torch.no_grad():
        toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
        want, _ = bundle.prefill(params, {"tokens": toks}, P + gen + 8)
        pool = bundle.init_paged_cache(1 + W, bs, "cuda")
        table = torch.arange(1, 1 + W, dtype=torch.int32, device="cuda")
        got = []
        for i in range(requests):
            for c0 in range(0, P, chunk):
                logits = bundle.paged_prefill_chunk(
                    params, pool, toks[i:i + 1, c0:c0 + chunk], table, c0)
            got.append(logits[0, P - 1 - c0])
        got = torch.stack(got).float()
        want = want.float()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        argmax_equal = torch.equal(got.argmax(-1), want.argmax(-1))
    del pool, params, toks
    if not rel <= DENSE_LOGIT_REL or not argmax_equal:
        raise AssertionError(f"dense vs paged prefill logits: {rel:.3e} of "
                             f"the largest (budget {DENSE_LOGIT_REL:g}), "
                             f"argmax equal {argmax_equal}")
    gib = 2**30
    print(f"[serve] llama-7b bf16 dense engine: {dense['requests']} requests, "
          f"{dense['tokens']} tokens in {dense['wall_s']:.3f}s: "
          f"{dense['tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{dense['ttft_p50_s'] * 1e3:.1f} ms, mean decode step "
          f"{dense['decode_step_ms_mean']:.3f} ms over "
          f"{dense['decode_calls']} steps, peak memory "
          f"{dense['peak_memory_bytes'] / gib:.2f} GiB, kernel launches "
          f"{sum(counts['dense'].values())}", flush=True)
    print(f"[serve] llama-7b bf16 paged engine, same params and prompts: "
          f"{paged['tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{paged['ttft_p50_s'] * 1e3:.1f} ms, mean decode wave "
          f"{paged['decode_wave_ms_mean']:.3f} ms, peak memory "
          f"{paged['peak_memory_bytes'] / gib:.2f} GiB; phase 6: "
          f"{paged_7b['tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{paged_7b['ttft_p50_s'] * 1e3:.1f} ms, wave "
          f"{paged_7b['decode_wave_ms_mean']:.3f} ms, peak "
          f"{paged_7b['peak_gib']:.2f} GiB", flush=True)
    print(f"[serve] dense vs paged: first tokens equal in all {requests} "
          f"requests; prefill logits max |dense - paged| {rel:.3e} of the "
          f"largest (budget {DENSE_LOGIT_REL:g}), argmax equal; greedy "
          f"tokens agree on prefixes of {prefix} of {gen}", flush=True)


def phase_time_fp32_routes() -> dict:
    """Phase 21 (timing): the fp32-G routes of project, project_colnorms
    and the front end, which ``--accum`` puts on the llama-1b step, at
    (2048, 5461, r 512) x 2 and on a 32-stack (one llama-1b leaf), beside
    their bounds (bytes at the memory rate, the products at the fp32 peak
    of the CUDA cores, which these routes use)."""
    from repro_torch.kernels import grassmann as gk

    m, n = TIMED_1B
    r = RANK_1B
    out = {name: {"ms": {}, "bound_ms": {}}
           for name in ("project", "project_colnorms",
                        "project_tangent_colnorms")}
    x = _front_inputs(m, n, r, torch.float32, SEED)
    for b in (2, 32):
        S, G = ((x["S"], x["G"]) if b == 2 else
                (x["S"].repeat(16, 1, 1), x["G"].repeat(16, 1, 1)))
        calls = {"project": lambda: gk.project(S, G),
                 "project_colnorms": lambda: gk.project_colnorms(S, G),
                 "project_tangent_colnorms":
                     lambda: gk.project_tangent_colnorms(S, G)}
        # inputs once, outputs once, fp32; operations per the whole stack
        work = {"project": (b * 4 * (m * r + m * n + r * n),
                            b * 2 * m * n * r),
                "project_colnorms": (b * 4 * (m * r + m * n + r * n + n),
                                     b * (2 * m * n * r + 2 * m * n)),
                "project_tangent_colnorms": (
                    b * 4 * (2 * m * r + m * n + r * n + n),
                    b * (4 * m * n * r + 4 * m * r * r + 2 * m * n
                         + 2 * m * r))}
        line = []
        for name, fn in calls.items():
            ms = _time_ms(fn, iters=10 if b == 2 else 2, repeats=3)
            route = getattr(gk, name).route
            if route != "cuda-cores":
                raise AssertionError(f"{name} with fp32 G took {route}")
            nbytes, flops = work[name]
            bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
            out[name]["ms"][f"x{b}"] = ms
            out[name]["bound_ms"][f"x{b}"] = bound
            line.append(f"{name} {ms:.4f} ms (bound {bound:.4f}, "
                        f"{flops / ms / 1e9:.1f} TFLOP/s)")
        print(f"[time] fp32 G at ({m}, {n}, r {r}) x{b}, route cuda-cores: "
              + ", ".join(line), flush=True)
        del S, G, calls
    del x
    return out


def _one_hot_bases(state) -> int:
    """Checks every low-rank leaf's S is a one-hot row selection (each
    column one 1, each row at most one); returns how many leaves."""
    from repro_torch.core.lowrank_adam import MatrixOptState
    from repro_torch.core.subtrack import tree_leaves

    n = 0
    for st in tree_leaves(state.inner):
        if not isinstance(st, MatrixOptState):
            continue
        S = st.S
        ok = (((S == 0) | (S == 1)).all() and (S.sum(-2) == 1).all()
              and (S.sum(-1) <= 1).all())
        if not ok:
            raise AssertionError(f"grass basis {tuple(S.shape)} is not "
                                 "one-hot")
        n += 1
    return n


def phase_train_1b_options(trained_1b: dict) -> None:
    """Phase 21: the llama-1b training options the earlier phases do not
    run, each for 4 steps (plain 0, 1, 3; tracking 2) from a copy of phase
    16's final params and state, on its stream's next batches: (a)
    ``--accum 2 --grad-fused`` (the fallback to the plain backward, fp32
    G's routes) and accum 2 against accum 1 on one batch; (b) remat
    full, dots and none; (c) the grass basis with its own warm start;
    (d) the dense baselines AdamW and BAdam."""
    import contextlib
    import io

    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import get_optimizer
    from repro_torch.core.subtrack import OptState, tree_map
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                           fetch_batch)
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (TrainState, accumulated_grads,
                                          global_norm, make_warm_start)
    from repro_torch.launch.train import run
    from repro_torch.models.api import build_model
    from repro_torch.optim.schedules import cosine_with_warmup

    steps, k, done, batch, seq = 4, 2, 4, 4, 512
    cfg = get_config("llama-1b")
    bundle = build_model(cfg)
    start = trained_1b["state"]                  # phase 22 starts from it too
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq, global_batch=batch,
                                         seed=SEED))
    sched = cosine_with_warmup(1e-3, done + steps, 2)
    subtrack = get_optimizer("subtrack", rank=RANK_1B, update_interval=k,
                             eta=10.0, use_kernels=True)

    def batch_at(s):
        b, ok = fetch_batch(cfg, data, done + s)
        if not ok:
            raise AssertionError(f"llama-1b: batch {done + s} rejected")
        return b

    def params_copy():
        return tree_map(torch.clone, start.params)

    def opt_copy():
        return OptState(step=start.opt.step, n_updates=start.opt.n_updates,
                        inner=tree_map(lambda st: type(st)(
                            *(t.clone() for t in st)), start.opt.inner))

    def go(label, optimizer, opt_state=None, **kw) -> dict:
        """4 steps of ``run`` from a fresh copy; frees them after."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()     # phase 16's state
        ops.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = run(cfg, params_copy(), batch_at, optimizer=optimizer,
                      steps=steps, lr_at=lambda s: sched(done + s),
                      log_every=steps, opt_state=opt_state, **kw)
        print(buf.getvalue(), end="", flush=True)
        hist = out["history"]
        res = {"launches": ops.launch_counts(), "log": buf.getvalue(),
               "losses": [h["loss"] for h in hist],
               "plain_s": [h["dt"] for h in hist
                           if not h["subspace_update"]],
               "tracking_s": [h["dt"] for h in hist
                              if h["subspace_update"]],
               "peak_gib": (torch.cuda.max_memory_allocated() - held)
               / 2**30, "state": out["state"]}
        if not all(x is not None and math.isfinite(x)
                   for x in res["losses"]):
            raise AssertionError(f"llama-1b {label}: losses "
                                 f"{res['losses']}")
        print(f"[train] llama-1b {label}: losses {res['losses']}; plain "
              f"steps {[round(t, 3) for t in res['plain_s']]} s, tracking "
              f"{[round(t, 3) for t in res['tracking_s']]} s; peak memory "
              f"{res['peak_gib']:.2f} GiB above the {held / 2**30:.2f} GiB "
              f"the phase holds; launches {res['launches']}", flush=True)
        return res

    results = {}
    want = _launches_want(steps, 1, single_front=True)

    # (a) --accum 2 --grad-fused: the plain backward, fp32 G
    res = go("accum 2 --grad-fused", subtrack, opt_copy(), grad_fused=True,
             accum=2)
    if "falling back to the plain backward" not in res["log"]:
        raise AssertionError("accum 2 --grad-fused: no fallback line")
    if res["launches"] != want:
        raise AssertionError(f"accum 2 launches {res['launches']}, want "
                             f"{want}")
    routes = {name: getattr(gk, name).route for name in (
        "project_colnorms", "project", "project_tangent_colnorms",
        "fused_update")}
    if routes != {"project_colnorms": "cuda-cores", "project": "cuda-cores",
                  "project_tangent_colnorms": "cuda-cores",
                  "fused_update": "wgmma-tma"}:
        raise AssertionError(f"accum 2 routes {routes}")
    print(f"[train] llama-1b accum 2: grad_tap launches 0, routes {routes}",
          flush=True)
    res.pop("state")
    results["accum"] = res
    # accum 2 against accum 1 on one batch and one set of params
    params = params_copy()
    b = {key: v.cuda() for key, v in batch_at(0).items()}
    sums = {}
    for accum in (1, 2):
        loss, _, grads = accumulated_grads(bundle, params, b, "full", accum)
        sums[accum] = (float(loss), float(global_norm(grads)))
        del grads
    del params
    loss_rel = abs(sums[2][0] - sums[1][0]) / abs(sums[1][0])
    gnorm_rel = abs(sums[2][1] - sums[1][1]) / sums[1][1]
    if not (loss_rel <= ACCUM_LOSS_REL and gnorm_rel <= ACCUM_GNORM_REL):
        raise AssertionError(f"accum 2 vs 1: loss {sums[2][0]} vs "
                             f"{sums[1][0]}, norm {sums[2][1]} vs "
                             f"{sums[1][1]}")
    print(f"[train] llama-1b one batch, accum 2 vs 1: loss {sums[2][0]:.6f} "
          f"vs {sums[1][0]:.6f} ({loss_rel:.2e}, budget {ACCUM_LOSS_REL:g}),"
          f" gradient norm {sums[2][1]:.6f} vs {sums[1][1]:.6f} "
          f"({gnorm_rel:.2e}, budget {ACCUM_GNORM_REL:g})", flush=True)

    # (b) remat full, dots, none from the same start
    for remat in ("full", "dots", "none"):
        res = go(f"remat {remat}", subtrack, opt_copy(), remat=remat)
        if res["launches"] != want:
            raise AssertionError(f"remat {remat} launches "
                                 f"{res['launches']}, want {want}")
        res.pop("state")
        results[f"remat_{remat}"] = res
    full0, dots0 = (results[f"remat_{r}"]["losses"][0]
                    for r in ("full", "dots"))
    if not abs(dots0 - full0) <= REMAT_LOSS_REL * abs(full0):
        raise AssertionError(f"step 0 loss: dots {dots0}, full {full0}")

    # (c) grass: its own warm start, then 4 steps
    grass = get_optimizer("subtrack", method="grass", rank=RANK_1B,
                          update_interval=k, eta=10.0, use_kernels=True)
    params = params_copy()
    ops.reset_launch_counts()
    warm, _ = make_warm_start(bundle, grass)(
        TrainState(params=params, opt=grass.init(params)),
        {key: v.cuda() for key, v in batch_at(0).items()})
    del params
    n_leaves = _one_hot_bases(warm.opt)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"grass warm start launched "
                             f"{ops.launch_counts()}")
    res = go("grass", grass, warm.opt)
    del warm
    _one_hot_bases(res.pop("state").opt)
    # the projection is the program's row gather: no project_colnorms
    want_grass = dict(want, project_tangent_colnorms=0, project=0,
                      project_colnorms=0)
    if res["launches"] != want_grass:
        raise AssertionError(f"grass launches {res['launches']}, want "
                             f"{want_grass}")
    print(f"[train] llama-1b grass: S one-hot in all {n_leaves} low-rank "
          f"leaves after the warm start and after the tracking step",
          flush=True)
    results["grass"] = res

    # (d) the dense baselines
    params = params_copy()
    state_bytes = {"subtrack": subtrack.state_bytes(params)}
    for name in ("adamw", "badam"):
        opt = get_optimizer(name)
        state_bytes[name] = opt.state_bytes(params)
        res = go(name, opt)
        if any(res["launches"].values()):
            raise AssertionError(f"{name} launched {res['launches']}")
        res.pop("state")
        results[name] = res
    del params
    peaks = {"subtrack": results["remat_full"]["peak_gib"],
             "adamw": results["adamw"]["peak_gib"],
             "badam": results["badam"]["peak_gib"]}
    print("[train] llama-1b optimizer state (state_bytes) and peak memory "
          "above what the phase holds: "
          + ", ".join(f"{name} {state_bytes[name] / 2**30:.2f} GiB state, "
                      f"peak {peaks[name]:.2f} GiB" for name in peaks),
          flush=True)
    del start
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The runtime around the training step (phase 22)
# ---------------------------------------------------------------------------

RESTART_RTOL = 1e-4   # the restarted run's losses against the uninterrupted


def _clone_state(state):
    """A device copy of a TrainState (params and every state tensor)."""
    from repro_torch.core.subtrack import OptState, tree_map
    from repro_torch.launch.steps import TrainState

    return TrainState(
        params=tree_map(torch.clone, state.params),
        opt=OptState(step=state.opt.step, n_updates=state.opt.n_updates,
                     inner=tree_map(lambda st: type(st)(
                         *(t.clone() for t in st)), state.opt.inner)))


def _state_tensors(state) -> list:
    from repro_torch.core.subtrack import tree_leaves

    return tree_leaves(state.params) + [
        t for st in tree_leaves(state.opt.inner) for t in st]


def _same_state(a, b) -> bool:
    return ((a.opt.step, a.opt.n_updates) == (b.opt.step, b.opt.n_updates)
            and all(torch.equal(x, y) for x, y in zip(_state_tensors(a),
                                                       _state_tensors(b))))


def _linked_copy(src: Path, dst: Path) -> None:
    """A checkpoint directory whose files are hard links of ``src``'s:
    each run resumes from the same step without another 7.9 GB write."""
    import shutil

    shutil.copytree(src, dst, copy_function=os.link)


def _train_logged(argv):
    """``train(argv)``'s summary and printed log (echoed)."""
    import contextlib
    import io

    from repro_torch.launch.train import train

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = train(argv)
    finally:
        print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


def phase_runtime_1b(trained_1b: dict) -> None:
    """Phase 22: the runtime around llama-1b's training step, from phase
    16's final state (after its step 3): (a) a known-good checkpoint of
    it, restored bit for bit, and a CLI run resuming from it with no warm
    start; (b) nan-grad quarantines one plain and one tracking step bit
    for bit with exact launch counts; (c) sigma-blowup clamps theta
    without a quarantine; (d) loss-spike gives exactly one rollback to the
    known-good step and a finite final loss; (e) a run failed at a step
    and restarted matches the uninterrupted losses; (f) ckpt-io-error is
    absorbed by the retry.  (a), (d) and (f) are one CLI run."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.transpose import state_program_records
    from repro_torch.configs.registry import get_config
    from repro_torch.core import health
    from repro_torch.core.api import get_optimizer
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                           fetch_batch)
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (checkpoint_descriptors,
                                          make_train_step)
    from repro_torch.launch.train import BLOWUP_ETA_SCALE
    from repro_torch.models.api import build_model

    t_phase = time.perf_counter()
    done, k, batch, seq = 4, 2, 4, 512
    cfg = get_config("llama-1b")
    state = trained_1b.pop("state")
    opt = get_optimizer("subtrack", rank=RANK_1B, update_interval=k,
                        eta=10.0, use_kernels=True)
    # each llama-1b checkpoint is ~7.9 GB: a fresh directory in the
    # checkout's git-ignored build directory, on the checkout's disk
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build"))
    try:
        usage = shutil.disk_usage(root)
        card = phase_device()
        print(f"[runtime] {card}; checkpoints under {root}: "
              f"{usage.free / 2**30:.1f} GiB free of "
              f"{usage.total / 2**30:.1f} GiB", flush=True)
        # (a) a known-good checkpoint of phase 16's final state
        mgr = CheckpointManager(root / "base")
        extra = state_program_records(
            state, checkpoint_descriptors(state.params, opt))
        mgr.save(done - 1, state, blocking=True, extra_meta=extra,
                 known_good=True)
        saved = dict(mgr.last_save)
        if usage.free < 4 * saved["bytes"]:
            raise AssertionError(f"{usage.free} B free: phase 22 keeps up to"
                                 f" 4 checkpoints of {saved['bytes']} B")
        t0 = time.perf_counter()
        back, at = mgr.restore(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if at != done - 1 or not _same_state(back, state):
            raise AssertionError("restored checkpoint differs from the saved "
                                 "state")
        del back
        print(f"[runtime] llama-1b checkpoint of step {done - 1}: "
              f"{saved['bytes'] / 1e9:.3f} GB; snapshot to host "
              f"{saved['snapshot_s']:.2f} s, write {saved['write_s']:.2f} s"
              f", restore onto the card {restore_s:.2f} s, bit for bit",
              flush=True)

        # (b), (c): single steps on copies of the state
        step = make_train_step(build_model(cfg), opt)
        data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                             seq_len=seq, global_batch=batch,
                                             seed=SEED))
        b, ok = fetch_batch(cfg, data, done)
        if not ok:
            raise AssertionError(f"llama-1b: batch {done} rejected")
        b = {key: v.cuda() for key, v in b.items()}
        for tracking in (False, True):
            copy = _clone_state(state)
            ops.reset_launch_counts()
            after, m = step(copy, b, 1e-3, do_subspace_update=tracking,
                            inject=health.INJECT_NAN_GRAD)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            want = _launches_want(1, int(tracking), single_front=True)
            kind = "tracking" if tracking else "plain"
            if not (float(m["quarantined"]) == 1.0
                    and math.isfinite(float(m["loss"]))
                    and _same_state(after, state)):
                raise AssertionError(f"nan-grad {kind} step not quarantined "
                                     f"bit for bit: {m}")
            if launches != want:
                raise AssertionError(f"nan-grad {kind} step launches "
                                     f"{launches}, want {want}")
            print(f"[runtime] nan-grad {kind} step: quarantined, every param "
                  f"and state tensor equal, step {after.opt.step}, launches "
                  f"as a healthy step's", flush=True)
            del copy, after
        diags = {}
        for scale in (1.0, BLOWUP_ETA_SCALE):
            copy = _clone_state(state)
            _, m = step(copy, b, 1e-3, do_subspace_update=True,
                        eta_scale=scale)
            diags[scale] = {key: float(m[key]) for key in (
                "loss", "sigma", "theta", "theta_clamped", "geo_degenerate",
                "quarantined", "update_norm")}
            del copy
        blow = diags[BLOWUP_ETA_SCALE]
        if not (blow["theta_clamped"] == 1.0 and blow["quarantined"] == 0.0
                and math.isfinite(blow["loss"])
                and abs(blow["theta"] - health.THETA_MAX) <= 1e-6):
            raise AssertionError(f"sigma-blowup: {blow}")
        print(f"[runtime] tracking step health at eta 10: {diags[1.0]}; with "
              f"sigma-blowup (eta x {BLOWUP_ETA_SCALE:g}): {blow}",
              flush=True)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()

        base = ["--arch", "llama-1b", "--optimizer", "subtrack",
                "--use-kernels", "--steps", "14", "--update-interval",
                str(k), "--warmup", "2", "--batch", str(batch), "--seq",
                str(seq), "--eta", "10", "--remat", "full", "--seed",
                str(SEED), "--log-every", "1"]
        stepdir = f"step_{done - 1:010d}"
        # (a) resume, (d) loss-spike, (f) ckpt-io-error: one CLI run
        _linked_copy(root / "base" / stepdir, root / "spike" / stepdir)
        ops.reset_launch_counts()
        spike, log = _train_logged(base + [
            "--checkpoint-dir", str(root / "spike"), "--checkpoint-every",
            "50", "--inject", "ckpt-io-error@4,loss-spike@9"])
        hist = spike["history"]
        n_track = sum(1 for h in hist if h["subspace_update"])
        want = _launches_want(len(hist), n_track, single_front=True)
        actions = [e["action"] for e in spike["sentinel_events"]]
        if not (spike["start_step"] == done and spike["warm_start_s"] is None
                and "no warm start" in log):
            raise AssertionError(f"resume: start {spike['start_step']}, warm "
                                 f"start {spike['warm_start_s']}")
        if not (spike["rollbacks"] == 1 and actions[-1] == "rollback"
                and actions.count("rollback") == 1
                and "rolled back to known-good checkpoint step "
                f"{done - 1}" in log
                and math.isfinite(spike["final_loss"])):
            raise AssertionError(f"loss-spike: rollbacks {spike['rollbacks']}"
                                 f", events {spike['sentinel_events']}, final"
                                 f" loss {spike['final_loss']}")
        if not ("attempt 2 failed" in log and (
                root / "spike" / "step_0000000013" / "KNOWN_GOOD").exists()):
            raise AssertionError("ckpt-io-error: the retried save did not "
                                 "land")
        if spike["launch_counts"] != want:
            raise AssertionError(f"loss-spike run launches "
                                 f"{spike['launch_counts']}, want {want}")
        print(f"[runtime] resumed at step {done} with no warm start; "
              f"loss-spike@9 -> {actions}, one rollback to step {done - 1}, "
              f"{len(hist)} steps run ({n_track} tracking), final loss "
              f"{spike['final_loss']:.4f}; ckpt-io-error absorbed by the "
              "retry", flush=True)
        shutil.rmtree(root / "spike")

        # (e) fail at step 6 (a checkpoint at 5), restart, match (d)'s
        # uninterrupted steps 6..9
        _linked_copy(root / "base" / stepdir, root / "restart" / stepdir)
        ck = ["--checkpoint-dir", str(root / "restart"),
              "--checkpoint-every", "5"]
        try:
            _train_logged(base + ck + ["--fail-at-step", "6"])
        except RuntimeError as e:
            if "failure-injection" not in str(e):
                raise
        else:
            raise AssertionError("--fail-at-step 6 did not fail")
        resumed, _ = _train_logged(base + ck)
        first = {}
        for h in hist:
            first.setdefault(h["step"], h["loss"])
        got = {h["step"]: h["loss"] for h in resumed["history"]}
        rel = max(abs(got[s] - first[s]) / abs(first[s]) for s in range(6, 10))
        if not (resumed["start_step"] == 6 and rel <= RESTART_RTOL):
            raise AssertionError(f"restart: start {resumed['start_step']}, "
                                 f"losses {got} vs {first} ({rel:.2e})")
        print(f"[runtime] failed at step 6, restarted from the step-5 "
              f"checkpoint: losses of steps 6-9 within {rel:.2e} of the "
              f"uninterrupted run's (budget {RESTART_RTOL:g})", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[runtime] phase 22: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# The decoder family's variants: gemma2-27b, minicpm3-4b, qwen2-vl-2b
# ---------------------------------------------------------------------------

VARIANT_ARCHS = ("gemma2-27b", "minicpm3-4b", "qwen2-vl-2b")
VARIANT_LAYERS = 2        # full width, depth cut (gemma2: one local, one global)
VARIANT_K = 2             # update interval: plain 0, 1, 3; tracking 2
VARIANT_STEPS = 4
VARIANT_ETA = 10.0        # the paper's, as phases 11 and 16
VARIANT_RUNS = {          # arch -> (train batch, train seq, serve prompt)
    "gemma2-27b": (1, 5120, 5120),   # past the 4096 window on local layers
    "minicpm3-4b": (2, 512, 512),
    "qwen2-vl-2b": (2, 2048, 2048),  # at least its 1024 vision tokens
}
VARIANT_GEN = 16          # decode steps a served request takes
VARIANT_AGREE = 0.9       # tests/test_models.py: argmax agreement
VARIANT_P90 = 0.12        # ... and p90 |delta| < 0.12 scale + 0.12
# (label, m, n, r, matrices, G a transposed view): the slice's new shapes
VARIANT_OPT_SHAPES = (
    ("gemma2 embed", 4608, 256000, 512, 1, True),
    ("gemma2 w_gate", 4608, 36864, 512, 2, False),
)
VARIANT_FRONT_SHAPES = (
    ("minicpm3 w_dq", 768, 2560, 512, 2, True),
    ("minicpm3 w_uq", 768, 3840, 512, 2, False),
    ("qwen2-vl embed", 1536, 152064, 256, 1, True),
)
VARIANT_TAP = ("gemma2 w_gate", 5120, 4608, 36864, 512)   # (b, m, n, r)


def _variant_inputs(m, n, r, b, transposed, seed):
    """``_opt_inputs`` for ``b`` matrices in bf16, drawn a matrix at a
    time (a (4608, 256000) fp32 draw is 4.7 GB)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    G = torch.empty((b, n, m) if transposed else (b, m, n),
                    dtype=torch.bfloat16, device="cuda")
    for i in range(b):
        G[i] = rn(*G.shape[1:])
    return dict(S=torch.linalg.qr(rn(b, m, r))[0].contiguous(),
                G=G.mT if transposed else G, M=0.1 * rn(b, r, n),
                V=0.01 * rn(b, r, n).abs(), phi=rn(b, n).abs(),
                clip=torch.tensor([0.9, 0.25], device="cuda").repeat(
                    -(-b // 2))[:b])


def _variant_bound(name, m, n, r, b) -> tuple[float, str]:
    """(bound ms, bound_by) of one call at (m, n, r) x b with bf16 G: the
    bytes it must move at the memory rate against its operations at each
    type's peak (``_tc_work``; phases 8 and 14 write these out)."""
    g = 2
    nbytes = {
        "project": b * (4 * m * r + g * m * n + 4 * r * n),
        "project_colnorms": b * (4 * m * r + g * m * n + 4 * r * n + 4 * n),
        "tangent": b * (g * m * n + 4 * r * n + 8 * m * r),
        "adam_lowrank_norms": b * (24 * r * n + 8 * n),
        "fused_update": b * (2 * g * m * n + 4 * m * r + 8 * r * n + 4 * n
                             + 12),
        "project_tangent_colnorms": b * (4 * m * r + g * m * n + 4 * r * n
                                         + 4 * n + 4 * m * r),
    }[name]
    tc = _tc_work(name, m, n, r, b)
    t_ops = ((sum(p * f for p, f in tc[0]) / BF16_FLOPS
              + tc[1] / FP32_FLOPS) * 1e3 if tc
             else b * 16 * r * n / FP32_FLOPS * 1e3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _record_kernel(out, tag, name, label, kern, plain, parts, rel, m, n, r,
                   b, iters, library=None) -> None:
    """Check one kernel call against its plain version (each part within
    ``rel[part]`` of its largest entry), then time both (CUDA events), and
    ``library`` (one PyTorch call for the same function, or None) beside
    them, and put the times, the bound and the route in
    ``out[name][label]``."""
    from repro_torch.kernels import grassmann as gk

    got = kern()
    torch.cuda.synchronize()
    want = plain()
    line = []
    err = 0.0
    for part, g_, w_ in parts(got, want):
        abs_err, e = _opt_error(g_, w_)
        if e > rel[part]:
            raise AssertionError(f"{name} at {label} ({m}, {n}, r {r}) "
                                 f"x{b} {part}: error {e:.3e} of the "
                                 f"largest entry > {rel[part]:g}")
        err = max(err, abs_err)
        line.append(f"{part} {abs_err:.2e} ({e:.1e})")
    del got, want
    route = getattr(getattr(gk, name), "route", None)
    ms = _time_ms(kern, iters=iters, repeats=3)
    plain_ms = _time_ms(plain, iters=1, repeats=3)
    library_ms = (None if library is None
                  else _time_ms(library, iters=1, repeats=3))
    bound, by = _variant_bound(name, m, n, r, b)
    out.setdefault(name, {})[label] = {
        "shape": [m, n, r, b], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
        "max_abs_err": err, "route": route}
    lib = "" if library is None else f", library {library_ms:.4f} ms"
    print(f"[{tag}] {name} {label} ({m}, {n}, r {r}) x{b} bf16 G: "
          f"max abs err (of largest) {', '.join(line)}; kernel "
          f"{ms:.4f} ms (CUDA events), bound {bound:.4f} ms ({by}), "
          f"plain {plain_ms:.4f} ms{lib}, route {route}", flush=True)


def _time_opt_shapes(out, tag, shapes, seed0, library=False,
                     only=None) -> None:
    """The optimizer step's kernels (project_colnorms, the tracking front
    end, project, adam_lowrank_norms, fused_update; those named in
    ``only`` where it is given) at each (label, m, n, r, matrices, G a
    transposed view) of ``shapes``, through :func:`_record_kernel`.  The
    front end is the dispatch's: tangent after project_colnorms past
    ``MAX_FRONT_M``, else the single-launch project_tangent_colnorms
    (``FRONT_REL``).  With ``library`` also phase 8's PyTorch yardsticks
    where one call computes the same function (project, tangent,
    fused_update)."""
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ref

    def one(name):
        return lambda g, w: [(name, g, w)], OPT_REL

    for i, (label, m, n, r, b, tr) in enumerate(shapes):
        x = _variant_inputs(m, n, r, b, tr, seed0 + i)
        S, G, M, V, phi, clip = (x[k] for k in ("S", "G", "M", "V", "phi",
                                                "clip"))
        A, _ = ref.project_colnorms_ref(S, G)
        Gto = ref.adam_lowrank_norms_ref(A, M, V, 3, 0.9, 0.999, 1e-8)[2]
        front = ({"tangent": (lambda: gk.tangent(G, A, S),
                              lambda: ref.tangent_ref(G, A, S),
                              *one("tangent"))}
                 if m > gk.MAX_FRONT_M else
                 {"project_tangent_colnorms": (
                     lambda: gk.project_tangent_colnorms(S, G),
                     lambda: ref.project_tangent_colnorms_ref(S, G),
                     lambda g, w: zip(("A", "gsq", "T"), g, w), FRONT_REL)})
        calls = {
            "project_colnorms": (lambda: gk.project_colnorms(S, G),
                                 lambda: ref.project_colnorms_ref(S, G),
                                 *one("project_colnorms")),
            **front,
            "project": (lambda: gk.project(S, G),
                        lambda: ref.project_ref(S, G), *one("project")),
            "adam_lowrank_norms": (
                lambda: gk.adam_lowrank_norms(A, M, V, 3),
                lambda: ref.adam_lowrank_norms_ref(A, M, V, 3, 0.9, 0.999,
                                                   1e-8),
                *one("adam_lowrank_norms")),
            "fused_update": (
                lambda: gk.fused_update(G, S, A, Gto, phi, 0.01, clip,
                                        out_dtype=G.dtype),
                lambda: ref.fused_update_ref(G, S, A, Gto, phi, 0.01, clip,
                                             out_dtype=G.dtype),
                *one("fused_update")),
        }
        lib = {}
        if library:   # phase 8's yardsticks, D formed beforehand
            phic = phi * clip[:, None]
            D = Gto - phic[:, None, :] * A
            Gphic = G.float() * phic[:, None, :]
            lib = {"project": lambda: S.mT @ G.float(),
                   "tangent": lambda: -2.0 * (G.float() @ A.mT)
                   + 2.0 * (S @ (A @ A.mT)),
                   "fused_update": lambda: torch.baddbmm(Gphic, S, D)}
        for name, (kern, plain, parts, rel) in calls.items():
            if only is None or name in only:
                _record_kernel(out, tag, name, label, kern, plain, parts,
                               rel, m, n, r, b, iters=3,
                               library=lib.get(name))
        del x, S, G, M, V, phi, clip, A, Gto, calls, lib
        gc.collect()
        torch.cuda.empty_cache()


def phase_variant_kernels() -> dict:
    """Phase 24 (a): the kernels the three variants run, at the shapes no
    earlier phase gave them, against their plain versions (``OPT_REL``,
    ``FRONT_REL``, ``TAP_REL``) and timed beside their bounds and plain
    versions; and the embedding's warm-start SVD alone."""
    from repro_torch.core.subspace import init_subspace_svd
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ref

    out: dict = {}
    _time_opt_shapes(out, "variants", VARIANT_OPT_SHAPES, SEED)
    _time_opt_shapes(out, "variants", VARIANT_FRONT_SHAPES, SEED + 10,
                     only=("project_tangent_colnorms",))
    label, tb, tm, tn, tr_ = VARIANT_TAP
    x, dy, S = _tap_inputs(tb, tm, tn, tr_, torch.bfloat16, SEED)
    got = gk.grad_tap(x, dy, S, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    want = ref.grad_tap_ref(x, dy, S)
    err = 0.0
    for part, g_, w_ in zip(("dW", "A", "gsq"), (got[0], got[1][:-1],
                                                 got[1][-1]), want):
        abs_err, e = _opt_error(g_, w_)
        if e > TAP_REL:
            raise AssertionError(f"grad_tap at {label}: {part} {e:.3e}")
        err = max(err, abs_err)
    del got, want
    ms = _time_ms(lambda: gk.grad_tap(x, dy, S, out_dtype=torch.bfloat16),
                  iters=3, repeats=3)
    plain_ms = _time_ms(lambda: ref.grad_tap_ref(x, dy, S), iters=1,
                        repeats=3)
    nbytes = (2 * tb * tm + 2 * tb * tn + 4 * tm * tr_ + 2 * tm * tn
              + 4 * tr_ * tn + 4 * tn)
    t_ops = ((2 * tb * tm * tn + TAP_PASSES * (2 * tb * tm * tr_
                                               + 2 * tb * tr_ * tn))
             / BF16_FLOPS + 2 * tm * tn / FP32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    out["grad_tap"] = {label: {
        "shape": [tm, tn, tr_, tb], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "max_abs_err": err, "route": gk.grad_tap.route}}
    print(f"[variants] grad_tap {label} ({tm}, {tn}, b {tb}, r {tr_}) bf16: "
          f"max abs err {err:.2e}; kernel {ms:.4f} ms, bound "
          f"{max(t_bytes, t_ops):.4f} ms, plain {plain_ms:.4f} ms, route "
          f"{gk.grad_tap.route}", flush=True)
    del x, dy, S
    # the warm start's largest SVD: gemma2's embedding, (4608, 256000),
    # which gesvd refuses whole: its R^T (4608, 4608) first (subspace.py)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    G = torch.randn((4608, 256000), generator=gen, device="cuda").to(
        torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S = init_subspace_svd(G, 512)
    torch.cuda.synchronize()
    out["svd_embed_s"] = time.perf_counter() - t0
    orth = (S.mT @ S - torch.eye(512, device="cuda")).abs().max().item()
    print(f"[variants] warm-start SVD of gemma2's embedding gradient shape "
          f"(4608, 256000), bf16 G (QR of G^T to R, then gesvd of R^T): "
          f"{out['svd_embed_s']:.2f} s, max |S^T S - I| {orth:.1e}",
          flush=True)
    del G, S
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _plan_launches(cfg, params, rank, steps, tracking, tapped=False) -> dict:
    """Exact launch counts of ``steps`` train steps (``tracking`` of them
    tracking steps), from each leaf's plan: a low-rank leaf launches
    adam_lowrank_norms and fused_update on every step; project_colnorms on
    a plain step, or grad_tap once per layer (once for lm_head) where
    ``tapped`` and the leaf is a tap site; on a tracking step the front
    end (project_tangent_colnorms at m <= MAX_FRONT_M, else
    project_colnorms + tangent) and project."""
    from repro_torch.core.plan import make_plans
    from repro_torch.kernels import grassmann as gk
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import _tap_paths

    want = {name: 0 for name in ops.launch_counts()}
    plain = steps - tracking
    sites = {path: cfg.n_layers if path[0] == "layers" else 1
             for path in _tap_paths(cfg)} if tapped else {}
    for path, plan in _leaf_paths(make_plans(params, rank)):
        if plan.mode != "lowrank":
            continue
        if path in sites:
            want["grad_tap"] += sites[path] * plain
        else:
            want["project_colnorms"] += plain
        want["adam_lowrank_norms"] += steps
        want["fused_update"] += steps
        want["project"] += tracking
        if plan.m <= gk.MAX_FRONT_M:
            want["project_tangent_colnorms"] += tracking
        else:
            want["project_colnorms"] += tracking
            want["tangent"] += tracking
    return want


def phase_variant_smoke() -> None:
    """Phase 24 (b): each variant's fp32 smoke config on CUDA and on the
    CPU from the same params, warm-started state and batches, through
    ``run``, plain and grad-fused (4 steps, tracking at 2, rank 32, eta
    2e-5): losses within ``SMOKE_LOSS_ATOL``, exact launch counts from
    the plans on CUDA, none on the CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import get_optimizer
    from repro_torch.core.subtrack import tree_map
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                           batch_for_model)
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import TrainState, make_warm_start
    from repro_torch.launch.train import run
    from repro_torch.models.api import build_model
    from repro_torch.optim.schedules import cosine_with_warmup

    steps, k, rank = VARIANT_STEPS, VARIANT_K, 32
    tracking = sum(1 for s in range(steps) if s and s % k == 0)
    for arch in VARIANT_ARCHS:
        cfg = get_config(arch, smoke=True).with_(dtype="float32")
        bundle = build_model(cfg)
        opt = get_optimizer("subtrack", rank=rank, update_interval=k,
                            eta=2e-5, use_kernels=True)
        data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                             seq_len=128, global_batch=2,
                                             seed=SEED))
        batches = [batch_for_model(cfg, None, data, s) for s in range(steps)]
        params = bundle.init(torch.Generator().manual_seed(SEED))
        warm, _ = make_warm_start(bundle, opt)(
            TrainState(params=params, opt=opt.init(params)), batches[0])

        def go(device, grad_fused):
            ops.reset_launch_counts()
            out = run(cfg, tree_map(lambda t: t.to(device, copy=True),
                                    params),
                      lambda s: batches[s], optimizer=opt, steps=steps,
                      lr_at=cosine_with_warmup(1e-3, steps, 2),
                      log_every=steps, opt_state=_state_to(warm.opt, device),
                      grad_fused=grad_fused)
            return [h["loss"] for h in out["history"]], ops.launch_counts()

        losses = {}
        for grad_fused in (False, True):
            cuda_losses, cuda_counts = go("cuda", grad_fused)
            cpu_losses, cpu_counts = go("cpu", grad_fused)
            losses[grad_fused] = cuda_losses
            diff = max(abs(a - b) for a, b in zip(cuda_losses, cpu_losses))
            name = f"{arch} smoke {'grad-fused' if grad_fused else 'plain'}"
            if not diff <= SMOKE_LOSS_ATOL:
                raise AssertionError(f"{name}: CUDA {cuda_losses} vs CPU "
                                     f"{cpu_losses} (max diff {diff:.3e})")
            want = _plan_launches(cfg, params, rank, steps, tracking,
                                  tapped=grad_fused)
            if cuda_counts != want or any(cpu_counts.values()):
                raise AssertionError(f"{name} launches: CUDA {cuda_counts} "
                                     f"(want {want}), CPU {cpu_counts}")
            print(f"[variants] {name}, {steps} steps: losses CUDA vs CPU max "
                  f"diff {diff:.2e} (budget {SMOKE_LOSS_ATOL:g}); CUDA "
                  f"launches {({k_: v for k_, v in cuda_counts.items() if v})}",
                  flush=True)
        diff = max(abs(a - b) for a, b in zip(losses[True], losses[False]))
        if not diff <= SMOKE_LOSS_ATOL:
            raise AssertionError(f"{arch} smoke on CUDA: grad-fused "
                                 f"{losses[True]} vs plain {losses[False]}")


def _divisor_block(T: int, block: int) -> int:
    """The largest divisor of T that is at most ``block``: the forward's
    KV blocks must tile the sequence (only the summation order moves);
    P + 16 at the three prompts gives 856, 528 and 688."""
    return max(d for d in range(1, min(block, T) + 1) if T % d == 0)


def phase_variant_full() -> dict:
    """Phase 24 (c, d): each variant at full width and ``VARIANT_LAYERS``
    layers: 4 SubTrack++ steps through ``run`` (kernels on, default rank,
    eta pinned), then its trained weights served through ``run_dense`` and
    teacher-forced against the full forward (the JAX package's
    decode-consistency criteria).  Returns launches and times per arch."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import get_optimizer
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                           batch_for_model, validate_batch)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (AdmissionQueue, Request,
                                          _prefill_inputs, run_dense)
    from repro_torch.launch.steps import default_rank
    from repro_torch.launch.train import run
    from repro_torch.models import transformer as ttf
    from repro_torch.models.api import build_model
    from repro_torch.optim.schedules import cosine_with_warmup

    t_phase = time.perf_counter()
    out = {}
    steps, k = VARIANT_STEPS, VARIANT_K
    for arch in VARIANT_ARCHS:
        full = get_config(arch)
        cfg = full.with_(n_layers=VARIANT_LAYERS)
        batch, seq, P = VARIANT_RUNS[arch]
        rank = default_rank(cfg.d_model)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bundle = build_model(cfg)
        params = bundle.init(torch.Generator(device="cuda").manual_seed(SEED))
        n_params = sum(t.numel() for _, t in _leaf_paths(params))
        print(f"[variants] {arch} cut to size: {full.n_layers} -> "
              f"{cfg.n_layers} layers at full width (d {cfg.d_model}, heads "
              f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.padded_vocab}): {n_params / 1e9:.2f} B params; rank "
              f"{rank}, batch {batch} x {seq}, eta {VARIANT_ETA:g}",
              flush=True)
        opt = get_optimizer("subtrack", rank=rank, update_interval=k,
                            eta=VARIANT_ETA, use_kernels=True)
        data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                             seq_len=seq, global_batch=batch,
                                             seed=SEED))

        def batch_at(step, mutate=None):
            b = batch_for_model(cfg, None, data, step)
            validate_batch(b, cfg.vocab_size)
            return b

        want = _plan_launches(cfg, params, rank, steps,
                              sum(1 for s in range(steps) if s and s % k == 0))
        ops.reset_launch_counts()
        res = run(cfg, params, batch_at, optimizer=opt, steps=steps,
                  lr_at=cosine_with_warmup(1e-3, steps, 2), log_every=1)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        hist = res["history"]
        if not all(h["loss"] is not None and math.isfinite(h["loss"])
                   and not h["quarantined"] for h in hist):
            raise AssertionError(f"{arch}: history {hist}")
        if [h["step"] for h in hist if h["subspace_update"]] != [2]:
            raise AssertionError(f"{arch}: tracking steps wrong: {hist}")
        if launches != want:
            raise AssertionError(f"{arch} launches {launches}, want {want}")
        plain_s = [h["dt"] for h in hist if not h["subspace_update"]]
        track_s = [h["dt"] for h in hist if h["subspace_update"]][0]
        tok_s = batch * seq / (sum(plain_s[1:]) / len(plain_s[1:]))
        rec = {"launches": launches, "warm_start_s": res["warm_start_s"],
               "plain_s": plain_s, "tracking_s": track_s, "tok_s": tok_s,
               "train_peak_gib": peak / 2**30,
               "losses": [h["loss"] for h in hist]}
        print(f"[variants] {arch} train: warm start {res['warm_start_s']:.2f}"
              f" s (loss {res['warm_loss']:.4f}); losses {rec['losses']}; "
              f"plain steps {[round(t, 3) for t in plain_s]} s (step 0 cold),"
              f" tracking {track_s:.3f} s; {tok_s:.1f} tok/s on warm plain "
              f"steps; peak {peak / 2**30:.2f} GiB; launches "
              f"{({k_: v for k_, v in launches.items() if v})}", flush=True)
        params = res.pop("state").params       # drop the optimizer state
        del res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # (d) two requests through the dense engine, then teacher-forced
        stream = SyntheticLMDataset(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=P + VARIANT_GEN,
            global_batch=2, seed=SEED + 1)).global_batch_at(0)["tokens"]
        queue = AdmissionQueue()
        for i in range(2):
            queue.submit(Request(rid=i, prompt=stream[i, :P].numpy(),
                                 max_new=VARIANT_GEN, t_submit=time.time()))
        ops.reset_launch_counts()
        served = run_dense(cfg, bundle, params, queue, batch=2, prompt_len=P)
        if served["requests"] != 2 or any(
                len(v) != VARIANT_GEN for v in served["outputs"].values()) \
                or any(ops.launch_counts().values()):
            raise AssertionError(f"{arch} serve: {served}")
        with torch.no_grad():
            toks = stream.cuda()
            # prefill P, then teacher-force the stream's next VARIANT_GEN
            # tokens: logits at positions P-1 .. P+GEN-1 against the full
            # forward over P + GEN tokens (tests/test_models.py's check)
            T = P + VARIANT_GEN
            logits, cache = bundle.prefill(
                params, _prefill_inputs(cfg, stream[:, :P].numpy(), "cuda"),
                T)
            got = [logits.float().cpu()]
            for i in range(VARIANT_GEN):
                logits, cache = bundle.decode_step(params, cache,
                                                   toks[:, P + i])
                got.append(logits.float().cpu())
            del cache, logits
            fwd = _prefill_inputs(cfg, stream.numpy(), "cuda")
            fcfg = cfg.with_(kv_block=_divisor_block(T, cfg.kv_block))
            full_logits, _ = ttf.decoder_forward(
                params, fwd.pop("tokens"), fcfg, fwd, remat="none")
            want_l = full_logits[:, P - 1:].float().transpose(0, 1).cpu()
            del full_logits, fwd
        got_l = torch.stack(got).numpy()
        want_l = want_l.numpy()
        agree = float((got_l.argmax(-1) == want_l.argmax(-1)).mean())
        p90 = float(np.percentile(np.abs(got_l - want_l), 90))
        scale = float(np.percentile(np.abs(want_l), 90)) + 1e-3
        if not (agree >= VARIANT_AGREE
                and p90 < VARIANT_P90 * scale + VARIANT_P90):
            raise AssertionError(f"{arch} decode vs forward: agreement "
                                 f"{agree:.3f}, p90 {p90:.4f} (scale "
                                 f"{scale:.3f})")
        rec.update(serve_tok_s=served["tok_per_s"],
                   ttft_p50_s=served["ttft_p50_s"],
                   decode_step_ms=served["decode_step_ms_mean"],
                   serve_peak_gib=served["peak_memory_bytes"] / 2**30,
                   agree=agree, p90=p90, scale=scale)
        print(f"[variants] {arch} serve (dense, 2 x {P} + {VARIANT_GEN}): "
              f"{served['tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{served['ttft_p50_s'] * 1e3:.1f} ms, decode step "
              f"{served['decode_step_ms_mean']:.2f} ms, peak "
              f"{rec['serve_peak_gib']:.2f} GiB; teacher-forced decode vs "
              f"full forward: argmax agreement {agree:.3f} (>= "
              f"{VARIANT_AGREE}), p90 |delta| {p90:.4f} < "
              f"{VARIANT_P90 * scale + VARIANT_P90:.4f}", flush=True)
        out[arch] = rec
        del params, got, got_l, want_l, toks
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[variants] phase 24 (c, d): {time.perf_counter() - t_phase:.1f} "
          "s", flush=True)
    return out


def phase_decoder_variants() -> dict:
    """Phase 24: the decoder family's variants (a-d)."""
    t0 = time.perf_counter()
    kernels = phase_variant_kernels()
    phase_variant_smoke()
    runs = phase_variant_full()
    print(f"[variants] phase 24: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"kernels": kernels, "runs": runs}


# ---------------------------------------------------------------------------
# Mixture of experts: mixtral-8x22b and llama4-maverick-400b-a17b
# ---------------------------------------------------------------------------

MOE_ARCHS = ("mixtral-8x22b", "llama4-maverick-400b-a17b")
MOE_LAYERS = 1            # full width, depth cut
MOE_GRAD_REL = 1e-4       # fp32 smoke gradients, CUDA vs CPU, of the largest
MOE_DECODE_REL = 1e-4     # fp32 smoke ring decode vs the full forward
# bf16: the MoE's input (the residual stream after attention), two
# programs' attention against each other, of the largest entry: the bf16
# budget of the port's CPU tests (tests/test_torch_decoder_variants.py)
MOE_INPUT_REL = 2e-2
# mixtral's smoke ring: window cut to 16, a prompt of 24, 8 decode steps
MOE_SMOKE_RING = (16, 24, 8)
MIXTRAL_TRAIN = (1, 6144)            # batch x seq: past the 4096 window
MIXTRAL_SERVE = (4200, 16, 512)      # prompt > T = 4096, decoded, short
# llama4-maverick serving: requests, batch, prompt, decoded, block, chunk
MAVERICK_SERVE = (4, 4, 512, 16, 16, 128)
# (label, m, n, r, matrices, G a transposed view): mixtral's expert stacks
MOE_OPT_SHAPES = (
    ("mixtral wg/wu", 6144, 16384, 1024, 8, False),
    ("mixtral wd", 6144, 16384, 1024, 8, True),
)


class _MoEDrops:
    """Records, while entered, each MoE layer call's keep mask (k, N) and
    its input x (fp32) on the host: ``repro_torch.models.moe``'s
    ``dispatch`` and ``moe_layer`` wrapped, so the layer itself runs
    unchanged.  ``dropped(i)`` -> (N,) bool, the tokens of call i with a
    choice over capacity.  With one layer, x is the residual stream after
    the attention: everything a cache (ring or paged) feeds the MoE."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self.inputs = [], []
        self._real = (moe.dispatch, moe.moe_layer)

        def spy(ids, E, C):
            row, keep = self._real[0](ids, E, C)
            self.calls.append(keep.view(ids.shape[1], ids.shape[0]).cpu())
            return row, keep

        def layer(x, *args, **kwargs):
            self.inputs.append(x.detach().float().cpu())
            return self._real[1](x, *args, **kwargs)

        moe.dispatch, moe.moe_layer = spy, layer
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.dispatch, moe.moe_layer = self._real

    def dropped(self, i: int) -> torch.Tensor:
        return ~self.calls[i].all(0)

    def slots_dropped(self) -> int:
        return int(sum(int((~keep).sum()) for keep in self.calls))


def phase_moe_smoke() -> None:
    """Phase 25 (a): each MoE arch's fp32 smoke config on CUDA and on the
    CPU from the same params: the loss and every gradient (the router's
    included) within ``MOE_GRAD_REL``; 4 steps through ``run`` (plain
    and grad-fused, tracking at 2, rank 32) within ``SMOKE_LOSS_ATOL``
    with exact launch counts from the plans; and mixtral's dense decode
    through a ring cut to 16 slots (a prompt of 24, 8 steps) against the
    full forward on the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import get_optimizer
    from repro_torch.core.subtrack import tree_leaves, tree_map
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                           batch_for_model)
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (TrainState, make_warm_start,
                                          value_and_grad)
    from repro_torch.launch.train import run
    from repro_torch.models import transformer as ttf
    from repro_torch.models.api import build_model
    from repro_torch.optim.schedules import cosine_with_warmup

    steps, k, rank = VARIANT_STEPS, VARIANT_K, 32
    tracking = sum(1 for s in range(steps) if s and s % k == 0)
    for arch in MOE_ARCHS:
        cfg = get_config(arch, smoke=True).with_(dtype="float32")
        bundle = build_model(cfg)
        data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                             seq_len=128, global_batch=2,
                                             seed=SEED))
        batches = [batch_for_model(cfg, None, data, s) for s in range(steps)]
        params = bundle.init(torch.Generator().manual_seed(SEED))
        grads = {}
        for device in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(device, copy=True), params)
            loss, metrics, g = value_and_grad(
                bundle, p, {k_: v.to(device) for k_, v in batches[0].items()},
                "full")
            grads[device] = (float(loss), float(metrics["aux_loss"]),
                             [t.cpu() for t in tree_leaves(g)])
        (l_c, aux_c, g_c), (l_h, aux_h, g_h) = grads["cuda"], grads["cpu"]
        g_err = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(g_c, g_h))
        if not (abs(l_c - l_h) <= 1e-5 * abs(l_h) and aux_h > 0
                and abs(aux_c - aux_h) <= 1e-5 * aux_h
                and g_err <= MOE_GRAD_REL):
            raise AssertionError(f"{arch} smoke: loss CUDA {l_c} CPU {l_h}, "
                                 f"aux {aux_c} / {aux_h}, gradients "
                                 f"{g_err:.3e} of the largest")
        print(f"[moe] {arch} smoke fp32: loss CUDA {l_c:.6f} vs CPU "
              f"{l_h:.6f}, aux {aux_c:.6f} vs {aux_h:.6f}, {len(g_c)} "
              f"gradients within {g_err:.2e} of their largest (budget "
              f"{MOE_GRAD_REL:g})", flush=True)
        opt = get_optimizer("subtrack", rank=rank, update_interval=k,
                            eta=2e-5, use_kernels=True)
        warm, _ = make_warm_start(bundle, opt)(
            TrainState(params=params, opt=opt.init(params)), batches[0])

        def go(device, grad_fused):
            ops.reset_launch_counts()
            out = run(cfg, tree_map(lambda t: t.to(device, copy=True),
                                    params),
                      lambda s: batches[s], optimizer=opt, steps=steps,
                      lr_at=cosine_with_warmup(1e-3, steps, 2),
                      log_every=steps, opt_state=_state_to(warm.opt, device),
                      grad_fused=grad_fused)
            return [h["loss"] for h in out["history"]], ops.launch_counts()

        for grad_fused in (False, True):
            cuda_losses, cuda_counts = go("cuda", grad_fused)
            cpu_losses, cpu_counts = go("cpu", grad_fused)
            diff = max(abs(a - b) for a, b in zip(cuda_losses, cpu_losses))
            name = f"{arch} smoke {'grad-fused' if grad_fused else 'plain'}"
            if not diff <= SMOKE_LOSS_ATOL:
                raise AssertionError(f"{name}: CUDA {cuda_losses} vs CPU "
                                     f"{cpu_losses} (max diff {diff:.3e})")
            want = _plan_launches(cfg, params, rank, steps, tracking,
                                  tapped=grad_fused)
            if cuda_counts != want or any(cpu_counts.values()):
                raise AssertionError(f"{name} launches: CUDA {cuda_counts} "
                                     f"(want {want}), CPU {cpu_counts}")
            print(f"[moe] {name}, {steps} steps: losses CUDA vs CPU max diff "
                  f"{diff:.2e} (budget {SMOKE_LOSS_ATOL:g}); CUDA launches "
                  f"{({k_: v for k_, v in cuda_counts.items() if v})}",
                  flush=True)
    # mixtral's ring: prefill past the window, decode past it again
    window, P, gen = MOE_SMOKE_RING
    cfg = get_config(MOE_ARCHS[0], smoke=True).with_(
        dtype="float32", sliding_window=window)
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(SEED))
    toks = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=P + gen, global_batch=2,
        seed=SEED + 3)).global_batch_at(0)["tokens"].cuda()
    with torch.no_grad():
        logits, cache = bundle.prefill(params, {"tokens": toks[:, :P]},
                                       P + gen + 1)
        got = [logits]
        for i in range(gen):
            logits, cache = bundle.decode_step(params, cache, toks[:, P + i])
            got.append(logits)
        T = cache.kv.k.shape[2]
        full, _ = ttf.decoder_forward(params, toks, cfg, remat="none")
        want = full[:, P - 1:]
        got = torch.stack(got, dim=1)
        rel = ((got - want).abs().max() / want.abs().max()).item()
    if not (T == window and rel <= MOE_DECODE_REL):
        raise AssertionError(f"mixtral smoke ring: {T} slots, decode vs "
                             f"forward {rel:.3e} of the largest")
    print(f"[moe] mixtral smoke fp32 dense decode through a ring of {T} "
          f"slots (window {window}, prompt {P}, {gen} positions to "
          f"{P + gen - 1}): logits within {rel:.2e} of the full forward's "
          f"largest (budget {MOE_DECODE_REL:g})", flush=True)


def _moe_param_count(cfg) -> int:
    """The parameters of a decoder config with MoE MLPs, from its shapes."""
    d, m = cfg.d_model, cfg.moe
    attn_ = d * cfg.hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    mlp = d * m.n_experts + 3 * m.n_experts * d * m.d_ff \
        + 3 * d * m.shared_d_ff * m.n_shared_experts
    head = 0 if cfg.tie_embeddings else d * cfg.padded_vocab
    return cfg.n_layers * (attn_ + mlp + 2 * d) + d * cfg.padded_vocab \
        + head + d


def _agreement(got, want, keep) -> tuple[float, float, float]:
    """tests/test_models.py's criteria over the kept positions: argmax
    agreement, p90 |delta| and its scale."""
    import numpy as np

    g, w = got[keep].numpy(), want[keep].numpy()
    agree = float((g.argmax(-1) == w.argmax(-1)).mean())
    p90 = float(np.percentile(np.abs(g - w), 90))
    scale = float(np.percentile(np.abs(w), 90)) + 1e-3
    return agree, p90, scale


def phase_moe_mixtral() -> dict:
    """Phase 25 (b, c): mixtral-8x22b at full width, ``MOE_LAYERS`` layer:
    4 SubTrack++ steps through ``run`` (batch 1 x 6144, default rank,
    kernels on, eta pinned), exact launch counts from the plans; the aux
    loss and the token slots dropped at capacity on batch 0 after
    training; then the seed's weights served through ``run_dense``: one
    request of 4200 + 16 (the ring's roll and its prefill positions past
    T = 4096) and one short one, and the long one teacher-forced against
    the full forward where neither dropped a choice of the position (the
    positions left out printed)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import get_optimizer
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                           batch_for_model, validate_batch)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import AdmissionQueue, Request, run_dense
    from repro_torch.launch.steps import default_rank
    from repro_torch.launch.train import run
    from repro_torch.models import transformer as ttf
    from repro_torch.models.api import build_model
    from repro_torch.optim.schedules import cosine_with_warmup

    t_phase = time.perf_counter()
    steps, k = VARIANT_STEPS, VARIANT_K
    full = get_config(MOE_ARCHS[0])
    cfg = full.with_(n_layers=MOE_LAYERS)
    batch, seq = MIXTRAL_TRAIN
    rank = default_rank(cfg.d_model)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for _, t in _leaf_paths(params))
    print(f"[moe] mixtral-8x22b cut to size: {full.n_layers} -> "
          f"{cfg.n_layers} layer at full width (d {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} of d_ff {cfg.moe.d_ff}, window "
          f"{cfg.sliding_window}, vocab {cfg.padded_vocab}): "
          f"{n_params / 1e9:.2f} B params; rank {rank}, batch {batch} x "
          f"{seq}, eta {VARIANT_ETA:g}", flush=True)
    opt = get_optimizer("subtrack", rank=rank, update_interval=k,
                        eta=VARIANT_ETA, use_kernels=True)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq, global_batch=batch,
                                         seed=SEED))

    def batch_at(step, mutate=None):
        b = batch_for_model(cfg, None, data, step)
        validate_batch(b, cfg.vocab_size)
        return b

    want = _plan_launches(cfg, params, rank, steps,
                          sum(1 for s in range(steps) if s and s % k == 0))
    ops.reset_launch_counts()
    res = run(cfg, params, batch_at, optimizer=opt, steps=steps,
              lr_at=cosine_with_warmup(1e-3, steps, 2), log_every=1)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = res["history"]
    if not all(h["loss"] is not None and math.isfinite(h["loss"])
               and not h["quarantined"] for h in hist):
        raise AssertionError(f"mixtral: history {hist}")
    if [h["step"] for h in hist if h["subspace_update"]] != [2]:
        raise AssertionError(f"mixtral: tracking steps wrong: {hist}")
    used = ("project", "project_colnorms", "tangent", "fused_update",
            "adam_lowrank_norms")
    if launches != want or not all(launches[n] for n in used):
        raise AssertionError(f"mixtral launches {launches}, want {want}")
    plain_s = [h["dt"] for h in hist if not h["subspace_update"]]
    track_s = [h["dt"] for h in hist if h["subspace_update"]][0]
    tok_s = batch * seq / (sum(plain_s[1:]) / len(plain_s[1:]))
    params = res.pop("state").params       # drop the optimizer state
    warm_s = res["warm_start_s"]
    del res
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad(), _MoEDrops() as drops:
        b0 = {k_: v.cuda() for k_, v in batch_at(0).items()}
        loss0, metrics = bundle.loss(params, b0, remat="none")
    aux = float(metrics["aux_loss"])
    slots = batch * seq * cfg.moe.top_k * cfg.n_layers
    rec = {"launches": launches, "warm_start_s": warm_s,
           "plain_s": plain_s, "tracking_s": track_s, "tok_s": tok_s,
           "train_peak_gib": peak / 2**30,
           "losses": [h["loss"] for h in hist], "aux_loss": aux,
           "slots_dropped": drops.slots_dropped(), "slots": slots}
    print(f"[moe] mixtral-8x22b train: warm start {warm_s:.2f} s; losses "
          f"{rec['losses']}; plain steps {[round(t, 3) for t in plain_s]} s "
          f"(step 0 cold), tracking {track_s:.3f} s; {tok_s:.1f} tok/s on "
          f"warm plain steps; peak {peak / 2**30:.2f} GiB; batch 0 after "
          f"training: aux loss {aux:.6f}, {rec['slots_dropped']} of {slots} "
          f"token slots dropped at capacity (factor "
          f"{cfg.moe.capacity_factor:g}); launches "
          f"{({k_: v for k_, v in launches.items() if v})}", flush=True)
    # (c) dense serving through the ring, from the seed's weights (as
    # launch/serve.py draws them): four steps at lr 1e-3 move the router's
    # logits by several units a step and routing collapses onto a few
    # experts
    del b0, loss0, metrics, params
    P, gen, P_short = MIXTRAL_SERVE
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = bundle.init(torch.Generator(device="cuda").manual_seed(SEED))
    stream = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=P + gen, global_batch=1,
        seed=SEED + 1)).global_batch_at(0)["tokens"]
    short = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=P_short, global_batch=1,
        seed=SEED + 2)).global_batch_at(0)["tokens"]
    # the prefill's KV blocks must tile the prompt, as the JAX package's
    # (1024 does not divide 4200): only the summation order moves
    served, blocks = {}, {}
    ops.reset_launch_counts()
    for name, prompt in (("long", stream[0, :P]), ("short", short[0])):
        scfg = cfg.with_(kv_block=_divisor_block(len(prompt), cfg.kv_block))
        sbundle = build_model(scfg)
        blocks[name] = scfg.kv_block
        queue = AdmissionQueue()
        queue.submit(Request(rid=0, prompt=prompt.numpy(), max_new=gen,
                             t_submit=time.time()))
        served[name] = run_dense(scfg, sbundle, params, queue, batch=1,
                                 prompt_len=len(prompt))
        if served[name]["requests"] != 1 or len(
                served[name]["outputs"][0]) != gen:
            raise AssertionError(f"mixtral serve {name}: {served[name]}")
    if any(ops.launch_counts().values()):
        raise AssertionError(f"mixtral dense serving launched "
                             f"{ops.launch_counts()}")
    serve_peak = torch.cuda.max_memory_allocated()
    sbundle = build_model(cfg.with_(kv_block=blocks["long"]))
    with torch.no_grad():
        toks = stream.cuda()
        with _MoEDrops() as pre:
            logits, cache = sbundle.prefill(params, {"tokens": toks[:, :P]},
                                            P + gen)
        got = [logits.float().cpu()]
        with _MoEDrops() as dec:
            for i in range(gen):
                logits, cache = sbundle.decode_step(params, cache,
                                                    toks[:, P + i])
                got.append(logits.float().cpu())
        T = cache.kv.k.shape[2]
        del cache, logits
        fcfg = cfg.with_(kv_block=_divisor_block(P + gen, cfg.kv_block))
        with _MoEDrops() as fwd:
            full_logits, _ = ttf.decoder_forward(params, toks, fcfg,
                                                 remat="none")
        want_l = full_logits[0, P - 1:].float().cpu()
        del full_logits
    got_l = torch.stack([g[0] for g in got])
    # one layer: the MoE's input (the residual stream after the ring's
    # attention) at every position, prefill's last and each decode step,
    # against the forward's; a position's logits move only with its own
    # MoE output, so the logits compare where neither the forward nor (at
    # P - 1) the prefill dropped a choice of that position
    h_got = torch.cat([pre.inputs[0][0, -1:]]
                      + [x[0] for x in dec.inputs])
    h_want = fwd.inputs[0][0, P - 1:]
    h_rel = ((h_got - h_want).abs().max() / h_want.abs().max()).item()
    keep = ~fwd.dropped(0)[P - 1:]
    keep[0] = keep[0] & ~pre.dropped(0)[P - 1]
    left_out = int((~keep).sum())
    fwd_dropped = fwd.slots_dropped()
    agree, p90, scale = (_agreement(got_l, want_l, keep) if int(keep.sum())
                         else (math.nan, math.nan, math.nan))
    if not (T == cfg.sliding_window and h_rel <= MOE_INPUT_REL
            and (not int(keep.sum()) or (
                agree >= VARIANT_AGREE
                and p90 < VARIANT_P90 * scale + VARIANT_P90))):
        raise AssertionError(f"mixtral ring decode vs forward: {T} slots, "
                             f"MoE input {h_rel:.3e} of the largest, "
                             f"{int(keep.sum())} logit positions compared, "
                             f"agreement {agree:.3f}, p90 {p90:.4f} (scale "
                             f"{scale:.3f})")
    rec.update(serve={n: {"tok_s": s["tok_per_s"],
                          "ttft_p50_s": s["ttft_p50_s"],
                          "decode_step_ms": s["decode_step_ms_mean"]}
                      for n, s in served.items()},
               serve_peak_gib=serve_peak / 2**30, moe_input_rel=h_rel,
               agree=agree, p90=p90, scale=scale,
               positions_left_out=left_out,
               forward_slots_dropped=fwd_dropped)
    for (name, s), plen in zip(served.items(), (P, P_short)):
        print(f"[moe] mixtral-8x22b serve (dense, ring of {T} slots, KV "
              f"blocks of {blocks[name]}) {name} request, {plen} + {gen}: "
              f"{s['tok_per_s']:.1f} "
              f"tok/s, TTFT p50 "
              f"{s['ttft_p50_s'] * 1e3:.1f} ms, decode step "
              f"{s['decode_step_ms_mean']:.2f} ms", flush=True)
    print(f"[moe] mixtral-8x22b ring decode (prefill {P} > {T}, then {gen} "
          f"positions) vs full forward, weights from the seed: the MoE's "
          f"input at all {gen + 1} positions within {h_rel:.2e} of the "
          f"largest (budget {MOE_INPUT_REL:g}); logits at the "
          f"{int(keep.sum())} positions where no choice was dropped: argmax "
          f"agreement {agree:.3f} (>= {VARIANT_AGREE}), p90 |delta| "
          f"{p90:.4f} (< {VARIANT_P90:g} scale + {VARIANT_P90:g}); "
          f"{left_out} left out (a choice dropped at capacity in the "
          f"forward or the prefill: the forward dropped {fwd_dropped} of "
          f"{(P + gen) * cfg.moe.top_k} slots, the sequence's tail first); "
          f"serve peak "
          f"{serve_peak / 2**30:.2f} GiB", flush=True)
    del toks, got, got_l, want_l
    rec["no_drop"] = _mixtral_ring_no_drop(cfg, params, stream, P, gen)
    print(f"[moe] phase 25 (b, c): {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _mixtral_ring_no_drop(cfg, params, stream, P: int, gen: int) -> dict:
    """Phase 25 (c), beside the capacity-1.25 check: the same weights and
    tokens at capacity factor E / top_k (C = N: no slot can drop), so the
    ring decode's logits (prefill P, then ``gen`` steps) are held against
    the full forward at every position with phase 24's criteria."""
    from dataclasses import replace

    from repro_torch.models import transformer as ttf
    from repro_torch.models.api import build_model

    ncfg = cfg.with_(moe=replace(cfg.moe, capacity_factor=(
        cfg.moe.n_experts / cfg.moe.top_k)))
    bundle = build_model(ncfg.with_(kv_block=_divisor_block(P,
                                                            cfg.kv_block)))
    fcfg = ncfg.with_(kv_block=_divisor_block(P + gen, cfg.kv_block))
    with torch.no_grad(), _MoEDrops() as drops:
        toks = stream.cuda()
        logits, cache = bundle.prefill(params, {"tokens": toks[:, :P]},
                                       P + gen)
        got = [logits[0].float().cpu()]
        for i in range(gen):
            logits, cache = bundle.decode_step(params, cache, toks[:, P + i])
            got.append(logits[0].float().cpu())
        T = cache.kv.k.shape[2]
        del cache, logits
        full_logits, _ = ttf.decoder_forward(params, toks, fcfg,
                                             remat="none")
        want = full_logits[0, P - 1:].float().cpu()
        del full_logits, toks
    agree, p90, scale = _agreement(torch.stack(got), want,
                                   torch.ones(gen + 1, dtype=torch.bool))
    dropped = drops.slots_dropped()
    if not (T == cfg.sliding_window and dropped == 0
            and agree >= VARIANT_AGREE
            and p90 < VARIANT_P90 * scale + VARIANT_P90):
        raise AssertionError(f"mixtral ring decode vs forward at capacity "
                             f"factor {ncfg.moe.capacity_factor:g}: {T} "
                             f"slots, {dropped} slots dropped, agreement "
                             f"{agree:.3f}, p90 {p90:.4f} (scale "
                             f"{scale:.3f})")
    print(f"[moe] mixtral-8x22b ring decode (prefill {P} > {T}, then {gen} "
          f"positions) vs full forward at capacity factor "
          f"{ncfg.moe.capacity_factor:g} (C = N, the seed's weights): 0 "
          f"slots dropped; logits at all {gen + 1} positions: argmax "
          f"agreement {agree:.3f} (>= {VARIANT_AGREE}), p90 |delta| "
          f"{p90:.4f} (< {VARIANT_P90:g} scale + {VARIANT_P90:g}, scale "
          f"{scale:.3f})", flush=True)
    return {"capacity_factor": ncfg.moe.capacity_factor, "agree": agree,
            "p90": p90, "scale": scale, "slots_dropped": dropped}


def phase_moe_maverick() -> dict:
    """Phase 25 (d): llama4-maverick at full width, ``MOE_LAYERS`` layer,
    served through the paged engine and the dense engine on one set of
    weights: exact paged_attention launches (one per layer per decode
    wave); both engines' programs on the same tokens: the prefills' MoE
    input at the prompt's last position, the dense engine's tokens
    teacher-forced through both decode programs, and the same first
    token wherever neither prefill dropped the prompt's last position at
    capacity; and paged_attention at maverick's decode shape timed beside
    its bound."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (AdmissionQueue, Request, run_dense,
                                          run_paged)
    from repro_torch.models.api import build_model

    t_phase = time.perf_counter()
    full = get_config(MOE_ARCHS[1])
    n_full = _moe_param_count(full)
    print(f"[moe] llama4-maverick-400b-a17b at full depth: "
          f"{n_full / 1e9:.1f} B params, {2 * n_full / 1e9:.1f} GB in bf16, "
          f"as much again for bf16 gradients: training at full width does "
          f"not fit one 80 GB card; it trains at smoke size only (a)",
          flush=True)
    cfg = full.with_(n_layers=MOE_LAYERS)
    requests, batch, P, gen, bs, chunk = MAVERICK_SERVE
    gc.collect()
    torch.cuda.empty_cache()
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _leaf_paths(params))
    print(f"[moe] llama4-maverick cut to size: {full.n_layers} -> "
          f"{cfg.n_layers} layer at full width (d {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, {cfg.moe.n_experts} experts "
          f"top-{cfg.moe.top_k} + {cfg.moe.n_shared_experts} shared of d_ff "
          f"{cfg.moe.d_ff}, vocab {cfg.padded_vocab}): {n_params / 1e9:.2f} "
          f"B params ({_moe_param_count(cfg) / 1e9:.2f} B by the shapes), "
          f"{2 * n_params / 1e9:.1f} GB bf16, drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=P, global_batch=requests,
        seed=SEED)).global_batch_at(0)["tokens"].numpy()
    W = -(-(P + gen) // bs)

    def queue():
        q = AdmissionQueue()
        for i in range(requests):
            q.submit(Request(rid=i, prompt=prompts[i], max_new=gen,
                             t_submit=time.time()))
        return q

    runs, counts = {}, {}
    for engine in ("paged", "dense"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        if engine == "dense":
            runs[engine] = run_dense(cfg, bundle, params, queue(),
                                     batch=batch, prompt_len=P, seed=SEED)
        else:
            runs[engine] = run_paged(cfg, bundle, params, queue(),
                                     batch=batch, block_size=bs,
                                     pool_blocks=1 + batch * W,
                                     max_context=P + gen,
                                     prefill_chunk=chunk, seed=SEED)
            runs[engine]["peak_memory_bytes"] = \
                torch.cuda.max_memory_allocated()
        counts[engine] = ops.launch_counts()
    dense, paged = runs["dense"], runs["paged"]
    for name, r in runs.items():
        lens = sorted(len(t) for t in r["outputs"].values())
        if r["requests"] != requests or lens != [gen] * requests:
            raise AssertionError(f"maverick {name}: {r['requests']} "
                                 f"requests, output lengths {lens}")
    want_paged = {n: 0 for n in counts["paged"]}
    want_paged["paged_attention"] = paged["decode_calls"] * cfg.n_layers
    if counts["paged"] != want_paged or any(counts["dense"].values()):
        raise AssertionError(f"maverick launches: paged {counts['paged']} "
                             f"(want {want_paged}), dense {counts['dense']}")
    # both engines' programs on the same tokens: the dense wave's prefill
    # (B x P tokens, one capacity) and each request's paged chunks (their
    # own), which dropped the prompt's last position; then the dense
    # engine's tokens teacher-forced through both decode programs (a
    # decode wave of B tokens never drops at C = 8), logits compared at
    # every step
    with torch.no_grad():
        toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
        forced = torch.tensor([dense["outputs"][i] for i in range(requests)],
                              dtype=torch.int64, device="cuda")
        with _MoEDrops() as dd:
            _, cache = bundle.prefill(params, {"tokens": toks}, P + gen + 8)
        dense_drop = dd.dropped(0).view(requests, P)[:, P - 1]
        pool = bundle.init_paged_cache(1 + requests * W, bs, "cuda")
        tables = (1 + torch.arange(requests * W, dtype=torch.int32,
                                   device="cuda")).view(requests, W)
        paged_drop, h_paged = [], []
        for i in range(requests):
            with _MoEDrops() as pd:
                for c0 in range(0, P, chunk):
                    bundle.paged_prefill_chunk(params, pool,
                                               toks[i:i + 1, c0:c0 + chunk],
                                               tables[i], c0)
            paged_drop.append(bool(pd.dropped(len(pd.calls) - 1)
                                   [(P - 1) % chunk]))
            h_paged.append(pd.inputs[-1][0, (P - 1) % chunk])
        h_dense = dd.inputs[0][:, P - 1]
        h_rel = ((torch.stack(h_paged) - h_dense).abs().max()
                 / h_dense.abs().max()).item()
        live = torch.ones(requests, dtype=torch.bool, device="cuda")
        got_d, got_p = [], []
        for t in range(gen - 1):
            lg, cache = bundle.decode_step(params, cache, forced[:, t])
            got_d.append(lg.float().cpu())
            lens = torch.full((requests,), P + t, dtype=torch.int32,
                              device="cuda")
            got_p.append(bundle.paged_decode_step(
                params, pool, forced[:, t], lens, tables, live).float().cpu())
        del pool, cache, toks, forced
    got_d, got_p = torch.stack(got_d), torch.stack(got_p)
    agree, p90, scale = _agreement(got_p, got_d, torch.ones(
        got_d.shape[:-1], dtype=torch.bool))
    compared = [i for i in range(requests)
                if not (bool(dense_drop[i]) or paged_drop[i])]
    firsts = [(dense["outputs"][i][0], paged["outputs"][i][0])
              for i in compared]
    if not (h_rel <= MOE_INPUT_REL and agree >= VARIANT_AGREE
            and p90 < VARIANT_P90 * scale + VARIANT_P90) \
            or any(a != b for a, b in firsts):
        raise AssertionError(f"maverick dense vs paged: prefill MoE input at "
                             f"the prompt's last position {h_rel:.3e} of the "
                             f"largest; teacher-forced decode agreement "
                             f"{agree:.3f}, p90 {p90:.4f} (scale "
                             f"{scale:.3f}); first tokens over requests "
                             f"{compared}: {firsts}")
    prefix = [_prefix_len(dense["outputs"][i], paged["outputs"][i])
              for i in range(requests)]
    gib = 2**30
    rec = {"paged_attention_launches": counts["paged"]["paged_attention"],
           "decode_calls": paged["decode_calls"], "moe_input_rel": h_rel,
           "decode_agree": agree, "decode_p90": p90,
           "first_tokens_compared": len(compared)}
    for name, r in runs.items():
        step = r.get("decode_wave_ms_mean", r.get("decode_step_ms_mean"))
        rec[name] = {"tok_s": r["tok_per_s"], "ttft_p50_s": r["ttft_p50_s"],
                     "decode_ms": step,
                     "peak_gib": r["peak_memory_bytes"] / gib}
        print(f"[moe] llama4-maverick {name} engine, {requests} requests of "
              f"{P} + {gen}, batch {batch}"
              f"{f', chunk {chunk}, block {bs}' if name == 'paged' else ''}: "
              f"{r['tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{r['ttft_p50_s'] * 1e3:.1f} ms, decode "
              f"{'wave' if name == 'paged' else 'step'} {step:.2f} ms, peak "
              f"{r['peak_memory_bytes'] / gib:.2f} GiB", flush=True)
    print(f"[moe] llama4-maverick: paged_attention launched "
          f"{rec['paged_attention_launches']} times = {paged['decode_calls']} "
          f"decode waves x {cfg.n_layers} layer; the prefills' MoE input at "
          f"the prompt's last position within {h_rel:.2e} of the largest "
          f"(budget {MOE_INPUT_REL:g}); the dense engine's tokens "
          f"teacher-forced through both decode programs, {gen - 1} steps x "
          f"{requests} lanes: argmax agreement {agree:.3f} (>= "
          f"{VARIANT_AGREE}), p90 |delta| {p90:.4f} < "
          f"{VARIANT_P90 * scale + VARIANT_P90:.4f}; first tokens equal in "
          f"{len(compared)} of {requests} requests ({requests - len(compared)}"
          f" left out: the prompt's last position dropped at capacity in a "
          f"prefill); greedy tokens agree on prefixes of {prefix} of {gen}",
          flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # #12 at maverick's decode shape: Hq 40 / Hkv 8, hd 128, the wave's
    # lanes at P + gen
    rec["kernel"] = _paged_times(batch, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 bs, P + gen, "llama4-maverick decode")
    print(f"[moe] phase 25 (d): {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rec


def phase_moe() -> dict:
    """Phase 25: the Mixture-of-Experts configs (a-d) and the optimizer
    kernels at mixtral's expert stacks."""
    t0 = time.perf_counter()
    kernels: dict = {}
    _time_opt_shapes(kernels, "moe", MOE_OPT_SHAPES, SEED + 20)
    phase_moe_smoke()
    mixtral = phase_moe_mixtral()
    maverick = phase_moe_maverick()
    print(f"[moe] phase 25: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"kernels": kernels, "mixtral": mixtral, "maverick": maverick}


# ---------------------------------------------------------------------------
# zamba2-7b: Mamba2's SSD and the shared attention block (phase 26)
# ---------------------------------------------------------------------------

ZAMBA_ARCH = "zamba2-7b"
ZAMBA_LAYERS = 18         # full width, 2 of its 9 groups: the shared block twice
ZAMBA_TRAIN = (1, 4096)   # batch x seq: train_4k's length, 32 chunks of 128
ZAMBA_SERVE = (2048, 8192)   # prompts: 2 requests of the first, 1 of the second
# fp32 smoke zamba, CUDA vs CPU from the same params: the loss, every
# gradient and prefill (of the largest entry), and a decode step whose
# new conv window entries round to the same bf16 values on both
ZAMBA_SMOKE_REL = 1e-5
# a decode step rounds the new token's conv input to bf16 before its conv
# reads it (the reference does); where the two devices' fp32 inputs
# straddle a rounding boundary they round one bf16 step apart, which moved
# the fp32 smoke's outputs by up to 8.6e-5 of their largest against the
# JAX package on the CPU (tests/test_torch_zamba.py)
ZAMBA_DECODE_REL = 5e-4
# the SSD states (and conv windows) after prefill(P) and 16 decode steps
# against prefill(P + 16)'s, of the largest entry.  The reference's own
# gap: its decode reads the conv inputs rounded to bf16, its chunked
# prefill does not; on the CPU at smoke width both packages gave 1.6e-2
# (fp32) and 2.4-2.8e-2 (bf16) at 6 layers, the port 3.2e-2 at 18 (bf16)
ZAMBA_STATE_REL = 0.1
# (label, m, n, r, matrices, G a transposed view): the stacks of 18 layers
ZAMBA_OPT_SHAPES = (
    ("zamba in_proj", 3584, 14576, 512, ZAMBA_LAYERS, False),
    ("zamba out_proj", 3584, 7168, 512, ZAMBA_LAYERS, True),
)


def _rel(got, want) -> float:
    """max |got - want| over max |want|, on the CPU in fp32."""
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def _zamba_cache_to(cache, device):
    """A copy of a zamba cache on ``device`` (decode writes in place)."""
    from repro_torch.models import ssm
    from repro_torch.models.zamba import ZambaCache

    return ZambaCache(
        mamba=ssm.MambaState(h=cache.mamba.h.to(device, copy=True),
                             conv=cache.mamba.conv.to(device, copy=True)),
        shared_k=cache.shared_k.to(device, copy=True),
        shared_v=cache.shared_v.to(device, copy=True),
        shared_pos=cache.shared_pos.to(device, copy=True),
        length=cache.length)


def _bf16_steps_apart(got, want, rel=ZAMBA_SMOKE_REL) -> int:
    """Entries of two bf16 tensors more than one bf16 step apart beyond
    ``rel`` of the largest (0 when they are the same values rounded on
    either side of a boundary)."""
    g, w = got.float().cpu(), want.float().cpu()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    return int(((g - w).abs() > step + rel * w.abs().max()).sum())


def _family_smoke_data(arch, seq=128):
    """The fp32 smoke config of ``arch``, its bundle, CPU params of the
    seed and ``VARIANT_STEPS`` batches of 2 x ``seq``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                           batch_for_model)
    from repro_torch.models.api import build_model

    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    bundle = build_model(cfg)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq, global_batch=2,
                                         seed=SEED))
    batches = [batch_for_model(cfg, None, data, s_)
               for s_ in range(VARIANT_STEPS)]
    return cfg, bundle, bundle.init(torch.Generator().manual_seed(SEED)), \
        batches


def _prompt_stream(cfg, P, gen, seed):
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset

    return SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=P + gen, global_batch=2,
        seed=seed)).global_batch_at(0)["tokens"]


def _smoke_grads_and_run(tag, cfg, params, batches, rank, rel,
                         what, fault=None) -> dict:
    """The fp32 smoke ``cfg`` on CUDA and on the CPU from the same
    ``params`` (on the CPU): the loss and every gradient of
    ``batches[0]`` within ``rel`` of the largest entry (and where
    ``fault`` plants one, ``fault(params)``'s CPU gradients read against
    the sound ones, past ``rel``); then
    ``len(batches)`` steps through ``run`` (tracking at 2, eta 2e-5,
    ``--grad-fused`` asked for: a family with no tap site takes the plain
    backward) within ``SMOKE_LOSS_ATOL``, exact launches from the plans
    on CUDA and none on the CPU.  Returns the params on each device."""
    from repro_torch.core.api import get_optimizer
    from repro_torch.core.subtrack import tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (TrainState, make_warm_start,
                                          value_and_grad)
    from repro_torch.launch.train import run
    from repro_torch.models.api import build_model
    from repro_torch.optim.schedules import cosine_with_warmup

    steps, k = len(batches), VARIANT_K
    tracking = sum(1 for s_ in range(steps) if s_ and s_ % k == 0)
    bundle = build_model(cfg)
    on = {d: tree_map(lambda t: t.to(d, copy=True), params)
          for d in ("cuda", "cpu")}
    grads = {}
    for device, p in on.items():
        loss, _, g = value_and_grad(
            bundle, p, {k_: v.to(device) for k_, v in batches[0].items()},
            "full")
        grads[device] = (float(loss), [t.cpu() for t in tree_leaves(g)])
    (l_c, g_c), (l_h, g_h) = grads["cuda"], grads["cpu"]
    g_err = max(_rel(a, b) for a, b in zip(g_c, g_h))
    planted = ""
    if fault is not None:
        _, _, g = value_and_grad(bundle, fault(on["cpu"]), batches[0],
                                 "full")
        f_err = max(_rel(a, b) for a, b in zip(tree_leaves(g), g_h))
        planted = f"; the planted fault reads {f_err:.2e}"
    print(f"[{tag}] smoke fp32 ({what}): loss CUDA {l_c:.6f} vs CPU "
          f"{l_h:.6f}, {len(g_c)} gradients within {g_err:.2e} of their "
          f"largest (budget {rel:g}){planted}", flush=True)
    if not (abs(l_c - l_h) <= rel * abs(l_h) and g_err <= rel):
        raise AssertionError(f"{tag} smoke: loss CUDA {l_c} CPU {l_h}, "
                             f"gradients {g_err:.3e} of the largest")
    if fault is not None and not f_err > rel:
        raise AssertionError(f"{tag} smoke: the planted fault's gradients "
                             f"read {f_err:.3e}, within the budget")
    del grads, g_c, g_h

    opt = get_optimizer("subtrack", rank=rank, update_interval=k,
                        eta=2e-5, use_kernels=True)
    warm, _ = make_warm_start(bundle, opt)(
        TrainState(params=params, opt=opt.init(params)), batches[0])

    def go(device):
        ops.reset_launch_counts()
        out = run(cfg, tree_map(lambda t: t.to(device, copy=True), params),
                  lambda s_: batches[s_], optimizer=opt, steps=steps,
                  lr_at=cosine_with_warmup(1e-3, steps, 2), log_every=steps,
                  opt_state=_state_to(warm.opt, device), grad_fused=True)
        return [h["loss"] for h in out["history"]], ops.launch_counts()

    cuda_losses, cuda_counts = go("cuda")
    cpu_losses, cpu_counts = go("cpu")
    diff = max(abs(a - b) for a, b in zip(cuda_losses, cpu_losses))
    want = _plan_launches(cfg, params, rank, steps, tracking)
    if not diff <= SMOKE_LOSS_ATOL:
        raise AssertionError(f"{tag} smoke: CUDA {cuda_losses} vs CPU "
                             f"{cpu_losses} (max diff {diff:.3e})")
    if cuda_counts != want or any(cpu_counts.values()):
        raise AssertionError(f"{tag} smoke launches: CUDA {cuda_counts} "
                             f"(want {want}), CPU {cpu_counts}")
    print(f"[{tag}] smoke, {steps} steps at rank {rank} (--grad-fused asked "
          f"for: the plain backward): losses CUDA vs CPU max diff "
          f"{diff:.2e} (budget {SMOKE_LOSS_ATOL:g}); CUDA launches "
          f"{({k_: v for k_, v in cuda_counts.items() if v})}", flush=True)
    return on


def phase_zamba_smoke() -> None:
    """Phase 26 (b): the fp32 smoke zamba on CUDA and on the CPU from the
    same params: the loss and every gradient within ``ZAMBA_SMOKE_REL``;
    4 steps through ``run`` (tracking at 2, rank 32, ``--grad-fused``
    asked for: the fallback) within ``SMOKE_LOSS_ATOL`` with exact
    launches from the plans on CUDA and none on the CPU; prefill (logits,
    SSD states, the shared K/V; the bf16 conv windows within a bf16 step)
    within ``ZAMBA_SMOKE_REL``, then 3 decode steps, each from the CPU's
    cache of the step before, within ``ZAMBA_SMOKE_REL`` where both
    devices' new conv entries are the same bf16 values, else
    ``ZAMBA_DECODE_REL`` (the entries that round apart printed)."""
    cfg, bundle, params, batches = _family_smoke_data(ZAMBA_ARCH)
    on = _smoke_grads_and_run(
        "zamba", cfg, params, batches, 32, ZAMBA_SMOKE_REL,
        f"{cfg.n_layers} layers, the shared block every {cfg.attn_every}")

    # prefill (24 tokens: not a chunk multiple) and 3 decode steps
    P, gen = 24, 3
    toks = _prompt_stream(cfg, P, gen, SEED + 3)
    with torch.no_grad():
        res = {d: bundle.prefill(on[d], {"tokens": toks[:, :P].to(d)},
                                 P + gen + 5) for d in ("cuda", "cpu")}
        (lg_c, c_c), (lg_h, c_h) = res["cuda"], res["cpu"]
        rels = [_rel(lg_c, lg_h), _rel(c_c.mamba.h, c_h.mamba.h),
                _rel(c_c.shared_k, c_h.shared_k),
                _rel(c_c.shared_v, c_h.shared_v)]
        apart = _bf16_steps_apart(c_c.mamba.conv, c_h.mamba.conv)
        if max(rels) > ZAMBA_SMOKE_REL or apart:
            raise AssertionError(f"zamba smoke prefill: logits, h, k, v "
                                 f"{rels}; {apart} conv entries apart")
        line = [f"prefill {max(rels):.2e}"]
        del res, c_c
        for i in range(gen):
            tok = toks[:, P + i]
            lg_c, c_c = bundle.decode_step(on["cuda"],
                                           _zamba_cache_to(c_h, "cuda"),
                                           tok.cuda())
            lg_h, c_h = bundle.decode_step(on["cpu"], c_h, tok)
            flips = int((c_c.mamba.conv[:, :, -1].cpu()
                         != c_h.mamba.conv[:, :, -1]).sum())
            budget = ZAMBA_DECODE_REL if flips else ZAMBA_SMOKE_REL
            rels = [_rel(lg_c, lg_h), _rel(c_c.mamba.h, c_h.mamba.h),
                    _rel(c_c.shared_k, c_h.shared_k),
                    _rel(c_c.shared_v, c_h.shared_v)]
            apart = _bf16_steps_apart(c_c.mamba.conv, c_h.mamba.conv)
            if max(rels) > budget or apart:
                raise AssertionError(f"zamba smoke decode {i}: logits, h, "
                                     f"k, v {rels} (budget {budget:g}, "
                                     f"{flips} new conv entries rounded "
                                     f"apart); {apart} conv entries apart")
            line.append(f"decode {i} {max(rels):.2e} ({flips} new conv "
                        f"entries rounded apart, budget {budget:g})")
            del c_c
    print(f"[zamba] smoke prefill ({P} tokens) and {gen} decode steps, each "
          f"from the CPU's cache: logits, SSD states and shared K/V, CUDA vs "
          f"CPU of the largest entry: {'; '.join(line)}", flush=True)


def _train_full(tag, cfg, batch, seq, cut, used) -> tuple[dict, dict]:
    """``cfg`` at full width through ``run``: ``VARIANT_STEPS`` steps at
    interval ``VARIANT_K`` (tracking at 2), the default rank, kernels on,
    eta ``VARIANT_ETA``, from random bf16 weights of the seed: finite,
    unquarantined, launches from the plans, every kernel of ``used``
    launched.  ``cut(n_params, rank, low-rank leaves, matrices)`` says how
    the config was cut, printed first.  Returns the record (launches, warm
    start, step times, tok/s, peak) and the trained params, with the
    optimizer state dropped."""
    from repro_torch.core.api import get_optimizer
    from repro_torch.core.plan import make_plans, matrix_count
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                           batch_for_model, validate_batch)
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import default_rank
    from repro_torch.launch.train import run
    from repro_torch.models.api import build_model
    from repro_torch.optim.schedules import cosine_with_warmup

    steps, k = VARIANT_STEPS, VARIANT_K
    rank = default_rank(cfg.d_model)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for _, t in _leaf_paths(params))
    plans = [(p, t) for (_, p), (_, t) in zip(
        _leaf_paths(make_plans(params, rank)), _leaf_paths(params))]
    n_svd = sum(matrix_count(p, tuple(t.shape)) for p, t in plans
                if p.mode == "lowrank")
    n_low = sum(1 for p, _ in plans if p.mode == "lowrank")
    print(f"[{tag}] {cut(n_params, rank, n_low, n_svd)}", flush=True)
    opt = get_optimizer("subtrack", rank=rank, update_interval=k,
                        eta=VARIANT_ETA, use_kernels=True)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq, global_batch=batch,
                                         seed=SEED))

    def batch_at(step, mutate=None):
        b = batch_for_model(cfg, None, data, step)
        validate_batch(b, cfg.vocab_size)
        return b

    want = _plan_launches(cfg, params, rank, steps,
                          sum(1 for s_ in range(steps) if s_ and s_ % k == 0))
    ops.reset_launch_counts()
    res = run(cfg, params, batch_at, optimizer=opt, steps=steps,
              lr_at=cosine_with_warmup(1e-3, steps, 2), log_every=1)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = res["history"]
    if not all(h["loss"] is not None and math.isfinite(h["loss"])
               and not h["quarantined"] for h in hist):
        raise AssertionError(f"{tag}: history {hist}")
    if [h["step"] for h in hist if h["subspace_update"]] != [2]:
        raise AssertionError(f"{tag}: tracking steps wrong: {hist}")
    if launches != want or not all(launches[n] for n in used):
        raise AssertionError(f"{tag} launches {launches}, want {want}")
    plain_s = [h["dt"] for h in hist if not h["subspace_update"]]
    track_s = [h["dt"] for h in hist if h["subspace_update"]][0]
    tok_s = batch * seq / (sum(plain_s[1:]) / len(plain_s[1:]))
    rec = {"launches": launches, "warm_start_s": res["warm_start_s"],
           "svds": n_svd, "plain_s": plain_s, "tracking_s": track_s,
           "tok_s": tok_s, "train_peak_gib": peak / 2**30,
           "losses": [h["loss"] for h in hist], "params_b": n_params / 1e9}
    print(f"[{tag}] train: warm start {res['warm_start_s']:.2f} s ({n_svd} "
          f"SVDs; loss {res['warm_loss']:.4f}); losses {rec['losses']}; "
          f"plain steps {[round(t, 3) for t in plain_s]} s (step 0 cold), "
          f"tracking {track_s:.3f} s; {tok_s:.1f} tok/s on warm plain "
          f"steps; peak {peak / 2**30:.2f} GiB; launches "
          f"{({k_: v for k_, v in launches.items() if v})}", flush=True)
    params = res.pop("state").params       # drop the optimizer state
    del res
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return rec, params


def phase_zamba_full() -> dict:
    """Phase 26 (c, d): zamba2-7b at full width and ``ZAMBA_LAYERS``
    layers: 4 SubTrack++ steps through ``run`` (batch 1 x 4096, default
    rank, kernels on, eta pinned): finite, unquarantined, tracking at 2,
    launches from the plans; then the trained weights through
    ``run_dense`` (2 requests of 2048 + 16, 1 of 8192 + 16), 2048 + 16
    teacher-forced against ``zamba_forward`` (phase 24's criteria), and the
    SSD states of prefill(P) + 16 decode steps against prefill(P + 16)'s
    (``ZAMBA_STATE_REL``).  Returns launches, times and cache bytes."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import AdmissionQueue, Request, run_dense
    from repro_torch.models import zamba
    from repro_torch.models.api import build_model

    t_phase = time.perf_counter()
    full = get_config(ZAMBA_ARCH)
    cfg = full.with_(n_layers=ZAMBA_LAYERS)
    batch, seq = ZAMBA_TRAIN

    def cut(n_params, rank, n_low, n_svd):
        return (f"zamba2-7b cut to size: {full.n_layers} -> "
                f"{cfg.n_layers} Mamba2 layers "
                f"({cfg.n_layers // cfg.attn_every} groups: the shared block "
                f"applied twice) at full width (d {cfg.d_model}, "
                f"{cfg.d_model * cfg.ssm.expand // cfg.ssm.head_dim} SSD "
                f"heads of {cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, "
                f"chunk {cfg.ssm.chunk}; attention {cfg.n_heads} heads of "
                f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}): "
                f"{n_params / 1e9:.2f} B params; rank {rank} ({n_low} "
                f"low-rank leaves, {n_svd} matrices), batch {batch} x {seq}, "
                f"eta {VARIANT_ETA:g}")

    rec, params = _train_full("zamba", cfg, batch, seq, cut, (
        "project", "project_colnorms", "tangent", "fused_update",
        "adam_lowrank_norms"))
    bundle = build_model(cfg)

    # (d) the dense engine: 2 requests of P + GEN, 1 of P_long + GEN
    P, P_long = ZAMBA_SERVE
    gen = VARIANT_GEN
    stream = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=P + gen, global_batch=2,
        seed=SEED + 1)).global_batch_at(0)["tokens"]
    long_prompt = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=P_long, global_batch=1,
        seed=SEED + 2)).global_batch_at(0)["tokens"]
    served = {}
    ops.reset_launch_counts()
    for name, prompts in (("short", stream[:, :P]), ("long", long_prompt)):
        queue = AdmissionQueue()
        for i in range(prompts.shape[0]):
            queue.submit(Request(rid=i, prompt=prompts[i].numpy(),
                                 max_new=gen, t_submit=time.time()))
        served[name] = run_dense(cfg, bundle, params, queue,
                                 batch=prompts.shape[0],
                                 prompt_len=prompts.shape[1])
        if served[name]["requests"] != prompts.shape[0] or any(
                len(v) != gen for v in served[name]["outputs"].values()):
            raise AssertionError(f"zamba serve {name}: {served[name]}")
        T = prompts.shape[1] + gen + 8              # run_dense's max_len
        c = bundle.init_cache(prompts.shape[0], T, device="meta")
        served[name]["state_bytes"] = c.mamba.h.nbytes + c.mamba.conv.nbytes
        served[name]["kv_bytes"] = c.shared_k.nbytes + c.shared_v.nbytes
    if any(ops.launch_counts().values()):
        raise AssertionError(f"zamba dense serving launched "
                             f"{ops.launch_counts()}")
    serve_peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        toks = stream.cuda()
        T = P + gen
        logits, cache = bundle.prefill(params, {"tokens": toks[:, :P]}, T)
        got = [logits.float().cpu()]
        for i in range(gen):
            logits, cache = bundle.decode_step(params, cache, toks[:, P + i])
            got.append(logits.float().cpu())
        fcfg = cfg.with_(kv_block=_divisor_block(T, cfg.kv_block))
        _, whole = build_model(fcfg).prefill(params, {"tokens": toks}, T)
        h_rel = _rel(cache.mamba.h, whole.mamba.h)
        conv_rel = _rel(cache.mamba.conv, whole.mamba.conv)
        del cache, whole, logits
        full_logits, _ = zamba.zamba_forward(params, toks, fcfg,
                                             remat="none")
        want_l = full_logits[:, P - 1:].float().transpose(0, 1).cpu()
        del full_logits
    got_l = torch.stack(got).numpy()
    want_l = want_l.numpy()
    agree = float((got_l.argmax(-1) == want_l.argmax(-1)).mean())
    p90 = float(np.percentile(np.abs(got_l - want_l), 90))
    scale = float(np.percentile(np.abs(want_l), 90)) + 1e-3
    if not (agree >= VARIANT_AGREE
            and p90 < VARIANT_P90 * scale + VARIANT_P90
            and h_rel <= ZAMBA_STATE_REL and conv_rel <= ZAMBA_STATE_REL):
        raise AssertionError(f"zamba decode vs forward: agreement "
                             f"{agree:.3f}, p90 {p90:.4f} (scale "
                             f"{scale:.3f}); states {h_rel:.3e}, conv "
                             f"windows {conv_rel:.3e}")
    rec.update(serve={n: {"tok_s": s_["tok_per_s"],
                          "ttft_p50_s": s_["ttft_p50_s"],
                          "decode_step_ms": s_["decode_step_ms_mean"],
                          "state_bytes": s_["state_bytes"],
                          "kv_bytes": s_["kv_bytes"]}
                      for n, s_ in served.items()},
               serve_peak_gib=serve_peak / 2**30, agree=agree, p90=p90,
               scale=scale, state_rel=h_rel, conv_rel=conv_rel)
    for (name, s_), (b_, plen) in zip(served.items(), ((2, P), (1, P_long))):
        print(f"[zamba] serve (dense) {name}: {b_} x ({plen} + {gen}): "
              f"{s_['tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{s_['ttft_p50_s'] * 1e3:.1f} ms, decode step "
              f"{s_['decode_step_ms_mean']:.2f} ms; cache: Mamba states "
              f"{s_['state_bytes'] / 2**20:.2f} MiB (any length), shared K/V "
              f"{s_['kv_bytes'] / 2**20:.2f} MiB", flush=True)
    print(f"[zamba] teacher-forced decode (2 x {P} + {gen}) vs zamba_forward:"
          f" argmax agreement {agree:.3f} (>= {VARIANT_AGREE}), p90 |delta| "
          f"{p90:.4f} < {VARIANT_P90 * scale + VARIANT_P90:.4f}; SSD states "
          f"of prefill({P}) + {gen} decode steps vs prefill({P + gen}) "
          f"{h_rel:.2e}, conv windows {conv_rel:.2e} of the largest (budget "
          f"{ZAMBA_STATE_REL:g}); serve peak {serve_peak / 2**30:.2f} GiB; "
          f"phase 26 (c, d) {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del params, toks, got, got_l, want_l
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_zamba() -> dict:
    """Phase 26: zamba2-7b, (a) the optimizer kernels at its stacks, (b)
    the smoke config CUDA against the CPU, (c) training and (d) serving
    at full width and ``ZAMBA_LAYERS`` layers."""
    t0 = time.perf_counter()
    kernels: dict = {}
    _time_opt_shapes(kernels, "zamba", ZAMBA_OPT_SHAPES, SEED + 30,
                     library=True)
    phase_zamba_smoke()
    train = phase_zamba_full()
    print(f"[zamba] phase 26: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"kernels": kernels, "train": train}


# ---------------------------------------------------------------------------
# xlstm-125m (phase 27) and seamless-m4t-large-v2 (phase 28)
# ---------------------------------------------------------------------------

XLSTM_ARCH = "xlstm-125m"
# batch x seq: the sLSTM's loop runs S steps, so 4 x 1024 takes a quarter
# of train_4k's 4096 steps for the same tokens
XLSTM_TRAIN = (4, 1024)
XLSTM_SERVE = 2048        # prompt: 2 requests of it, + VARIANT_GEN
SEAMLESS_ARCH = "seamless-m4t-large-v2"
SEAMLESS_LAYERS = 6       # encoder and decoder layers each, of 24
SEAMLESS_TRAIN = (2, 2048)   # batch x seq: frames and tokens
SEAMLESS_SERVE = 1024     # prompt (tokens and zero frames): 2 requests
# fp32 smoke, CUDA vs CPU from the same params, of the largest entry:
# the loss and every gradient, prefill and a decode step (the CPU tests'
# budget against the JAX package; seamless came within 2.13e-6)
FAMILY_SMOKE_REL = 2e-5
# the fp32 smoke xlstm's loss and gradients, CUDA vs CPU: its sLSTM runs a
# 128-step recurrence, and the two devices came 1.77e-5 apart on the H100;
# a planted fault, the sLSTM bias read in the other layout (each gate's
# block split by head; ROADMAP Queue 3's sLSTM bias quirk), read 3.96
# there (PERF.md section 6), and is read on every run
XLSTM_GRAD_REL = 1e-4
# an fp32 smoke xlstm decode step whose new conv window entries round
# apart in bf16 on the two devices: the layers after it read inputs a
# bf16 step apart, so more entries round apart downstream (42 entries and
# 5.4e-4 of the largest against the JAX package, tests/test_torch_xlstm.py;
# CUDA vs CPU within 1.4e-6 on the H100); half a bf16 step of the
# largest.  The planted faults (a step from a conv window its step before
# did not advance, an mLSTM stabiliser off by one) read 0.34-1.14 there
XLSTM_DECODE_REL = 2e-3
# the bf16 smoke xlstm (the dtype it is served in), CUDA vs CPU from the
# same params and, for each decode step, the CPU's cache: prefill and a
# decode step, of the largest entry.  Two bf16 evaluations round their
# intermediates in different places: the port against the JAX package
# came 4.6e-2 apart on prefill and 1.6e-2 on a decode step
# (tests/test_torch_xlstm.py), CUDA against the CPU 2.7e-2 and 4.8e-7 on
# the H100, where the two planted faults read 0.36-1.13 on a step
XLSTM_BF16_PREFILL_REL = 0.1
XLSTM_BF16_DECODE_REL = 3e-2
# phase 27 (d): bf16 decode of 2 x (2048 + 16) teacher-forced against
# xlstm_forward, the reference's decode departing from its own forward:
# it forms q and k in fp32 where its chunked forward rounds them to bf16
# (at smoke width the JAX package's own bf16 decode agrees with its
# forward at 0.912 and its states sit 5.1e-2 from prefill(P + 16)'s,
# tests/test_torch_xlstm.py).  The port on the H100: argmax agreement
# 0.853, p90 |delta| 0.070, the sLSTM's h 0.198 and the conv windows
# 0.117 of their largest from prefill(2064)'s at one stabiliser, C and n
# 1.0e-2; the two planted faults, held for all 16 steps: agreement
# 0.147-0.176, p90 0.95-1.19, states up to 1.26-1.52 (PERF.md section 6)
XLSTM_AGREE = 0.75
XLSTM_STATE_REL = 0.4
# (label, m, n, r, matrices, G a transposed view): the slice's new shapes
XLSTM_OPT_SHAPES = (
    ("xlstm slstm R", 192, 768, 128, 12, False),    # (3, 4, 192, 768)
    ("xlstm embed", 768, 50432, 128, 1, True),
)
SEAMLESS_OPT_SHAPES = (
    ("seamless embed", 1024, 256256, 256, 1, True),
    ("seamless w_gate", 1024, 8192, 256, SEAMLESS_LAYERS, False),
)
FAMILY_USED = ("project", "project_colnorms", "project_tangent_colnorms",
               "fused_update", "adam_lowrank_norms")   # every m <= 2048


def _xlstm_cache_to(cache, device):
    """A copy of an xlstm cache on ``device`` (decode writes in place)."""
    from repro_torch.models.xlstm import MLSTMState, SLSTMState, XLSTMCache

    return XLSTMCache(
        mlstm=MLSTMState(*(a.to(device, copy=True) for a in cache.mlstm)),
        mlstm_conv=cache.mlstm_conv.to(device, copy=True),
        slstm=SLSTMState(*(a.to(device, copy=True) for a in cache.slstm)),
        length=cache.length)


def _xlstm_state_rels(c_c, c_h) -> list[float]:
    """The xlstm caches' state tensors, CUDA against CPU, of the largest
    entry: mLSTM C, n, m, sLSTM h, c, n, m."""
    return ([_rel(a, b) for a, b in zip(c_c.mlstm, c_h.mlstm)]
            + [_rel(a, b) for a, b in zip(c_c.slstm, c_h.slstm)])


XLSTM_FAULTS = ("conv window not advanced", "stabiliser off by one")


def _xlstm_fault(cache, fault, before=None):
    """A copy of an xlstm cache with a planted fault: the conv window of
    ``before``, the cache a step earlier (a decode step that did not
    advance the window), or every mLSTM stabiliser m one too large (C
    and n not rescaled)."""
    out = _xlstm_cache_to(cache, cache.mlstm_conv.device)
    if fault == XLSTM_FAULTS[0]:
        out.mlstm_conv.copy_(before.mlstm_conv)
    else:
        out.mlstm.m.add_(1.0)
    return out


def _other_bias_layout(params):
    """``params`` with each sLSTM bias ``b`` read in the other layout: the
    cell splits a head's row into i, f, z, o, so a bias whose [i | f | z |
    o] blocks are each split by head lands on other gates)."""
    from repro_torch.core.subtrack import tree_map

    out = tree_map(lambda t: t.clone(), params)
    b = out["slstm_layers"]["b"]
    d = b.shape[-1] // 4
    H = params["slstm_layers"]["R"].shape[-3]
    out["slstm_layers"]["b"] = b.reshape(*b.shape[:-1], 4, H, d // H) \
        .transpose(-3, -2).reshape(b.shape)
    return out


def _xlstm_decode_vs_cpu(bundle, on, toks, P, gen, prefill_rel,
                         step_rel) -> list[str]:
    """Prefill ``toks[:, :P]`` on CUDA and on the CPU from the same params
    ``on[device]``, then ``gen`` decode steps, each on CUDA from the CPU's
    cache of the step before, and from the same cache each planted fault
    of :func:`_xlstm_fault` (the stale window from the second step on),
    its logits read against the CPU's step; the prefill's planted fault is
    :func:`_other_bias_layout`.  The prefill's logits and
    states are held to ``prefill_rel``, a step's to ``step_rel(flips)``
    where ``flips`` of its new conv entries round apart on the two
    devices, and every conv window to within a bf16 step of that; each
    fault must read past its step's budget.  Returns the readings, one
    string a step, after raising if one fails."""
    fails, line = [], []
    with torch.no_grad():
        res = {d: bundle.prefill(on[d], {"tokens": toks[:, :P].to(d)}, 0)
               for d in ("cuda", "cpu")}
        (lg_c, c_c), (lg_h, c_h) = res["cuda"], res["cpu"]
        rels = [_rel(lg_c, lg_h)] + _xlstm_state_rels(c_c, c_h)
        apart = _bf16_steps_apart(c_c.mlstm_conv, c_h.mlstm_conv,
                                  prefill_rel)
        bias = _rel(bundle.prefill(_other_bias_layout(on["cuda"]),
                                   {"tokens": toks[:, :P].cuda()}, 0)[0],
                    lg_h)
        line.append(f"prefill {max(rels):.2e} (budget {prefill_rel:g}; "
                    f"fault: the sLSTM bias in the other layout {bias:.2e})")
        if max(rels) > prefill_rel or apart:
            fails.append(f"prefill: logits and states {rels}; {apart} conv "
                         f"entries apart")
        if not bias > prefill_rel:
            fails.append(f"prefill: the bias fault reads {bias:.3e}")
        del res, c_c
        before = None
        for i in range(gen):
            tok = toks[:, P + i]
            faulty = {name: _xlstm_fault(c_h, name, before)
                      for name in XLSTM_FAULTS
                      if before is not None or name != XLSTM_FAULTS[0]}
            lg_c, c_c = bundle.decode_step(on["cuda"],
                                           _xlstm_cache_to(c_h, "cuda"),
                                           tok.cuda())
            before = _xlstm_cache_to(c_h, "cpu")
            lg_h, c_h = bundle.decode_step(on["cpu"], c_h, tok)
            flips = int((c_c.mlstm_conv[:, :, -1].cpu()
                         != c_h.mlstm_conv[:, :, -1]).sum())
            budget = step_rel(flips)
            rels = [_rel(lg_c, lg_h)] + _xlstm_state_rels(c_c, c_h)
            apart = _bf16_steps_apart(c_c.mlstm_conv, c_h.mlstm_conv, budget)
            reads = {name: _rel(bundle.decode_step(
                on["cuda"], _xlstm_cache_to(fc, "cuda"), tok.cuda())[0],
                lg_h) for name, fc in faulty.items()}
            line.append(f"decode {i} {max(rels):.2e} ({flips} new conv "
                        f"entries rounded apart, budget {budget:g}; faults "
                        + ", ".join(f"{k} {v:.2e}" for k, v in reads.items())
                        + ")")
            if max(rels) > budget or apart:
                fails.append(f"decode {i}: logits and states {rels}; {apart}"
                             f" conv entries apart")
            fails += [f"decode {i}: the fault '{k}' reads {v:.3e}"
                      for k, v in reads.items() if not v > budget]
            del c_c, faulty
    if fails:
        raise AssertionError(f"xlstm smoke decode, CUDA vs CPU: {fails} "
                             f"({'; '.join(line)})")
    return line


def phase_xlstm_smoke() -> None:
    """Phase 27 (b): the fp32 smoke xlstm (4 layers: 3 mLSTM, 1 sLSTM) on
    CUDA and on the CPU from the same params: the loss and every gradient
    within ``XLSTM_GRAD_REL`` (the sLSTM bias in the other layout read
    past it); 4 steps through ``run`` at rank 16 (the sLSTM's 4-D R
    low-rank; ``--grad-fused`` asked for: the fallback) within
    ``SMOKE_LOSS_ATOL``, exact launches from the plans; prefill and 3
    decode steps, each from the CPU's cache (:func:`_xlstm_decode_vs_cpu`):
    in fp32 within ``FAMILY_SMOKE_REL``, or ``XLSTM_DECODE_REL`` for a
    step whose new conv entries round apart, and in bf16, the dtype it is
    served in, within ``XLSTM_BF16_PREFILL_REL`` and
    ``XLSTM_BF16_DECODE_REL``; the planted faults read past each."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.subtrack import tree_map
    from repro_torch.models.api import build_model

    cfg, bundle, params, batches = _family_smoke_data(XLSTM_ARCH)
    on = _smoke_grads_and_run("xlstm", cfg, params, batches, 16,
                              XLSTM_GRAD_REL,
                              f"{cfg.n_layers} layers: 3 mLSTM, 1 sLSTM",
                              fault=_other_bias_layout)
    P, gen = 21, 3                      # not a multiple of the chunk (8)
    toks = _prompt_stream(cfg, P, gen, SEED + 3)
    line = _xlstm_decode_vs_cpu(
        bundle, on, toks, P, gen, FAMILY_SMOKE_REL,
        lambda flips: XLSTM_DECODE_REL if flips else FAMILY_SMOKE_REL)
    print(f"[xlstm] smoke fp32 prefill ({P} tokens) and {gen} decode steps, "
          f"each from the CPU's cache: logits and mLSTM / sLSTM states, "
          f"CUDA vs CPU of the largest entry: {'; '.join(line)}", flush=True)
    cfg16 = get_config(XLSTM_ARCH, smoke=True)
    bundle16 = build_model(cfg16)
    params16 = bundle16.init(torch.Generator().manual_seed(SEED))
    on16 = {d: tree_map(lambda t: t.to(d, copy=True), params16)
            for d in ("cuda", "cpu")}
    line = _xlstm_decode_vs_cpu(bundle16, on16, toks, P, gen,
                                XLSTM_BF16_PREFILL_REL,
                                lambda _: XLSTM_BF16_DECODE_REL)
    print(f"[xlstm] smoke bf16 (as served) prefill and {gen} decode steps, "
          f"the same way: {'; '.join(line)}", flush=True)


def _serve_dense(tag, cfg, bundle, params, prompts, gen) -> dict:
    """Serve ``prompts`` (B, P) through ``run_dense`` in one wave of B,
    ``gen`` tokens each, no kernel launched; returns run_dense's
    summary."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import AdmissionQueue, Request, run_dense

    queue = AdmissionQueue()
    for i in range(prompts.shape[0]):
        queue.submit(Request(rid=i, prompt=prompts[i].numpy(), max_new=gen,
                             t_submit=time.time()))
    ops.reset_launch_counts()
    out = run_dense(cfg, bundle, params, queue, batch=prompts.shape[0],
                    prompt_len=prompts.shape[1])
    if out["requests"] != prompts.shape[0] or any(
            len(v) != gen for v in out["outputs"].values()):
        raise AssertionError(f"{tag} serve: {out}")
    if any(ops.launch_counts().values()):
        raise AssertionError(f"{tag} dense serving launched "
                             f"{ops.launch_counts()}")
    return out


def _at_one_stabiliser(x, m, m_star):
    """A stabilised state tensor x (with its log stabiliser m, broadcast
    over x's trailing dims) rescaled to the stabiliser m_star."""
    scale = torch.exp(m - m_star)
    return x * scale.reshape(scale.shape + (1,) * (x.dim() - m.dim()))


def _xlstm_state_gap(a, b) -> dict:
    """Two xlstm caches' states, of the largest entry, each stabilised
    pair at the larger of the two stabilisers: mLSTM C and n, sLSTM c and
    n (and h, which carries none), and the conv windows."""
    out = {}
    for kind, pairs in (("mlstm", ("C", "n")), ("slstm", ("c", "n"))):
        sa, sb = getattr(a, kind), getattr(b, kind)
        m_star = torch.maximum(sa.m, sb.m)
        for f in pairs:
            out[f"{kind} {f}"] = _rel(
                _at_one_stabiliser(getattr(sa, f), sa.m, m_star),
                _at_one_stabiliser(getattr(sb, f), sb.m, m_star))
    out["slstm h"] = _rel(a.slstm.h, b.slstm.h)
    out["conv"] = _rel(a.mlstm_conv, b.mlstm_conv)
    return out


def _xlstm_teacher_forced(cfg, bundle, params, toks, P, gen) -> dict:
    """Prefill ``toks[:, :P]`` and decode the next ``gen`` tokens, sound
    and under each planted fault of :func:`_xlstm_fault` (the window held
    back at every step; the stabiliser moved once, after the prefill); for
    each run, the logits against ``xlstm_forward`` over all of ``toks``
    (phase 24's measures: argmax agreement, p90 |delta| and its scale)
    and the final states against prefill(P + gen)'s at one stabiliser
    (:func:`_xlstm_state_gap`)."""
    from repro_torch.models import xlstm

    out = {}
    with torch.no_grad():
        logits, cache = bundle.prefill(params, {"tokens": toks[:, :P]}, 0)
        first = logits.float().cpu()
        _, whole = bundle.prefill(params, {"tokens": toks}, 0)
        full_logits, _ = xlstm.xlstm_forward(params, toks, cfg, remat="none")
        want = full_logits[:, P - 1:].float().transpose(0, 1).cpu()
        del full_logits
        for run in ("sound",) + XLSTM_FAULTS:
            c = _xlstm_cache_to(cache, "cuda")
            if run == XLSTM_FAULTS[1]:
                c.mlstm.m.add_(1.0)
            got = [first]
            for i in range(gen):
                held = (c.mlstm_conv.clone() if run == XLSTM_FAULTS[0]
                        else None)
                logits, c = bundle.decode_step(params, c, toks[:, P + i])
                if held is not None:
                    c.mlstm_conv.copy_(held)
                got.append(logits.float().cpu())
            out[run] = (*_agreement(torch.stack(got), want, slice(None)),
                        _xlstm_state_gap(c, whole))
            del c
    return out


def phase_xlstm_full() -> dict:
    """Phase 27 (c, d): xlstm-125m at full width and depth (12 blocks: 9
    mLSTM, 3 sLSTM): 4 SubTrack++ steps through ``run`` (batch 4 x 1024,
    default rank 128, kernels on, eta pinned): finite, unquarantined,
    tracking at 2, launches from the plans; the sLSTM's sequential loop
    timed alone beside the step; then the trained weights through
    ``run_dense`` (2 requests of 2048 + 16; the cache's bytes, the same at
    any length) and the 16 teacher-forced in bf16 against
    ``xlstm_forward``: agreement ``XLSTM_AGREE``, phase 24's p90, and the
    states of prefill(2048) + 16 decode steps against prefill(2064)'s at
    one stabiliser within ``XLSTM_STATE_REL``; each planted fault must
    fail them."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import xlstm
    from repro_torch.models.api import build_model

    t_phase = time.perf_counter()
    cfg = get_config(XLSTM_ARCH)
    batch, seq = XLSTM_TRAIN
    every = cfg.xlstm.slstm_every
    n_s = cfg.n_layers // every

    def cut(n_params, rank, n_low, n_svd):
        return (f"xlstm-125m at full width and depth ({cfg.n_layers} "
                f"blocks: {cfg.n_layers - n_s} mLSTM, {n_s} sLSTM; d "
                f"{cfg.d_model}, {cfg.n_heads} heads, mLSTM inner "
                f"{xlstm._mlstm_dims(cfg)[0]}, chunk {cfg.xlstm.chunk}, "
                f"vocab {cfg.padded_vocab}): {n_params / 1e9:.3f} B params; "
                f"rank {rank} ({n_low} low-rank leaves, {n_svd} matrices), "
                f"batch {batch} x {seq}, eta {VARIANT_ETA:g}")

    rec, params = _train_full("xlstm", cfg, batch, seq, cut, FAMILY_USED)
    bundle = build_model(cfg)

    # the sLSTM's loop as the step runs it: one block's forward under the
    # step's checkpoint, its recompute and its backward, at the step's shape
    p_s = {k: v[0] for k, v in params["slstm_layers"].items()}
    x = torch.randn((batch, seq, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(SEED)
                    ).to(torch.bfloat16)
    for _ in range(2):                           # the second is timed
        xi = x.detach().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = torch.utils.checkpoint.checkpoint(
            lambda x_: xlstm.slstm_block(x_, p_s, cfg)[0], xi,
            use_reentrant=False)
        y.float().sum().backward()
        torch.cuda.synchronize()
        block_s = time.perf_counter() - t0
    del x, xi, y
    plain = sum(rec["plain_s"][1:]) / len(rec["plain_s"][1:])
    rec.update(slstm_block_s=block_s, slstm_share=n_s * block_s / plain)
    print(f"[xlstm] the sLSTM's loop over {seq} steps, one block at batch "
          f"{batch} as the step runs it (checkpointed forward, recompute, "
          f"backward): {block_s:.3f} s; x {n_s} blocks {n_s * block_s:.2f} s "
          f"of the {plain:.3f} s warm plain step "
          f"({100 * n_s * block_s / plain:.0f}%)", flush=True)

    # (d) the dense engine: 2 requests of P + GEN
    P, gen = XLSTM_SERVE, VARIANT_GEN
    stream = _prompt_stream(cfg, P, gen, SEED + 1)
    s_ = _serve_dense("xlstm", cfg, bundle, params, stream[:, :P], gen)
    c = bundle.init_cache(2, P + gen + 8, device="meta")
    state_bytes = (sum(a.nbytes for a in c.mlstm) + c.mlstm_conv.nbytes
                   + sum(a.nbytes for a in c.slstm))
    serve_peak = torch.cuda.max_memory_allocated()
    print(f"[xlstm] serve (dense): 2 x ({P} + {gen}): {s_['tok_per_s']:.1f} "
          f"tok/s, TTFT p50 {s_['ttft_p50_s'] * 1e3:.1f} ms, decode step "
          f"{s_['decode_step_ms_mean']:.2f} ms; cache {state_bytes / 2**20:.2f}"
          f" MiB at any length (mLSTM C, n, m, bf16 conv windows, sLSTM h, "
          f"c, n, m); serve peak {serve_peak / 2**30:.2f} GiB", flush=True)
    rec.update(serve={"tok_s": s_["tok_per_s"],
                      "ttft_p50_s": s_["ttft_p50_s"],
                      "decode_step_ms": s_["decode_step_ms_mean"],
                      "state_bytes": state_bytes},
               serve_peak_gib=serve_peak / 2**30)
    # teacher-forced in bf16, sound and under the planted faults
    runs = _xlstm_teacher_forced(cfg, bundle, params, stream.cuda(), P, gen)
    rec["teacher_forced"] = {}
    fails = []
    for run, (agree, p90, scale, gap) in runs.items():
        ok = (agree >= XLSTM_AGREE
              and p90 < VARIANT_P90 * scale + VARIANT_P90
              and max(gap.values()) <= XLSTM_STATE_REL)
        rec["teacher_forced"][run] = dict(agree=agree, p90=p90, scale=scale,
                                          state_gap=gap)
        print(f"[xlstm] teacher-forced bf16 decode (2 x {P} + {gen}) vs "
              f"xlstm_forward, {run}: argmax agreement {agree:.3f} (>= "
              f"{XLSTM_AGREE}), p90 |delta| {p90:.4f} < "
              f"{VARIANT_P90 * scale + VARIANT_P90:.4f}; states of prefill("
              f"{P}) + {gen} decode steps vs prefill({P + gen}), at one "
              f"stabiliser, of the largest: "
              f"{', '.join(f'{k} {v:.2e}' for k, v in gap.items())} (budget "
              f"{XLSTM_STATE_REL:g}): {'passes' if ok else 'fails'}",
              flush=True)
        if ok != (run == "sound"):
            fails.append(run)
    if fails:
        raise AssertionError(f"xlstm decode vs forward: the sound run must "
                             f"pass and each fault fail; wrong: {fails} "
                             f"({rec['teacher_forced']})")
    print(f"[xlstm] phase 27 (c, d) {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del runs, params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_xlstm() -> dict:
    """Phase 27: xlstm-125m, (a) the optimizer kernels at the sLSTM's R
    stack and the embedding's view, (b) the smoke config CUDA against the
    CPU, (c) training and (d) serving at full width and depth."""
    t0 = time.perf_counter()
    kernels: dict = {}
    _time_opt_shapes(kernels, "xlstm", XLSTM_OPT_SHAPES, SEED + 40,
                     library=True)
    phase_xlstm_smoke()
    train = phase_xlstm_full()
    print(f"[xlstm] phase 27: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"kernels": kernels, "train": train}


def _encdec_cache_to(cache, device):
    """A copy of an encoder-decoder cache on ``device``."""
    from repro_torch.models.encdec import EncDecCache

    return EncDecCache(**{
        f: getattr(cache, f).to(device, copy=True)
        for f in ("self_k", "self_v", "self_pos", "cross_k", "cross_v")},
        length=cache.length)


def _encdec_rels(c_c, c_h) -> list[float]:
    return [_rel(getattr(c_c, f), getattr(c_h, f))
            for f in ("self_k", "self_v", "cross_k", "cross_v")]


def phase_encdec_smoke() -> None:
    """Phase 28 (b): the fp32 smoke seamless (2 encoder and 2 decoder
    layers) on CUDA and on the CPU from the same params: the loss and
    every gradient within ``FAMILY_SMOKE_REL``; 4 steps through ``run``
    (rank 32, ``--grad-fused`` asked for: the fallback) within
    ``SMOKE_LOSS_ATOL``, exact launches from the plans; prefill of 24
    frames and 13 tokens (logits and the self and cross K/V within
    ``FAMILY_SMOKE_REL``, the position tags equal), then 3 decode steps,
    each from the CPU's cache of the step before, within it."""
    cfg, bundle, params, batches = _family_smoke_data(SEAMLESS_ARCH)
    on = _smoke_grads_and_run(
        "seamless", cfg, params, batches, 32, FAMILY_SMOKE_REL,
        f"{cfg.n_enc_layers} encoder and {cfg.n_dec_layers} decoder layers")
    P, P_enc, gen = 13, 24, 3
    toks = _prompt_stream(cfg, P, gen, SEED + 3)
    frames = batches[0]["frames"][:, :P_enc]
    with torch.no_grad():
        res = {d: bundle.prefill(on[d], {"tokens": toks[:, :P].to(d),
                                         "frames": frames.to(d)}, P + gen + 5)
               for d in ("cuda", "cpu")}
        (lg_c, c_c), (lg_h, c_h) = res["cuda"], res["cpu"]
        rels = [_rel(lg_c, lg_h)] + _encdec_rels(c_c, c_h)
        if max(rels) > FAMILY_SMOKE_REL or not torch.equal(
                c_c.self_pos.cpu(), c_h.self_pos):
            raise AssertionError(f"seamless smoke prefill: logits, self "
                                 f"k, v, cross k, v {rels}")
        line = [f"prefill {max(rels):.2e}"]
        del res, c_c
        for i in range(gen):
            tok = toks[:, P + i]
            lg_c, c_c = bundle.decode_step(on["cuda"],
                                           _encdec_cache_to(c_h, "cuda"),
                                           tok.cuda())
            lg_h, c_h = bundle.decode_step(on["cpu"], c_h, tok)
            rels = [_rel(lg_c, lg_h)] + _encdec_rels(c_c, c_h)
            if max(rels) > FAMILY_SMOKE_REL or not torch.equal(
                    c_c.self_pos.cpu(), c_h.self_pos):
                raise AssertionError(f"seamless smoke decode {i}: {rels}")
            line.append(f"decode {i} {max(rels):.2e}")
            del c_c
    print(f"[seamless] smoke prefill ({P_enc} frames, {P} tokens) and {gen} "
          f"decode steps, each from the CPU's cache: logits and self / "
          f"cross K/V, CUDA vs CPU of the largest entry (budget "
          f"{FAMILY_SMOKE_REL:g}): {'; '.join(line)}", flush=True)


def phase_encdec_full() -> dict:
    """Phase 28 (c, d): seamless-m4t-large-v2 at full width and
    ``SEAMLESS_LAYERS`` encoder + decoder layers: 4 SubTrack++ steps
    through ``run`` (batch 2 x 2048 frames and tokens, default rank 256,
    kernels on, eta pinned): finite, unquarantined, tracking at 2,
    launches from the plans; then the trained weights through
    ``run_dense`` (2 requests of 1024 + 16 on zero frames; the self and
    cross K/V bytes), the 16 teacher-forced against ``encode`` +
    ``decode_train`` (phase 24's criteria)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec
    from repro_torch.models.api import build_model

    t_phase = time.perf_counter()
    full = get_config(SEAMLESS_ARCH)
    cfg = full.with_(n_enc_layers=SEAMLESS_LAYERS,
                     n_dec_layers=SEAMLESS_LAYERS,
                     n_layers=2 * SEAMLESS_LAYERS)
    batch, seq = SEAMLESS_TRAIN

    def cut(n_params, rank, n_low, n_svd):
        return (f"seamless-m4t-large-v2 cut to size: {full.n_enc_layers} + "
                f"{full.n_dec_layers} -> {cfg.n_enc_layers} encoder + "
                f"{cfg.n_dec_layers} decoder layers at full width (d "
                f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, d_ff "
                f"{cfg.d_ff}, vocab {cfg.padded_vocab}; the speech front end "
                f"a stub of frame embeddings): {n_params / 1e9:.2f} B params;"
                f" rank {rank} ({n_low} low-rank leaves, {n_svd} matrices), "
                f"batch {batch} x {seq} frames and tokens, eta "
                f"{VARIANT_ETA:g}")

    rec, params = _train_full("seamless", cfg, batch, seq, cut, FAMILY_USED)
    bundle = build_model(cfg)

    # (d) the dense engine: 2 requests of P + GEN on zero frames
    P, gen = SEAMLESS_SERVE, VARIANT_GEN
    stream = _prompt_stream(cfg, P, gen, SEED + 1)
    s_ = _serve_dense("seamless", cfg, bundle, params, stream[:, :P], gen)
    c = encdec.init_encdec_cache(cfg, 2, P + gen + 8, memory_len=P,
                                 device="meta")
    self_bytes = c.self_k.nbytes + c.self_v.nbytes
    cross_bytes = c.cross_k.nbytes + c.cross_v.nbytes
    serve_peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        toks = stream.cuda()
        frames = torch.zeros((2, P, cfg.d_model), dtype=torch.bfloat16,
                             device="cuda")
        logits, cache = bundle.prefill(params, {"tokens": toks[:, :P],
                                                "frames": frames}, P + gen)
        got = [logits.float().cpu()]
        for i in range(gen):
            logits, cache = bundle.decode_step(params, cache, toks[:, P + i])
            got.append(logits.float().cpu())
        del cache, logits
        # the forward's KV blocks must tile both the P + GEN tokens and
        # the P frames
        fcfg = cfg.with_(kv_block=_divisor_block(math.gcd(P + gen, P),
                                                 cfg.kv_block))
        memory = encdec.encode(params, frames, fcfg, remat="none")
        full_logits = encdec.decode_train(params, memory, toks, fcfg,
                                          remat="none")
        want_l = full_logits[:, P - 1:].float().transpose(0, 1).cpu()
        del full_logits, memory
    agree, p90, scale = _agreement(torch.stack(got), want_l, slice(None))
    if not (agree >= VARIANT_AGREE
            and p90 < VARIANT_P90 * scale + VARIANT_P90):
        raise AssertionError(f"seamless decode vs forward: agreement "
                             f"{agree:.3f}, p90 {p90:.4f} (scale "
                             f"{scale:.3f})")
    rec.update(serve={"tok_s": s_["tok_per_s"],
                      "ttft_p50_s": s_["ttft_p50_s"],
                      "decode_step_ms": s_["decode_step_ms_mean"],
                      "self_kv_bytes": self_bytes,
                      "cross_kv_bytes": cross_bytes},
               serve_peak_gib=serve_peak / 2**30, agree=agree, p90=p90,
               scale=scale)
    print(f"[seamless] serve (dense): 2 x ({P} + {gen}) on zero frames: "
          f"{s_['tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{s_['ttft_p50_s'] * 1e3:.1f} ms, decode step "
          f"{s_['decode_step_ms_mean']:.2f} ms; cache: self K/V "
          f"{self_bytes / 2**20:.2f} MiB ({P + gen + 8} slots), cross K/V "
          f"{cross_bytes / 2**20:.2f} MiB ({P} frames)", flush=True)
    print(f"[seamless] teacher-forced decode (2 x {P} + {gen}) vs encode + "
          f"decode_train: argmax agreement {agree:.3f} (>= {VARIANT_AGREE}),"
          f" p90 |delta| {p90:.4f} < {VARIANT_P90 * scale + VARIANT_P90:.4f};"
          f" serve peak {serve_peak / 2**30:.2f} GiB; phase 28 (c, d) "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del params, toks, frames, got, want_l
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_encdec() -> dict:
    """Phase 28: seamless-m4t-large-v2, (a) the optimizer kernels at the
    embedding's view and the w_gate stack, and the warm start's SVD of
    the embedding, (b) the smoke config CUDA against the CPU, (c) training
    and (d) serving at full width and ``SEAMLESS_LAYERS`` + as many
    layers."""
    from repro_torch.core.subspace import init_subspace_svd

    t0 = time.perf_counter()
    kernels: dict = {}
    _time_opt_shapes(kernels, "seamless", SEAMLESS_OPT_SHAPES, SEED + 50,
                     library=True)
    _, m, n, r, _, _ = SEAMLESS_OPT_SHAPES[0]       # the embedding's view
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    G = torch.randn((m, n), generator=gen, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    t_svd = time.perf_counter()
    S = init_subspace_svd(G, r)
    torch.cuda.synchronize()
    svd_s = time.perf_counter() - t_svd
    orth = (S.mT @ S - torch.eye(r, device="cuda")).abs().max().item()
    print(f"[seamless] warm-start SVD of the embedding gradient's shape "
          f"({m}, {n}), bf16 G ({G.numel() / 2**30:.2f} x 2^30 elements: "
          f"gesvd whole): {svd_s:.2f} s, max |S^T S - I| {orth:.1e}",
          flush=True)
    del G, S
    gc.collect()
    torch.cuda.empty_cache()
    phase_encdec_smoke()
    train = phase_encdec_full()
    train["svd_embed_s"] = svd_s
    print(f"[seamless] phase 28: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"kernels": kernels, "train": train}


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
    opt_err = phase_check_optimizer()
    opt_time = phase_time_optimizer()
    tap_err = phase_check_grad_tap()
    tap_time = phase_time_grad_tap()
    phase_train_smoke()
    front_err = phase_check_front()
    front_time = phase_time_front()
    unfused = phase_unfused_step()
    gram_err = phase_check_gram_adam()
    gram_time = phase_time_gram_adam()
    phase_gram_schedule()
    flash = phase_flash()
    phase_time_svd()
    trained = phase_train_7b()
    mesh = phase_mesh_programs(trained)
    fused = phase_train_7b_grad_fused(trained)
    trained_1b = phase_train_1b()
    variants = phase_decoder_variants()
    moe = phase_moe()
    zamba = phase_zamba()
    xl = phase_xlstm()
    seamless = phase_encdec()
    phase_serve_dense(served)
    fp32_routes = phase_time_fp32_routes()
    phase_train_1b_options(trained_1b)
    phase_runtime_1b(trained_1b)
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
        "timing": timing["timing"], "splits": timing["splits"],
    }]
    for name, (src, line) in OPT_KERNELS.items():
        t = opt_time[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/grassmann.py:{line}",
            "launches": trained["launches"][name],
            "max_abs_err": opt_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        for key in ("bound_fp32_ms", "kernel_route"):
            if key in t:
                kernels[-1][key] = t[key]
    kernels.append({
        "name": "grad_tap", "route": "cuda",
        "source": "src/repro_torch/csrc/grad_tap.cu",
        "replaces": "src/repro/kernels/grassmann.py:406",
        "launches": fused["launches"]["grad_tap"],
        "max_abs_err": tap_err, "ms": tap_time["ms"],
        "plain_ms": tap_time["plain_ms"], "bound_ms": tap_time["bound_ms"],
        "bound_by": tap_time["bound_by"],
        "library_ms": tap_time["library_ms"],
        "bound_mixed_ms": tap_time["bound_mixed_ms"],
        "kernel_route": tap_time["kernel_route"], "xs_ms": tap_time["xs_ms"],
        "xs_bound_ms": tap_time["xs_bound_ms"]})
    for name, (src, line) in FRONT_KERNELS.items():
        t = front_time[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/grassmann.py:{line}",
            "launches": (trained_1b["launches"][name]
                         if name == "project_tangent_colnorms"
                         else unfused[name]),
            "max_abs_err": front_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        for key in ("bound_fp32_ms", "kernel_route", "composite_ms"):
            if key in t:
                kernels[-1][key] = t[key]
    for name, src, line, launches in (
            ("tangent_gram", "grassmann_tangent_gram.cu", 479,
             mesh["launches"]["tangent_gram"]),
            ("adam_lowrank", "adam_lowrank_norms.cu", 634,
             gram_err["adam_lowrank_launches"])):
        t = gram_time[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/grassmann.py:{line}",
            "launches": launches, "max_abs_err": gram_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        for key in ("bound_fp32_ms", "kernel_route"):
            if key in t:
                kernels[-1][key] = t[key]
    t = flash[FLASH_TIMED[0]]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "launches": flash["launches"], "max_abs_err": flash["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "design_bound_ms": t["design_bound_ms"],
        "kernel_route": t["kernel_route"],
        "gemma2_local": {k: flash[FLASH_TIMED[1]][k]
                         for k in ("ms", "plain_ms", "bound_ms",
                                   "design_bound_ms", "library_ms",
                                   "no_softcap_ms")}})
    for entry in kernels:
        name = entry["name"]
        if name in variants["kernels"]:    # phase 24 (a): the new shapes
            entry["variant_shapes"] = variants["kernels"][name]
        entry["variant_launches"] = {       # phase 24 (c): the three runs
            arch: run_["launches"][name]
            for arch, run_ in variants["runs"].items()}
        if name in moe["kernels"]:         # phase 25: the expert stacks
            entry["moe_shapes"] = moe["kernels"][name]
        entry["moe_launches"] = {           # phase 25 (b) and (d)
            "mixtral-8x22b train": moe["mixtral"]["launches"][name],
            "llama4-maverick-400b-a17b serve (paged)":
                moe["maverick"]["paged_attention_launches"]
                if name == "paged_attention" else 0}
        if name == "paged_attention":      # phase 25 (d): maverick's decode
            entry["maverick_decode"] = moe["maverick"]["kernel"]
        if name in zamba["kernels"]:       # phase 26 (a): zamba's stacks
            entry["zamba_shapes"] = zamba["kernels"][name]
        entry["zamba_launches"] = {         # phase 26 (c)
            "zamba2-7b train": zamba["train"]["launches"][name]}
        for key, res, arch in (("xlstm", xl, "xlstm-125m"),
                               ("seamless", seamless,
                                "seamless-m4t-large-v2")):
            if name in res["kernels"]:    # phases 27 and 28 (a)
                entry[f"{key}_shapes"] = res["kernels"][name]
            entry[f"{key}_launches"] = {    # phases 27 and 28 (c)
                f"{arch} train": res["train"]["launches"][name]}
        if name in fp32_routes:   # the routes --accum puts on a path
            entry["fp32_ms"] = fp32_routes[name]["ms"]
            entry["fp32_bound_ms"] = fp32_routes[name]["bound_ms"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
