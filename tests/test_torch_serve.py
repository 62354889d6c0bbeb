"""The port's serving stack against the JAX package, end to end on the CPU.

Greedy tokens of the port's ``run_paged`` and ``run_dense`` must be
identical to the JAX package's paged engine (``run_paged``) and its
static-batch engine (``run_dense``), on the case of ``tests/test_serve.py``
(P = 9, GEN = 5, block size 4, whole-prompt and 4-token chunked prefill)
for the fp32 smoke llama and its GQA variant (n_kv_heads 2, QKV bias, 25%
partial rotary); with heterogeneous ``max_new`` the dense engines also
agree on their decode-step counts.  Both packages start from the JAX
init's parameters.

The host-side policy the port copies (block allocator, admission queue)
is held to the JAX package's by driving both with one scripted sequence
of operations; sampling and the synthetic prompt source get their own
contracts, since their random draws differ between the packages by
design.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.distributed.context import mesh_context
from repro.launch import serve as jserve
from repro.launch.mesh import smoke_context
from repro.models.api import build_model as jax_build_model
from repro.serve.kv_cache import BlockAllocator as JaxAllocator
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models.api import build_model
from repro_torch.serve.kv_cache import BlockAllocator
from repro_torch.serve.sampling import sample_tokens
from torch_threads import one_thread  # noqa: F401


P, GEN, BS = 9, 5, 4


def _perturb_zero_inits(tree, rng):
    if isinstance(tree, dict):
        return {k: _perturb_zero_inits(v, rng) for k, v in tree.items()}
    if not np.any(tree):
        return (0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)
    return tree


def _queue(mod, prompts, max_new):
    """``max_new``: one count for every request, or one per request."""
    if isinstance(max_new, int):
        max_new = [max_new] * len(prompts)
    q = mod.AdmissionQueue()
    for i, (p, g) in enumerate(zip(prompts, max_new)):
        q.submit(mod.Request(rid=i, prompt=p, max_new=g), now=1.0)
    return q


def _jax_params(jcfg, variant):
    """The JAX init's params as numpy (the GQA variant's zero-initialised
    biases and norms perturbed, so they matter)."""
    params_np = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    if variant == "gqa":
        params_np = _perturb_zero_inits(params_np, np.random.default_rng(1))
    return params_np


def _configs(variant):
    extra = (dict(n_kv_heads=2, qkv_bias=True, rope_pct=0.25)
             if variant == "gqa" else {})
    return (jax_get_config("llama-100m", smoke=True).with_(
                dtype="float32", **extra),
            get_config("llama-100m", smoke=True).with_(
                dtype="float32", **extra))


@pytest.mark.parametrize("variant", ["llama", "gqa"])
def test_greedy_tokens_match_both_jax_engines(variant):
    jcfg, tcfg = _configs(variant)
    prompts = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, size=(3, P)).astype(np.int32)
    pool_blocks = 1 + 2 * -(-(P + GEN) // BS)
    with mesh_context(smoke_context()):
        jbundle = jax_build_model(jcfg)
        params_np = _jax_params(jcfg, variant)
        jparams = jax.tree.map(jax.numpy.asarray, params_np)
        want = {"dense": jserve.run_dense(
            jcfg, jbundle, jparams, _queue(jserve, prompts, GEN), batch=2,
            prompt_len=P)["outputs"]}
        for chunk in (0, 4):
            want[chunk] = jserve.run_paged(
                jcfg, jbundle, jparams, _queue(jserve, prompts, GEN),
                batch=2, block_size=BS, pool_blocks=pool_blocks,
                max_context=P + GEN, prefill_chunk=chunk)["outputs"]

    bundle = build_model(tcfg)
    tparams = params_from_jax(params_np, tcfg, "cpu")
    for chunk in (0, 4):
        got = tserve.run_paged(
            tcfg, bundle, tparams, _queue(tserve, prompts, GEN), batch=2,
            block_size=BS, pool_blocks=pool_blocks, max_context=P + GEN,
            prefill_chunk=chunk)
        assert got["outputs"] == want[chunk] == want["dense"]
        assert all(len(t) == GEN for t in got["outputs"].values())
        assert got["kv"]["prefill_chunks"] == 3 * (3 if chunk else 1)
        assert got["decode_calls"] > 0
    dense = tserve.run_dense(tcfg, bundle, tparams,
                             _queue(tserve, prompts, GEN), batch=2,
                             prompt_len=P)
    assert dense["outputs"] == want["dense"]
    assert dense["engine"] == "dense" and dense["tokens"] == 3 * GEN
    assert dense["decode_step_ms_mean"] > 0 and dense["ttft_p50_s"] >= 0
    counts = ops.launch_counts()                 # CPU: the oracle
    assert counts["paged_attention"] == 0 and not any(counts.values())


def test_dense_engine_with_heterogeneous_max_new_matches_jax():
    """A wave ends when its longest request is done and a finished slot
    emits nothing: outputs and decode-step counts equal the JAX dense
    engine's (max_new 2, 5, 3 over two waves of batch 2: 4 + 2 steps)."""
    jcfg, tcfg = _configs("llama")
    prompts = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, size=(3, P)).astype(np.int32)
    max_new = [2, 5, 3]
    with mesh_context(smoke_context()):
        params_np = _jax_params(jcfg, "llama")
        want = jserve.run_dense(
            jcfg, jax_build_model(jcfg),
            jax.tree.map(jax.numpy.asarray, params_np),
            _queue(jserve, prompts, max_new), batch=2, prompt_len=P)
    got = tserve.run_dense(tcfg, build_model(tcfg),
                           params_from_jax(params_np, tcfg, "cpu"),
                           _queue(tserve, prompts, max_new), batch=2,
                           prompt_len=P)
    assert got["outputs"] == want["outputs"]
    assert [len(got["outputs"][i]) for i in range(3)] == max_new
    assert got["decode_calls"] == want["decode_calls"] == 4 + 2


def test_pool_exhaustion_sheds_and_defers():
    """KV OOM policy, as tests/test_serve.py pins it for the JAX engine."""
    cfg = get_config("llama-100m", smoke=True).with_(dtype="float32")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, P))
    q = _queue(tserve, prompts, GEN)
    q.submit(tserve.Request(rid=99, prompt=np.zeros(40, np.int32),
                            max_new=4), now=1.0)   # can never fit -> shed
    out = tserve.run_paged(cfg, bundle, params, q, batch=2, block_size=BS,
                           pool_blocks=5, max_context=P + GEN,
                           prefill_chunk=0)
    assert out["shed"] == [99] and out["kv"]["oom_shed"] == 1
    assert 0 < out["kv"]["oom_deferrals"] <= 3
    assert sorted(out["outputs"]) == [0, 1, 2, 3]


def _drive_allocators(ops_seq):
    """Apply one scripted op sequence to both allocators; return both
    traces of (result, tables, free, reserved)."""
    traces = []
    for cls in (JaxAllocator, BlockAllocator):
        a = cls(num_blocks=9, block_size=3)
        trace = []
        for op, rid, n in ops_seq:
            if op == "reserve":
                res = a.reserve(rid, n)
            elif op == "ensure":
                res = a.ensure(rid, n)
            elif op == "append":
                res = a.append(rid)
            else:
                res = a.free(rid)
            trace.append((res, {r: a.table(r) for r in sorted(a._tables)},
                          a.free_blocks, a.reserved_blocks, a.occupancy))
        traces.append(trace)
    return traces


def test_allocator_copy_behaves_like_jax():
    seq = [("reserve", 0, 7), ("reserve", 1, 9), ("ensure", 0, 4),
           ("reserve", 2, 10), ("append", 1, 0), ("ensure", 1, 9),
           ("append", 0, 0), ("append", 0, 0), ("free", 1, 0),
           ("reserve", 2, 10), ("ensure", 2, 10), ("append", 0, 0),
           ("free", 0, 0), ("reserve", 3, 3), ("ensure", 3, 3)]
    jtrace, ttrace = _drive_allocators(seq)
    assert ttrace == jtrace


def test_admission_queue_copy_behaves_like_jax():
    def run(mod):
        q = mod.AdmissionQueue(max_queue=3, deadline_s=2.0)
        log = []
        for rid, t in [(0, 1.0), (1, 1.5), (2, 4.0), (3, 4.0)]:
            log.append(q.submit(mod.Request(rid=rid, prompt=np.zeros(2),
                                            max_new=1, t_submit=t)))
        wave = q.take_wave(4, now=4.0)
        q.defer(wave[0])
        q.shed_now(mod.Request(rid=7, prompt=np.zeros(2), max_new=1))
        log.append([r.rid for r in q.take_wave(1, now=5.0)])
        log.append([r.rid for r in q.take_wave(1, now=9.0)])
        return log, [(r.rid, r.status) for r in q.shed + q.expired]

    assert run(tserve) == run(jserve)


def test_sampling_greedy_is_full_width_argmax_and_temperature_reproducible():
    logits = torch.tensor(np.random.default_rng(3).standard_normal((5, 64)),
                          dtype=torch.float32)
    greedy = sample_tokens(logits, 0.0, seed=0, n_samples=0)
    assert greedy.tolist() == np.argmax(logits.numpy(), -1).tolist()
    assert sample_tokens(logits, -1.0, 9, 4).tolist() == greedy.tolist()
    a = sample_tokens(logits, 0.8, seed=4, n_samples=2)
    assert a.tolist() == sample_tokens(logits, 0.8, 4, 2).tolist()
    assert all(0 <= t < 64 for t in a.tolist())
    draws = {tuple(sample_tokens(logits, 5.0, 4, n).tolist())
             for n in range(8)}
    assert len(draws) > 1                   # the call count is folded in


def test_synthetic_prompts_are_a_pure_zipf_markov_function_of_the_seed():
    cfg = DataConfig(vocab_size=512, seq_len=256, global_batch=8, seed=3)
    a = SyntheticLMDataset(cfg).global_batch_at(0)["tokens"]
    b = SyntheticLMDataset(cfg).global_batch_at(0)["tokens"]
    assert a.shape == (8, 256) and torch.equal(a, b)
    assert not torch.equal(a,
                           SyntheticLMDataset(cfg).global_batch_at(1)["tokens"])
    assert int(a.min()) >= 0 and int(a.max()) < 512
    ds = SyntheticLMDataset(cfg)
    follows = ds._succ[a[:, :-1] % cfg.n_patterns] % 512 == a[:, 1:]
    assert 0.6 < follows.float().mean().item() < 0.85     # strength 0.7
    # Zipf head: token 0 is ~19% of the 30% base draws, vs 0.2% uniform
    assert (a == 0).float().mean().item() > 0.03


def test_serve_cli_on_cpu_answers_every_request():
    out = tserve.serve(["--arch", "llama-100m", "--smoke", "--device", "cpu",
                        "--requests", "3", "--batch", "2", "--prompt-len",
                        "9", "--gen", "4", "--block-size", "4",
                        "--prefill-chunk", "4", "--temperature", "0.7"])
    assert out["requests"] == 3 and out["tokens"] == 12
    assert out["temperature"] == 0.7 and out["engine"] == "paged"
    assert out["ttft_p50_s"] >= 0 and out["decode_wave_ms_mean"] > 0
