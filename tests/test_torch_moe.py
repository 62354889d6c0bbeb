"""The Mixture-of-Experts layer, the two MoE configs and the ring cache
against the JAX package, on the CPU.

The JAX side runs inside ``mesh_context(smoke_context())`` (the one-device
mesh of ``tests/test_moe.py``); each JAX program is compiled once, in a
module-scoped fixture, and every comparison is fp32 from the same numpy
parameters (``params_from_jax``):

* ``moe_layer`` at d 16: top-2 softmax gates, top-1 sigmoid gates,
  capacity drops at capacity factor 0.01 for top-1 and top-2 (the same
  dropped rows, slot-major ranking), the shared expert, and the serving
  layout equal to the training one: the output and the aux + z loss at
  2e-5 of the largest entry, every gradient (the router's included) at
  1e-5;
* ``moe_capacity``, ``_route``'s order on tied logits (the lower index
  first, as ``lax.top_k``) and ``expert_layout``;
* the mixtral-8x22b and llama4-maverick smoke decoders: loss, aux metric
  and every gradient at 2e-5; one plain and one tracking SubTrack++ step
  from one JAX state on mixtral's 5-D expert banks (1e-5, 1e-3);
* the ring cache: ``_prefill_positions`` and ``_fit_cache`` at S < T,
  S = T and S > T, and mixtral smoke (window cut to 16) prefilled below
  and past the window and decoded past it, logits and cache each step;
* maverick smoke greedy tokens through the port's paged (chunked
  prefill: each chunk its own capacity) and dense engines against the JAX
  engines;
* the MoE configs' ``paged_supported``, ``_tap_paths``, default ranks and
  init shapes against the reference's (``paged_supported`` and
  ``_tap_paths`` for every arch of the port's registry), and both CLIs at
  smoke size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.distributed.context import mesh_context
from repro.launch import serve as jserve
from repro.launch.mesh import smoke_context
from repro.launch.steps import _tap_paths as jax_tap_paths
from repro.launch.steps import default_rank as jax_default_rank
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.api import build_model as jax_build_model
from repro.models.config import MoEConfig as JMoEConfig
from repro_torch.configs.registry import PAPER_RANKS, get_config
from repro_torch.core.subtrack import tree_leaves
from repro_torch.distributed.context import abstract_context
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import _tap_paths, default_rank
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model
from repro_torch.models.config import MoEConfig
from torch_compare import (check_optimizer_step, close, close_tree,
                           jax_optimizer_steps, unflatten)
from torch_threads import one_thread  # noqa: F401


TOL = 2e-5
GRAD_TOL = 1e-5
ARCHS = ("mixtral-8x22b", "llama4-maverick-400b-a17b")
D, FF = 16, 32
# case -> (E, k, capacity factor, shared expert, B, S)
LAYER_CASES = {
    "top2": (4, 2, 8.0, False, 2, 8),
    "top1-sigmoid": (4, 1, 8.0, False, 2, 8),
    "drops-top1": (4, 1, 0.01, False, 4, 16),
    "drops-top2": (4, 2, 0.01, False, 4, 16),
    "shared": (4, 1, 8.0, True, 2, 8),
}
B, S = 2, 64                    # decoder loss batch
WINDOW, RING_MAX = 16, 48       # mixtral smoke window cut so decode wraps
RING_CASES = {"below": (8, 12), "past": (32, 4)}   # prompt -> decode steps
P, GEN, BS = 9, 5, 4            # the serving case of tests/test_serve.py


# ---------------------------------------------------------------------------
# moe_layer
# ---------------------------------------------------------------------------


def _layer_inputs(case):
    E, k, cf, shared, b, s = LAYER_CASES[case]
    rng = np.random.default_rng(len(case))
    kw = dict(n_shared_experts=1, shared_d_ff=FF) if shared else {}
    moe = dict(n_experts=E, top_k=k, d_ff=FF, capacity_factor=cf, **kw)

    def rn(*shape, std=None):
        std = shape[-2] ** -0.5 if std is None else std
        return (std * rng.standard_normal(shape)).astype(np.float32)

    params = {"router": rn(D, E), "wg": rn(1, E, D, FF),
              "wu": rn(1, E, D, FF), "wd": rn(1, E, FF, D)}
    if shared:
        params.update(shared_wg=rn(D, FF), shared_wu=rn(D, FF),
                      shared_wd=rn(FF, D))
    return (moe, params, rn(b, s, D, std=0.5), rn(b, s, D, std=1.0))


@pytest.fixture(scope="module")
def layer_runs():
    """Per case, from one compiled program: the JAX layer's output, aux,
    the gradients of sum(y * ct) + aux over x and every parameter, and
    the serving layout's output."""
    out = {}
    with mesh_context(smoke_context()):
        for case in LAYER_CASES:
            moe, params, x, ct = _layer_inputs(case)
            cfg = JMoEConfig(**moe)

            def loss(x, p):
                y, aux = jmoe.moe_layer(x, p, cfg)
                ys, _ = jmoe.moe_layer(x, p, cfg, serving=True)
                return jnp.sum(y * ct) + aux, (y, aux, ys)

            (_, (y, aux, ys)), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), params)
            out[case] = dict(y=np.asarray(y), aux=float(aux),
                             grads=jax.tree.map(np.asarray, grads),
                             y_serving=np.asarray(ys))
    return out


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_jax(case, layer_runs):
    want = layer_runs[case]
    moe, params_np, x_np, ct = _layer_inputs(case)
    cfg = MoEConfig(**moe)
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in params_np.items()}
    x = torch.tensor(x_np, requires_grad=True)
    y, aux = tmoe.moe_layer(x, params, cfg)
    assert y.dtype == x.dtype and aux.dtype == torch.float32
    close(y, want["y"], msg="y")
    assert float(aux) == pytest.approx(want["aux"], rel=TOL)
    gx, *gp = torch.autograd.grad((y * torch.tensor(ct)).sum() + aux,
                                  [x] + list(params.values()))
    close(gx, want["grads"][0], GRAD_TOL, "dx")
    for (name, g) in zip(params, gp):
        close(g, want["grads"][1][name], GRAD_TOL, name)
    ys, aux_s = tmoe.moe_layer(x, params, cfg, serving=True)
    close(ys, want["y_serving"], msg="serving")
    assert torch.equal(ys, y) and torch.equal(aux_s, aux)
    if case.startswith("drops"):
        # the same rows dropped: with every choice of a token over
        # capacity its output is exactly zero in both packages
        N = x_np.shape[0] * x_np.shape[1]
        C = tmoe.moe_capacity(N, cfg)
        ids = tmoe._route(x.detach().reshape(N, D) @ params["router"],
                          cfg)[0]
        _, keep = tmoe.dispatch(ids, cfg.n_experts, C)
        assert C == 8 and not bool(keep.all())
        zero = ~keep.view(cfg.top_k, N).any(0)
        got_zero = (y.detach().reshape(N, D) == 0).all(-1)
        want_zero = (want["y"].reshape(N, D) == 0).all(-1)
        assert torch.equal(got_zero, torch.tensor(want_zero))
        assert torch.equal(got_zero, zero)
        if cfg.top_k == 1:
            assert bool(zero.any())


def test_capacity_route_ties_and_expert_layout():
    for n, E, k, cf in ((64, 4, 1, 0.01), (6144, 8, 2, 1.25),
                        (4, 128, 1, 1.25), (24, 4, 2, 8.0)):
        assert tmoe.moe_capacity(n, MoEConfig(E, k, 8, capacity_factor=cf)) \
            == jmoe.moe_capacity(n, JMoEConfig(E, k, 8, capacity_factor=cf))
    # ties go to the lower index first, as lax.top_k orders them
    logits = np.asarray([[1.0, 2.0, 1.0, 2.0, 0.5],
                         [0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    for k in (1, 2, 3):
        ids, gates, probs = tmoe._route(torch.tensor(logits),
                                        MoEConfig(5, k, 8))
        jids, jgates, jprobs = jmoe._route(jnp.asarray(logits),
                                           JMoEConfig(5, k, 8))
        assert ids.tolist() == np.asarray(jids).tolist()
        assert ids.tolist() == [[1, 3, 0][:k], [0, 1, 2][:k]]
        close(gates, jgates)
        close(probs, jprobs)
    one = abstract_context((1, 1))
    assert one.expert_layout(128, 8192) == (1, 128, 8192)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        abstract_context((1, 2)).expert_layout(8, 16384)


# ---------------------------------------------------------------------------
# The MoE decoders
# ---------------------------------------------------------------------------


def _configs(arch, **kw):
    kw = dict(dtype="float32", **kw)
    return (jax_get_config(arch, smoke=True).with_(**kw),
            get_config(arch, smoke=True).with_(**kw))


def _jax_params(jcfg, seed):
    """Parameters of the JAX package's schema and shapes, drawn with numpy:
    fan-in scaled weights (the router and expert banks included), 0.02
    N(0, 1) embeddings and nonzero norm scales."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))

    def draw(path, sds):
        name = path[-1].key
        if name == "embed":
            std = 0.02
        elif len(sds.shape) >= 3 or name == "lm_head":
            std = sds.shape[-2] ** -0.5
        else:
            std = 0.1
        return (std * rng.standard_normal(sds.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=ARCHS)
def decoder(request):
    """The JAX smoke decoder's loss, metrics and gradients."""
    arch = request.param
    jcfg, tcfg = _configs(arch)
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    params_np = _jax_params(jcfg, seed=len(arch))
    with mesh_context(smoke_context()):
        jb = jax_build_model(jcfg)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jb.loss(p, {"tokens": jnp.asarray(tokens)},
                              remat="none"), has_aux=True))(
            jax.tree.map(jnp.asarray, params_np))
    return dict(tcfg=tcfg, tokens=tokens, params_np=params_np,
                loss=float(loss), aux=float(metrics["aux_loss"]),
                grads=jax.tree.map(np.asarray, grads))


def test_decoder_loss_and_grads_match_jax(decoder):
    tcfg = decoder["tcfg"]
    params = params_from_jax(decoder["params_np"], tcfg)
    assert params["layers"]["mlp"]["router"].dtype == torch.float32
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, metrics = build_model(tcfg).loss(
        params, {"tokens": torch.tensor(decoder["tokens"]).long()},
        remat="none")
    assert float(loss) == pytest.approx(decoder["loss"], rel=TOL)
    assert float(metrics["aux_loss"]) == pytest.approx(decoder["aux"],
                                                       rel=TOL)
    assert float(metrics["aux_loss"]) > 0
    grads = torch.autograd.grad(loss, tree_leaves(params))
    close_tree(unflatten(params, grads), decoder["grads"])


@pytest.fixture(scope="module")
def opt_runs():
    jcfg, _ = _configs("mixtral-8x22b")
    return jax_optimizer_steps(_jax_params(jcfg, seed=5),
                               dict(rank=32, update_interval=2, eta=5.0),
                               seed=4)


@pytest.mark.parametrize("tracking", [False, True])
def test_optimizer_step_on_expert_banks_matches_jax(tracking, opt_runs):
    """One plain (1e-5) and one tracking (1e-3) SubTrack++ step on the
    mixtral smoke tree from one JAX state: the expert banks are 5-D
    leaves (L, 1, E, d, f) planned with 3 stack dims; the router (L, d, E)
    is dense."""
    banks = opt_state_from_jax(opt_runs["state_np"]).inner["layers"]["mlp"]
    for w in ("wg", "wu", "wd"):
        assert banks[w].S.shape == (2, 1, 4, 128, 32), w
    assert "S" not in banks["router"]._fields
    check_optimizer_step(opt_runs, _configs("mixtral-8x22b")[1], tracking)


# ---------------------------------------------------------------------------
# The ring cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S_", [5, 8, 13, 16, 19])
def test_ring_prefill_helpers_match_jax(S_):
    T = 8
    arr = np.random.default_rng(S_).standard_normal((2, S_, 3)).astype(
        np.float32)
    assert ttf._prefill_positions(S_, T).tolist() == np.asarray(
        jtf._prefill_positions(S_, T)).tolist()
    np.testing.assert_array_equal(
        ttf._fit_cache(torch.tensor(arr), T, S_).numpy(),
        np.asarray(jtf._fit_cache(jnp.asarray(arr), T, S_)))


@pytest.fixture(scope="module")
def ring_runs():
    """mixtral smoke (window 16, cache of 16 slots) prefilled with 8 and
    with 32 tokens, then decoded past the window: the JAX logits and
    cache after every program."""
    jcfg, tcfg = _configs("mixtral-8x22b", sliding_window=WINDOW)
    params_np = _jax_params(jcfg, seed=7)
    rng = np.random.default_rng(8)
    out = {}
    with mesh_context(smoke_context()):
        jb = jax_build_model(jcfg)
        jp = jax.tree.map(jnp.asarray, params_np)
        decode = jax.jit(jb.decode_step)
        for case, (s, n) in RING_CASES.items():
            toks = rng.integers(0, jcfg.vocab_size, (B, s + n)).astype(
                np.int32)
            lg, cache = jax.jit(lambda p, b: jb.prefill(p, b, RING_MAX))(
                jp, {"tokens": jnp.asarray(toks[:, :s])})
            served = [(lg, cache)]
            for i in range(n):
                lg, cache = decode(jp, cache, jnp.asarray(toks[:, s + i]))
                served.append((lg, cache))
            out[case] = (toks, [(np.asarray(a), jax.tree.map(np.asarray, c))
                                for a, c in served])
    return dict(tcfg=tcfg, params_np=params_np, runs=out)


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_prefill_and_decode_match_jax(case, ring_runs):
    tcfg = ring_runs["tcfg"]
    toks, want = ring_runs["runs"][case]
    s, n = RING_CASES[case]
    params = params_from_jax(ring_runs["params_np"], tcfg)
    bundle = build_model(tcfg)
    with torch.no_grad():
        logits, cache = bundle.prefill(
            params, {"tokens": torch.tensor(toks[:, :s]).long()}, RING_MAX)
        assert cache.kv.k.shape[2] == WINDOW
        for i, (wlg, wc) in enumerate(want):
            if i:
                logits, cache = bundle.decode_step(
                    params, cache, torch.tensor(toks[:, s + i - 1]).long())
            close(logits, wlg, msg=f"logits {i}")
            for f in ("k", "v", "positions"):
                close(getattr(cache.kv, f), getattr(wc.kv, f),
                       msg=f"{f} {i}")
            assert cache.length == int(wc.length) == s + i
    assert s + n > WINDOW     # the ring wrapped


# ---------------------------------------------------------------------------
# Serving llama4-maverick through both engines
# ---------------------------------------------------------------------------


def _queue(mod, prompts, max_new):
    q = mod.AdmissionQueue()
    for i, p in enumerate(prompts):
        q.submit(mod.Request(rid=i, prompt=p, max_new=max_new), now=1.0)
    return q


def test_maverick_greedy_tokens_match_both_jax_engines():
    jcfg, tcfg = _configs("llama4-maverick-400b-a17b")
    prompts = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, size=(3, P)).astype(np.int32)
    pool_blocks = 1 + 2 * -(-(P + GEN) // BS)
    params_np = _jax_params(jcfg, seed=9)
    with mesh_context(smoke_context()):
        jbundle = jax_build_model(jcfg)
        jparams = jax.tree.map(jnp.asarray, params_np)
        want = {"dense": jserve.run_dense(
            jcfg, jbundle, jparams, _queue(jserve, prompts, GEN), batch=2,
            prompt_len=P)["outputs"]}
        want["paged"] = jserve.run_paged(
            jcfg, jbundle, jparams, _queue(jserve, prompts, GEN), batch=2,
            block_size=BS, pool_blocks=pool_blocks, max_context=P + GEN,
            prefill_chunk=4)["outputs"]
    bundle = build_model(tcfg)
    assert bundle.paged_decode_step is not None
    tparams = params_from_jax(params_np, tcfg)
    got = tserve.run_paged(
        tcfg, bundle, tparams, _queue(tserve, prompts, GEN), batch=2,
        block_size=BS, pool_blocks=pool_blocks, max_context=P + GEN,
        prefill_chunk=4)
    assert got["outputs"] == want["paged"]
    assert all(len(t) == GEN for t in got["outputs"].values())
    assert got["kv"]["prefill_chunks"] == 3 * 3
    dense = tserve.run_dense(tcfg, bundle, tparams,
                             _queue(tserve, prompts, GEN), batch=2,
                             prompt_len=P)
    assert dense["outputs"] == want["dense"]


# ---------------------------------------------------------------------------
# Configs, plans and the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_match_the_reference(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert tcfg.moe.__dict__ == jcfg.moe.__dict__
    assert _tap_paths(tcfg) == jax_tap_paths(jcfg)
    assert ("layers", "mlp", "w_gate") not in _tap_paths(tcfg)
    assert ttf.paged_supported(tcfg) == jtf.paged_supported(jcfg)
    assert ttf.paged_supported(tcfg)[0] == (arch != "mixtral-8x22b")
    assert arch not in PAPER_RANKS
    assert default_rank(tcfg.d_model) == jax_default_rank(jcfg.d_model) \
        == {"mixtral-8x22b": 1024}.get(arch, 512)
    jsmoke, tsmoke = _configs(arch)
    assert tsmoke.moe.__dict__ == jsmoke.moe.__dict__
    params = build_model(tsmoke).init(torch.Generator().manual_seed(0))
    assert params["layers"]["mlp"]["router"].dtype == torch.float32
    assert params["layers"]["mlp"]["wg"].dtype == torch.float32
    with mesh_context(smoke_context()):
        jshapes = jax.eval_shape(jax_build_model(jsmoke).init,
                                 jax.random.PRNGKey(0))
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jshapes)
            == jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[1]),
                            params, is_leaf=torch.is_tensor))


def test_every_ported_arch_pages_and_taps_as_the_reference():
    """``paged_supported`` and ``_tap_paths`` equal the reference's for
    every arch in the port's registry: no refusal of its own is left."""
    from repro_torch.configs.registry import arch_names

    for arch in arch_names():
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        assert ttf.paged_supported(tcfg) == jtf.paged_supported(jcfg), arch
        assert _tap_paths(tcfg) == jax_tap_paths(jcfg), arch


def test_moe_clis_run_at_smoke_size():
    """``train --arch mixtral-8x22b`` and ``serve --arch
    llama4-maverick-400b-a17b`` (paged) run at smoke size on the CPU."""
    out = ttrain.train(["--arch", "mixtral-8x22b", "--smoke", "--device",
                        "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
                        "--rank", "32", "--update-interval", "1"])
    assert all(np.isfinite(out["losses"]))
    served = tserve.serve(["--arch", "llama4-maverick-400b-a17b", "--smoke",
                           "--device", "cpu", "--requests", "2",
                           "--prompt-len", "8", "--gen", "3"])
    assert served["engine"] == "paged" and served["tokens"] == 6
