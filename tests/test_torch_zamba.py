"""Mamba2's SSD and the zamba2-7b hybrid against the JAX package, on the
CPU.

Every comparison feeds the same numpy inputs to both packages (the
models' parameters through ``params_from_jax``) and is fp32.  The JAX
side runs inside ``mesh_context(smoke_context())``, and each JAX function
is compiled once (``jax.jit``) in a module-scoped fixture:

* ``ssd_chunked`` with S a multiple of the chunk and not, with and
  without an initial state, at 1e-5 of the largest entry; the port's
  chained ``ssd_decode_step`` against the same outputs and final state;
* ``_causal_conv`` and ``mamba_block`` (output and every gradient);
* the reference's NaN gradient: at chunk 128 a fast-decaying head's
  summed log-decay passes fp32's 88.7, the reference's ``_segsum_mask``
  takes exp of it above the diagonal and its backward gives 0 * inf =
  NaN in d/d(dt); the port masks the exponent first, so its gradient is
  finite, equal to the reference's on the heads where that is finite,
  and equal to the port's own float64 evaluation;
* the fp32 smoke zamba (6 layers in 2 groups, chunk 16): the loss and
  every gradient (the shared block's summed over its 2 applications)
  under each remat policy at 2e-5 of the largest entry; prefill (logits,
  SSD states, conv windows, the shared K/V and their position tags) at
  2e-5 and 3 decode steps at ``DECODE_TOL``, the bf16 conv window's
  rounding (see that test);
* one plain (1e-5) and one tracking (1e-3) SubTrack++ step from one JAX
  state on the smoke zamba's tree;
* the config, its plans at the full width and the CLIs at smoke size
  (the grad-fused fallback line and the paged engine's refusal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.plan import make_plans as jax_make_plans
from repro.distributed.context import mesh_context
from repro.launch.mesh import smoke_context
from repro.launch.steps import _tap_paths as jax_tap_paths
from repro.launch.steps import default_rank as jax_default_rank
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models.api import build_model as jax_build_model
from repro_torch.configs.registry import PAPER_RANKS, get_config
from repro_torch.core.plan import make_plans
from repro_torch.core.subtrack import tree_leaves
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import _tap_paths, default_rank
from repro_torch.models import ssm
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model
from torch_compare import (TOL, check_optimizer_step, close, close_bf16,
                           close_tree, jax_optimizer_steps, t as _t,
                           unflatten)
from torch_threads import one_thread  # noqa: F401


SSD_TOL = 1e-5
TOL = 2e-5
DECODE_TOL = 5e-4       # a decode step's bf16 conv rounding (see its test)
ARCH = "zamba2-7b"
# case -> (S, chunk, with h0); B 2, H 3, P 4, N 5
SSD_CASES = {"multiple": (32, 8, False), "ragged": (27, 8, False),
             "multiple-h0": (32, 8, True), "ragged-h0": (27, 8, True)}
SSD_DIMS = (2, 3, 4, 5)
B, S = 2, 64                    # the smoke model's loss batch
P, GEN = 24, 3                  # prefill (not a chunk multiple), decode steps
MAX_LEN = 32


# ---------------------------------------------------------------------------
# The SSD
# ---------------------------------------------------------------------------


def _ssd_inputs(S_, with_h0, seed):
    """x, dt (softplus of N(0, 1) - 2), A (-(1..3)), Bm, Cm, h0."""
    Bn, H, Pd, N = SSD_DIMS
    rng = np.random.default_rng(seed)

    def rn(*shape, std=1.0):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    dt = np.log1p(np.exp(rn(Bn, S_, H) - 2.0)).astype(np.float32)
    return dict(x=rn(Bn, S_, H, Pd), dt=dt,
                A=-np.linspace(1.0, 3.0, H).astype(np.float32),
                Bm=rn(Bn, S_, N), Cm=rn(Bn, S_, N),
                h0=rn(Bn, H, Pd, N) if with_h0 else None)


@pytest.fixture(scope="module")
def ssd_runs():
    """Per case: the inputs and the JAX package's (y, final state).  The
    JAX side always takes an initial state (zeros where the port's case
    has none: the reference's own start), so it compiles once a length."""
    fn = jax.jit(jssm.ssd_chunked, static_argnames=("chunk",))
    out = {}
    for i, (case, (S_, chunk, with_h0)) in enumerate(SSD_CASES.items()):
        x = _ssd_inputs(S_, with_h0, seed=i)
        h0 = np.zeros(SSD_DIMS, np.float32) if x["h0"] is None else x["h0"]
        y, h = fn(*(jnp.asarray(x[k]) for k in ("x", "dt", "A", "Bm", "Cm")),
                  chunk=chunk, h0=jnp.asarray(h0))
        out[case] = (x, chunk, np.asarray(y), np.asarray(h))
    return out


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_chunked_matches_jax(case, ssd_runs):
    x, chunk, y_want, h_want = ssd_runs[case]
    y, h = ssm.ssd_chunked(
        *(_t(x[k]) for k in ("x", "dt", "A", "Bm", "Cm")), chunk,
        None if x["h0"] is None else _t(x["h0"]))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == y_want.shape and h.shape == h_want.shape
    close(y, y_want, SSD_TOL, "y")
    close(h, h_want, SSD_TOL, "final state")


@pytest.mark.parametrize("case", ["ragged", "multiple-h0"])
def test_chained_decode_steps_equal_the_chunked_ssd(case, ssd_runs):
    """The exact recurrence, one token at a time from the same initial
    state, gives ssd_chunked's outputs and final state."""
    x, _, y_want, h_want = ssd_runs[case]
    Bn, H, Pd, N = SSD_DIMS
    h = (torch.zeros((Bn, H, Pd, N)) if x["h0"] is None
         else _t(x["h0"]))
    A = _t(x["A"])
    ys = []
    for t in range(x["x"].shape[1]):
        y, h = ssm.ssd_decode_step(_t(x["x"][:, t]), _t(x["dt"][:, t]), A,
                                   _t(x["Bm"][:, t]), _t(x["Cm"][:, t]), h)
        ys.append(y)
    close(torch.stack(ys, dim=1), y_want, SSD_TOL, "y")
    close(h, h_want, SSD_TOL, "final state")


def _nan_case():
    """H 8, P = N = 16, S 256, chunk 128, seed 0: A = -linspace(1, 16, H)
    (the reference's A_log), dt = softplus(N(0, 1) + dt_bias) with dt_bias
    drawn as the reference draws it."""
    H, Pd, N, S_ = 8, 16, 16, 256
    rng = np.random.default_rng(0)
    u = rng.uniform(np.log(1e-3), np.log(1e-1), H)
    dt_bias = np.log(np.expm1(np.exp(u)))
    dt = np.logaddexp(0.0, rng.standard_normal((1, S_, H)) + dt_bias)
    return dict(x=rng.standard_normal((1, S_, H, Pd)),
                dt=dt, A=-np.linspace(1.0, 16.0, H),
                Bm=rng.standard_normal((1, S_, N)),
                Cm=rng.standard_normal((1, S_, N)),
                ct=rng.standard_normal((1, S_, H, Pd)),
                ct_h=rng.standard_normal((1, H, Pd, N)))


def test_ssd_gradient_is_finite_where_the_reference_is_nan():
    c = _nan_case()
    chunk = 128
    f32 = {k: v.astype(np.float32) for k, v in c.items()}
    Q = chunk
    # the largest per-chunk decay sum passes exp's fp32 range on some head
    sums = (f32["dt"] * -f32["A"]).reshape(1, -1, Q, 8).sum(2)
    assert sums.max() > 88.8

    def jloss(dt, x):
        y, h = jssm.ssd_chunked(x, dt, jnp.asarray(f32["A"]),
                                jnp.asarray(f32["Bm"]),
                                jnp.asarray(f32["Cm"]), chunk)
        return jnp.sum(y * f32["ct"]) + jnp.sum(h * f32["ct_h"])

    jdt, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(f32["dt"]), jnp.asarray(f32["x"]))
    jdt, jdx = np.asarray(jdt), np.asarray(jdx)
    bad = ~np.isfinite(jdt).all(axis=(0, 1))           # per head
    assert bad.any(), "the reference's d/d(dt) was finite on every head"
    assert np.isfinite(jdx).all()

    def tgrad(dtype):
        dt = _t(c["dt"], dtype).requires_grad_()
        x = _t(c["x"], dtype).requires_grad_()
        y, h = ssm.ssd_chunked(x, dt, _t(c["A"], dtype), _t(c["Bm"], dtype),
                               _t(c["Cm"], dtype), chunk)
        loss = (y * _t(c["ct"], dtype)).sum() \
            + (h * _t(c["ct_h"], dtype)).sum()
        return torch.autograd.grad(loss, (dt, x))

    tdt, tdx = tgrad(torch.float32)
    assert torch.isfinite(tdt).all() and torch.isfinite(tdx).all()
    close(tdt[..., ~bad], jdt[..., ~bad], SSD_TOL, "d/d(dt), finite heads")
    close(tdx, jdx, SSD_TOL, "d/dx")
    ddt, ddx = tgrad(torch.float64)
    close(tdt, ddt.numpy(), SSD_TOL, "d/d(dt) against float64")
    close(tdx, ddx.numpy(), SSD_TOL, "d/dx against float64")


# ---------------------------------------------------------------------------
# The Mamba block and the smoke zamba
# ---------------------------------------------------------------------------


def _configs(**kw):
    kw = dict(dtype="float32", **kw)
    return (jax_get_config(ARCH, smoke=True).with_(**kw),
            get_config(ARCH, smoke=True).with_(**kw))


def _jax_params(jcfg, seed):
    """Parameters of the JAX package's schema and shapes, drawn with
    numpy: fan-in scaled weights, 0.02 N(0, 1) embeddings, nonzero norm
    scales and conv biases, and the reference's A_log, D and dt_bias
    (perturbed)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))

    def draw(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == "embed":
            a = 0.02 * rng.standard_normal(shape)
        elif name == "A_log":
            a = np.log(np.linspace(1.0, 16.0, shape[-1])) \
                + 0.1 * rng.standard_normal(shape)
        elif name == "D":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "dt_bias":
            a = np.log(np.expm1(np.exp(rng.uniform(np.log(1e-3),
                                                   np.log(1e-1), shape))))
        elif len(shape) >= 3 or name in ("lm_head", "w_in") or (
                len(shape) == 2 and path[-2].key == "shared"):
            a = shape[-2] ** -0.5 * rng.standard_normal(shape)
        else:                                   # norms, conv biases
            a = 0.1 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def block_runs():
    """The JAX Mamba block's output and the gradients of sum(y * ct) over
    x and every parameter; the causal conv alone."""
    jcfg, _ = _configs()
    params_np = jax.tree.map(lambda a: a[0],
                             _jax_params(jcfg, seed=1)["mamba_layers"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 40, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def block_and_grads(x, p, conv_args):
        y, vjp = jax.vjp(lambda x, p: jssm.mamba_block(x, p, jcfg), x, p)
        return y, *vjp(ct), jssm._causal_conv(*conv_args)

    conv_args = (rng.standard_normal((B, 11, 7)).astype(np.float32),
                 rng.standard_normal((4, 7)).astype(np.float32),
                 rng.standard_normal(7).astype(np.float32))
    with mesh_context(smoke_context()):
        y, gx, gp, conv = jax.jit(block_and_grads)(jnp.asarray(x),
                                                   params_np, conv_args)
        conv_in, conv_w, conv_b = conv_args
    return dict(cfg=jcfg, params_np=params_np, x=x, ct=ct, y=np.asarray(y),
                gx=np.asarray(gx), gp=jax.tree.map(np.asarray, gp),
                conv=(conv_in, conv_w, conv_b, np.asarray(conv)))


def test_causal_conv_and_mamba_block_match_jax(block_runs):
    conv_in, conv_w, conv_b, want = block_runs["conv"]
    close(ssm._causal_conv(_t(conv_in), _t(conv_w), _t(conv_b)), want,
           SSD_TOL, "causal conv")
    _, tcfg = _configs()
    p = params_from_jax(block_runs["params_np"], tcfg)
    for k in ("A_log", "D", "dt_bias"):
        assert p[k].dtype == torch.float32
    x = _t(block_runs["x"]).requires_grad_()
    for t in tree_leaves(p):
        t.requires_grad_(True)
    y = ssm.mamba_block(x, p, tcfg)
    close(y, block_runs["y"], TOL, "y")
    grads = torch.autograd.grad((y * _t(block_runs["ct"])).sum(),
                                [x] + tree_leaves(p))
    close(grads[0], block_runs["gx"], TOL, "d/dx")
    close_tree(unflatten(p, grads[1:]), block_runs["gp"])


@pytest.fixture(scope="module")
def zamba_runs():
    """From one set of numpy parameters: the JAX smoke zamba's loss and
    gradients (one compiled program), and its prefill of P tokens and GEN
    decode steps (one program each), every cache kept."""
    jcfg, tcfg = _configs()
    params_np = _jax_params(jcfg, seed=3)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    with mesh_context(smoke_context()):
        jb = jax_build_model(jcfg)
        jp = jax.tree.map(jnp.asarray, params_np)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jb.loss(p, {"tokens": jnp.asarray(tokens)},
                              remat="none"), has_aux=True))(jp)
        logits, cache = jax.jit(jb.prefill, static_argnums=2)(
            jp, {"tokens": jnp.asarray(tokens[:, :P])}, MAX_LEN)
        steps = [(logits, cache)]
        decode = jax.jit(jb.decode_step)
        for i in range(GEN):
            logits, cache = decode(jp, cache, jnp.asarray(tokens[:, P + i]))
            steps.append((logits, cache))
    return dict(tcfg=tcfg, params_np=params_np, tokens=tokens,
                loss=float(loss), grads=jax.tree.map(np.asarray, grads),
                steps=[(np.asarray(lg), jax.tree.map(np.asarray, c))
                       for lg, c in steps])


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_zamba_loss_and_grads_match_jax(remat, zamba_runs):
    """Every gradient at 2e-5 of its largest entry, the shared block's
    the sum over its two applications (the reference's)."""
    tcfg = zamba_runs["tcfg"]
    params = params_from_jax(zamba_runs["params_np"], tcfg)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, metrics = build_model(tcfg).loss(
        params, {"tokens": _t(zamba_runs["tokens"], torch.int64)},
        remat=remat)
    assert float(loss.detach()) == pytest.approx(zamba_runs["loss"], rel=TOL)
    assert float(metrics["aux_loss"]) == 0.0
    grads = torch.autograd.grad(loss, tree_leaves(params))
    close_tree(unflatten(params, grads), zamba_runs["grads"])


def _cache_from_jax(jc):
    """The JAX package's zamba cache as the port's (conv stays bf16)."""
    from repro_torch.models.zamba import ZambaCache

    return ZambaCache(
        mamba=ssm.MambaState(
            h=_t(jc.mamba.h),
            conv=_t(np.asarray(jc.mamba.conv, np.float32)).bfloat16()),
        shared_k=_t(jc.shared_k), shared_v=_t(jc.shared_v),
        shared_pos=_t(jc.shared_pos), length=int(jc.length))


def _check_cache(c, jc, where, tol=TOL):
    assert c.length == int(jc.length), where
    assert c.mamba.h.dtype == torch.float32, where
    assert c.mamba.conv.dtype == torch.bfloat16, where
    close(c.mamba.h, jc.mamba.h, tol, f"{where} h")
    close_bf16(c.mamba.conv, jc.mamba.conv, msg=f"{where} conv")
    close(c.shared_k, jc.shared_k, tol, f"{where} shared_k")
    close(c.shared_v, jc.shared_v, tol, f"{where} shared_v")
    np.testing.assert_array_equal(c.shared_pos.numpy(), jc.shared_pos,
                                  err_msg=where)


def test_zamba_prefill_and_decode_match_jax(zamba_runs):
    """Prefill of P tokens: logits and every cache tensor at 2e-5 of the
    largest entry, the bf16 conv window within one bf16 step of that.
    Then each of GEN decode steps from the JAX package's cache of the
    step before (each step held alone), and the port's own chain of
    steps, at ``DECODE_TOL``: a decode step rounds the new token's conv
    input to bf16 before its conv reads it (both packages), and where the
    two packages' fp32 conv inputs (equal to ~1e-6) straddle a rounding
    boundary they land one bf16 step apart, which moved logits and
    states by up to 8.6e-5 of their largest here (every other entry
    within ~1e-6)."""
    tcfg = zamba_runs["tcfg"]
    params = params_from_jax(zamba_runs["params_np"], tcfg)
    bundle = build_model(tcfg)
    toks = _t(zamba_runs["tokens"], torch.int64)
    steps = zamba_runs["steps"]
    with torch.no_grad():
        logits, cache = bundle.prefill(params, {"tokens": toks[:, :P]},
                                       MAX_LEN)
        close(logits, steps[0][0], TOL, "prefill logits")
        _check_cache(cache, steps[0][1], "prefill")
        assert cache.length == P
        for i in range(GEN):
            lg, c = bundle.decode_step(params, _cache_from_jax(steps[i][1]),
                                       toks[:, P + i])
            close(lg, steps[i + 1][0], DECODE_TOL, f"decode {i} logits")
            _check_cache(c, steps[i + 1][1], f"decode {i}", DECODE_TOL)
            logits, cache = bundle.decode_step(params, cache, toks[:, P + i])
            close(logits, steps[i + 1][0], DECODE_TOL,
                   f"chained decode {i} logits")
            _check_cache(cache, steps[i + 1][1], f"chained decode {i}",
                         DECODE_TOL)


# ---------------------------------------------------------------------------
# The optimizer on the zamba tree
# ---------------------------------------------------------------------------


OPT_KW = dict(rank=32, update_interval=2, eta=5.0)


@pytest.fixture(scope="module")
def opt_runs():
    jcfg, _ = _configs()
    return jax_optimizer_steps(_jax_params(jcfg, seed=6), OPT_KW, seed=5)


@pytest.mark.parametrize("tracking", [False, True])
def test_optimizer_step_on_the_zamba_tree_matches_jax(tracking, opt_runs):
    """One plain (1e-5) and one tracking (1e-3) step from one JAX state:
    in_proj / out_proj stacks and the shared matrices low-rank (out_proj,
    w_in, w_down and embed as transposed plans), conv_w (L, K, C) and the
    fp32 (L, H) leaves dense."""
    layers = opt_state_from_jax(opt_runs["state_np"]).inner["mamba_layers"]
    assert layers["in_proj"].S.shape == (6, 128, 32)
    assert layers["out_proj"].S.shape == (6, 128, 32)
    for k in ("conv_w", "A_log", "D", "dt_bias"):
        assert "S" not in layers[k]._fields, k
    check_optimizer_step(opt_runs, _configs()[1], tracking)


# ---------------------------------------------------------------------------
# Config, plans and the CLIs
# ---------------------------------------------------------------------------


def test_zamba_config_and_plans_match_the_reference():
    """The config, its paging and tap answers, default rank and init
    schema equal the reference's; at the full width and 18 layers the
    plans are the reference's: 12 low-rank leaves at rank 512, every
    one with m = 3584, the fp32 (L, H) leaves and conv_w dense."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    assert tcfg.ssm.__dict__ == jcfg.ssm.__dict__
    assert ({k: v for k, v in tcfg.__dict__.items() if k != "ssm"}
            == {k: v for k, v in jcfg.__dict__.items() if k != "ssm"})
    assert ttf.paged_supported(tcfg) == jtf.paged_supported(jcfg) == (
        False, "family 'zamba' has no paged cache layout")
    assert _tap_paths(tcfg) == jax_tap_paths(jcfg)
    assert ARCH not in PAPER_RANKS
    assert default_rank(tcfg.d_model) == jax_default_rank(jcfg.d_model) \
        == 512
    assert build_model(tcfg).loss_taps is None
    jsmoke = jax_get_config(ARCH, smoke=True)
    tsmoke = get_config(ARCH, smoke=True)
    params = build_model(tsmoke).init(torch.Generator().manual_seed(0))
    with mesh_context(smoke_context()):
        jshapes = jax.eval_shape(jax_build_model(jsmoke).init,
                                 jax.random.PRNGKey(0))
        jfull = jax.eval_shape(jax_build_model(jcfg.with_(n_layers=18)).init,
                               jax.random.PRNGKey(0))
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jshapes)
            == jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[1]),
                            params, is_leaf=torch.is_tensor))
    jplans = jax.tree.map(lambda p: (p.mode, p.transpose, p.m, p.n, p.rank),
                          jax_make_plans(jfull, 512),
                          is_leaf=lambda p: hasattr(p, "mode"))
    tplans = jax.tree.map(lambda p: (p.mode, p.transpose, p.m, p.n, p.rank),
                          make_plans(jfull, 512),
                          is_leaf=lambda p: hasattr(p, "mode"))
    assert tplans == jplans
    low = [v for v in jax.tree.leaves(
        tplans, is_leaf=lambda v: isinstance(v, tuple)) if v[0] == "lowrank"]
    assert len(low) == 12 and {v[2] for v in low} == {3584}


def test_zamba_clis_run_at_smoke_size(capsys):
    """``train --arch zamba2-7b --smoke --use-kernels --grad-fused``: the
    JAX package's fallback line, finite losses, the tracking step at 2 and
    no kernel launch on the CPU; ``serve``: the paged engine's refusal and
    every request through the dense engine."""
    out = ttrain.train(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "4", "--rank", "32", "--update-interval",
                        "2", "--use-kernels", "--batch", "2", "--seq", "32",
                        "--grad-fused"])
    said = capsys.readouterr().out
    assert ("--grad-fused requested but this model family exposes no "
            "taggable matmuls — falling back to the plain backward") in said
    assert "grad-fused backward: taggable leaves" not in said
    assert all(np.isfinite(out["losses"]))
    assert [h["step"] for h in out["history"] if h["subspace_update"]] == [2]
    assert not any(h["quarantined"] for h in out["history"])
    assert not any(out["launch_counts"].values())
    assert ops.launch_counts() == out["launch_counts"]
    served = tserve.serve(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "3", "--batch", "2",
                           "--prompt-len", "8", "--gen", "3"])
    said = capsys.readouterr().out
    assert ("paged engine unavailable for zamba2-7b: family 'zamba' has "
            "no paged cache layout — falling back to dense") in said
    assert served["engine"] == "dense" and served["tokens"] == 9
    assert all(len(v) == 3 for v in served["outputs"].values())
