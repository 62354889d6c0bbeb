"""The mLSTM, the sLSTM and the xlstm-125m model against the JAX package,
on the CPU.

Every comparison feeds the same numpy inputs to both packages (the
models' parameters through ``params_from_jax``) and is fp32, save those
of bf16, the dtype the model is served in.  The JAX
side runs inside ``mesh_context(smoke_context())``, and each JAX function
is compiled once (``jax.jit``) in a module-scoped fixture:

* ``mlstm_chunked`` with S a multiple of the chunk and not, with and
  without an initial state, at 1e-5 of the largest entry; the port's
  chained ``mlstm_decode`` against the same outputs and final state;
* ``_slstm_cell`` and ``slstm_block`` (output, final state and every
  gradient) on the reference's bias, whose [i | f | z | o] blocks of
  width d meet a per-head split (head 1 takes 3 on all four gates);
* ``_causal_conv``, and ``mlstm_block``'s output, final state and every
  gradient;
* the reference's NaN gradient: an input gate that jumps inside a chunk
  pushes the reference's unmasked intra-chunk exponent past fp32's 88.7,
  and its backward gives 0 * inf = NaN in the gate gradients; the port
  masks the exponent first, so its gradient is finite, equal to the
  reference's wherever that is finite, and equal to the port's own
  float64 evaluation;
* the fp32 smoke xlstm (4 layers: 3 mLSTM, 1 sLSTM): the loss and every
  gradient under each remat policy at 2e-5 of the largest entry; prefill
  (logits and every cache entry) at 2e-5 and 3 decode steps at
  ``DECODE_TOL``, the bf16 conv window's rounding;
* bf16: one decode step of each block from the same inputs (the new
  states at 2e-5, which a decode forming q and k in bf16 fails), the
  smoke model's prefill and 16 decode steps from the JAX package's
  caches (two planted faults read past the budget), and the witness
  that the reference's own bf16 decode departs from its forward (q and
  k fp32 on one path, bf16 on the other) by as much as the port's;
* one plain (1e-5) and one tracking (1e-3) SubTrack++ step from one JAX
  state on the smoke tree, the sLSTM's 4-D ``R`` leaf low-rank;
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
from repro.launch.steps import default_rank as jax_default_rank
from repro.models import transformer as jtf
from repro.models import xlstm as jx
from repro.models.api import build_model as jax_build_model
from repro_torch.configs.registry import get_config
from repro_torch.core.plan import make_plans
from repro_torch.core.subtrack import tree_leaves
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import default_rank
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm
from repro_torch.models.api import build_model
from torch_compare import (TOL, check_optimizer_step, close, close_bf16,
                           close_tree, jax_optimizer_steps, t as _t,
                           unflatten)
from torch_threads import one_thread  # noqa: F401


CELL_TOL = 1e-5
# a decode step whose new conv entries round apart in bf16 (see its test):
# half a bf16 step of the largest entry
DECODE_TOL = 2e-3
ARCH = "xlstm-125m"
# case -> (S, chunk, with an initial state); B 2, H 2, hd 8
MLSTM_CASES = {"multiple": (32, 8, False), "ragged": (27, 8, False),
               "multiple-state": (32, 8, True), "ragged-state": (27, 8, True)}
MLSTM_DIMS = (2, 2, 8)
B, S = 2, 48                    # the smoke model's loss batch
P, GEN = 21, 3                  # prefill (not a chunk multiple), decode steps


# ---------------------------------------------------------------------------
# The mLSTM cell
# ---------------------------------------------------------------------------


def _mlstm_inputs(S_, with_state, seed):
    """q, k, v, log_i N(0, 1), log_f = log_sigmoid(N(0, 1) + 1), and an
    initial (C, n, m) or None."""
    Bn, H, hd = MLSTM_DIMS
    rng = np.random.default_rng(seed)

    def rn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    log_f = -np.logaddexp(0.0, -(rn(Bn, S_, H) + 1.0)).astype(np.float32)
    state = ((rn(Bn, H, hd, hd), rn(Bn, H, hd), rn(Bn, H))
             if with_state else None)
    return dict(q=rn(Bn, S_, H, hd), k=rn(Bn, S_, H, hd),
                v=rn(Bn, S_, H, hd), log_i=rn(Bn, S_, H), log_f=log_f,
                state=state)


@pytest.fixture(scope="module")
def mlstm_runs():
    """Per case: the inputs and the JAX package's (h, final state).  The
    JAX side always takes a state (its own empty one where the case has
    none), so it compiles once a length."""
    fn = jax.jit(jx.mlstm_chunked, static_argnames=("chunk",))
    out = {}
    for i, (case, (S_, chunk, with_state)) in enumerate(MLSTM_CASES.items()):
        x = _mlstm_inputs(S_, with_state, seed=i)
        st = (jx.MLSTMState(*map(jnp.asarray, x["state"])) if with_state
              else jx.init_mlstm_state(*MLSTM_DIMS))
        h, fin = fn(*(jnp.asarray(x[k]) for k in ("q", "k", "v", "log_i",
                                                  "log_f")),
                    chunk=chunk, state=st)
        out[case] = (x, chunk, np.asarray(h), [np.asarray(a) for a in fin])
    return out


def _state(x):
    return (None if x["state"] is None
            else xlstm.MLSTMState(*map(_t, x["state"])))


@pytest.mark.parametrize("case", list(MLSTM_CASES))
def test_mlstm_chunked_matches_jax(case, mlstm_runs):
    x, chunk, h_want, st_want = mlstm_runs[case]
    h, st = xlstm.mlstm_chunked(
        *(_t(x[k]) for k in ("q", "k", "v", "log_i", "log_f")), chunk,
        _state(x))
    assert h.dtype == torch.float32 and h.shape == h_want.shape
    close(h, h_want, CELL_TOL, "h")
    for name, got, want in zip("Cnm", st, st_want):
        close(got, want, CELL_TOL, f"final {name}")


@pytest.mark.parametrize("case", ["ragged", "multiple-state"])
def test_chained_decode_steps_equal_the_chunked_mlstm(case, mlstm_runs):
    """The step recurrence, one token at a time from the same initial
    state, gives mlstm_chunked's outputs and final state (the two carry
    the same stabiliser m: b_tot + max(m, max g) unrolls to the step's
    max(log_f + m, log_i))."""
    x, _, h_want, st_want = mlstm_runs[case]
    Bn, H, hd = MLSTM_DIMS
    st = _state(x) or xlstm.init_mlstm_state(Bn, H, hd)
    hs = []
    for t in range(x["q"].shape[1]):
        h, st = xlstm.mlstm_decode(
            *(_t(x[k][:, t]) for k in ("q", "k", "v", "log_i", "log_f")), st)
        hs.append(h)
    close(torch.stack(hs, dim=1), h_want, CELL_TOL, "h")
    for name, got, want in zip("Cnm", st, st_want):
        close(got, want, CELL_TOL, f"final {name}")


def _spike_case():
    """B 1, S = Q = 64, H 2, hd 8, seed 0: q, k, v and log_i N(0, 1),
    log_f = log_sigmoid(3 + N(0, 1)), and a spike of 95 added to
    log_i[0, 40, 0]; the cotangents of h and of the final C."""
    rng = np.random.default_rng(0)
    Bn, S_, H, hd = 1, 64, 2, 8
    c = dict(q=rng.standard_normal((Bn, S_, H, hd)),
             k=rng.standard_normal((Bn, S_, H, hd)),
             v=rng.standard_normal((Bn, S_, H, hd)),
             log_i=rng.standard_normal((Bn, S_, H)),
             log_f=-np.logaddexp(0.0, -(3.0 + rng.standard_normal(
                 (Bn, S_, H)))),
             ct=rng.standard_normal((Bn, S_, H, hd)),
             ct_C=rng.standard_normal((Bn, H, hd, hd)))
    c["log_i"][0, 40, 0] += 95.0
    return c


def test_mlstm_gradient_is_finite_where_the_reference_is_nan():
    c = _spike_case()
    chunk = 64
    f32 = {k: v.astype(np.float32) for k, v in c.items()}

    def jloss(li, lf, q):
        h, st = jx.mlstm_chunked(q, jnp.asarray(f32["k"]),
                                 jnp.asarray(f32["v"]), li, lf, chunk)
        return jnp.sum(h * f32["ct"]) + jnp.sum(st.C * f32["ct_C"])

    jl, (jli, jlf, jq) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2)))(*(jnp.asarray(f32[k])
                                     for k in ("log_i", "log_f", "q")))
    jli, jlf, jq = np.asarray(jli), np.asarray(jlf), np.asarray(jq)
    assert np.isfinite(float(jl)), "the reference's forward stays finite"
    assert not (np.isfinite(jli).all() and np.isfinite(jlf).all()), \
        "the reference's gate gradients were finite"

    def tgrad(dtype):
        li = _t(c["log_i"], dtype).requires_grad_()
        lf = _t(c["log_f"], dtype).requires_grad_()
        q = _t(c["q"], dtype).requires_grad_()
        h, st = xlstm.mlstm_chunked(q, _t(c["k"], dtype), _t(c["v"], dtype),
                                    li, lf, chunk)
        loss = (h * _t(c["ct"], dtype)).sum() \
            + (st.C * _t(c["ct_C"], dtype)).sum()
        return (loss.detach(),) + torch.autograd.grad(loss, (li, lf, q))

    tl, tli, tlf, tq = tgrad(torch.float32)
    assert float(tl) == pytest.approx(float(jl), rel=CELL_TOL)
    for name, got, want in (("d/d(log_i)", tli, jli),
                            ("d/d(log_f)", tlf, jlf), ("d/dq", tq, jq)):
        assert torch.isfinite(got).all(), name
        ok = np.isfinite(want)
        close(got.numpy()[ok], want[ok], CELL_TOL, f"{name}, finite entries")
    _, dli, dlf, dq = tgrad(torch.float64)
    for name, got, want in (("d/d(log_i)", tli, dli),
                            ("d/d(log_f)", tlf, dlf), ("d/dq", tq, dq)):
        close(got, want.numpy(), CELL_TOL, f"{name} against float64")


# ---------------------------------------------------------------------------
# The blocks and the smoke model
# ---------------------------------------------------------------------------


def _configs(**kw):
    kw = dict(dtype="float32", **kw)
    return (jax_get_config(ARCH, smoke=True).with_(**kw),
            get_config(ARCH, smoke=True).with_(**kw))


def _jax_params(jcfg, seed):
    """Parameters of the JAX package's schema and shapes, drawn with
    numpy: fan-in scaled weights, 0.02 N(0, 1) embeddings, nonzero norm
    scales, conv and gate biases around the reference's, and the sLSTM's
    bias ``b`` exactly as the reference lays it out ([i | f | z | o], the
    forget block 3)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))
    d = jcfg.d_model

    def draw(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == "embed":
            a = 0.02 * rng.standard_normal(shape)
        elif name == "b":
            a = np.broadcast_to(np.concatenate(
                [np.zeros(d), np.full(d, 3.0), np.zeros(2 * d)]), shape)
        elif name == "b_f":
            a = 3.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 3 or name == "lm_head":
            a = shape[-2] ** -0.5 * rng.standard_normal(shape)
        else:                                   # norms, conv and gate biases
            a = 0.1 * rng.standard_normal(shape)
        return np.array(a, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def block_runs():
    """The JAX mLSTM and sLSTM blocks' outputs, final states and the
    gradients of sum(y * ct) + sum(state * ct_state) over x and every
    parameter, one compiled program; the causal conv and one sLSTM cell
    step alone."""
    jcfg, _ = _configs()
    params_np = _jax_params(jcfg, seed=1)
    pm = jax.tree.map(lambda a: a[0], params_np["mlstm_layers"])
    ps = jax.tree.map(lambda a: a[0], params_np["slstm_layers"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 19, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    H, hd = jcfg.n_heads, jcfg.d_model // jcfg.n_heads
    di, mhd = jx._mlstm_dims(jcfg)
    ct_m = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, mhd, mhd), (B, H, mhd), (B, H))]
    ct_s = [rng.standard_normal((B, H, hd)).astype(np.float32)
            for _ in range(4)]
    cell_args = (rng.standard_normal((B, 4 * jcfg.d_model)).astype(
        np.float32), [rng.standard_normal((B, H, hd)).astype(np.float32)
                      for _ in range(4)])
    conv_args = (rng.standard_normal((B, 11, 7)).astype(np.float32),
                 rng.standard_normal((4, 7)).astype(np.float32),
                 rng.standard_normal(7).astype(np.float32))

    def blocks_and_grads(x, pm, ps):
        def m_loss(x, p):
            y, st = jx.mlstm_block(x, p, jcfg)
            return jnp.sum(y * ct) + sum(jnp.sum(a * c)
                                         for a, c in zip(st, ct_m)), (y, st)

        def s_loss(x, p):
            y, st = jx.slstm_block(x, p, jcfg)
            return jnp.sum(y * ct) + sum(jnp.sum(a * c)
                                         for a, c in zip(st, ct_s)), (y, st)

        out = []
        for f, p in ((m_loss, pm), (s_loss, ps)):
            (_, (y, st)), g = jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True)(x, p)
            out.append((y, st, g))
        cell = jx._slstm_cell(cell_args[0], jx.SLSTMState(*cell_args[1]),
                              ps["R"])
        return out, cell, jx._causal_conv(*conv_args)

    with mesh_context(smoke_context()):
        (m_out, s_out), cell, conv = jax.jit(blocks_and_grads)(
            jnp.asarray(x), pm, ps)
    return dict(cfg=jcfg, pm=pm, ps=ps, x=x, ct=ct, ct_m=ct_m, ct_s=ct_s,
                m=jax.tree.map(np.asarray, m_out),
                s=jax.tree.map(np.asarray, s_out),
                cell=(cell_args, [np.asarray(a) for a in cell]),
                conv=(*conv_args, np.asarray(conv)))


def test_slstm_cell_follows_the_reference_bias_layout(block_runs):
    """The cell splits each head's row of the pre-activation into i, f,
    z, o; with the reference's bias, head 1 takes 3 on all four gates and
    heads 0, 2, 3 none on their forget gates."""
    jcfg = block_runs["cfg"]
    H, d = jcfg.n_heads, jcfg.d_model
    b = block_runs["ps"]["b"].reshape(H, 4, d // H)
    assert (b[1] == 3.0).all()
    assert (b[[0, 2, 3], 1] == 0.0).all()
    (xw, st), want = block_runs["cell"]
    got = xlstm._slstm_cell(_t(xw), xlstm.SLSTMState(*map(_t, st)),
                            _t(block_runs["ps"]["R"]))
    for name, g, w in zip("hcnm", got, want):
        close(g, w, CELL_TOL, f"cell {name}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_match_jax(kind, block_runs):
    """Each block's output, final state and every gradient (over x and
    each parameter) at 2e-5 of the largest entry; the causal conv at
    1e-5."""
    conv_in, conv_w, conv_b, want = block_runs["conv"]
    close(xlstm._causal_conv(_t(conv_in), _t(conv_w), _t(conv_b)), want,
           CELL_TOL, "causal conv")
    _, tcfg = _configs()
    short = kind[0]
    p = params_from_jax(block_runs["p" + short], tcfg)
    for k in (("w_i", "b_i", "w_f", "b_f") if kind == "mlstm" else ("b",)):
        assert p[k].dtype == torch.float32
    x = _t(block_runs["x"]).requires_grad_()
    for t in tree_leaves(p):
        t.requires_grad_(True)
    block = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
    y, st = block(x, p, tcfg)
    y_want, st_want, (gx_want, gp_want) = block_runs[short]
    close(y, y_want, TOL, "y")
    for i, (g, w) in enumerate(zip(st, st_want)):
        close(g, w, TOL, f"final state {st._fields[i]}")
    loss = (y * _t(block_runs["ct"])).sum() + sum(
        (a * _t(c)).sum() for a, c in zip(st, block_runs["ct_" + short]))
    grads = torch.autograd.grad(loss, [x] + tree_leaves(p))
    close(grads[0], gx_want, TOL, "d/dx")
    close_tree(unflatten(p, grads[1:]), gp_want)


@pytest.fixture(scope="module")
def model_runs():
    """From one set of numpy parameters: the JAX smoke xlstm's loss and
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
            jp, {"tokens": jnp.asarray(tokens[:, :P])}, 0)
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
def test_xlstm_loss_and_grads_match_jax(remat, model_runs):
    tcfg = model_runs["tcfg"]
    params = params_from_jax(model_runs["params_np"], tcfg)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, metrics = build_model(tcfg).loss(
        params, {"tokens": _t(model_runs["tokens"], torch.int64)},
        remat=remat)
    assert float(loss.detach()) == pytest.approx(model_runs["loss"], rel=TOL)
    assert float(metrics["aux_loss"]) == 0.0
    grads = torch.autograd.grad(loss, tree_leaves(params))
    close_tree(unflatten(params, grads), model_runs["grads"])


def _cache_from_jax(jc):
    """The JAX package's xlstm cache as the port's (conv stays bf16)."""
    return xlstm.XLSTMCache(
        mlstm=xlstm.MLSTMState(*map(_t, jc.mlstm)),
        mlstm_conv=_t(np.asarray(jc.mlstm_conv, np.float32)).bfloat16(),
        slstm=xlstm.SLSTMState(*map(_t, jc.slstm)), length=int(jc.length))


def _check_cache(c, jc, where, tol=TOL):
    assert c.length == int(jc.length), where
    assert c.mlstm_conv.dtype == torch.bfloat16, where
    for kind in ("mlstm", "slstm"):
        for name, g, w in zip(getattr(c, kind)._fields, getattr(c, kind),
                              getattr(jc, kind)):
            assert g.dtype == torch.float32, where
            close(g, w, tol, f"{where} {kind} {name}")
    close_bf16(c.mlstm_conv, jc.mlstm_conv, tol, f"{where} conv")


def _flips(c, jc) -> int:
    """The new conv window entries (the last slot of every layer) that
    the two packages rounded to different bf16 values."""
    want = torch.tensor(np.asarray(jc.mlstm_conv, np.float32)[:, :, -1])
    return int((c.mlstm_conv[:, :, -1].float() != want).sum())


def test_xlstm_prefill_and_decode_match_jax(model_runs):
    """Prefill of P tokens: logits and every cache tensor at 2e-5 of the
    largest entry, the bf16 conv window within one bf16 step of that.
    Then each of GEN decode steps from the JAX package's cache of the
    step before (each step held alone), and the port's own chain of
    steps: at 2e-5 where every new conv entry rounded to the same bf16
    value in both packages, else at ``DECODE_TOL``.  A decode step rounds
    the new token's conv input to bf16 before its conv reads it (both
    packages); where the two packages' fp32 conv inputs straddle a
    rounding boundary they land one bf16 step apart, and the layers
    after it see inputs that differ by that much, so more entries round
    apart downstream: here the third step had 42 such entries and moved
    the logits and states by up to 5.4e-4 of their largest (the first
    two, with 0 and 2, by under 2e-6)."""
    tcfg = model_runs["tcfg"]
    params = params_from_jax(model_runs["params_np"], tcfg)
    bundle = build_model(tcfg)
    toks = _t(model_runs["tokens"], torch.int64)
    steps = model_runs["steps"]
    chain_flips = 0
    with torch.no_grad():
        logits, cache = bundle.prefill(params, {"tokens": toks[:, :P]}, 0)
        close(logits, steps[0][0], TOL, "prefill logits")
        _check_cache(cache, steps[0][1], "prefill")
        for i in range(GEN):
            want_lg, want_c = steps[i + 1]
            lg, c = bundle.decode_step(params, _cache_from_jax(steps[i][1]),
                                       toks[:, P + i])
            tol = DECODE_TOL if _flips(c, want_c) else TOL
            close(lg, want_lg, tol, f"decode {i} logits")
            _check_cache(c, want_c, f"decode {i}", tol)
            logits, cache = bundle.decode_step(params, cache, toks[:, P + i])
            chain_flips += _flips(cache, want_c)
            tol = DECODE_TOL if chain_flips else TOL
            close(logits, want_lg, tol, f"chained decode {i} logits")
            _check_cache(cache, want_c, f"chained decode {i}", tol)


# ---------------------------------------------------------------------------
# bf16, the dtype the model is served in
# ---------------------------------------------------------------------------


# bf16 models against each other, of the largest entry: the two packages
# round their bf16 intermediates in different places (XLA keeps a fused
# chain of elementwise ops in fp32, torch rounds after each op), so their
# prefills of P tokens come up to 4.6e-2 apart and a decode step from the
# same cache up to 1.6e-2 (the test below prints both); a decode step from
# a cache whose conv window the step before did not advance, or whose
# mLSTM stabiliser m is off by one, reads 0.24-1.4 from the reference's step
BF16_PREFILL_TOL = 0.1
BF16_DECODE_TOL = 3e-2
BF16_GEN = 16                   # decode steps, as a served request takes


def _bf16_params(jcfg, seed):
    """``_jax_params`` rounded to the bf16 config's schema (numpy arrays
    of JAX's bfloat16 where the leaf is bf16; the gates stay fp32)."""
    shapes = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda a, sds: np.asarray(jnp.asarray(a, sds.dtype)),
                        _jax_params(jcfg, seed), shapes)


def _bf16_values(rng, shape):
    """N(0, 1) rounded to bf16, held in fp32."""
    return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16),
                      np.float32)


@pytest.fixture(scope="module")
def bf16_block_runs():
    """One bf16 decode step of the JAX mLSTM and sLSTM blocks from the
    same inputs (x and the conv window bf16 values, fp32 states), one
    compiled program."""
    jcfg = jax_get_config(ARCH, smoke=True)
    assert jcfg.dtype == "bfloat16"
    params_np = _bf16_params(jcfg, seed=3)
    pm = jax.tree.map(lambda a: a[0], params_np["mlstm_layers"])
    ps = jax.tree.map(lambda a: a[0], params_np["slstm_layers"])
    rng = np.random.default_rng(7)
    d, H = jcfg.d_model, jcfg.n_heads
    di, mhd = jx._mlstm_dims(jcfg)
    x = _bf16_values(rng, (B, 1, d))
    conv = _bf16_values(rng, (B, jcfg.xlstm.conv_kernel - 1, di))
    m_st = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, mhd, mhd), (B, H, mhd), (B, H))]
    s_st = [rng.standard_normal((B, H, d // H)).astype(np.float32)
            for _ in range(4)]

    def steps(x, pm, ps, conv):
        y_m, (st_m, conv_new) = jx.mlstm_block(
            x, pm, jcfg, state=(jx.MLSTMState(*m_st), conv), decode=True)
        y_s, st_s = jx.slstm_block(x, ps, jcfg, state=jx.SLSTMState(*s_st),
                                   decode=True)
        return (y_m, (*st_m, conv_new)), (y_s, st_s)

    with mesh_context(smoke_context()):
        out = jax.jit(steps)(jnp.asarray(x, jnp.bfloat16), pm, ps,
                             jnp.asarray(conv, jnp.bfloat16))
    return dict(pm=pm, ps=ps, x=x, conv=conv, m_st=m_st, s_st=s_st,
                out=jax.tree.map(lambda a: np.asarray(a, np.float32), out))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_bf16_decode_blocks_match_jax(kind, bf16_block_runs):
    """One bf16 decode step of each block from the same inputs: the new
    fp32 states at 2e-5 of the largest entry (they came within 6.1e-7;
    a decode that forms the mLSTM's q and k in bf16, where the reference
    promotes them to fp32, moves C and n by 2.5e-3 and 9.1e-4), the conv
    window exactly, and the bf16 output within two bf16 steps of its
    largest entry (5.2e-3 and 2.1e-3: the packages round the norm and
    gate products in different places)."""
    r = bf16_block_runs
    tcfg = get_config(ARCH, smoke=True)
    x = _t(r["x"]).bfloat16()
    with torch.no_grad():
        if kind == "mlstm":
            (y_want, st_want) = r["out"][0]
            y, (st, conv) = xlstm.mlstm_block(
                x, params_from_jax(r["pm"], tcfg), tcfg,
                state=(xlstm.MLSTMState(*map(_t, r["m_st"])),
                       _t(r["conv"]).bfloat16()), decode=True)
            assert conv.dtype == torch.bfloat16
            assert torch.equal(conv.float(), _t(st_want[-1])), "conv window"
            st_want = st_want[:-1]
        else:
            (y_want, st_want) = r["out"][1]
            y, st = xlstm.slstm_block(
                x, params_from_jax(r["ps"], tcfg), tcfg,
                state=xlstm.SLSTMState(*map(_t, r["s_st"])), decode=True)
    assert y.dtype == torch.bfloat16
    close(y, y_want, 2.0**-7, "y")
    for name, g, w in zip(st._fields, st, st_want):
        assert g.dtype == torch.float32, name
        close(g, w, TOL, f"state {name}")


def _state_gap(a, b) -> dict:
    """Two xlstm caches' states, of the largest entry: each stabilised
    pair (mLSTM C and n, sLSTM c and n) at the larger of the two
    stabilisers, the sLSTM's h and the conv windows as they are."""
    out = {}
    for kind, pairs in (("mlstm", "Cn"), ("slstm", "cn")):
        sa, sb = getattr(a, kind), getattr(b, kind)
        m = torch.maximum(sa.m, sb.m)
        for f in pairs:
            x, y = (getattr(s_, f) * torch.exp(s_.m - m).reshape(
                m.shape + (1,) * (getattr(s_, f).dim() - m.dim()))
                for s_ in (sa, sb))
            out[f"{kind} {f}"] = float((x - y).abs().max() / y.abs().max())
    for name, x, y in (("slstm h", a.slstm.h, b.slstm.h),
                       ("conv", a.mlstm_conv.float(), b.mlstm_conv.float())):
        out[name] = float((x - y).abs().max() / y.abs().max())
    return out


def _faulty_caches(cache, before):
    """Planted faults: ``cache`` with the conv window of the cache before
    it (a step that did not advance the window), and with every mLSTM
    stabiliser m one too large (C and n not rescaled)."""
    stale = _cache_from_jax(cache)
    stale.mlstm_conv = _cache_from_jax(before).mlstm_conv
    off = _cache_from_jax(cache)
    off.mlstm.m.add_(1.0)
    return {"conv window not advanced": stale, "stabiliser off by one": off}


@pytest.fixture(scope="module")
def bf16_runs():
    """The bf16 smoke xlstm from one set of numpy parameters: the JAX
    package's prefill of P tokens and BF16_GEN decode steps (every cache
    kept), its forward over all P + BF16_GEN tokens and its prefill of
    them."""
    jcfg = jax_get_config(ARCH, smoke=True)
    params_np = _bf16_params(jcfg, seed=3)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size,
                          (B, P + BF16_GEN)).astype(np.int32)
    with mesh_context(smoke_context()):
        jb = jax_build_model(jcfg)
        jp = jax.tree.map(jnp.asarray, params_np)
        prefill = jax.jit(jb.prefill, static_argnums=2)
        steps = [prefill(jp, {"tokens": jnp.asarray(tokens[:, :P])}, 0)]
        decode = jax.jit(jb.decode_step)
        for i in range(BF16_GEN):
            steps.append(decode(jp, steps[-1][1],
                                jnp.asarray(tokens[:, P + i])))
        forward = jax.jit(lambda p, tk: jx.xlstm_forward(
            p, tk, jcfg, remat="none")[0])(jp, jnp.asarray(tokens))
        _, whole = prefill(jp, {"tokens": jnp.asarray(tokens)}, 0)

    def f32(tree):
        return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)

    return dict(tcfg=get_config(ARCH, smoke=True), params_np=params_np,
                tokens=tokens, steps=[f32(st) for st in steps],
                forward=f32(forward), whole=f32(whole))


def _rels(lg, c, want_lg, want_c) -> list[float]:
    """Logits and every cache tensor, of the largest entry."""
    out = [float(np.abs(lg.float().numpy() - want_lg).max()
                 / np.abs(want_lg).max())]
    for kind in ("mlstm", "slstm"):
        for g, w in zip(getattr(c, kind), getattr(want_c, kind)):
            out.append(float(np.abs(g.numpy() - w).max() / np.abs(w).max()))
    w = want_c.mlstm_conv
    out.append(float(np.abs(c.mlstm_conv.float().numpy() - w).max()
                     / np.abs(w).max()))
    return out


def test_bf16_prefill_and_decode_match_jax(bf16_runs):
    """The bf16 smoke xlstm, the dtype it is served in: prefill of P
    tokens (logits and every cache tensor within ``BF16_PREFILL_TOL``),
    then each of BF16_GEN decode steps from the JAX package's cache of the
    step before within ``BF16_DECODE_TOL``; and from the same caches two
    planted faults, each of which must read past that budget at every
    step.  Readings: prefill 4.64e-2, decode steps up to 1.62e-2; the
    faults' logits from 0.849 (conv window) and 0.236 (stabiliser)."""
    r = bf16_runs
    tcfg, steps = r["tcfg"], r["steps"]
    params = params_from_jax(r["params_np"], tcfg)
    bundle = build_model(tcfg)
    toks = _t(r["tokens"], torch.int64)
    with torch.no_grad():
        logits, cache = bundle.prefill(params, {"tokens": toks[:, :P]}, 0)
        pre = max(_rels(logits, cache, *steps[0]))
        assert pre <= BF16_PREFILL_TOL, pre
        sound, faults = [], {}
        for i in range(BF16_GEN):
            lg, c = bundle.decode_step(params, _cache_from_jax(steps[i][1]),
                                       toks[:, P + i])
            sound.append(max(_rels(lg, c, *steps[i + 1])))
            assert sound[-1] <= BF16_DECODE_TOL, (i, sound[-1])
            if i == 0:
                continue
            for name, fc in _faulty_caches(steps[i][1],
                                           steps[i - 1][1]).items():
                lg_f, _ = bundle.decode_step(params, fc, toks[:, P + i])
                faults.setdefault(name, []).append(_rels(
                    lg_f, c, steps[i + 1][0], steps[i + 1][1])[0])
    for name, reads in faults.items():
        assert min(reads) > BF16_DECODE_TOL, (name, reads)


def test_bf16_decode_departs_from_the_forward_as_the_reference_does(
        bf16_runs):
    """In bf16 the reference's own decode departs from its forward: its
    decode forms q and k in fp32 from an fp32 conv, where its chunked
    forward rounds them to bf16.  Witness, at smoke width: the JAX
    package's prefill(P) + BF16_GEN decode steps against its forward over
    the same tokens (argmax agreement 0.912, p90 |delta| 0.047) and their
    final states against its prefill(P + BF16_GEN) at one stabiliser (up
    to 5.1e-2, the sLSTM's h).  The port's own decode chain, held the
    same way against its own forward and prefill, departs by as much:
    within twice the reference's gap on every state and on p90 (the
    port: agreement 0.971, p90 0.047, states up to 4.8e-2)."""
    r = bf16_runs
    tcfg = r["tcfg"]
    params = params_from_jax(r["params_np"], tcfg)
    bundle = build_model(tcfg)
    toks = _t(r["tokens"], torch.int64)
    with torch.no_grad():
        logits, cache = bundle.prefill(params, {"tokens": toks[:, :P]}, 0)
        got = [logits.float()]
        for i in range(BF16_GEN):
            logits, cache = bundle.decode_step(params, cache, toks[:, P + i])
            got.append(logits.float())
        forward, _ = xlstm.xlstm_forward(params, toks, tcfg, remat="none")
        _, whole = bundle.prefill(params, {"tokens": toks}, 0)
    got = torch.stack(got).numpy()
    want = forward.float().numpy()[:, P - 1:].transpose(1, 0, 2)
    jgot = np.stack([lg for lg, _ in r["steps"]])
    jwant = r["forward"][:, P - 1:].transpose(1, 0, 2)

    def agree_p90(g, w):
        return (float((g.argmax(-1) == w.argmax(-1)).mean()),
                float(np.percentile(np.abs(g - w), 90)))

    (j_agree, j_p90), (_, t_p90) = (agree_p90(jgot, jwant),
                                    agree_p90(got, want))
    assert j_agree < 1.0, "the reference's own bf16 decode flips no argmax"
    j_gap = _state_gap(_cache_from_jax(r["steps"][-1][1]),
                       _cache_from_jax(r["whole"]))
    t_gap = _state_gap(cache, whole)
    assert max(j_gap.values()) > 10 * TOL, j_gap   # the reference's own gap
    for k in j_gap:
        assert t_gap[k] <= 2 * j_gap[k], (k, t_gap, j_gap)
    assert t_p90 <= 2 * j_p90, (t_p90, j_p90)


# ---------------------------------------------------------------------------
# The optimizer on the xlstm tree
# ---------------------------------------------------------------------------


# rank 16 < the smoke sLSTM's head dim 32: R (1, 4, 32, 128) is low-rank
OPT_KW = dict(rank=16, update_interval=2, eta=5.0)


@pytest.fixture(scope="module")
def opt_runs():
    jcfg, _ = _configs()
    return jax_optimizer_steps(_jax_params(jcfg, seed=6), OPT_KW, seed=5)


@pytest.mark.parametrize("tracking", [False, True])
def test_optimizer_step_on_the_xlstm_tree_matches_jax(tracking, opt_runs):
    """One plain (1e-5) and one tracking (1e-3) step from one JAX state:
    the mLSTM and sLSTM matrices low-rank, the sLSTM's R as a stack of
    (1, 4) matrices of m 32, conv_w and the fp32 gates dense."""
    tstate = opt_state_from_jax(opt_runs["state_np"])
    assert tstate.inner["slstm_layers"]["R"].S.shape == (1, 4, 32, 16)
    mlayers = tstate.inner["mlstm_layers"]
    for k in ("conv_w", "w_i", "w_f", "b_i", "b_f"):
        assert "S" not in mlayers[k]._fields, k
    check_optimizer_step(opt_runs, _configs()[1], tracking)


# ---------------------------------------------------------------------------
# Config, plans and the CLIs
# ---------------------------------------------------------------------------


def _plan_tuples(plans):
    return jax.tree.map(lambda p: (p.mode, p.transpose, p.m, p.n, p.rank),
                        plans, is_leaf=lambda p: hasattr(p, "mode"))


def test_xlstm_config_and_plans_match_the_reference():
    """The config, its paging answer, default rank and init schema equal
    the reference's; at the full width the plans are the reference's: 12
    low-rank leaves at rank 128 (the sLSTM's R as 3 x 4 matrices of m
    192), conv_w and the fp32 gates dense."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    assert tcfg.xlstm.__dict__ == jcfg.xlstm.__dict__
    assert ({k: v for k, v in tcfg.__dict__.items() if k != "xlstm"}
            == {k: v for k, v in jcfg.__dict__.items() if k != "xlstm"})
    assert ttf.paged_supported(tcfg) == jtf.paged_supported(jcfg) == (
        False, "family 'xlstm' has no paged cache layout")
    assert default_rank(tcfg.d_model) == jax_default_rank(jcfg.d_model) \
        == 128
    assert build_model(tcfg).loss_taps is None
    with pytest.raises(ValueError, match="divisible by slstm_every"):
        build_model(get_config(ARCH, smoke=True).with_(n_layers=6)).init(
            torch.Generator().manual_seed(0))
    jsmoke, tsmoke = jax_get_config(ARCH, smoke=True), get_config(ARCH,
                                                                  smoke=True)
    params = build_model(tsmoke).init(torch.Generator().manual_seed(0))
    with mesh_context(smoke_context()):
        jshapes = jax.eval_shape(jax_build_model(jsmoke).init,
                                 jax.random.PRNGKey(0))
        jfull = jax.eval_shape(jax_build_model(jcfg).init,
                               jax.random.PRNGKey(0))
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jshapes)
            == jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[1]),
                            params, is_leaf=torch.is_tensor))
    b = params["slstm_layers"]["b"][0]
    assert b.dtype == torch.float32 and (b[128:256] == 3.0).all() \
        and (b[:128] == 0).all() and (b[256:] == 0).all()
    assert (params["mlstm_layers"]["b_f"] == 3.0).all()
    tplans = _plan_tuples(make_plans(jfull, 128))
    assert tplans == _plan_tuples(jax_make_plans(jfull, 128))
    low = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
        tplans, is_leaf=lambda v: isinstance(v, tuple))[0]
        if v[0] == "lowrank"}
    assert len(low) == 12
    assert tplans["slstm_layers"]["R"][0] == "lowrank"
    assert tplans["slstm_layers"]["R"][2] == 192
    assert tplans["mlstm_layers"]["conv_w"][0] != "lowrank"


def test_xlstm_clis_run_at_smoke_size(capsys):
    """``train --arch xlstm-125m --smoke --use-kernels --grad-fused``: the
    JAX package's fallback line, finite losses, the tracking step at 2 and
    no kernel launch on the CPU; ``serve``: the paged engine's refusal and
    every request through the dense engine."""
    out = ttrain.train(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "4", "--rank", "16", "--update-interval",
                        "2", "--use-kernels", "--batch", "2", "--seq", "24",
                        "--grad-fused"])
    said = capsys.readouterr().out
    assert ("--grad-fused requested but this model family exposes no "
            "taggable matmuls — falling back to the plain backward") in said
    assert all(np.isfinite(out["losses"]))
    assert [h["step"] for h in out["history"] if h["subspace_update"]] == [2]
    assert not any(h["quarantined"] for h in out["history"])
    assert not any(out["launch_counts"].values())
    assert ops.launch_counts() == out["launch_counts"]
    served = tserve.serve(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "3", "--batch", "2",
                           "--prompt-len", "8", "--gen", "3"])
    said = capsys.readouterr().out
    assert ("paged engine unavailable for xlstm-125m: family 'xlstm' has "
            "no paged cache layout — falling back to dense") in said
    assert served["engine"] == "dense" and served["tokens"] == 9
    assert all(len(v) == 3 for v in served["outputs"].values())
