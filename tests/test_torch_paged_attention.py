"""The port's paged-attention oracle and dispatch against the JAX package.

Same numpy inputs through ``repro.kernels.ref.paged_attention_ref`` (and
once through the Pallas kernel in interpret mode) and through
``repro_torch.kernels.ref.paged_attention_ref``, over the sweep of
``tests/test_kernels_paged.py``: G in {1, 2, 4}, mixed lengths, null-block
padding, dead lanes.  Tolerances: fp32 atol = rtol = 2e-5 (summation
order only); bf16 atol 3e-2, rtol 5e-2 (one bf16 rounding of the output,
inputs rounded identically on both sides).  Plus the CPU half of the
dispatch contract and the kernel wrapper's input checks, which run before
any device is touched.  The CUDA kernel's split-K schedule (partials per
split of the table words, merged by log-sum-exp in split order) is
modelled in torch here and held against both oracles and the Pallas
kernel, at split counts 1 to past the table, with dead lanes, partial
blocks and broken tables.  The kernel itself is tested on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as jax_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_attention import choose_splits
from repro_torch.kernels.paged_attention import paged_attention as cuda_kernel
from torch_threads import one_thread  # noqa: F401


TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=5e-2)}


def _case(B, Hq, Hkv, hd, bs, W, seed=0, lengths=None):
    """numpy q, pools, null-padded tables over distinct blocks, lengths."""
    rng = np.random.default_rng(seed)
    nb = 1 + B * W
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, Hkv, hd)).astype(np.float32)
    tables = (rng.permutation(nb - 1)[:B * W] + 1).reshape(B, W)
    if lengths is None:
        lengths = rng.integers(1, W * bs + 1, size=(B,))
    lengths = np.asarray(lengths, np.int32)
    for b in range(B):
        tables[b, -(-int(lengths[b]) // bs):] = 0
    return q, kp, vp, tables.astype(np.int32), lengths


def _jax(case, dtype):
    q, kp, vp, tables, lengths = case
    d = jnp.dtype(dtype)
    return (jnp.asarray(q, d), jnp.asarray(kp, d), jnp.asarray(vp, d),
            jnp.asarray(tables), jnp.asarray(lengths))


def _torch(case, dtype):
    q, kp, vp, tables, lengths = case
    d = getattr(torch, dtype)
    return (torch.tensor(q).to(d), torch.tensor(kp).to(d),
            torch.tensor(vp).to(d), torch.tensor(tables),
            torch.tensor(lengths))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,hd", [
    (2, 2, 32),        # G = 1
    (4, 2, 32),        # G = 2
    (8, 2, 64),        # G = 4
    (4, 1, 16),        # MQA (G = 4)
])
@pytest.mark.parametrize("bs,W", [(4, 3), (8, 4), (16, 2)])
def test_ref_matches_jax_ref(dtype, Hq, Hkv, hd, bs, W):
    case = _case(3, Hq, Hkv, hd, bs, W, seed=Hq * 100 + bs)
    want = jref.paged_attention_ref(*_jax(case, dtype))
    got = tref.paged_attention_ref(*_torch(case, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == case[0].shape
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_kernel_dead_lane_partial_block(dtype):
    """Against the Pallas kernel itself (interpret mode): a dead lane, a
    one-position lane, a mid-block length and a full table, at G = 2."""
    case = _case(4, 4, 2, 32, 8, 3, lengths=[0, 1, 11, 24])
    want = jax_kernel(*_jax(case, dtype), interpret=True)
    got = tref.paged_attention_ref(*_torch(case, dtype))
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    assert torch.count_nonzero(got[0]).item() == 0      # exactly zero
    assert float(jnp.max(jnp.abs(want[0]))) == 0.0


def test_gqa_groups_are_contiguous_query_heads():
    """Query head h*G + g reads KV head h: perturbing KV head 1 moves only
    query heads G..2G-1.  (With G = 1 a wrong grouping would still pass.)"""
    q, kp, vp, tables, lengths = _torch(_case(2, 8, 2, 32, 4, 3, seed=4),
                                        "float32")
    base = tref.paged_attention_ref(q, kp, vp, tables, lengths)
    vp2 = vp.clone()
    vp2[:, :, 1] += 1.0
    moved = tref.paged_attention_ref(q, kp, vp2, tables, lengths)
    changed = (moved - base).abs().amax(dim=(0, 2)) > 1e-3     # per q head
    assert changed.tolist() == [False] * 4 + [True] * 4


def test_ops_dispatch_on_cpu_takes_the_oracle_and_counts_nothing():
    args = _torch(_case(2, 4, 2, 32, 8, 3, seed=5), "float32")
    ops.reset_launch_counts()
    via_ops = ops.paged_attention(*args)
    torch.testing.assert_close(via_ops, tref.paged_attention_ref(*args),
                               atol=0, rtol=0)
    counts = ops.launch_counts()
    assert counts["paged_attention"] == 0 and not any(counts.values())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it raises."""
    args = _torch(_case(2, 4, 2, 32, 8, 3), "float32")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_kernel(*args)
    assert cuda_kernel.launches == 0


@pytest.mark.parametrize("mutate,match", [
    (lambda a: (a[0], a[1][:, :0], a[2][:, :0], a[3], a[4]), "block size"),
    (lambda a: (a[0].repeat(1, 1, 2),) + a[1:], "head dims"),
    (lambda a: (a[0].half(), a[1].half(), a[2].half(), a[3], a[4]),
     "dtype"),
    (lambda a: a[:3] + (a[3].long(), a[4]), "int32"),
    (lambda a: (a[0].transpose(0, 1).contiguous().transpose(0, 1),)
     + a[1:], "contiguous"),
    (lambda a: (a[0][:, :3].contiguous(),) + a[1:], "multiple of Hkv"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(mutate, match):
    args = mutate(_torch(_case(2, 4, 2, 32, 8, 3), "float32"))
    with pytest.raises(ValueError, match=match):
        cuda_kernel(*args)


def test_kernel_wrapper_rejects_head_dim_past_256():
    q, kp, vp, tables, lengths = _torch(_case(1, 2, 1, 264, 4, 2),
                                        "float32")
    with pytest.raises(ValueError, match="<= 256"):
        cuda_kernel(q, kp, vp, tables, lengths)


# ---------------------------------------------------------------------------
# The CUDA kernel's split-K schedule, modelled on the CPU
# ---------------------------------------------------------------------------


def _split_merge_model(q, k_pool, v_pool, tables, lengths, splits):
    """A torch model of the kernel's schedule: split s owns table words
    [s * wps, (s + 1) * wps) and writes an fp32 partial (max m, normaliser
    l, acc) over its positions below ``length``; an empty split writes
    (-1e30, 0, 0); a broken table word or a length past the table makes
    its split's max NaN.  The merge adds the partials by log-sum-exp in
    split order and divides by max(L, 1e-30)."""
    B, Hq, hd = q.shape
    nb, bs, Hkv, _ = k_pool.shape
    G = Hq // Hkv
    W = tables.shape[1]
    wps = -(-W // splits)                    # table words per split
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty(B, Hq, hd)
    for b in range(B):
        length = max(int(lengths[b]), 0)
        qb = q[b].float().reshape(Hkv, G, hd)
        ms, ls, accs = [], [], []
        for s in range(splits):
            p0 = s * wps * bs
            p1 = min(length, min(W, (s + 1) * wps) * bs)
            m = torch.full((Hq,), -1e30)
            l_, acc = torch.zeros(Hq), torch.zeros(Hq, hd)
            bad = length > W * bs
            if not bad and p1 > p0:
                pos = torch.arange(p0, p1)
                words = tables[b, pos // bs].long()
                bad = bool(((words < 0) | (words >= nb)).any())
                if not bad:
                    k = k_pool[words, pos % bs].float()      # (n, Hkv, hd)
                    v = v_pool[words, pos % bs].float()
                    logits = torch.einsum("hgd,nhd->hgn", qb, k) * scale
                    mx = logits.amax(-1, keepdim=True)
                    p = torch.exp(logits - mx)
                    m = mx.reshape(Hq)
                    l_ = p.sum(-1).reshape(Hq)
                    acc = torch.einsum("hgn,nhd->hgd", p, v).reshape(Hq, hd)
            ms.append(torch.full((Hq,), math.nan) if bad else m)
            ls.append(l_)
            accs.append(acc)
        m_all = torch.stack(ms)                              # (splits, Hq)
        lane_bad = torch.isnan(m_all).any(0)
        M = torch.where(torch.isnan(m_all), -math.inf, m_all).amax(0)
        L = torch.zeros(Hq)
        O = torch.zeros(Hq, hd)
        for s in range(splits):                              # split order
            w = torch.exp(m_all[s] - M)
            L = L + ls[s] * w
            O = O + accs[s] * w[:, None]
        o = O / L.clamp_min(1e-30)[:, None]
        out[b] = torch.where(lane_bad[:, None], math.nan, o)
    return out.to(q.dtype)


SPLIT_CASE = dict(B=4, Hq=4, Hkv=2, hd=32, bs=8, W=5,
                  lengths=[0, 1, 27, 40])     # dead lane, one position,
#                                               a partial last block, full


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 9])   # 9 > W: empty splits
def test_split_merge_model_matches_refs(dtype, splits):
    """The split-and-merge schedule gives the oracle's attention (torch and
    JAX) at any split count, a dead lane exactly 0."""
    c = SPLIT_CASE
    case = _case(c["B"], c["Hq"], c["Hkv"], c["hd"], c["bs"], c["W"],
                 seed=splits, lengths=c["lengths"])
    got = _split_merge_model(*_torch(case, dtype), splits)
    want = tref.paged_attention_ref(*_torch(case, dtype))
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    np.testing.assert_allclose(
        _f32(got), _f32(jref.paged_attention_ref(*_jax(case, dtype))),
        **TOL[dtype])
    assert torch.count_nonzero(got[0]).item() == 0


def test_split_merge_model_matches_jax_kernel():
    """Against the Pallas kernel itself (interpret mode), 2 splits."""
    case = _case(4, 4, 2, 32, 8, 3, seed=7, lengths=[0, 5, 16, 24])
    want = jax_kernel(*_jax(case, "float32"), interpret=True)
    got = _split_merge_model(*_torch(case, "float32"), 2)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_split_merge_broken_table_word_is_nan_whichever_split(splits):
    """A word outside [0, nb) below the length makes that lane NaN, and
    only that lane; a length past W * bs too."""
    c = SPLIT_CASE
    q, kp, vp, tables, lengths = _torch(
        _case(3, c["Hq"], c["Hkv"], c["hd"], c["bs"], c["W"], seed=3,
              lengths=[40, 40, 40]), "float32")
    tables[1, 3] = kp.shape[0]                 # one past the pool
    lengths[2] = c["W"] * c["bs"] + 1          # past the table
    got = _split_merge_model(q, kp, vp, tables, lengths, splits)
    assert torch.isnan(got[1]).all() and torch.isnan(got[2]).all()
    want0 = tref.paged_attention_ref(q[:1], kp, vp, tables[:1], lengths[:1])
    torch.testing.assert_close(got[:1], want0, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,Hkv,W,bs,want", [
    (8, 32, 36, 16, 3),        # llama-7b decode wave: 256 (b, h) pairs
    (1, 1, 4, 16, 1),          # 64 positions: too few to split
    (64, 32, 36, 16, 1),       # 2048 pairs already fill the card
    (1, 8, 2048, 16, 99),      # one long sequence: the card's worth of CTAs
    (2, 2, 3, 128, 3),         # never more splits than table words
])
def test_choose_splits_from_shapes_alone(B, Hkv, W, bs, want):
    """At 6 CTAs per SM of 132 (792 resident): one wave, no tail."""
    assert choose_splits(B, Hkv, W, bs, capacity=792) == want
    assert 1 <= want <= W
    assert B * Hkv * want <= 792 or want == 1


@pytest.mark.parametrize("splits", [0, -1, 65536])
def test_kernel_wrapper_rejects_bad_split_counts(splits):
    args = _torch(_case(2, 4, 2, 32, 8, 3), "float32")
    with pytest.raises(ValueError, match="splits"):
        cuda_kernel(*args, splits=splits)
