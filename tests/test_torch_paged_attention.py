"""The port's paged-attention oracle and dispatch against the JAX package.

Same numpy inputs through ``repro.kernels.ref.paged_attention_ref`` (and
once through the Pallas kernel in interpret mode) and through
``repro_torch.kernels.ref.paged_attention_ref``, over the sweep of
``tests/test_kernels_paged.py``: G in {1, 2, 4}, mixed lengths, null-block
padding, dead lanes.  Tolerances: fp32 atol = rtol = 2e-5 (summation
order only); bf16 atol 3e-2, rtol 5e-2 (one bf16 rounding of the output,
inputs rounded identically on both sides).  Plus the CPU half of the
dispatch contract and the kernel wrapper's input checks, which run before
any device is touched.  The kernel itself is tested on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as jax_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_attention import paged_attention as cuda_kernel

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
