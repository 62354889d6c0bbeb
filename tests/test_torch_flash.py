"""The port's ``flash_attention`` (#13) against the JAX package's Pallas
kernel in interpret mode (``bq = bk = 64``), on the CPU, where the port's
dispatch runs its oracle ``ref.flash_attention_ref``.

Same numpy inputs from a seed, in the JAX layout (q (B, S, Hq, hd), k and
v (B, T, Hkv, hd)): MHA, GQA 2 and MQA; causal, window 64, softcap 30 and
non-causal; S != T (top-left causal alignment, both positions from 0);
hd 128 and an odd hd; a window that leaves rows with no visible key (the
kernel's mean of all values).  fp32 within atol = rtol = 1e-5 (online
softmax in 64-key blocks against one softmax per row).  bf16 inputs:
within one bf16 rounding of the output on top of that fp32 budget (both
sides compute in fp32 from the same bf16 values, so their fp32 results
differ by the fp32 budget and the final rounding may then fall apart;
near-zero outputs, where the sum cancels, need the 1e-5).

The bf16 route's arithmetic (``ref.flash_attention_split_ref``: 64-key
tiles, log2-domain softmax, P V over P's two bf16 terms) is held against
the same Pallas kernel at the same cases and tolerances, on inputs rounded
to bf16 (the only inputs that route takes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref
from torch_threads import one_thread  # noqa: F401


def _qkv(B, S, T, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, hd)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, hd)).astype(np.float32))


def _both(q, k, v, dtype="float32", **kw):
    tq, tk, tv = (torch.tensor(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, **kw)
    want = jflash.flash_attention(jq, jk, jv, bq=64, bk=64, interpret=True,
                                  **kw)
    return got, np.asarray(want.astype(jnp.float32))


MASKS = pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0), (False, 0, 0.0)])


@MASKS
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [
    (1, 128, 2, 2, 128),       # MHA
    (2, 128, 4, 2, 128),       # GQA, group 2
    (1, 128, 4, 1, 128),       # MQA
])
def test_matches_the_pallas_kernel(B, S, Hq, Hkv, hd, causal, window,
                                   softcap):
    q, k, v = _qkv(B, S, S, Hq, Hkv, hd, seed=Hq * 10 + Hkv)
    got, want = _both(q, k, v, causal=causal, window=window, softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == (B, S, Hq, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,T,causal,window", [
    (64, 192, True, 0),        # top-left: query i sees keys 0..i only
    (64, 192, False, 32),
    (192, 64, True, 0),        # rows past T see every key
    (192, 64, False, 32),      # rows >= T - 1 + window see no key: the mean
])
def test_s_not_t_matches_the_pallas_kernel(S, T, causal, window):
    q, k, v = _qkv(1, S, T, 4, 2, 64, seed=S + T + window)
    got, want = _both(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if S > T and window:
        mean = v.repeat(2, axis=2).mean(axis=1)           # (1, Hq, hd)
        np.testing.assert_allclose(got.numpy()[:, T - 1 + window:],
                                   np.broadcast_to(mean[:, None],
                                                   (1, S - T - window + 1,
                                                    4, 64)),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hd", [85, 21])
def test_odd_head_dim_matches_the_pallas_kernel(hd):
    q, k, v = _qkv(1, 128, 128, 4, 2, hd, seed=hd)
    got, want = _both(q, k, v, causal=True, window=64, softcap=30.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0),
                                                   (True, 64, 50.0)])
def test_bf16_within_one_rounding_of_the_pallas_kernel(causal, window,
                                                       softcap):
    q, k, v = _qkv(1, 128, 128, 4, 2, 128, seed=3)
    got, want = _both(q, k, v, "bfloat16", causal=causal, window=window,
                      softcap=softcap)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    _, e = np.frexp(want)
    ulp = np.where(want == 0, 0.0, np.ldexp(1.0, e - 8))  # bf16: 8 bits
    assert (np.abs(got - want) <= ulp + 1e-5 + 1e-5 * np.abs(want)).all()


def test_p_stays_fp32_unlike_blocked_attention():
    """The oracle keeps P in fp32 for P V; rounding P to v's dtype, as the
    jnp ``blocked_attention`` does, is a different function."""
    q, k, v = _qkv(1, 64, 64, 2, 2, 64, seed=9)
    tq, tk, tv = (torch.tensor(a).bfloat16() for a in (q, k, v))
    got = ref.flash_attention_ref(tq.float(), tk.float(), tv.float())
    qf, kf, vf = tq.float(), tk.float(), tv.float()
    logits = torch.einsum("bshd,bthd->bhst", qf, kf) / 8.0
    logits = logits.masked_fill(
        ~torch.ones(64, 64, dtype=torch.bool).tril(), -1e30)
    p = torch.softmax(logits, dim=-1)
    fp32 = torch.einsum("bhst,bthd->bshd", p, vf)
    rounded = torch.einsum("bhst,bthd->bshd", p.bfloat16().float(), vf)
    torch.testing.assert_close(got, fp32, atol=1e-5, rtol=1e-5)
    assert (got - rounded).abs().max() > 1e-4


def test_traffic_model_matches_jax():
    for args in ((1, 2048, 2048, 32, 32, 128, 128),
                 (2, 8192, 8192, 32, 16, 128, 128, 256, 4)):
        assert tflash.flash_traffic_bytes(*args) \
            == jflash.flash_traffic_bytes(*args)


def test_cpu_dispatch_launches_nothing_and_the_kernel_refuses_the_cpu():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 64, 64, 2, 1, 32))
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.flash_attention(q, k, v, window=16),
                               ref.flash_attention_ref(q, k, v, window=16),
                               atol=0, rtol=0)
    assert not any(ops.launch_counts().values())
    with pytest.raises(ValueError, match="CUDA device"):
        tflash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tflash.flash_attention(q, k[:, :, :1].expand(1, 64, 3, 32)
                               .contiguous(), v[:, :, :1].expand(1, 64, 3, 32)
                               .contiguous())
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention(*(torch.zeros(1, 4, 1, 257),) * 3)


def _split_both(q, k, v, dtype="float32", **kw):
    """The bf16 route's emulated arithmetic and the Pallas kernel on q, k, v
    rounded to bf16: (emulated fp32 output, the kernel's output in
    ``dtype`` as fp32 numpy)."""
    tq, tk, tv = (torch.tensor(a).bfloat16() for a in (q, k, v))
    got = ref.flash_attention_split_ref(tq, tk, tv, **kw)
    want = jflash.flash_attention(
        *(jnp.asarray(t.float().numpy(), jnp.dtype(dtype))
          for t in (tq, tk, tv)), bq=64, bk=64, interpret=True, **kw)
    return got, np.asarray(want.astype(jnp.float32))


@MASKS
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [
    (1, 128, 2, 2, 128), (2, 128, 4, 2, 128), (1, 128, 4, 1, 128)])
def test_split_route_matches_the_pallas_kernel(B, S, Hq, Hkv, hd, causal,
                                               window, softcap):
    q, k, v = _qkv(B, S, S, Hq, Hkv, hd, seed=Hq * 10 + Hkv)
    got, want = _split_both(q, k, v, causal=causal, window=window,
                            softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,T,causal,window", [
    (64, 192, True, 0), (64, 192, False, 32), (192, 64, True, 0),
    (192, 64, False, 32)])
def test_split_route_s_not_t_matches_the_pallas_kernel(S, T, causal, window):
    q, k, v = _qkv(1, S, T, 4, 2, 64, seed=S + T + window)
    got, want = _split_both(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hd", [85, 21])
def test_split_route_odd_head_dim_matches_the_pallas_kernel(hd):
    q, k, v = _qkv(1, 128, 128, 4, 2, hd, seed=hd)
    got, want = _split_both(q, k, v, causal=True, window=64, softcap=30.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0),
                                                   (True, 64, 50.0)])
def test_split_route_bf16_within_one_rounding_of_the_pallas_kernel(
        causal, window, softcap):
    q, k, v = _qkv(1, 128, 128, 4, 2, 128, seed=3)
    got, want = _split_both(q, k, v, "bfloat16", causal=causal,
                            window=window, softcap=softcap)
    got = got.bfloat16().float().numpy()
    _, e = np.frexp(want)
    ulp = np.where(want == 0, 0.0, np.ldexp(1.0, e - 8))  # bf16: 8 bits
    assert (np.abs(got - want) <= ulp + 1e-5 + 1e-5 * np.abs(want)).all()
