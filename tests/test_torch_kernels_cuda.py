"""The port's CUDA kernels against their plain-PyTorch oracles, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (a CUDA kernel has no CPU
mode), carries the ``cuda`` marker and skips elsewhere with its reason.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import paged_attention

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=5e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(B, Hq, Hkv, hd, bs, W, dtype, device, seed=0, lengths=None):
    """Random pool + null-padded tables over distinct non-null blocks."""
    rng = np.random.default_rng(seed)
    nb = 1 + B * W
    q = torch.tensor(rng.standard_normal((B, Hq, hd)), dtype=dtype)
    kp = torch.tensor(rng.standard_normal((nb, bs, Hkv, hd)), dtype=dtype)
    vp = torch.tensor(rng.standard_normal((nb, bs, Hkv, hd)), dtype=dtype)
    tables = (rng.permutation(nb - 1)[:B * W] + 1).reshape(B, W)
    if lengths is None:
        lengths = rng.integers(1, W * bs + 1, size=(B,))
    lengths = np.asarray(lengths)
    for b in range(B):
        tables[b, -(-int(lengths[b]) // bs):] = 0
    args = (q, kp, vp, torch.tensor(tables, dtype=torch.int32),
            torch.tensor(lengths, dtype=torch.int32))
    return tuple(t.to(device) for t in args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd,bs,W", [
    (2, 2, 32, 4, 3),          # MHA, tiny blocks
    (4, 2, 32, 8, 4),          # G = 2
    (8, 2, 64, 16, 2),         # G = 4
    (4, 1, 16, 7, 5),          # MQA, odd block size
    (32, 32, 128, 16, 36),     # llama-7b decode shape, 576 positions
    (32, 8, 160, 16, 36),      # stablelm-12b: G = 4, hd 160
    (4, 2, 256, 1, 40),        # widest head, one position per block
])
def test_kernel_matches_oracle(cuda, dtype, Hq, Hkv, hd, bs, W):
    args = _case(3, Hq, Hkv, hd, bs, W, dtype, cuda, seed=Hq * 100 + bs)
    got = paged_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_dead_lane_is_exactly_zero_and_partial_block_masked(cuda):
    args = _case(4, 4, 2, 32, 8, 3, torch.float32, cuda,
                 lengths=[0, 1, 11, 24])
    got = paged_attention(*args)
    torch.testing.assert_close(got, ref.paged_attention_ref(*args),
                               atol=2e-5, rtol=2e-5)
    assert torch.count_nonzero(got[0]).item() == 0


@pytest.mark.cuda
def test_broken_table_gives_nan_not_garbage(cuda):
    q, kp, vp, tables, lengths = _case(2, 4, 2, 32, 8, 3, torch.float32,
                                       cuda, lengths=[24, 24])
    tables[1, 1] = kp.shape[0]                  # one past the pool
    out = paged_attention(q, kp, vp, tables, lengths)
    assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()


@pytest.mark.cuda
def test_dispatch_launches_kernel_and_counts(cuda):
    args = _case(2, 4, 2, 32, 8, 3, torch.bfloat16, cuda)
    ops.reset_launch_counts()
    ops.paged_attention(*args)
    ops.paged_attention(*args)
    assert ops.launch_counts()["paged_attention"] == 2


@pytest.mark.cuda
def test_rejects_non_contiguous_and_mixed_devices(cuda):
    q, kp, vp, tables, lengths = _case(2, 4, 2, 32, 8, 3, torch.float32,
                                       cuda)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                        kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="CUDA device"):
        paged_attention(q, kp, vp, tables, lengths.cpu())
