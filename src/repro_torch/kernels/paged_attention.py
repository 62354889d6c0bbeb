"""Paged-attention decode: Python binding of ``csrc/paged_attention.cu``.

One query token per sequence attends over K/V scattered across a global
block pool and addressed through a per-request block table.  The kernel
replaces the Pallas TPU kernel ``repro.kernels.paged_attention``; what it
computes is ``repro_torch.kernels.ref.paged_attention_ref``, and the source
note in the ``.cu`` file says how the design differs from the TPU's and
what bounds it.  There is no shape gate beyond what the CUDA code itself
needs (the TPU's ``hd % 128``, ``bs % 8`` were MXU tiling limits): any
head dim up to ``MAX_HEAD_DIM`` (the kernel stages rows by ``cp.async``
where they are whole 16-byte words and by element loads elsewhere, e.g.
llama-1b's hd 85), any block size, any G.

The kernel splits each sequence's table words over ``splits`` CTAs and
merges their partials in a second kernel of the same C call;
:func:`choose_splits` picks the count from the shapes alone (never from
``lengths``, which would cost a device sync per layer).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
MIN_SPLIT_POSITIONS = 64      # fewer positions per split cost more to merge
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def choose_splits(B: int, Hkv: int, W: int, bs: int, capacity: int) -> int:
    """Splits over a sequence's W table words: as many as keep all
    B * Hkv * splits CTAs resident at once (``capacity``, the CTAs the card
    holds for these shapes: one wave, no tail), at least
    ``MIN_SPLIT_POSITIONS`` positions of the table each, never more than
    W, at least 1."""
    fits = capacity // max(1, B * Hkv)
    by_length = (W * bs) // MIN_SPLIT_POSITIONS
    return max(1, min(fits, by_length, W))


@functools.cache
def _capacity(G: int, hd: int, dtype: int, device: int) -> int:
    with torch.cuda.device(device):
        n = _lib().paged_attention_capacity(G, hd, dtype)
    if n <= 0:
        raise RuntimeError("paged_attention: the occupancy query failed")
    return n


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = [vp] * 7 + [i] * 9 + [
        ctypes.c_float, vp]
    lib.paged_attention_launch.restype = ctypes.c_int
    lib.paged_attention_capacity.argtypes = [i, i, i]
    lib.paged_attention_capacity.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_pool, v_pool, block_tables, lengths) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError("expected q (B, Hq, hd) and k_pool == v_pool "
                         f"(nb, bs, Hkv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, Hq, hd = q.shape
    _, bs, Hkv, hd_kv = k_pool.shape
    if hd_kv != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"head dims {hd}/{hd_kv} differ or Hq {Hq} is not "
                         f"a multiple of Hkv {Hkv}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError("q, k_pool and v_pool must share one dtype of "
                         f"float32/bfloat16; got {q.dtype}, {k_pool.dtype}, "
                         f"{v_pool.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} must be <= {MAX_HEAD_DIM}")
    if bs < 1:
        raise ValueError("block size must be >= 1")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError("expected int32 block_tables (B, W) and lengths "
                         f"(B,); got {block_tables.dtype} "
                         f"{tuple(block_tables.shape)}, {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *, splits: int | None = None
                    ) -> torch.Tensor:
    """Launch the CUDA kernels: q (B, Hq, hd); pools (nb, bs, Hkv, hd);
    block_tables (B, W) int32; lengths (B,) int32 -> (B, Hq, hd) in q's
    dtype, on PyTorch's current stream.  ``splits`` (default
    :func:`choose_splits`) is the number of CTAs a sequence's table is cut
    into.  Raises on a tensor that is not on one CUDA device, and after a
    launch that reports an error.  Counts one launch per call, whether or
    not the merge kernel runs."""
    _check(q, k_pool, v_pool, block_tables, lengths)
    if splits is not None and not 1 <= splits <= 65535:
        raise ValueError(f"splits must be in [1, 65535]; got {splits}")
    tensors = (q, k_pool, v_pool, block_tables, lengths)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention kernel needs every tensor on one "
                         "CUDA device; got "
                         f"{sorted({str(t.device) for t in tensors})}")
    B, Hq, hd = q.shape
    nb, bs, Hkv, _ = k_pool.shape
    G = Hq // Hkv
    W = block_tables.shape[1]
    if splits is None:
        splits = choose_splits(B, Hkv, W, bs, _capacity(
            G, hd, _DTYPES[q.dtype], q.device.index or 0))
    lib = _lib()
    out = torch.empty_like(q)
    partials = (torch.empty(B * Hq * splits * (hd + 2), dtype=torch.float32,
                            device=q.device) if splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            _DTYPES[q.dtype], B, Hkv, G, hd, bs, W, nb, splits,
            1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError("paged_attention launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0      # kernel launches since the last reset
