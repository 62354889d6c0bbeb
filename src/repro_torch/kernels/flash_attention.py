"""Flash attention (forward): Python binding of ``csrc/flash_attention.cu``.

The kernel replaces the Pallas TPU kernel ``repro.kernels.flash_attention``
and keeps its layout and semantics: q (B, S, Hq, hd), k and v (B, T, Hkv,
hd) -> (B, S, Hq, hd) in q's dtype, scale 1/sqrt(hd), an optional logit
softcap applied before the masks, causal and sliding-window masks with both
positions counted from 0, P kept to fp32 accuracy in the P V product.  What
it computes is ``repro_torch.kernels.ref.flash_attention_ref``; the note in
the ``.cu`` file says how the design differs from the TPU's and what bounds
it.

The route follows the dtype (``FLASH_ROUTES``; ``flash_attention.route``
names the last call's): bf16 q/k/v run on the tensor cores (``wgmma``,
Q K^T in one bf16 pass, P V over P split in registers into two bf16 terms,
K and V through a ring fed by TMA, ``wgmma-tma``, or by element loads where
a row of hd is not a whole number of 16-byte words, ``wgmma-loads``); fp32
q/k/v run on the CUDA cores (``cuda-cores``).  There is no fallback: a
build or launch failure raises.

No model of the JAX package calls the TPU kernel (its decoders use the jnp
``blocked_attention``), so this entry point is the public function itself,
dispatched by :func:`repro_torch.kernels.ops.flash_attention`.  There is no
shape gate beyond the kernel's own: any S and T (ragged tiles are masked;
the TPU's ``S % bq == 0`` was a tiling limit) and any head dim up to
``MAX_HEAD_DIM`` (rows that are not whole 16-byte words take one element
per load, e.g. llama-1b's hd 85).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the routes flash_attention_launch reports
FLASH_ROUTES = {0: "cuda-cores", 1: "wgmma-tma", 2: "wgmma-loads"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [vp] * 4 + [i] * 9 + [
        ctypes.c_float, ctypes.c_float, vp, vp]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window: int) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("expected q (B, S, Hq, hd) and k == v (B, T, Hkv, "
                         f"hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, hd = q.shape
    Bk, T, Hkv, hd_kv = k.shape
    if Bk != B or hd_kv != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim, or Hq is not a multiple of "
                         "Hkv")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} must be in [1, {MAX_HEAD_DIM}]")
    if T == 0:
        raise ValueError("no keys: T must be >= 1")
    if window < 0:
        raise ValueError(f"window must be >= 0 (0 is off); got {window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype of float32/"
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError("the flash_attention kernel needs q, k and v on one "
                         f"CUDA device; got {sorted(str(d) for d in devs)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream: q (B, S, Hq, hd),
    k and v (B, T, Hkv, hd), all contiguous, one dtype (fp32 or bf16) ->
    (B, S, Hq, hd) in q's dtype.  ``window`` 0 and ``softcap`` 0 are off.
    Raises ValueError on what the kernel does not take and RuntimeError
    after a launch that reports an error; ``flash_attention.route`` names
    the route taken (``FLASH_ROUTES``)."""
    window = int(window)
    _check(q, k, v, window)
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _lib()
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, S, T, Hq, Hkv, hd, int(bool(causal)), window,
            float(softcap), 1.0 / math.sqrt(hd), ctypes.byref(route), stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    flash_attention.route = FLASH_ROUTES[route.value]
    flash_attention.launches += 1
    return out


flash_attention.launches = 0      # kernel launches since the last reset
flash_attention.route = None      # route of the last call


def flash_traffic_bytes(B: int, S: int, T: int, Hq: int, Hkv: int,
                        hd: int, vd: int, bq: int = 512,
                        dtype_bytes: int = 2) -> int:
    """Device-memory traffic of the flash schedule, the JAX package's model
    (``repro/kernels/flash_attention.py``): read Q once, write O once, and
    stream K and V once per block of ``bq`` query rows."""
    nq = S // bq
    q_o = B * S * Hq * (hd + vd) * dtype_bytes
    kv = B * T * Hkv * (hd + vd) * dtype_bytes
    return q_o + nq * kv
