"""SubTrack++ optimizer kernels: Python bindings of the CUDA sources.

    project, project_colnorms   csrc/grassmann_project.cu
    tangent                     csrc/grassmann_tangent.cu
    tangent_gram                csrc/grassmann_tangent_gram.cu
    project_tangent_colnorms    csrc/grassmann_tangent_front.cu
    backproject, recovery       csrc/grassmann_backproject.cu
    adam_lowrank_norms,
    adam_lowrank                csrc/adam_lowrank_norms.cu
    fused_update                csrc/fused_update.cu
    grad_tap                    csrc/grad_tap.cu

They replace the Pallas TPU kernels of the same names in
``repro.kernels.grassmann``; what each computes is its oracle in
:mod:`repro_torch.kernels.ref`, and the note at the top of each ``.cu``
file says how the design differs from the TPU's and what bounds it on
the H100.  Every kernel but ``grad_tap`` (called per layer from the
backward) takes a leading batch dim (one matrix per index, one launch
for a whole layer stack) and accumulates in fp32.  Nine run on the bf16
tensor cores (``wgmma``, the shared machinery in
``csrc/hopper_mma.cuh``) over fp32 factors split into three exact bf16
terms (``ref.split3_ref``):

* ``project`` and ``project_colnorms`` with bf16 G (S split);
* ``tangent`` with bf16 G (A, S and the Gram 2 A A^T split; 6 term
  products for the fp32 x fp32 ones);
* ``project_tangent_colnorms`` with bf16 G (S and A split; its tail's
  S^T W and S (2C) over 6 term products);
* ``fused_update``, ``backproject`` and ``recovery`` for every dtype (S
  and the direction D, or S and X / Gt, split; 6 term products);
* ``tangent_gram``'s Grams for every dtype (S and T split, 6 term
  products), and its T^T G with bf16 G (T split, 3 passes);
* ``grad_tap`` with bf16 x and dy (S and P = x S split; dW exact in one
  pass).

fp32 G (or fp32 x and dy) keeps the CUDA cores where its product is not
exact in one bf16 term; ``adam_lowrank_norms`` and ``adam_lowrank`` are
elementwise, on the CUDA cores.  Each tensor-core wrapper reports the
route of its last call in ``<wrapper>.route``.  There is no shape gate:
ragged tiles are masked in the kernels (the TPU's 256-multiples were
MXU/VMEM limits).  One kernel has a size limit of its own:
``project_tangent_colnorms`` takes m <= ``MAX_FRONT_M``
(a thread-block cluster of at most 16 CTAs holds the whole m extent, 128
rows each; ``csrc/grassmann_tangent_front.cu``).

Inputs the kernels read in place through strides: the gradient G (also
in ``recovery``) and,
in ``fused_update``, the parameter and the output, so the transposed
canonical view of a ``(.., n, m)`` leaf needs no copy; in ``grad_tap``,
x, dy and the dW it writes.  Every other
operand (S, T, A, Gt, Gto, M, V, phi) must be contiguous fp32; anything else
raises ``ValueError``.  Each wrapper runs on PyTorch's current stream,
raises ``RuntimeError`` when its launch reports an error, and counts its
launches in ``<wrapper>.launches``: one per call, however many CUDA
kernels the call runs (a split pre-pass, ``grad_tap``'s two tile
launches, ``fused_update``'s chunks of a stack).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
_SIGNATURES = {
    "grassmann_project": ("grassmann_project_launch",
                          [_vp] * 5 + [_i] * 6 + [_ll] * 3 + [_vp, _vp]),
    "grassmann_tangent": ("grassmann_tangent_launch",
                          [_vp] * 6 + [_i] * 5 + [_ll] * 3 + [_vp, _vp]),
    "grassmann_tangent_gram": ("grassmann_tangent_gram_launch",
                               [_vp] * 8 + [_i] * 5 + [_ll] * 3 + [_vp, _vp]),
    "adam_lowrank_norms": ("adam_lowrank_norms_launch",
                           [_vp] * 8 + [_i] * 3 + [_f] * 7 + [_vp]),
    "fused_update": ("fused_update_launch",
                     [_vp] * 12 + [_i] * 8 + [_vp, _vp]),
    "grad_tap": ("grad_tap_launch",
                 [_vp] * 6 + [_i] * 7 + [_ll] * 6 + [_vp, _vp]),
    "grassmann_tangent_front": ("tangent_front_launch",
                                [_vp] * 6 + [_i] * 5 + [_ll] * 3 + [_vp, _vp]),
    "grassmann_backproject": ("grassmann_recovery_launch",
                              [_vp] * 6 + [_i] * 5 + [_ll] * 3 + [_vp, _vp]),
}
# the tallest matrix project_tangent_colnorms takes in one launch: 16 CTAs
# of a cluster x 128 rows each (tangent_front_max_m() of its library)
MAX_FRONT_M = 2048


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    if name == "grad_tap":
        lib.grad_tap_scratch_bytes.argtypes = [_i] * 5
        lib.grad_tap_scratch_bytes.restype = _ll
    if name == "fused_update":
        lib.fused_update_scratch_bytes.argtypes = [_i] * 4
        lib.fused_update_scratch_bytes.restype = _ll
        lib.fused_update_split_direction_launch.argtypes = [_vp] * 5 + [
            _i] * 4 + [_vp]
        lib.fused_update_split_direction_launch.restype = _i
    if name == "grassmann_backproject":
        lib.backproject_scratch_bytes.argtypes = [_i] * 4
        lib.backproject_scratch_bytes.restype = _ll
        lib.backproject_wgmma_launch.argtypes = [_vp] * 4 + [_i] * 4 + [
            _vp, _vp]
        lib.backproject_wgmma_launch.restype = _i
    if name == "grassmann_project":
        lib.grassmann_project_r_pad.argtypes = [_i]
        lib.grassmann_project_r_pad.restype = _i
        lib.grassmann_split_bf16_launch.argtypes = [_vp, _vp] + [_i] * 3 + [
            _vp]
        lib.grassmann_split_bf16_launch.restype = _i
    if name == "grassmann_tangent_gram":
        lib.grassmann_tangent_gram_scratch_bytes.argtypes = [_i] * 3
        lib.grassmann_tangent_gram_scratch_bytes.restype = _ll
    if name == "grassmann_tangent":
        lib.grassmann_tangent_scratch_bytes.argtypes = [_i] * 5
        lib.grassmann_tangent_scratch_bytes.restype = _ll
    if name == "grassmann_tangent_front":
        lib.tangent_front_scratch_bytes.argtypes = [_i] * 5
        lib.tangent_front_scratch_bytes.restype = _ll
        lib.tangent_front_max_m.argtypes = []
        lib.tangent_front_max_m.restype = _i
        lib.tangent_front_active_clusters.argtypes = [_i]
        lib.tangent_front_active_clusters.restype = _i
    return lib


def _launch(name: str, *args) -> None:
    lib = _lib(name)
    err = getattr(lib, _SIGNATURES[name][0])(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")


def _device(**tensors) -> torch.device:
    """The one CUDA device every given tensor lies on, or raise."""
    devs = {t.device for t in tensors.values() if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError("the kernel needs every tensor on one CUDA device; "
                         f"got {sorted(str(d) for d in devs)}")
    return next(iter(devs))


def _fp32_contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _shape(name: str, t: torch.Tensor, want: tuple) -> None:
    if tuple(t.shape) != tuple(want):
        raise ValueError(f"{name} has shape {tuple(t.shape)}; expected "
                         f"{tuple(want)}")


def _float_dtype(name: str, t: torch.Tensor) -> int:
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16; got {t.dtype}")
    return _DTYPES[t.dtype]


def _stack3(t: torch.Tensor) -> torch.Tensor:
    """(..., a, b) -> (batch, a, b); a view for 2-D and 3-D tensors."""
    return t.unsqueeze(0) if t.dim() == 2 else t.reshape(-1, *t.shape[-2:])


def _stream(dev: torch.device) -> int:
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


# the routes grassmann_project_launch reports (bit 4: G staged K-major)
PROJECT_ROUTES = {0: "cuda-cores", 1: "wgmma-tma", 2: "wgmma-loads",
                  5: "wgmma-tma-kmajor", 6: "wgmma-loads-kmajor"}
# ... grassmann_tangent_launch (bit 4: G staged MN-major, a transposed view)
TANGENT_ROUTES = {0: "cuda-cores", 1: "wgmma-tma", 2: "wgmma-loads",
                  5: "wgmma-tma-mnmajor", 6: "wgmma-loads-mnmajor"}
# ... tangent_front_launch (bit 4: a transposed view)
FRONT_ROUTES = {0: "cuda-cores", 1: "wgmma-tma", 2: "wgmma-loads",
                5: "wgmma-tma-transposed", 6: "wgmma-loads-transposed"}
# ... grassmann_tangent_gram_launch (bit 4: G staged K-major, a transposed
# view; 0: fp32 G's T^T G on the CUDA cores, its Grams on the tensor cores)
GRAM_ROUTES = {0: "cuda-cores-ttg", 1: "wgmma-tma", 2: "wgmma-loads",
               5: "wgmma-tma-kmajor", 6: "wgmma-loads-kmajor"}


def _project(S: torch.Tensor, G: torch.Tensor, norms: bool):
    """Returns (A, gsq or None, route name).  bf16 G takes the tensor
    cores: the wrapper allocates the (batch, 3, m, r_pad) split of S the
    kernel writes first; fp32 G takes the CUDA-core GEMM."""
    if G.dim() < 2:
        raise ValueError(f"G must be (..., m, n); got {tuple(G.shape)}")
    lead, (m, n) = tuple(G.shape[:-2]), tuple(G.shape[-2:])
    r = S.shape[-1]
    _shape("S", S, lead + (m, r))
    _fp32_contiguous(S=S)
    dtype = _float_dtype("G", G)
    dev = _device(S=S, G=G)
    G3 = _stack3(G)
    batch = G3.shape[0]
    A = torch.empty((batch, r, n), dtype=torch.float32, device=dev)
    gsq = (torch.empty((batch, n), dtype=torch.float32, device=dev)
           if norms else None)
    scratch = None
    if G.dtype == torch.bfloat16:
        r_pad = _lib("grassmann_project").grassmann_project_r_pad(r)
        scratch = torch.empty((batch, 3, m, r_pad), dtype=torch.bfloat16,
                              device=dev)
    route = ctypes.c_int(-1)
    _launch("grassmann_project", S.data_ptr(), G3.data_ptr(), A.data_ptr(),
            gsq.data_ptr() if norms else None,
            None if scratch is None else scratch.data_ptr(), dtype,
            int(norms), batch, m, n, r, *G3.stride(), ctypes.byref(route),
            _stream(dev))
    return (A.reshape(lead + (r, n)),
            gsq.reshape(lead + (n,)) if norms else None,
            PROJECT_ROUTES[route.value])


def project(S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """A = S^T G.  S (..., m, r) fp32; G (..., m, n) fp32 or bf16, any
    strides -> (..., r, n) fp32.  ``project.route`` names the route of the
    last call (``PROJECT_ROUTES``)."""
    A, _, project.route = _project(S, G, norms=False)
    project.launches += 1
    return A


def project_colnorms(S: torch.Tensor, G: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(A = S^T G, ||G_:,j||^2) from one read of G -> ((..., r, n),
    (..., n)) fp32.  ``project_colnorms.route`` names the last call's
    route."""
    A, gsq, project_colnorms.route = _project(S, G, norms=True)
    project_colnorms.launches += 1
    return A, gsq


def split_bf16(S: torch.Tensor) -> torch.Tensor:
    """The bf16 route's first kernel alone: S (..., m, r) fp32 contiguous
    -> (..., 3, m, r_pad) bf16 (S_hi, S_mid, S_lo; ``ref.split_bf16_ref``).
    Not a wrapper of its own: ``project`` and ``project_colnorms`` launch
    it and count it as theirs."""
    if S.dim() < 2:
        raise ValueError(f"S must be (..., m, r); got {tuple(S.shape)}")
    _fp32_contiguous(S=S)
    dev = _device(S=S)
    lead, (m, r) = tuple(S.shape[:-2]), tuple(S.shape[-2:])
    batch = _stack3(S).shape[0]
    lib = _lib("grassmann_project")
    out = torch.empty(lead + (3, m, lib.grassmann_project_r_pad(r)),
                      dtype=torch.bfloat16, device=dev)
    err = lib.grassmann_split_bf16_launch(S.data_ptr(), out.data_ptr(), batch,
                                          m, r, _stream(dev))
    if err:
        raise RuntimeError("split_bf16 launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    return out


def tangent(G: torch.Tensor, A: torch.Tensor,
            S: torch.Tensor) -> torch.Tensor:
    """T = -2 G A^T + 2 S (A A^T) -> (..., m, r) fp32.  bf16 G takes the
    tensor cores: A, S and the Gram 2 A A^T split in three bf16 terms
    (pre-passes and a Gram kernel inside the call, into a wrapper-allocated
    scratch of 256 MiB at most, or one matrix's split where that is more,
    a chunk of the stack at a time).  fp32 G takes the CUDA cores, with the
    (r, r) Gram formed before the launch, as the TPU wrapper forms it
    outside its kernel (``repro/kernels/grassmann.py:205``).
    ``tangent.route`` names the last call's route (``TANGENT_ROUTES``)."""
    if G.dim() < 2:
        raise ValueError(f"G must be (..., m, n); got {tuple(G.shape)}")
    lead, (m, n) = tuple(G.shape[:-2]), tuple(G.shape[-2:])
    r = S.shape[-1]
    _shape("S", S, lead + (m, r))
    _shape("A", A, lead + (r, n))
    _fp32_contiguous(S=S, A=A)
    dtype = _float_dtype("G", G)
    dev = _device(G=G, A=A, S=S)
    C2 = 2.0 * (A @ A.mT) if dtype == 0 else None   # (..., r, r)
    G3 = _stack3(G)
    batch = G3.shape[0]
    T = torch.empty((batch, m, r), dtype=torch.float32, device=dev)
    scratch = torch.empty(
        (_lib("grassmann_tangent").grassmann_tangent_scratch_bytes(
            batch, m, n, r, dtype),), dtype=torch.uint8, device=dev)
    route = ctypes.c_int(-1)
    _launch("grassmann_tangent", G3.data_ptr(), A.data_ptr(), S.data_ptr(),
            None if C2 is None else C2.data_ptr(), T.data_ptr(),
            scratch.data_ptr(), dtype, batch, m, n, r, *G3.stride(),
            ctypes.byref(route), _stream(dev))
    tangent.route = TANGENT_ROUTES[route.value]
    tangent.launches += 1
    return T.reshape(lead + (m, r))


def tangent_gram(S: torch.Tensor, T: torch.Tensor, G: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """(T^T G, S^T T, T^T T, S^T S) from one call: S, T (..., m, r) fp32
    contiguous; G (..., m, n) fp32 or bf16, any strides -> ((..., r, n),
    (..., r, r) x 3) fp32.  Each output tile is owned by one CTA, which
    sums over all of m itself: deterministic, no shape gate, T^T T and S^T S
    exactly symmetric.  On the tensor cores: S and T split in three bf16
    terms (pre-passes into a wrapper-allocated scratch of 256 MiB at most,
    or one matrix's split where that is more, a chunk of the stack at a
    time), the Grams over 6 term products, bf16 G's T^T G over 3 (G one
    exact term), all in one persistent launch per chunk.  fp32 G's T^T G
    takes the CUDA cores.  ``tangent_gram.route`` names the last call's
    route (``GRAM_ROUTES``)."""
    if G.dim() < 2:
        raise ValueError(f"G must be (..., m, n); got {tuple(G.shape)}")
    lead, (m, n) = tuple(G.shape[:-2]), tuple(G.shape[-2:])
    r = S.shape[-1]
    _shape("S", S, lead + (m, r))
    _shape("T", T, lead + (m, r))
    _fp32_contiguous(S=S, T=T)
    dtype = _float_dtype("G", G)
    dev = _device(S=S, T=T, G=G)
    G3 = _stack3(G)
    batch = G3.shape[0]
    TtG = torch.empty((batch, r, n), dtype=torch.float32, device=dev)
    StT, TtT, StS = (torch.empty((batch, r, r), dtype=torch.float32,
                                 device=dev) for _ in range(3))
    scratch = torch.empty(
        (_lib("grassmann_tangent_gram").grassmann_tangent_gram_scratch_bytes(
            batch, m, r),), dtype=torch.uint8, device=dev)
    route = ctypes.c_int(-1)
    _launch("grassmann_tangent_gram", S.data_ptr(), T.data_ptr(),
            G3.data_ptr(), TtG.data_ptr(), StT.data_ptr(), TtT.data_ptr(),
            StS.data_ptr(), scratch.data_ptr(), dtype, batch, m, n, r,
            *G3.stride(), ctypes.byref(route), _stream(dev))
    tangent_gram.route = GRAM_ROUTES[route.value]
    tangent_gram.launches += 1
    return (TtG.reshape(lead + (r, n)), StT.reshape(lead + (r, r)),
            TtT.reshape(lead + (r, r)), StS.reshape(lead + (r, r)))


def project_tangent_colnorms(S: torch.Tensor, G: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(A = S^T G, ||G_:,j||^2, T = -2 W + 2 S (S^T W)) with W = G A^T,
    from one read of G: S (..., m, r) fp32 contiguous, G (..., m, n) fp32
    or bf16, any strides -> ((..., r, n), (..., n), (..., m, r)) fp32.
    Takes m <= MAX_FRONT_M and raises ValueError past it.  bf16 G sweeps
    on the tensor cores and runs the tail (S^T W, then T) on them after
    the sweep, within the call (S and W split in three bf16 terms into a
    wrapper-allocated scratch, 256 MiB at most, a chunk of the stack at a
    time); fp32 G runs on the CUDA cores in one launch.
    ``project_tangent_colnorms.route`` names the last call's route
    (``FRONT_ROUTES``)."""
    if G.dim() < 2:
        raise ValueError(f"G must be (..., m, n); got {tuple(G.shape)}")
    lead, (m, n) = tuple(G.shape[:-2]), tuple(G.shape[-2:])
    r = S.shape[-1]
    if m > MAX_FRONT_M:
        raise ValueError(f"m = {m} is past the single launch's limit of "
                         f"{MAX_FRONT_M} rows (16 CTAs x 128)")
    _shape("S", S, lead + (m, r))
    _fp32_contiguous(S=S)
    dtype = _float_dtype("G", G)
    dev = _device(S=S, G=G)
    G3 = _stack3(G)
    batch = G3.shape[0]
    A = torch.empty((batch, r, n), dtype=torch.float32, device=dev)
    gsq = torch.empty((batch, n), dtype=torch.float32, device=dev)
    T = torch.empty((batch, m, r), dtype=torch.float32, device=dev)
    lib = _lib("grassmann_tangent_front")
    scratch = torch.empty(
        (lib.tangent_front_scratch_bytes(batch, m, n, r, dtype),),
        dtype=torch.uint8, device=dev)
    route = ctypes.c_int(-1)
    _launch("grassmann_tangent_front", S.data_ptr(), G3.data_ptr(),
            A.data_ptr(), gsq.data_ptr(), T.data_ptr(), scratch.data_ptr(),
            dtype, batch, m, n, r, *G3.stride(), ctypes.byref(route),
            _stream(dev))
    project_tangent_colnorms.route = FRONT_ROUTES[route.value]
    project_tangent_colnorms.launches += 1
    return (A.reshape(lead + (r, n)), gsq.reshape(lead + (n,)),
            T.reshape(lead + (m, r)))


def _backproject_shapes(S, X):
    if S.dim() < 2 or X.dim() < 2:
        raise ValueError("S and X must be (..., m, r) and (..., r, n)")
    lead, (m, r) = tuple(S.shape[:-2]), tuple(S.shape[-2:])
    n = X.shape[-1]
    _shape("X", X, lead + (r, n))
    return lead, m, n, r


def backproject(S: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Ghat = S X: S (..., m, r), X (..., r, n), both fp32 contiguous ->
    (..., m, n) fp32, on the tensor cores (S and X split in three bf16
    terms, 6 term products; ``backproject.route`` is ``wgmma-tma``)."""
    lead, m, n, r = _backproject_shapes(S, X)
    _fp32_contiguous(S=S, X=X)
    dev = _device(S=S, X=X)
    batch = _stack3(S).shape[0]
    out = torch.empty((batch, m, n), dtype=torch.float32, device=dev)
    lib = _lib("grassmann_backproject")
    scratch = torch.empty((lib.backproject_scratch_bytes(batch, m, n, r),),
                          dtype=torch.uint8, device=dev)
    route = ctypes.c_int(-1)
    err = lib.backproject_wgmma_launch(
        S.data_ptr(), X.data_ptr(), out.data_ptr(), scratch.data_ptr(), batch,
        m, n, r, ctypes.byref(route), _stream(dev))
    if err:
        raise RuntimeError("backproject launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    backproject.route = BACKPROJECT_ROUTES[route.value]
    backproject.launches += 1
    return out.reshape(lead + (m, n))


def recovery(S: torch.Tensor, G: torch.Tensor, Gt: torch.Tensor,
             phi: torch.Tensor) -> torch.Tensor:
    """Lam = (G - S Gt) * phi[..., None, :]: S (..., m, r), Gt (..., r, n)
    and phi (..., n) fp32 contiguous; G (..., m, n) fp32 or bf16, any
    strides -> (..., m, n) fp32.  ``backproject``'s main loop (S and Gt
    split in three bf16 terms, 6 term products on the tensor cores) with G
    and phi read in its epilogue, so one route for every dtype;
    ``recovery.route`` is ``wgmma-tma``."""
    lead, m, n, r = _backproject_shapes(S, Gt)
    _fp32_contiguous(S=S, Gt=Gt, phi=phi)
    _shape("G", G, lead + (m, n))
    _shape("phi", phi, lead + (n,))
    dtype = _float_dtype("G", G)
    dev = _device(S=S, Gt=Gt, G=G, phi=phi)
    batch = _stack3(S).shape[0]
    G3 = _stack3(G)
    out = torch.empty((batch, m, n), dtype=torch.float32, device=dev)
    scratch = torch.empty(
        (_lib("grassmann_backproject").backproject_scratch_bytes(
            batch, m, n, r),), dtype=torch.uint8, device=dev)
    route = ctypes.c_int(-1)
    _launch("grassmann_backproject", S.data_ptr(), Gt.data_ptr(),
            G3.data_ptr(), phi.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            dtype, batch, m, n, r, *G3.stride(), ctypes.byref(route),
            _stream(dev))
    recovery.route = RECOVERY_ROUTES[route.value]
    recovery.launches += 1
    return out.reshape(lead + (m, n))


def bias_corrections(step: int, beta1: float, beta2: float,
                     bias_correction: bool = True) -> tuple[float, float]:
    """(1 / (1 - beta1^t), 1 / (1 - beta2^t)) with t = step + 1, in fp32
    as the reference computes them (``repro/kernels/grassmann.py:713``)."""
    if not bias_correction:
        return 1.0, 1.0
    t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
    return (float(1.0 / (1.0 - beta1 ** t)), float(1.0 / (1.0 - beta2 ** t)))


def _adam(Gt, M, V, step, beta1, beta2, eps, bias_correction, norms):
    _fp32_contiguous(Gt=Gt, M=M, V=V)
    _shape("M", M, Gt.shape)
    _shape("V", V, Gt.shape)
    if Gt.dim() < 2:
        raise ValueError(f"Gt must be (..., r, n); got {tuple(Gt.shape)}")
    dev = _device(Gt=Gt, M=M, V=V)
    lead, (r, n) = tuple(Gt.shape[:-2]), tuple(Gt.shape[-2:])
    batch = _stack3(Gt).shape[0]
    M1, V1, Gto = (torch.empty_like(Gt) for _ in range(3))
    # no norm outputs (null pointers) compiles the norms out of the kernel
    gtsq, gtosq = ((torch.empty(lead + (n,), dtype=torch.float32, device=dev)
                    for _ in range(2)) if norms else (None, None))
    bc1, bc2 = bias_corrections(step, beta1, beta2, bias_correction)
    _launch("adam_lowrank_norms", Gt.data_ptr(), M.data_ptr(), V.data_ptr(),
            M1.data_ptr(), V1.data_ptr(), Gto.data_ptr(),
            gtsq.data_ptr() if norms else None,
            gtosq.data_ptr() if norms else None, batch, r, n, beta1,
            1.0 - beta1, beta2, 1.0 - beta2, bc1, bc2, eps, _stream(dev))
    return (M1, V1, Gto, gtsq, gtosq) if norms else (M1, V1, Gto)


def adam_lowrank_norms(Gt: torch.Tensor, M: torch.Tensor, V: torch.Tensor,
                       step: int, *, beta1: float = 0.9, beta2: float = 0.999,
                       eps: float = 1e-8, bias_correction: bool = True):
    """(M', V', Gto, ||Gt_:,j||^2, ||Gto_:,j||^2) from one (r, n) pass.
    Gt, M, V (..., r, n) fp32 contiguous; ``step`` the 0-based Python int
    count of updates applied so far."""
    out = _adam(Gt, M, V, step, beta1, beta2, eps, bias_correction, True)
    adam_lowrank_norms.launches += 1
    return out


def adam_lowrank(Gt: torch.Tensor, M: torch.Tensor, V: torch.Tensor,
                 step: int, *, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, bias_correction: bool = True):
    """(M', V', Gto): ``adam_lowrank_norms`` without the column norms, the
    same kernel with its norms compiled out.  Same contract."""
    out = _adam(Gt, M, V, step, beta1, beta2, eps, bias_correction, False)
    adam_lowrank.launches += 1
    return out


def _per_matrix_column(x, lead: tuple, dev) -> torch.Tensor:
    """A per-matrix scalar (float or tensor of the batch shape) as a flat
    fp32 vector on the device, without a host sync."""
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=torch.float32).expand(lead).reshape(-1)
    return torch.full(lead, float(x), dtype=torch.float32,
                      device=dev).reshape(-1)


# the routes fused_update_launch, grad_tap_launch, backproject_wgmma_launch
# and grassmann_recovery_launch report
UPDATE_ROUTES = BACKPROJECT_ROUTES = RECOVERY_ROUTES = {1: "wgmma-tma"}
TAP_ROUTES = {0: "cuda-cores", 1: "wgmma-tma", 2: "wgmma-loads"}


def _scalars(lead, dev, *xs) -> torch.Tensor:
    """Per-matrix scalars as a (batch, len(xs)) fp32 device array."""
    return torch.stack([_per_matrix_column(x, lead, dev) for x in xs],
                       dim=-1).contiguous()


def fused_update(G, S, Gt, Gto, phi, coef, clip, *, out_dtype=None,
                 param=None, wd_coef=None) -> torch.Tensor:
    """upd = -coef (S Gto + (G - S Gt) phi clip) [- wd_coef param] written
    once in ``out_dtype``.  ``G=None`` (with Gt, phi None) is the
    no-recovery variant.  coef, clip and wd_coef are per-matrix: floats or
    tensors of the batch shape, passed to the kernel as a (batch, 3) device
    array.  G and ``param`` may be strided views; the update is allocated
    in G's layout (else the parameter's), so a transposed canonical view
    of a leaf comes back in the leaf's own layout.  One route for every
    dtype: S and D = Gto - (phi clip) Gt split into three bf16 terms each
    (a wrapper-allocated scratch of 256 MiB at most, or one matrix's split
    where that is more, a chunk of the stack at a time), 6 term products on
    the tensor cores; ``fused_update.route`` names it."""
    recovery, decay = G is not None, param is not None
    if S.dim() < 2 or Gto.dim() < 2:
        raise ValueError("S and Gto must be (..., m, r) and (..., r, n)")
    lead, (m, r) = tuple(S.shape[:-2]), tuple(S.shape[-2:])
    n = Gto.shape[-1]
    out_dtype = out_dtype or torch.float32
    _shape("Gto", Gto, lead + (r, n))
    _fp32_contiguous(S=S, Gto=Gto, Gt=Gt, phi=phi)
    if recovery:
        _shape("G", G, lead + (m, n))
        _shape("Gt", Gt, lead + (r, n))
        _shape("phi", phi, lead + (n,))
    if decay:
        _shape("param", param, lead + (m, n))
        if param.dtype != out_dtype:
            raise ValueError(f"param dtype {param.dtype} differs from the "
                             f"output dtype {out_dtype}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"output dtype must be float32 or bfloat16; got "
                         f"{out_dtype}")
    g_dtype = _float_dtype("G", G) if recovery else 0
    dev = _device(S=S, Gto=Gto, G=G, Gt=Gt, phi=phi, param=param)
    batch = _stack3(S).shape[0]
    scalars = _scalars(lead, dev, coef, clip,
                       0.0 if wd_coef is None else wd_coef)
    G3 = _stack3(G) if recovery else None
    P3 = _stack3(param) if decay else None
    like = G3 if recovery else P3
    out3 = (torch.empty_like(like, dtype=out_dtype) if like is not None
            else torch.empty((batch, m, n), dtype=out_dtype, device=dev))
    strides = [(ctypes.c_longlong * 3)(*(t.stride() if t is not None
                                         else (0, 0, 0)))
               for t in (G3, P3, out3)]
    lib = _lib("fused_update")
    scratch = torch.empty((lib.fused_update_scratch_bytes(batch, m, n, r),),
                          dtype=torch.uint8, device=dev)
    route = ctypes.c_int(-1)
    _launch("fused_update", S.data_ptr(), Gto.data_ptr(),
            Gt.data_ptr() if recovery else None,
            phi.data_ptr() if recovery else None, scalars.data_ptr(),
            G3.data_ptr() if recovery else None, strides[0],
            P3.data_ptr() if decay else None, strides[1], out3.data_ptr(),
            strides[2], scratch.data_ptr(), g_dtype, _DTYPES[out_dtype],
            int(recovery), int(decay), batch, m, n, r, ctypes.byref(route),
            _stream(dev))
    fused_update.route = UPDATE_ROUTES[route.value]
    fused_update.launches += 1
    return out3.reshape(lead + (m, n))


def split_direction(Gto: torch.Tensor, Gt: torch.Tensor | None,
                    phi: torch.Tensor | None, clip) -> torch.Tensor:
    """``fused_update``'s second pre-pass alone: D = Gto - (phi clip) Gt
    (or Gto when Gt is None) as three bf16 terms -> (..., 3, r, n)
    (``ref.split_direction_ref``).  Not a wrapper of its own: no path calls
    it, and it does not count."""
    if Gto.dim() < 2:
        raise ValueError(f"Gto must be (..., r, n); got {tuple(Gto.shape)}")
    recovery = Gt is not None
    _fp32_contiguous(Gto=Gto, Gt=Gt, phi=phi)
    lead, (r, n) = tuple(Gto.shape[:-2]), tuple(Gto.shape[-2:])
    dev = _device(Gto=Gto, Gt=Gt, phi=phi)
    batch = _stack3(Gto).shape[0]
    scalars = _scalars(lead, dev, 0.0, clip, 0.0)
    out = torch.empty(lead + (3, r, n), dtype=torch.bfloat16, device=dev)
    lib = _lib("fused_update")
    err = lib.fused_update_split_direction_launch(
        Gto.data_ptr(), Gt.data_ptr() if recovery else None,
        phi.data_ptr() if recovery else None, scalars.data_ptr(),
        out.data_ptr(), int(recovery), batch, r, n, _stream(dev))
    if err:
        raise RuntimeError("split_direction launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    return out


def _grad_tap(x, dy, S, out_dtype, transposed_out, stages):
    if x.dim() != 2 or dy.dim() != 2:
        raise ValueError(f"x and dy must be (b, m) and (b, n); got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    (b, m), n = tuple(x.shape), dy.shape[1]
    if dy.shape[0] != b:
        raise ValueError(f"x has {b} rows, dy {dy.shape[0]}")
    if S.dim() != 2 or S.shape[0] != m:
        raise ValueError(f"S must be ({m}, r); got {tuple(S.shape)}")
    r = S.shape[1]
    _fp32_contiguous(S=S)
    dtype = _float_dtype("x", x)
    if dy.dtype != x.dtype:
        raise ValueError(f"x is {x.dtype} but dy is {dy.dtype}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"dW dtype must be float32 or bfloat16; got "
                         f"{out_dtype}")
    dev = _device(x=x, dy=dy, S=S)
    dW = (torch.empty((n, m), dtype=out_dtype, device=dev).mT
          if transposed_out else
          torch.empty((m, n), dtype=out_dtype, device=dev))
    tap = torch.empty((r + 1, n), dtype=torch.float32, device=dev)
    scratch = torch.empty((_lib("grad_tap").grad_tap_scratch_bytes(
                              b, m, n, r, dtype),),
                          dtype=torch.uint8, device=dev)
    route = ctypes.c_int(-1)
    _launch("grad_tap", x.data_ptr(), dy.data_ptr(), S.data_ptr(),
            dW.data_ptr(), tap.data_ptr(), scratch.data_ptr(), dtype,
            _DTYPES[out_dtype], stages, b, m, n, r, *x.stride(),
            *dy.stride(), *dW.stride(), ctypes.byref(route), _stream(dev))
    grad_tap.route = TAP_ROUTES[route.value]
    return dW, tap


def grad_tap(x: torch.Tensor, dy: torch.Tensor, S: torch.Tensor, *,
             out_dtype: torch.dtype = torch.float32,
             transposed_out: bool = False):
    """(dW = x^T dy, tap = [A; gsq]) from one call: x (b, m) and dy (b, n)
    of one float dtype, any strides; S (m, r) fp32 contiguous -> dW (m, n)
    in ``out_dtype`` and the (r+1, n) fp32 tap, rows [0:r] A = S^T dW and
    row r the column norms ||dW_:,j||^2, both from the fp32 dW.
    ``transposed_out`` stores dW in (n, m) row-major memory and returns the
    (m, n) view of it, so a transposed leaf's gradient lands in the leaf's
    own layout.  Any b: the token extent streams through the tiles.  bf16
    x and dy take the tensor cores (TMA where x and dy have a tensor map,
    element loads otherwise), fp32 the CUDA cores; ``grad_tap.route``
    names the last call's route (``TAP_ROUTES``).  One call launches
    several kernels (S's split, then the P and dW tiles, then the A tiles;
    fp32: P, then the dW and A tiles) and counts once."""
    out = _grad_tap(x, dy, S, out_dtype, transposed_out, stages=3)
    grad_tap.launches += 1
    return out


def grad_tap_xs(x: torch.Tensor, dy: torch.Tensor, S: torch.Tensor) -> None:
    """Only grad_tap's P = x S (bf16: S's split and the P tiles alone), on
    grad_tap's inputs, so that it can be timed apart.  No path calls it,
    and it does not count."""
    _grad_tap(x, dy, S, torch.float32, False, stages=1)


for _fn in (project, project_colnorms, tangent, tangent_gram,
            project_tangent_colnorms, backproject, recovery,
            adam_lowrank_norms, adam_lowrank, fused_update, grad_tap):
    _fn.launches = 0          # kernel launches since the last reset
# route of the last call
project.route = project_colnorms.route = fused_update.route = None
tangent.route = project_tangent_colnorms.route = grad_tap.route = None
backproject.route = recovery.route = tangent_gram.route = None
