"""Dense encode Â = G A, as a hand-written CUDA kernel.

``gaussian_encode_cuda`` launches ``csrc/gaussian_encode.cu`` (the port of
the Pallas ``repro.kernels.lt_encode.gaussian_encode_pallas``), a tiled
fp32 SGEMM for any [q, r] x [r, M].  Its plain version is
``repro_torch.kernels.ref.ref_gaussian_encode``; the mode-switching
wrappers are ``repro_torch.kernels.ops.gaussian_encode`` and
``encode_blocks_device``.  The LT gather-encode joins with the task form.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["gaussian_encode_cuda"]


def _lib():
    from repro_torch.kernels._build import load

    lib = load("gaussian_encode")
    fn = lib.gaussian_encode
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return fn


def gaussian_encode_cuda(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """g [q, r], a [r, M] — fp32, contiguous, on one CUDA device -> [q, M] fp32."""
    for name, t in (("g", g), ("a", a)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if a.device != g.device:
        raise ValueError(f"a is on {a.device}, g on {g.device}")
    q, r = g.shape
    r2, m = a.shape
    if r != r2:
        raise ValueError(f"generator has {r} columns, A has {r2} rows")
    if q == 0 or r == 0 or m == 0:
        raise ValueError(f"empty encode: g {tuple(g.shape)}, a {tuple(a.shape)}")
    out = torch.empty((q, m), dtype=torch.float32, device=a.device)
    fn = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), a.data_ptr(), out.data_ptr(), q, r, m, stream)
    gaussian_encode_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"gaussian_encode launch failed: cudaError {err}")
    return out


gaussian_encode_cuda.launches = 0
