"""Coded matvec y = A x, as a hand-written CUDA kernel.

``coded_matvec_cuda`` launches ``csrc/coded_matvec.cu`` (the port of the
Pallas ``repro.kernels.coded_matvec.coded_matvec_pallas``): one worker's,
or one code block's, product with fp32 sums, reading A once.  Its plain
version is ``repro_torch.kernels.ref.ref_coded_matvec``; the mode-switching
wrapper is ``repro_torch.kernels.ops.coded_matvec``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import c_function

__all__ = ["MAX_B", "coded_matvec_cuda"]

MAX_B = 16  # widest x the kernel takes (decode batch = n_slots)
_DTYPES = (torch.float32, torch.float16)


def coded_matvec_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a [R, M], x [M] or [M, B] (B <= 16) — both fp32 or both fp16,
    contiguous, on one CUDA device -> y [R(, B)] fp32.  ``a`` may be a row
    view (a code block of a coded weight) at any element offset."""
    for name, t in (("a", a), ("x", x)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or float16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
    if x.dtype != a.dtype:
        raise TypeError(f"a is {a.dtype} but x is {x.dtype}; the kernel takes one type")
    squeeze = x.dim() == 1
    xc = x[:, None] if squeeze else x
    if a.dim() != 2 or xc.dim() != 2:
        raise ValueError("a must be 2-D, x 1-D or 2-D")
    r, m = a.shape
    b = xc.shape[1]
    if xc.shape[0] != m:
        raise ValueError(f"x has {xc.shape[0]} rows, a has {m} columns")
    if r == 0 or m == 0:
        raise ValueError(f"empty product: a {tuple(a.shape)}")
    if not 1 <= b <= MAX_B:
        raise ValueError(f"x has {b} columns; the kernel takes 1..{MAX_B}")
    out = torch.empty((r, b), dtype=torch.float32, device=a.device)
    p = ctypes.c_void_p
    fn = c_function("coded_matvec", "coded_matvec",
                    [p, p, p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, p])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), xc.data_ptr(), out.data_ptr(), r, m, b,
                 int(a.dtype == torch.float16), stream)
    coded_matvec_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"coded_matvec launch failed: cudaError {err}")
    return out[:, 0] if squeeze else out


coded_matvec_cuda.launches = 0
