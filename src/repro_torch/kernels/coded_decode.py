"""Fused coded block matmul + erasure decode, as a hand-written CUDA kernel.

``coded_matvec_decode_cuda`` launches ``csrc/coded_decode.cu`` (the port of
the Pallas ``repro.kernels.coded_decode.coded_matvec_decode_pallas``):
y = R · blocked(W_c x), decoded inside the kernel so the coded partials
never reach device memory.  Its plain version is
``repro_torch.kernels.ref.ref_coded_matvec_decode``; the mode-switching
wrapper is ``repro_torch.kernels.ops.coded_matvec_decode``.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["MAX_B", "MAX_BLOCKS", "coded_matvec_decode_cuda"]

MAX_B = 16        # widest x the kernel takes (decode batch = n_slots)
MAX_BLOCKS = 32   # most code blocks (the mask-keyed cache stops at 20)


def _lib():
    from repro_torch.kernels._build import load

    lib = load("coded_decode")
    fn = lib.coded_matvec_decode
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def coded_matvec_decode_cuda(
    w_coded: torch.Tensor, x: torch.Tensor, rec: torch.Tensor
) -> torch.Tensor:
    """w_coded [nb*br, M], x [M] or [M, B] (B <= 16), rec [n_data, nb] —
    all fp32, contiguous, on one CUDA device -> y [n_data*br(, B)] fp32."""
    for name, t in (("w_coded", w_coded), ("x", x), ("rec", rec)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != w_coded.device:
            raise ValueError(f"{name} is on {t.device}, w_coded on {w_coded.device}")
    squeeze = x.dim() == 1
    xc = x[:, None] if squeeze else x
    if w_coded.dim() != 2 or xc.dim() != 2 or rec.dim() != 2:
        raise ValueError("w_coded and rec must be 2-D, x 1-D or 2-D")
    rows, m = w_coded.shape
    n_data, nb = rec.shape
    b = xc.shape[1]
    if xc.shape[0] != m:
        raise ValueError(f"x has {xc.shape[0]} rows, w_coded has {m} columns")
    if not 1 <= nb <= MAX_BLOCKS or not 1 <= n_data <= nb:
        raise ValueError(f"rec [{n_data}, {nb}] outside 1 <= n_data <= nb <= {MAX_BLOCKS}")
    if rows % nb or rows == 0 or m == 0:
        raise ValueError(f"{rows} coded rows not a positive multiple of {nb} blocks")
    if not 1 <= b <= MAX_B:
        raise ValueError(f"x has {b} columns; the kernel takes 1..{MAX_B}")
    br = rows // nb
    out = torch.empty((n_data * br, b), dtype=torch.float32, device=w_coded.device)
    fn = _lib()
    with torch.cuda.device(w_coded.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(w_coded.data_ptr(), xc.data_ptr(), rec.data_ptr(), out.data_ptr(),
                 br, m, b, nb, n_data, stream)
    coded_matvec_decode_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"coded_matvec_decode launch failed: cudaError {err}")
    return out[:, 0] if squeeze else out


coded_matvec_decode_cuda.launches = 0
