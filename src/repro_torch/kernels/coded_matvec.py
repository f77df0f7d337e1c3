"""Coded matvec y = A x, as a hand-written CUDA kernel.

``coded_matvec_cuda`` launches ``csrc/coded_matvec.cu`` (the port of the
Pallas ``repro.kernels.coded_matvec.coded_matvec_pallas``): one worker's,
or one code block's, product with fp32 sums, reading A once through the
thin-row engine ``csrc/thin_rows.cuh``, on the geometry of
``repro_torch.kernels.thin_rows.head_plan``.  The kernel takes up to
``MAX_B`` columns of x; a wider x runs in column panels
(``thin_rows.column_panels``), one launch (and one read of A) a panel.
Its plain version is ``repro_torch.kernels.ref.ref_coded_matvec``; the
mode-switching wrapper is ``repro_torch.kernels.ops.coded_matvec``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import count_launch, refuse_grad, thin_rows
from repro_torch.kernels._build import c_function

__all__ = ["MAX_B", "coded_matvec_cuda"]

MAX_B = thin_rows.MAX_B  # widest x one launch takes; wider runs in panels
_DTYPES = (torch.float32, torch.float16)


def coded_matvec_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a [R, M], x [M] or [M, B] (any B >= 1) — both fp32 or both fp16,
    contiguous, on one CUDA device -> y [R(, B)] fp32.  ``a`` may be a row
    view (a code block of a coded weight) at any element offset.  B > 16
    runs in ceil(B / 16) column panels, each one launch, counted."""
    refuse_grad(coded_matvec_cuda, a, x)
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
    if a.dim() != 2 or x.dim() not in (1, 2):
        raise ValueError("a must be 2-D, x 1-D or 2-D")
    r, m = a.shape
    b = x.shape[1] if x.dim() == 2 else 1   # x [M] is x [M, 1] in memory, and y [R] y [R, 1]
    if x.shape[0] != m:
        raise ValueError(f"x has {x.shape[0]} rows, a has {m} columns")
    if r == 0 or m == 0:
        raise ValueError(f"empty product: a {tuple(a.shape)}")
    if b < 1:
        raise ValueError("x has no columns")
    if b > MAX_B:
        return torch.cat([_launch(a, x[:, lo:hi].contiguous(), hi - lo)
                          for lo, hi in thin_rows.column_panels(b)], dim=1)
    return _launch(a, x, b)


coded_matvec_cuda.launches = 0
coded_matvec_cuda.captured = 0


def _launch(a: torch.Tensor, x: torch.Tensor, b: int) -> torch.Tensor:
    """One launch on checked inputs, x of at most MAX_B columns."""
    r, m = a.shape
    out = torch.empty((r, b) if x.dim() == 2 else (r,), dtype=torch.float32, device=a.device)
    half = a.dtype == torch.float16
    vec = m % (8 if half else 4) == 0 and a.data_ptr() % 16 == 0
    plan = _plan(a.device, r, m, b, half, vec)
    err = thin_rows.call_on(a.device, _entry(), a.data_ptr(), x.data_ptr(), out.data_ptr(), r,
                            m, b, int(half), int(vec), plan.grid, plan.group_rows,
                            plan.x_panel, plan.smem_bytes)
    count_launch(coded_matvec_cuda)
    if err != 0:
        raise RuntimeError(f"coded_matvec launch failed: cudaError {err}")
    return out


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return c_function("coded_matvec", "coded_matvec",
                      [p, p, p, ctypes.c_longlong, ctypes.c_longlong, i, i, i, i, i, i, i, p])


@functools.lru_cache(maxsize=None)
def _plan(device: torch.device, r: int, m: int, b: int, half: bool,
          vec: bool) -> thin_rows.HeadPlan:
    dev = device.index if device.index is not None else torch.cuda.current_device()
    return thin_rows.head_plan(r, m, b, sm_count=thin_rows.sm_count(dev),
                               occupancy=lambda smem: _occupancy(dev, b, half, vec, smem))


def _occupancy(device_index: int, b: int, half: bool, vec: bool, smem: int) -> int:
    fn = c_function("coded_matvec", "coded_matvec_occupancy",
                    [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(b, int(half), int(vec), smem, ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"coded_matvec occupancy query failed: cudaError {err}")
    return blocks.value
