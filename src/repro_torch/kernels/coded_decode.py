"""Fused coded block matmul + erasure decode, as a hand-written CUDA kernel.

``coded_matvec_decode_cuda`` launches ``csrc/coded_decode.cu`` (the port of
the Pallas ``repro.kernels.coded_decode.coded_matvec_decode_pallas``):
y = R · blocked(W_c x), decoded inside the kernel so the coded partials
never reach device memory.  The row products stream through
``csrc/thin_rows.cuh`` on the geometry of
``repro_torch.kernels.thin_rows.head_plan``.  The kernel takes up to
``MAX_B`` columns of x; a wider x runs in column panels
(``thin_rows.column_panels``), one launch (and one read of W_c) a panel.
Its plain version is
``repro_torch.kernels.ref.ref_coded_matvec_decode``; the mode-switching
wrapper is ``repro_torch.kernels.ops.coded_matvec_decode``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import count_launch, refuse_grad, thin_rows
from repro_torch.kernels._build import c_function

__all__ = ["MAX_B", "MAX_BLOCKS", "coded_matvec_decode_cuda"]

MAX_B = thin_rows.MAX_B   # widest x one launch takes; wider runs in panels
MAX_BLOCKS = 32   # most code blocks (the mask-keyed cache stops at 20)


def coded_matvec_decode_cuda(
    w_coded: torch.Tensor, x: torch.Tensor, rec: torch.Tensor
) -> torch.Tensor:
    """w_coded [nb*br, M], x [M] or [M, B] (any B >= 1), rec [n_data, nb] —
    all fp32, contiguous, on one CUDA device -> y [n_data*br(, B)] fp32.
    B > 16 runs in ceil(B / 16) column panels, each one launch, counted."""
    refuse_grad(coded_matvec_decode_cuda, w_coded, x, rec)
    for name, t in (("w_coded", w_coded), ("x", x), ("rec", rec)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != w_coded.device:
            raise ValueError(f"{name} is on {t.device}, w_coded on {w_coded.device}")
    if w_coded.dim() != 2 or x.dim() not in (1, 2) or rec.dim() != 2:
        raise ValueError("w_coded and rec must be 2-D, x 1-D or 2-D")
    rows, m = w_coded.shape
    n_data, nb = rec.shape
    b = x.shape[1] if x.dim() == 2 else 1   # x [M] is x [M, 1] in memory, and y [N] y [N, 1]
    if x.shape[0] != m:
        raise ValueError(f"x has {x.shape[0]} rows, w_coded has {m} columns")
    if not 1 <= nb <= MAX_BLOCKS or not 1 <= n_data <= nb:
        raise ValueError(f"rec [{n_data}, {nb}] outside 1 <= n_data <= nb <= {MAX_BLOCKS}")
    if rows % nb or rows == 0 or m == 0:
        raise ValueError(f"{rows} coded rows not a positive multiple of {nb} blocks")
    if b < 1:
        raise ValueError("x has no columns")
    if b > MAX_B:
        return torch.cat([_launch(w_coded, x[:, lo:hi].contiguous(), rec, hi - lo)
                          for lo, hi in thin_rows.column_panels(b)], dim=1)
    return _launch(w_coded, x, rec, b)


coded_matvec_decode_cuda.launches = 0
coded_matvec_decode_cuda.captured = 0


def _launch(w_coded: torch.Tensor, x: torch.Tensor, rec: torch.Tensor, b: int) -> torch.Tensor:
    """One launch on checked inputs, x of at most MAX_B columns."""
    rows, m = w_coded.shape
    n_data, nb = rec.shape
    br = rows // nb
    out = torch.empty((n_data * br, b) if x.dim() == 2 else (n_data * br,),
                      dtype=torch.float32, device=w_coded.device)
    vec = m % 4 == 0 and w_coded.data_ptr() % 16 == 0
    plan = _plan(w_coded.device, rows, m, b, nb, n_data, vec)
    err = thin_rows.call_on(w_coded.device, _entry(), w_coded.data_ptr(), x.data_ptr(),
                            rec.data_ptr(), out.data_ptr(), br, m, b, nb, n_data, int(vec),
                            plan.grid, plan.group_rows, plan.x_panel, plan.smem_bytes)
    count_launch(coded_matvec_decode_cuda)
    if err != 0:
        raise RuntimeError(f"coded_matvec_decode launch failed: cudaError {err}")
    return out


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return c_function("coded_decode", "coded_matvec_decode",
                      [p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                       i, i, i, i, i, i, i, i, p])


@functools.lru_cache(maxsize=None)
def _plan(device: torch.device, rows: int, m: int, b: int, nb: int, n_data: int,
          vec: bool) -> thin_rows.HeadPlan:
    dev = device.index if device.index is not None else torch.cuda.current_device()
    return thin_rows.head_plan(rows, m, b, sm_count=thin_rows.sm_count(dev),
                               occupancy=lambda smem: _occupancy(dev, b, vec, smem),
                               nb=nb, n_data=n_data)


def _occupancy(device_index: int, b: int, vec: bool, smem: int) -> int:
    fn = c_function("coded_decode", "coded_matvec_decode_occupancy",
                    [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(b, int(vec), smem, ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"coded_matvec_decode occupancy query failed: cudaError {err}")
    return blocks.value
