"""The Mamba-2 SSD intra-chunk kernels, hand-written in CUDA.

``ssd_chunk_cuda`` and ``ssd_combine_cuda`` launch ``csrc/ssd_scan.cu``,
the ports of the Pallas ``repro.kernels.ssd_scan.ssd_chunk_pallas`` and
``ssd_combine_pallas``: per (batch, head, chunk) cell, the quadratic
intra-chunk output, the chunk's state contribution, its total decay and the
running cumsum of dt·A; then the inter-chunk output from the state entering
each chunk.  Their plain versions are ``ref_ssd_chunk`` and
``ref_ssd_combine`` in ``repro_torch.kernels.ref``; the mode-switching
wrapper is ``repro_torch.kernels.ops.ssd_forward``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import c_function

__all__ = ["MAX_P", "MAX_Q", "ssd_chunk_cuda", "ssd_combine_cuda"]

MAX_Q = 256   # longest chunk (one cell's cumsum lives in shared memory)
MAX_P = 64    # widest head (one 64-column output tile)
_INPUT_DTYPES = (torch.float32, torch.bfloat16)


def _check(tensors: dict, dev: torch.device) -> None:
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the first input on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _cell_shape(g: int, q: int, p: int, n: int) -> None:
    if g < 1 or n < 1 or not 1 <= q <= MAX_Q or not 1 <= p <= MAX_P:
        raise ValueError(f"cells G={g}, Q={q}, P={p}, N={n}: the kernel takes G >= 1, "
                         f"1 <= Q <= {MAX_Q}, 1 <= P <= {MAX_P}, N >= 1")


def ssd_chunk_cuda(x: torch.Tensor, da: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """x [G, Q, P], b and c [G, Q, N] — one dtype, fp32 or bf16 — and da
    [G, Q] fp32, contiguous, on one CUDA device -> (y_diag [G, Q, P],
    states [G, P, N], total_decay [G], cum [G, Q]), all fp32."""
    _check({"x": x, "da": da, "b": b, "c": c}, x.device)
    if x.dtype not in _INPUT_DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c must share one dtype of float32 or bfloat16, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if da.dtype != torch.float32:
        raise TypeError(f"da must be float32, got {da.dtype}")
    if x.dim() != 3 or b.dim() != 3 or b.shape != c.shape or da.shape != x.shape[:2] \
            or b.shape[:2] != x.shape[:2]:
        raise ValueError(f"need x [G, Q, P], da [G, Q], b and c [G, Q, N]; got "
                         f"{tuple(x.shape)}, {tuple(da.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    g, q, p = x.shape
    n = b.shape[2]
    _cell_shape(g, q, p, n)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((g, q, p), **f32)
    states = torch.empty((g, p, n), **f32)
    decay = torch.empty((g,), **f32)
    cum = torch.empty((g, q), **f32)
    vp = ctypes.c_void_p
    fn = c_function("ssd_scan", "ssd_chunk",
                    [vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                 states.data_ptr(), decay.data_ptr(), cum.data_ptr(), g, q, p, n,
                 int(x.dtype == torch.bfloat16), stream)
    ssd_chunk_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed: cudaError {err}")
    return y, states, decay, cum


ssd_chunk_cuda.launches = 0


def ssd_combine_cuda(c: torch.Tensor, cum: torch.Tensor, states_in: torch.Tensor) -> torch.Tensor:
    """c [G, Q, N] fp32 or bf16, cum [G, Q] fp32, states_in [G, P, N] fp32 —
    contiguous, on one CUDA device -> y_off [G, Q, P] fp32."""
    _check({"c": c, "cum": cum, "states_in": states_in}, c.device)
    if c.dtype not in _INPUT_DTYPES:
        raise TypeError(f"c must be float32 or bfloat16, got {c.dtype}")
    if cum.dtype != torch.float32 or states_in.dtype != torch.float32:
        raise TypeError(f"cum and states_in must be float32, got {cum.dtype}, "
                        f"{states_in.dtype}")
    if c.dim() != 3 or states_in.dim() != 3 or cum.shape != c.shape[:2] \
            or states_in.shape[0] != c.shape[0] or states_in.shape[2] != c.shape[2]:
        raise ValueError(f"need c [G, Q, N], cum [G, Q], states_in [G, P, N]; got "
                         f"{tuple(c.shape)}, {tuple(cum.shape)}, {tuple(states_in.shape)}")
    g, q, n = c.shape
    p = states_in.shape[1]
    _cell_shape(g, q, p, n)
    y = torch.empty((g, q, p), dtype=torch.float32, device=c.device)
    vp = ctypes.c_void_p
    fn = c_function("ssd_scan", "ssd_combine",
                    [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, vp])
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(c.data_ptr(), cum.data_ptr(), states_in.data_ptr(), y.data_ptr(), g, q, p, n,
                 int(c.dtype == torch.bfloat16), stream)
    ssd_combine_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"ssd_combine launch failed: cudaError {err}")
    return y


ssd_combine_cuda.launches = 0
