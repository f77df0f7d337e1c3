"""The encode kernels: LT gather-encode and dense encode, hand-written in CUDA.

``lt_encode_cuda`` launches ``csrc/lt_encode.cu`` (the port of the Pallas
``repro.kernels.lt_encode.lt_encode_pallas``): Â[j] = Σ_d coeffs[j,d] ·
A[indices[j,d]] over a padded degree table, reading A only for the nonzero
entries.  ``gaussian_encode_cuda`` launches ``csrc/gaussian_encode.cu``
(the port of ``gaussian_encode_pallas``), a tiled fp32 SGEMM for any
[q, r] x [r, M].  Their plain versions are ``ref_lt_encode`` and
``ref_gaussian_encode`` in ``repro_torch.kernels.ref``; the mode-switching
wrappers are ``lt_encode``, ``gaussian_encode``, ``encode_rows`` and
``encode_blocks_device`` in ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import c_function

__all__ = ["gaussian_encode_cuda", "lt_encode_cuda"]


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
    p = ctypes.c_void_p
    fn = c_function("gaussian_encode", "gaussian_encode",
                    [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, p])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), a.data_ptr(), out.data_ptr(), q, r, m, stream)
    gaussian_encode_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"gaussian_encode launch failed: cudaError {err}")
    return out


gaussian_encode_cuda.launches = 0


def lt_encode_cuda(
    a: torch.Tensor, indices: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """a [r, M] fp32, indices [q, d_max] int32/int64, coeffs [q, d_max] fp32 —
    contiguous, on one CUDA device -> [q, M] fp32.

    Coefficient 0 marks padding, anywhere in a row.  The table is compacted
    here into CSR (the nonzero entries of each row, in table order), so the
    kernel reads the rows of A that the sum needs and nothing else.  An
    index of a nonzero entry outside [0, r) raises.
    """
    if not a.is_cuda:
        raise ValueError(f"a must be a CUDA tensor, got device {a.device}")
    for name, t in (("indices", indices), ("coeffs", coeffs)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
    if a.dtype != torch.float32 or coeffs.dtype != torch.float32:
        raise TypeError(f"a and coeffs must be float32, got {a.dtype} and {coeffs.dtype}")
    if indices.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"indices must be int32 or int64, got {indices.dtype}")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    if a.dim() != 2 or indices.dim() != 2 or indices.shape != coeffs.shape:
        raise ValueError(
            f"need a [r, M] and indices, coeffs [q, d_max]; got {tuple(a.shape)}, "
            f"{tuple(indices.shape)}, {tuple(coeffs.shape)}"
        )
    r, m = a.shape
    q = indices.shape[0]
    if q == 0 or r == 0 or m == 0:
        raise ValueError(f"empty encode: a {tuple(a.shape)}, table {tuple(indices.shape)}")
    nonzero = coeffs != 0
    row_ptr = torch.nn.functional.pad(nonzero.sum(dim=1).cumsum(dim=0), (1, 0))
    cols = indices[nonzero].to(torch.int32)
    vals = coeffs[nonzero]
    if cols.numel() and (int(cols.min()) < 0 or int(cols.max()) >= r):
        raise IndexError(f"a nonzero entry's source row is outside [0, {r})")
    out = torch.empty((q, m), dtype=torch.float32, device=a.device)
    p = ctypes.c_void_p
    fn = c_function("lt_encode", "lt_encode",
                    [p, p, p, p, p, ctypes.c_int, ctypes.c_longlong, p])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                 out.data_ptr(), q, m, stream)
    lt_encode_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"lt_encode launch failed: cudaError {err}")
    return out


lt_encode_cuda.launches = 0
