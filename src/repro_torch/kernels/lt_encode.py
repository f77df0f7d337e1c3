"""The encode kernels: LT gather-encode and dense encode, hand-written in CUDA.

``lt_encode_cuda`` launches ``csrc/lt_encode.cu`` (the port of the Pallas
``repro.kernels.lt_encode.lt_encode_pallas``): Â[j] = Σ_d coeffs[j,d] ·
A[indices[j,d]] over a padded degree table, reading A only for the nonzero
entries, in narrow column spans whose slabs of A stay in the L2.  It is
:func:`_lt_csr` (the table compacted to CSR, on any device) followed by
:func:`_lt_launch` (the kernel on that CSR).  ``gaussian_encode_cuda``
launches ``csrc/gaussian_encode.cu`` (the port of ``gaussian_encode_pallas``),
an fp32 G·A for any [q, r] x [r, M] that reads A once when q <= 32.  The
launch geometry of ``gaussian_encode`` is computed here
(:func:`gaussian_plan`) and checked again by the kernel; ``lt_encode.cu``
computes its own from its fixed span and chunk sizes.  Their plain versions
are ``ref_lt_encode`` and ``ref_gaussian_encode`` in
``repro_torch.kernels.ref``; the mode-switching wrappers are ``lt_encode``,
``gaussian_encode``, ``encode_rows`` and ``encode_blocks_device`` in
``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels._build import c_function

__all__ = [
    "GaussianPlan",
    "LTCsr",
    "gaussian_encode_cuda",
    "gaussian_plan",
    "lt_encode_cuda",
]

# gaussian_encode.cu's fixed geometry
GAUSSIAN_THREADS = 128
GAUSSIAN_SPAN = 4 * GAUSSIAN_THREADS   # columns of a work item
GAUSSIAN_MAX_QT = 32
GAUSSIAN_SMEM_CAP = 64 * 1024          # bytes of G a block stages at most

# rows of more nonzero entries take lt_encode.cu's heavy path
LT_HEAVY_DEGREE = 64


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def _unroll(qt: int) -> int:
    """Rows of A a gaussian_encode thread loads before their first FMA."""
    return 8 if qt > 16 else 16


@dataclass(frozen=True)
class GaussianPlan:
    """Launch geometry of gaussian_encode.cu for one [q, r] x [r, M]."""

    qt: int          # rows of a q-tile (the template's QT), a multiple of 4
    n_qtiles: int    # ceil(q / qt); A is read once per q-tile
    unroll: int      # rows of A in flight before the first FMA
    panel: int       # rows of G a block stages at once
    smem_bytes: int  # round_up(min(panel, r), unroll) * qt * 4
    n_spans: int     # 512-column work items per q-tile
    grid: int        # persistent blocks


def gaussian_plan(q: int, r: int, m: int, sm_count: int,
                  blocks_per_sm: Callable[[int, int], int]) -> GaussianPlan:
    """The q-tiles, G's panel, shared bytes and grid for out [q, m] = G [q, r] A [r, m].

    q is cut into ceil(q / 32) equal tiles, each rounded up to a multiple of
    4 (q = 16 -> one tile of 16; q = 26 -> one of 28; q = 70 -> three of
    24).  G's tile is staged in panels of at most 64 KB.  ``blocks_per_sm(qt,
    smem_bytes)`` is the occupancy of that variant; the grid is that many
    blocks on each of ``sm_count`` SMs, or fewer where there is less work.
    """
    if min(q, r, m) < 1:
        raise ValueError(f"empty encode: q={q}, r={r}, m={m}")
    n_qtiles = _cdiv(q, GAUSSIAN_MAX_QT)
    qt = 4 * _cdiv(_cdiv(q, n_qtiles), 4)
    u = _unroll(qt)
    cap_rows = GAUSSIAN_SMEM_CAP // (4 * qt) // u * u
    panel = min(r, u * _cdiv(_cdiv(r, _cdiv(r, cap_rows)), u))
    smem = u * _cdiv(panel, u) * qt * 4
    n_spans = _cdiv(m, GAUSSIAN_SPAN)
    per_sm = blocks_per_sm(qt, smem)
    if per_sm < 1:
        raise RuntimeError(f"gaussian_encode (QT {qt}, {smem} B of shared memory) fits no SM")
    grid = min(n_qtiles * n_spans, sm_count * per_sm)
    return GaussianPlan(qt, n_qtiles, u, panel, smem, n_spans, grid)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _gaussian_occupancy(device_index: int, qt: int, vec4: bool, smem: int) -> int:
    fn = c_function("gaussian_encode", "gaussian_encode_occupancy",
                    [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(qt, int(vec4), smem, ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"gaussian_encode occupancy query failed: cudaError {err}")
    return blocks.value


def _vec4(m: int, *tensors: torch.Tensor) -> bool:
    """The kernels' float4 variant: M % 4 == 0 and every base 16-byte aligned."""
    return m % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


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
    dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
    vec4 = _vec4(m, a, out)
    plan = gaussian_plan(q, r, m, _sm_count(dev),
                         lambda qt, smem: _gaussian_occupancy(dev, qt, vec4, smem))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = c_function("gaussian_encode", "gaussian_encode",
                    [p, p, p, i, i, ctypes.c_longlong, i, i, i, i, i, i, p])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), a.data_ptr(), out.data_ptr(), q, r, m, plan.qt, plan.n_qtiles,
                 plan.panel, plan.smem_bytes, plan.grid, int(vec4), stream)
    gaussian_encode_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"gaussian_encode launch failed: cudaError {err}")
    return out


gaussian_encode_cuda.launches = 0


class LTCsr(NamedTuple):
    """A degree table compacted for lt_encode.cu."""

    row_ptr: torch.Tensor  # [q + 1] int64
    cols: torch.Tensor     # [nnz] int32: the nonzero entries' source rows, in table order
    vals: torch.Tensor     # [nnz] fp32: their coefficients
    order: torch.Tensor    # [q] int32: the rows by degree, largest first (stable)
    n_heavy: int           # rows of degree > LT_HEAVY_DEGREE (order's first n_heavy)


def _lt_csr(indices: torch.Tensor, coeffs: torch.Tensor, r: int) -> LTCsr:
    """Compact a padded degree table (coefficient 0 = padding, anywhere in a
    row) into CSR on the table's device, keeping each row's nonzero entries
    in table order.  A nonzero entry's index outside [0, r) raises
    IndexError.  Plain torch; runs on any device."""
    nonzero = coeffs != 0
    degree = nonzero.sum(dim=1)
    row_ptr = torch.nn.functional.pad(degree.cumsum(dim=0), (1, 0))
    src = indices[nonzero]
    order = torch.argsort(degree, descending=True, stable=True).to(torch.int32)
    bad, n_heavy = torch.stack([((src < 0) | (src >= r)).sum(),
                                (degree > LT_HEAVY_DEGREE).sum()]).tolist()
    if bad:
        raise IndexError(f"a nonzero entry's source row is outside [0, {r})")
    return LTCsr(row_ptr, src.to(torch.int32), coeffs[nonzero], order, n_heavy)


def _lt_launch(a: torch.Tensor, csr: LTCsr) -> torch.Tensor:
    """lt_encode.cu on a compacted table: a [r, M] fp32, contiguous, on the
    CSR's CUDA device -> [q, M] fp32."""
    q, m = csr.order.numel(), a.shape[1]
    out = torch.empty((q, m), dtype=torch.float32, device=a.device)
    next_unit = torch.zeros(1, dtype=torch.int64, device=a.device)
    p = ctypes.c_void_p
    fn = c_function("lt_encode", "lt_encode",
                    [p, p, p, p, p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, p, p])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), csr.row_ptr.data_ptr(), csr.cols.data_ptr(),
                 csr.vals.data_ptr(), csr.order.data_ptr(), out.data_ptr(), q, m, csr.n_heavy,
                 next_unit.data_ptr(), stream)
    lt_encode_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"lt_encode launch failed: cudaError {err}")
    return out


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
    return _lt_launch(a, _lt_csr(indices, coeffs, r))


lt_encode_cuda.launches = 0
