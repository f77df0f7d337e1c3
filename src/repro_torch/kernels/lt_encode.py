"""The encode kernels: LT gather-encode and dense encode, hand-written in CUDA.

``lt_encode_cuda`` launches ``csrc/lt_encode.cu`` (the port of the Pallas
``repro.kernels.lt_encode.lt_encode_pallas``): Â[j] = Σ_d coeffs[j,d] ·
A[indices[j,d]] over a padded degree table, reading A only for the nonzero
entries.  It is :func:`_lt_csr` (the table compacted to CSR, on any
device) followed by :func:`_lt_launch`, which runs one of two engines: the
slab engine (each span of columns' slab of the used rows of A staged in
shared memory once, :func:`lt_slab_plan`) where a slab of useful width
fits a block, else the L2 engine (narrow spans whose slabs stay in the
L2).  ``encode_rows`` builds the CSR on the host instead
(:func:`lt_csr_host`, numpy, copied to the card once) and calls
:func:`lt_encode_csr_cuda`.  ``gaussian_encode_cuda`` launches
``csrc/gaussian_encode.cu`` (the port of ``gaussian_encode_pallas``), an
fp32 G·A for any [q, r] x [r, M]: up to ``GAUSSIAN_WIDE_MIN_Q`` rows on
the register engine (A read once a q-tile of at most 32 rows,
:func:`gaussian_plan`), above it on the tensor-core engine of
``csrc/wide_rows.cuh`` (out^T = A^T G^T, fp32 split into three bf16
pieces, A read once a column tile of 256 rows of G,
:func:`gaussian_wide_plan`).  The launch geometry is computed here and
checked again by the kernels.  Their plain versions are ``ref_lt_encode``
and ``ref_gaussian_encode`` in ``repro_torch.kernels.ref``; the
mode-switching wrappers are ``lt_encode``, ``gaussian_encode``,
``encode_rows`` and ``encode_blocks_device`` in
``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import count_launch, refuse_grad
from repro_torch.kernels._build import c_function
from repro_torch.kernels.wide_rows import GAUSSIAN_WIDE_MIN_Q, WidePlan, wide_plan

__all__ = [
    "GAUSSIAN_WIDE_MIN_Q",
    "GaussianPlan",
    "LTCsr",
    "LTSlabPlan",
    "gaussian_encode_cuda",
    "gaussian_engine",
    "gaussian_plan",
    "gaussian_wide_plan",
    "lt_csr_host",
    "lt_encode_csr_cuda",
    "lt_encode_cuda",
    "lt_slab_plan",
    "lt_slab_smem",
]

# gaussian_encode.cu's fixed geometry
GAUSSIAN_THREADS = 128
GAUSSIAN_SPAN = 4 * GAUSSIAN_THREADS   # columns of a work item
GAUSSIAN_MAX_QT = 32
GAUSSIAN_SMEM_CAP = 64 * 1024          # bytes of G a block stages at most

# rows of more nonzero entries take lt_encode.cu's heavy path (the L2 engine)
LT_HEAVY_DEGREE = 64

# lt_encode.cu's slab engine
LT_SLAB_LANE_COLS = 4                 # kLaneCols: columns of a span a work item sums
LT_SLAB_SMEM = 227 * 1024 - 64        # kSlabSmemMax: bytes of slab and table a block holds
LT_SLAB_WIDTHS = (64, 32, 16)         # span widths the plan picks from, widest first
LT_SLAB_MIN_WIDTH = 16                # narrower spans walk the table too often (PERF.md §6)


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


def gaussian_engine(q: int) -> str:
    """'register' (gaussian_encode.cu's register engine) for q up to
    ``GAUSSIAN_WIDE_MIN_Q`` rows of G, else 'wide' (the tensor cores)."""
    return "register" if q <= GAUSSIAN_WIDE_MIN_Q else "wide"


def gaussian_wide_plan(q: int, r: int, m: int, sm_count: int) -> WidePlan:
    """The tensor-core engine's geometry for out [q, m] = G [q, r] A [r, m]:
    wide_rows.cuh's for W = A^T [m, r] and x = G^T [r, q], so A is read once
    a column tile of up to 256 rows of G (ceil(q / 256) tiles), K = r is
    padded to the stages' 32 and q to the tile's multiple of 32."""
    if min(q, r, m) < 1:
        raise ValueError(f"empty encode: q={q}, r={r}, m={m}")
    if m >= 2**31:
        raise ValueError(f"m={m}: the tensor-core engine takes m < 2^31 (TMA coordinates)")
    return wide_plan(m, r, q, sm_count=sm_count)


def gaussian_encode_cuda(g: torch.Tensor, a: torch.Tensor,
                         engine: str | None = None) -> torch.Tensor:
    """g [q, r], a [r, M] — fp32, contiguous, on one CUDA device -> [q, M]
    fp32.  ``engine`` None: by :func:`gaussian_engine`; 'register' or
    'wide' runs that one (the sweeps and tests).  One launch, counted; the
    tensor-core engine's also in ``.wide_launches``."""
    refuse_grad(gaussian_encode_cuda, g, a)
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
    engine = gaussian_engine(q) if engine is None else engine
    if engine not in ("register", "wide"):
        raise ValueError(f"unknown gaussian_encode engine {engine!r}")
    out = torch.empty((q, m), dtype=torch.float32, device=a.device)
    dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
    if engine == "wide":
        return _gaussian_wide(g, a, out, dev)
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
    count_launch(gaussian_encode_cuda)
    if err != 0:
        raise RuntimeError(f"gaussian_encode launch failed: cudaError {err}")
    return out


gaussian_encode_cuda.launches = 0
gaussian_encode_cuda.captured = 0
gaussian_encode_cuda.wide_launches = 0
gaussian_encode_cuda.wide_captured = 0


def _gaussian_wide(g: torch.Tensor, a: torch.Tensor, out: torch.Tensor, dev: int) -> torch.Tensor:
    """One launch of the tensor-core engine on checked inputs (G split into
    its pieces by the entry's pre-pass, into scratch allocated here)."""
    (q, r), m = g.shape, a.shape[1]
    plan = gaussian_wide_plan(q, r, m, _sm_count(dev))
    gp = torch.empty(plan.xp_elements, dtype=torch.bfloat16, device=a.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = c_function("gaussian_encode", "gaussian_encode_wide",
                    [p, p, p, p, i, i, ctypes.c_longlong, i, i, i, i, p])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), a.data_ptr(), gp.data_ptr(), out.data_ptr(), q, r, m,
                 plan.grid, plan.cols, plan.stages, plan.smem_bytes, stream)
    count_launch(gaussian_encode_cuda, "wide")
    if err != 0:
        raise RuntimeError(f"gaussian_encode (wide) launch failed: cudaError {err}")
    return out


class LTCsr(NamedTuple):
    """A degree table compacted for lt_encode.cu: CSR for the L2 engine, and
    for a table that may fit the slab engine (the table and a slab of
    ``LT_SLAB_MIN_WIDTH`` columns within ``LT_SLAB_SMEM``) the same entries
    by rank; None there otherwise."""

    row_ptr: torch.Tensor    # [q + 1] int64
    cols: torch.Tensor       # [nnz] int32: the nonzero entries' source rows, in table order
    vals: torch.Tensor       # [nnz] fp32: their coefficients
    order: torch.Tensor      # [q] int32: the rows by degree, largest first (stable): rank -> row
    n_heavy: int             # rows of degree > LT_HEAVY_DEGREE (order's first n_heavy)
    n_used: int              # u: the source rows the table references
    used: torch.Tensor | None      # [u] int32: those rows, ascending
    slab_ptr: torch.Tensor | None  # [q + 1] int32: each rank's entries' offset in slab_ent
    slab_ent: torch.Tensor | None  # [nnz, 2] int32 by rank (each row's in table order):
    #                                the entry's source row's index in used, its coefficient's bits

    def to(self, device) -> "LTCsr":
        return self._replace(**{f: getattr(self, f).to(device) for f in _CSR_TENSORS
                                if getattr(self, f) is not None})


_CSR_TENSORS = ("row_ptr", "cols", "vals", "order", "used", "slab_ptr", "slab_ent")


def _slab_may_fit(q: int, u: int, nnz: int) -> bool:
    """Whether the table and a slab of its u rows fit the slab engine (an
    all-padding table, u = 0, goes to the L2 engine, which writes zeros)."""
    return u >= 1 and lt_slab_smem(q, u, nnz, LT_SLAB_MIN_WIDTH) <= LT_SLAB_SMEM


def _lt_csr(indices: torch.Tensor, coeffs: torch.Tensor, r: int) -> LTCsr:
    """Compact a padded degree table (coefficient 0 = padding, anywhere in a
    row) into CSR on the table's device, keeping each row's nonzero entries
    in table order.  A nonzero entry's index outside [0, r) raises
    IndexError.  Plain torch; runs on any device."""
    nonzero = coeffs != 0
    degree = nonzero.sum(dim=1)
    row_ptr = torch.nn.functional.pad(degree.cumsum(dim=0), (1, 0))
    src = indices[nonzero]
    order = torch.argsort(degree, descending=True, stable=True)
    used_mask = torch.zeros(r, dtype=torch.bool, device=src.device)
    used_mask[src.clamp(0, r - 1)] = True
    bad, n_heavy, u = torch.stack([((src < 0) | (src >= r)).sum(),
                                   (degree > LT_HEAVY_DEGREE).sum(), used_mask.sum()]).tolist()
    if bad:
        raise IndexError(f"a nonzero entry's source row is outside [0, {r})")
    vals = coeffs[nonzero].to(torch.float32)
    q, nnz = order.numel(), src.numel()
    used = slab_ptr = ent = None
    if _slab_may_fit(q, u, nnz):
        used = torch.nonzero(used_mask).flatten().to(torch.int32)
        local = torch.cumsum(used_mask, dim=0)[src] - 1
        deg_r = degree[order]
        slab_ptr = torch.nn.functional.pad(deg_r.cumsum(dim=0), (1, 0))
        rank = torch.repeat_interleave(torch.arange(q, device=src.device), deg_r,
                                       output_size=nnz)
        pos = row_ptr[order][rank] + torch.arange(nnz, device=src.device) - slab_ptr[rank]
        ent = torch.stack([local[pos].to(torch.int32), vals[pos].view(torch.int32)], dim=1)
        slab_ptr = slab_ptr.to(torch.int32)
    return LTCsr(row_ptr, src.to(torch.int32), vals, order.to(torch.int32), n_heavy, u, used,
                 slab_ptr, ent)


def lt_csr_host(indices: np.ndarray, coeffs: np.ndarray, r: int) -> LTCsr:
    """:func:`_lt_csr` in numpy on the host, as CPU tensors (``.to(device)``
    copies them once): what ``encode_rows`` hands the card, so no task
    compacts its table there or waits on the host to size it."""
    coeffs = np.asarray(coeffs, dtype=np.float32)
    nonzero = coeffs != 0
    degree = nonzero.sum(axis=1)
    row_ptr = np.concatenate([[0], np.cumsum(degree)]).astype(np.int64)
    src = np.asarray(indices)[nonzero].astype(np.int64)
    if src.size and (src.min() < 0 or src.max() >= r):
        raise IndexError(f"a nonzero entry's source row is outside [0, {r})")
    vals = coeffs[nonzero]
    order = np.argsort(-degree, kind="stable")
    used = np.unique(src)
    q, nnz = order.size, src.size
    t = torch.from_numpy
    slab = (None, None, None)
    if _slab_may_fit(q, used.size, nnz):
        local = np.searchsorted(used, src)
        deg_r = degree[order]
        slab_ptr = np.concatenate([[0], np.cumsum(deg_r)]).astype(np.int64)
        rank = np.repeat(np.arange(q), deg_r)
        pos = row_ptr[order][rank] + np.arange(nnz) - slab_ptr[rank]
        ent = np.stack([local[pos].astype(np.int32), vals[pos].view(np.int32)], axis=1)
        slab = (t(used.astype(np.int32)), t(slab_ptr.astype(np.int32)),
                t(np.ascontiguousarray(ent)))
    return LTCsr(t(row_ptr), t(src.astype(np.int32)), t(vals), t(order.astype(np.int32)),
                 int((degree > LT_HEAVY_DEGREE).sum()), int(used.size), *slab)


@dataclass(frozen=True)
class LTSlabPlan:
    """One launch of lt_encode.cu's slab engine."""

    width: int       # columns of a span (a multiple of 4)
    smem_bytes: int  # the slab and the table (slab_smem in lt_encode.cu)
    n_spans: int     # ceil(m / width)


def lt_slab_smem(q: int, u: int, nnz: int, width: int) -> int:
    """Shared bytes of a slab launch: the slab, u x width fp32, and the
    table (8 bytes an entry, 8 a row and 4), rounded up to 16."""
    return (u * width * 4 + 8 * nnz + 4 * (2 * q + 1) + 15) // 16 * 16


def lt_slab_plan(q: int, u: int, nnz: int, m: int, sm_count: int) -> LTSlabPlan | None:
    """The slab engine's span for a table of q rows and nnz nonzero entries
    over u rows of A [r, m], or None where the table and a slab of
    ``LT_SLAB_MIN_WIDTH`` columns do not fit a block's ``LT_SLAB_SMEM``
    bytes: the L2 engine takes those.  Of the widths of ``LT_SLAB_WIDTHS``
    that fit, those that let two blocks share an SM (the sums are latency-
    bound: a second block's warps hide the first's), then the widest that
    still gives every SM a span, else the narrowest (chip_smoke.py
    --sweep-lt at the EC2 example's tables)."""
    if min(q, u, m, sm_count) < 1 or nnz < 0:
        raise ValueError(f"q={q}, u={u}, nnz={nnz}, m={m}, sm_count={sm_count}")
    fits = [w for w in LT_SLAB_WIDTHS
            if w >= LT_SLAB_MIN_WIDTH and lt_slab_smem(q, u, nnz, w) <= LT_SLAB_SMEM]
    if not fits:
        return None
    pairs = [w for w in fits if lt_slab_smem(q, u, nnz, w) <= LT_SLAB_SMEM // 2] or fits
    spread = [w for w in pairs if _cdiv(m, w) >= sm_count]
    width = spread[0] if spread else pairs[-1]
    return LTSlabPlan(width, lt_slab_smem(q, u, nnz, width), _cdiv(m, width))


def _lt_launch(a: torch.Tensor, csr: LTCsr, engine: str | None = None) -> torch.Tensor:
    """lt_encode.cu on a compacted table: a [r, M] fp32, contiguous, on the
    CSR's CUDA device -> [q, M] fp32.  ``engine`` None: the slab engine
    where :func:`lt_slab_plan` finds a slab, else the L2 engine; 'slab' or
    'l2' runs that one (the tests and chip_smoke.py's checks)."""
    q, m, nnz = csr.order.numel(), a.shape[1], csr.cols.numel()
    dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
    plan = (None if engine == "l2" or csr.used is None
            else lt_slab_plan(q, csr.n_used, nnz, m, _sm_count(dev)))
    if engine is None:
        engine = "l2" if plan is None else "slab"
    if engine == "slab" and plan is None:
        raise ValueError(f"the table and its {csr.n_used} rows of A fit no slab")
    out = torch.empty((q, m), dtype=torch.float32, device=a.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if engine == "slab":
            fn = c_function("lt_encode", "lt_encode_slab",
                            [p, p, p, p, p, p, i, i, i, ctypes.c_longlong, i, p])
            err = fn(a.data_ptr(), csr.slab_ptr.data_ptr(), csr.slab_ent.data_ptr(),
                     csr.order.data_ptr(), csr.used.data_ptr(), out.data_ptr(), q,
                     csr.n_used, nnz, m, plan.width, stream)
        elif engine == "l2":
            next_unit = torch.zeros(1, dtype=torch.int64, device=a.device)
            fn = c_function("lt_encode", "lt_encode",
                            [p, p, p, p, p, p, i, ctypes.c_longlong, i, p, p])
            err = fn(a.data_ptr(), csr.row_ptr.data_ptr(), csr.cols.data_ptr(),
                     csr.vals.data_ptr(), csr.order.data_ptr(), out.data_ptr(), q, m,
                     csr.n_heavy, next_unit.data_ptr(), stream)
        else:
            raise ValueError(f"unknown lt_encode engine {engine!r}")
    count_launch(lt_encode_cuda, "slab" if engine == "slab" else None)
    if err != 0:
        raise RuntimeError(f"lt_encode ({engine}) launch failed: cudaError {err}")
    return out


def lt_encode_csr_cuda(a: torch.Tensor, csr: LTCsr) -> torch.Tensor:
    """lt_encode on a table already compacted (:func:`lt_csr_host`, copied
    to a's device): a [r, M] fp32, contiguous, on one CUDA device -> [q, M]
    fp32."""
    refuse_grad(lt_encode_cuda, a, csr.vals)
    if not a.is_cuda:
        raise ValueError(f"a must be a CUDA tensor, got device {a.device}")
    if a.dtype != torch.float32 or not a.is_contiguous() or a.dim() != 2:
        raise ValueError(f"a must be a contiguous 2-D float32 tensor, got {a.dtype} "
                         f"{tuple(a.shape)}")
    for name in _CSR_TENSORS:
        t = getattr(csr, name)
        if t is not None and t.device != a.device:
            raise ValueError(f"the CSR's {name} is on {t.device}, a on {a.device}")
    if csr.order.numel() == 0 or a.numel() == 0:
        raise ValueError(f"empty encode: a {tuple(a.shape)}, {csr.order.numel()} rows")
    return _lt_launch(a, csr)


def lt_encode_cuda(
    a: torch.Tensor, indices: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """a [r, M] fp32, indices [q, d_max] int32/int64, coeffs [q, d_max] fp32 —
    contiguous, on one CUDA device -> [q, M] fp32.

    Coefficient 0 marks padding, anywhere in a row.  The table is compacted
    here into CSR (the nonzero entries of each row, in table order), so the
    kernel reads the rows of A that the sum needs and nothing else.  An
    index of a nonzero entry outside [0, r) raises.  One launch, counted;
    the slab engine's also in ``.slab_launches``.
    """
    refuse_grad(lt_encode_cuda, a, coeffs)
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
lt_encode_cuda.captured = 0
lt_encode_cuda.slab_launches = 0
lt_encode_cuda.slab_captured = 0
