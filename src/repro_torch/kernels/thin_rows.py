"""Launch geometry of the thin row-product kernels, computed on the host.

``csrc/thin_rows.cuh`` is the engine of ``coded_matvec.cu`` and
``coded_decode.cu``: fp32 dot products of the rows of a tall weight with a
thin x [M, B] (B <= 16), reading the weight once.  A wider x runs in column
panels of at most 16 (:func:`column_panels`), one launch a panel, so the
weight is read once a panel.  :func:`head_plan` gives one launch's
geometry: the persistent grid, the unit (a row, or a row tile
across the nb code blocks of the decode), the rows streamed together,
whether x stays resident in shared memory, and the shared bytes.  The C
entries compute it again (``thin_rows::geometry``) and refuse a mismatch.
Pure Python, so the CPU tests check it (``tests/test_torch_head_plan.py``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["HeadPlan", "call_on", "column_panels", "head_plan", "sm_count"]

# thin_rows.cuh's setting (kWarps, kRowsPerWarp) and fixed geometry
WARPS = 16                   # warps a block
ROWS_PER_WARP = 2            # rows a warp streams at once (coded_matvec: its rows a group)
BLOCKS_PER_SM = 2            # the grid's cap an SM (the occupancy may allow fewer)
MAX_B = 16
MAX_GROUP_ROWS = 32          # rows whose sums a block holds at once
X_CAP_BYTES = 64 * 1024      # x stays resident in shared memory up to this
X_PANEL_QUANTUM = 256        # x panels (above the cap) are multiples of this many columns
SMEM_PER_BLOCK = 227 * 1024  # the most dynamic shared memory an H100 block can use


@dataclass(frozen=True)
class HeadPlan:
    """One launch of coded_matvec.cu or coded_decode.cu."""

    n_units: int       # rows (coded_matvec) or row tiles of bt rows a block (decode)
    bt: int            # decode: rows of each code block in a tile (32 // nb); 1 for rows
    group_rows: int    # rows streamed together (<= 32)
    x_resident: bool   # B * round_up(M, 4) * 4 <= X_CAP_BYTES: x staged once a block
    x_panel: int       # columns of x staged at once (M when resident)
    x_stride: int      # floats between columns of x in shared memory
    smem_bytes: int    # dynamic shared memory
    grid: int          # persistent blocks: min(n_units, sm_count * blocks an SM)


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def column_panels(b: int) -> list[tuple[int, int]]:
    """The [lo, hi) column ranges of an x with ``b`` columns that the head
    kernels launch on: ceil(b / MAX_B) panels whose widths differ by at most
    one (17 columns are 9 + 8, 33 are 11 + 11 + 11).  Each panel is one
    launch and reads the whole weight; a column's sums do not depend on the
    panel it is in."""
    if b < 1:
        raise ValueError(f"x has {b} columns")
    n = _cdiv(b, MAX_B)
    q, extra = divmod(b, n)
    bounds = [0]
    for i in range(n):
        bounds.append(bounds[-1] + q + (i < extra))
    return list(zip(bounds[:-1], bounds[1:]))


def head_plan(rows: int, m: int, b: int, *, sm_count: int, occupancy: Callable[[int], int],
              nb: int | None = None, n_data: int | None = None) -> HeadPlan:
    """The geometry of y = W x for W [rows, m] and x [m, b]: coded_matvec
    when ``nb`` is None (a unit is a row, a group WARPS * ROWS_PER_WARP
    rows), else coded_matvec_decode over nb code blocks of rows // nb rows
    with ``n_data`` decoded blocks (a unit is a tile of bt = 32 // nb rows of
    every block, a group one tile).  ``occupancy(smem_bytes)`` is the blocks
    an SM of the instantiation to launch; the grid is at most BLOCKS_PER_SM
    of them on each of ``sm_count`` SMs, and at most one block a unit."""
    if min(rows, m, b) < 1 or b > MAX_B:
        raise ValueError(f"rows={rows}, m={m}, b={b}: need rows, m >= 1 and 1 <= b <= {MAX_B}")
    if nb is None:
        bt, n_units = 1, rows
        group_rows = WARPS * ROWS_PER_WARP
        epi_bytes = 0
    else:
        if not 1 <= (n_data or 0) <= nb <= MAX_GROUP_ROWS or rows % nb:
            raise ValueError(f"{rows} rows, nb={nb}, n_data={n_data}")
        bt = MAX_GROUP_ROWS // nb
        n_units = _cdiv(rows // nb, bt)
        group_rows = nb * bt
        epi_bytes = 32 + 4 * (2 * group_rows * b + n_data * nb)  # mbarriers, ys x 2, R
    m4 = _cdiv(m, 4) * 4
    x_resident = b * m4 * 4 <= X_CAP_BYTES
    if x_resident:
        x_panel, x_stride = m, m4
    else:
        x_panel = X_CAP_BYTES // (4 * b) // X_PANEL_QUANTUM * X_PANEL_QUANTUM
        x_stride = x_panel
    smem = b * x_stride * 4 + epi_bytes
    per_sm = min(BLOCKS_PER_SM, occupancy(smem))
    if per_sm < 1:
        raise RuntimeError(f"the thin-row kernel ({smem} B of shared memory) fits no SM")
    return HeadPlan(n_units, bt, group_rows, x_resident, x_panel, x_stride, smem,
                    min(n_units, sm_count * per_sm))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def call_on(device: torch.device, fn, *args):
    """``fn(*args, stream)`` with ``device`` current and its current stream,
    entering the device only when it is not current (a head kernel takes
    60 microseconds at the Mamba-2 heads, so the host's cost a launch
    shows)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)
