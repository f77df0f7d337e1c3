"""Launch geometry of the wide row-product kernels, computed on the host.

``csrc/wide_rows.cuh`` is the engine of the coded-head kernels
(``coded_matvec.cu``, ``coded_decode.cu``) for x [M, B] of ``WIDE_MIN_B``
columns and more: tiles of 128 rows of the weight by up to 256 columns of
x on the tensor cores, fp32 split into three bf16 pieces, the weight read
once a column tile.  Narrower x goes to the thin-row engine
(``kernels/thin_rows.py``).  ``gaussian_encode.cu`` runs on it too, above
``GAUSSIAN_WIDE_MIN_Q`` rows of G.  :func:`wide_plan` gives one launch's
geometry: the row and column tiles, the shared-memory ring's stages and
bytes and the persistent grid.  The C entries compute it again
(``wide_rows::geometry``) and refuse a mismatch.  Pure Python, so the CPU
tests check it (``tests/test_torch_head_plan.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["GAUSSIAN_WIDE_MIN_Q", "WIDE_MIN_B", "WidePlan", "wide_plan"]

# the smallest width of x the wide engine takes; narrower goes to the
# thin-row engine.  Measured on an H100 (PERF.md §6, chip_smoke.py
# --sweep-wide): the smallest of B in {4, 8, 12, 16, 17} at which the wide
# kernel beats the thin-row one at the glm4-9b code block, the glm4-9b W_c
# and the mamba2-130m W_c alike
WIDE_MIN_B = 8

# the most rows of G gaussian_encode runs on its register engine
# (gaussian_encode.cu); above it the dense encode runs on this engine as
# out^T = A^T G^T.  Measured on an H100 (PERF.md §6, chip_smoke.py
# --sweep-gauss at r = 500, m = 500,000): the register engine reads A once
# up to 32 rows and wins there
GAUSSIAN_WIDE_MIN_Q = 32

# wide_rows.cuh's fixed geometry
TILE_ROWS = 128              # rows of the weight a tile (two warpgroups of 64)
COL_QUANTUM = 32             # columns of one wgmma (m64n32k16)
MAX_TILE_COLS = 256          # columns of x a tile at most
MAX_STAGES = 6               # stages of the shared-memory ring at most
CONSUMER_WARPS = 8
THREADS = 32 * (CONSUMER_WARPS + 4)  # and the producer warpgroup
W_ROW_BYTES = 128            # a weight row's share of a stage
EPI_PITCH = COL_QUANTUM + 1  # floats a row of the decode's scratch
ALIGN = 1024                 # the ring's alignment
BARRIER_BYTES = 16 * MAX_STAGES
SMEM_PER_BLOCK = 227 * 1024  # the most dynamic shared memory an H100 block can use
MAX_BLOCKS = 32              # code blocks of the decode at most


@dataclass(frozen=True)
class WidePlan:
    """One launch of the wide engine."""

    n_row_tiles: int   # tiles of 128 rows (coded_matvec) or of bt rows of each block (decode)
    n_col_tiles: int   # ceil(B / 256)
    items: int         # n_row_tiles * n_col_tiles: the persistent grid's work
    bt: int            # decode: rows of each code block a tile (128 // nb); 0 for rows
    tile_rows: int     # rows a tile loads: 128, or nb * bt
    cols: int          # columns of a tile: ceil(B / n_col_tiles) rounded up to 32
    b_pad: int         # n_col_tiles * cols: x's pieces' columns
    bk: int            # weight elements of a row in a stage (32 fp32, 64 fp16)
    k_tiles: int       # stages of the K loop
    m_pad: int         # k_tiles * bk: x's pieces' rows
    pieces: int        # 3 (fp32: hi, mid, lo in bf16) or 1 (fp16)
    stages: int        # the shared-memory ring
    stage_bytes: int
    smem_bytes: int    # dynamic shared memory, alignment slack included
    grid: int          # persistent blocks: min(items, sm_count), one an SM

    @property
    def xp_elements(self) -> int:
        """Elements (2 bytes each) of the scratch that holds x's pieces."""
        return self.pieces * self.b_pad * self.m_pad

    @property
    def weight_reads(self) -> int:
        """Times the weight is read: once a column tile."""
        return self.n_col_tiles


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def wide_plan(rows: int, m: int, b: int, *, sm_count: int, half: bool = False,
              nb: int | None = None, n_data: int | None = None) -> WidePlan:
    """The geometry of y = W x for W [rows, m] and x [m, b] on the wide
    engine: coded_matvec when ``nb`` is None (fp16 when ``half``), else
    coded_matvec_decode over nb code blocks of rows // nb rows with
    ``n_data`` decoded blocks (fp32 only).  One block an SM, at most one a
    (row tile, column tile) item."""
    if min(rows, m, b, sm_count) < 1:
        raise ValueError(f"rows={rows}, m={m}, b={b}, sm_count={sm_count}: need all >= 1")
    elt = 2 if half else 4
    if nb is None:
        bt, tile_rows, n_row_tiles, epi = 0, TILE_ROWS, _cdiv(rows, TILE_ROWS), 0
    else:
        if half:
            raise ValueError("the decode takes fp32 only")
        if not 1 <= (n_data or 0) <= nb <= MAX_BLOCKS or rows % nb:
            raise ValueError(f"{rows} rows, nb={nb}, n_data={n_data}")
        bt = TILE_ROWS // nb
        tile_rows, n_row_tiles = nb * bt, _cdiv(rows // nb, bt)
        epi = TILE_ROWS * EPI_PITCH * 4 + 4 * nb * _cdiv(n_data, 8) * 8  # ys, R transposed
    n_col_tiles = _cdiv(b, MAX_TILE_COLS)
    cols = _cdiv(_cdiv(b, n_col_tiles), COL_QUANTUM) * COL_QUANTUM
    bk = W_ROW_BYTES // elt
    pieces = 3 if elt == 4 else 1
    k_tiles = _cdiv(m, bk)
    stage_bytes = TILE_ROWS * W_ROW_BYTES + pieces * cols * bk * 2
    fixed = ALIGN + BARRIER_BYTES + epi
    stages = min(MAX_STAGES, (SMEM_PER_BLOCK - fixed) // stage_bytes)
    if stages < 2:
        raise RuntimeError(f"the wide kernel's ring ({stage_bytes} B a stage) fits no SM")
    items = n_row_tiles * n_col_tiles
    return WidePlan(n_row_tiles, n_col_tiles, items, bt, tile_rows, cols, n_col_tiles * cols,
                    bk, k_tiles, k_tiles * bk, pieces, stages, stage_bytes,
                    fixed + stages * stage_bytes, min(items, sm_count))
