"""The Mamba-2 SSD intra-chunk kernels, hand-written in CUDA.

``ssd_chunk_cuda`` and ``ssd_combine_cuda`` launch ``csrc/ssd_scan.cu``,
the ports of the Pallas ``repro.kernels.ssd_scan.ssd_chunk_pallas`` and
``ssd_combine_pallas``: per (batch, head, chunk) cell, the quadratic
intra-chunk output, the chunk's state contribution, its total decay and the
running cumsum of dt·A; then the inter-chunk output from the state entering
each chunk.  Their plain versions are ``ref_ssd_chunk`` and
``ref_ssd_combine`` in ``repro_torch.kernels.ref``; the mode-switching
wrapper is ``repro_torch.kernels.ops.ssd_forward``.

bf16 inputs run on the tensor cores: each fp32 operand is split into three
bf16 pieces (:func:`split_bf16`) whose sum is exact, so three bf16 passes
with fp32 accumulators keep fp32 accuracy.  :func:`ssd_plan` is that
route's launch geometry, which the CUDA source computes again
(``tc_plan``).  fp32 inputs run on SIMT fp32 kernels.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import count_launch, refuse_grad
from repro_torch.kernels._build import c_function

__all__ = ["MAX_N_BF16", "MAX_P", "MAX_Q", "SsdPlan", "split_bf16", "ssd_chunk_cuda",
           "ssd_combine_cuda", "ssd_plan"]

MAX_Q = 256   # longest chunk (one cell's cumsum lives in shared memory)
MAX_P = 64    # widest head (one 64-column output tile)
_INPUT_DTYPES = (torch.float32, torch.bfloat16)

# ssd_scan.cu's tensor-core route: kChunkWarps, kCombineWarps, kRowGroup,
# kSTile, kMaxNTc, kPieces, kHeadBytes and kCombineHeadBytes
CHUNK_WARPS = 8      # ssd_chunk's warps a block; one block a cell
COMBINE_WARPS = 8    # ssd_combine's
ROW_GROUP = 16       # rows of an MMA row group (l), or of a k-step over s
S_TILE = 64          # rows s of one staging stage (one mbarrier)
MAX_N_BF16 = 128     # widest state of the bf16 route (C's rows live in registers)
PIECES = 3           # bf16 pieces of an fp32 operand
HEAD_BYTES = 2304    # cum, decay and the stage mbarriers before the staged B
COMBINE_HEAD_BYTES = 128  # ssd_combine's stage mbarriers before the staged C


@dataclass(frozen=True)
class SsdPlan:
    """One launch of the bf16 route over G cells of [Q, P] x [Q, N]."""

    nk: int            # k16 steps over N: N zero-padded to 16 nk (64 or 128)
    pt: int            # n8 tiles over P: P zero-padded to 8 pt (pt even)
    rows: int          # row groups R = ceil(Q / 16)
    y_units: int       # ceil(R / 2): row groups r and R-1-r paired
    split: int         # statesᵀ units a 16-row tile of n (2 when nk = 4 and pt / 2 is even)
    state_units: int   # nk * split
    stages: int        # 64-row stages of B and X, one mbarrier each
    ld_b: int          # staged row pitches in bf16: 16 nk + 8 ...
    ld_x: int          # ... and 8 pt + 8 (odd multiples of 16 bytes: no bank conflict)
    smem_chunk: int    # ssd_chunk's dynamic shared bytes
    smem_combine: int  # ssd_combine's: C staged whole, then S_in in three bf16 planes
    grid: int          # one block a cell

    def chunk_items(self, warp: int) -> list[tuple]:
        """What warp ``warp`` of a block computes in ssd_chunk, in order:
        ("y", r) for the 16 rows of y_diag from row 16 r, and ("states", mt,
        nt0, tiles) for statesᵀ rows [16 mt, 16 mt + 16) of n by p columns
        [8 nt0, 8 (nt0 + tiles))."""
        tiles = self.pt // self.split
        out = []
        for it in range(warp, self.y_units + self.state_units, CHUNK_WARPS):
            if it < self.y_units:
                out.append(("y", it))
                if self.rows - 1 - it != it:
                    out.append(("y", self.rows - 1 - it))
            else:
                u = it - self.y_units
                out.append(("states", u // self.split, u % self.split * tiles, tiles))
        return out

    def combine_rows(self, warp: int) -> list[int]:
        """The row groups of y_off that warp ``warp`` computes in ssd_combine."""
        return list(range(warp, self.rows, COMBINE_WARPS))


def ssd_plan(g: int, q: int, p: int, n: int) -> SsdPlan:
    """The bf16 route's geometry for G cells of Q positions, head width P
    and state width N, as ``ssd_scan.cu::tc_plan`` computes it."""
    if g < 1 or not 1 <= q <= MAX_Q or not 1 <= p <= MAX_P or not 1 <= n <= MAX_N_BF16:
        raise ValueError(f"cells G={g}, Q={q}, P={p}, N={n}: the bf16 route takes G >= 1, "
                         f"1 <= Q <= {MAX_Q}, 1 <= P <= {MAX_P}, 1 <= N <= {MAX_N_BF16}")
    nk = 4 if n <= 64 else 8
    pt = -(-p // 16) * 2
    rows = -(-q // ROW_GROUP)
    split = 2 if nk == 4 and pt // 2 % 2 == 0 else 1
    ld_b, ld_x = 16 * nk + 8, 8 * pt + 8
    return SsdPlan(nk=nk, pt=pt, rows=rows, y_units=(rows + 1) // 2, split=split,
                   state_units=nk * split, stages=-(-rows * ROW_GROUP // S_TILE),
                   ld_b=ld_b, ld_x=ld_x,
                   smem_chunk=HEAD_BYTES + 2 * rows * ROW_GROUP * (ld_b + ld_x),
                   smem_combine=COMBINE_HEAD_BYTES + 2 * (rows * ROW_GROUP + PIECES * 8 * pt) * ld_b,
                   grid=g)


def split_bf16(v: torch.Tensor, pieces: int = PIECES) -> list[torch.Tensor]:
    """fp32 ``v`` as ``pieces`` bf16 tensors, each the bf16 rounding of what
    the ones before it leave: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v -
    hi - mid).  Three pieces sum to v exactly (for normal v away from the
    underflow edge), which is how the bf16 route holds an fp32 operand."""
    rest = v.to(torch.float32)
    out = []
    for _ in range(pieces):
        piece = rest.to(torch.bfloat16)
        out.append(piece)
        rest = rest - piece.to(torch.float32)
    return out


def _check(tensors: dict, dev: torch.device) -> None:
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the first input on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _cell_shape(g: int, q: int, p: int, n: int, dtype: torch.dtype) -> None:
    if g < 1 or n < 1 or not 1 <= q <= MAX_Q or not 1 <= p <= MAX_P:
        raise ValueError(f"cells G={g}, Q={q}, P={p}, N={n}: the kernel takes G >= 1, "
                         f"1 <= Q <= {MAX_Q}, 1 <= P <= {MAX_P}, N >= 1")
    if dtype == torch.bfloat16 and n > MAX_N_BF16:
        raise ValueError(f"cells of N={n}: the bf16 (tensor-core) route takes N <= {MAX_N_BF16}")


def ssd_chunk_cuda(x: torch.Tensor, da: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """x [G, Q, P], b and c [G, Q, N] — one dtype, fp32 or bf16 (then N <=
    128) — and da [G, Q] fp32, contiguous, on one CUDA device -> (y_diag [G,
    Q, P], states [G, P, N], total_decay [G], cum [G, Q]), all fp32."""
    refuse_grad(ssd_chunk_cuda, x, da, b, c)
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
    _cell_shape(g, q, p, n, x.dtype)
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
    count_launch(ssd_chunk_cuda)
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed: cudaError {err}")
    return y, states, decay, cum


ssd_chunk_cuda.launches = 0
ssd_chunk_cuda.captured = 0


def ssd_combine_cuda(c: torch.Tensor, cum: torch.Tensor, states_in: torch.Tensor) -> torch.Tensor:
    """c [G, Q, N] fp32 or bf16 (then N <= 128), cum [G, Q] fp32, states_in
    [G, P, N] fp32 — contiguous, on one CUDA device -> y_off [G, Q, P] fp32."""
    refuse_grad(ssd_combine_cuda, c, cum, states_in)
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
    _cell_shape(g, q, p, n, c.dtype)
    y = torch.empty((g, q, p), dtype=torch.float32, device=c.device)
    vp = ctypes.c_void_p
    fn = c_function("ssd_scan", "ssd_combine",
                    [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, vp])
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(c.data_ptr(), cum.data_ptr(), states_in.data_ptr(), y.data_ptr(), g, q, p, n,
                 int(c.dtype == torch.bfloat16), stream)
    count_launch(ssd_combine_cuda)
    if err != 0:
        raise RuntimeError(f"ssd_combine launch failed: cudaError {err}")
    return y


ssd_combine_cuda.launches = 0
ssd_combine_cuda.captured = 0
