"""The arithmetic of the SSD kernels' bf16 (tensor-core) route, on the CPU.

On bf16 inputs ``csrc/ssd_scan.cu`` multiplies on the tensor cores: in each
product one operand is a bf16 input and the other is fp32, which is split
into three bf16 pieces (``kernels/ssd_scan.py::split_bf16``) and multiplied
in three passes into one fp32 sum.  Here, in plain torch and with no card:

  * the three pieces sum to the fp32 value exactly, over a wide range of
    magnitudes (two do not);
  * y_diag, states and y_off computed from the pieces, as the kernels
    compute them, meet the tolerance the kernels are held to on the card
    (the reference's rtol 1e-4, atol 1e-5 scaled by max|plain|) against
    ``ref_ssd_chunk`` and ``ref_ssd_combine`` at both Mamba-2 widths and
    both decay draws; with one piece (plain bf16 rounding) they do not;
  * ``ssd_plan``, the route's launch geometry, gives every row group and
    every tile of the state of every cell to exactly one warp, at every
    cell shape the serve sends, and agrees with the constants of the CUDA
    source, which computes it again.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ssd_scan import (
    CHUNK_WARPS,
    COMBINE_HEAD_BYTES,
    COMBINE_WARPS,
    HEAD_BYTES,
    MAX_N_BF16,
    PIECES,
    ROW_GROUP,
    S_TILE,
    split_bf16,
    ssd_plan,
)

# the SSD widths of mamba2-130m and zamba2-1.2b: heads, head dim P, state N
WIDTHS = {"mamba2-130m": (32, 48, 128), "zamba2-1.2b": (64, 64, 64)}
PROMPTS = (4096, 1000, 100, 2)        # the serve's prompt lengths (chunk 256)
SMEM_PER_BLOCK = 227 * 1024


def _close(got, want):
    """The kernels' tolerance on the card (tests/test_torch_cuda.py::_ssd_close)."""
    return bool(torch.isfinite(got).all()) and np.allclose(
        got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5 * max(1.0, want.abs().max().item()))


def _cells(g, q, p, n, draw, seed):
    """bf16 x, b, c and fp32 da as the card's tests draw them: the reference
    tests' decay, -0.3|N(0, 1)|, or the slow one, -U(0, 2/Q), under which
    every tile of the cell carries weight."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(0.1 * rng.standard_normal((g, q, p)), dtype=torch.float32)
    b = torch.as_tensor(0.3 * rng.standard_normal((g, q, n)), dtype=torch.float32)
    c = torch.as_tensor(0.3 * rng.standard_normal((g, q, n)), dtype=torch.float32)
    if draw == "reference":
        da = -0.3 * np.abs(rng.standard_normal((g, q)))
    else:
        da = -(2.0 / q) * rng.random((g, q))
    return (x.bfloat16(), torch.as_tensor(da, dtype=torch.float32), b.bfloat16(), c.bfloat16())


def _passes(eq, fp32_operand, bf16_operand, pieces, fp32_first=True):
    """Σ over the pieces of the fp32 operand of einsum(eq) with the bf16
    operand: each piece times a bf16 value is exact in fp32, summed in fp32."""
    out = 0.0
    for piece in split_bf16(fp32_operand, pieces):
        ops = (piece.float(), bf16_operand.float())
        out = out + torch.einsum(eq, *(ops if fp32_first else ops[::-1]))
    return out


def chunk_from_pieces(x, da, b, c, pieces=PIECES):
    """ssd_chunk as the bf16 route computes it: C·Bᵀ of bf16 operands in
    fp32, selected (l >= s) and scaled by L in fp32, split in ``pieces``
    against X; the state from decay ∘ B, split, against X."""
    cum = torch.cumsum(da, dim=-1)
    q = x.shape[1]
    mask = torch.ones(q, q, dtype=torch.bool).tril()
    diff = torch.where(mask, cum[:, :, None] - cum[:, None, :], torch.zeros(()))
    cb = torch.einsum("gln,gsn->gls", c.float(), b.float())
    v = torch.where(mask, cb * torch.exp(diff), torch.zeros(()))
    y = _passes("gls,gsp->glp", v, x, pieces)
    w = torch.exp(cum[:, -1:] - cum)[:, :, None] * b.float()
    states = _passes("gsp,gsn->gpn", w, x, pieces, fp32_first=False)
    return y, states, torch.exp(cum[:, -1]), cum


def combine_from_pieces(c, cum, s_in, pieces=PIECES):
    """ssd_combine as the bf16 route computes it: C times S_in's pieces, the
    row scale exp(cum) last."""
    return torch.exp(cum)[:, :, None] * _passes("gpn,gln->glp", s_in, c, pieces)


def test_three_bf16_pieces_rebuild_fp32_exactly():
    rng = np.random.default_rng(0)
    wide = np.exp(rng.uniform(-30.0, 30.0, 100_000)) * rng.choice([-1.0, 1.0], 100_000)
    extremes = np.ldexp(rng.uniform(1.0, 2.0, 2000), rng.integers(-100, 100, 2000))
    v = torch.as_tensor(np.concatenate([wide, extremes, [0.0, 1.0, -1.0, 3.0e-30]]),
                        dtype=torch.float32)
    hi, mid, lo = split_bf16(v)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.double() + mid.double() + lo.double(), v.double())
    hi2, mid2 = split_bf16(v, 2)
    assert not torch.equal(hi2.double() + mid2.double(), v.double())


@pytest.mark.parametrize("arch", sorted(WIDTHS))
@pytest.mark.parametrize("draw", ["reference", "slow"])
def test_three_pieces_meet_the_kernel_tolerance(arch, draw):
    _, p, n = WIDTHS[arch]
    x, da, b, c = _cells(4, 256, p, n, draw, seed=p + n + len(draw))
    want = ref.ref_ssd_chunk(x, da, b, c)
    got = chunk_from_pieces(x, da, b, c)
    for name, g_, w_ in zip(("y_diag", "states", "decay", "cum"), got, want):
        assert _close(g_, w_), name
    s_in = torch.as_tensor(np.random.default_rng(p).standard_normal((4, p, n)),
                           dtype=torch.float32)
    assert _close(combine_from_pieces(c, want[3], s_in), ref.ref_ssd_combine(c, want[3], s_in))


@pytest.mark.parametrize("arch", sorted(WIDTHS))
@pytest.mark.parametrize("draw", ["reference", "slow"])
def test_one_piece_misses_the_kernel_tolerance(arch, draw):
    """Plain bf16 rounding of the fp32 operand (one pass) is not enough: the
    pieces are what keeps the route at the fp32 tolerance."""
    _, p, n = WIDTHS[arch]
    x, da, b, c = _cells(4, 256, p, n, draw, seed=p + n + len(draw))
    want = ref.ref_ssd_chunk(x, da, b, c)
    got = chunk_from_pieces(x, da, b, c, pieces=1)
    assert not _close(got[0], want[0])
    assert not _close(got[1], want[1])
    s_in = torch.as_tensor(np.random.default_rng(p).standard_normal((4, p, n)),
                           dtype=torch.float32)
    assert not _close(combine_from_pieces(c, want[3], s_in, pieces=1),
                      ref.ref_ssd_combine(c, want[3], s_in))


def _serve_cells():
    """(G, Q, P, N) of every launch the serve makes: one prompt of each
    length at B = 1, cut into chunks of 256 as ssd_forward cuts it."""
    out = []
    for heads, p, n in WIDTHS.values():
        for s in PROMPTS:
            q = min(256, s)
            out.append((heads * -(-s // q), q, p, n))
    return out


CELLS = _serve_cells() + [(6, 37, 5, 19), (1, 1, 1, 1), (3, 17, 64, 65), (2, 250, 40, 128),
                          (5, 64, 16, 64), (4, 255, 33, 100)]


@pytest.mark.parametrize("g,q,p,n", CELLS)
def test_ssd_plan_covers_every_cell_once(g, q, p, n):
    plan = ssd_plan(g, q, p, n)
    rows = -(-q // ROW_GROUP)
    assert plan.grid == g and plan.rows == rows  # one block a cell
    assert 16 * plan.nk >= n and 8 * plan.pt >= p and plan.pt % 2 == 0
    assert plan.stages == -(-rows * ROW_GROUP // S_TILE) <= 256 // S_TILE
    # the row groups of y_diag and the 16 x 8 tiles of statesᵀ, each once
    y_rows, tiles = [], []
    for warp in range(CHUNK_WARPS):
        for item in plan.chunk_items(warp):
            if item[0] == "y":
                y_rows.append(item[1])
            else:
                _, mt, nt0, count = item
                assert count % 2 == 0  # ldmatrix.x4 takes two n8 tiles of X at a time
                tiles += [(mt, nt) for nt in range(nt0, nt0 + count)]
    assert sorted(y_rows) == list(range(rows))
    assert sorted(tiles) == [(mt, nt) for mt in range(plan.nk) for nt in range(plan.pt)]
    combine = [r for warp in range(COMBINE_WARPS) for r in plan.combine_rows(warp)]
    assert sorted(combine) == list(range(rows))
    # staged rows are odd multiples of 16 bytes: ldmatrix's 8 rows hit 8 distinct bank groups
    assert (2 * plan.ld_b // 16) % 2 == 1 and (2 * plan.ld_x // 16) % 2 == 1
    assert plan.smem_chunk <= SMEM_PER_BLOCK and plan.smem_combine <= SMEM_PER_BLOCK


@pytest.mark.parametrize("g,q,p,n", [c for c in _serve_cells() if c[1] == 256])
def test_ssd_plan_balances_the_causal_rows(g, q, p, n):
    """At full chunks each warp's y work — its row groups' s-blocks, r + 1
    for row group r — is the same: the pairs (r, R-1-r) each take R + 1."""
    plan = ssd_plan(g, q, p, n)
    work = [sum(item[1] + 1 for item in plan.chunk_items(w) if item[0] == "y")
            for w in range(CHUNK_WARPS)]
    assert len(set(work)) == 1 and sum(work) == plan.rows * (plan.rows + 1) // 2


def test_ssd_plan_refuses_what_the_route_does_not_take():
    for bad in [(0, 16, 8, 8), (1, 257, 8, 8), (1, 16, 65, 8), (1, 16, 8, MAX_N_BF16 + 1)]:
        with pytest.raises(ValueError):
            ssd_plan(*bad)


def test_cuda_source_has_the_plans_constants():
    """ssd_scan.cu computes the plan again (tc_plan): its constants are these."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()

    def const(name):
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert len(found) == 1, name
        return int(found[0])

    assert const("kChunkWarps") == CHUNK_WARPS
    assert const("kCombineWarps") == COMBINE_WARPS
    assert const("kRowGroup") == ROW_GROUP
    assert const("kSTile") == S_TILE
    assert const("kMaxNTc") == MAX_N_BF16
    assert const("kPieces") == PIECES
    assert const("kHeadBytes") == HEAD_BYTES
    assert const("kCombineHeadBytes") == COMBINE_HEAD_BYTES
    for line in ("pl.nk = n <= 64 ? 4 : 8;", "pl.pt = (p + 15) / 16 * 2;",
                 "pl.split = (pl.nk == 4 && pl.pt / 2 % 2 == 0) ? 2 : 1;",
                 "pl.ld_b = 16 * pl.nk + 8;", "pl.ld_x = 8 * pl.pt + 8;"):
        assert line in src, line
