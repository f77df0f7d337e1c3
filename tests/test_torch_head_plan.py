"""What surrounds the coded-head kernels, on the CPU: the launch geometry of
the thin-row engine (``kernels/thin_rows.py::head_plan``) and of the wide
engine (``kernels/wide_rows.py::wide_plan``), which the CUDA sources
compute again and check, and the build key that must follow the engines'
headers.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""
import re
import shutil

import pytest

from repro_torch.configs import ARCHS
from repro_torch.kernels import _build, wide_rows
from repro_torch.kernels.thin_rows import (
    MAX_B,
    MAX_GROUP_ROWS,
    ROWS_PER_WARP,
    SMEM_PER_BLOCK,
    WARPS,
    X_CAP_BYTES,
    X_PANEL_QUANTUM,
    head_plan,
)
from repro_torch.kernels.wide_rows import WIDE_MIN_B, wide_plan

SMS = 132
ROWS = [1, 131, 132, 133, 10826, 11658, 173216]
NBS = [1, 3, 16, 17, 32]
# thin_rows.cuh's block_units, checked word for word in test_header_constants_match_the_plan
BLOCK_UNITS = "return {block, grid, static_cast<int>(geo.share) + (block < geo.extra ? 1 : 0)};"


def _fits(smem):
    """The occupancy of a 227 KB SM for blocks of ``smem`` bytes (1 KB reserved each)."""
    return (228 * 1024) // (smem + 1024)


def _block_units(n_units, grid, block):
    """The units of ``block`` as thin_rows.cuh's block_units gives them: block
    + j * grid for j below share (n_units // grid), plus one for the first
    extra (n_units % grid) blocks."""
    count = n_units // grid + (block < n_units % grid)
    return [block + j * grid for j in range(count)]


def _check_plan(plan, n_units, per_sm):
    # the grid never exceeds its SM multiple, nor one block a unit
    assert 1 <= plan.grid == min(n_units, SMS * per_sm)
    assert plan.n_units == n_units
    shares = [_block_units(n_units, plan.grid, i) for i in range(plan.grid)]
    sizes = [len(units) for units in shares]
    # shares that differ by at most one unit, covering every unit once
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    assert sorted(u for units in shares for u in units) == list(range(n_units))
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert 1 <= plan.group_rows <= MAX_GROUP_ROWS


def _check_x(plan, m, b):
    m4 = -(-m // 4) * 4
    assert plan.x_resident == (b * m4 * 4 <= X_CAP_BYTES)
    if plan.x_resident:
        assert (plan.x_panel, plan.x_stride) == (m, m4)
    else:
        assert plan.x_panel % X_PANEL_QUANTUM == 0 and plan.x_panel == plan.x_stride
        assert b * plan.x_panel * 4 <= X_CAP_BYTES < b * (plan.x_panel + X_PANEL_QUANTUM) * 4
    assert plan.smem_bytes >= b * plan.x_stride * 4


@pytest.mark.parametrize("r", ROWS)
@pytest.mark.parametrize("b", [1, 4, MAX_B])
def test_matvec_plan_covers_every_row_once(r, b):
    plan = head_plan(r, 4096, b, sm_count=SMS, occupancy=_fits)
    _check_plan(plan, r, min(2, _fits(plan.smem_bytes)))
    _check_x(plan, 4096, b)
    assert plan.bt == 1 and plan.group_rows == WARPS * ROWS_PER_WARP
    assert plan.smem_bytes == b * plan.x_stride * 4


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("br", ROWS)
def test_decode_plan_covers_every_tile_once(nb, br):
    for b in (1, 4, MAX_B):
        n_data = max(1, nb - 2)
        plan = head_plan(nb * br, 4096, b, sm_count=SMS, occupancy=_fits, nb=nb, n_data=n_data)
        bt = MAX_GROUP_ROWS // nb
        assert plan.bt == bt and plan.group_rows == nb * bt
        _check_plan(plan, -(-br // bt), min(2, _fits(plan.smem_bytes)))
        _check_x(plan, 4096, b)
        # the epilogue: two mbarrier pairs, two tiles' coded sums and R
        assert plan.smem_bytes == b * plan.x_stride * 4 + 32 + 4 * (2 * nb * bt * b + n_data * nb)
        # the tiles cover each block's rows once: bt rows a tile, the last ragged
        assert (plan.n_units - 1) * bt < br <= plan.n_units * bt


@pytest.mark.parametrize("m", [1, 3, 129, 4096, 4097, 4100, 16384, 16385, 100_000])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 6, MAX_B])
def test_x_resident_exactly_under_the_cap(m, b):
    for nb in (None, 16):
        plan = head_plan(16 * 1000, m, b, sm_count=SMS, occupancy=_fits, nb=nb,
                         n_data=nb and 14)
        _check_x(plan, m, b)
        assert plan.smem_bytes <= SMEM_PER_BLOCK


def test_served_shapes():
    # glm4-9b code block, B = 4: 10826 rows over 132 SMs, 82 +- 1 an SM
    blk = head_plan(10826, 4096, 4, sm_count=SMS, occupancy=lambda s: 1)
    assert blk.x_resident and blk.x_stride * 4 * 4 == X_CAP_BYTES and blk.grid == SMS
    assert {len(_block_units(10826, SMS, i)) for i in range(SMS)} == {82, 83}
    # at two blocks an SM the grid doubles
    assert head_plan(10826, 4096, 4, sm_count=SMS, occupancy=lambda s: 2).grid == 2 * SMS
    # glm4-9b W_c, nb = 16: tiles of 2 rows a block, 5413 tiles, 41 +- 1 an SM
    wc = head_plan(16 * 10826, 4096, 4, sm_count=SMS, occupancy=lambda s: 1, nb=16, n_data=14)
    assert (wc.bt, wc.group_rows, wc.n_units, wc.grid) == (2, 32, 5413, SMS)
    assert {len(_block_units(5413, SMS, i)) for i in range(SMS)} == {41, 42}
    # B = 7 at M = 4100 walks x in panels
    assert not head_plan(77, 4100, MAX_B, sm_count=SMS, occupancy=_fits).x_resident


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(RuntimeError, match="fits no SM"):
        head_plan(100, 64, 1, sm_count=SMS, occupancy=lambda s: 0)
    for kw in ({"nb": 33, "n_data": 1}, {"nb": 4, "n_data": 5}, {"nb": 3, "n_data": 1},
               {"nb": 4, "n_data": 0}):
        with pytest.raises(ValueError):
            head_plan(100, 64, 1, sm_count=SMS, occupancy=_fits, **kw)
    for b in (0, MAX_B + 1):
        with pytest.raises(ValueError):
            head_plan(100, 64, b, sm_count=SMS, occupancy=_fits)


def _check_columns(plan, b):
    """Column tiles of equal width, each the tightest multiple of 32 that
    holds its share, at most 256 wide, cover x's b columns once, in as few
    tiles as 256 columns allow; the weight is read once a tile."""
    assert plan.n_col_tiles == -(-b // wide_rows.MAX_TILE_COLS) == plan.weight_reads
    share = -(-b // plan.n_col_tiles)
    assert plan.cols % wide_rows.COL_QUANTUM == 0 and share <= plan.cols < share + 32
    assert plan.cols <= wide_rows.MAX_TILE_COLS
    tiles = [(i * plan.cols, min(b, (i + 1) * plan.cols)) for i in range(plan.n_col_tiles)]
    assert tiles[0][0] == 0 and tiles[-1][1] == b and all(lo < hi for lo, hi in tiles)
    assert plan.b_pad == plan.n_col_tiles * plan.cols


def _check_wide(plan, n_row_tiles, m, half=False):
    """The items (row tile x column tile) over the persistent grid: each
    once, the blocks' shares within one item; the ring in 227 KB."""
    assert plan.items == n_row_tiles * plan.n_col_tiles
    assert plan.grid == min(plan.items, SMS)
    shares = [_block_units(plan.items, plan.grid, i) for i in range(plan.grid)]
    sizes = [len(units) for units in shares]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    assert sorted(u for units in shares for u in units) == list(range(plan.items))
    assert plan.smem_bytes <= wide_rows.SMEM_PER_BLOCK and 2 <= plan.stages
    ring = plan.stages * plan.stage_bytes
    assert plan.smem_bytes - wide_rows.ALIGN - wide_rows.BARRIER_BYTES - ring >= 0
    # as many stages as fit, up to the cap
    assert plan.stages == wide_rows.MAX_STAGES or (
        plan.smem_bytes + plan.stage_bytes > wide_rows.SMEM_PER_BLOCK)
    elt = 2 if half else 4
    assert plan.bk * elt == wide_rows.W_ROW_BYTES and plan.pieces == (1 if half else 3)
    assert plan.stage_bytes == (wide_rows.TILE_ROWS * wide_rows.W_ROW_BYTES
                                + plan.pieces * plan.cols * plan.bk * 2)
    # the K loop covers M once; x's pieces are padded to whole stages
    assert (plan.k_tiles - 1) * plan.bk < m <= plan.k_tiles * plan.bk == plan.m_pad
    assert plan.xp_elements == plan.pieces * plan.b_pad * plan.m_pad


@pytest.mark.parametrize("b", [1, 2, 15, 16, 17, 31, 32, 33, 100, 128, 129])
def test_wide_column_tiles_cover_x_in_one_launch(b):
    """Any width of x is one launch: column tiles of at most 256 columns
    tile its columns in order (the thin-row engine's panels of 16 are gone)."""
    plan = wide_plan(10826, 4096, b, sm_count=SMS)
    _check_columns(plan, b)
    _check_wide(plan, -(-10826 // 128), 4096)


def _head_shapes():
    """Every config's coded head at (14, 2) and (13, 3): W_c and one code block."""
    for name, cfg in sorted(ARCHS.items()):
        for n_data, n_parity in ((14, 2), (13, 3)):
            yield name, n_data, n_parity, -(-cfg.vocab // n_data), cfg.d_model


HEADS = list(_head_shapes())


@pytest.mark.parametrize("name,n_data,n_parity,br,m", HEADS)
@pytest.mark.parametrize("b", [17, 33, 64, 128, 256, 300])
def test_wide_plan_covers_every_tile_and_column_once(name, n_data, n_parity, br, m, b):
    nb = n_data + n_parity
    # the decode over W_c: tiles of bt = 128 // nb rows of every block
    dec = wide_plan(nb * br, m, b, sm_count=SMS, nb=nb, n_data=n_data)
    assert dec.bt == 128 // nb and dec.tile_rows == nb * dec.bt <= wide_rows.TILE_ROWS
    assert (dec.n_row_tiles - 1) * dec.bt < br <= dec.n_row_tiles * dec.bt
    _check_columns(dec, b)
    _check_wide(dec, dec.n_row_tiles, m)
    # the decode's scratch: 128 rows of 33 floats and R transposed, its
    # n_data rounded up to the 8 decoded rows a thread sums at once
    assert (dec.smem_bytes - wide_rows.ALIGN - wide_rows.BARRIER_BYTES
            - dec.stages * dec.stage_bytes) == 128 * 33 * 4 + 4 * nb * -(-n_data // 8) * 8
    # coded_matvec over a code block (the mesh head), fp32 and fp16
    for half in (False, True):
        blk = wide_plan(br, m, b, sm_count=SMS, half=half)
        assert blk.bt == 0 and blk.tile_rows == 128
        assert (blk.n_row_tiles - 1) * 128 < br <= blk.n_row_tiles * 128
        _check_columns(blk, b)
        _check_wide(blk, blk.n_row_tiles, m, half)
        assert blk.smem_bytes == (wide_rows.ALIGN + wide_rows.BARRIER_BYTES
                                  + blk.stages * blk.stage_bytes)


def test_wide_served_shapes():
    # glm4-9b W_c at 64 slots: 1354 tiles of 8 rows of each of 16 blocks on
    # 132 SMs (10 or 11 a block), 64 columns, six stages; read once
    wc = wide_plan(16 * 10826, 4096, 64, sm_count=SMS, nb=16, n_data=14)
    assert (wc.bt, wc.n_row_tiles, wc.grid, wc.cols, wc.stages) == (8, 1354, SMS, 64, 6)
    assert {len(_block_units(1354, SMS, i)) for i in range(SMS)} == {10, 11}
    # the dry run's mamba2-130m decode at 128 columns: one tile wide
    mb = wide_plan(16 * 3592, 768, 128, sm_count=SMS, nb=16, n_data=14)
    assert (mb.n_col_tiles, mb.cols, mb.k_tiles) == (1, 128, 24)
    # B = 300: two tiles of 160 columns, the weight read twice
    two = wide_plan(1001, 4104, 300, sm_count=SMS)
    assert (two.n_col_tiles, two.cols, two.weight_reads, two.m_pad) == (2, 160, 2, 4128)
    # B = 256 fills the widest tile with three stages
    full = wide_plan(10826, 4096, 256, sm_count=SMS)
    assert (full.cols, full.stages) == (256, 3)


def test_wide_plan_refuses_what_the_kernels_do_not_take():
    for kw in ({"nb": 33, "n_data": 1}, {"nb": 4, "n_data": 5}, {"nb": 3, "n_data": 1},
               {"nb": 4, "n_data": 0}, {"nb": 4, "n_data": 2, "half": True}):
        with pytest.raises(ValueError):
            wide_plan(100, 64, 20, sm_count=SMS, **kw)
    for b in (0, -1):
        with pytest.raises(ValueError):
            wide_plan(100, 64, b, sm_count=SMS)
    # the thin-row engine takes what the wide one does not, and no more
    assert 1 < WIDE_MIN_B == MAX_B + 1
    head_plan(100, 64, WIDE_MIN_B - 1, sm_count=SMS, occupancy=_fits)
    with pytest.raises(ValueError):
        head_plan(100, 64, WIDE_MIN_B, sm_count=SMS, occupancy=_fits)


def test_wide_header_constants_match_the_plan():
    text = (_build.CSRC / "wide_rows.cuh").read_text()
    consts = {name: value for _, name, value in
              re.findall(r"constexpr (bool|int) (\w+) = ([^;]+);", text)}
    want = {"kTileRows": wide_rows.TILE_ROWS, "kColQuantum": wide_rows.COL_QUANTUM,
            "kMaxTileCols": wide_rows.MAX_TILE_COLS, "kMaxStages": wide_rows.MAX_STAGES,
            "kConsumerWarps": wide_rows.CONSUMER_WARPS, "kWRowBytes": wide_rows.W_ROW_BYTES,
            "kAlign": wide_rows.ALIGN, "kSmemLimit": wide_rows.SMEM_PER_BLOCK,
            "kMaxBlocks": wide_rows.MAX_BLOCKS}
    for name, value in want.items():
        assert eval(consts[name]) == value, name
    env = {k: eval(v.split("//")[0], {}, {"kColQuantum": wide_rows.COL_QUANTUM,
                                          "kMaxStages": wide_rows.MAX_STAGES,
                                          "kConsumerWarps": wide_rows.CONSUMER_WARPS})
           for k, v in consts.items() if k in ("kEpiPitch", "kBarrierBytes", "kThreads")}
    assert (env["kEpiPitch"], env["kBarrierBytes"], env["kThreads"]) == (
        wide_rows.EPI_PITCH, wide_rows.BARRIER_BYTES, wide_rows.THREADS)
    # the persistent grid walks its items as _block_units does
    assert "for (int item = blockIdx.x; item < geo.items; item += gridDim.x)" in text
    for name in ("coded_matvec", "coded_decode"):
        assert '#include "wide_rows.cuh"' in (_build.CSRC / f"{name}.cu").read_text()


def test_header_constants_match_the_plan():
    text = (_build.CSRC / "thin_rows.cuh").read_text()
    consts = {name: value for _, name, value in
              re.findall(r"constexpr (bool|int) (\w+) = ([^;]+);", text)}
    assert int(consts["kWarps"]) == WARPS
    assert int(consts["kRowsPerWarp"]) == ROWS_PER_WARP
    assert int(consts["kMaxB"]) == MAX_B
    assert int(consts["kMaxGroupRows"]) == MAX_GROUP_ROWS
    assert eval(consts["kXCapBytes"]) == X_CAP_BYTES
    assert int(consts["kXPanelQuantum"]) == X_PANEL_QUANTUM
    assert eval(consts["kSmemLimit"]) == SMEM_PER_BLOCK
    assert BLOCK_UNITS in text
    for name in ("coded_matvec", "coded_decode"):
        assert '#include "thin_rows.cuh"' in (_build.CSRC / f"{name}.cu").read_text()


def test_build_key_follows_the_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    header = csrc / "thin_rows.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in ("coded_matvec", "coded_decode"))
    wide = csrc / "wide_rows.cuh"
    wide.write_bytes(wide.read_bytes() + b"\n// edited\n")
    assert all(_build._lib_path(n) != after[n] for n in ("coded_matvec", "coded_decode"))
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    # a source's own edit moves its key only
    src = csrc / "ssd_scan.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    again = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert again["ssd_scan"] != after["ssd_scan"]
    assert all(again[n] == after[n] for n in _build.SOURCES if n != "ssd_scan")
    # a new header moves every key
    (csrc / "other.cuh").write_text("#pragma once\n")
    assert all(_build._lib_path(n) != again[n] for n in _build.SOURCES)
