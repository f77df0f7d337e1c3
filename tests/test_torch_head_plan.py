"""What surrounds the coded-head kernels, on the CPU: the launch geometry of
the thin-row engine (``kernels/thin_rows.py::head_plan``), which the CUDA
sources compute again and check, and the build key that must follow the
engine's header.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""
import re
import shutil

import pytest

from repro_torch.kernels import _build
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
@pytest.mark.parametrize("b", [1, 4, 16])
def test_matvec_plan_covers_every_row_once(r, b):
    plan = head_plan(r, 4096, b, sm_count=SMS, occupancy=_fits)
    _check_plan(plan, r, min(2, _fits(plan.smem_bytes)))
    _check_x(plan, 4096, b)
    assert plan.bt == 1 and plan.group_rows == WARPS * ROWS_PER_WARP
    assert plan.smem_bytes == b * plan.x_stride * 4


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("br", ROWS)
def test_decode_plan_covers_every_tile_once(nb, br):
    for b in (1, 4, 16):
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
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8, 16])
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
    # B = 16 at M = 4100 walks x in panels
    assert not head_plan(77, 4100, 16, sm_count=SMS, occupancy=_fits).x_resident


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
    # a source's own edit moves its key only
    src = csrc / "ssd_scan.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    again = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert again["ssd_scan"] != after["ssd_scan"]
    assert all(again[n] == after[n] for n in _build.SOURCES if n != "ssd_scan")
    # a new header moves every key
    (csrc / "other.cuh").write_text("#pragma once\n")
    assert all(_build._lib_path(n) != again[n] for n in _build.SOURCES)
