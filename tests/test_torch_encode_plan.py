"""What surrounds the encode kernels, on the CPU: the LT table's compaction
(``_lt_csr``) and ``gaussian_encode``'s launch geometry (``gaussian_plan``),
which ``kernels/lt_encode.py`` computes and the CUDA source checks again.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.lt_encode import (
    GAUSSIAN_MAX_QT,
    GAUSSIAN_SMEM_CAP,
    GAUSSIAN_SPAN,
    LT_HEAVY_DEGREE,
    _lt_csr,
    gaussian_plan,
)

SMEM_PER_BLOCK = 227 * 1024  # the most shared memory an H100 block can use
SMS = 132

# (q, r, m): the glm4-9b, mamba2-130m and zamba2-1.2b parity raises, the
# Gaussian task's reserve slice, then ragged shapes
SERVED = [(16, 13, 11658 * 4096), (16, 13, 3868 * 768), (16, 13, 2462 * 2048),
          (26, 500, 200_000)]
RAGGED = [(33, 40, 257), (5, 3, 1001), (16, 14, 1), (1, 1, 4), (70, 2000, 1000),
          (9, 5000, 513), (100, 700, 3), (32, 4097, 7)]
# q at the q-tile edges, r under and across G's panel
Q_SWEEP = [(q, r, 1000) for q in (1, 8, 9, 16, 17, 32, 33, 64, 65, 96, 97)
           for r in (13, 3000)]


def _np_csr(idx: np.ndarray, cof: np.ndarray):
    """The CSR of a padded table, built row by row in numpy."""
    row_ptr, cols, vals = [0], [], []
    for j in range(idx.shape[0]):
        for d in range(idx.shape[1]):
            if cof[j, d] != 0:
                cols.append(int(idx[j, d]))
                vals.append(cof[j, d])
        row_ptr.append(len(cols))
    return np.array(row_ptr), np.array(cols, dtype=np.int64), np.array(vals, np.float32)


def _table(q, d_max, r, zero_frac, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, r, (q, d_max))
    cof = rng.standard_normal((q, d_max)).astype(np.float32)
    cof[rng.random((q, d_max)) < zero_frac] = 0.0
    cof[q // 2] = 0.0                      # a degree-0 row
    idx[cof == 0] = r + 7                  # padding may point anywhere
    return idx, cof


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("q,d_max,r,zero_frac", [(7, 5, 20, 0.4), (40, 64, 300, 0.3),
                                                  (3, 1, 2, 0.0), (50, 100, 1000, 0.5)])
def test_lt_csr_matches_numpy(dtype, q, d_max, r, zero_frac):
    idx, cof = _table(q, d_max, r, zero_frac, q * d_max)
    csr = _lt_csr(torch.as_tensor(idx).to(dtype), torch.as_tensor(cof), r)
    row_ptr, cols, vals = _np_csr(idx, cof)
    assert csr.row_ptr.dtype == torch.int64 and csr.cols.dtype == torch.int32
    np.testing.assert_array_equal(csr.row_ptr.numpy(), row_ptr)
    np.testing.assert_array_equal(csr.cols.numpy(), cols)   # table order, zeros skipped
    np.testing.assert_array_equal(csr.vals.numpy(), vals)
    degree = np.diff(row_ptr)
    assert degree[q // 2] == 0
    # the rows by degree, largest first, ties in row order; heavy rows first
    np.testing.assert_array_equal(csr.order.numpy(), np.argsort(-degree, kind="stable"))
    assert csr.n_heavy == int((degree > LT_HEAVY_DEGREE).sum())
    assert (degree[csr.order.numpy()[:csr.n_heavy]] > LT_HEAVY_DEGREE).all()


@pytest.mark.parametrize("dtype,bad", [(torch.int32, -1), (torch.int32, 5), (torch.int64, -1),
                                       (torch.int64, 5), (torch.int64, 2**32 + 1)])
def test_lt_csr_rejects_out_of_range_nonzero_entries(dtype, bad):
    idx = torch.tensor([[0, 1, 2], [3, bad, 4]], dtype=dtype)
    with pytest.raises(IndexError, match="outside"):
        _lt_csr(idx, torch.tensor([[1.0, 0.0, 2.0], [1.0, 3.0, 0.0]]), 5)
    # the same index under a zero coefficient is padding
    csr = _lt_csr(idx, torch.tensor([[1.0, 0.0, 2.0], [1.0, 0.0, 0.0]]), 5)
    np.testing.assert_array_equal(csr.cols.numpy(), [0, 2, 3])


def _check_gaussian_plan(q, r, m, per_sm=3):
    asked = []

    def occupancy(qt, smem):
        asked.append((qt, smem))
        return per_sm

    plan = gaussian_plan(q, r, m, SMS, occupancy)
    assert asked == [(plan.qt, plan.smem_bytes)]
    # every output row lies in exactly one q-tile
    assert plan.qt % 4 == 0 and 4 <= plan.qt <= GAUSSIAN_MAX_QT
    assert plan.n_qtiles == -(-q // plan.qt)
    rows = np.concatenate([np.arange(t * plan.qt, min((t + 1) * plan.qt, q))
                           for t in range(plan.n_qtiles)])
    np.testing.assert_array_equal(rows, np.arange(q))
    # A is read once (one q-tile) when q <= 32; else once per tile, no tile idle
    if q <= GAUSSIAN_MAX_QT:
        assert plan.n_qtiles == 1
    assert (plan.n_qtiles - 1) * plan.qt < q
    # G's panels cover r and fit the stated cap, well under a block's 227 KB
    assert 1 <= plan.panel <= r
    assert plan.panel == r or plan.panel % plan.unroll == 0
    assert plan.smem_bytes == -(-plan.panel // plan.unroll) * plan.unroll * plan.qt * 4
    assert plan.smem_bytes <= GAUSSIAN_SMEM_CAP < SMEM_PER_BLOCK // 2
    assert plan.unroll == (8 if plan.qt > 16 else 16)
    assert plan.n_spans * GAUSSIAN_SPAN >= m > (plan.n_spans - 1) * GAUSSIAN_SPAN
    assert 1 <= plan.grid == min(SMS * per_sm, plan.n_qtiles * plan.n_spans)
    return plan


@pytest.mark.parametrize("q,r,m", SERVED + RAGGED + Q_SWEEP)
def test_gaussian_plan_covers_rows_and_fits(q, r, m):
    _check_gaussian_plan(q, r, m)


def test_gaussian_plan_served_shapes():
    raise_plan = _check_gaussian_plan(16, 13, 11658 * 4096)
    assert (raise_plan.qt, raise_plan.n_qtiles, raise_plan.panel) == (16, 1, 13)
    task = _check_gaussian_plan(26, 500, 200_000)
    assert (task.qt, task.n_qtiles, task.panel) == (28, 1, 500)   # G once per block
    assert _check_gaussian_plan(70, 13, 100).qt == 24               # 3 tiles, 2 rows idle
    wide = _check_gaussian_plan(32, 5000, 100)                     # r crosses the panel cap
    assert wide.panel < 5000 and -(-5000 // wide.panel) == 10
    with pytest.raises(RuntimeError, match="fits no SM"):
        gaussian_plan(16, 13, 100, SMS, lambda qt, smem: 0)


# --------------------------------------------------------------------------
# the tensor-core engine of gaussian_encode (q > GAUSSIAN_WIDE_MIN_Q) and
# lt_encode's slab engine: their plans, and the CSR encode_rows builds on
# the host
# --------------------------------------------------------------------------
from repro_torch.kernels.lt_encode import (  # noqa: E402
    GAUSSIAN_WIDE_MIN_Q,
    LT_SLAB_MIN_WIDTH,
    LT_SLAB_SMEM,
    LT_SLAB_WIDTHS,
    gaussian_engine,
    gaussian_wide_plan,
    lt_csr_host,
    lt_slab_plan,
    lt_slab_smem,
)
from repro_torch.kernels.wide_rows import COL_QUANTUM, MAX_TILE_COLS, TILE_ROWS  # noqa: E402

CSR_FIELDS = ("row_ptr", "cols", "vals", "order", "used", "slab_ptr", "slab_ent")


@pytest.mark.parametrize("q", [1, 16, 26, GAUSSIAN_WIDE_MIN_Q - 1, GAUSSIAN_WIDE_MIN_Q,
                               GAUSSIAN_WIDE_MIN_Q + 1, 48, 564, 5000])
def test_gaussian_engine_threshold(q):
    """At or below GAUSSIAN_WIDE_MIN_Q rows the register engine (A read once
    up to 32 rows); above it the tensor cores."""
    assert gaussian_engine(q) == ("register" if q <= GAUSSIAN_WIDE_MIN_Q else "wide")
    assert GAUSSIAN_WIDE_MIN_Q >= 16  # every parity raise stays on the register engine


@pytest.mark.parametrize("q,r,m", [(564, 500, 500_000), (564, 500, 100_003), (33, 40, 257),
                                   (100, 77, 1001), (257, 100, 3000), (600, 33, 5),
                                   (700, 2000, 30_000), (1, 1, 1)])
def test_gaussian_wide_plan_tiles_and_padding(q, r, m):
    """out^T = A^T G^T on wide_rows.cuh: 128 columns of A a row tile, G's
    rows in column tiles of at most 256 (a multiple of 32, equal widths),
    K = r padded to the 32-row stages; A is read once a column tile."""
    plan = gaussian_wide_plan(q, r, m, SMS)
    assert plan.n_row_tiles == -(-m // TILE_ROWS)
    assert plan.n_col_tiles == -(-q // MAX_TILE_COLS) == plan.weight_reads
    assert plan.cols % COL_QUANTUM == 0 and plan.cols <= MAX_TILE_COLS
    assert plan.b_pad == plan.n_col_tiles * plan.cols >= q > plan.b_pad - plan.cols
    assert plan.cols - COL_QUANTUM < -(-q // plan.n_col_tiles) <= plan.cols
    assert plan.bk == 32 and plan.k_tiles == -(-r // 32) and plan.m_pad == 32 * plan.k_tiles
    assert plan.pieces == 3 and plan.xp_elements == 3 * plan.b_pad * plan.m_pad
    assert plan.items == plan.n_row_tiles * plan.n_col_tiles
    assert plan.grid == min(plan.items, SMS)
    assert 2 <= plan.stages and plan.smem_bytes <= SMEM_PER_BLOCK


def test_gaussian_wide_plan_at_the_task_and_refusals():
    task = gaussian_wide_plan(564, 500, 500_000, SMS)
    assert (task.n_col_tiles, task.cols, task.b_pad, task.k_tiles, task.stages) == (3, 192, 576,
                                                                                   16, 4)
    assert task.items == 3907 * 3  # A read three times, once a column tile
    for q, r, m in [(0, 500, 10), (5, 0, 10), (5, 5, 0)]:
        with pytest.raises(ValueError, match="empty"):
            gaussian_wide_plan(q, r, m, SMS)
    with pytest.raises(ValueError, match="2\\^31"):
        gaussian_wide_plan(564, 500, 2**31, SMS)


@pytest.mark.parametrize("q,u,nnz,m,want", [
    (598, 500, 1516, 10_000, 32),          # the EC2 example's last coded task
    (150, 125, 316, 10_000, 64),           # its first (r = 125)
    (8739, 5000, 54_380, 500_000, None),   # the whole LT plan: its table alone is 510 KB
    (2672, 4842, 16_811, 500_000, None),   # the task's reserve slice
    (1, 1, 1, 4100, 16),                   # m / 32 < 132 spans: the narrowest width
    (300, 2800, 600, 1000, 16),            # one block an SM
])
def test_lt_slab_plan_width_and_which_tables_fit(q, u, nnz, m, want):
    """Of the widths whose slab fits beside the table, those that let two
    blocks share an SM, then the widest that gives every SM a span (else
    the narrowest); None where not even a slab of LT_SLAB_MIN_WIDTH columns
    fits beside the table: the L2 engine then."""
    plan = lt_slab_plan(q, u, nnz, m, SMS)
    if want is None:
        assert plan is None
        assert lt_slab_smem(q, u, nnz, LT_SLAB_MIN_WIDTH) > LT_SLAB_SMEM
        return
    assert plan.width == want
    assert plan.width in LT_SLAB_WIDTHS and plan.width >= LT_SLAB_MIN_WIDTH
    assert plan.smem_bytes == lt_slab_smem(q, u, nnz, plan.width) <= LT_SLAB_SMEM
    assert plan.smem_bytes % 16 == 0
    assert plan.smem_bytes >= u * plan.width * 4 + 8 * nnz + 4 * (2 * q + 1)
    assert plan.n_spans == -(-m // plan.width)
    pairs = [w for w in LT_SLAB_WIDTHS if lt_slab_smem(q, u, nnz, w) <= LT_SLAB_SMEM // 2]
    if pairs:
        assert plan.width in pairs
        wider = [w for w in pairs if w > plan.width]
        assert all(-(-m // w) < SMS for w in wider)
    with pytest.raises(ValueError):
        lt_slab_plan(0, u, nnz, m, SMS)


def _assert_same_csr(got, want):
    for f in CSR_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), f
    assert (got.n_heavy, got.n_used) == (want.n_heavy, want.n_used)


def _check_rank_order(csr, idx, cof):
    """slab_ent holds each rank's row's nonzero entries in table order: its
    source rows through used, its coefficients' bits."""
    used, ent = csr.used.numpy(), csr.slab_ent.numpy()
    assert csr.n_used == used.size == np.unique(idx[cof != 0]).size
    for rank in range(csr.order.numel()):
        j = int(csr.order[rank])
        s0, s1 = int(csr.slab_ptr[rank]), int(csr.slab_ptr[rank + 1])
        nz = cof[j] != 0
        np.testing.assert_array_equal(used[ent[s0:s1, 0]], idx[j][nz])
        np.testing.assert_array_equal(ent[s0:s1, 1].view(np.float32), cof[j][nz])


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("q,d_max,r,zero_frac", [(7, 5, 20, 0.4), (40, 64, 300, 0.3),
                                                  (3, 1, 2, 0.0), (50, 100, 1000, 0.5)])
def test_lt_csr_host_matches_the_torch_compaction(dtype, q, d_max, r, zero_frac):
    idx, cof = _table(q, d_max, r, zero_frac, q * d_max)
    host = lt_csr_host(idx.astype(dtype), cof, r)
    _assert_same_csr(host, _lt_csr(torch.as_tensor(idx.astype(dtype)), torch.as_tensor(cof), r))
    _check_rank_order(host, idx, cof)
    with pytest.raises(IndexError, match="outside"):
        lt_csr_host(np.array([[0, 5]]), np.array([[1.0, 2.0]], np.float32), 5)


@pytest.fixture(scope="module")
def task_tables():
    """The LT tables the task path hands the encode: the whole scenario-1
    plan (a run at m = 8) and every coded task's of the EC2 example."""
    import contextlib
    import importlib.util
    import io
    import os

    from repro_torch.kernels.autotune import lt_task_table

    r, plan = lt_task_table(0, reserve=False)
    tables = [("scenario 1, all of A-hat", r, plan.indices, plan.coeffs)]
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "ec2_repro_torch.py")
    spec = importlib.util.spec_from_file_location("ec2_repro_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with contextlib.redirect_stdout(io.StringIO()):
        records = example.main(["--scale", "40", "--trials", "2", "--m", "64",
                                "--device", "cpu"])
    for i, rec in enumerate(x for x in records if x["scheme"] in ("hcmm", "bpcc")):
        p = rec["encode"]["plan"]
        tables.append((f"ec2 coded task {i}", rec["a_shape"][0], p.indices, p.coeffs))
    return tables


def test_lt_csr_host_equals_torch_at_the_task_tables(task_tables):
    """encode_rows' host CSR is _lt_csr's on CPU tensors, field by field, at
    scenario 1's whole plan and at all 32 coded tasks of the EC2 example; the
    whole plan goes to the L2 engine, every EC2 table to the slab engine."""
    assert len(task_tables) == 33
    for label, r, idx, cof in task_tables:
        host = lt_csr_host(idx, cof, r)
        _assert_same_csr(host, _lt_csr(torch.as_tensor(idx), torch.as_tensor(cof), r))
        q, u, nnz = host.order.numel(), host.n_used, host.cols.numel()
        m = 500_000 if label.startswith("scenario") else 10_000
        assert (lt_slab_plan(q, u, nnz, m, SMS) is None) == label.startswith("scenario"), label
        assert (host.slab_ent is None) == label.startswith("scenario"), label
    _, r, idx, cof = task_tables[-1]
    _check_rank_order(lt_csr_host(idx, cof, r), idx, cof)
    whole = lt_csr_host(*task_tables[0][2:], task_tables[0][1])
    assert (whole.order.numel(), whole.cols.numel(), whole.n_used) == (8739, 54_380, 5000)
    assert whole.used is None and whole.slab_ptr is None  # no slab: nothing built for one


def test_autotune_merge_replaces_only_the_remeasured_ops():
    """``--ops gaussian_encode,lt_encode --merge`` writes the encode cells
    over the committed table: every entry of another op kept as it was,
    every old entry of a re-measured op gone (a cell no longer measured, as
    the Gaussian task's old reserve shape, too), the merge recorded."""
    from repro_torch.kernels import autotune

    def entry(op, shape, us):
        return {"op": op, "shape": shape, "dtype": "float32", "backend": "cuda", "us": us,
                "flagged": us > 100}

    base = {"meta": {"card": "H100, 700 W", "quick": False}, "flagged_cells": 0,
            "entries": [entry("coded_matvec", "1x2x3", 5.0),
                        entry("gaussian_encode", "26x500x200000", 200.0),
                        entry("gaussian_encode", "16x13x700", 9.0),
                        entry("lt_encode", "2672x5000x500000", 90.0)]}
    new = {"meta": {"card": "H100, 700 W", "quick": False},
           "entries": [entry("gaussian_encode", "564x500x500000", 2900.0),
                       entry("gaussian_encode", "16x13x700", 8.0),
                       entry("lt_encode", "2672x5000x500000", 95.0)]}
    doc = autotune.merge_table(base, new)
    got = {(e["op"], e["shape"]): e["us"] for e in doc["entries"]}
    assert got == {("coded_matvec", "1x2x3"): 5.0, ("gaussian_encode", "564x500x500000"): 2900.0,
                   ("gaussian_encode", "16x13x700"): 8.0,
                   ("lt_encode", "2672x5000x500000"): 95.0}
    assert doc["flagged_cells"] == 1
    assert doc["meta"]["quick"] is False and doc["meta"]["card"] == "H100, 700 W"
    assert doc["meta"]["remeasured"]["ops"] == ["gaussian_encode", "lt_encode"]
    assert base["entries"][1]["shape"] == "26x500x200000"  # the base is not changed


def test_slab_constants_mirror_the_source():
    """kernels/lt_encode.py's slab constants are lt_encode.cu's."""
    import re

    from repro_torch.kernels._build import CSRC
    from repro_torch.kernels.lt_encode import LT_SLAB_LANE_COLS

    src = (CSRC / "lt_encode.cu").read_text()
    assert int(re.search(r"constexpr int kLaneCols = (\d+);", src).group(1)) == LT_SLAB_LANE_COLS
    assert "constexpr int kSlabSmemMax = 227 * 1024 - 64;" in src
    assert LT_SLAB_SMEM == 227 * 1024 - 64
    assert all(w % 4 == 0 and w % LT_SLAB_LANE_COLS == 0 for w in LT_SLAB_WIDTHS)


def test_lt_csr_of_an_all_padding_table_takes_the_l2_engine():
    """No nonzero entry: u = 0, nothing to stage, so no slab tables (the L2
    engine writes the zero rows); host and torch agree."""
    idx = np.full((4, 3), 7, np.int64)
    cof = np.zeros((4, 3), np.float32)
    host = lt_csr_host(idx, cof, 5)
    _assert_same_csr(host, _lt_csr(torch.as_tensor(idx), torch.as_tensor(cof), 5))
    assert host.n_used == 0 and host.used is None and host.slab_ent is None
    np.testing.assert_array_equal(host.row_ptr.numpy(), np.zeros(5))
