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
