"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips, with its reason, where
there is no CUDA device.  This file imports neither jax nor the reference,
so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m gpu -q

Tolerance: |kernel - plain| <= 1e-4 * max(1, max|plain|) — both fp32, summed
in another order; for fp16 inputs of ``coded_matvec`` (fp32 sums in both)
the reference's fp16 bound, 2e-3.  The SSD kernels, fp32 or bf16 inputs
(cast to fp32 in both; bf16 runs on the tensor cores with each fp32
operand in three bf16 pieces): the reference's rtol 1e-4 and atol 1e-5,
the atol scaled by max|plain|.  The prefill attention kernel (bf16): cache
rows bit-equal to its plain version's; its output's error against an fp32
SDPA no larger than the plain bf16 SDPA's plus one rounding of the output
(2^-9 of max|out|).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.coded_ops import encode_blocks
from repro_torch.core.decoding import get_decoder_cache
from repro_torch.core.encoding import GaussianCode, LTCode
from repro_torch.kernels import ops
from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda
from repro_torch.kernels.coded_matvec import coded_matvec_cuda
from repro_torch.kernels.lt_encode import (
    GAUSSIAN_WIDE_MIN_Q,
    LT_HEAVY_DEGREE,
    _lt_csr,
    _lt_launch,
    gaussian_encode_cuda,
    gaussian_engine,
    lt_csr_host,
    lt_encode_csr_cuda,
    lt_encode_cuda,
)
from repro_torch.kernels.masked_pinv import masked_pinv_cuda
from repro_torch.kernels.prefill_attn import prefill_attn_cuda
from repro_torch.kernels.ssd_scan import ssd_chunk_cuda, ssd_combine_cuda

# (r, m, b): the reference's coded_matvec sweep (tests/test_kernels.py), then
# ragged shapes: M % 8 != 0 (fp16 scalar loads), B = 16, one row
MATVEC_SHAPES = [(64, 64, 1), (100, 70, 1), (256, 512, 4), (300, 1000, 8), (1, 4096, 1),
                 (513, 129, 3), (77, 4100, 16), (33, 1030, 5), (1, 1, 1)]
# (n_data, n_parity, out, inner, b): ragged block rows, unaligned inner, B = 1..16
DECODE_SHAPES = [
    (6, 2, 100, 64, 8),
    (12, 4, 256, 32, 1),
    (4, 2, 64, 129, 3),
    (14, 2, 515, 130, 4),
    (13, 3, 77, 516, 16),
]
# (q, r, m): the encode's skinny K, ragged q / r / M; then every q-tile
# edge (QT is q rounded up to 4, tiles of at most 32 rows); an r that
# crosses G's 64 KB shared-memory panel (QT 32: 512 rows); and M spanning
# many grid-stride steps of the persistent grid (M % 4 == 0 and != 0); then
# for the tensor-core engine q at GAUSSIAN_WIDE_MIN_Q and either side of
# it, the Gaussian task's q = 564 at r = 500 with a ragged M, an r not a
# multiple of 16 and q over two column tiles of 256
ENCODE_SHAPES = [(16, 13, 700), (16, 14, 1), (5, 3, 129), (33, 40, 257), (1, 1, 4),
                 *((q, 13, 1031) for q in (1, 8, 9, 16, 17, 26, 32, 33, 70)),
                 (26, 500, 2048), (32, 1500, 517), (70, 2000, 260),
                 (16, 13, 4_000_000), (26, 50, 1_000_003),
                 *((q, 500, 4099) for q in (GAUSSIAN_WIDE_MIN_Q - 1, GAUSSIAN_WIDE_MIN_Q,
                                            GAUSSIAN_WIDE_MIN_Q + 1)),
                 (564, 500, 100_003), (100, 77, 1001), (257, 100, 3000)]
# (q, d_max, r, m, zero_frac): LT degree tables with zeros anywhere in a row
# and a degree-0 row; M % 4 != 0 (scalar loads), M over several 128-column
# spans, q = 1 with d_max = 1, rows of degree over 64 (the heavy path) and
# light rows of over 32 entries; M spanning many narrow spans
LT_SHAPES = [(6, 5, 20, 64, 0.4), (9, 3, 11, 129, 0.5), (1, 1, 3, 7, 0.0),
             (40, 7, 30, 4097, 0.3), (3, 600, 1000, 8200, 0.2), (70000, 2, 5, 4, 0.0),
             (50, 100, 300, 5000, 0.3), (20, 64, 100, 1031, 0.1), (300, 40, 500, 20_000, 0.6)]

# (Q, P, N): chunk lengths 2 (a 2-token prompt), 100 (a 100-token prompt)
# and 256 (full chunks) at the full widths of mamba2-130m (P 48, N 128) and
# zamba2-1.2b (P 64, N 64), and a ragged small one
SSD_SHAPES = [(q, p, n) for q in (2, 100, 256) for p, n in ((48, 128), (64, 64))] + [(37, 5, 19)]


def _masks(n_data, n_parity):
    nb = n_data + n_parity
    out = [np.ones(nb, np.float32)]
    for erased in [(1,), tuple(range(n_parity)), tuple(range(nb - n_parity, nb))]:
        m = np.ones(nb, np.float32)
        m[list(erased)] = 0.0
        out.append(m)
    return out


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels build and run only on a GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_data,n_parity,out,inner,b", DECODE_SHAPES)
def test_cuda_coded_matvec_decode_matches_plain(n_data, n_parity, out, inner, b):
    dev = _cuda()
    rng = np.random.default_rng(n_data * 100 + out + inner)
    w = torch.as_tensor(rng.standard_normal((out, inner)).astype(np.float32))
    wc_d = encode_blocks(w, n_data, n_parity).to(dev)
    x_d = torch.as_tensor(rng.standard_normal((inner, b)).astype(np.float32), device=dev)
    cache = get_decoder_cache(n_data, n_parity)
    for m in _masks(n_data, n_parity):
        rec = cache.recovery(torch.as_tensor(m, device=dev))
        before = coded_matvec_decode_cuda.launches
        got = ops.coded_matvec_decode(wc_d, x_d, rec)
        assert coded_matvec_decode_cuda.launches == before + 1
        want = ops.coded_matvec_decode(wc_d, x_d, rec, mode="off")
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, want.abs().max().item()))


@pytest.mark.gpu
@pytest.mark.parametrize("q,r,m", ENCODE_SHAPES)
def test_cuda_gaussian_encode_matches_plain(q, r, m):
    """The engine the wrapper picks (one launch, the tensor-core engine's
    counted apart above GAUSSIAN_WIDE_MIN_Q rows), and the other one asked
    for by name, each within the file's tolerance."""
    dev = _cuda()
    rng = np.random.default_rng(q * 1000 + r * 10 + m)
    g = torch.as_tensor(rng.standard_normal((q, r)).astype(np.float32), device=dev)
    a = torch.as_tensor(rng.standard_normal((r, m)).astype(np.float32), device=dev)
    before = (gaussian_encode_cuda.launches, gaussian_encode_cuda.wide_launches)
    got = ops.gaussian_encode(g, a)
    wide = gaussian_engine(q) == "wide"
    assert (gaussian_encode_cuda.launches, gaussian_encode_cuda.wide_launches) == (
        before[0] + 1, before[1] + int(wide))
    other = gaussian_encode_cuda(g, a, engine="register" if wide else "wide")
    want = ops.gaussian_encode(g, a, mode="off")
    torch.cuda.synchronize()
    for out in (got, other):
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, want.abs().max().item()))


@pytest.mark.gpu
@pytest.mark.parametrize("q,r,m", [(564, 500, 100_003), (48, 500, 20_000)])
def test_cuda_gaussian_wide_engine_within_twice_fp32_error_of_float64(q, r, m):
    """The tensor-core engine's six bf16 products against G A in float64, at
    the Gaussian task's K: within twice fp32 torch.matmul's error."""
    dev = _cuda()
    rng = np.random.default_rng(q + m)
    g = torch.as_tensor((rng.standard_normal((q, r)) / np.sqrt(r)).astype(np.float32), device=dev)
    a = torch.as_tensor(rng.standard_normal((r, m)).astype(np.float32), device=dev)
    want = g.double() @ a.double()
    scale = want.abs().max().item()
    wide = (gaussian_encode_cuda(g, a, engine="wide").double() - want).abs().max().item()
    fp32 = (torch.matmul(g, a).double() - want).abs().max().item()
    assert wide / scale <= 2 * fp32 / scale, (wide, fp32)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 3])
def test_cuda_gaussian_wide_engine_on_misaligned_views(offset):
    """A view off a 16-byte boundary, and M % 4 != 0: the tensor-core
    engine's producer warp loads A itself, into the TMA's layout."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(offset)
    for r, m in ((500, 20_000), (77, 4097)):
        a = torch.randn(offset + r * m, device=dev, generator=gen)[offset:].view(r, m)
        g = torch.randn(40, r, device=dev, generator=gen)
        got = gaussian_encode_cuda(g, a, engine="wide")
        want = ops.gaussian_encode(g, a, mode="off")
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, want.abs().max().item()))


def _lt_table(q, d_max, r, zero_frac, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, r, (q, d_max)).astype(np.int32)
    cof = rng.standard_normal((q, d_max)).astype(np.float32)
    cof[rng.random((q, d_max)) < zero_frac] = 0.0
    if q > 1:
        cof[q // 2] = 0.0
    return idx, cof


@pytest.mark.gpu
@pytest.mark.parametrize("q,d_max,r,m,zero_frac", LT_SHAPES)
def test_cuda_lt_encode_matches_plain(q, d_max, r, m, zero_frac):
    """The kernel sums in the plain version's order with the same roundings,
    so the two agree bit for bit: asserted on top of the file's tolerance."""
    dev = _cuda()
    idx, cof = _lt_table(q, d_max, r, zero_frac, q + m)
    a = torch.as_tensor(np.random.default_rng(m).standard_normal((r, m)).astype(np.float32),
                        device=dev)
    i_t, c_t = torch.as_tensor(idx, device=dev), torch.as_tensor(cof, device=dev)
    before = lt_encode_cuda.launches
    got = ops.lt_encode(a, i_t, c_t)
    assert lt_encode_cuda.launches == before + 1
    want = ops.lt_encode(a, i_t, c_t, mode="off")
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * max(1.0, want.abs().max().item()))
    assert torch.equal(got, want)
    if q > 1:
        assert not got[q // 2].any()


@pytest.mark.parametrize("m", [3001, 3000, 128, 33])
@pytest.mark.gpu
def test_cuda_lt_encode_full_chunks_heavy_rows_and_empty_rows_bit_equal(m):
    """A table built to reach every kind of unit: two heavy rows (degree 70
    and 190), 64 light rows (four full chunks of 16, their lists past 32
    entries), degree-0 rows among them, two of them adjacent; then the same
    CSR with no row marked heavy, so the heavy rows run as light ones.
    Both give the plain version's bits, in the float4 and scalar variants."""
    dev = _cuda()
    rng = np.random.default_rng(m)
    idx = rng.integers(0, 200, (66, 190)).astype(np.int32)
    cof = rng.standard_normal((66, 190)).astype(np.float32)
    cof[:, 40:] = 0.0
    cof[rng.random((66, 190)) < 0.5] = 0.0  # light rows of degree ~20
    cof[7, :70] = 1.5                       # degree 70: heavy
    cof[50] = rng.standard_normal(190)      # degree 190: heavy
    cof[[3, 20, 21, 65]] = 0.0              # degree-0 rows
    a = torch.as_tensor(rng.standard_normal((200, m)).astype(np.float32), device=dev)
    i_t, c_t = torch.as_tensor(idx, device=dev), torch.as_tensor(cof, device=dev)
    want = ops.lt_encode(a, i_t, c_t, mode="off")
    csr = _lt_csr(i_t, c_t, 200)
    assert csr.n_heavy == 2 and LT_HEAVY_DEGREE < 70
    for c in (csr, csr._replace(n_heavy=0)):
        for engine in ("l2", "slab"):
            got = _lt_launch(a, c, engine=engine)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (c.n_heavy, engine)
    assert not want[[3, 20, 21, 65]].any()


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cuda_encode_kernels_on_misaligned_views(offset):
    """A viewed from an element offset into a flat buffer (M % 4 == 0, the
    start off a 16-byte boundary): both kernels take their scalar loads."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(offset)
    r, m = 40, 2052
    a = torch.randn(offset + r * m, device=dev, generator=gen)[offset:].view(r, m)
    assert a.data_ptr() % 16 != 0 and a.is_contiguous()
    g = torch.randn(26, r, device=dev, generator=gen)
    got = gaussian_encode_cuda(g, a)
    want = ops.gaussian_encode(g, a, mode="off")
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * max(1.0, want.abs().max().item()))
    idx, cof = _lt_table(30, 40, r, 0.2, offset)
    i_t, c_t = torch.as_tensor(idx, device=dev), torch.as_tensor(cof, device=dev)
    got = lt_encode_cuda(a, i_t, c_t)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.lt_encode(a, i_t, c_t, mode="off"))


def _ec2_tables():
    """Every coded task's LT table of the EC2 example (``--scale 40 --trials
    2``; the tables do not depend on m or on where Â is encoded): (r, idx, cof)."""
    import contextlib
    import importlib.util
    import io
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "ec2_repro_torch.py")
    spec = importlib.util.spec_from_file_location("ec2_repro_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with contextlib.redirect_stdout(io.StringIO()):
        records = example.main(["--scale", "40", "--trials", "2", "--m", "64",
                                "--device", "cpu"])
    return [(rec["a_shape"][0], rec["encode"]["plan"].indices, rec["encode"]["plan"].coeffs)
            for rec in records if rec["scheme"] in ("hcmm", "bpcc")]


def _lt_engines_bit_equal(a, idx, cof, slab: bool):
    """lt_encode on a and (idx, cof) through encode_rows' host CSR, the
    wrapper's own compaction and each engine that takes the table: all the
    plain version's bits; the slab engine launched (and counted) iff
    ``slab``."""
    dev = a.device
    r = a.shape[0]
    i_t, c_t = torch.as_tensor(idx, device=dev), torch.as_tensor(cof, device=dev)
    want = ops.lt_encode(a, i_t, c_t, mode="off")
    before = (lt_encode_cuda.launches, lt_encode_cuda.slab_launches)
    got = lt_encode_csr_cuda(a, lt_csr_host(idx, cof, r).to(dev))
    assert (lt_encode_cuda.launches, lt_encode_cuda.slab_launches) == (
        before[0] + 1, before[1] + int(slab))
    outs = [got, lt_encode_cuda(a, i_t, c_t), _lt_launch(a, _lt_csr(i_t, c_t, r), engine="l2")]
    if slab:
        outs.append(_lt_launch(a, _lt_csr(i_t, c_t, r), engine="slab"))
    else:
        with pytest.raises(ValueError, match="fit no slab"):
            _lt_launch(a, _lt_csr(i_t, c_t, r), engine="slab")
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert torch.equal(out, want), i


@pytest.mark.gpu
def test_cuda_lt_encode_ec2_tables_bit_equal():
    """The EC2 example's coded tasks' tables (r 125 to 500, q up to 598) at
    its m = 10,000: the slab engine takes each; bit-equal on every engine."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    tables = _ec2_tables()
    assert len(tables) == 32
    for r, idx, cof in tables[::5] + tables[-1:]:
        _lt_engines_bit_equal(torch.randn(r, 10_000, device=dev, generator=gen), idx, cof, True)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,m", [(150, 3001), (None, 2000)])
def test_cuda_lt_encode_scenario_1_tables_bit_equal(rows, m):
    """Scenario 1's whole plan (q 8,739 over all 5,000 rows of A: a table
    too large for a slab, so the L2 engine) and its first 150 rows (a
    scenario-1-like table that fits one) at a small m; bit-equal."""
    from repro_torch.kernels.autotune import lt_task_table

    dev = _cuda()
    r, plan = lt_task_table(0, reserve=False)
    idx, cof = plan.indices[:rows], plan.coeffs[:rows]
    a = torch.randn(r, m, device=dev, generator=torch.Generator(device=dev).manual_seed(6))
    _lt_engines_bit_equal(a, idx, cof, rows is not None)


@pytest.mark.gpu
def test_cuda_gaussian_encode_64bit_offsets():
    """Row 2 of A and of out start past 2^31 elements (2.2e9)."""
    dev = _cuda()
    free, _ = torch.cuda.mem_get_info()
    m = 1_100_000_000
    if free < 4 * 8 * m * 1.2:
        pytest.skip(f"needs {32 * m / 1e9:.1f} GB of free device memory")
    a = torch.zeros(3, m, device=dev)
    a[:, -5000:].normal_()
    a[:, :5000].normal_()
    g = torch.tensor([[1.0, 0.0, 2.0], [0.5, 0.0, 0.0], [0.0, 0.0, 1.0]], device=dev)
    got = gaussian_encode_cuda(g, a)
    torch.cuda.synchronize()
    assert torch.equal(got[0], a[0] + 2.0 * a[2])
    assert torch.equal(got[1], 0.5 * a[0])
    assert torch.equal(got[2], a[2])


@pytest.mark.gpu
def test_cuda_lt_encode_64bit_offsets():
    """Source row index x M and output row x M past 2^31 elements."""
    dev = _cuda()
    free, _ = torch.cuda.mem_get_info()
    r, m = 1100, 2_000_000  # A is 8.8 GB: the last row starts at 2.2e9 elements
    if free < 4 * (r * m + 3 * m) * 1.2:
        pytest.skip(f"needs {4 * r * m / 1e9:.1f} GB of free device memory")
    a = torch.empty(r, m, device=dev)
    a[-2:].normal_()
    a[:-2] = 0.0
    idx = torch.tensor([[r - 1, r - 2], [r - 2, 0]], dtype=torch.int32, device=dev)
    cof = torch.tensor([[1.0, 2.0], [0.5, 0.0]], device=dev)
    got = lt_encode_cuda(a, idx, cof)
    torch.cuda.synchronize()
    assert torch.equal(got[0], a[r - 1] + 2.0 * a[r - 2])
    assert torch.equal(got[1], 0.5 * a[r - 2])


@pytest.mark.gpu
@pytest.mark.parametrize("code", ["lt", "gaussian"])
def test_cuda_encode_rows_both_plan_kinds(code):
    dev = _cuda()
    r, q, m = 300, 480, 1001
    plan = LTCode(r, seed=1).plan(q) if code == "lt" else GaussianCode(r, seed=1).plan(q)
    a = np.random.default_rng(2).standard_normal((r, m)).astype(np.float32)
    kernel = lt_encode_cuda if code == "lt" else gaussian_encode_cuda
    before = kernel.launches
    got = ops.encode_rows(a, plan, 310, q, mode="cuda", device=dev)
    assert kernel.launches == before + 1 and got.device.type == "cuda"
    want = ops.encode_rows(a, plan, 310, q, mode="off", device="cpu")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4 * max(1.0, want.abs().max().item()))


@pytest.mark.gpu
def test_cuda_task_reserve_encoded_by_the_kernel():
    """run_task with encode_mode='cuda', and with the default mode, on an
    emulator whose device defaults to the card, for the adaptive task and
    the static one: one lt_encode launch each (all of Â), none with
    encode_mode=None, and the trajectory of the host-encode run."""
    from repro_torch.cluster import ClusterEmulator, TaskSpec, ec2_scenario
    from repro_torch.core.adaptive import ChurnEvent, ChurnSchedule, ReallocationPolicy

    _cuda()
    rng = np.random.default_rng(0)
    a = rng.standard_normal((400, 64)).astype(np.float32)
    x = rng.standard_normal(64).astype(np.float32)
    _, workers = ec2_scenario(1)
    churn = ChurnSchedule((ChurnEvent(t=0.01, worker=0, kind="death"),
                           ChurnEvent(t=0.008, worker=1, kind="rate", factor=5.0)))
    ref = a.astype(np.float64) @ x
    for task in ({"churn": churn, "adaptive": ReallocationPolicy()}, {}):
        runs = {}
        for mode in ("cuda", "default", None):
            before = lt_encode_cuda.launches
            em = ClusterEmulator(workers, time_scale=0.02, seed=9)
            kw = {} if mode == "default" else {"encode_mode": mode}
            runs[mode] = em.run_task(a, x, TaskSpec(code="lt", **task, **kw))
            assert lt_encode_cuda.launches - before == (1 if mode else 0)
            if mode:
                enc = em.last_encode
                assert enc["device"].startswith("cuda")
                assert enc["rows"] == runs[mode].rows_assigned
                assert enc["static_rows"] + enc["reserve_rows"] == enc["rows"]
                assert (enc["reserve_rows"] > 0) == bool(task)
        for mode in ("cuda", "default"):
            assert runs[mode].ok and runs[mode].arrivals == runs[None].arrivals
            assert runs[mode].t_complete == runs[None].t_complete
            assert runs[mode].reallocations == runs[None].reallocations
            assert np.abs(runs[mode].y - ref).max() / np.abs(ref).max() < 2e-3


@pytest.mark.gpu
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    wc = torch.zeros(16, 8, device=dev)
    rec = torch.zeros(2, 4, device=dev)
    with pytest.raises(ValueError, match="columns"):
        coded_matvec_decode_cuda(wc, torch.zeros(8, 0, device=dev), rec)
    with pytest.raises(TypeError):
        coded_matvec_decode_cuda(wc.double(), torch.zeros(8, 2, device=dev), rec)
    with pytest.raises(ValueError, match="contiguous"):
        coded_matvec_decode_cuda(wc, torch.zeros(2, 8, device=dev).T, rec)
    with pytest.raises(ValueError, match="rows"):
        gaussian_encode_cuda(torch.zeros(3, 2, device=dev), torch.zeros(4, 5, device=dev))
    a = torch.zeros(4, 8, device=dev)
    idx = torch.zeros(2, 3, dtype=torch.int32, device=dev)
    with pytest.raises(IndexError, match="outside"):
        lt_encode_cuda(a, idx + 4, torch.ones(2, 3, device=dev))
    lt_encode_cuda(a, idx + 4, torch.zeros(2, 3, device=dev))  # padding may point anywhere
    with pytest.raises(TypeError):
        lt_encode_cuda(a, idx.float(), torch.ones(2, 3, device=dev))
    with pytest.raises(ValueError, match="d_max"):
        lt_encode_cuda(a, idx, torch.ones(2, 2, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        lt_encode_cuda(torch.zeros(8, 4, device=dev).T, idx, torch.ones(2, 3, device=dev))


@pytest.mark.gpu
def test_cuda_coded_head_matches_uncoded_under_erasures():
    """Through CodedLinear.apply(kernel_mode='cuda'): the decoded logits equal
    the uncoded product for masks with <= n_parity erasures."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.standard_normal((1000, 96)).astype(np.float32), device=dev)
    x = torch.as_tensor(rng.standard_normal((96, 4)).astype(np.float32), device=dev)
    wc = encode_blocks(w, 14, 2)
    truth = w @ x
    for m in _masks(14, 2):
        got = ops.coded_head_matvec(wc, x, torch.as_tensor(m, device=dev), 14, 2,
                                    kernel_mode="cuda")[:1000]
        torch.cuda.synchronize()
        assert float((got - truth).abs().max()) <= 1e-3 * float(truth.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n_data,n_parity", [(10, 6), (19, 3)])
@pytest.mark.parametrize("kernel_mode", [None, "cuda", "svd"])
def test_cuda_coded_head_uncacheable_geometry_launches_kernel(n_data, n_parity, kernel_mode):
    """Geometries the DecoderCache refuses still run the kernel on the card,
    with the pinv recovery matrix, and decode exactly."""
    dev = _cuda()
    rng = np.random.default_rng(n_data)
    w = torch.as_tensor(rng.standard_normal((500, 80)).astype(np.float32), device=dev)
    x = torch.as_tensor(rng.standard_normal((80, 4)).astype(np.float32), device=dev)
    wc = encode_blocks(w, n_data, n_parity)
    truth = w @ x
    for m in _masks(n_data, n_parity):
        before = coded_matvec_decode_cuda.launches
        got = ops.coded_head_matvec(wc, x, torch.as_tensor(m, device=dev), n_data, n_parity,
                                    kernel_mode=kernel_mode)[:500]
        torch.cuda.synchronize()
        assert coded_matvec_decode_cuda.launches == before + 1
        assert float((got - truth).abs().max()) <= 1e-3 * float(truth.abs().max())


@pytest.mark.gpu
def test_cuda_default_engine_runs_the_head_kernel():
    """A ServeEngine built on CUDA with default arguments runs the coded
    head as the kernel: one launch per prefill and per decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    dev = _cuda()
    cfg = get_config("glm4-9b", smoke=True).scaled(coded=True, coded_parity=2)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServeEngine(model, params, n_slots=2, s_max=32, device=dev)
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, 8), max_new_tokens=4))
    before = coded_matvec_decode_cuda.launches
    done = eng.run()
    assert len(done) == 3 and all(len(r.out_tokens) == 4 for r in done)
    assert coded_matvec_decode_cuda.launches - before == 3 + eng._steps


def _matvec_tol(dtype, want):
    return (1e-4 if dtype == torch.float32 else 2e-3) * max(1.0, want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("r,m,b", MATVEC_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_cuda_coded_matvec_matches_plain(r, m, b, dtype):
    dev = _cuda()
    rng = np.random.default_rng(r * 1000 + m)
    a = torch.as_tensor(rng.standard_normal((r, m)), dtype=dtype, device=dev)
    shape = (m, b) if b > 1 else (m,)
    x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
    before = coded_matvec_cuda.launches
    got = ops.coded_matvec(a, x)
    assert coded_matvec_cuda.launches == before + 1
    want = ops.coded_matvec(a, x, mode="off")
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = _matvec_tol(dtype, want)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_cuda_coded_matvec_on_views(dtype, offset):
    """Row views at any element offset: code blocks of a coded weight (M odd,
    so most blocks start off a 16-byte boundary) and a matrix viewed from an
    offset into a flat buffer (M a multiple of 8, the start misaligned)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(offset)
    w = torch.randn(16 * 37, 131, device=dev, generator=gen).to(dtype)
    x = torch.randn(131, 4, device=dev, generator=gen).to(dtype)
    for blk in w.chunk(16):
        got = coded_matvec_cuda(blk, x)
        want = ops.coded_matvec(blk, x, mode="off")
        torch.cuda.synchronize()
        tol = _matvec_tol(dtype, want)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)
    flat = torch.randn(offset + 300 * 64, device=dev, generator=gen).to(dtype)
    a = flat[offset:].view(300, 64)
    x = torch.randn(64, 2, device=dev, generator=gen).to(dtype)
    got = coded_matvec_cuda(a, x)
    want = ops.coded_matvec(a, x, mode="off")
    torch.cuda.synchronize()
    tol = _matvec_tol(dtype, want)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cuda_coded_matvec_rejects_what_the_kernel_does_not_take():
    dev = _cuda()
    a = torch.zeros(8, 4, device=dev)
    with pytest.raises(ValueError, match="columns"):
        coded_matvec_cuda(a, torch.zeros(4, 0, device=dev))
    with pytest.raises(TypeError, match="one type"):
        coded_matvec_cuda(a, torch.zeros(4, 2, device=dev, dtype=torch.float16))
    with pytest.raises(TypeError):
        coded_matvec_cuda(a.bfloat16(), torch.zeros(4, 2, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        coded_matvec_cuda(torch.zeros(4, 8, device=dev).T, torch.zeros(4, 2, device=dev))
    with pytest.raises(ValueError, match="rows"):
        coded_matvec_cuda(a, torch.zeros(5, 2, device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        ops.coded_matvec(torch.zeros(8, 4), torch.zeros(4, 2), mode="cuda")


@pytest.mark.gpu
def test_cuda_mesh_head_sixteen_logical_devices_matches_fused_head():
    """The head mesh of sixteen logical devices on one card: each call
    launches coded_matvec once per block (and never the fused kernel), and
    equals the fused single-device head within 1e-4 * max|y|."""
    from repro_torch.sharding import HeadMesh, shard_coded_head

    dev = _cuda()
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.standard_normal((1000, 96)).astype(np.float32), device=dev)
    x = torch.as_tensor(rng.standard_normal((96, 4)).astype(np.float32), device=dev)
    wc = encode_blocks(w, 14, 2)
    mesh = HeadMesh((dev,) * 16)
    placed = shard_coded_head(wc, mesh)
    assert all(b.untyped_storage().data_ptr() == wc.untyped_storage().data_ptr()
               for b in placed)  # views: no copy on one card
    truth = w @ x
    for m in _masks(14, 2):
        mask = torch.as_tensor(m, device=dev)
        before = (coded_matvec_cuda.launches, coded_matvec_decode_cuda.launches)
        got = ops.coded_head_matvec(placed, x, mask, 14, 2, mesh=mesh)
        assert (coded_matvec_cuda.launches - before[0],
                coded_matvec_decode_cuda.launches - before[1]) == (16, 0)
        fused = ops.coded_head_matvec(wc, x, mask, 14, 2)
        torch.cuda.synchronize()
        assert float((got - fused).abs().max()) <= 1e-4 * float(fused.abs().max())
        assert float((got[:1000] - truth).abs().max()) <= 1e-3 * float(truth.abs().max())


@pytest.mark.gpu
def test_cuda_mesh_engine_runs_coded_matvec_per_block():
    """A ServeEngine on a sixteen-logical-device mesh of the card: 16
    coded_matvec launches per prefill and per step, and the single-device
    engine's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.sharding import HeadMesh

    dev = _cuda()
    cfg = get_config("glm4-9b", smoke=True).scaled(coded=True, coded_parity=2,
                                                   dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 8) for _ in range(3)]
    out = {}
    for mesh in (None, HeadMesh((dev,) * 16)):
        eng = ServeEngine(model, params, n_slots=2, s_max=32, mesh=mesh, device=dev,
                          mask_fn=lambda: np.array([1.0] * 3 + [0.0] + [1.0] * 12))
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
        before = coded_matvec_cuda.launches
        out[mesh is None] = {r.uid: r.out_tokens for r in eng.run()}
        assert coded_matvec_cuda.launches - before == (0 if mesh is None
                                                       else 16 * (3 + eng._steps))
    assert out[True] == out[False]


# (r, m, b, dtype): the persistent grid's edges on a 132-SM card (rows
# below, at and just above the SM count), B on both sides of the 64 KB
# x-resident cap (M 4096: B 4 resident, B 5 in panels; M 16384 at B 1
# resident, 16388 in panels), M % 4 != 0 and fp16 M % 8 != 0 (scalar loads)
MATVEC_EDGES = [(5, 4096, 1, torch.float32), (131, 4096, 4, torch.float32),
                (132, 4096, 4, torch.float32), (133, 4096, 4, torch.float32),
                (300, 4096, 5, torch.float32), (300, 16384, 1, torch.float32),
                (300, 16388, 1, torch.float32), (1000, 4100, 16, torch.float16),
                (263, 4097, 3, torch.float32), (265, 4100, 4, torch.float16),
                (264, 1030, 16, torch.float16)]
# (n_data, nb, br, m, b): 1, 17 and 32 code blocks under a dense R (the
# decoder cache stops at 20 blocks); tiles below and above the SM count;
# B across the cap; M % 4 != 0
DECODE_EDGES = [(1, 1, 100, 4096, 2), (17, 17, 131, 260, 5), (30, 32, 133, 1024, 1),
                (14, 16, 266, 4096, 4), (14, 16, 300, 4096, 5), (3, 3, 500, 130, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("r,m,b,dtype", MATVEC_EDGES)
def test_cuda_coded_matvec_grid_and_cap_edges_bit_equal_relaunch(r, m, b, dtype):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(r + m + b)
    a = torch.randn(r, m, device=dev, generator=gen).to(dtype)
    x = torch.randn(m, b, device=dev, generator=gen).to(dtype)
    got = coded_matvec_cuda(a, x)
    again = coded_matvec_cuda(a, x)
    want = ops.coded_matvec(a, x, mode="off")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = _matvec_tol(dtype, want)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("n_data,nb,br,m,b", DECODE_EDGES)
def test_cuda_coded_matvec_decode_block_count_and_cap_edges_bit_equal_relaunch(n_data, nb, br,
                                                                               m, b):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(nb * 1000 + br)
    w = torch.randn(nb * br, m, device=dev, generator=gen)
    x = torch.randn(m, b, device=dev, generator=gen)
    rec = torch.randn(n_data, nb, device=dev, generator=gen)
    got = coded_matvec_decode_cuda(w, x, rec)
    again = coded_matvec_decode_cuda(w, x, rec)
    want = ops.coded_matvec_decode(w, x, rec, mode="off")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=tol)


# x of WIDE_MIN_B columns and more runs on the wide engine (csrc/wide_rows.cuh),
# one launch a call at any width: 17, 33 and 128 (the dry run's decode
# batch) in one column tile of 32, 64 and 128 columns, 300 in two tiles of
# 160; M 4096 and 768 through the TMA, M 4104 fp16
WIDE_B = [17, 33, 128, 300]


def _wide_counts(wrapper):
    return wrapper.launches, wrapper.wide_launches


@pytest.mark.gpu
@pytest.mark.parametrize("b", WIDE_B)
@pytest.mark.parametrize("m,dtype", [(4096, torch.float32), (768, torch.float32),
                                     (4104, torch.float16)])
def test_cuda_coded_matvec_takes_any_batch_width(b, m, dtype):
    """B >= WIDE_MIN_B: one launch (counted, and counted as the wide
    engine's) a call, within the plain version's tolerance, and the first
    and the last WIDE_MIN_B columns bit-equal to the same columns launched
    alone (at B = 300 the last ones lie in the second column tile)."""
    from repro_torch.kernels.wide_rows import WIDE_MIN_B

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(b + m)
    a = torch.randn(1001, m, device=dev, generator=gen).to(dtype)
    x = torch.randn(m, b, device=dev, generator=gen).to(dtype)
    before = _wide_counts(coded_matvec_cuda)
    got = ops.coded_matvec(a, x)
    assert _wide_counts(coded_matvec_cuda) == (before[0] + 1, before[1] + 1)
    want = ops.coded_matvec(a, x, mode="off")
    first = coded_matvec_cuda(a, x[:, :WIDE_MIN_B].contiguous())
    last = coded_matvec_cuda(a, x[:, b - WIDE_MIN_B:].contiguous())
    torch.cuda.synchronize()
    assert got.shape == (1001, b)
    assert torch.equal(got[:, :WIDE_MIN_B], first)
    assert torch.equal(got[:, b - WIDE_MIN_B:], last)
    tol = _matvec_tol(dtype, want)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b", WIDE_B)
@pytest.mark.parametrize("n_data,n_parity,br,m", [(14, 2, 3592, 768), (14, 2, 300, 4096),
                                                  (13, 3, 77, 516)])
def test_cuda_coded_matvec_decode_takes_any_batch_width(b, n_data, n_parity, br, m):
    """The decode kernel at B >= WIDE_MIN_B (the mamba2-130m head at B =
    128 among them): one launch a call and the tolerance as for
    coded_matvec, under an erasure, the first and the last WIDE_MIN_B
    columns bit-equal to the same columns alone, and through
    ``CodedLinear.apply`` with None and 'auto' too."""
    from repro_torch.core.coded_ops import CodedLinear
    from repro_torch.kernels.wide_rows import WIDE_MIN_B

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(b * 7 + br)
    nb = n_data + n_parity
    w = torch.randn(nb * br, m, device=dev, generator=gen)
    x = torch.randn(m, b, device=dev, generator=gen)
    mask = torch.ones(nb, device=dev)
    mask[1] = 0.0
    rec = get_decoder_cache(n_data, n_parity).recovery(mask)
    before = _wide_counts(coded_matvec_decode_cuda)
    got = ops.coded_matvec_decode(w, x, rec)
    assert _wide_counts(coded_matvec_decode_cuda) == (before[0] + 1, before[1] + 1)
    want = ops.coded_matvec_decode(w, x, rec, mode="off")
    for cols in (slice(0, WIDE_MIN_B), slice(b - WIDE_MIN_B, b)):
        assert torch.equal(got[:, cols], coded_matvec_decode_cuda(w, x[:, cols].contiguous(), rec))
    torch.cuda.synchronize()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=tol)
    head = CodedLinear(n_data, n_parity, n_data * br)
    for mode in (None, "auto"):
        before = coded_matvec_decode_cuda.wide_launches
        y = head.apply(w, x, mask, kernel_mode=mode)
        assert coded_matvec_decode_cuda.wide_launches - before == 1, mode
        assert torch.equal(y, got), mode


def _wide_decode_inputs(dev, gen, n_data, n_parity, br, m, b, erased=(1,)):
    nb = n_data + n_parity
    w = torch.randn(nb * br, m, device=dev, generator=gen)
    x = torch.randn(m, b, device=dev, generator=gen)
    mask = torch.ones(nb, device=dev)
    mask[list(erased)] = 0.0
    return w, x, get_decoder_cache(n_data, n_parity).recovery(mask)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["coded_matvec", "coded_matvec_decode"])
def test_cuda_wide_columns_bit_equal_across_widths(kernel):
    """Column j of a 64-wide call is bit-equal to the same column in a 17-
    and a 33-wide call: a column's sums do not depend on B or on the other
    columns (a fixed K order, no atomics, the same instructions)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(64)
    if kernel == "coded_matvec":
        a = torch.randn(1001, 4096, device=dev, generator=gen)
        x = torch.randn(4096, 64, device=dev, generator=gen)
        call = lambda xs: coded_matvec_cuda(a, xs)  # noqa: E731
    else:
        w, x, rec = _wide_decode_inputs(dev, gen, 14, 2, 300, 4096, 64)
        call = lambda xs: coded_matvec_decode_cuda(w, xs, rec)  # noqa: E731
    wide = call(x)
    for b in (17, 33):
        assert torch.equal(call(x[:, :b].contiguous()), wide[:, :b]), b


@pytest.mark.gpu
def test_cuda_wide_decode_erased_block_garbage_leaves_the_bits():
    """An erased code block overwritten with finite garbage leaves every
    bit of the decoded output as it was: R's column for it is zero."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    w, x, rec = _wide_decode_inputs(dev, gen, 14, 2, 300, 4096, 64, erased=(3, 12))
    before = coded_matvec_decode_cuda(w, x, rec)
    for blk in (3, 12):
        w[blk * 300:(blk + 1) * 300] = 1e6 * torch.randn(300, 4096, device=dev, generator=gen)
    after = coded_matvec_decode_cuda(w, x, rec)
    torch.cuda.synchronize()
    assert torch.isfinite(after).all() and torch.equal(before, after)


# inputs the TMA cannot take: the producer warp's own loads.  A code block
# view that starts mid-row (M odd), and M % 4 != 0 at an aligned base.  The
# same product with W and x zero-padded to a 16-byte row pitch goes through
# the TMA into the same stages with the same K tiles, so it has the same bits.
def _padded(w, x, m_pad):
    wp = torch.zeros(w.shape[0], m_pad, dtype=w.dtype, device=w.device)
    wp[:, :w.shape[1]] = w
    xp = torch.zeros(m_pad, x.shape[1], dtype=x.dtype, device=x.device)
    xp[:x.shape[0]] = x
    return wp, xp


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["misaligned view", "m % 4", "m % 4 fp16"])
def test_cuda_coded_matvec_wide_without_the_tma(case):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(11)
    dtype = torch.float16 if case.endswith("fp16") else torch.float32
    if case == "misaligned view":
        a = torch.randn(16 * 301, 1027, device=dev, generator=gen).chunk(16)[3]
        assert a.data_ptr() % 16 != 0
    else:
        a = torch.randn(301, 1030, device=dev, generator=gen).to(dtype)
    x = torch.randn(a.shape[1], 40, device=dev, generator=gen).to(dtype)
    got = coded_matvec_cuda(a, x)
    again = coded_matvec_cuda(a, x)
    via_tma = coded_matvec_cuda(*_padded(a, x, -(-a.shape[1] // 8) * 8))
    want = ops.coded_matvec(a, x, mode="off")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, via_tma)
    tol = _matvec_tol(dtype, want)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1030, 517])
def test_cuda_coded_matvec_decode_wide_without_the_tma(m):
    """W_c with M % 4 != 0: the producer warp's own loads, bit-equal on a
    relaunch, within the plain version's tolerance."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(m)
    w, x, rec = _wide_decode_inputs(dev, gen, 13, 3, 77, m, 40)
    got = coded_matvec_decode_cuda(w, x, rec)
    again = coded_matvec_decode_cuda(w, x, rec)
    via_tma = coded_matvec_decode_cuda(*_padded(w, x, -(-m // 4) * 4), rec)
    want = ops.coded_matvec_decode(w, x, rec, mode="off")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, via_tma)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["coded_matvec", "coded_matvec_decode"])
def test_cuda_wide_call_captured_in_a_graph_equals_eager(kernel):
    """A wide call captured in a CUDA graph (after an eager call, as the
    engine's warm-up does): recorded as one wide node, and its replay is
    bit-equal to the eager call."""
    from repro_torch.kernels import count_wide_nodes, graph_dot

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(3)
    if kernel == "coded_matvec":
        a = torch.randn(1001, 4096, device=dev, generator=gen)
        x = torch.randn(4096, 64, device=dev, generator=gen)
        wrapper, call = coded_matvec_cuda, lambda: coded_matvec_cuda(a, x)
    else:
        w, x, rec = _wide_decode_inputs(dev, gen, 14, 2, 300, 4096, 64)
        wrapper, call = coded_matvec_decode_cuda, lambda: coded_matvec_decode_cuda(w, x, rec)
    eager = call()
    before = (wrapper.launches, wrapper.captured, wrapper.wide_captured)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev)):
        out = call()
    assert (wrapper.launches, wrapper.captured, wrapper.wide_captured) == (
        before[0], before[1] + 1, before[2] + 1)
    assert count_wide_nodes(graph_dot(graph))[kernel] == 1
    graph.instantiate()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.gpu
def test_cuda_dryrun_cell_argument_bytes_equal_its_reckoning():
    """A small dry-run cell of each kind (``repro_torch.launch.dryrun``) run
    on the card: its arguments, made there with the reckoned shapes, hold
    exactly the bytes the 1 x 1 mesh reckons; the step runs through the
    kernels (the decode at 20 sequences: the wide engine) and its output
    is finite."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import Workload
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils.tree import tree_flatten_with_path

    dev = _cuda()
    cfg = get_config("mamba2-130m", smoke=True)
    one = make_mesh((1, 1), ("data", "model"))
    for wl in (Workload("d", "decode", 512, 20), Workload("p", "prefill", 512, 1),
               Workload("t", "train", 256, 2)):
        reckoned, _ = dryrun.reckon(cfg, wl, one, coded=True)
        fn, args, _ = dryrun.build_cell(cfg, wl, one, coded=True, device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(1))
        got = sum(x.numel() * x.element_size() for a in args for _, x in tree_flatten_with_path(a))
        assert got == reckoned["memory"]["argument_size_in_bytes"], wl.kind
        before = {n: w.launches for n, w in kernel_wrappers().items()}
        out = fn(*args)
        torch.cuda.synchronize()
        after = {n: w.launches - before[n] for n, w in kernel_wrappers().items()}
        if wl.kind == "train":
            assert np.isfinite(float(out[1]["loss"]))
            assert after["ssd_chunk"] == after["ssd_combine"] == 2 * cfg.n_layers
        else:
            assert bool(torch.isfinite(out[0]).all())
            if wl.kind == "decode":
                assert after["coded_matvec_decode"] == 1
            else:
                assert after["ssd_chunk"] == cfg.n_layers


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cuda_coded_matvec_decode_on_a_misaligned_view(offset):
    """W_c viewed from an offset into a flat buffer (M a multiple of 4, the
    start off a 16-byte boundary): the scalar loads, same sums."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(offset)
    flat = torch.randn(offset + 16 * 70 * 256, device=dev, generator=gen)
    w = flat[offset:].view(16 * 70, 256)
    assert w.data_ptr() % 16 != 0
    x = torch.randn(256, 4, device=dev, generator=gen)
    rec = get_decoder_cache(14, 2).recovery(torch.ones(16, device=dev))
    got = coded_matvec_decode_cuda(w, x, rec)
    want = ops.coded_matvec_decode(w, x, rec, mode="off")
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * max(1.0, want.abs().max().item()))


@pytest.mark.gpu
def test_cuda_head_kernels_take_more_shared_memory_after_less():
    """One instantiation launched with x of 16 KB, then 3 KB (its occupancy
    asked again), then 16 KB again on the cached plan, all under the 48 KB
    default: the last launch's shared memory must still be allowed (the
    serve's head after the kernel checks of a smaller head)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(3)
    rec = get_decoder_cache(14, 2).recovery(torch.ones(16, device=dev))
    for m in (4096, 768, 4096):          # x of 16, 3 and 16 KB at B = 1
        w = torch.randn(16 * 40, m, device=dev, generator=gen)
        x = torch.randn(m, 1, device=dev, generator=gen)
        got = coded_matvec_decode_cuda(w, x, rec)
        want = ops.coded_matvec_decode(w, x, rec, mode="off")
        a = torch.randn(300, m, device=dev, generator=gen)
        got_a, want_a = coded_matvec_cuda(a, x), ops.coded_matvec(a, x, mode="off")
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, want.abs().max().item()))
        np.testing.assert_allclose(got_a.cpu().numpy(), want_a.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, want_a.abs().max().item()))


@pytest.mark.gpu
def test_cuda_head_kernels_64bit_offsets():
    """An fp16 A [R, M] of R * M > 2^31 elements, and an fp32 W_c of as many:
    rows past 2^31 elements are read from where they lie (checked on the
    last rows against the plain version of just those rows)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(7)
    m = 4096
    r = (1 << 31) // m + 700
    a = torch.randn(r, m, device=dev, generator=gen, dtype=torch.float16)
    x = torch.randn(m, 2, device=dev, generator=gen, dtype=torch.float16)
    got = coded_matvec_cuda(a, x)
    tail = slice(r - 1500, r)
    want = ops.coded_matvec(a[tail], x, mode="off")
    torch.cuda.synchronize()
    tol = _matvec_tol(torch.float16, want)
    np.testing.assert_allclose(got[tail].cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)
    del a, got
    br = (1 << 31) // (2 * m) + 300          # nb = 2: 2 * br * m > 2^31
    w = torch.randn(2 * br, m, device=dev, generator=gen)
    x = torch.randn(m, 3, device=dev, generator=gen)
    rec = torch.randn(2, 2, device=dev, generator=gen)
    got = coded_matvec_decode_cuda(w, x, rec)
    rows = torch.arange(br - 500, br, device=dev)
    want = ops.coded_matvec_decode(torch.cat([w[rows], w[br + rows]]), x, rec, mode="off")
    torch.cuda.synchronize()
    got_tail = torch.cat([got[rows], got[br + rows]])
    np.testing.assert_allclose(got_tail.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * max(1.0, want.abs().max().item()))


def _ssd_close(got, want):
    """The reference's rtol 1e-4, atol 1e-5 scaled by max|plain|."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-5 * max(1.0, want.abs().max().item()))


def _ssd_cells(dev, g, q, p, n, dtype, seed, da_scale=0.3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (0.1 * torch.randn(g, q, p, device=dev, generator=gen)).to(dtype)
    da = -da_scale * torch.randn(g, q, device=dev, generator=gen).abs()
    b = (0.3 * torch.randn(g, q, n, device=dev, generator=gen)).to(dtype)
    c = (0.3 * torch.randn(g, q, n, device=dev, generator=gen)).to(dtype)
    return x, da, b, c


@pytest.mark.gpu
@pytest.mark.parametrize("q,p,n", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_chunk_and_combine_match_plain(q, p, n, dtype):
    from repro_torch.kernels import ref

    dev = _cuda()
    x, da, b, c = _ssd_cells(dev, 6, q, p, n, dtype, seed=q * 1000 + p + n)
    before = (ssd_chunk_cuda.launches, ssd_combine_cuda.launches)
    got = ssd_chunk_cuda(x, da, b, c)
    want = ref.ref_ssd_chunk(x, da, b, c)
    st_in = torch.randn(6, p, n, device=dev)
    y_off = ssd_combine_cuda(c, want[3], st_in)
    assert (ssd_chunk_cuda.launches - before[0], ssd_combine_cuda.launches - before[1]) == (1, 1)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        _ssd_close(g_, w_)
    _ssd_close(y_off, ref.ref_ssd_combine(c, want[3], st_in))


@pytest.mark.gpu
def test_cuda_ssd_chunk_overflowing_cell_gives_no_nan():
    """|da| so large that exp(cum_l - cum_s) above the diagonal is inf: the
    kernel selects before the exp, so no inf·0 = NaN reaches any output."""
    from repro_torch.kernels import ref

    dev = _cuda()
    for dtype in (torch.float32, torch.bfloat16):
        x, da, b, c = _ssd_cells(dev, 4, 256, 64, 64, dtype, seed=11, da_scale=60.0)
        da = da - 20.0          # every step decays by e^-20 or more
        assert torch.isinf(torch.exp(-da.sum(-1))).all()
        got = ssd_chunk_cuda(x, da, b, c)
        want = ref.ref_ssd_chunk(x, da, b, c)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            _ssd_close(g_, w_)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_forward_with_initial_state_matches_plain(dtype):
    """ops.ssd_forward on CUDA tensors launches both kernels once and equals
    its plain route ('off') on the card, with h0 and grouped B/C."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(3)
    bsz, s, h, p, g, n = 2, 512, 8, 48, 2, 128
    x = (0.1 * torch.randn(bsz, s, h, p, device=dev, generator=gen)).to(dtype)
    da = -0.3 * torch.randn(bsz, s, h, device=dev, generator=gen).abs()
    b = (0.3 * torch.randn(bsz, s, g, n, device=dev, generator=gen)).to(dtype)
    c = (0.3 * torch.randn(bsz, s, g, n, device=dev, generator=gen)).to(dtype)
    h0 = 0.1 * torch.randn(bsz, h, p, n, device=dev, generator=gen)
    before = (ssd_chunk_cuda.launches, ssd_combine_cuda.launches)
    y, final = ops.ssd_forward(x, da, b, c, 256, h0=h0)
    assert (ssd_chunk_cuda.launches - before[0], ssd_combine_cuda.launches - before[1]) == (1, 1)
    y_p, final_p = ops.ssd_forward(x, da, b, c, 256, mode="off", h0=h0)
    torch.cuda.synchronize()
    _ssd_close(final, final_p)
    if dtype == torch.float32:
        _ssd_close(y, y_p)
    else:  # y is cast back to bf16: within one bf16 step (2^-7 relative)
        np.testing.assert_allclose(y.float().cpu().numpy(), y_p.float().cpu().numpy(),
                                   rtol=2.0 ** -7, atol=1e-5 * y_p.float().abs().max().item())


def _slow_da(dev, shape, q, seed):
    """da = -U(0, 2/Q): |cum| <= 2 over a chunk, so every 64-row tile of
    y_diag and y_off, every s-tile and every stage of the state reduction
    carries weight within e^-2 of the largest.  Under the reference tests'
    -0.3|N(0, 1)|, exp(cum) at Q = 256 falls under e^-15 after ~64
    positions and hides all but the first and diagonal tiles."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return -(2.0 / q) * torch.rand(*shape, device=dev, generator=gen)


@pytest.mark.gpu
@pytest.mark.parametrize("q,p,n", [(q, p, n) for q in (2, 100, 256)
                                   for p, n in ((48, 128), (64, 64))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_kernels_match_plain_with_every_tile_in_sight(q, p, n, dtype):
    from repro_torch.kernels import ref

    dev = _cuda()
    x, _, b, c = _ssd_cells(dev, 6, q, p, n, dtype, seed=q * 1000 + p + n + 7)
    da = _slow_da(dev, (6, q), q, seed=q + p)
    got = ssd_chunk_cuda(x, da, b, c)
    want = ref.ref_ssd_chunk(x, da, b, c)
    st_in = torch.randn(6, p, n, device=dev)
    y_off = ssd_combine_cuda(c, want[3], st_in)
    torch.cuda.synchronize()
    assert float(want[3].min()) >= -2.0
    for g_, w_ in zip(got, want):
        _ssd_close(g_, w_)
    _ssd_close(y_off, ref.ref_ssd_combine(c, want[3], st_in))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_forward_with_initial_state_and_slow_decay_matches_plain(dtype):
    """As the h0 test above, with the slow decay: h0 and every chunk's
    state reach every later position of the 4-chunk prompt."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(4)
    bsz, s, h, p, g, n = 1, 1024, 8, 64, 1, 64
    x = (0.1 * torch.randn(bsz, s, h, p, device=dev, generator=gen)).to(dtype)
    da = _slow_da(dev, (bsz, s, h), 256, seed=5)
    b = (0.3 * torch.randn(bsz, s, g, n, device=dev, generator=gen)).to(dtype)
    c = (0.3 * torch.randn(bsz, s, g, n, device=dev, generator=gen)).to(dtype)
    h0 = 0.1 * torch.randn(bsz, h, p, n, device=dev, generator=gen)
    before = (ssd_chunk_cuda.launches, ssd_combine_cuda.launches)
    y, final = ops.ssd_forward(x, da, b, c, 256, h0=h0)
    assert (ssd_chunk_cuda.launches - before[0], ssd_combine_cuda.launches - before[1]) == (1, 1)
    y_p, final_p = ops.ssd_forward(x, da, b, c, 256, mode="off", h0=h0)
    torch.cuda.synchronize()
    _ssd_close(final, final_p)
    if dtype == torch.float32:
        _ssd_close(y, y_p)
    else:  # y is cast back to bf16: within one bf16 step (2^-7 relative)
        np.testing.assert_allclose(y.float().cpu().numpy(), y_p.float().cpu().numpy(),
                                   rtol=2.0 ** -7, atol=1e-5 * y_p.float().abs().max().item())


@pytest.mark.gpu
def test_cuda_ssd_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    x, da, b, c = _ssd_cells(dev, 2, 16, 8, 8, torch.float32, seed=0)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_chunk_cuda(x.half(), da, b.half(), c.half())
    with pytest.raises(TypeError, match="one dtype"):
        ssd_chunk_cuda(x, da, b.bfloat16(), c)
    with pytest.raises(TypeError, match="da must be float32"):
        ssd_chunk_cuda(x, da.double(), b, c)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_cuda(x.cpu(), da.cpu(), b.cpu(), c.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), da, b, c)
    big = _ssd_cells(dev, 1, 257, 8, 8, torch.float32, seed=0)
    with pytest.raises(ValueError, match="Q <= 256"):
        ssd_chunk_cuda(*big)
    wide = _ssd_cells(dev, 1, 16, 65, 8, torch.float32, seed=0)
    with pytest.raises(ValueError, match="P <= 64"):
        ssd_chunk_cuda(*wide)
    with pytest.raises(TypeError, match="float32"):
        ssd_combine_cuda(c, da, torch.zeros(2, 8, 8, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError, match="states_in"):
        ssd_combine_cuda(c, da, torch.zeros(2, 8, 9, device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_forward(torch.zeros(1, 16, 2, 8), torch.zeros(1, 16, 2),
                        torch.zeros(1, 16, 1, 8), torch.zeros(1, 16, 1, 8), 16, mode="cuda")


def _ssd_draw(dev, g, q, p, n, draw, seed):
    """bf16 cells under one of three decays: the reference tests' draw, the
    slow one that keeps every tile in sight, or one whose exp overflows
    above the diagonal (every step decays by e^-20 or more)."""
    if draw == "overflow":
        x, da, b, c = _ssd_cells(dev, g, q, p, n, torch.bfloat16, seed, da_scale=60.0)
        return x, da - 20.0, b, c
    x, da, b, c = _ssd_cells(dev, g, q, p, n, torch.bfloat16, seed)
    if draw == "slow":
        da = _slow_da(dev, (g, q), q, seed=seed + 1)
    return x, da, b, c


@pytest.mark.gpu
@pytest.mark.parametrize("q,p,n", SSD_SHAPES)
@pytest.mark.parametrize("draw", ["reference", "slow", "overflow"])
def test_cuda_ssd_bf16_route_matches_plain(q, p, n, draw):
    """The tensor-core route (bf16 x, B, C; fp32 operands in three bf16
    pieces) at every SSD shape, under each decay, at the file's tolerance."""
    from repro_torch.kernels import ref

    dev = _cuda()
    x, da, b, c = _ssd_draw(dev, 6, q, p, n, draw, seed=q * 1000 + p + n + 11)
    got = ssd_chunk_cuda(x, da, b, c)
    want = ref.ref_ssd_chunk(x, da, b, c)
    st_in = torch.randn(6, p, n, device=dev)
    y_off = ssd_combine_cuda(c, want[3], st_in)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        _ssd_close(g_, w_)
    _ssd_close(y_off, ref.ref_ssd_combine(c, want[3], st_in))


@pytest.mark.gpu
@pytest.mark.parametrize("q,p,n", SSD_SHAPES)
def test_cuda_ssd_bf16_route_is_deterministic_and_keeps_the_scan(q, p, n):
    """Two launches of the tensor-core route give the same bits, and its cum
    and decay are the SIMT route's bits (the same scan, once a cell)."""
    dev = _cuda()
    x, da, b, c = _ssd_draw(dev, 5, q, p, n, "slow", seed=q + 7 * p + n)
    first = ssd_chunk_cuda(x, da, b, c)
    second = ssd_chunk_cuda(x, da, b, c)
    simt = ssd_chunk_cuda(x.float(), da, b.float(), c.float())
    st_in = torch.randn(5, p, n, device=dev)
    y_off = [ssd_combine_cuda(c, first[3], st_in) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    assert torch.equal(y_off[0], y_off[1])
    assert torch.equal(first[2], simt[2]) and torch.equal(first[3], simt[3])


@pytest.mark.gpu
def test_cuda_ssd_c_entries_refuse_what_the_kernels_do_not_take():
    """The C entries return cudaErrorInvalidValue (1) for cells outside
    both routes, and for bf16 cells wider than the tensor-core route's N <=
    128; the wrappers raise before launching."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import MAX_N_BF16

    dev = _cuda()
    lib = _build.load("ssd_scan")
    vp, i = ctypes.c_void_p, ctypes.c_int
    chunk, combine = lib.ssd_chunk, lib.ssd_combine
    chunk.argtypes = [vp] * 8 + [ctypes.c_longlong, i, i, i, i, vp]
    combine.argtypes = [vp] * 4 + [ctypes.c_longlong, i, i, i, i, vp]
    chunk.restype = combine.restype = i
    big = torch.zeros(1 << 20, device=dev)  # room for every output the calls name
    ptr = big.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    for g, q, p, n, bf16 in [(1, 16, 8, MAX_N_BF16 + 1, 1), (0, 16, 8, 8, 1), (1, 257, 8, 8, 1),
                             (1, 16, 65, 8, 1), (1, 0, 8, 8, 0), (1, 16, 8, 0, 0)]:
        assert chunk(*[ptr] * 8, g, q, p, n, bf16, stream) == 1
        assert combine(*[ptr] * 4, g, q, p, n, bf16, stream) == 1
    x, da, b, c = _ssd_cells(dev, 2, 16, 8, MAX_N_BF16 + 1, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="N <= 128"):
        ssd_chunk_cuda(x, da, b, c)
    with pytest.raises(ValueError, match="N <= 128"):
        ssd_combine_cuda(c, da, torch.zeros(2, 8, MAX_N_BF16 + 1, device=dev))
    # the fp32 (SIMT) route takes the same cells
    from repro_torch.kernels import ref

    got = ssd_chunk_cuda(x.float(), da, b.float(), c.float())
    want = ref.ref_ssd_chunk(x.float(), da, b.float(), c.float())
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        _ssd_close(g_, w_)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_cuda_engine_prefill_runs_the_ssd_kernels(arch):
    """A ServeEngine on CUDA with default arguments runs every Mamba block's
    prefill SSD as the two kernels (one launch each per block per prefill),
    and its tokens equal those of the same engine with ssd_kernel_mode='off'."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    dev = _cuda()
    cfg = get_config(arch, smoke=True).scaled(coded=True, coded_parity=2, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (40, 16, 5, 2)]
    out = {}
    for mode in (None, "off"):
        eng = ServeEngine(model, params, n_slots=2, s_max=48, device=dev, ssd_kernel_mode=mode)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
        before = (ssd_chunk_cuda.launches, ssd_combine_cuda.launches)
        out[mode] = {r.uid: r.out_tokens for r in eng.run()}
        launched = (ssd_chunk_cuda.launches - before[0], ssd_combine_cuda.launches - before[1])
        want = cfg.n_layers * len(prompts) if mode is None else 0
        assert launched == (want, want)
    assert out[None] == out["off"]


# --------------------------------------------------------------------------
# fused macro-steps as CUDA graphs
# --------------------------------------------------------------------------
def _straggling_latency(seed, healthy_calls=0, persistent=False):
    """A shard-latency stream: random stragglers (or, with ``persistent``,
    shards 2, 5 and 9 always slow) after ``healthy_calls`` healthy calls."""
    rng = np.random.default_rng(seed)
    calls = [0]

    def latency_fn():
        calls[0] += 1
        lat = 1e-3 * (1.0 + 0.1 * rng.random(16))
        if calls[0] > healthy_calls:
            if persistent:
                lat[[2, 5, 9]] = 0.5
            else:
                lat[rng.random(16) < 0.2] *= 400.0
        return lat

    return latency_fn


def _graph_run(arch, macro_steps, *, mesh=False, max_new=18, n_req=4, topup=0,
               latency=None, masked=True):
    """A float32 smoke engine on the card, masked head under a straggler
    posterior (or, without ``masked``, a coded head with no mask source);
    returns the engine, its tokens and the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core.adaptive import ParityController
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.sharding import HeadMesh

    dev = _cuda()
    cfg = get_config(arch, smoke=True).scaled(coded=True, coded_parity=2, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    if cfg.family == "vlm":  # tanh(0) = 0 at init would hide the cross-attention layers
        for name, sub in params["blocks"].items():
            if name.startswith("xattn_"):
                sub["gate"].fill_(0.5)
    eng = ServeEngine(model, params, n_slots=4, s_max=64, device=dev, macro_steps=macro_steps,
                      latency_fn=(latency or _straggling_latency(3)) if masked else None,
                      parity_controller=ParityController(16, decay=0.5) if masked else None,
                      parity_topup=topup, topup_patience=3,
                      mesh=HeadMesh((dev,) * 16) if mesh else None)
    rng = np.random.default_rng(1)
    img = ({"img_embed": rng.standard_normal((cfg.img_tokens, cfg.d_model)).astype(np.float32)}
           if cfg.family == "vlm" else {})
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 5 + 3 * i), max_new_tokens=max_new,
                    **img) for i in range(n_req)]
    for r in reqs:
        eng.submit(r)
    before = (coded_matvec_decode_cuda.launches, coded_matvec_cuda.launches)
    eng.run()
    torch.cuda.synchronize()
    launches = (coded_matvec_decode_cuda.launches - before[0],
                coded_matvec_cuda.launches - before[1])
    return eng, {r.uid: list(r.out_tokens) for r in reqs}, launches


@pytest.mark.gpu
@pytest.mark.parametrize("arch,mesh", [("glm4-9b", False), ("mamba2-130m", False),
                                       ("dbrx-132b", False), ("llama-3.2-vision-11b", False),
                                       ("zamba2-1.2b", False), ("glm4-9b", True)])
def test_cuda_graph_blocks_equal_scalar_steps(arch, mesh):
    """Fused blocks replayed from captured graphs give the scalar route's
    tokens, for the dense, ssm and hybrid layouts and the head mesh of
    sixteen logical devices.  The launch counters after the replays are the
    scalar run's (prefills + steps, or 16 a call on the mesh) plus one
    eager warm-up step a capture; a replay counts its graph's kernel nodes,
    one head call a captured step.  Also the moe (dbrx-132b) and vlm
    (llama-3.2-vision-11b, seeded images) smokes: routing, capacity and
    the cached cross K/V inside a graph."""
    ref, ref_toks, ref_launches = _graph_run(arch, 1, mesh=mesh)
    eng, toks, launches = _graph_run(arch, 16, mesh=mesh)
    assert toks == ref_toks
    assert eng._steps == ref._steps and eng.macro_blocks > 0
    assert eng.graph_replays == eng.macro_blocks and eng.graph_log
    assert eng.sync_count < ref.sync_count
    n_calls = 4 + eng._steps
    assert ref_launches == ((0, 16 * n_calls) if mesh else (n_calls, 0))
    n_calls += len(eng.graph_log)
    assert launches == ((0, 16 * n_calls) if mesh else (n_calls, 0))
    for entry in eng.graph_log:
        want = {"coded_matvec": 16 * entry["k"]} if mesh else {"coded_matvec_decode": entry["k"]}
        assert entry["launches_per_replay"] == want


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", [False, True])
def test_cuda_graph_blocks_without_a_mask_source_decode_unmasked(mesh):
    """A coded head with neither ``mask_fn`` nor ``latency_fn``: the graphs
    read no mask buffer and decode every shard, as the scalar step does,
    on the single device and on the head mesh (where an all-erased mask
    would zero every logit); the tokens are the scalar route's."""
    ref, ref_toks, _ = _graph_run("glm4-9b", 1, mesh=mesh, masked=False)
    eng, toks, _ = _graph_run("glm4-9b", 16, mesh=mesh, masked=False)
    assert eng._mask_buf is None and eng.macro_blocks > 0 and eng.graph_log
    assert toks == ref_toks
    assert len({t for out in toks.values() for t in out}) > 1


@pytest.mark.gpu
def test_cuda_count_launch_under_capture_counts_the_replays():
    """A wrapper called while its stream captures records its kernel into
    the graph without counting a launch; the graph's kernel nodes, read
    back from the graph, are what each replay launches."""
    from repro_torch.kernels import graph_kernel_nodes
    from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(16 * 32, 64, generator=gen, device=dev)
    x = torch.randn(64, 2, generator=gen, device=dev)
    rec = torch.eye(14, 16, device=dev)
    y = coded_matvec_decode_cuda(w, x, rec)  # eager: the first-use set-up
    before = (coded_matvec_decode_cuda.launches, coded_matvec_decode_cuda.captured)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    stream = torch.cuda.Stream(dev)
    with torch.cuda.graph(graph, stream=stream):
        out = [coded_matvec_decode_cuda(w, x, rec) for _ in range(3)]
    assert (coded_matvec_decode_cuda.launches, coded_matvec_decode_cuda.captured) == (
        before[0], before[1] + 3)
    nodes = graph_kernel_nodes(graph)
    assert nodes["coded_matvec_decode"] == 3
    assert sum(nodes.values()) == 3
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, y) for o in out)


@pytest.mark.gpu
def test_cuda_graph_parity_raise_drops_graphs_and_captures_anew():
    """A raise re-binds: every graph of the (14, 2) head is dropped and the
    next block captures anew on the (13, 3) head; tokens stay the scalar
    route's."""
    lat = dict(healthy_calls=14, persistent=True)
    ref, ref_toks, _ = _graph_run("glm4-9b", 1, max_new=40, topup=1,
                                  latency=_straggling_latency(5, **lat))
    eng, toks, _ = _graph_run("glm4-9b", 4, max_new=40, topup=1,
                              latency=_straggling_latency(5, **lat))
    assert len(ref.parity_events) == len(eng.parity_events) == 1
    assert eng.parity_events == ref.parity_events
    assert toks == ref_toks
    parities = [e["n_parity"] for e in eng.graph_log]
    assert 2 in parities and 3 in parities
    assert parities == sorted(parities)       # nothing of the old bind after the raise
    assert all(blk for blk in eng._graphs.values())
    assert eng.model.cfg.coded_parity == 3


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["glm4-9b", "zamba2-1.2b"])
def test_cuda_graph_cache_leaves_keep_their_addresses(arch):
    """The graphs read fixed addresses: steps, replays and splices all
    write into the tensors the engine made at build time."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    dev = _cuda()
    cfg = get_config(arch, smoke=True).scaled(coded=True, coded_parity=2, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServeEngine(model, params, n_slots=2, s_max=48, device=dev, macro_steps=4)

    def ptrs(tree):
        if isinstance(tree, dict):
            return [p for v in tree.values() for p in ptrs(v)]
        if isinstance(tree, list):
            return [p for v in tree for p in ptrs(v)]
        return [tree.data_ptr()]

    before = ptrs(eng.cache) + [eng._last_tok.data_ptr()]
    rng = np.random.default_rng(2)
    for i in range(4):  # two waves: splices into slots the graphs read
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, 3 + 2 * i), max_new_tokens=10))
    eng.run()
    assert eng.graph_replays > 0 and eng.splice_rebuilds == 2
    assert ptrs(eng.cache) + [eng._last_tok.data_ptr()] == before


def _svd_graph_run(case, macro_steps, max_new=14):
    """A float32 glm4-9b smoke engine on the card whose head decodes
    through ``svd_recovery`` (the ``masked_pinv`` kernel): a (10, 6) head
    under seeded masks of up to six erasures (alone, or on a head mesh of
    sixteen logical devices on the card), the (14, 2) head in the 'svd'
    mode under masks of up to two, or an (11, 5) head whose six persistent
    stragglers raise it into (10, 6).  Returns the engine, its tokens and
    the launches of ``masked_pinv`` and of the head kernels."""
    from repro_torch.configs import get_config
    from repro_torch.core.adaptive import ParityController
    from repro_torch.kernels.masked_pinv import masked_pinv_cuda
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.sharding import HeadMesh

    dev = _cuda()
    parity = {"head_10_6": 6, "mesh_10_6": 6, "svd_mode": 2, "topup_into_10_6": 5}[case]
    cfg = get_config("glm4-9b", smoke=True).scaled(coded=True, coded_parity=parity,
                                                   dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(3)
    kw = {}
    if case == "topup_into_10_6":
        lat_rng = np.random.default_rng(4)

        def latency_fn():
            lat = 1e-3 * (1.0 + 0.1 * lat_rng.random(16))
            lat[[1, 3, 5, 7, 9, 11]] = 0.5
            return lat

        kw = dict(latency_fn=latency_fn, parity_controller=ParityController(16, decay=0.5),
                  parity_topup=1, topup_patience=2)
    else:
        def mask_fn():
            m = np.ones(16)
            m[rng.choice(16, rng.integers(0, parity + 1), replace=False)] = 0.0
            return m

        kw = dict(mask_fn=mask_fn, head_kernel_mode="svd" if case == "svd_mode" else None,
                  mesh=HeadMesh((dev,) * 16) if case == "mesh_10_6" else None)
    eng = ServeEngine(model, params, n_slots=4, s_max=48, device=dev, macro_steps=macro_steps,
                      **kw)
    prompts = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=prompts.integers(0, cfg.vocab, 5 + 3 * i),
                    max_new_tokens=max_new) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    wrappers = (masked_pinv_cuda, coded_matvec_decode_cuda, coded_matvec_cuda)
    before = [w.launches for w in wrappers]
    eng.run()
    torch.cuda.synchronize()
    launches = tuple(w.launches - b for w, b in zip(wrappers, before))
    return eng, {r.uid: list(r.out_tokens) for r in reqs}, launches


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["head_10_6", "svd_mode", "topup_into_10_6", "mesh_10_6"])
def test_cuda_macro_steps_refuse_what_a_graph_cannot_hold(case):
    """On the card, fused blocks hold the heads whose decode is
    ``svd_recovery`` (a geometry the DecoderCache refuses, now or after a
    raise, or the 'svd' mode; alone or on a head mesh of one card): the
    ``masked_pinv`` kernel builds the recovery matrix from the block's
    masks in the graph.  Fused tokens equal scalar tokens; every head call
    launches ``masked_pinv`` once (prefills + steps, and one eager warm-up
    step a capture), a replay counting its graph's nodes.  Only a head mesh
    over several cards still raises."""
    ref, ref_toks, ref_launches = _svd_graph_run(case, 1)
    eng, toks, launches = _svd_graph_run(case, 4)
    assert toks == ref_toks
    assert eng.parity_events == ref.parity_events
    assert eng._steps == ref._steps and eng.macro_blocks > 0
    assert eng.graph_replays == eng.macro_blocks and eng.graph_log
    head_kernel = 1 if case == "mesh_10_6" else 0    # index of the head's kernel's count
    svd_calls = [4 + ref._steps, 4 + eng._steps + len(eng.graph_log)]
    for run, got in ((ref, ref_launches), (eng, launches)):
        head_calls = got[1 + head_kernel] // (16 if case == "mesh_10_6" else 1)
        if case == "topup_into_10_6":   # the (11, 5) head before the raise takes the cache
            assert [e["n_parity"] for e in run.parity_events] == [6]
            assert 0 < got[0] < head_calls
        else:
            assert got[0] == head_calls == svd_calls[run is eng]
    for entry in eng.graph_log:
        if entry["n_parity"] == 6 or case == "svd_mode":
            assert entry["launches_per_replay"]["masked_pinv"] == entry["k"]
    if torch.cuda.device_count() >= 2 and case == "head_10_6":
        from repro_torch.serve import ServeEngine
        from repro_torch.sharding import HeadMesh

        dev = _cuda()
        mesh = HeadMesh(tuple(torch.device("cuda", i % 2) for i in range(16)))
        with pytest.raises(NotImplementedError, match="several cards"):
            ServeEngine(eng.model, eng.params, device=dev, macro_steps=4, mesh=mesh)


@pytest.mark.gpu
def test_cuda_macro_steps_refuse_the_plain_pinv_in_a_graph():
    """The plain head (``head_kernel_mode`` 'off') decodes a geometry the
    DecoderCache refuses through ``torch.linalg.pinv``, which syncs the
    host: fused blocks with it raise when the engine is built, now or after
    the allowed raises, and scalar steps still serve it; the plain version
    refuses a capture by name."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ServeEngine

    dev = _cuda()
    cfg = get_config("glm4-9b", smoke=True).scaled(coded=True, coded_parity=6, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    for mode in ("off", "interpret"):
        with pytest.raises(NotImplementedError, match=r"\(10, 6\) head"):
            ServeEngine(model, params, device=dev, macro_steps=4, head_kernel_mode=mode)
    ServeEngine(model, params, device=dev, macro_steps=1, head_kernel_mode="off")
    ServeEngine(model, params, device=dev, macro_steps=4, head_kernel_mode="cuda")
    model2 = build_model(cfg.scaled(coded_parity=2))
    params2 = model2.init(torch.Generator(device=dev).manual_seed(0), dev)
    ServeEngine(model2, params2, device=dev, macro_steps=4, head_kernel_mode="off")
    with pytest.raises(NotImplementedError, match=r"\(10, 6\) head"):
        ServeEngine(model2, params2, device=dev, macro_steps=4, head_kernel_mode="off",
                    parity_topup=4)
    mask, gen = torch.ones(16, device=dev), torch.ones(16, 10, dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError, match="captured"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=torch.cuda.Stream(dev)):
            ops.masked_pinv(mask, gen, mode="off")


def _erasure_masks(nb, n_parity, extra=32):
    """Every mask of at most n_parity erasures, then ``extra`` seeded masks
    of one erasure more."""
    import itertools

    rows = []
    for e in range(n_parity + 1):
        for erased in itertools.combinations(range(nb), e):
            m = np.ones(nb, np.float32)
            m[list(erased)] = 0.0
            rows.append(m)
    rng = np.random.default_rng(nb + n_parity)
    for _ in range(extra):
        m = np.ones(nb, np.float32)
        m[rng.choice(nb, n_parity + 1, replace=False)] = 0.0
        rows.append(m)
    return np.stack(rows)


@pytest.mark.gpu
@pytest.mark.parametrize("n_data,n_parity", [(10, 6), (14, 2)])
def test_cuda_masked_pinv_matches_plain_version_over_every_pattern(n_data, n_parity):
    """``masked_pinv`` on every pattern of at most n_parity erasures (14,893
    at (10, 6)) and on masks of one more, in one launch, against its plain
    version (``torch.linalg.pinv`` in float64), each mask within 1e-6 of
    its own max|rec|;
    erased columns exactly 0; a second call bit-identical, and a single
    mask's call the batch's row bit for bit; one launch counted a call;
    every mask converged inside the sweep cap."""
    from repro_torch.core.coded_ops import _generator64, svd_recovery
    from repro_torch.kernels.masked_pinv import MAX_SWEEPS, masked_pinv_cuda
    from repro_torch.kernels.ref import ref_masked_pinv

    dev = _cuda()
    nb = n_data + n_parity
    masks = torch.as_tensor(_erasure_masks(nb, n_parity), device=dev)
    gen = _generator64(nb, n_data, dev)
    sweeps = torch.zeros(len(masks), dtype=torch.int32, device=dev)
    before = masked_pinv_cuda.launches
    got = masked_pinv_cuda(masks, gen, sweeps)
    again = masked_pinv_cuda(masks, gen)
    torch.cuda.synchronize()
    assert masked_pinv_cuda.launches == before + 2
    want = ref_masked_pinv(masks, gen)
    err = (got - want).abs().amax((1, 2))
    assert bool((err <= 1e-6 * want.abs().amax((1, 2))).all())
    assert torch.equal(got, again)
    assert not got[(masks == 0)[:, None, :].expand_as(got)].any()
    assert 1 <= int(sweeps.min()) and int(sweeps.max()) < MAX_SWEEPS
    for i in (0, len(masks) // 3, len(masks) - 1):
        assert torch.equal(masked_pinv_cuda(masks[i].contiguous(), gen), got[i])
        assert torch.equal(svd_recovery(masks[i].contiguous(), n_data, n_parity), got[i])


@pytest.mark.gpu
def test_cuda_masked_pinv_in_a_graph_reads_its_mask_buffer():
    """Captured in a CUDA graph, ``svd_recovery`` reads the mask from the
    device at each replay (no host copy in the graph) and gives the eager
    call's bits; its kernel node is counted from the graph."""
    from repro_torch.core.coded_ops import svd_recovery
    from repro_torch.kernels import graph_kernel_nodes

    dev = _cuda()
    masks = torch.as_tensor(_erasure_masks(16, 6, extra=0)[::1500], device=dev)
    buf = masks[0].clone()
    svd_recovery(buf, 10, 6)   # eager first: the generator's upload
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev)):
        out = svd_recovery(buf, 10, 6)
    assert graph_kernel_nodes(graph)["masked_pinv"] == 1
    graph.instantiate()
    for m in masks:
        buf.copy_(m)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, svd_recovery(m.contiguous(), 10, 6))


# ---- the training path ------------------------------------------------------------
def _wrapper_calls(dev):
    """Each kernel wrapper with small valid inputs on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    rec = get_decoder_cache(4, 2).recovery(torch.ones(6, device=dev))
    idx = torch.tensor([[0, 1], [2, 0]], dtype=torch.int32, device=dev)
    cells = (rnd(3, 16, 8), -torch.rand(3, 16, generator=g, device=dev), rnd(3, 16, 4),
             rnd(3, 16, 4))
    return [
        (coded_matvec_cuda, (rnd(24, 16), rnd(16, 2))),
        (coded_matvec_decode_cuda, (rnd(24, 16), rnd(16, 2), rec)),
        (gaussian_encode_cuda, (rnd(5, 3), rnd(3, 40))),
        (lt_encode_cuda, (rnd(3, 40), idx, torch.ones(2, 2, device=dev))),
        (masked_pinv_cuda, (torch.ones(6, device=dev), rnd(6, 4).double())),
        (prefill_attn_cuda, (rnd(1, 5, 2, 64).bfloat16(), rnd(1, 5, 1, 64).bfloat16(),
                             rnd(1, 5, 1, 64).bfloat16(), rnd(1, 5, 32), rnd(1, 5, 32),
                             rnd(1, 5, 1, 64).bfloat16(), rnd(1, 5, 1, 64).bfloat16())),
        (ssd_chunk_cuda, cells),
        (ssd_combine_cuda, (cells[3], torch.cumsum(cells[1], 1), rnd(3, 8, 4))),
    ]


@pytest.mark.gpu
def test_cuda_kernel_wrappers_refuse_inputs_that_require_grad():
    """Under grad mode every wrapper raises, naming itself, when an input
    requires grad (its kernel has no backward); under no_grad it launches."""
    dev = _cuda()
    for wrapper, args in _wrapper_calls(dev):
        for k, a in enumerate(args):
            if not a.is_floating_point():
                continue
            grad_args = [t.clone().requires_grad_(i == k) for i, t in enumerate(args)]
            before = wrapper.launches
            with pytest.raises(RuntimeError, match=wrapper.__name__):
                wrapper(*grad_args)
            assert wrapper.launches == before
            with torch.no_grad():
                wrapper(*grad_args)
            assert wrapper.launches == before + 1
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk,p,n", [(512, 256, 64, 64), (1024, 256, 48, 128), (96, 32, 8, 16)])
def test_cuda_ssd_scan_forward_is_the_kernels_and_grads_are_ssd_chunkeds(s, chunk, p, n, dtype):
    """SSDScan on the card: its forward is ssd_forward through the two
    kernels (one launch of each, bit-equal outputs), and its gradients are
    those of autograd through ssd_chunked at the same inputs (1e-5 of each
    gradient's max: the same computation, recomputed)."""
    from repro_torch.models.ssm import ssd_chunked

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(s + p)
    bsz, h = 2, 4
    x = (torch.randn(bsz, s, h, p, generator=g, device=dev) * 0.5).to(dtype)
    da = -torch.rand(bsz, s, h, generator=g, device=dev) * 0.1
    b = torch.randn(bsz, s, 1, n, generator=g, device=dev).to(dtype)
    c = torch.randn(bsz, s, 1, n, generator=g, device=dev).to(dtype)
    ins = [t.clone().requires_grad_(True) for t in (x, da, b, c)]
    before = (ssd_chunk_cuda.launches, ssd_combine_cuda.launches)
    y, fin = ops.SSDScan.apply(*ins, chunk, None)
    assert (ssd_chunk_cuda.launches - before[0], ssd_combine_cuda.launches - before[1]) == (1, 1)
    with torch.no_grad():
        wy, wfin = ops.ssd_forward(x, da, b, c, chunk, mode="cuda")
    assert torch.equal(y, wy) and torch.equal(fin, wfin)
    gy = torch.randn(y.shape, generator=g, device=dev).to(dtype)
    gf = torch.randn(fin.shape, generator=g, device=dev)
    before = (ssd_chunk_cuda.launches, ssd_combine_cuda.launches)
    gots = torch.autograd.grad((y, fin), ins, (gy, gf))
    assert (ssd_chunk_cuda.launches, ssd_combine_cuda.launches) == before  # no kernel backward
    ref_in = [t.clone().requires_grad_(True) for t in (x, da, b, c)]
    wants = torch.autograd.grad(ssd_chunked(*ref_in, chunk), ref_in, (gy, gf))
    for got, want in zip(gots, wants):
        assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= 1e-5 * max(scale, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-130m", "zamba2-1.2b"])
def test_cuda_train_step_matches_the_cpu(arch):
    """A coded train step of a float32 smoke config on the card gives the
    CPU's loss (1e-5 relative) and gradient (the first moment, 1e-4 of each
    leaf's max), and the next step's loss (1e-5); the Mamba blocks launch
    ssd_chunk and ssd_combine once a block a forward and once a recompute."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map

    dev = _cuda()
    cfg = get_config(arch, smoke=True).scaled(dtype="float32")
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3)
    tc = TrainConfig(microbatches=2, gradient_coding="frc")
    step = make_train_step(model, opt, tc)
    pipe = make_pipeline(cfg, seq=32, global_batch=4)
    cpu = init_train_state(model, torch.Generator().manual_seed(0), opt, tc, device="cpu")
    gpu = tree_map(lambda t: t.to(dev), cpu)
    out = {}
    for name, st in (("cpu", cpu), ("gpu", gpu)):
        before = (ssd_chunk_cuda.launches, ssd_combine_cuda.launches)
        st1, m1 = step(st, pipe.batch(0), torch.ones(2))
        launches = (ssd_chunk_cuda.launches - before[0], ssd_combine_cuda.launches - before[1])
        _, m2 = step(st1, pipe.batch(1), torch.ones(2))
        out[name] = (st1, float(m1["loss"]), float(m2["loss"]), launches)
    want_launches = (0, 0) if cfg.family == "dense" else (cfg.n_layers * 2 * 2,) * 2
    assert out["cpu"][3] == (0, 0) and out["gpu"][3] == want_launches
    for k in (1, 2):
        assert abs(out["gpu"][k] - out["cpu"][k]) <= 1e-5 * abs(out["cpu"][k])
    for a, b in zip(tree_leaves(out["gpu"][0]["opt"]["m"]), tree_leaves(out["cpu"][0]["opt"]["m"])):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["plain", "frc"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "llama-3.2-vision-11b", "seamless-m4t-large-v2"])
def test_cuda_family_train_step_matches_the_cpu(arch, kind):
    """The moe, vlm (cross-attention gates 0.5, the pipeline's seeded images)
    and encdec (seeded frames) train steps of a float32 smoke config, plain
    over 4 microbatches and FRC (s = 1) under one straggler: on the card the
    CPU's loss and metrics (1e-5 relative), gradient (the first moment,
    1e-4 of each leaf's max) and next loss (1e-5); no hand-written kernel
    launches on these paths."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map

    dev = _cuda()
    cfg = get_config(arch, smoke=True).scaled(dtype="float32")
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3)
    tc = TrainConfig(microbatches=4, **({"gradient_coding": "frc"} if kind == "frc" else {}))
    mask = () if kind == "plain" else (torch.tensor([1.0, 0.0, 1.0, 1.0]),)
    step = make_train_step(model, opt, tc)
    pipe = make_pipeline(cfg, seq=32, global_batch=8, seed=2)
    cpu = init_train_state(model, torch.Generator().manual_seed(0), opt, tc, device="cpu")
    for name, sub in cpu["params"]["blocks"].items() if cfg.family == "vlm" else ():
        if name.startswith("xattn_"):
            sub["gate"].fill_(0.5)
    gpu = tree_map(lambda t: t.to(dev), cpu)
    out = {}
    for name, st in (("cpu", cpu), ("gpu", gpu)):
        before = {k: w.launches for k, w in kernel_wrappers().items()}
        st1, m1 = step(st, pipe.batch(0), *mask)
        _, m2 = step(st1, pipe.batch(1), *mask)
        launched = {k: w.launches - before[k] for k, w in kernel_wrappers().items()}
        out[name] = (st1, {k: float(v) for k, v in m1.items()}, float(m2["loss"]), launched)
    assert not any(out["cpu"][3].values()) and not any(out["gpu"][3].values()), out["gpu"][3]
    assert out["gpu"][1].get("ok", 1.0) == 1.0
    for k, want in out["cpu"][1].items():
        assert abs(out["gpu"][1][k] - want) <= 1e-5 * max(abs(want), 1e-30), (k, out)
    assert abs(out["gpu"][2] - out["cpu"][2]) <= 1e-5 * abs(out["cpu"][2])
    for a, b in zip(tree_leaves(out["gpu"][0]["opt"]["m"]), tree_leaves(out["cpu"][0]["opt"]["m"])):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,sk", [(True, 4096), (False, 4096), (False, 1024)])
def test_cuda_sdpa_chunked_matches_the_dense_sdpa(dtype, causal, sk):
    """The chunked online-softmax SDPA against the dense ``_sdpa`` on the
    same q, k, v (fp32 in both: the dense one on the upcast inputs): the
    reference's 2e-5 for fp32 inputs, one bf16 step of max|dense| for bf16
    (the chunked output's rounding)."""
    from repro_torch.models.attention import _causal_mask5, _sdpa, _sdpa_chunked

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(sk + causal)
    q = torch.randn(1, 4096, 4, 64, device=dev, generator=gen).to(dtype)
    k = torch.randn(1, sk, 2, 64, device=dev, generator=gen).to(dtype)
    v = torch.randn(1, sk, 2, 64, device=dev, generator=gen).to(dtype)
    got = _sdpa_chunked(q, k, v, causal=causal)
    want = _sdpa(q.float(), k.float(), v.float(), _causal_mask5(4096, sk, dev) if causal else None)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7 * scale
    assert float((got.float() - want).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k,groups,shared", [(4, 1, False), (1, 2, True), (2, 1, True)])
def test_cuda_moe_apply_matches_its_loop(dtype, top_k, groups, shared):
    """``moe_apply`` (scatter, batched expert GEMMs, gather) against the
    token-by-token ``moe_apply_loop`` with the same keep mask, drops
    included: 1e-5 of max|loop| in fp32, two bf16 steps in bf16; two calls
    bit-equal (kept slots are unique, so the scatter's bits are fixed)."""
    from repro_torch.models.moe import init_moe, moe_apply, moe_apply_loop, route

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(top_k)
    p = init_moe(gen, 256, 512, 16, "swiglu", shared, torch.float32, dev)
    p = {k: (v if k == "router" else
             {n: w.to(dtype) for n, w in v.items()} if isinstance(v, dict) else v.to(dtype))
         for k, v in p.items()}
    x = torch.randn(2, 24, 256, device=dev, generator=gen).to(dtype)
    kw = dict(top_k=top_k, capacity_factor=0.75, kind="swiglu", dispatch_groups=groups)
    y, aux = moe_apply(p, x, **kw)
    again, _ = moe_apply(p, x, **kw)
    loop = moe_apply_loop(p, x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    assert not bool(route(p, x.reshape(-1, 256), top_k=top_k, capacity_factor=0.75,
                          dispatch_groups=groups).keep.all())
    scale = float(loop.float().abs().max())
    tol = 1e-5 * scale if dtype == torch.float32 else 2 * 2.0 ** -7 * scale
    assert float((y.float() - loop.float()).abs().max()) <= tol and bool(torch.isfinite(aux))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4])
def test_cuda_coded_matvec_decode_at_the_dbrx_head(b):
    """dbrx-132b's coded head, W_c [114688, 6144] (14 + 2 blocks): at B = 4
    x is 96 KB, over ``thin_rows.cuh``'s 64 KB resident cap, so the decode
    runs x in panels; at B = 1 x is resident.  Against the plain version
    under 0 and 2 erasures, launched twice and bit-equal to itself."""
    from repro_torch.kernels import thin_rows

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(b)
    n_data, n_parity, br, m = 14, 2, 7168, 6144
    w = torch.randn(16 * br, m, device=dev, generator=gen)
    x = torch.randn(m, b, device=dev, generator=gen)
    assert (b * m * 4 > thin_rows.X_CAP_BYTES) == (b == 4)
    cache = get_decoder_cache(n_data, n_parity)
    for erased in ((), (3, 15)):
        mask = torch.ones(16, device=dev)
        mask[list(erased)] = 0.0
        rec = cache.recovery(mask)
        got = ops.coded_matvec_decode(w, x, rec, mode="cuda")
        again = ops.coded_matvec_decode(w, x, rec, mode="cuda")
        want = ops.coded_matvec_decode(w, x, rec, mode="off")
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * max(1.0, scale)
    del w
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# per-shape dispatch ('auto'): the kernel, launched exactly once
# --------------------------------------------------------------------------
def _auto_calls(dev, gen):
    """(name, wrapper counted, 'auto' call, 'cuda' call) for every kernel
    that 'auto' reaches."""
    from repro_torch.core.coded_ops import CodedLinear

    t = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    a, x = t(1001, 260), t(260, 4)
    cl = CodedLinear(14, 2, 14 * 40)
    wc, xh = t(16 * 40, 260), t(260, 3)
    mask = torch.ones(16, device=dev)
    mask[[2, 9]] = 0.0
    g, a2 = t(16, 13), t(13, 70_001)
    lt = LTCode(300, seed=3).plan(420)
    a3 = t(300, 4097)
    idx = torch.as_tensor(lt.indices[300:], device=dev)
    cof = torch.as_tensor(lt.coeffs[300:], device=dev)
    return [
        ("coded_matvec", coded_matvec_cuda, lambda m: ops.coded_matvec(a, x, m)),
        ("coded_matvec_decode", coded_matvec_decode_cuda,
         lambda m: cl.apply(wc, xh, mask, kernel_mode=m)),
        ("gaussian_encode", gaussian_encode_cuda, lambda m: ops.gaussian_encode(g, a2, m)),
        ("lt_encode", lt_encode_cuda, lambda m: ops.lt_encode(a3, idx, cof, m)),
    ]


@pytest.mark.gpu
def test_cuda_auto_launches_the_kernel_once():
    """'auto' on CUDA tensors raises each kernel's launch count by exactly
    one and gives the 'cuda' mode's bits: it never runs the plain version."""
    from repro_torch.kernels import dispatch

    dev = _cuda()
    dispatch.invalidate()
    for name, wrapper, call in _auto_calls(dev, torch.Generator(device=dev).manual_seed(5)):
        want = call("cuda")
        before = wrapper.launches
        got = call("auto")
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, name
        assert torch.equal(got, want), name


@pytest.mark.gpu
def test_cuda_auto_raises_where_cuda_raises():
    """'auto' on a CUDA tensor refuses what the kernel refuses, as 'cuda'
    does, and launches nothing."""
    from repro_torch.core.coded_ops import CodedLinear

    dev = _cuda()
    cases = [
        (TypeError, lambda m: ops.coded_matvec_decode(
            torch.zeros(32, 8, device=dev, dtype=torch.float16),
            torch.zeros(8, 2, device=dev, dtype=torch.float16), torch.eye(16, device=dev)[:14],
            m)),
        (ValueError, lambda m: ops.coded_matvec(torch.zeros(8, 8, device=dev),
                                                torch.zeros(8, 0, device=dev), m)),
        (ValueError, lambda m: ops.gaussian_encode(torch.zeros(4, 3, device=dev),
                                                   torch.zeros(5, 40, device=dev), m)),
        (IndexError, lambda m: ops.lt_encode(torch.zeros(3, 8, device=dev),
                                             torch.full((2, 2), 5, device=dev),
                                             torch.ones(2, 2, device=dev), m)),
        (ValueError, lambda m: CodedLinear(14, 2, 14 * 8).apply(
            torch.zeros(16 * 8, 8, device=dev), torch.zeros(8, 0, device=dev),
            torch.ones(16, device=dev), kernel_mode=m)),
    ]
    from repro_torch.kernels import kernel_wrappers

    for err, call in cases:
        counts = {n: w.launches for n, w in kernel_wrappers().items()}
        for mode in ("cuda", "auto"):
            with pytest.raises(err):
                call(mode)
        assert counts == {n: w.launches for n, w in kernel_wrappers().items()}


# --------------------------------------------------------------------------
# the serving prefill's attention (kernels/prefill_attn.py)
# --------------------------------------------------------------------------
# prompt lengths: one token, either side of a 64-row tile, the longprompt
# cell's median and longest prompts and its cache (4160), ragged ones
PREFILL_LENGTHS = (1, 63, 64, 65, 1000, 1024, 3000, 4096, 4160)


def _prefill_inputs(dev, b, s, h, kvh, hd, seed):
    from repro_torch.models.layers import rope_table

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, s, n, hd, generator=g, device=dev).to(torch.bfloat16)
               for n in (h, kvh, kvh))
    return q, k, v, rope_table(torch.arange(s, device=dev)[None], hd, 5e5)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("h,kvh", [(32, 2), (4, 4)])
@pytest.mark.parametrize("s", PREFILL_LENGTHS)
def test_cuda_prefill_attn_matches_plain(s, h, kvh, hd):
    """The prefill kernel (GQA 16:1, glm4-9b's heads, and 1:1) against its
    plain version on the same projections: the cache rows [:S] bit-equal
    (the same fp32 rotation, each product and sum rounded alone), the rows
    past S untouched; one attention launch and one prologue.  The output's
    largest error against an fp32 SDPA of the same roped inputs is no larger
    than the plain bf16 ``_sdpa``'s, within one rounding of the output to
    bf16 (2^-9 of max|out|): the kernel keeps the logits in fp32 where the
    plain version rounds them to bf16, so its error is about that last
    rounding alone (0.005-0.010 against the plain's 0.008-0.016 at max|out|
    2.6-3.9, measured on an H100); where the logits' rounding costs the
    plain version little (S = 65, 1:1, Hd 64: 0.0080 against 0.0077), which
    of the two lands nearer is the output rounding's draw."""
    from repro_torch.models.attention import _attention_prefill_plain, _causal_mask5, _sdpa
    from repro_torch.models.layers import apply_rope_table

    dev = _cuda()
    assert not torch.backends.cuda.matmul.allow_tf32
    q, k, v, rope = _prefill_inputs(dev, 1, s, h, kvh, hd, s + hd + h)
    cache = torch.full((4, 1, s + 7, kvh, hd), 3.0, dtype=torch.bfloat16, device=dev)
    before = (prefill_attn_cuda.launches, prefill_attn_cuda.prologue_launches)
    with torch.no_grad():
        got = prefill_attn_cuda(q, k, v, *rope, cache[0, :, :s], cache[1, :, :s])
        torch.cuda.synchronize()
        assert (prefill_attn_cuda.launches - before[0],
                prefill_attn_cuda.prologue_launches - before[1]) == (1, 1)
        plain = _attention_prefill_plain(q, k, v, rope, cache[2, :, :s], cache[3, :, :s])
        ref = _sdpa(apply_rope_table(q, *rope).float(), apply_rope_table(k, *rope).float(),
                    v.float(), _causal_mask5(s, s, dev))
    assert torch.equal(cache[0], cache[2]) and torch.equal(cache[1], cache[3])
    assert bool((cache[:, :, s:] == 3).all())
    assert got.shape == plain.shape and got.dtype == torch.bfloat16
    kernel_err = float((got.float() - ref).abs().max())
    plain_err = float((plain.float() - ref).abs().max())
    assert kernel_err <= plain_err + 2.0 ** -9 * float(ref.abs().max()), (kernel_err, plain_err)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kvh,hd", [(2, 100, 8, 2, 64), (3, 130, 4, 1, 128)])
def test_cuda_prefill_attn_batches(b, s, h, kvh, hd):
    """B > 1 with one rope table for every row and cache rows that are a
    view of a longer cache (batches s_max rows apart): each batch's output
    and cache rows are those of a B = 1 call on its own."""
    dev = _cuda()
    q, k, v, rope = _prefill_inputs(dev, b, s, h, kvh, hd, b * s)
    cache = torch.zeros((2, b, s + 9, kvh, hd), dtype=torch.bfloat16, device=dev)
    one = torch.zeros((2, 1, s, kvh, hd), dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        got = prefill_attn_cuda(q, k, v, *rope, cache[0, :, :s], cache[1, :, :s])
        for i in range(b):
            want = prefill_attn_cuda(q[i:i + 1], k[i:i + 1], v[i:i + 1], *rope, one[0], one[1])
            assert torch.equal(got[i:i + 1], want)
            assert torch.equal(cache[0, i, :s], one[0, 0]) and torch.equal(cache[1, i, :s], one[1, 0])


@pytest.mark.gpu
def test_cuda_engine_serves_the_same_tokens_through_the_prefill_kernel(monkeypatch):
    """A 2-layer engine at head_dim 128: every prefill layer launches the
    kernel once (and its prologue once), and the tokens equal those of the
    same engine with the prefill on the plain path; the decode reads the
    cache rows the kernel wrote."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention, transformer
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    dev = _cuda()
    cfg = get_config("glm4-9b", smoke=True).scaled(head_dim=128, n_layers=2, coded=True,
                                                   coded_parity=2)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (130, 64, 33, 5, 1)]
    out = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            for mod in (attention, transformer):
                monkeypatch.setattr(mod, "prefill_path", lambda x, hd: "plain")
        eng = ServeEngine(model, params, n_slots=2, s_max=160, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        before = (prefill_attn_cuda.launches, prefill_attn_cuda.prologue_launches)
        out[route] = {r.uid: r.out_tokens for r in eng.run()}
        want = cfg.n_layers * len(prompts) if route == "kernel" else 0
        assert (prefill_attn_cuda.launches - before[0],
                prefill_attn_cuda.prologue_launches - before[1]) == (want, want)
    assert len(out["kernel"]) == len(prompts)
    assert out["kernel"] == out["plain"]
