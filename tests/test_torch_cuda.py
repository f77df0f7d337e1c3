"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips, with its reason, where
there is no CUDA device.  This file imports neither jax nor the reference,
so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m gpu -q

Tolerance: |kernel - plain| <= 1e-4 * max(1, max|plain|) — both fp32, summed
in another order; for fp16 inputs of ``coded_matvec`` (fp32 sums in both)
the reference's fp16 bound, 2e-3.  The SSD kernels, fp32 or bf16 inputs
(cast to fp32 in both): the reference's rtol 1e-4 and atol 1e-5, the atol
scaled by max|plain|.
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
    LT_HEAVY_DEGREE,
    _lt_csr,
    _lt_launch,
    gaussian_encode_cuda,
    lt_encode_cuda,
)
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
# many grid-stride steps of the persistent grid (M % 4 == 0 and != 0)
ENCODE_SHAPES = [(16, 13, 700), (16, 14, 1), (5, 3, 129), (33, 40, 257), (1, 1, 4),
                 *((q, 13, 1031) for q in (1, 8, 9, 16, 17, 26, 32, 33, 70)),
                 (26, 500, 2048), (32, 1500, 517), (70, 2000, 260),
                 (16, 13, 4_000_000), (26, 50, 1_000_003)]
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
    dev = _cuda()
    rng = np.random.default_rng(q * 1000 + r * 10 + m)
    g = torch.as_tensor(rng.standard_normal((q, r)).astype(np.float32), device=dev)
    a = torch.as_tensor(rng.standard_normal((r, m)).astype(np.float32), device=dev)
    got = ops.gaussian_encode(g, a)
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
        got = _lt_launch(a, c)
        torch.cuda.synchronize()
        assert torch.equal(got, want), c.n_heavy
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
    emulator whose device defaults to the card: one lt_encode launch each,
    and the trajectory of the host-encode run."""
    from repro_torch.cluster import ClusterEmulator, TaskSpec, ec2_scenario
    from repro_torch.core.adaptive import ChurnEvent, ChurnSchedule, ReallocationPolicy

    _cuda()
    rng = np.random.default_rng(0)
    a = rng.standard_normal((400, 64)).astype(np.float32)
    x = rng.standard_normal(64).astype(np.float32)
    _, workers = ec2_scenario(1)
    churn = ChurnSchedule((ChurnEvent(t=0.01, worker=0, kind="death"),
                           ChurnEvent(t=0.008, worker=1, kind="rate", factor=5.0)))
    runs = {}
    for mode in ("cuda", "default", None):
        before = lt_encode_cuda.launches
        em = ClusterEmulator(workers, time_scale=0.02, seed=9)
        kw = {} if mode == "default" else {"encode_mode": mode}
        runs[mode] = em.run_task(a, x, TaskSpec(code="lt", churn=churn,
                                                adaptive=ReallocationPolicy(), **kw))
        assert lt_encode_cuda.launches - before == (1 if mode else 0)
    ref = a.astype(np.float64) @ x
    for mode in ("cuda", "default"):
        assert runs[mode].ok and runs[mode].arrivals == runs[None].arrivals
        assert runs[mode].reallocations == runs[None].reallocations
        assert np.abs(runs[mode].y - ref).max() / np.abs(ref).max() < 2e-3


@pytest.mark.gpu
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    wc = torch.zeros(16, 8, device=dev)
    rec = torch.zeros(2, 4, device=dev)
    with pytest.raises(ValueError, match="columns"):
        coded_matvec_decode_cuda(wc, torch.zeros(8, 17, device=dev), rec)
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
        coded_matvec_cuda(a, torch.zeros(4, 17, device=dev))
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
