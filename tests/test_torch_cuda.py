"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips, with its reason, where
there is no CUDA device.  This file imports neither jax nor the reference,
so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m gpu -q

Tolerance: |kernel - plain| <= 1e-4 * max(1, max|plain|) — both fp32, summed
in another order.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.coded_ops import encode_blocks
from repro_torch.core.decoding import get_decoder_cache
from repro_torch.core.encoding import GaussianCode, LTCode
from repro_torch.kernels import ops
from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda
from repro_torch.kernels.lt_encode import gaussian_encode_cuda, lt_encode_cuda

# (n_data, n_parity, out, inner, b): ragged block rows, unaligned inner, B = 1..16
DECODE_SHAPES = [
    (6, 2, 100, 64, 8),
    (12, 4, 256, 32, 1),
    (4, 2, 64, 129, 3),
    (14, 2, 515, 130, 4),
    (13, 3, 77, 516, 16),
]
# (q, r, m): the encode's skinny K, ragged q / r / M
ENCODE_SHAPES = [(16, 13, 700), (16, 14, 1), (5, 3, 129), (33, 40, 257), (1, 1, 4)]
# (q, d_max, r, m, zero_frac): LT degree tables with zeros anywhere in a row
# and a degree-0 row; M % 4 != 0 (scalar loads), M over one 4096-column span,
# q = 1 with d_max = 1, more entries in a row than one shared-memory stage
LT_SHAPES = [(6, 5, 20, 64, 0.4), (9, 3, 11, 129, 0.5), (1, 1, 3, 7, 0.0),
             (40, 7, 30, 4097, 0.3), (3, 600, 1000, 8200, 0.2), (70000, 2, 5, 4, 0.0)]


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
    so the two agree bit for bit; the tolerance is still the file's."""
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
    if q > 1:
        assert not got[q // 2].any()


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
