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
from repro_torch.kernels import ops
from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda
from repro_torch.kernels.lt_encode import gaussian_encode_cuda

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
