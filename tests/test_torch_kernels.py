"""Port kernels vs the JAX reference: plain versions against the Pallas
kernels (interpret mode), mode routing, and the port's import isolation.

The hand-written CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda.py``.
"""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.coded_ops import encode_blocks as jax_encode_blocks
from repro.kernels.coded_decode import coded_matvec_decode_pallas
from repro.kernels.lt_encode import gaussian_encode_pallas
from repro.kernels.ops import encode_blocks_device as jax_encode_blocks_device
from repro_torch.core.decoding import get_decoder_cache
from repro_torch.kernels import ops
from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda
from repro_torch.kernels.lt_encode import gaussian_encode_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def _decode_inputs(n_data, n_parity, out, inner, b):
    rng = np.random.default_rng(n_data * 100 + out + inner)
    w = rng.standard_normal((out, inner)).astype(np.float32)
    wc = np.array(jax_encode_blocks(jnp.asarray(w), n_data, n_parity))
    x = rng.standard_normal((inner, b)).astype(np.float32)
    return w, wc, x


@pytest.mark.parametrize("n_data,n_parity,out,inner,b", DECODE_SHAPES)
def test_plain_coded_matvec_decode_matches_pallas(n_data, n_parity, out, inner, b):
    w, wc, x = _decode_inputs(n_data, n_parity, out, inner, b)
    cache = get_decoder_cache(n_data, n_parity)
    for m in _masks(n_data, n_parity):
        rec = cache.recovery(torch.as_tensor(m))
        got = ops.coded_matvec_decode(torch.as_tensor(wc), torch.as_tensor(x), rec)
        want = np.asarray(coded_matvec_decode_pallas(
            jnp.asarray(wc), jnp.asarray(x), jnp.asarray(rec.numpy()), interpret=True))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(want).max()))
        truth = w @ x
        np.testing.assert_allclose(got.numpy()[:out], truth, rtol=1e-3,
                                   atol=1e-3 * max(1.0, np.abs(truth).max()))


def test_plain_coded_matvec_decode_vector_x():
    _, wc, x = _decode_inputs(6, 2, 100, 64, 1)
    rec = get_decoder_cache(6, 2).recovery(torch.ones(8))
    got = ops.coded_matvec_decode(torch.as_tensor(wc), torch.as_tensor(x[:, 0]), rec)
    want = np.asarray(coded_matvec_decode_pallas(
        jnp.asarray(wc), jnp.asarray(x[:, 0]), jnp.asarray(rec.numpy()), interpret=True))
    assert got.shape == want.shape == (6 * 17,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("q,r,m", ENCODE_SHAPES)
def test_plain_gaussian_encode_matches_pallas(q, r, m):
    rng = np.random.default_rng(q * 1000 + r * 10 + m)
    g = rng.standard_normal((q, r)).astype(np.float32)
    a = rng.standard_normal((r, m)).astype(np.float32)
    got = ops.gaussian_encode(torch.as_tensor(g), torch.as_tensor(a)).numpy()
    want = np.asarray(gaussian_encode_pallas(jnp.asarray(g), jnp.asarray(a), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("n_data,n_parity,out,inner", [(14, 2, 100, 24), (13, 3, 100, 24),
                                                       (4, 2, 9, 5)])
def test_encode_blocks_device_matches_reference(n_data, n_parity, out, inner):
    rng = np.random.default_rng(out + inner)
    w = rng.standard_normal((out, inner)).astype(np.float32)
    got = ops.encode_blocks_device(torch.as_tensor(w), n_data, n_parity).numpy()
    want = np.asarray(jax_encode_blocks_device(jnp.asarray(w), n_data, n_parity,
                                               mode="interpret"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # and the offline einsum encode of the same weight (plain vs transposed view)
    offline = np.asarray(jax_encode_blocks(jnp.asarray(w), n_data, n_parity))
    np.testing.assert_allclose(got, offline, rtol=1e-4, atol=1e-4 * np.abs(offline).max())
    got_t = ops.encode_blocks_device(torch.as_tensor(w.T.copy()).T, n_data, n_parity)
    np.testing.assert_array_equal(got_t.numpy(), got)


def test_cuda_mode_on_cpu_tensors_raises():
    wc = torch.zeros(16, 8)
    x = torch.zeros(8, 2)
    rec = torch.zeros(2, 4)
    for mode in ("cuda", "compile"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.coded_matvec_decode(wc, x, rec, mode=mode)
        with pytest.raises(ValueError, match="CUDA"):
            ops.gaussian_encode(torch.zeros(3, 8), x, mode=mode)
        with pytest.raises(ValueError, match="CUDA"):
            ops.encode_blocks_device(torch.zeros(10, 4), 2, 1, mode=mode)
    with pytest.raises(ValueError, match="CUDA"):
        coded_matvec_decode_cuda(wc, x, rec)
    with pytest.raises(ValueError, match="CUDA"):
        gaussian_encode_cuda(torch.zeros(3, 2), torch.zeros(2, 5))


def test_mode_routing():
    t = torch.zeros(2)
    assert ops.resolve_mode(None, t) == "off"        # CPU tensor: plain version
    assert ops.resolve_mode("interpret", t) == "off"
    assert ops.resolve_mode("off", t) == "off"
    with pytest.raises(NotImplementedError):
        ops.resolve_mode("auto", t)
    with pytest.raises(ValueError, match="unknown kernel mode"):
        ops.resolve_mode("triton", t)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch.serve.engine, repro_torch.launch.serve\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.coded_decode\n"
        "import repro_torch.kernels.lt_encode, repro_torch.kernels._build\n"
        "import repro_torch.weights, repro_torch.configs, repro_torch.core.adaptive\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
