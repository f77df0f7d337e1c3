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
from repro.kernels.coded_matvec import coded_matvec_pallas
from repro.core.encoding import GaussianCode as RefGaussianCode
from repro.core.encoding import LTCode as RefLTCode
from repro.kernels.lt_encode import gaussian_encode_pallas, lt_encode_pallas
from repro.kernels.ops import encode_blocks_device as jax_encode_blocks_device
from repro.kernels.ops import encode_rows as jax_encode_rows
from repro_torch.core.decoding import get_decoder_cache
from repro_torch.core.encoding import GaussianCode, LTCode
from repro_torch.kernels import ops
from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda
from repro_torch.kernels.lt_encode import gaussian_encode_cuda, lt_encode_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (n_data, n_parity, out, inner, b): ragged block rows, unaligned inner, B = 1..16,
# and x wider than the thin-row engine's 16 columns (17, 40: the card's wide engine)
DECODE_SHAPES = [
    (6, 2, 100, 64, 8),
    (12, 4, 256, 32, 1),
    (4, 2, 64, 129, 3),
    (14, 2, 515, 130, 4),
    (13, 3, 77, 516, 16),
    (14, 2, 515, 130, 17),
    (13, 3, 77, 516, 40),
]
# (r, m, b): coded_matvec's plain version against the Pallas kernel, thin and wide x
MATVEC_SHAPES = [(100, 70, 1), (513, 129, 3), (300, 260, 17), (77, 516, 40)]
# (q, r, m): the encode's skinny K, ragged q / r / M
ENCODE_SHAPES = [(16, 13, 700), (16, 14, 1), (5, 3, 129), (33, 40, 257), (1, 1, 4)]
# (q, d_max, r, m, zero_frac): LT degree tables kept small (interpret mode
# walks the whole q x M/512 x d_max grid); zeros anywhere in a row, M % 4 != 0
LT_SHAPES = [(6, 5, 20, 64, 0.4), (9, 3, 11, 129, 0.5), (1, 1, 3, 7, 0.0), (4, 7, 30, 1030, 0.3)]


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


@pytest.mark.parametrize("r,m,b", MATVEC_SHAPES)
def test_plain_coded_matvec_matches_pallas(r, m, b):
    rng = np.random.default_rng(r * 10 + m + b)
    a = rng.standard_normal((r, m)).astype(np.float32)
    x = rng.standard_normal((m, b)).astype(np.float32)
    got = ops.coded_matvec(torch.as_tensor(a), torch.as_tensor(x)).numpy()
    want = np.asarray(coded_matvec_pallas(jnp.asarray(a), jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()))


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


def _lt_table(q, d_max, r, zero_frac, seed):
    """A degree table with zeros anywhere in a row (and a degree-0 row when
    q > 1), non-unit coefficients and repeated source rows."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, r, (q, d_max)).astype(np.int32)
    cof = rng.standard_normal((q, d_max)).astype(np.float32)
    cof[rng.random((q, d_max)) < zero_frac] = 0.0
    if q > 1:
        cof[q // 2] = 0.0
    return idx, cof


@pytest.mark.parametrize("q,d_max,r,m,zero_frac", LT_SHAPES)
def test_plain_lt_encode_matches_pallas(q, d_max, r, m, zero_frac):
    idx, cof = _lt_table(q, d_max, r, zero_frac, q * 100 + m)
    a = np.random.default_rng(m).standard_normal((r, m)).astype(np.float32)
    got = ops.lt_encode(torch.as_tensor(a), torch.as_tensor(idx), torch.as_tensor(cof)).numpy()
    want = np.asarray(lt_encode_pallas(jnp.asarray(a), jnp.asarray(idx), jnp.asarray(cof),
                                       interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()))
    if q > 1:
        assert not got[q // 2].any()  # a degree-0 row is zeros


@pytest.mark.parametrize("code", ["lt", "gaussian"])
def test_encode_rows_matches_reference(code):
    """The reserve-slice encode of both plan kinds, the port's plain kernels
    against the reference's Pallas kernels (interpret mode)."""
    r, q, m = 30, 45, 33
    plan, plan_ref = ((LTCode(r, seed=2).plan(q), RefLTCode(r, seed=2).plan(q)) if code == "lt"
                      else (GaussianCode(r, seed=2).plan(q), RefGaussianCode(r, seed=2).plan(q)))
    a = np.random.default_rng(1).standard_normal((r, m))  # float64: cast to fp32, as the reference
    got = ops.encode_rows(a, plan, 31, 45, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (14, m)
    want = np.asarray(jax_encode_rows(a, plan_ref, 31, 45, mode="interpret"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # a tensor's own device is used, and an empty slice gives no rows
    assert torch.equal(ops.encode_rows(torch.as_tensor(a), plan, 31, 45), got)
    assert ops.encode_rows(a, plan, 5, 5, device="cpu").shape == (0, m)
    with pytest.raises(ValueError, match="bad plan row range"):
        ops.encode_rows(a, plan, 40, 46, device="cpu")


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
            ops.lt_encode(torch.zeros(3, 8), torch.zeros(2, 2, dtype=torch.int32),
                          torch.ones(2, 2), mode=mode)
        with pytest.raises(ValueError, match="CUDA"):
            ops.encode_rows(torch.zeros(4, 8), LTCode(4).plan(6), 4, 6, mode=mode)
    with pytest.raises(ValueError, match="CUDA"):
        coded_matvec_decode_cuda(wc, x, rec)
    with pytest.raises(ValueError, match="CUDA"):
        gaussian_encode_cuda(torch.zeros(3, 2), torch.zeros(2, 5))
    with pytest.raises(ValueError, match="CUDA"):
        lt_encode_cuda(torch.zeros(3, 2), torch.zeros(2, 2, dtype=torch.int32), torch.ones(2, 2))


def test_mode_routing():
    t = torch.zeros(2)
    assert ops.resolve_mode(None, t) == "off"        # CPU tensor: plain version
    assert ops.resolve_mode("interpret", t) == "off"
    assert ops.resolve_mode("off", t) == "off"
    assert ops.resolve_mode("auto", t) == "off"       # per-shape dispatch: plain on the CPU
    with pytest.raises(ValueError, match="unknown kernel mode"):
        ops.resolve_mode("triton", t)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch.serve.engine, repro_torch.launch.serve\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.coded_decode\n"
        "import repro_torch.kernels.lt_encode, repro_torch.kernels._build\n"
        "import repro_torch.weights, repro_torch.configs, repro_torch.core.adaptive\n"
        "import repro_torch.cluster, repro_torch.core.simulator, repro_torch.utils.prng\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
