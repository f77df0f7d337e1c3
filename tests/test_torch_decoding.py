"""Port decode path vs the JAX reference: generator, DecoderCache, masks,
decoders and the ParityController, on the same numpy inputs."""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import coded_ops as jco
from repro.core import decoding as jdec
from repro_torch.core import adaptive as tad
from repro_torch.core import coded_ops as tco
from repro_torch.core import decoding as tdec

# (n_data, n_parity): the serving head, its (13, 3) re-split, a small code
GEOMETRIES = [(14, 2), (13, 3), (4, 2)]


def _codeword(n_data, n_parity, shape, seed):
    """Coded blocks of random data [n_blocks, *shape] (float32) and the data."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n_data,) + shape).astype(np.float32)
    b = jco.block_mds_generator_np(n_data + n_parity, n_data).astype(np.float32)
    return np.einsum("bd,d...->b...", b, data).astype(np.float32), data, rng


def _with_garbage(y, m, rng):
    """Erased blocks hold garbage: the decode must never read them."""
    y = y.copy()
    y[m == 0.0] = rng.standard_normal(y[m == 0.0].shape) * 1e3
    return y


def _masks_upto(n_blocks, n_parity):
    for e in range(n_parity + 1):
        for pat in itertools.combinations(range(n_blocks), e):
            m = np.ones(n_blocks, np.float32)
            m[list(pat)] = 0.0
            yield m


@pytest.mark.parametrize("n_blocks,n_data", [(16, 14), (16, 13), (6, 4), (8, 8), (21, 19)])
def test_block_mds_generator_bit_equal(n_blocks, n_data):
    got = tco.block_mds_generator_np(n_blocks, n_data)
    want = jco.block_mds_generator_np(n_blocks, n_data)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_data,n_parity", GEOMETRIES)
def test_decoder_cache_tables_bit_equal(n_data, n_parity):
    got = tdec.DecoderCache(n_data, n_parity)
    want = jdec.DecoderCache(n_data, n_parity)
    assert got.table.dtype == want.table.dtype == np.float32
    assert np.array_equal(got.table, want.table)
    assert np.array_equal(got.lut, want.lut)
    assert got.table.shape[0] == tdec.decodable_patterns(n_data + n_parity, n_parity)
    assert tdec.cacheable(n_data, n_parity) == jdec.cacheable(n_data, n_parity)
    # the lut default (undecodable masks) is the full-mask row 0
    assert got.lut[(1 << (n_data + n_parity)) - 1] == 0


@pytest.mark.parametrize("n_data,n_parity", GEOMETRIES)
def test_recovery_gather_equals_reference_over_every_mask(n_data, n_parity):
    got_cache = tdec.get_decoder_cache(n_data, n_parity)
    want_cache = jdec.get_decoder_cache(n_data, n_parity)
    for m in _masks_upto(n_data + n_parity, n_parity):
        got = got_cache.recovery(torch.as_tensor(m))
        assert got.shape == (n_data, n_data + n_parity)
        assert np.array_equal(got.numpy(), np.asarray(want_cache.recovery(jnp.asarray(m))))
    too_many = np.ones(n_data + n_parity, np.float32)
    too_many[: n_parity + 1] = 0.0
    assert int(got_cache.index(torch.as_tensor(too_many))[0]) == 0


def test_first_decodable_mask_equal():
    rng = np.random.default_rng(3)
    for trial in range(50):
        n_data, n_parity = GEOMETRIES[trial % len(GEOMETRIES)]
        lat = rng.exponential(1.0, n_data + n_parity)
        lat[rng.random(lat.shape) < 0.15] = np.inf
        if trial % 7 == 0:
            lat[:] = 1.0  # ties: stable index order
        got = tdec.first_decodable_mask(lat, n_data, n_parity)
        want = jdec.first_decodable_mask(lat, n_data, n_parity)
        assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        tdec.first_decodable_mask(np.ones(5), 4, 2)


@pytest.mark.parametrize("n_data,n_parity", [(14, 2), (13, 3), (6, 2)])
def test_decode_blocks_matches_reference_over_every_mask(n_data, n_parity):
    nb = n_data + n_parity
    y0, data, rng = _codeword(n_data, n_parity, (5, 3), n_data)
    for m in _masks_upto(nb, n_parity):
        y = _with_garbage(y0, m, rng)
        got = tco.decode_blocks(torch.as_tensor(y), torch.as_tensor(m), n_data, n_parity)
        want = np.asarray(jco.decode_blocks(jnp.asarray(y), jnp.asarray(m), n_data, n_parity))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
        np.testing.assert_allclose(got.numpy(), data, atol=1e-3)


@pytest.mark.parametrize("n_data,n_parity", [(14, 2), (6, 2)])
def test_decode_blocks_svd_matches_reference_over_every_mask(n_data, n_parity):
    nb = n_data + n_parity
    y0, data, rng = _codeword(n_data, n_parity, (4, 2), n_data + 1)
    for m in _masks_upto(nb, n_parity):
        y = _with_garbage(y0, m, rng)
        got = tco.decode_blocks_svd(torch.as_tensor(y), torch.as_tensor(m), n_data, n_parity)
        want = np.asarray(jco.decode_blocks_svd(jnp.asarray(y), jnp.asarray(m), n_data, n_parity))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
        # and the cached decode agrees with the SVD decode (the reference's oracle)
        cached = tco.decode_blocks(torch.as_tensor(y), torch.as_tensor(m), n_data, n_parity)
        np.testing.assert_allclose(cached.numpy(), got.numpy(), atol=2e-4)


def test_wide_code_falls_back_to_svd_and_recovers():
    n_data, n_parity = tdec.MAX_LUT_BLOCKS - 1, 2
    with pytest.raises(ValueError):
        tdec.DecoderCache(n_data, n_parity)
    rng = np.random.default_rng(1)
    y_true = rng.standard_normal((n_data, 4, 2)).astype(np.float32)
    b = tco.block_mds_generator(n_data + n_parity, n_data)
    y_coded = torch.einsum("bd,dre->bre", b, torch.as_tensor(y_true))
    m = np.ones(n_data + n_parity, np.float32)
    m[[2, 17]] = 0.0
    out = tco.decode_blocks(y_coded, torch.as_tensor(m), n_data, n_parity)
    np.testing.assert_allclose(out.numpy(), y_true, atol=1e-3)


@pytest.mark.parametrize("kernel_mode", [None, "off", "interpret", "svd"])
def test_coded_linear_apply_matches_reference(kernel_mode):
    cl_t = tco.CodedLinear(n_data=6, n_parity=2, out_features=100)
    cl_j = jco.CodedLinear(n_data=6, n_parity=2, out_features=100)
    rng = np.random.default_rng(5)
    w = rng.standard_normal((100, 40)).astype(np.float32)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    wc_t = cl_t.encode(torch.as_tensor(w))
    wc_j = cl_j.encode(jnp.asarray(w))
    np.testing.assert_array_equal(wc_t.numpy(), np.asarray(wc_j))
    ref = w @ x
    for m in _masks_upto(8, 2):
        got = cl_t.apply(wc_t, torch.as_tensor(x), torch.as_tensor(m), kernel_mode=kernel_mode)
        want = np.asarray(cl_j.apply(wc_j, jnp.asarray(x), jnp.asarray(m),
                                     kernel_mode=kernel_mode))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(ref).max())
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize("n_data,n_parity", [(10, 6), (19, 3)])
def test_coded_linear_apply_uncacheable_geometry_matches_reference(n_data, n_parity):
    """Geometries the DecoderCache refuses (too many patterns, too many
    blocks) decode through the pinv recovery matrix; the reference takes
    its SVD fallback.  A kernel mode on CPU tensors raises, never falls back."""
    nb = n_data + n_parity
    assert not tdec.cacheable(n_data, n_parity)
    cl_t = tco.CodedLinear(n_data=n_data, n_parity=n_parity, out_features=90)
    cl_j = jco.CodedLinear(n_data=n_data, n_parity=n_parity, out_features=90)
    rng = np.random.default_rng(nb)
    w = rng.standard_normal((90, 24)).astype(np.float32)
    x = rng.standard_normal((24, 2)).astype(np.float32)
    wc_t, wc_j = cl_t.encode(torch.as_tensor(w)), cl_j.encode(jnp.asarray(w))
    ref = w @ x
    for trial in range(6):
        m = np.ones(nb, np.float32)
        m[rng.choice(nb, size=trial % (n_parity + 1), replace=False)] = 0.0
        got = cl_t.apply(wc_t, torch.as_tensor(x), torch.as_tensor(m))
        want = np.asarray(cl_j.apply(wc_j, jnp.asarray(x), jnp.asarray(m)))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(ref).max())
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-3 * np.abs(ref).max())
        rec = tco.svd_recovery(torch.as_tensor(m), n_data, n_parity)
        assert not rec[:, m == 0.0].any()
    with pytest.raises(ValueError, match="CUDA"):
        cl_t.apply(wc_t, torch.as_tensor(x), torch.ones(nb), kernel_mode="cuda")


def test_decoder_cache_memo_and_stats():
    cache = tdec.get_decoder_cache(9, 3)
    stats0 = tdec.decoder_cache_stats()
    calls0 = cache.recovery_calls
    for _ in range(3):
        assert tdec.get_decoder_cache(9, 3) is cache
        cache.recovery(torch.ones(12))
    stats = tdec.decoder_cache_stats()
    assert stats["hits"] - stats0["hits"] == 3 and stats["misses"] == stats0["misses"]
    assert cache.recovery_calls - calls0 == 3


def test_parity_controller_trajectories_equal():
    rng = np.random.default_rng(11)
    for decay, threshold in [(0.7, 2.0), (0.5, 3.0)]:
        got = tad.ParityController(16, decay=decay, threshold=threshold)
        want = jad.ParityController(16, decay=decay, threshold=threshold)
        for step in range(60):
            lat = 1e-3 * (1.0 + 0.1 * rng.random(16))
            lat[rng.random(16) < 0.2] *= 50.0
            if step > 20:
                lat[[2, 7, 11]] = 5e-2        # persistent stragglers
            if step % 9 == 0:
                lat[5] = np.inf               # a dead shard
            got.observe(lat)
            want.observe(lat)
            assert np.array_equal(got.posterior, want.posterior)
            for budget in (0, 2, 3, 4):
                assert got.parity_level(budget) == want.parity_level(budget)
        block = rng.exponential(1e-3, (5, 16))
        got.observe_block(block)
        want.observe_block(block)
        assert np.array_equal(got.posterior, want.posterior)
    with pytest.raises(ValueError):
        tad.ParityController(16, decay=1.0)
