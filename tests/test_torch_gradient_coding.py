"""Port gradient coding (``repro_torch.core.gradient_coding``) vs the JAX reference.

* ``frc_code`` and ``cyclic_code`` are numpy copies: ``B`` bit-equal.
* FRC decode (closed form): weights and ``ok`` equal on every mask.
* CRC decode (pinv + two refinements, fp32 on both sides, through different
  SVD routines): ``ok`` equal on every mask, ``v`` within 1e-4.
* The reference's own contracts, mirrored inside the port: over every mask
  ``ok`` is the ground-truth recoverability, and ok masks decode the exact
  gradient sum; ``ok`` is a 0-dim bool tensor on the mask's device.
"""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import gradient_coding as ref
from repro_torch.core import GradCode, cyclic_code, decode_weights, frc_code
from repro_torch.core.gradient_coding import decode_weights_checked


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster, and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CODES = [("frc", 4, 1), ("frc", 6, 2), ("frc", 6, 0), ("frc", 6, 1), ("frc", 8, 3),
         ("cyclic", 4, 1), ("cyclic", 5, 1), ("cyclic", 6, 2), ("cyclic", 6, 0),
         ("cyclic", 8, 3), ("cyclic", 7, 2)]


def _codes(kind, n, s):
    if kind == "frc":
        return ref.frc_code(n, s), frc_code(n, s)
    return ref.cyclic_code(n, s), cyclic_code(n, s)


def _masks(n):
    return [np.asarray(bits, np.float32) for bits in itertools.product([0.0, 1.0], repeat=n)]


def _ground_truth_ok(code, mask: np.ndarray) -> bool:
    if code.kind == "frc":
        return bool((mask.reshape(-1, code.s + 1).sum(axis=1) >= 1).all())
    return bool(mask.sum() >= code.n_workers - code.s)


@pytest.mark.parametrize("kind,n,s", CODES)
def test_codes_bit_equal(kind, n, s):
    jc, tc = _codes(kind, n, s)
    assert isinstance(tc, GradCode)
    assert tc.kind == jc.kind and tc.s == jc.s
    assert tc.b.dtype == jc.b.dtype and np.array_equal(tc.b, jc.b)
    assert tc.replication == jc.replication
    for w in range(n):
        assert np.array_equal(tc.shards_of(w), jc.shards_of(w))


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_cyclic_code_seeds_bit_equal(seed):
    assert np.array_equal(cyclic_code(6, 2, seed=seed).b, ref.cyclic_code(6, 2, seed=seed).b)


def test_frc_needs_divisible_groups():
    with pytest.raises(ValueError):
        frc_code(5, 1)


@pytest.mark.parametrize("n,s", [(4, 1), (6, 2)])
def test_frc_decode_equal_on_every_mask(n, s):
    jc, tc = _codes("frc", n, s)
    for mask in _masks(n):
        jv, jok = ref.decode_weights_checked(jc, jnp.asarray(mask))
        tv, tok = decode_weights_checked(tc, torch.as_tensor(mask))
        assert np.array_equal(tv.numpy(), np.asarray(jv)), mask
        assert bool(tok) == bool(jok), mask


@pytest.mark.parametrize("n,s,check_v", [(4, 1, True), (5, 1, True), (6, 2, True),
                                         (7, 2, False), (8, 3, False)])
def test_cyclic_decode_on_every_mask(n, s, check_v):
    """``ok`` equal on every mask; ``v`` within 1e-4 where the code's masked
    generators are well conditioned.  At (7, 2) and (8, 3) some decodable
    masks leave a generator of condition ~4e3, and two fp32 SVDs then
    differ by cond x eps ~ 2e-4 in ``v``; there the decoded sums are held
    to the exact sum instead (``test_decode_checked_flag_exhaustive``)."""
    jc, tc = _codes("cyclic", n, s)
    for mask in _masks(n):
        jv, jok = ref.decode_weights_checked(jc, jnp.asarray(mask))
        tv, tok = decode_weights_checked(tc, torch.as_tensor(mask))
        assert bool(tok) == bool(jok), mask
        if check_v:
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind,n,s", CODES)
def test_decode_checked_flag_exhaustive(kind, n, s):
    """Over every mask: ``ok`` is the ground-truth recoverability, and ok
    masks decode the exact gradient sum (the reference's own test)."""
    _, code = _codes(kind, n, s)
    g = np.random.default_rng(0).standard_normal((n, 5))
    msgs = code.b @ g
    want = g.sum(axis=0)
    for mask in _masks(n):
        v, ok = decode_weights_checked(code, torch.as_tensor(mask))
        assert ok.dtype == torch.bool and ok.dim() == 0
        assert bool(ok) == _ground_truth_ok(code, mask), mask
        if bool(ok):
            got = v.double().numpy() @ (msgs * mask[:, None])
            assert np.abs(got - want).max() / np.abs(want).max() < 5e-3


def test_decode_weights_unchecked_and_shape():
    code = frc_code(4, 1)
    v = decode_weights(code, torch.tensor([1.0, 0.0, 0.0, 1.0]))
    assert v.dtype == torch.float32 and v.shape == (4,)
    assert v.tolist() == [1.0, 0.0, 0.0, 1.0]
