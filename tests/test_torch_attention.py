"""The port's attention against the JAX reference's, on the same numpy inputs.

``_sdpa_chunked`` (the online-softmax SDPA from 8192 tokens on) is held to
the reference's at its own test's 2e-5 (``tests/test_models.py``): causal,
cross shapes, and the fallback to the dense ``_sdpa`` when a length is no
multiple of its chunk.  ``attention_full`` at 8192 tokens must go through
it, within 2e-5 of max|reference| (its projections grow the values to ~10).  Padded heads (``_mask_pad_heads``, a ``pad_heads = 2`` smoke model)
and the cross-attention functions, with a non-zero tanh gate (at init the
gate is tanh(0) = 0 and would hide the cross-attention), are held to the
reference at 1e-5 (float32).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models.layers import dense_init as jax_dense_init
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models.registry import build_model
from repro_torch.weights import params_from_numpy

TOL = 2e-5    # the reference's chunked-attention test
F32 = 1e-5    # float32 functions, of max|reference|
GATE = 0.5    # the cross-attention gate under test: tanh(0.5) = 0.46


def _qkv(rng, b, sq, sk, h, kvh, hd):
    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return draw(b, sq, h, hd), draw(b, sk, kvh, hd), draw(b, sk, kvh, hd)


def _both(fn_j, fn_t, *arrays, **kw):
    want = np.asarray(fn_j(*map(jnp.asarray, arrays), **kw))
    got = fn_t(*map(torch.as_tensor, arrays), **kw).numpy()
    return got, want


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_chunked_matches_reference(causal):
    q, k, v = _qkv(np.random.default_rng(5), 2, 64, 64, 4, 2, 16)
    got, want = _both(jattn._sdpa_chunked, tattn._sdpa_chunked, q, k, v, causal=causal,
                      q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    mask = tattn._causal_mask5(64, 64, "cpu") if causal else None
    dense = tattn._sdpa(*map(torch.as_tensor, (q, k, v)), mask).numpy()
    np.testing.assert_allclose(got, dense, rtol=TOL, atol=TOL)


def test_sdpa_chunked_cross_shape_matches_reference():
    q, k, v = _qkv(np.random.default_rng(6), 2, 64, 32, 4, 2, 16)
    got, want = _both(jattn._sdpa_chunked, tattn._sdpa_chunked, q, k, v, causal=False,
                      q_chunk=16, kv_chunk=8)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sq,sk,causal", [(20, 20, True), (20, 64, False), (64, 40, False)])
def test_sdpa_chunked_falls_back_to_dense_on_non_multiple(sq, sk, causal):
    """A length that is no multiple of its chunk runs the dense ``_sdpa``,
    as the reference's does (``repro/models/attention.py:62-63``)."""
    q, k, v = _qkv(np.random.default_rng(7), 1, sq, sk, 4, 2, 8)
    got, want = _both(jattn._sdpa_chunked, tattn._sdpa_chunked, q, k, v, causal=causal,
                      q_chunk=16, kv_chunk=16)
    mask = tattn._causal_mask5(sq, sk, "cpu") if causal else None
    assert np.array_equal(got, tattn._sdpa(*map(torch.as_tensor, (q, k, v)), mask).numpy())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_attention_full_serves_8192_tokens_through_the_chunked_sdpa(monkeypatch):
    """At the threshold the port runs ``_sdpa_chunked`` (no refusal) and
    agrees with the reference's ``attention_full`` on fp32 inputs."""
    rng = np.random.default_rng(8)
    s, d, h, kvh, hd = tattn.CHUNKED_ATTN_THRESHOLD, 16, 2, 1, 8
    keys = jax.random.split(jax.random.key(3), 4)
    p = {"w_q": jax_dense_init(keys[0], (d, h, hd), jnp.float32),
         "w_k": jax_dense_init(keys[1], (d, kvh, hd), jnp.float32),
         "w_v": jax_dense_init(keys[2], (d, kvh, hd), jnp.float32),
         "w_o": jax_dense_init(keys[3], (h, hd, d), jnp.float32, fan_in=h * hd)}
    x = rng.standard_normal((1, s, d)).astype(np.float32)
    want = np.asarray(jattn.attention_full(p, jnp.asarray(x), jnp.arange(s)[None], 1e4))
    calls = []
    real = tattn._sdpa_chunked
    monkeypatch.setattr(tattn, "_sdpa_chunked", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tp = params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    got = tattn.attention_full(tp, torch.as_tensor(x), torch.arange(s)[None], 1e4).numpy()
    assert calls == [1]
    # the projections around the SDPA grow the values to ~10: 2e-5 of max|ref|
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("n_real", [None, 2, 3, 6])
def test_mask_pad_heads_matches_reference(n_real):
    out = np.random.default_rng(9).standard_normal((2, 3, 6, 4)).astype(np.float32)
    want = np.asarray(jattn._mask_pad_heads(jnp.asarray(out), n_real))
    got = tattn._mask_pad_heads(torch.as_tensor(out), n_real).numpy()
    assert np.array_equal(got, want)


def test_pad_heads_model_matches_reference_and_ignores_its_pad_heads():
    """A glm4-9b smoke model with 2 padding heads: prefill and decode logits
    equal the reference's, and the padding heads' weights do not matter."""
    cfg = jax_config("glm4-9b", smoke=True).scaled(dtype="float32", pad_heads=2)
    tcfg = get_config("glm4-9b", smoke=True).scaled(dtype="float32", pad_heads=2)
    jm, tm = jax_build(cfg), build_model(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["blocks"]["attn_0"]["w_q"].shape[2] == cfg.n_heads + 2
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    tt = torch.as_tensor(toks, dtype=torch.long)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_max=9)
    tl, tc = tm.prefill(tp, {"tokens": tt}, s_max=9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=F32 * np.abs(np.asarray(jl)).max())
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(toks[:, 0]))
    tl, _ = tm.decode_step(tp, tc, tt[:, 0])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=F32 * np.abs(np.asarray(jl)).max())
    # other weights in the padding heads: the same bits
    moved = {**tp, "blocks": {**tp["blocks"], "attn_0": dict(tp["blocks"]["attn_0"])}}
    for name, axis in (("w_q", 2), ("w_o", 1)):
        w = moved["blocks"]["attn_0"][name].clone()
        w.narrow(axis, cfg.n_heads, 2).normal_(generator=torch.Generator().manual_seed(2))
        moved["blocks"]["attn_0"][name] = w
    again, _ = tm.prefill(moved, {"tokens": tt}, s_max=9)
    first, _ = tm.prefill(tp, {"tokens": tt}, s_max=9)
    assert torch.equal(again, first)


def _cross_params(d, h, kvh, hd, gated):
    p = jattn.init_cross_attn(jax.random.key(4), d, h, kvh, hd, jnp.float32, gated=gated)
    if gated:
        assert float(p["gate"]) == 0.0  # tanh(0) = 0 at init: set it non-zero
        p["gate"] = jnp.asarray(GATE, jnp.float32)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("gated", [True, False])
def test_cross_attention_functions_match_reference(gated):
    d, h, kvh, hd = 16, 4, 2, 8
    jp, tp = _cross_params(d, h, kvh, hd, gated)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    mem = rng.standard_normal((2, 7, d)).astype(np.float32)
    want = np.asarray(jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(mem)))
    got = tattn.cross_attention(tp, torch.as_tensor(x), torch.as_tensor(mem)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32 * np.abs(want).max())
    assert np.abs(want).max() > 0.1
    jk, jv = jattn.precompute_cross_kv(jp, jnp.asarray(mem))
    tk, tv = tattn.precompute_cross_kv(tp, torch.as_tensor(mem))
    for a, b in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=F32 * np.abs(np.asarray(b)).max())
    x1 = x[:, :1]
    want = np.asarray(jattn.cross_attention_cached(jp, jnp.asarray(x1), jk, jv))
    got = tattn.cross_attention_cached(tp, torch.as_tensor(x1), tk, tv).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32 * np.abs(want).max())
    # the cached path is the full one at one query
    full = tattn.cross_attention(tp, torch.as_tensor(x1), torch.as_tensor(mem)).numpy()
    np.testing.assert_allclose(got, full, rtol=0, atol=F32 * np.abs(full).max())
