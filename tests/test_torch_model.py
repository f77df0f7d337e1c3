"""Port dense LM vs the JAX reference on carried params (SMOKE configs).

The reference's params are carried into the port through numpy
(``repro_torch.weights.params_from_numpy``), so both packages compute the
same function.  Tolerances: float32 configs match to 1e-5 of max|logit| with
equal greedy tokens; bfloat16 configs (the configs' default activations)
round at the same places but in other kernels, so their logits are held to
3e-2 of max|logit|.
"""
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro.models.transformer import _last_logits as jax_last_logits
from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import _last_logits
from repro_torch.weights import params_from_numpy

ARCHS = ["glm4-9b", "phi3-mini-3.8b"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _pair(arch, dtype, coded):
    jcfg = jax_config(arch, smoke=True).scaled(dtype=dtype, coded=coded)
    tcfg = get_config(arch, smoke=True).scaled(dtype=dtype, coded=coded)
    assert jcfg == tcfg or jcfg.__dict__ == tcfg.__dict__
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jm, tm, jp, tp


def _close(got, want, dtype):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * np.abs(want).max())


def test_configs_copied_letter_for_letter():
    from repro_torch.configs import ARCHS as PORTED

    assert set(PORTED) == set(ARCHS) | {"mamba2-130m", "zamba2-1.2b"}
    for arch in PORTED:
        for smoke in (False, True):
            assert get_config(arch, smoke).__dict__ == jax_config(arch, smoke).__dict__


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("coded", [False, True])
def test_prefill_and_decode_logits_match_reference(arch, dtype, coded):
    jcfg, tcfg, jm, tm, jp, tp = _pair(arch, dtype, coded)
    if coded:
        np.testing.assert_array_equal(tp["lm_head_coded"].numpy(),
                                      np.asarray(jp["lm_head_coded"]))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 7)).astype(np.int32)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_max=12)
    tl, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long)}, s_max=12)
    assert tl.shape == (2, jcfg.vocab) and tl.dtype == torch.float32
    _close(tl.numpy(), jl, dtype)
    for name in ("k", "v"):
        got = tcache["blocks"]["attn_0"][name]
        assert got.dtype == torch.bfloat16 and got.shape == jcache["blocks"]["attn_0"][name].shape
        _close(got.float().numpy(),
               np.asarray(jcache["blocks"]["attn_0"][name], np.float32), dtype)
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    for step in range(3):
        nxt = rng.integers(0, jcfg.vocab, 2).astype(np.int32)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt))
        tl, tcache = tm.decode_step(tp, tcache, torch.as_tensor(nxt, dtype=torch.long))
        _close(tl.numpy(), jl, dtype)
        if dtype == "float32":
            assert np.array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_cast_weights_once_gives_the_per_use_bits():
    _, tcfg, _, tm, _, tp = _pair("glm4-9b", "bfloat16", True)
    toks = torch.as_tensor(np.arange(5)[None] % tcfg.vocab)
    a, _ = tm.prefill(tp, {"tokens": toks})
    b, _ = tm.prefill(tm.prepare(tp), {"tokens": toks})
    assert tm.prepare(tp)["blocks"]["attn_0"]["w_q"].dtype == torch.bfloat16
    assert tm.prepare(tp)["lm_head"].dtype == torch.float32
    assert torch.equal(a, b)


def test_decode_past_cache_capacity_writes_nothing():
    """A slot whose position ran past s_max (an idle engine slot) leaves the
    cache untouched, as the reference's one-hot write does."""
    jcfg, tcfg, jm, tm, jp, tp = _pair("glm4-9b", "float32", False)
    toks = np.array([[3, 4, 5]], np.int32)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_max=3)
    tl, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long)}, s_max=3)
    k_before = tcache["blocks"]["attn_0"]["k"].clone()
    jl, jcache = jm.decode_step(jp, jcache, jnp.asarray([7], jnp.int32))
    tl, tcache = tm.decode_step(tp, tcache, torch.as_tensor([7]))
    assert torch.equal(tcache["blocks"]["attn_0"]["k"], k_before)
    _close(tl.numpy(), jl, "float32")


def test_aligned_decode_write_matches_reference():
    """``aligned_decode``: one cache slice written at the shared position."""
    jcfg, tcfg, jm, tm, jp, tp = _pair("phi3-mini-3.8b", "float32", False)
    jcfg, tcfg = jcfg.scaled(aligned_decode=True), tcfg.scaled(aligned_decode=True)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (3, 5)).astype(np.int32)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_max=7)
    tl, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long)}, s_max=7)
    for step in range(4):  # the last step runs past s_max: the write clamps
        nxt = toks[:, step]
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt))
        tl, tcache = tm.decode_step(tp, tcache, torch.as_tensor(nxt, dtype=torch.long))
        _close(tl.numpy(), jl, "float32")
        _close(tcache["blocks"]["attn_0"]["k"].float().numpy(),
               np.asarray(jcache["blocks"]["attn_0"]["k"], np.float32), "float32")


@pytest.mark.parametrize("kernel_mode", [None, "off", "svd"])
def test_coded_head_under_every_erasure_equals_uncoded_head(kernel_mode):
    """Every mask with <= coded_parity erasures yields the uncoded logits."""
    jcfg, tcfg, _, _, jp, tp = _pair("glm4-9b", "float32", True)
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    uncoded = hidden[:, -1] @ tp["lm_head"].numpy()
    scale = np.abs(uncoded).max()
    n_blocks = 16
    worst = 0.0
    for e in range(tcfg.coded_parity + 1):
        for pat in itertools.combinations(range(n_blocks), e):
            m = np.ones(n_blocks, np.float32)
            m[list(pat)] = 0.0
            got = _last_logits(tp, torch.as_tensor(hidden), tcfg, torch.as_tensor(m),
                               kernel_mode).numpy()
            worst = max(worst, np.abs(got - uncoded).max() / scale)
    assert worst < 1e-3
    # one mask against the reference's own coded head
    m = np.ones(n_blocks, np.float32)
    m[[3, 9]] = 0.0
    want = np.asarray(jax_last_logits(jp, jnp.asarray(hidden), jcfg, jnp.asarray(m)))
    got = _last_logits(tp, torch.as_tensor(hidden), tcfg, torch.as_tensor(m), kernel_mode)
    _close(got.numpy(), want, "float32")


def test_init_matches_reference_layout():
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True).scaled(coded=True)
        params = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
        ref = jax.eval_shape(lambda: jax_build(cfg).init(jax.random.key(0)))
        ref_shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), ref)
        got_shapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                                  params)
        assert got_shapes == ref_shapes
        w = params["blocks"]["attn_0"]["w_q"]
        std = 1.0 / np.sqrt(cfg.d_model)
        assert float(w.abs().max()) <= 2.0 * std + 1e-6  # truncated at 2 sigma
        assert 0.5 * std < float(w.std()) < 1.2 * std


def test_entry_points_need_a_named_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour; this machine has a GPU")
    model = build_model(get_config("glm4-9b", smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(2, 8)
    with pytest.raises(NotImplementedError):
        build_model(jax_config("dbrx-132b", smoke=True))
