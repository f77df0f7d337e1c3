"""Port ssm (mamba2-130m) and hybrid (zamba2-1.2b) LMs vs the JAX reference.

The SMOKE configs, with the reference's seeded params carried into the port
through numpy (``repro_torch.weights.params_from_numpy``), so both packages
compute the same function; on the CPU the port's SSD runs the kernels'
plain versions (``ssd_kernel_mode`` None on a CPU tensor).

Tolerances, of max|logit|:

  * float32 prefill logits: 1e-5, ``tests/test_torch_model.py``'s float32
    bound;
  * float32 decode logits: 1e-3.  Both packages round the conv tail a
    prefill hands to decode, and the shared block's K/V, to bf16; an fp32
    ulp between XLA's and torch's matmuls can put a cached value on the
    other side of a bf16 rounding step (2^-7 relative), and that one value
    moves the next step's logits by up to a few 1e-4.  Greedy tokens must
    still be equal;
  * bfloat16 configs: 3e-2, ``tests/test_torch_model.py``'s bf16 bound.
"""
import functools
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.adaptive import ParityController as JaxParityController
from repro.models.registry import build_model as jax_build
from repro.models.transformer import _last_logits as jax_last_logits
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.core.adaptive import ParityController
from repro_torch.launch import serve
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import _last_logits
from repro_torch.serve import Request, ServeEngine
from repro_torch.weights import params_from_numpy

ARCHS = ["mamba2-130m", "zamba2-1.2b"]
PREFILL_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DECODE_TOL = {"float32": 1e-3, "bfloat16": 3e-2}


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg):
    return jax.jit(jax_build(jcfg).init)(jax.random.key(0))


def _jax_params(jcfg):
    """The reference's seeded params for a config (jitted init; made once
    per config and only read).  The init draws every param in
    ``param_dtype`` whatever the activation dtype, so the float32 and
    bfloat16 configs share one set."""
    return _jax_init(jcfg.scaled(dtype="float32"))


def _pair(arch, dtype):
    """Reference and port configs, models and params, coded head (14, 2)."""
    jcfg = jax_config(arch, smoke=True).scaled(dtype=dtype, coded=True, coded_parity=2)
    tcfg = get_config(arch, smoke=True).scaled(dtype=dtype, coded=True, coded_parity=2)
    assert jcfg.__dict__ == tcfg.__dict__
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jp = _jax_params(jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jm, tm, jp, tp


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _leaves(tree):
    """(path, leaf) pairs of a cache, dicts by sorted key (jax's order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, leaf in _leaves(tree[k]):
                yield (k,) + path, leaf
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            for path, leaf in _leaves(v):
                yield (i,) + path, leaf
    else:
        yield (), tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_reference(arch, dtype):
    """A 20-token prompt (ragged against the smoke chunk of 16: padded to
    32, two chunks) then three decode steps."""
    jcfg, tcfg, jm, tm, jp, tp = _pair(arch, dtype)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 20)).astype(np.int32)
    jl, jcache = jax.jit(jm.prefill, static_argnames="s_max")(
        jp, {"tokens": jnp.asarray(toks)}, s_max=26)
    tl, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long)}, s_max=26)
    assert tl.shape == (2, jcfg.vocab) and tl.dtype == torch.float32
    _close(tl, jl, PREFILL_TOL[dtype])
    jl_leaves, tl_leaves = list(_leaves(jcache)), list(_leaves(tcache))
    assert [p for p, _ in tl_leaves] == [p for p, _ in jl_leaves]
    for (path, j), (_, t) in zip(jl_leaves, tl_leaves):
        assert tuple(t.shape) == j.shape and str(t.dtype).split(".")[-1] == str(j.dtype), path
        if path[-1] == "ssm":
            _close(t, j, 1e-4 if dtype == "float32" else 3e-2)
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    j_decode = jax.jit(jm.decode_step)
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab, 2).astype(np.int32)
        jl, jcache = j_decode(jp, jcache, jnp.asarray(nxt))
        tl, tcache = tm.decode_step(tp, tcache, torch.as_tensor(nxt, dtype=torch.long))
        _close(tl, jl, DECODE_TOL[dtype])
        if dtype == "float32":
            assert np.array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_coded_head_under_every_erasure_equals_uncoded_head(arch):
    """Every mask with <= coded_parity erasures yields the uncoded logits
    (mamba2's head is the tied embedding)."""
    jcfg, tcfg, _, _, jp, tp = _pair(arch, "float32")
    head = tp["lm_head"] if "lm_head" in tp else tp["embed"].T
    assert ("lm_head" in tp) != tcfg.tie_embeddings
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    uncoded = hidden[:, -1] @ head.numpy()
    worst = 0.0
    for e in range(tcfg.coded_parity + 1):
        for pat in itertools.combinations(range(16), e):
            m = np.ones(16, np.float32)
            m[list(pat)] = 0.0
            got = _last_logits(tp, torch.as_tensor(hidden), tcfg, torch.as_tensor(m)).numpy()
            worst = max(worst, np.abs(got - uncoded).max() / np.abs(uncoded).max())
    assert worst < 1e-3
    m = np.ones(16, np.float32)
    m[[4, 15]] = 0.0
    want = jax_last_logits(jp, jnp.asarray(hidden), jcfg, jnp.asarray(m))
    _close(_last_logits(tp, torch.as_tensor(hidden), tcfg, torch.as_tensor(m)), want, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,bound", [("bfloat16", 0.05), ("float32", 1e-2)])
def test_prefill_then_decode_equals_full_forward(arch, dtype, bound):
    """Prefill of S tokens + one decode step == the prefill of S + 1 tokens
    at its last position: the reference's contract (tests/test_models.py),
    at its 0.05 for the default bf16 activations.  In float32, 1e-2: the
    decode conv cache is bf16, so the step sees the last W-1 conv inputs
    rounded by up to 2^-9 where the forward sees them in fp32.  A contract
    of the port's own model, so on the port's own seeded init."""
    tcfg = get_config(arch, smoke=True).scaled(dtype=dtype)
    tm = build_model(tcfg)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    seq = 8
    toks = (torch.arange(2 * (seq + 1)).reshape(2, seq + 1) * 7) % tcfg.vocab
    ref, _ = tm.prefill(tp, {"tokens": toks})
    _, cache = tm.prefill(tp, {"tokens": toks[:, :seq]}, s_max=seq + 4)
    got, _ = tm.decode_step(tp, cache, toks[:, seq])
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err < bound, f"{arch}: decode diverges from forward ({err:.4f})"


def _drive(eng, request_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        eng.submit(request_cls(uid=i, prompt=p, max_new_tokens=max_new[i % len(max_new)]))
    done = eng.run()
    return {r.uid: list(r.out_tokens) for r in done}, [r.uid for r in done]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_and_parity_raise_equal_reference(arch):
    """Same params, prompts and three persistent stragglers into both
    engines: equal tokens, host syncs and parity events through the (14, 2)
    -> (13, 3) raise.  The prompts include one over the smoke chunk (20),
    one shorter (5) and a 2-token prompt, whose conv tail has fewer than
    W-1 rows and is zero-padded at the end by the splice in both."""
    jcfg, tcfg, jm, tm, jp, tp = _pair(arch, "float32")

    def latency_fn():
        lat = np.full(16, 1e-3)
        lat[2] = lat[7] = lat[11] = 5e-2
        return lat

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32) for n in (20, 2, 5, 20, 2)]
    kw = dict(n_slots=2, s_max=32, latency_fn=latency_fn, parity_topup=1, topup_patience=2,
              encode_mode="interpret")
    jeng = JaxServeEngine(jm, jp, parity_controller=JaxParityController(16, decay=0.5), **kw)
    teng = ServeEngine(tm, tp, parity_controller=ParityController(16, decay=0.5),
                       device="cpu", **kw)
    jout, jorder = _drive(jeng, JaxRequest, prompts, [5, 3])
    tout, torder = _drive(teng, Request, prompts, [5, 3])
    assert tout == jout and torder == jorder
    assert teng.sync_count == jeng.sync_count and teng.tokens_emitted == jeng.tokens_emitted
    assert teng.parity_events == jeng.parity_events
    assert len(teng.parity_events) == 1 and teng.parity_events[0]["n_parity"] == 3


def test_splice_pads_a_short_conv_tail_at_the_end():
    """The reference's splice zero-pads a conv tail shorter than W-1 rows at
    its END (not its start): the port reproduces that layout."""
    _, tcfg, _, tm, _, tp = _pair("mamba2-130m", "float32")
    eng = ServeEngine(tm, tp, n_slots=2, s_max=16, device="cpu")
    eng.submit(Request(uid=0, prompt=np.array([3, 4]), max_new_tokens=4))
    eng._refill()
    conv = eng.cache["blocks"]["mamba"]["conv"]          # [L, slots, W-1, C]
    assert conv.shape[2] == tcfg.conv_width - 1 == 3
    _, one = tm.prefill(eng.params, {"tokens": torch.as_tensor([[3, 4]])})
    tail = one["blocks"]["mamba"]["conv"][:, 0]         # [L, 2, C]
    assert torch.equal(conv[:, 0, :2], tail.to(conv.dtype))
    assert not conv[:, 0, 2].any() and not conv[:, 1].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_cache_match_reference_layout(arch):
    cfg = get_config(arch, smoke=True).scaled(coded=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    ref = jax.eval_shape(lambda: jax_build(cfg).init(jax.random.key(0)))
    assert jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), ref) == jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), params)
    ref_cache = jax.eval_shape(lambda: jax_build(cfg).init_cache(3, 10))
    cache = model.init_cache(3, 10, device="cpu")
    assert jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), ref_cache) == jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), cache)
    # the cast once gives the per-use bits; norms and per-head params stay fp32
    prepared = model.prepare(params)
    toks = torch.as_tensor(np.arange(5)[None] % cfg.vocab)
    assert torch.equal(model.prefill(params, {"tokens": toks})[0],
                       model.prefill(prepared, {"tokens": toks})[0])
    blk = prepared["blocks"] if cfg.family == "ssm" else prepared["blocks"][0]
    assert blk["mamba"]["in_proj"].dtype == torch.bfloat16
    assert blk["mamba"]["gate_norm"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_runs_on_cpu(arch, capsys):
    """The launcher's ``main`` with the arguments a user would pass to
    ``python -m repro_torch.launch.serve``."""
    serve.main(["--arch", arch, "--smoke", "--coded", "--device", "cpu", "--requests", "3",
                "--max-new", "3", "--prompt-len", "20", "--straggler-prob", "0.3"])
    assert "[serve] 3 requests, 9 tokens" in capsys.readouterr().out
