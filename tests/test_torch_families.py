"""The moe, vlm and encdec families (and all ten configs) against the JAX reference.

* Every ``CONFIG`` and ``SMOKE`` of the ten configs, and ``shapes.py``,
  equal the reference's field by field; the port's seeded init has the
  reference's layout for every smoke config.
* ``Model.loss`` and ``Model.forward`` run for every family, with finite
  gradients (held to the reference in ``tests/test_torch_train_*.py``).
* Prefill + one decode step == the full forward at the next position, for
  every family (the reference's ``test_decode_matches_forward`` at its 0.05;
  the vlm's gates set non-zero, the encdec's frames seeded and non-zero).
* On float32 smoke configs, with the reference's params carried over, the
  prefill and decode logits of dbrx-132b, llama4-maverick (period 2, shared
  expert), llama-3.2-vision-11b (seeded images, gates 0.5) and
  seamless-m4t-large-v2 (seeded frames) are within 1e-5 of max|logit| of
  the reference's (the encdec decode 1e-3: its cross K/V are bf16 in the
  cache, and a bf16 rounding may flip on one fp32 ulp).
* ``ServeEngine`` greedy tokens equal the reference engine's for the same
  four configs and request mix (MoE capacity is per call, so a decode's
  drops depend on every slot's token: both engines get the same requests),
  under a seeded erasure mask on the coded head; the encdec engine serves
  zero frames and an uncoded head, as the reference's does.
* Fused blocks are bit-identical to scalar steps on the CPU for the moe and
  vlm smokes; the cross K/V of a request reach its slot (``_batch_axis``'s
  ``ck``/``cv``); the launcher refuses a vlm serve, whose requests need
  images it cannot supply (the reference's launcher crashes there).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import applicable as jax_applicable
from repro.configs import get_config as jax_config
from repro.models import ModelConfig as JaxModelConfig
from repro.models.registry import build_model as jax_build
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCHS, SHAPES, applicable, get_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import encdec_forward
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import lm_forward
from repro_torch.serve import Request, ServeEngine
from repro_torch.weights import params_from_numpy

SERVED = ["dbrx-132b", "llama4-maverick-400b-a17b", "llama-3.2-vision-11b",
          "seamless-m4t-large-v2"]
GATE = 0.5   # every vlm cross-attention gate under test (tanh(0) = 0 at init)
F32 = 1e-5


def test_all_ten_configs_equal_the_reference():
    assert set(ARCHS) == set(JAX_ARCHS) and len(ARCHS) == 10
    for arch in ARCHS:
        for smoke in (False, True):
            assert get_config(arch, smoke).__dict__ == jax_config(arch, smoke).__dict__
            assert get_config(arch, smoke).param_count() == jax_config(arch, smoke).param_count()
        for shape in SHAPES:
            assert applicable(ARCHS[arch], shape) == jax_applicable(JAX_ARCHS[arch], shape)
    assert {k: vars(w) for k, w in SHAPES.items()} == {k: vars(w) for k, w in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_init_layout_matches_reference(arch):
    cfg = get_config(arch, smoke=True).scaled(coded=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    ref = jax.eval_shape(lambda: jax_build(jax_config(arch, smoke=True).scaled(coded=True))
                         .init(jax.random.key(0)))
    ref_shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), ref)
    got_shapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), params)
    assert got_shapes == ref_shapes


# ---- decode == forward, the reference's contract, on the port ------------
FAMS = {
    "dense": dict(family="dense", n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64),
    "moe": dict(family="moe", n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, n_experts=4,
                top_k=2, capacity_factor=4.0),
    "moe_period2": dict(family="moe", n_layers=4, n_heads=4, n_kv_heads=2, d_ff=64,
                        n_experts=4, top_k=1, moe_every=2, shared_expert=True,
                        capacity_factor=4.0),
    "ssm": dict(family="ssm", n_layers=2, n_heads=0, n_kv_heads=0, d_ff=0, ssm_state=16,
                ssm_head_dim=8, ssm_chunk=8),
    "hybrid": dict(family="hybrid", n_layers=4, n_heads=4, n_kv_heads=4, d_ff=64,
                   ssm_state=16, ssm_head_dim=8, ssm_chunk=8, attn_every=2),
    "vlm": dict(family="vlm", n_layers=4, n_heads=4, n_kv_heads=2, d_ff=64,
                cross_attn_every=2, img_tokens=8),
    "encdec": dict(family="encdec", n_layers=2, n_heads=4, n_kv_heads=4, d_ff=64,
                   enc_layers=2),
    "dense_pad_heads": dict(family="dense", n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
                            pad_heads=2),
}


def _set_gates(params, value=GATE):
    for name, sub in params["blocks"].items():
        if name.startswith("xattn_"):
            sub["gate"] = (jnp.full_like(sub["gate"], value) if isinstance(sub["gate"], jax.Array)
                           else torch.full_like(sub["gate"], value))


@pytest.mark.parametrize("fam", list(FAMS))
def test_training_of_the_new_families_is_queued(fam):
    """Training of the moe, vlm and encdec families, once queued, now runs:
    ``Model.loss`` of every family gives a finite loss and finite gradients
    for every leaf on a pipeline batch (images for the vlm, frames for the
    encdec), and ``Model.forward`` takes the same inputs as keywords.  The
    values are held to the reference in ``tests/test_torch_train_*.py``."""
    from repro_torch.data import make_pipeline
    from repro_torch.utils.tree import tree_leaves

    cfg = ModelConfig(name=fam, d_model=32, vocab=64, **FAMS[fam])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "vlm":
        _set_gates(params)
    batch = {k: torch.as_tensor(v) for k, v in
             make_pipeline(cfg, seq=8, global_batch=2, seed=1).batch(0).items()}
    batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = model.loss(params, batch)
    loss.backward()
    assert bool(torch.isfinite(loss)) and float(metrics["tokens"]) == 16.0
    assert (float(metrics["aux"].detach()) > 0) == (cfg.family == "moe")
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in leaves)
    kw = {"img": batch["img_embed"]} if "img_embed" in batch else (
        {"frames": batch["frames"]} if "frames" in batch else {})
    with torch.no_grad():
        hidden = model.forward(params, batch["tokens"], **kw)
    assert tuple(hidden.shape) == (2, 8, cfg.d_model)


@pytest.mark.parametrize("fam", list(FAMS))
def test_decode_matches_forward(fam):
    """Prefill + one decode step == the full forward at the next position
    (bf16 activations, the reference's 0.05 of max|logit|)."""
    cfg = ModelConfig(name=fam, d_model=32, vocab=64, **FAMS[fam])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    b, s = 2, 8
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s + 1)))
    batch = {"tokens": toks[:, :s]}
    if cfg.family == "vlm":
        _set_gates(params)
        batch["img_embed"] = torch.as_tensor(
            rng.standard_normal((b, cfg.img_tokens, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(
            rng.standard_normal((b, s, cfg.d_model)).astype(np.float32))
        hid = encdec_forward(params, cfg, batch["frames"], toks)
    else:
        hid, aux = lm_forward(params, cfg, toks, batch.get("img_embed"))
        assert (float(aux) > 0) == (cfg.family == "moe")
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    ref = (hid[:, -1].float() @ head.float()).numpy()
    _, cache = model.prefill(params, batch, s_max=s + 4)
    lg, _ = model.decode_step(params, cache, toks[:, s])
    err = np.abs(lg.numpy() - ref).max() / max(np.abs(ref).max(), 1e-9)
    assert err < 0.05, f"{fam}: decode diverges from forward ({err:.4f})"


def test_moe_forward_aux_matches_reference():
    """``lm_forward``'s summed aux loss and hidden states (float32)."""
    cfg = JaxModelConfig(name="moe", d_model=32, vocab=64, dtype="float32",
                         **FAMS["moe_period2"])
    jp = jax_build(cfg).init(jax.random.key(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    from repro.models.transformer import lm_forward as jax_lm_forward

    toks = np.random.default_rng(3).integers(0, 64, (2, 9)).astype(np.int32)
    jh, jaux = jax_lm_forward(jp, cfg, jnp.asarray(toks))
    th, taux = lm_forward(tp, ModelConfig(**vars(cfg)), torch.as_tensor(toks, dtype=torch.long))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=F32 * np.abs(np.asarray(jh)).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=F32)


# ---- the served configs against the reference -----------------------------
def _pair(arch, coded=True):
    jcfg = jax_config(arch, smoke=True).scaled(dtype="float32", coded=coded)
    tcfg = get_config(arch, smoke=True).scaled(dtype="float32", coded=coded)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.key(0))
    if jcfg.family == "vlm":
        _set_gates(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, tm, tp


def _inputs(cfg, rng, b, s):
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["img_embed"] = rng.standard_normal((b, cfg.img_tokens, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal((b, s + 2, cfg.d_model)).astype(np.float32)
    return toks, extra


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_logits_match_reference(arch):
    jcfg, jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(1)
    toks, extra = _inputs(jcfg, rng, 2, 7)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             **{k: jnp.asarray(v) for k, v in extra.items()}}, s_max=12)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long),
                             **{k: torch.as_tensor(v) for k, v in extra.items()}}, s_max=12)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=F32 * np.abs(jl).max())
    tol = 1e-3 if jcfg.family == "encdec" else F32
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab, 2).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.as_tensor(nxt, dtype=torch.long))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=tol * np.abs(jl).max())
        assert np.array_equal(tl.numpy().argmax(-1), jl.argmax(-1))


def _mask_fn_factory(seed, p=0.3, budget=2):
    rng = np.random.default_rng(seed)

    def mask_fn():
        m = np.ones(16)
        m[np.flatnonzero(rng.random(16) < p)[:budget]] = 0.0
        return m

    return mask_fn


def _requests(cls, cfg, n, max_new, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kw = {}
        if cfg.family == "vlm":
            kw["img_embed"] = rng.standard_normal((cfg.img_tokens, cfg.d_model)).astype(
                np.float32)
        out.append(cls(uid=i, prompt=rng.integers(0, cfg.vocab, 3 + i % 4).astype(np.int32),
                       max_new_tokens=max_new[i % len(max_new)], **kw))
    return out


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: list(r.out_tokens) for r in eng.run()}


@pytest.mark.parametrize("arch", SERVED)
def test_engine_tokens_equal_reference(arch):
    jcfg, jm, jp, tm, tp = _pair(arch)
    max_new = [4, 1, 6]
    jeng = JaxServeEngine(jm, jp, n_slots=3, s_max=24, mask_fn=_mask_fn_factory(4))
    teng = ServeEngine(tm, tp, n_slots=3, s_max=24, mask_fn=_mask_fn_factory(4), device="cpu")
    jout = _serve(jeng, _requests(JaxRequest, jcfg, 5, max_new))
    tout = _serve(teng, _requests(Request, jcfg, 5, max_new))
    assert tout == jout
    assert teng.sync_count == jeng.sync_count and teng.tokens_emitted == jeng.tokens_emitted


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama-3.2-vision-11b"])
def test_fused_blocks_bit_identical_to_scalar_steps(arch):
    cfg = get_config(arch, smoke=True).scaled(dtype="float32", coded=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "vlm":
        _set_gates(params)
    runs = {}
    for k in (1, 4):
        eng = ServeEngine(model, params, n_slots=4, s_max=40, macro_steps=k,
                          mask_fn=_mask_fn_factory(5), device="cpu")
        runs[k] = (_serve(eng, _requests(Request, cfg, 4, [14], seed=3)), eng.macro_blocks)
    assert runs[4][0] == runs[1][0]
    assert runs[1][1] == 0 and runs[4][1] > 0


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "seamless-m4t-large-v2"])
def test_cross_kv_reach_the_slot(arch):
    """A prefill's cross K/V are spliced into its slot of the engine's cache,
    zero-padded to the slot's rows (the image's for the vlm; seeded frames
    for the encdec, since the engine's own zero frames give zero K/V)."""
    cfg = get_config(arch, smoke=True).scaled(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(model, params, n_slots=3, s_max=16, device="cpu")
    rng = np.random.default_rng(4)
    toks, extra = _inputs(cfg, rng, 1, 5)
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.long),
             **{k: torch.as_tensor(v) for k, v in extra.items()}}
    if cfg.family == "vlm":
        batch["img_embed"] = batch["img_embed"][:, : cfg.img_tokens - 3]  # a shorter image
    _, one = model.prefill(eng.params, batch, s_max=16)
    eng._pending_splice.append((2, one))
    eng._flush_splices()
    full = eng.cache["blocks"]["xattn_1"] if cfg.family == "vlm" else eng.cache
    one = one["blocks"]["xattn_1"] if cfg.family == "vlm" else one
    for name in ("ck", "cv"):
        got, want = full[name][:, 2], one[name][:, 0]
        n = want.shape[1]
        assert bool(want.any()) and n < got.shape[1]
        assert torch.equal(got[:, :n], want)
        assert not bool(got[:, n:].any())
        assert not bool(full[name][:, :2].any())   # other slots untouched


def test_encdec_engine_serves_zero_frames_with_an_uncoded_head():
    """The reference's encdec engine: zero frames of the prompt's length;
    ``cfg.coded`` makes no coded head and changes no token."""
    tokens = {}
    for coded in (False, True):
        cfg = get_config("seamless-m4t-large-v2", smoke=True).scaled(dtype="float32",
                                                                     coded=coded)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        assert "lm_head_coded" not in params
        eng = ServeEngine(model, params, n_slots=2, s_max=16, device="cpu")
        tokens[coded] = _serve(eng, _requests(Request, cfg, 3, [4], seed=6))
    assert tokens[True] == tokens[False]


def test_launcher_refuses_vlm_and_serves_moe_and_encdec(capsys):
    from repro_torch.launch.serve import main

    with pytest.raises(ValueError, match="img_embed"):
        main(["--arch", "llama-3.2-vision-11b", "--smoke", "--coded", "--device", "cpu",
              "--requests", "2", "--max-new", "2"])
    for arch in ("dbrx-132b", "seamless-m4t-large-v2"):
        main(["--arch", arch, "--smoke", "--coded", "--device", "cpu", "--requests", "3",
              "--max-new", "3", "--s-max", "32"])
        assert "3 requests, 9 tokens" in capsys.readouterr().out
