"""Port optimizer (``repro_torch.optim``) vs the JAX reference, and its own contracts.

Differential (same numpy inputs through both packages):

* ``quantize`` / ``dequantize``: bit-equal.  With ``pow=1`` every op is an
  exactly rounded IEEE op in both.  With ``pow=4`` the fourth root goes
  through two libraries' ``pow``; a code may then differ by one step, and
  only where 127·|y|^(1/4) sits within 1e-4 of a rounding tie (k + 1/2).
  None does on these draws.  ``compress_with_feedback`` holds to the same.
* ``adamw_update``: one call on identical params, moments, step and grads,
  for fp32, bf16 and int8 moments: params within 1e-6 relative (of each
  leaf's max|p|), fp32/bf16 moments within 1e-6 relative, int8 moments
  within one code, ``step``, ``grad_norm`` and ``lr`` equal to fp32
  rounding.
* the LR schedules: within 1e-6 relative at every step.

Port-internal, mirrored from the reference's ``tests/test_optim.py``: int8
Adam tracks fp32 Adam, the int8 state is ~4x smaller, quantization error is
bounded, companding keeps small values, error feedback is unbiased, and
clipping applies.
"""
import gc
import weakref

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import quant as jquant
from repro.optim import schedule as jsched
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.models.registry import build_model
from repro_torch.optim import (
    AdamWConfig,
    QTensor,
    adamw_update,
    compress_leaf_,
    compress_with_feedback,
    constant,
    decompress,
    dequantize,
    global_norm,
    init_error_state,
    init_opt_state,
    quantize,
    warmup_cosine,
)
from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.weights import train_state_from_numpy, train_state_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster, and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SHAPES = [(1000,), (64, 257), (3, 5, 300), (), (1, 1)]


def _draw(shape, seed):
    rng = np.random.default_rng(seed)
    scale = [1e-6, 1.0, 1e4][seed % 3]
    x = rng.standard_normal(shape) * scale
    if x.size > 3:
        x.flat[:3] = [0.0, scale * 1e-5, -scale]   # a zero, a tiny value, the row max
    return np.asarray(x, np.float32)


def _assert_codes_match(tq, jq_t, x, pw):
    got, want = tq.q.numpy().astype(np.int64), np.asarray(jq_t.q).astype(np.int64)
    assert got.shape == want.shape and tq.q.dtype == torch.int8
    off = got != want
    assert np.abs(got - want).max(initial=0) <= 1
    if off.any():
        assert pw != 1, "pow=1 must be bit-equal"
        xf = np.atleast_1d(x).astype(np.float64)
        y = np.abs(xf / np.maximum(np.abs(xf).max(-1, keepdims=True), 1e-30)) ** (1.0 / pw)
        frac = (127.0 * y).reshape(got.shape)[off] % 1.0
        assert np.all(np.abs(frac - 0.5) < 1e-4), "a code differs away from a rounding tie"
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq_t.scale))


@pytest.mark.parametrize("pw", [1, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_reference(shape, pw):
    for seed in range(3):
        x = _draw(shape, seed)
        jq_t = jquant.quantize(jnp.asarray(x), pow=pw)
        tq = quantize(torch.as_tensor(x), pow=pw)
        assert tq.shape == tuple(jq_t.shape) and tq.pow == jq_t.pow
        _assert_codes_match(tq, jq_t, x, pw)
        # dequantize of the same codes: bit-equal
        same = QTensor(q=torch.as_tensor(np.array(jq_t.q)),
                       scale=torch.as_tensor(np.array(jq_t.scale)), shape=tq.shape, pow=pw)
        np.testing.assert_array_equal(dequantize(same).numpy(),
                                      np.asarray(jquant.dequantize(jq_t)))


def test_compress_with_feedback_matches_reference():
    rng = np.random.default_rng(3)
    g = {"w": rng.standard_normal((4, 33, 70)).astype(np.float32),
         "b": [rng.standard_normal((4, 70)).astype(np.float32) * 1e-3]}
    e = {"w": rng.standard_normal((4, 33, 70)).astype(np.float32) * 1e-2,
         "b": [rng.standard_normal((4, 70)).astype(np.float32) * 1e-5]}
    jm, je = jcomp.compress_with_feedback(jax.tree.map(jnp.asarray, g),
                                          jax.tree.map(jnp.asarray, e))
    tm, te = compress_with_feedback(train_state_from_numpy(g, "cpu"),
                                    train_state_from_numpy(e, "cpu"))
    for tq, jq_t, x, ee in ((tm["w"], jm["w"], g["w"], e["w"]),
                            (tm["b"][0], jm["b"][0], g["b"][0], e["b"][0])):
        _assert_codes_match(tq, jq_t, x + ee, 1)
    np.testing.assert_array_equal(te["w"].numpy(), np.asarray(je["w"]))
    np.testing.assert_array_equal(te["b"][0].numpy(), np.asarray(je["b"][0]))
    np.testing.assert_array_equal(decompress(tm)["w"].numpy(),
                                  np.asarray(jcomp.decompress(jm)["w"]))


def test_compress_leaf_in_place_is_compress_with_feedback():
    """The coded step's in-place exchange of one message buffer sends what
    ``compress_with_feedback`` quantizes and leaves its residual in the
    buffer; ``compress_with_feedback`` leaves its own inputs unchanged."""
    rng = np.random.default_rng(4)
    g = torch.as_tensor(rng.standard_normal((4, 33, 70)).astype(np.float32))
    e = torch.as_tensor(rng.standard_normal((4, 33, 70)).astype(np.float32) * 1e-2)
    g0, e0 = g.clone(), e.clone()
    (q,), (res,) = compress_with_feedback([g], [e])
    assert torch.equal(g, g0) and torch.equal(e, e0)
    buf = g.clone()
    q2, sent = compress_leaf_(buf, e)
    assert torch.equal(q2.q, q.q) and torch.equal(q2.scale, q.scale)
    assert torch.equal(sent, dequantize(q))
    assert torch.equal(buf, res)
    assert torch.equal(e, e0)


def _opt_inputs(kind, seed=0):
    """Params (matrices and vectors, nested), grads, and a mid-run AdamW
    state (moments from earlier steps, step 7) as numpy trees."""
    rng = np.random.default_rng(seed)
    shapes = {"emb": (32, 8), "blocks": [{"k": (3, 4, 5), "n": (5,)}, {"k": (3, 4, 5), "n": (5,)}],
              "w": (8, 16), "b": (16,)}

    def tree(f):
        return jax.tree.map(f, shapes, is_leaf=lambda s: isinstance(s, tuple))

    params = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = tree(lambda s: (rng.standard_normal(s) * 0.3).astype(np.float32))
    m = tree(lambda s: (rng.standard_normal(s) * 0.05).astype(np.float32))
    v = tree(lambda s: (rng.random(s) * 0.01 + 1e-6).astype(np.float32))
    jm, jv = jax.tree.map(jnp.asarray, m), jax.tree.map(jnp.asarray, v)
    if kind == "int8":
        jm = jax.tree.map(lambda x: jquant.quantize(x, pow=4), jm)
        jv = jax.tree.map(lambda x: jquant.quantize(x, pow=4), jv)
    elif kind == "bfloat16":
        jm = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jm)
        jv = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jv)
    state = {"m": jm, "v": jv, "step": jnp.asarray(7, jnp.int32)}
    return params, grads, state


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_reference(kind):
    params, grads, jstate = _opt_inputs(kind)
    jcfg = jadamw.AdamWConfig(lr=jsched.warmup_cosine(3e-3, 5, 100), moment_dtype=kind)
    tcfg = AdamWConfig(lr=warmup_cosine(3e-3, 5, 100), moment_dtype=kind)
    jp, js, jmet = jadamw.adamw_update(jax.tree.map(jnp.asarray, params),
                                       jax.tree.map(jnp.asarray, grads), jstate, jcfg)
    tstate = train_state_from_numpy(jstate, "cpu")
    tp, ts, tmet = adamw_update(train_state_from_numpy(params, "cpu"),
                                train_state_from_numpy(grads, "cpu"), tstate, tcfg)
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert int(ts["step"]) == int(js["step"]) == 8 and ts["step"].dtype == torch.int32
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
    is_q = lambda x: isinstance(x, (QTensor, jquant.QTensor))  # noqa: E731
    for key in ("m", "v"):
        for got, want in zip(tree_leaves(ts[key], is_q), jax.tree.leaves(js[key], is_leaf=is_q)):
            if kind == "int8":
                assert got.pow == 4
                assert np.abs(got.q.numpy().astype(int) - np.asarray(want.q).astype(int)).max() <= 1
                np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
            else:
                assert got.dtype == getattr(torch, kind)
                w = np.asarray(want, np.float32)
                np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                                           atol=1e-6 * np.abs(w).max() if kind == "float32"
                                           else 2 ** -8 * np.abs(w).max())
    # the inputs stay valid: nothing updated in place
    assert int(tstate["step"]) == 7


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_init_opt_state_matches_reference(kind):
    params, _, _ = _opt_inputs(kind)
    js = jadamw.init_opt_state(jax.tree.map(jnp.asarray, params),
                               jadamw.AdamWConfig(moment_dtype=kind))
    ts = init_opt_state(train_state_from_numpy(params, "cpu"), AdamWConfig(moment_dtype=kind))
    back = train_state_to_numpy(ts)
    is_q = lambda x: isinstance(x, (QTensor, jquant.QTensor))  # noqa: E731
    for got, want in zip(tree_leaves(back, is_q), jax.tree.leaves(js, is_leaf=is_q)):
        if is_q(want):
            np.testing.assert_array_equal(got.q, np.asarray(want.q))
            np.testing.assert_array_equal(got.scale, np.asarray(want.scale))
        else:
            np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_schedules_match_reference():
    for j, t in ((jsched.warmup_cosine(3e-3, 5, 100), warmup_cosine(3e-3, 5, 100)),
                 (jsched.warmup_cosine(1e-2, 1, 7, 0.2), warmup_cosine(1e-2, 1, 7, 0.2)),
                 (jsched.constant(1e-3), constant(1e-3))):
        for step in range(0, 120, 3):
            got = t(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), float(j(jnp.asarray(step, jnp.int32))),
                                       rtol=1e-6)


def test_schedule_stays_on_the_steps_device():
    step = torch.tensor(3, dtype=torch.int32, device="meta")
    assert warmup_cosine(1e-3, 5, 10)(step).device.type == "meta"
    assert constant(1e-3)(step).device.type == "meta"


# ---- port-internal contracts (the reference's tests/test_optim.py) --------
CFG = get_config("glm4-9b", smoke=True).scaled(
    name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=0, d_ff=64, vocab=64,
    dtype="float32")


def _run(moment_dtype, steps=25):
    model = build_model(CFG)
    opt = AdamWConfig(lr=warmup_cosine(3e-3, 5, 100), moment_dtype=moment_dtype)
    state = init_train_state(model, torch.Generator().manual_seed(0), opt, device="cpu")
    pipe = make_pipeline(CFG, seq=32, global_batch=8)
    step = make_train_step(model, opt, TrainConfig())
    losses = []
    for i in range(steps):
        state, m = step(state, pipe.batch(i))
        losses.append(float(m["loss"]))
    return losses, state


def test_int8_adam_tracks_fp32():
    l32, s32 = _run("float32")
    l8, s8 = _run("int8")
    assert np.abs(np.array(l32) - np.array(l8)).max() < 0.02
    for a, b in zip(tree_leaves(s32["params"]), tree_leaves(s8["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-3)


def test_int8_moment_memory():
    st8 = init_train_state(build_model(CFG), None, AdamWConfig(moment_dtype="int8"),
                           device="cpu")
    n_params = sum(x.numel() for x in tree_leaves(st8["params"]))
    m_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(st8["opt"]["m"]))
    assert m_bytes < n_params * 1.2  # ~1.02 bytes/param vs 4 for fp32


@pytest.mark.parametrize("n,scale,pw", [(1, 1.0, 1), (7, 1e-6, 4), (257, 1e6, 1),
                                        (1000, 3.0, 4), (2000, 1e-3, 1), (33, 5e5, 4)])
def test_quantize_roundtrip_bounded(n, scale, pw):
    x = (np.random.default_rng(n).standard_normal(n) * scale).astype(np.float32)
    back = dequantize(quantize(torch.as_tensor(x), pow=pw)).numpy()
    assert back.shape == x.shape
    tol = (np.abs(x).max() + 1e-30) * (0.02 if pw == 1 else 0.05)
    assert np.abs(back - x).max() <= tol


def test_companding_preserves_small_values():
    x = torch.tensor([1.0, 1e-4, 1e-6])
    lin = dequantize(quantize(x, pow=1)).numpy()
    cmp4 = dequantize(quantize(x, pow=4)).numpy()
    assert lin[1] == 0.0 and lin[2] == 0.0
    assert cmp4[1] > 0 and cmp4[2] > 0
    assert abs(cmp4[1] / 1e-4 - 1) < 0.2


def test_compression_error_feedback_unbiased():
    """Sum of compressed messages + final residual == sum of raw grads."""
    rng = np.random.default_rng(0)
    err = init_error_state({"w": torch.zeros(500)})
    total_sent, total_raw = torch.zeros(500), torch.zeros(500)
    for _ in range(20):
        g = {"w": torch.as_tensor(rng.standard_normal(500).astype(np.float32) * 0.1)}
        msgs, err = compress_with_feedback(g, err)
        total_sent = total_sent + decompress(msgs)["w"]
        total_raw = total_raw + g["w"]
    assert float((total_sent + err["w"] - total_raw).abs().max()) < 1e-4


def test_grad_clip_applies():
    model = build_model(CFG)
    opt = AdamWConfig(lr=1e-3, grad_clip=1e-9)
    state = init_train_state(model, torch.Generator().manual_seed(0), opt, device="cpu")
    step = make_train_step(model, opt, TrainConfig())
    p0 = tree_leaves(state["params"])[0].clone()
    state, _ = step(state, make_pipeline(CFG, seq=16, global_batch=4).batch(0))
    assert float((tree_leaves(state["params"])[0] - p0).abs().max()) < 1e-3


def test_global_norm():
    tree = {"a": torch.full((3,), 2.0), "b": [torch.full((2, 2), 1.0, dtype=torch.bfloat16)]}
    assert float(global_norm(tree)) == pytest.approx(4.0)
    assert tree_map(lambda x: x.dtype, tree)["b"][0] == torch.bfloat16


def _adamw_whole_leaves(params, grads, state, cfg):
    """``adamw_update`` as it was before it sliced large leaves and released
    the gradients: every leaf updated whole, every output built first."""
    from repro_torch.optim.quant import dequantize as deq

    is_q = lambda x: isinstance(x, QTensor)  # noqa: E731
    step = state["step"] + 1
    lr = cfg.lr_at(step)
    gn = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gn, 1e-12), 1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        mf = deq(m) if is_q(m) else m.to(torch.float32)
        vf = deq(v) if is_q(v) else v.to(torch.float32)
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
        delta = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        if is_q(m):
            return new_p, quantize(mf, pow=4), quantize(vf, pow=4)
        return new_p, mf.to(m.dtype), vf.to(v.dtype)

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"], is_q),
        tree_leaves(state["v"], is_q))]
    return ([o[0] for o in out], [o[1] for o in out], [o[2] for o in out])


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_sliced_adamw_releasing_its_gradients_is_bit_equal(kind, monkeypatch):
    """With leaves above ``SLICE_ELEMENTS`` updated in slices of whole rows
    and the gradients handed over as a list (each entry released once its
    leaf is done), params and moments are bit-equal to the whole-leaf
    update's, and the state the update was given is unchanged."""
    from repro_torch.optim import adamw as adamw_mod

    rng = np.random.default_rng(3)
    shapes = {"experts": (2, 4, 64, 128), "embed": (512, 64), "ragged": (7, 5, 48),
              "odd": (40, 37), "router": (2, 64, 4), "gate": (2,), "norm": (3, 64)}
    params = {k: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    grads = {k: torch.as_tensor((rng.standard_normal(s) * 0.3).astype(np.float32))
             for k, s in shapes.items()}
    cfg = AdamWConfig(lr=warmup_cosine(3e-3, 5, 100), moment_dtype=kind)
    state = init_opt_state(params, cfg)
    # a mid-run state: one whole-leaf step from zero moments
    p1, m1, v1 = _adamw_whole_leaves(params, grads, state, cfg)
    state = {"m": tree_unflatten(params, m1), "v": tree_unflatten(params, v1),
             "step": state["step"] + 1}
    params = tree_unflatten(params, p1)
    grads = {k: g.flip(0) for k, g in grads.items()}
    want_p, want_m, want_v = _adamw_whole_leaves(params, grads, state, cfg)
    kept = [t.clone() for t in tree_leaves(state) + tree_leaves(params)]
    monkeypatch.setattr(adamw_mod, "SLICE_ELEMENTS", 1000)
    g_list = [g.clone() for g in tree_leaves(grads)]
    released = [weakref.ref(g) for g in g_list]
    gc.disable()   # freed by reference counts alone: nothing holds them in a cycle
    try:
        got_p, got_state, met = adamw_update(params, g_list, state, cfg)
        assert g_list == [None] * len(shapes)
        assert all(r() is None for r in released)
    finally:
        gc.enable()
    assert float(met["grad_norm"]) == float(global_norm(grads))
    for got, want in zip(tree_leaves(got_p), want_p):
        assert got.dtype == want.dtype and torch.equal(got, want)
    is_q = lambda x: isinstance(x, QTensor)  # noqa: E731
    for key, want in (("m", want_m), ("v", want_v)):
        for got, w in zip(tree_leaves(got_state[key], is_q), want):
            if kind == "int8":
                assert got.shape == w.shape and got.pow == w.pow
                assert torch.equal(got.q, w.q) and torch.equal(got.scale, w.scale)
            else:
                assert torch.equal(got, w)
    assert all(torch.equal(a, b) for a, b in zip(kept, tree_leaves(state) + tree_leaves(params)))
