"""Port training path (``repro_torch.train``, ``lm_loss``, ``SSDScan``, data) vs the JAX reference.

The SMOKE configs of glm4-9b (dense), mamba2-130m (ssm) and zamba2-1.2b
(hybrid) in float32 activations, with the reference's seeded params
carried into the port through numpy (``repro_torch.weights.params_from_numpy``).
On the CPU the SSD runs the kernels' plain versions forward and
``ssd_chunked``'s backward.

Tolerances:

* ``SyntheticLM`` batches: ``np.array_equal``.
* ``lm_loss``: within 1e-5 relative; each gradient leaf within 1e-4 of its
  max|g| (``jax.value_and_grad`` on the reference side); the final hidden
  states within 1e-5 of their max.
* ``SSDScan``: its forward is ``ssd_forward``'s and its gradients are
  ``ssd_chunked``'s, bit for bit (the same computations on the CPU).

The whole train step against the reference is in
``tests/test_torch_train_step.py``; here also the port's own contracts,
mirrored from the reference's tests (all-ones and one-straggler coded
steps equal the plain step, the skip step, M = 1 vs M = 4, the loss
decreasing, error feedback) and the Mamba train path reaching the SSD only
through ``SSDScan``.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import make_pipeline as jax_pipeline
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, make_pipeline
from repro_torch.kernels.ops import SSDScan, ssd_forward
from repro_torch.models.registry import build_model
from repro_torch.models.ssm import ssd_chunked
from repro_torch.models.transformer import chunked_ce
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step
from repro_torch.utils.tree import tree_leaves
from repro_torch.weights import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster, and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARCHS = ["glm4-9b", "mamba2-130m", "zamba2-1.2b"]
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _cfgs(arch, **kw):
    jc = jax_config(arch, smoke=True).scaled(dtype="float32", **kw)
    tc = get_config(arch, smoke=True).scaled(dtype="float32", **kw)
    assert jc.__dict__ == tc.__dict__
    return jc, tc


def _close_rel(got, want, rtol=LOSS_RTOL):
    got, want = (x.detach() if isinstance(x, torch.Tensor) else x for x in (got, want))
    assert abs(float(got) - float(want)) <= rtol * max(abs(float(want)), 1e-30), (got, want)


def _grads_close(got_leaves, want_leaves, tol=GRAD_TOL):
    got_leaves, want_leaves = list(got_leaves), list(want_leaves)
    assert len(got_leaves) == len(want_leaves)
    for got, want in zip(got_leaves, want_leaves):
        want = np.asarray(want, np.float32)
        got = got.detach().float().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


# ---- data -------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_batches_bit_equal(arch):
    jc, tc = _cfgs(arch)
    for seed, host, n_hosts in ((0, 0, 1), (3, 1, 2)):
        jp = jax_pipeline(jc, seq=24, global_batch=8, seed=seed, host_id=host, n_hosts=n_hosts)
        tp = make_pipeline(tc, seq=24, global_batch=8, seed=seed, host_id=host, n_hosts=n_hosts)
        assert isinstance(tp, SyntheticLM) and tp.local_batch == jp.local_batch
        for step in (0, 1, 17):
            a, b = jp.batch(step), tp.batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_pipeline_restartable_and_shifted():
    _, tc = _cfgs("glm4-9b")
    p = make_pipeline(tc, seq=16, global_batch=4, seed=1)
    b5 = p.batch(5)
    assert np.array_equal(list(p.batches(5, 1))[0]["tokens"], b5["tokens"])
    assert np.array_equal(b5["tokens"][:, 1:], b5["labels"][:, :-1])


# ---- loss and its gradient -------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_params(jc):
    return jax.jit(jax_build(jc).init)(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(arch):
    """The reference's (loss, metrics, grads, params, batch) on a batch of
    2 x 32 tokens in chunks of 8 (with its default remat)."""
    jc, tc = _cfgs(arch, logit_chunk=8)
    jp = _jax_params(jc)
    batch = make_pipeline(tc, seq=32, global_batch=2, seed=4).batch(0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_build(jc).loss(p, batch), has_aux=True))(jp)
    return jloss, jmet, jgrads, jp, batch


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grad_match_reference(arch, remat):
    _, tc = _cfgs(arch, remat=remat, logit_chunk=8)
    jloss, jmet, jgrads, jp, batch = _jax_loss_and_grad(arch)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    tloss, tmet = build_model(tc).loss(tp, tb)
    tloss.backward()
    _close_rel(tloss, jloss)
    _close_rel(tmet["ce"], jmet["ce"])
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == 64.0
    _grads_close([p.grad for p in leaves], jax.tree.leaves(jgrads))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jc, tc = _cfgs(arch)
    jp = _jax_params(jc)
    tokens = np.random.default_rng(1).integers(0, jc.vocab, (2, 24)).astype(np.int32)
    want = np.asarray(jax.jit(jax_build(jc).forward)(jp, jnp.asarray(tokens)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with torch.no_grad():
        got = build_model(tc).forward(tp, torch.as_tensor(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_chunked_ce_keeps_no_chunk_logits_for_the_backward():
    """Under grad mode no tensor of a chunk's [B, c, V] logits is saved for
    the backward (each chunk is recomputed), and the loss and its gradient
    equal the unchunked CE's."""
    g = torch.Generator().manual_seed(0)
    b, s, d, v, c = 2, 32, 16, 97, 8
    hidden = torch.randn(b, s, d, generator=g, requires_grad=True)
    head = torch.randn(d, v, generator=g, requires_grad=True)
    labels = torch.randint(0, v, (b, s), generator=g)
    labels[0, 3] = -1
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        loss, cnt = chunked_ce(hidden, head, labels, c)
    assert not [t.shape for t in saved
                if t.shape[-1:] == (v,) and t.data_ptr() != head.data_ptr()]
    loss.backward()
    want = torch.nn.functional.cross_entropy((hidden @ head).reshape(-1, v), labels.reshape(-1),
                                             ignore_index=-1)
    assert float(cnt) == b * s - 1
    _close_rel(loss, want)
    gh, gw = torch.autograd.grad(want, (hidden, head))
    _grads_close([hidden.grad, head.grad], [gh.numpy(), gw.numpy()])


# ---- SSDScan -----------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk", [(32, 8), (48, 16), (16, 16)])
def test_ssd_scan_forward_and_grads(s, chunk, dtype):
    """SSDScan's forward is ssd_forward's, and its gradients (of y and of
    the final state) are those of ssd_chunked at the same inputs."""
    g = torch.Generator().manual_seed(s)
    bsz, h, p, n, gr = 2, 4, 8, 16, 1
    x = torch.randn(bsz, s, h, p, generator=g).to(dtype)
    da = -torch.rand(bsz, s, h, generator=g) * 0.5
    b = torch.randn(bsz, s, gr, n, generator=g).to(dtype)
    c = torch.randn(bsz, s, gr, n, generator=g).to(dtype)
    ins = [t.clone().requires_grad_(True) for t in (x, da, b, c)]
    y, fin = SSDScan.apply(*ins, chunk, "off")
    wy, wfin = ssd_forward(x, da, b, c, chunk, mode="off")
    assert torch.equal(y, wy) and torch.equal(fin, wfin)
    gy = torch.randn(y.shape, generator=g).to(dtype)
    gf = torch.randn(fin.shape, generator=g)
    gots = torch.autograd.grad((y, fin), ins, (gy, gf))
    ref_in = [t.clone().requires_grad_(True) for t in (x, da, b, c)]
    ry, rfin = ssd_chunked(*ref_in, chunk)
    wants = torch.autograd.grad((ry, rfin), ref_in, (gy, gf))
    for got, want in zip(gots, wants):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_ssd_scan_grad_of_y_only():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 16, 2, 4, generator=g, requires_grad=True)
    da = (-torch.rand(1, 16, 2, generator=g)).requires_grad_(True)
    b = torch.randn(1, 16, 1, 8, generator=g, requires_grad=True)
    c = torch.randn(1, 16, 1, 8, generator=g)   # no grad wanted
    y, _ = SSDScan.apply(x, da, b, c, 8, None)
    y.sum().backward()
    ref = [t.detach().clone().requires_grad_(True) for t in (x, da, b)]
    ssd_chunked(*ref, c, 8)[0].sum().backward()
    for got, want in zip((x.grad, da.grad, b.grad), (r.grad for r in ref)):
        assert torch.equal(got, want)
    assert c.grad is None


# ---- port-internal contracts (the reference's tests) -----------------------------
def _tiny(arch="glm4-9b"):
    _, tc = _cfgs(arch)
    return build_model(tc), make_pipeline(tc, seq=16, global_batch=8)


def _state(model, opt, tc=None):
    return init_train_state(model, torch.Generator().manual_seed(0), opt, tc, device="cpu")


@pytest.mark.parametrize("kind", ["frc", "cyclic"])
def test_coded_all_ones_and_one_straggler_equal_plain(kind):
    model, pipe = _tiny()
    opt = AdamWConfig(lr=1e-2)
    plain = make_train_step(model, opt, TrainConfig(microbatches=4))
    coded = make_train_step(model, opt, TrainConfig(microbatches=4, gradient_coding=kind))
    batch = pipe.batch(0)
    sp, mp = plain(_state(model, opt), batch)
    for mask in ([1.0] * 4, [1.0, 1.0, 0.0, 1.0]):
        sc, mc = coded(_state(model, opt), batch, torch.tensor(mask))
        assert set(mc) == set(mp) | {"ok"} and float(mc["ok"]) == 1.0
        _close_rel(mc["loss"], mp["loss"])
        _close_rel(mc["ce"], mp["ce"])
        _grads_close(tree_leaves(sc["opt"]["m"]),
                     [t.numpy() for t in tree_leaves(sp["opt"]["m"])], 1e-4)


@pytest.mark.parametrize("kind,mask", [("cyclic", [1.0, 0.0, 0.0, 1.0]),
                                       ("frc", [0.0, 0.0, 1.0, 1.0])])
def test_unrecoverable_step_is_skipped(kind, mask):
    """A > s straggler pattern flags ok = 0 and leaves params AND the whole
    optimizer state (step included) bit-identical; the compression residual
    is still carried forward."""
    model, pipe = _tiny()
    opt = AdamWConfig(lr=1e-2, moment_dtype="int8")
    tc = TrainConfig(microbatches=4, gradient_coding=kind, compression="int8")
    step = make_train_step(model, opt, tc)
    st0 = _state(model, opt, tc)
    st1, met = step(st0, pipe.batch(0), torch.tensor(mask))
    assert float(met["ok"]) == 0.0
    for key in ("params", "opt"):
        for a, b in zip(tree_leaves(st0[key]), tree_leaves(st1[key])):
            assert torch.equal(a, b)
    assert int(st1["opt"]["step"]) == 0
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(st1["err"]))
    good = [1.0, 0.0, 1.0, 1.0]
    st2, met2 = step(st0, pipe.batch(0), torch.tensor(good))
    assert float(met2["ok"]) == 1.0 and int(st2["opt"]["step"]) == 1
    assert max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(st0["params"]), tree_leaves(st2["params"]))) > 0.0


def test_loss_decreases():
    model, pipe = _tiny()
    opt = AdamWConfig(lr=1e-2)
    step = make_train_step(model, opt, TrainConfig(microbatches=2))
    st, losses = _state(model, opt), []
    for i in range(30):
        st, met = step(st, pipe.batch(i % 4))
        losses.append(float(met["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_microbatch_equivalence():
    """M = 1 and M = 4 accumulate the same gradient (compared through the
    first moment; Adam's sign-like first step is not)."""
    model, pipe = _tiny()
    opt = AdamWConfig(lr=1e-3)
    batch = pipe.batch(0)
    s1, m1 = make_train_step(model, opt, TrainConfig(microbatches=1))(_state(model, opt), batch)
    s4, m4 = make_train_step(model, opt, TrainConfig(microbatches=4))(_state(model, opt), batch)
    _close_rel(m4["loss"], m1["loss"])
    _grads_close(tree_leaves(s4["opt"]["m"]), [t.numpy() for t in tree_leaves(s1["opt"]["m"])])


def test_compression_error_feedback_in_the_step():
    model, pipe = _tiny()
    opt = AdamWConfig(lr=1e-2)
    tc = TrainConfig(microbatches=4, gradient_coding="cyclic", gc_stragglers=1,
                     compression="int8")
    step = make_train_step(model, opt, tc)
    st = _state(model, opt, tc)
    assert all(x.shape[0] == 4 for x in tree_leaves(st["err"]))
    losses = []
    for i in range(12):
        mask = torch.ones(4)
        mask[i % 4] = 0.0
        st, met = step(st, pipe.batch(i), mask)
        losses.append(float(met["loss"]))
    assert any(float(x.abs().max()) > 0.0 for x in tree_leaves(st["err"]))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    with pytest.raises(ValueError):
        TrainConfig(microbatches=4, compression="int8")
    with pytest.raises(KeyError):
        step({k: v for k, v in st.items() if k != "err"}, pipe.batch(0))


def test_mamba_train_step_reaches_the_ssd_through_ssd_scan(monkeypatch):
    """The Mamba block's train path calls SSDScan (never the bare
    ssd_forward under grad), once a block a forward and once more a
    checkpoint recompute."""
    import repro_torch.kernels.ops as ops

    calls = {"scan": 0, "bare_under_grad": 0}
    real_apply, real_fwd = ops.SSDScan.apply, ops.ssd_forward

    def counted_apply(*a):
        calls["scan"] += 1
        return real_apply(*a)

    def counted_fwd(*a, **k):
        if torch.is_grad_enabled() and any(t.requires_grad for t in a[:4]):
            calls["bare_under_grad"] += 1
        return real_fwd(*a, **k)

    monkeypatch.setattr(ops.SSDScan, "apply", counted_apply)
    monkeypatch.setattr(ops, "ssd_forward", counted_fwd)
    model, pipe = _tiny("zamba2-1.2b")
    opt = AdamWConfig(lr=1e-3)
    make_train_step(model, opt, TrainConfig(microbatches=2))(_state(model, opt), pipe.batch(0))
    n_blocks = model.cfg.n_layers
    assert calls == {"scan": n_blocks * 2 * 2, "bare_under_grad": 0}


def test_kernel_wrappers_refuse_grad_requiring_inputs():
    """Every hand-written kernel's wrapper raises, naming itself, when grad
    mode is on and an input requires grad — before anything else, so the
    refusal holds on any device (the launch itself is the card's; see
    ``tests/test_torch_cuda.py``)."""
    from repro_torch.kernels import kernel_wrappers

    x = torch.ones(4, 4, requires_grad=True)
    for name, wrapper in kernel_wrappers().items():
        args = [x] + [torch.ones(4, 4)] * 6
        n_args = {"coded_matvec": 2, "coded_matvec_decode": 3, "gaussian_encode": 2,
                  "lt_encode": 3, "masked_pinv": 2, "prefill_attn": 7, "ssd_chunk": 4,
                  "ssd_combine": 3}[name]
        with pytest.raises(RuntimeError, match=wrapper.__name__):
            wrapper(*args[:n_args])
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            wrapper(*args[:n_args])
