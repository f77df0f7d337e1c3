"""Shared cases of ``tests/test_torch_train_{moe,vlm,encdec}.py``: the port's
training of the moe, vlm and encdec families against the JAX reference.

The SMOKE configs in float32 activations, the reference's seeded params or
train state carried into the port through numpy (``params_from_numpy``,
``train_state_from_numpy``).  A vlm's cross-attention gates are set to
``GATE`` on both sides where a case says so (at init tanh(0) = 0 hides the
cross path from the loss, though not from the gate's own gradient).

Tolerances (those of ``tests/test_torch_train.py``): loss and metrics
within 1e-5 relative; each gradient leaf within 1e-4 of its max|g|; a
whole step's gradient read from the first moment after one step from zero
moments, the next step's loss within 1e-5.
"""
import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro.optim import AdamWConfig as JaxAdamW
from repro.runtime import checkpoint as jck
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import init_train_state as jax_init_state
from repro.train.loop import make_train_step as jax_make_step
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.launch import train as launcher
from repro_torch.models import transformer
from repro_torch.models.moe import route
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig, QTensor
from repro_torch.runtime import restore_checkpoint, save_checkpoint
from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves
from repro_torch.weights import params_from_numpy, train_state_from_numpy

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
GATE = 0.5
SEQ, BATCH = 32, 2          # the loss and gradient cases: 2 x 32 tokens in chunks of 8
STEP_SEQ, STEP_BATCH = 32, 8

STEP_CASES = {
    "plain": (dict(microbatches=4), None),
    "frc": (dict(microbatches=4, gradient_coding="frc"), [1.0, 0.0, 1.0, 1.0]),
    "cyclic": (dict(microbatches=4, gradient_coding="cyclic"), [1.0, 1.0, 0.0, 1.0]),
    "frc-skip": (dict(microbatches=4, gradient_coding="frc"), [0.0, 0.0, 1.0, 1.0]),
}


def one_torch_thread():
    """The models are tiny: one intra-op thread runs them faster, and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch, **kw):
    jc = jax_config(arch, smoke=True).scaled(dtype="float32", **kw)
    tc = get_config(arch, smoke=True).scaled(dtype="float32", **kw)
    assert jc.__dict__ == tc.__dict__
    return jc, tc


def close_rel(got, want, rtol=LOSS_RTOL):
    got, want = (float(x.detach() if isinstance(x, torch.Tensor) else x) for x in (got, want))
    assert abs(got - want) <= rtol * max(abs(want), 1e-30), (got, want)


def grads_close(got_leaves, want_leaves, tol=GRAD_TOL):
    got_leaves, want_leaves = list(got_leaves), list(want_leaves)
    assert len(got_leaves) == len(want_leaves)
    for got, want in zip(got_leaves, want_leaves):
        want = np.asarray(want, np.float32)
        got = got.detach().float().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def set_gates(params, value):
    """A copy of a vlm param tree (either package's) with every cross-attention
    gate set to ``value``; other families' trees come back as they are."""
    if value is None or not any(k.startswith("xattn_") for k in params.get("blocks", {})):
        return params
    blocks = dict(params["blocks"])
    for name, sub in blocks.items():
        if name.startswith("xattn_"):
            g = sub["gate"]
            blocks[name] = {**sub, "gate": (torch.full_like(g, value) if isinstance(g, torch.Tensor)
                                            else jnp.full_like(g, value))}
    return {**params, "blocks": blocks}


def torch_batch(batch):
    return {k: torch.as_tensor(v).long() if v.dtype.kind in "iu" else torch.as_tensor(v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    jc, _ = cfgs(arch)
    return jax.jit(jax_build(jc).init)(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def jax_loss_and_grad(arch, gate=None, with_image=True):
    """The reference's (loss, metrics, grads, params, batch) on a batch of 2 x
    32 tokens in loss chunks of 8 (its default remat); a vlm batch carries
    the pipeline's seeded images unless ``with_image`` is False."""
    jc, tc = cfgs(arch, logit_chunk=8)
    jp = set_gates(jax_params(arch), gate)
    batch = make_pipeline(tc, seq=SEQ, global_batch=BATCH, seed=4).batch(0)
    if not with_image:
        batch.pop("img_embed")
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_build(jc).loss(p, batch), has_aux=True))(jp)
    return jloss, jmet, jgrads, jp, batch


def torch_loss_and_grad(arch, *, remat=True, gate=None, with_image=True):
    """The port's (loss, metrics, gradient leaves) on the reference's params
    and batch."""
    _, tc = cfgs(arch, remat=remat, logit_chunk=8)
    _, _, _, jp, batch = jax_loss_and_grad(arch, gate, with_image)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    tloss, tmet = build_model(tc).loss(tp, torch_batch(batch))
    tloss.backward()
    return tloss, tmet, [p.grad for p in leaves]


def check_loss_and_grad(arch, remat, gate=None):
    """``Model.loss`` and every gradient leaf against the reference's."""
    jloss, jmet, jgrads, _, _ = jax_loss_and_grad(arch, gate)
    tloss, tmet, tgrads = torch_loss_and_grad(arch, remat=remat, gate=gate)
    close_rel(tloss, jloss)
    for k in ("ce", "aux"):
        close_rel(tmet[k], jmet[k])
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == SEQ * BATCH
    grads_close(tgrads, jax.tree.leaves(jgrads))
    return tgrads


def moe_calls(arch):
    """Each ``moe_apply`` call of the port's loss on the reference's params and
    batch: (its params, its input)."""
    _, tc = cfgs(arch, logit_chunk=8)
    _, _, _, jp, batch = jax_loss_and_grad(arch)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    seen, real = [], transformer.moe_apply

    def record(p, x, **kw):
        seen.append((p, x.detach().clone(), kw))
        return real(p, x, **kw)

    transformer.moe_apply = record
    try:
        with torch.no_grad():
            build_model(tc).loss(tp, torch_batch(batch))
    finally:
        transformer.moe_apply = real
    return seen


def check_routing_ids(arch):
    """At every MoE layer's real input, the port's routing picks the experts
    the reference's ``lax.top_k`` over its fp32 softmax picks, and its gates
    are the reference's."""
    calls = moe_calls(arch)
    _, tc = cfgs(arch)
    assert len(calls) == tc.n_layers // max(tc.moe_every, 1)
    for p, x, kw in calls:
        xf = x.reshape(-1, x.shape[-1])
        r = route(p, xf, top_k=kw["top_k"], capacity_factor=kw["capacity_factor"],
                  dispatch_groups=kw["dispatch_groups"])
        logits = jnp.asarray(xf.numpy(), jnp.float32) @ jnp.asarray(p["router"].numpy())
        gates, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), kw["top_k"])
        gates = gates / jnp.clip(gates.sum(-1, keepdims=True), 1e-9)
        assert np.array_equal(r.ids.numpy(), np.asarray(ids))
        np.testing.assert_allclose(r.gates.numpy(), np.asarray(gates), rtol=1e-6, atol=1e-7)


def check_forward(arch, gate=None):
    """``Model.forward`` (with ``img`` or ``frames``) against the reference's."""
    jc, tc = cfgs(arch)
    jp = set_gates(jax_params(arch), gate)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, (2, 24)).astype(np.int32)
    kw = {}
    if jc.family == "vlm":
        kw["img"] = rng.standard_normal((2, jc.img_tokens, jc.d_model)).astype(np.float32)
    if jc.family == "encdec":
        kw["frames"] = rng.standard_normal((2, 20, jc.d_model)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, t, **k: jax_build(jc).forward(p, t, **k))(
        jp, jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in kw.items()}))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with torch.no_grad():
        got = build_model(tc).forward(tp, torch.as_tensor(tokens).long(),
                                      **{k: torch.as_tensor(v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    return got


def check_train_step(arch, case, gate=None):
    """One whole step of ``case`` and the next, against the reference's
    jitted step from the same state and batches."""
    kw, mask = STEP_CASES[case]
    jc, tc = cfgs(arch)
    jm, tm = jax_build(jc), build_model(tc)
    jopt, topt = JaxAdamW(lr=1e-3), AdamWConfig(lr=1e-3)
    js = jax_init_state(jm, jax.random.key(0), jopt, JaxTrainConfig(**kw))
    js = {**js, "params": set_gates(js["params"], gate)}
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jstep = jax.jit(jax_make_step(jm, jopt, JaxTrainConfig(**kw)))
    tstep = make_train_step(tm, topt, TrainConfig(**kw))
    pipe = make_pipeline(tc, seq=STEP_SEQ, global_batch=STEP_BATCH, seed=2)
    jargs = () if mask is None else (jnp.asarray(mask, jnp.float32),)
    targs = () if mask is None else (torch.tensor(mask),)
    js1, jmet = jstep(js, jax.tree.map(jnp.asarray, pipe.batch(0)), *jargs)
    ts1, tmet = tstep(ts, pipe.batch(0), *targs)
    assert set(tmet) == set(jmet)
    for k in jmet:
        close_rel(tmet[k], jmet[k])
    grads_close(tree_leaves(ts1["opt"]["m"]), jax.tree.leaves(js1["opt"]["m"]))
    if case == "frc-skip":
        assert float(tmet["ok"]) == 0.0
        for a, b in zip(tree_leaves(ts1["params"]) + tree_leaves(ts1["opt"]),
                        tree_leaves(ts["params"]) + tree_leaves(ts["opt"])):
            assert torch.equal(a, b)
    elif "ok" in tmet:
        assert float(tmet["ok"]) == 1.0
    _, jmet2 = jstep(js1, jax.tree.map(jnp.asarray, pipe.batch(1)), *jargs)
    _, tmet2 = tstep(ts1, pipe.batch(1), *targs)
    close_rel(tmet2["loss"], jmet2["loss"])


def check_checkpoints_cross(arch, tmp_path):
    """A train state with int8 moments and a compression residual, every
    leaf drawn, written by the reference restores in the port bit for bit,
    and the port's copy restores in the reference bit for bit; both
    manifests name the same leaves."""
    tcfg = dict(microbatches=2, gradient_coding="cyclic", compression="int8")
    jc = jax_config(arch, smoke=True)
    js = jax_init_state(jax_build(jc), jax.random.key(1), JaxAdamW(moment_dtype="int8"),
                        JaxTrainConfig(**tcfg))
    rng = np.random.default_rng(0)

    def fill(x):
        if x.dtype == jnp.int8:
            return jnp.asarray(rng.integers(-127, 128, x.shape).astype(np.int8))
        return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)).astype(x.dtype)

    js = {"params": jax.tree.map(fill, js["params"]), "err": jax.tree.map(fill, js["err"]),
          "opt": {**jax.tree.map(fill, {k: js["opt"][k] for k in ("m", "v")}),
                  "step": jnp.asarray(13, jnp.int32)}}
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jck.save_checkpoint(str(tmp_path / "ref"), 13, js)
    template = init_train_state(build_model(get_config(arch, smoke=True)), None,
                                AdamWConfig(moment_dtype="int8"), TrainConfig(**tcfg),
                                device="cpu")
    step, got = restore_checkpoint(str(tmp_path / "ref"), template)
    assert step == 13
    lg, lt = tree_leaves(got), tree_leaves(ts)
    assert len(lg) == len(lt) == len(jax.tree.leaves(js))
    for a, b in zip(lg, lt):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(isinstance(q, QTensor) and q.pow == 4
               for q in tree_leaves(got["opt"]["m"], lambda x: isinstance(x, QTensor)))
    save_checkpoint(str(tmp_path / "port"), 14, got)
    jstep, back = jck.restore_checkpoint(str(tmp_path / "port"), js)
    assert jstep == 14
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    with open(tmp_path / "ref" / "step_00000013" / "manifest.json") as f:
        mref = json.load(f)["leaves"]
    with open(tmp_path / "port" / "step_00000014" / "manifest.json") as f:
        assert json.load(f)["leaves"] == mref
    return mref


def run_launcher(arch, *extra):
    """The train launcher in-process on a smoke config: FRC over 2
    microbatches under Markov stragglers, 6 steps."""
    rec = launcher.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "6",
                         "--batch", "4", "--seq", "16", "--microbatches", "2",
                         "--gradient-coding", "frc", "--straggler-prob", "0.2",
                         "--log-every", "3", "--lr", "1e-2", *extra])
    steps = rec["steps"]
    assert len(steps) == 6 and rec["skipped"] == 0
    assert all(np.isfinite(loss) and ok == 1.0 for _, loss, ok, _, _ in steps)
    return rec
