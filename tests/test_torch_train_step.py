"""The port's whole train step vs the JAX reference's, one step and the next.

The SMOKE configs of glm4-9b (dense), mamba2-130m (ssm) and zamba2-1.2b
(hybrid) in float32 activations; the reference's initial train state is
carried into the port through numpy (``train_state_from_numpy``).  Cases:
plain with 4 microbatches, FRC and cyclic under a one-straggler mask,
cyclic with int8 compression, and FRC under an undecodable mask (a whole
group dead: both skip).

Tolerances: loss and metrics within 1e-5 relative, ``ok`` equal, the
gradient within 1e-4 of each leaf's max|g|.  The gradient is read from the
first moment after one step from zero moments (m = (1 - b1) · clip · g,
the same map in both packages); params after Adam are not compared
(Adam's first step is sign-like and amplifies fp noise on near-zero
gradients), the next step's loss is, within 1e-5 relative.  With int8
compression a message element whose corrected value sits on a rounding
tie may round to the neighbouring code in one package: there the gradient
is held within 1e-4 of the leaf's max at 99.5 % of elements and within
3/127 of it everywhere (a code step is 1/127 of a message row's max).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro.optim import AdamWConfig as JaxAdamW
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import init_train_state as jax_init_state
from repro.train.loop import make_train_step as jax_make_step
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import TrainConfig, make_train_step
from repro_torch.utils.tree import tree_leaves
from repro_torch.weights import train_state_from_numpy


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


def _cfgs(arch):
    jc = jax_config(arch, smoke=True).scaled(dtype="float32")
    tc = get_config(arch, smoke=True).scaled(dtype="float32")
    assert jc.__dict__ == tc.__dict__
    return jc, tc


def _close_rel(got, want, rtol=LOSS_RTOL):
    assert abs(float(got) - float(want)) <= rtol * max(abs(float(want)), 1e-30), (got, want)


def _grads_close(got_leaves, want_leaves, tol=GRAD_TOL):
    got_leaves, want_leaves = list(got_leaves), list(want_leaves)
    assert len(got_leaves) == len(want_leaves)
    for got, want in zip(got_leaves, want_leaves):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol * max(np.abs(want).max(), 1e-30))


STEP_CASES = [
    ("plain", dict(microbatches=4), None),
    ("frc", dict(microbatches=4, gradient_coding="frc"), [1.0, 0.0, 1.0, 1.0]),
    ("cyclic", dict(microbatches=4, gradient_coding="cyclic"), [1.0, 1.0, 0.0, 1.0]),
    ("cyclic-int8", dict(microbatches=4, gradient_coding="cyclic", compression="int8"),
     [0.0, 1.0, 1.0, 1.0]),
    ("frc-skip", dict(microbatches=4, gradient_coding="frc"), [0.0, 0.0, 1.0, 1.0]),
]


def _pair_states(jm, tc_model, kw, lr=1e-3):
    jopt, topt = JaxAdamW(lr=lr), AdamWConfig(lr=lr)
    js = jax_init_state(jm, jax.random.key(0), jopt, JaxTrainConfig(**kw))
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jstep = jax.jit(jax_make_step(jm, jopt, JaxTrainConfig(**kw)))
    tstep = make_train_step(tc_model, topt, TrainConfig(**kw))
    return js, ts, jstep, tstep


@pytest.mark.parametrize("case", [c[0] for c in STEP_CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, case):
    _, kw, mask = next(c for c in STEP_CASES if c[0] == case)
    jc, tc = _cfgs(arch)
    js, ts, jstep, tstep = _pair_states(jax_build(jc), build_model(tc), kw)
    pipe = make_pipeline(tc, seq=32, global_batch=8, seed=2)
    jargs = () if mask is None else (jnp.asarray(mask, jnp.float32),)
    targs = () if mask is None else (torch.tensor(mask),)
    js1, jmet = jstep(js, jax.tree.map(jnp.asarray, pipe.batch(0)), *jargs)
    ts1, tmet = tstep(ts, pipe.batch(0), *targs)
    assert set(tmet) == set(jmet)
    for k in jmet:
        _close_rel(tmet[k], jmet[k])
    if "ok" in jmet:
        assert float(tmet["ok"]) == float(jmet["ok"])
    got_m, want_m = tree_leaves(ts1["opt"]["m"]), jax.tree.leaves(js1["opt"]["m"])
    if case == "cyclic-int8":
        for got, want in zip(got_m, want_m):
            want = np.asarray(want)
            diff = np.abs(got.numpy() - want)
            scale = max(np.abs(want).max(), 1e-30)
            assert np.mean(diff <= GRAD_TOL * scale) >= 0.995
            assert diff.max() <= 3 / 127 * scale
    else:
        _grads_close(got_m, want_m)
    if case == "frc-skip":
        assert float(tmet["ok"]) == 0.0
        for a, b in zip(tree_leaves(ts1["params"]) + tree_leaves(ts1["opt"]),
                        tree_leaves(ts["params"]) + tree_leaves(ts["opt"])):
            assert torch.equal(a, b)
    js2, jmet2 = jstep(js1, jax.tree.map(jnp.asarray, pipe.batch(1)), *jargs)
    ts2, tmet2 = tstep(ts1, pipe.batch(1), *targs)
    _close_rel(tmet2["loss"], jmet2["loss"])
