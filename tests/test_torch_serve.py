"""Port ServeEngine vs the JAX reference engine on carried params.

Same params, prompts and seeded mask/latency functions into both engines:
the float32 smoke configs must give identical tokens, host-sync counts and
parity events — including the 3-persistent-straggler parity raise, where
the reference re-encodes through its Pallas kernel in interpret mode.
"""
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.adaptive import ParityController as JaxParityController
from repro.models.registry import build_model as jax_build
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.core.adaptive import ParityController
from repro_torch.models.registry import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.weights import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _models(arch, coded, parity=2):
    cfg = jax_config(arch, smoke=True).scaled(dtype="float32", coded=coded,
                                              coded_parity=parity)
    jm = jax_build(cfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    from repro_torch.configs import get_config

    tcfg = get_config(arch, smoke=True).scaled(dtype="float32", coded=coded,
                                               coded_parity=parity)
    return cfg, jm, jp, build_model(tcfg), tp


def _prompts(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 3 + (i % 4)).astype(np.int32) for i in range(n)]


def _drive(eng, request_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        eng.submit(request_cls(uid=i, prompt=p, max_new_tokens=max_new[i % len(max_new)]))
    done = eng.run()
    return {r.uid: list(r.out_tokens) for r in done}, [r.uid for r in done]


def _assert_same(jeng, teng, jout, tout):
    assert tout == jout
    assert teng.sync_count == jeng.sync_count
    assert teng.tokens_emitted == jeng.tokens_emitted
    assert teng.parity_events == jeng.parity_events


def _mask_fn_factory(n_shards, p, budget, seed):
    rng = np.random.default_rng(seed)

    def mask_fn():
        m = np.ones(n_shards)
        m[np.flatnonzero(rng.random(n_shards) < p)[:budget]] = 0.0
        return m

    return mask_fn


@pytest.mark.parametrize("arch,coded", [("glm4-9b", False), ("glm4-9b", True),
                                        ("phi3-mini-3.8b", True)])
def test_engine_tokens_equal_reference(arch, coded):
    cfg, jm, jp, tm, tp = _models(arch, coded)
    prompts = _prompts(cfg.vocab, 5)
    kw = {}
    if coded:
        kw = dict(mask_fn=_mask_fn_factory(16, 0.3, 2, seed=4))
    jeng = JaxServeEngine(jm, jp, n_slots=3, s_max=24, **kw)
    if coded:
        kw = dict(mask_fn=_mask_fn_factory(16, 0.3, 2, seed=4))
    teng = ServeEngine(tm, tp, n_slots=3, s_max=24, device="cpu", **kw)
    jout, jorder = _drive(jeng, JaxRequest, prompts, [4, 1, 6])
    tout, torder = _drive(teng, Request, prompts, [4, 1, 6])
    _assert_same(jeng, teng, jout, tout)
    assert torder == jorder
    assert all(len(tout[i]) == [4, 1, 6][i % 3] for i in tout)


def test_engine_eos_and_latency_driven_masks_equal_reference():
    cfg, jm, jp, tm, tp = _models("glm4-9b", True)
    prompts = _prompts(cfg.vocab, 4, seed=1)

    def latency_factory(seed):
        rng = np.random.default_rng(seed)

        def latency_fn():
            lat = 1e-3 * (1.0 + 0.1 * rng.random(16))
            lat[rng.random(16) < 0.2] *= 50.0
            return lat

        return latency_fn

    # find a token the reference emits mid-stream, and use it as EOS
    probe = JaxServeEngine(jm, jp, n_slots=2, s_max=24)
    pout, _ = _drive(probe, JaxRequest, prompts, [6])
    eos = pout[0][2]
    jeng = JaxServeEngine(jm, jp, n_slots=2, s_max=24, eos_token=eos,
                          latency_fn=latency_factory(7),
                          parity_controller=JaxParityController(16))
    teng = ServeEngine(tm, tp, n_slots=2, s_max=24, eos_token=eos, device="cpu",
                       latency_fn=latency_factory(7), parity_controller=ParityController(16))
    jout, _ = _drive(jeng, JaxRequest, prompts, [6])
    tout, _ = _drive(teng, Request, prompts, [6])
    _assert_same(jeng, teng, jout, tout)
    assert tout[0][-1] == eos and len(tout[0]) == 3


def test_parity_raise_on_device_equals_reference():
    """Three persistent stragglers on a budget of 2: after ``topup_patience``
    saturated steps the head is re-encoded to (13, 3), on the device path
    of each package, and the tokens stay those of the reference."""
    cfg, jm, jp, tm, tp = _models("glm4-9b", True, parity=2)

    def latency_fn():
        lat = np.full(16, 1e-3)
        lat[2] = lat[7] = lat[11] = 5e-2
        return lat

    prompts = [np.arange(4 + i) % cfg.vocab for i in range(3)]
    jeng = JaxServeEngine(jm, jp, n_slots=2, s_max=32, latency_fn=latency_fn,
                          parity_controller=JaxParityController(16, decay=0.5),
                          parity_topup=1, topup_patience=2, encode_mode="interpret")
    teng = ServeEngine(tm, tp, n_slots=2, s_max=32, latency_fn=latency_fn,
                       parity_controller=ParityController(16, decay=0.5),
                       parity_topup=1, topup_patience=2, encode_mode="interpret",
                       device="cpu")
    jout, _ = _drive(jeng, JaxRequest, prompts, [6])
    tout, _ = _drive(teng, Request, prompts, [6])
    _assert_same(jeng, teng, jout, tout)
    assert len(teng.parity_events) == 1 and teng.parity_events[0]["n_parity"] == 3
    assert teng.model.cfg.coded_parity == 3 and teng.parity_topup == 0
    np.testing.assert_allclose(teng.params["lm_head_coded"].numpy(),
                               np.asarray(jeng.params["lm_head_coded"]), rtol=1e-5,
                               atol=1e-5 * float(teng.params["lm_head_coded"].abs().max()))
    # the caller's params keep the (14, 2) head
    assert tp["lm_head_coded"].shape[0] == 16 * 37   # ceil(512 / 14) rows a block
    assert teng.params["lm_head_coded"].shape[0] == 16 * 40  # ceil(512 / 13)
    # and the unmasked, unraised engine emits the same tokens
    plain = ServeEngine(tm, tp, n_slots=2, s_max=32, device="cpu")
    pout, _ = _drive(plain, Request, prompts, [6])
    assert pout == tout


def test_engine_refuses_unported_options_and_foreign_devices():
    """A parity policy around another controller is refused, as the
    reference refuses it.  Fused blocks are CUDA graphs on the card, which
    cannot hold ``svd_recovery``'s decode or launches on several cards: the
    engine's capture check refuses a geometry the DecoderCache refuses (now
    or after the allowed raises) and a head mesh over several devices (on
    the CPU the engine runs them, so the check is called directly here;
    ``tests/test_torch_cuda.py`` builds them on the card)."""
    from repro_torch.core.adaptive import DeadlineAwareParity
    from repro_torch.sharding import HeadMesh

    _, _, _, tm, tp = _models("glm4-9b", True)
    with pytest.raises(ValueError, match="different ParityController"):
        ServeEngine(tm, tp, device="cpu", parity_controller=ParityController(16),
                    parity_policy=DeadlineAwareParity(ParityController(16)))
    eng = ServeEngine(tm, tp, device="cpu", macro_steps=4)
    eng._check_capturable()  # (14, 2): cacheable, one device
    eng.parity_topup = 4     # raises up to (10, 6), which the DecoderCache refuses
    with pytest.raises(NotImplementedError, match=r"\(10, 6\) head"):
        eng._check_capturable()
    eng.parity_topup = 0
    eng._mesh = HeadMesh((torch.device("cpu"),) * 15 + (torch.device("meta"),))
    with pytest.raises(NotImplementedError, match="several cards"):
        eng._check_capturable()
    _, _, _, tm6, tp6 = _models("glm4-9b", True, parity=6)
    eng6 = ServeEngine(tm6, tp6, device="cpu", macro_steps=4)
    with pytest.raises(NotImplementedError, match=r"\(10, 6\) head"):
        eng6._check_capturable()
    eng6.head_kernel_mode = "svd"
    with pytest.raises(NotImplementedError, match="svd"):
        eng6._check_capturable()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(tm, tp)
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(tm, tp, device="meta")


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--coded",
           "--device", "cpu", "--requests", "3", "--max-new", "3",
           "--straggler-prob", "0.3"]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[serve] 3 requests, 9 tokens" in res.stdout
    dry = subprocess.run(cmd + ["--dry-run"], env=env, capture_output=True, text=True,
                         timeout=120)
    assert dry.returncode == 0 and "arch=glm4-9b" in dry.stdout, dry.stderr
