"""The comparison that decides ``correct``: the plain fp32 reference agrees
with the port's plain path, and the lower-precision control and faults
planted in the timed path fail it (CPU, smoke sizes)."""
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

BM = json.loads((ROOT / "BENCHMARK.json").read_text())
# a cell kept out of BENCHMARK.json for a fault of the program on the card
# (PERF.md, Open questions); its files still run here at smoke sizes
KEPT_OUT = [{"name": "zamba2-1.2b.longprompt", "config": "zamba2-1.2b",
             "traffic": "longprompt-4k", "chips": 1}]
WORKLOADS = BM["workloads"] + KEPT_OUT
SEED = 2 ** 31 + 11


def smoke_run(name, seed=SEED, **kw):
    import torch

    from portbench import bench

    wl = next(w for w in WORKLOADS if w["name"] == name)
    return bench.run(wl, seed, 1.5, False, device=torch.device("cpu"),
                     t_start=time.monotonic(), smoke=True, clock=bench.TickClock(0.01), **kw)


@pytest.mark.parametrize("config", ["glm4-9b", "zamba2-1.2b"])
def test_reference_matches_port_plain_path(config):
    """At fp32 activations the port's prefill (its plain kernels, the
    coded head under two erasures) and the reference's forward give the
    same logits; its decode steps, which read a bf16 KV cache (and for
    the hybrid a bf16 conv tail) whatever the activation dtype, within a
    bf16 step of the largest logit."""
    import torch

    from portbench import bench, weights
    from portbench.reference.common import Precision, exact_fp32
    from repro_torch.models.registry import build_model

    cfg = bench.load_config(config)
    mc = dataclasses.replace(bench.port_config(cfg, smoke=True), dtype="float32")
    cfg_run = {**cfg, **cfg["smoke"]}
    model = build_model(mc)
    dev = torch.device("cpu")
    params = weights.make(model, 5, dev)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, mc.vocab, 37))
    fed = torch.as_tensor(rng.integers(0, mc.vocab, 6))
    mask = torch.ones(16)
    mask[[3, 12]] = 0.0
    with torch.no_grad():
        logit, cache = model.prefill(params, {"tokens": prompt[None]}, s_max=64, head_mask=mask)
        port = [logit[0]]
        for t in fed[:-1]:
            logit, cache = model.decode_step(params, cache, t[None].to(torch.int32), mask)
            port.append(logit[0])
        port = torch.stack(port)
        with exact_fp32():
            ref = bench.reference_module(cfg_run).served_logits(
                params, cfg_run, prompt, fed, Precision())
    scale = float(ref.abs().max())
    err = (port - ref).abs().amax(dim=1)
    assert float(err[0]) <= 2e-5 * scale
    assert float(err[1:].max()) <= 2 ** -7 * scale


@pytest.mark.parametrize("seed", [SEED, 3, 7])
@pytest.mark.parametrize("cell", ["glm4-9b.chat", "zamba2-1.2b.longprompt",
                                  "glm4-9b.longprompt"])
def test_lower_precision_control_fails(cell, seed):
    """The reference in fp8 where the program holds bf16, put in the
    program's place on the same requests, fails the limit that the
    program's own tokens pass."""
    rec = smoke_run(cell, seed, control=True)
    chk = rec["check"]
    assert chk["correct"] is True
    assert chk["control_max_gap"] > chk["max_gap"]["limit"] >= chk["max_gap"]["value"]


def _alter_token(eng):
    orig = eng._decode
    vocab = eng.model.cfg.vocab

    def decode(*a, **k):
        toks, cache = orig(*a, **k)
        return (toks + 1) % vocab, cache
    eng._decode = decode


def _state_unchanged(eng):
    orig = eng._decode

    def decode(cache, last_tok, mask, *a, **k):
        toks, _ = orig(cache, last_tok, mask, *a, **k)
        return toks, cache
    eng._decode = decode


def _half_batch(eng):
    orig = eng._decode

    def decode(cache, last_tok, *a, **k):
        toks, new = orig(cache, last_tok, *a, **k)
        half = toks.shape[0] // 2
        return torch_cat(toks[:half], last_tok[half:]), new
    eng._decode = decode


def torch_cat(a, b):
    import torch

    return torch.cat([a, b])


@pytest.mark.parametrize("fault", [_alter_token, _state_unchanged, _half_batch])
def test_fault_in_timed_path_fails(fault):
    """A token altered where it is produced, a step that returns its state
    unchanged, half of the batch left undecoded: each comes out not
    correct."""
    rec = smoke_run("glm4-9b.longprompt", fault=fault)
    assert rec["check"]["correct"] is False, rec["check"]
