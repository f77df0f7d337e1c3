"""The port's fused macro-step decode and scheduler-driven engine.

Mirrors ``tests/test_engine_fused.py`` on the port, on float32 SMOKE
configs (phi3-mini-3.8b as the reference's suite uses, and mamba2-130m,
whose Mamba states are carried back into the engine's cache each step).
Within the port, K_max in {2, 4, 16} must be bit-identical to scalar
stepping: tokens, posteriors, parity events, scheduler bookkeeping.  On the
CPU a fused block is a loop of K decode steps with one [K, n_slots] host
copy; on CUDA a captured graph (``tests/test_torch_cuda.py``).

Across packages, with the reference's params carried over by
``params_from_numpy`` and both engines on a clock that advances on every
read, a scheduler-driven engine with deadline parity and a prefill budget
gives the reference's tokens and parity events, and the scheduler's
``results()`` are bit-equal: the port reads the clock where the reference
does, in the same order.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.adaptive import DeadlineAwareParity, ParityController
from repro_torch.models.registry import build_model
from repro_torch.serve import Request, ServeEngine, TraceScheduler, replay_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BLOCKS = 16  # the serving head's block count (models.config.coded_blocks)
K_GRID = [2, 4, 16]
ARCHS = ["phi3-mini-3.8b", "mamba2-130m"]


def _port_model(arch):
    cfg = get_config(arch, smoke=True).scaled(dtype="float32", coded=True, coded_parity=2)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def models():
    return {arch: _port_model(arch) for arch in ARCHS}


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


class TickClock:
    """A clock that advances on every read, so decode intervals are
    non-zero and every extra or missing read shows in the results."""

    def __init__(self, tick=0.1):
        self.now = 0.0
        self.tick = tick
        self.reads = 0

    def __call__(self):
        self.reads += 1
        self.now += self.tick
        return self.now


def _mk_latency(seed: int, straggler_p: float = 0.25):
    """A deterministic shard-latency stream, fresh per engine run."""
    state = np.random.default_rng(seed)

    def latency_fn():
        lat = 1e-3 * (1.0 + 0.1 * state.random(N_BLOCKS))
        lat[state.random(N_BLOCKS) < straggler_p] *= 400.0
        return lat

    return latency_fn


def _persistent_latency():
    """Three persistent stragglers (more than the budget of 2)."""
    def latency_fn():
        lat = np.full(N_BLOCKS, 1e-3)
        lat[[2, 5, 9]] = 0.5
        return lat

    return latency_fn


def _queue_wave(model_entry, k, *, n_slots=4, max_new=18, seed=7, eos_token=None,
                with_ctrl=False, lat_seed=None, topup=0, patience=4):
    cfg, model, params = model_entry
    ctrl = ParityController(N_BLOCKS) if with_ctrl else None
    eng = ServeEngine(
        model, params, n_slots=n_slots, s_max=64, macro_steps=k, eos_token=eos_token,
        latency_fn=(_persistent_latency() if topup else _mk_latency(lat_seed))
        if lat_seed is not None or topup else None,
        parity_controller=ctrl, parity_topup=topup, topup_patience=patience, device="cpu",
    )
    rng = np.random.default_rng(seed)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 6).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n_slots)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=5000)
    return {
        "tokens": {r.uid: list(r.out_tokens) for r in reqs},
        "posterior": None if ctrl is None else ctrl.posterior.copy(),
        "events": [{f: e[f] for f in ("step", "n_parity")} for e in eng.parity_events],
        "parity": eng.model.cfg.coded_parity,
        "syncs": eng.sync_count,
        "blocks": eng.macro_blocks,
        "steps": eng._steps,
    }


# --------------------------------------------------------------------------
# batch-full steady state
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", K_GRID)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_full_bit_identical(models, arch, k):
    ref = _queue_wave(models[arch], 1)
    got = _queue_wave(models[arch], k)
    assert got["tokens"] == ref["tokens"]
    assert got["steps"] == ref["steps"]
    assert got["blocks"] > 0
    assert got["syncs"] < ref["syncs"]


@pytest.mark.parametrize("k", K_GRID)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_full_controller_bit_identical(models, arch, k):
    ref = _queue_wave(models[arch], 1, with_ctrl=True, lat_seed=11)
    got = _queue_wave(models[arch], k, with_ctrl=True, lat_seed=11)
    assert got["tokens"] == ref["tokens"]
    np.testing.assert_array_equal(got["posterior"], ref["posterior"])


# --------------------------------------------------------------------------
# EOS mid-block: early drain + control rollback
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", K_GRID)
@pytest.mark.parametrize("arch", ARCHS)
def test_eos_mid_block_bit_identical(models, arch, k):
    probe = _queue_wave(models[arch], 1, with_ctrl=True, lat_seed=13)
    eos = probe["tokens"][0][5]
    ref = _queue_wave(models[arch], 1, eos_token=eos, with_ctrl=True, lat_seed=13)
    got = _queue_wave(models[arch], k, eos_token=eos, with_ctrl=True, lat_seed=13)
    assert got["tokens"] == ref["tokens"]
    np.testing.assert_array_equal(got["posterior"], ref["posterior"])
    assert any(len(t) < 18 for t in ref["tokens"].values())


# --------------------------------------------------------------------------
# parity raise mid-stream
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", K_GRID)
@pytest.mark.parametrize("arch", ARCHS)
def test_parity_raise_bit_identical(models, arch, k):
    ref = _queue_wave(models[arch], 1, with_ctrl=True, topup=1, patience=3)
    got = _queue_wave(models[arch], k, with_ctrl=True, topup=1, patience=3)
    assert ref["events"], "scenario must actually raise parity"
    assert got["events"] == ref["events"]
    assert got["parity"] == ref["parity"] == 3
    assert got["tokens"] == ref["tokens"]
    np.testing.assert_array_equal(got["posterior"], ref["posterior"])


@pytest.mark.parametrize("arch", ARCHS)
def test_degrade_path_replays_through_old_decode(models, arch):
    """A raise MID-BLOCK truncates the fused block: the pre-raise steps
    decode through the OLD model and params, the post-raise control
    decision is stashed for the next scalar step.  The K gate keeps blocks
    away from the boundary, so the branch is driven directly."""
    cfg, model, params = models[arch]

    def build(k):
        eng = ServeEngine(model, params, n_slots=4, s_max=64, macro_steps=k,
                          latency_fn=_persistent_latency(),
                          parity_controller=ParityController(N_BLOCKS),
                          parity_topup=1, topup_patience=3, device="cpu")
        rng = np.random.default_rng(21)
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 6).astype(np.int32),
                        max_new_tokens=18) for i in range(4)]
        for r in reqs:
            eng.submit(r)
        return eng, reqs

    ref_eng, ref_reqs = build(1)
    ref_eng.run(max_steps=5000)
    assert len(ref_eng.parity_events) == 1

    eng, reqs = build(16)
    while eng._saturated_steps != 1:
        assert eng.step() > 0
    events0, steps0 = len(eng.parity_events), eng._steps
    old_head = eng.params["lm_head_coded"]
    assert eng._fused_block(4) > 0
    assert len(eng.parity_events) == events0 + 1   # raised mid-block
    assert eng._pending_ctrl is not None           # post-raise ctrl stashed
    assert eng._steps == steps0 + 1                # ONE pre-raise step decoded
    assert eng.macro_blocks == 0                   # ... scalar-wise
    assert eng.model.cfg.coded_parity == 3
    assert eng.params["lm_head_coded"].shape[0] > old_head.shape[0]
    eng.run(max_steps=5000)
    assert {r.uid: list(r.out_tokens) for r in reqs} == \
        {r.uid: list(r.out_tokens) for r in ref_reqs}
    assert [e["step"] for e in eng.parity_events] == [e["step"] for e in ref_eng.parity_events]


# --------------------------------------------------------------------------
# scheduler-driven: queue pressure keeps the gate reactive
# --------------------------------------------------------------------------
def _sched_run(model_entry, k, t_arrival, n_tokens):
    cfg, model, params = model_entry
    rng = np.random.default_rng(3)
    trace = replay_trace(t_arrival, n_tokens, t_token=0.5, slo_factor=8.0, queue_grace=20.0)
    payloads = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 6).astype(np.int32),
                        max_new_tokens=int(n_tokens[i])) for i in range(len(n_tokens))]
    sched = TraceScheduler(trace, 2, t_step_init=0.5, payloads=payloads)
    clock = FakeClock()
    eng = ServeEngine(model, params, n_slots=2, s_max=32, scheduler=sched, clock=clock,
                      macro_steps=k, device="cpu")
    for _ in range(500):
        if sched.finished:
            break
        if eng.macro_step():
            clock.now += 0.5
        else:
            nxt = sched.next_arrival()
            if nxt is None:
                break
            clock.now = max(clock.now, nxt)
    assert sched.finished
    res = sched.results()
    return ({r.uid: list(r.out_tokens) for r in eng.completed},
            {f: np.asarray(res[f]).tolist() for f in res}, eng.macro_blocks)


@pytest.mark.parametrize("k", [4, 16])
def test_scheduler_queue_pressure_holds_scalar(models, k):
    t_arrival = np.arange(7) * 0.4
    n_tokens = np.array([5, 5, 5, 5, 5, 5, 1])
    ref_toks, ref_res, _ = _sched_run(models["phi3-mini-3.8b"], 1, t_arrival, n_tokens)
    toks, res, blocks = _sched_run(models["phi3-mini-3.8b"], k, t_arrival, n_tokens)
    assert toks == ref_toks
    assert res == ref_res
    assert blocks == 0


@pytest.mark.parametrize("k", [4, 16])
def test_scheduler_steady_state_fuses(models, k):
    t_arrival = np.array([0.0, 0.0, 6.0, 10.0])
    n_tokens = np.array([8, 8, 6, 12])
    ref_toks, ref_res, _ = _sched_run(models["phi3-mini-3.8b"], 1, t_arrival, n_tokens)
    toks, res, blocks = _sched_run(models["phi3-mini-3.8b"], k, t_arrival, n_tokens)
    assert toks == ref_toks
    assert blocks > 0
    assert res["slo_met"] == ref_res["slo_met"]
    assert res["rejected"] == ref_res["rejected"]


def test_choose_k_gates(models):
    cfg, model, params = models["phi3-mini-3.8b"]
    eng = ServeEngine(model, params, n_slots=2, s_max=32, macro_steps=16, device="cpu")
    rng = np.random.default_rng(5)
    for i, max_new in enumerate((5, 20, 20)):  # the third admits beside the second
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, 4).astype(np.int32),
                           max_new_tokens=max_new))
    assert eng._choose_k() == (1, "idle")   # nothing active yet
    eng.step()                            # admits 2 of 3
    assert eng.queue and eng._choose_k() == (1, "queue")   # queue pressure
    while eng.queue or (eng._active.any() and not eng._active.all()):
        eng.step()
    assert eng._active.all()
    k, why = eng._choose_k()
    assert k & (k - 1) == 0 and 1 < k <= 16 and why is None
    # capped at the longest remaining budget, quantised down
    rem = max(r.max_new_tokens - len(r.out_tokens) for r in eng.slots)
    assert k <= rem < 2 * k or k == 16
    eng.run(max_steps=500)
    assert eng._choose_k() == (1, "idle")   # drained


# --------------------------------------------------------------------------
# counters: sync economics, batched splices, first-call exclusion
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_sync_reduction_at_k16(models, arch):
    ref = _queue_wave(models[arch], 1, max_new=34)
    got = _queue_wave(models[arch], 16, max_new=34)
    assert got["tokens"] == ref["tokens"]
    assert ref["syncs"] / got["syncs"] >= 4.0


def test_refill_pass_splices_once(models):
    cfg, model, params = models["phi3-mini-3.8b"]
    eng = ServeEngine(model, params, n_slots=4, s_max=32, device="cpu")
    rng = np.random.default_rng(9)
    for i in range(4):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, 6).astype(np.int32),
                           max_new_tokens=4))
    eng.step()
    assert eng.splice_rebuilds == 1
    assert eng._active.all()


def test_per_bucket_first_call_exclusion(models):
    """The first call of EVERY bucket since the bind is left out of the
    step-time estimate: scalar step (excluded) -> first 4-block (excluded)
    -> second 4-block (observed, the estimate moves)."""
    cfg, model, params = models["phi3-mini-3.8b"]
    rng = np.random.default_rng(17)
    n_tokens = np.array([12, 12])
    trace = replay_trace(np.zeros(2), n_tokens, t_token=0.5, slo_factor=50.0,
                         queue_grace=50.0)
    payloads = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 4).astype(np.int32),
                        max_new_tokens=12) for i in range(2)]
    sched = TraceScheduler(trace, 2, t_step_init=0.5, payloads=payloads)
    eng = ServeEngine(model, params, n_slots=2, s_max=32, scheduler=sched,
                      clock=TickClock(), macro_steps=4, device="cpu")
    est0 = sched.est_step_time
    seen_blocks = 0
    for _ in range(100):
        if sched.finished:
            break
        before = sched.est_step_time
        b0 = eng.macro_blocks
        eng.macro_step()
        if eng.macro_blocks > b0:
            seen_blocks += 1
            if seen_blocks == 1:
                assert sched.est_step_time == before == est0
            elif seen_blocks == 2:
                assert sched.est_step_time != before
                break
    assert seen_blocks == 2
    assert ("decode", 1) in eng._compiled and ("decode", 4) in eng._compiled


# --------------------------------------------------------------------------
# the engine's cache: persistent leaves, the conv leaf's dtype
# --------------------------------------------------------------------------
def _leaves(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v, name)
    else:
        yield name, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_leaves_keep_their_tensors(models, arch):
    """Steps, fused blocks and splices write into the cache the engine made
    at build time (a captured graph reads fixed addresses); the conv leaf
    holds the activation dtype, which a bf16 prefill tail widens into
    exactly."""
    cfg, model, params = models[arch]
    eng = ServeEngine(model, params, n_slots=2, s_max=48, macro_steps=4, device="cpu")
    ptrs = [(n, t.data_ptr()) for n, t in _leaves(eng.cache)]
    lt_ptr = eng._last_tok.data_ptr()
    rng = np.random.default_rng(4)
    for i in range(4):  # two waves; the second fuses
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, 3 + i).astype(np.int32),
                           max_new_tokens=9))
    eng.run()
    assert eng.macro_blocks > 0 and eng.splice_rebuilds == 2
    assert [(n, t.data_ptr()) for n, t in _leaves(eng.cache)] == ptrs
    assert eng._last_tok.data_ptr() == lt_ptr
    convs = [t for n, t in _leaves(eng.cache) if n == "conv"]
    assert all(t.dtype == torch.float32 for t in convs)
    assert bool(convs) == (cfg.family != "dense")


# --------------------------------------------------------------------------
# across packages: the scheduler-driven engine on a ticking clock
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def carried():
    from repro.configs import get_config as jax_config
    from repro.models.registry import build_model as jax_build
    from repro_torch.weights import params_from_numpy

    jcfg = jax_config("phi3-mini-3.8b", smoke=True).scaled(dtype="float32", coded=True,
                                                           coded_parity=2)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, _port_model("phi3-mini-3.8b")[1], tp


def _trace_engine_run(pkg, carried, macro_steps):
    """One scheduler-driven run: 8 arrivals in two waves, deadline parity
    over a straggling latency stream, a prefill budget of one prompt, a
    ticking clock, the launcher's drive loop."""
    jcfg, jm, jp, tm, tp = carried
    if pkg == "jax":
        from repro.core.adaptive import DeadlineAwareParity as DAP
        from repro.core.adaptive import ParityController as PC
        from repro.serve import Request as Req
        from repro.serve import ServeEngine as Eng
        from repro.serve import TraceScheduler as Sched
        from repro.serve import replay_trace as replay
        model, params, kw = jm, jp, {}
    else:
        DAP, PC, Req, Eng = DeadlineAwareParity, ParityController, Request, ServeEngine
        Sched, replay = TraceScheduler, replay_trace
        model, params, kw = tm, tp, {"device": "cpu"}
    rng = np.random.default_rng(31)
    t_arrival = np.array([0.0, 0.0, 0.2, 0.3, 9.0, 9.0, 9.1, 9.5])
    n_tokens = np.array([14, 9, 12, 1, 16, 7, 16, 11])
    trace = replay(t_arrival, n_tokens, t_token=0.5, slo_factor=1.0, queue_grace=0.5)
    payloads = [Req(uid=i, prompt=rng.integers(0, jcfg.vocab, 4 + i % 3).astype(np.int32),
                    max_new_tokens=int(n_tokens[i])) for i in range(len(n_tokens))]
    sched = Sched(trace, 4, t_step_init=0.5, payloads=payloads)
    policy = DAP(PC(N_BLOCKS))
    clock = TickClock()
    eng = Eng(model, params, n_slots=4, s_max=40, latency_fn=_mk_latency(5, 0.15),
              parity_policy=policy, scheduler=sched, clock=clock, prefill_budget=5,
              macro_steps=macro_steps, **kw)
    for _ in range(1000):
        if sched.finished:
            break
        if eng.macro_step() == 0:
            nxt = sched.next_arrival()
            if nxt is None:
                break
            clock.now = max(clock.now, nxt)
    assert sched.finished
    res = sched.results()
    return {
        "tokens": {r.uid: list(r.out_tokens) for r in eng.completed},
        "order": [r.uid for r in eng.completed],
        "results": {f: np.asarray(res[f]) for f in res},
        "posterior": policy.controller.posterior.copy(),
        "events": eng.parity_events, "syncs": eng.sync_count, "blocks": eng.macro_blocks,
        "reads": clock.reads, "est": sched.est_step_time,
    }


@pytest.mark.parametrize("macro_steps", [1, 4])
def test_scheduler_engine_equals_reference(carried, macro_steps):
    ref = _trace_engine_run("jax", carried, macro_steps)
    got = _trace_engine_run("torch", carried, macro_steps)
    assert got["tokens"] == ref["tokens"]
    assert got["order"] == ref["order"]
    assert got["events"] == ref["events"]
    assert got["reads"] == ref["reads"]
    assert got["syncs"] == ref["syncs"] and got["blocks"] == ref["blocks"]
    assert got["est"] == ref["est"]
    np.testing.assert_array_equal(got["posterior"], ref["posterior"])
    assert got["results"].keys() == ref["results"].keys()
    for f in ref["results"]:
        assert np.array_equal(got["results"][f], ref["results"][f], equal_nan=True), f
    # the run rejected at admission and completed requests
    assert ref["results"]["rejected"].sum() >= 1
    assert np.isfinite(ref["results"]["t_complete"]).sum() >= 4
    if macro_steps > 1:
        assert got["blocks"] > 0


def test_parity_policy_must_wrap_the_controller(models):
    _, model, params = models["phi3-mini-3.8b"]
    with pytest.raises(ValueError, match="different ParityController"):
        ServeEngine(model, params, device="cpu", parity_controller=ParityController(16),
                    parity_policy=DeadlineAwareParity(ParityController(16)))
    pol = DeadlineAwareParity(ParityController(16))
    eng = ServeEngine(model, params, device="cpu", parity_policy=pol)
    assert eng.parity_controller is pol.controller
    with pytest.raises(ValueError, match="macro_steps"):
        ServeEngine(model, params, device="cpu", macro_steps=0)


def test_launcher_trace_mode_with_macro_steps_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--coded",
           "--device", "cpu", "--straggler-prob", "0.25", "--adaptive-parity",
           "--trace", "poisson", "--rate", "4", "--requests", "6", "--max-new", "8",
           "--deadline-parity", "--slo-factor", "40", "--t-token-est", "0.3",
           "--macro-steps", "4"]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[serve] trace=poisson 6 requests" in res.stdout
    assert "SLO attainment" in res.stdout and "rejected" in res.stdout
    assert "est_step" in res.stdout and "deadline_parity=True" in res.stdout
    assert "macro_steps=4" in res.stdout and "host_syncs/token=" in res.stdout
    assert "choose_k: " in res.stdout and "kv_in_use=" in res.stdout
    assert "span engine.macro_step: " in res.stdout and "attr engine.macro_step k: " in res.stdout
    dry = subprocess.run(cmd + ["--dry-run"], env=env, capture_output=True, text=True,
                         timeout=120)
    assert dry.returncode == 0, dry.stderr
    assert "traffic: trace=poisson rate=4.0/s" in dry.stdout
    assert "macro_steps=4" in dry.stdout
    bad = subprocess.run(cmd[:-2] + ["--macro-steps", "0"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert bad.returncode != 0 and "--macro-steps must be >= 1" in bad.stderr


# a captured graph's DOT text as CUDA 12.8 writes it on the H100 (one
# coded_matvec_decode, one coded_matvec and one argmax node; a node's
# accessPolicyWindow, cooperative and priority rows cut)
_GRAPH_DOT = r'''digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 2) | _ZN9thin_rows16thin_rows_kernelIN48_GLOBAL__N__010dd0cb_15_coded_decode_cu_e788c52410DecodeTaskELi2ELi2ELb1EEEvT_NS_8GeometryE\<\<\<16,512,1952\>\>\>}
| {{node handle | func handle} | {0x0000000009CFB620 | 0x00000000098D3C30}}
}"];

"graph_1_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 1) | _ZN9thin_rows16thin_rows_kernelIN48_GLOBAL__N__b74fef15_15_coded_matvec_cu_d8662a0510MatvecTaskIfEELi2ELi2ELb1EEEvT_NS_8GeometryE\<\<\<132,512,512\>\>\>}
| {{node handle | func handle} | {0x0000000009CFBD88 | 0x0000000009A7C400}}
}"];

"graph_1_node_2"[style="bold" shape="record" label="{KERNEL
| {ID | 2 (topoId: 0) | _ZN2at6native13reduce_kernelILi256ELi2ENS0_8ReduceOpIfNS0_9ArgMaxOpsIfEEjlLi4ELi4EEEEEvT1_\<\<\<1,\{1,256\},8192\>\>\>}
| {{node handle | func handle} | {0x0000000009CFC4F0 | 0x0000000009DCC8E0}}
}"];

"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];
"graph_1_node_1" -> "graph_1_node_2" [headlabel=0];
}
}
'''


def test_graph_kernel_nodes_are_counted_from_the_graphs_dot_text():
    """A replay's launches are the captured graph's kernel nodes of each
    hand-written kernel: one a node, whatever else the graph holds, edges
    and a symbol named twice in one label included."""
    from repro_torch.kernels import count_kernel_nodes, kernel_wrappers

    want = dict.fromkeys(kernel_wrappers(), 0)
    assert count_kernel_nodes(_GRAPH_DOT) == dict(want, coded_matvec=1, coded_matvec_decode=1)
    twice = _GRAPH_DOT.replace("\\<\\<\\<16,512", " DecodeTask \\<\\<\\<16,512")
    assert count_kernel_nodes(twice)["coded_matvec_decode"] == 1
    node = _GRAPH_DOT[_GRAPH_DOT.index('"graph_1_node_0"['):_GRAPH_DOT.index('"graph_1_node_1"[')]
    four = _GRAPH_DOT.replace(node, "".join(node.replace("node_0", f"node_{9 + i}")
                                            for i in range(4)))
    assert count_kernel_nodes(four)["coded_matvec_decode"] == 4
    with pytest.raises(ValueError, match="no graph node"):
        count_kernel_nodes("digraph dot {\n}\n")
