"""The port's traffic layer against the reference, on the same seeds.

``repro_torch.serve.loadgen``, ``repro_torch.serve.scheduler`` and
``repro_torch.runtime.health`` are numpy copies of the reference's modules;
mirroring ``tests/test_serve_traffic.py`` and ``tests/test_serve_batch.py``,
their traces, admission, WFQ order, slack, ``simulate_serve`` and
``simulate_serve_batch`` must be ``np.array_equal`` to the reference's, and
both committed golden fixtures must apply to the port unchanged.  So must
``core.decoding.peel_decode_plan``.  The engine's prefill/decode seams
(a one-token request, EOS at prefill, the prefill budget) are held on a
tiny port model.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core.decoding import peel_decode_plan as jax_peel_decode_plan
from repro.runtime.health import HealthMonitor as JaxHealthMonitor
from repro.serve import loadgen as jlg
from repro.serve import scheduler as jsc
from repro_torch.core import adaptive as tad
from repro_torch.core.decoding import peel_decode_plan
from repro_torch.core.encoding import LTCode
from repro_torch.runtime import HealthMonitor
from repro_torch.serve import loadgen as tlg
from repro_torch.serve import scheduler as tsc

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _classes(lg):
    return (
        lg.SLOClass(name="prem", weight=3.0, slo_factor=6.0, queue_grace=40.0,
                    share=0.3, escalate_steps=16.0),
        lg.SLOClass(name="std", weight=1.0, slo_factor=3.0, queue_grace=20.0,
                    share=0.7, escalate_steps=4.0),
    )


def _inj(sc, kind):
    return {"hot": sc.StragglerInjection(onset=0.002, slow_factor=50.0, persistence=150.0),
            "noise": sc.StragglerInjection(onset=0.0, noise=0.25), None: None}[kind]


TRACE_FIELDS = ("t_arrival", "n_tokens", "deadline", "n_prefill", "tenant")


def _trace(lg, kind, seed, tenants):
    kw = dict(seed=seed, mean_tokens=12.0, max_tokens=40)
    if tenants:
        kw.update(classes=_classes(lg), mean_prefill=16.0)
    mk = lg.poisson_trace if kind == "poisson" else lg.bursty_trace
    return mk(0.3, 150, **kw)


def assert_trace_equal(a, b):
    for f in TRACE_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.kind == b.kind
    assert [c.__dict__ for c in a.classes] == [c.__dict__ for c in b.classes]


# --------------------------------------------------------------------------
# load generation
# --------------------------------------------------------------------------
@pytest.mark.parametrize("tenants", [False, True])
@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_traces_equal_reference(kind, seed, tenants):
    assert_trace_equal(_trace(tlg, kind, seed, tenants), _trace(jlg, kind, seed, tenants))


def test_replay_trace_equals_reference_and_validates():
    t = np.array([0.0, 1.0, 2.5])
    n = np.array([4, 2, 8])
    kw = dict(t_token=1.0, slo_factor=3.0, queue_grace=10.0)
    assert_trace_equal(tlg.replay_trace(t, n, **kw), jlg.replay_trace(t, n, **kw))
    tenant = np.array([1, 0, 1])
    assert_trace_equal(
        tlg.replay_trace(t, n, classes=_classes(tlg), tenant=tenant, n_prefill=n * 3),
        jlg.replay_trace(t, n, classes=_classes(jlg), tenant=tenant, n_prefill=n * 3))
    for bad in (dict(t_arrival=t[::-1].copy(), n_tokens=n),
                dict(t_arrival=t, n_tokens=np.zeros(3, np.int64)),
                dict(t_arrival=t, n_tokens=n, deadline=t)):
        with pytest.raises(ValueError):
            tlg.replay_trace(**bad)


# --------------------------------------------------------------------------
# the scheduler, driven step by step in both packages
# --------------------------------------------------------------------------
def _drive_scheduler(lg, sc, seed, n_slots, tenants, admission):
    trace = _trace(lg, "bursty" if tenants else "poisson", seed, tenants)
    sched = sc.TraceScheduler(trace, n_slots, t_step_init=1.0, admission=admission)
    rng = np.random.default_rng(seed)
    t, log = 0.0, []
    for _ in range(5000):
        if sched.finished:
            break
        admitted = sched.admit(t, int(rng.integers(1, n_slots + 1)))
        log.append(("admit", t, [r.idx for r in admitted]))
        assert sched.n_active <= n_slots
        if sched.n_active == 0:
            nxt = sched.next_arrival()
            if nxt is None:
                break
            t = max(t, nxt)
            continue
        log.append(("slack", sched.min_slack_steps(t), sched.class_slack_steps(t).tolist(),
                    sched.pending(t), sched.has_prefill_debt))
        _, prefilled = sched.consume_prefill(int(rng.integers(0, 24)))
        log.append(("prefill", prefilled))
        dt = float(rng.uniform(0.2, 3.0))
        t += dt
        sched.observe_step(dt)
        for idx in sched.decode_ready():
            if rng.random() < 0.02:
                sched.on_finish(idx, t)     # an engine-side EOS
            else:
                sched.on_token(idx, t)
        log.append(("est", sched.est_step_time))
    return log, sched.results()


@pytest.mark.parametrize("admission", ["deadline", "all"])
@pytest.mark.parametrize("tenants", [False, True])
@pytest.mark.parametrize("seed,n_slots", [(1, 3), (7, 8)])
def test_scheduler_equals_reference(seed, n_slots, tenants, admission):
    """Admissions (with WFQ order over classes), rejections, slack, prefill
    debt and the step-time estimate, step for step; then ``results()``."""
    tlog, tres = _drive_scheduler(tlg, tsc, seed, n_slots, tenants, admission)
    jlog, jres = _drive_scheduler(jlg, jsc, seed, n_slots, tenants, admission)
    assert tlog == jlog
    assert tres.keys() == jres.keys()
    for f in jres:
        assert np.array_equal(tres[f], jres[f], equal_nan=True), f
    if admission == "deadline":
        assert jres["rejected"].any() or jres["slo_met"].all()


def test_wfq_admission_order_equals_reference():
    rng = np.random.default_rng(3)
    w = rng.uniform(0.2, 5.0, 3)
    n_req = 90
    tenant = rng.integers(0, 3, n_req)
    orders = []
    for lg, sc in ((tlg, tsc), (jlg, jsc)):
        classes = tuple(lg.SLOClass(name=f"c{c}", weight=float(w[c])) for c in range(3))
        trace = lg.replay_trace(np.zeros(n_req), np.ones(n_req, np.int64), classes=classes,
                                tenant=tenant)
        sched = sc.TraceScheduler(trace, n_slots=n_req, admission="all")
        orders.append([sched.admit(0.0, 1)[0].idx for _ in range(n_req)])
    assert orders[0] == orders[1]
    assert sorted(orders[0]) == list(range(n_req))


# --------------------------------------------------------------------------
# simulators
# --------------------------------------------------------------------------
SIM_FIELDS = ("t_complete", "t_admit", "slo_met", "rejected", "step_times", "step_tokens",
              "parity_levels", "step_prefill", "tenant", "class_attainment", "class_max_wait")
SIM_SCALARS = ("topups", "makespan", "attainment", "goodput", "throughput", "occupancy")

# (trace kind, tenants, injection, extra simulate_serve kwargs)
SIM_GRID = [
    ("poisson", False, None, {}),
    ("poisson", False, "hot", {}),
    ("poisson", False, "noise", {"admission": "all"}),
    ("bursty", True, "hot", {"tenant_parity": True}),
    ("bursty", True, "hot", {"step_budget": 24, "n_slots": 6}),
]


def assert_sim_equal(a, b, ctx=""):
    for f in SIM_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True), f"{ctx}: {f}"
    for f in SIM_SCALARS:
        assert getattr(a, f) == getattr(b, f), f"{ctx}: {f}"


@pytest.mark.parametrize("policy", ["uncoded", "fixed", "adaptive"])
@pytest.mark.parametrize("cell", range(len(SIM_GRID)), ids=lambda i: f"cell{i}")
def test_simulate_serve_equals_reference(policy, cell):
    kind, tenants, inj, kw = SIM_GRID[cell]
    got = tsc.simulate_serve(_trace(tlg, kind, 3, tenants), policy, injection=_inj(tsc, inj),
                             seed=11, **kw)
    want = jsc.simulate_serve(_trace(jlg, kind, 3, tenants), policy, injection=_inj(jsc, inj),
                              seed=11, **kw)
    assert_sim_equal(got, want, f"{policy}/cell{cell}")


@pytest.mark.parametrize("policy", ["fixed", "adaptive"])
@pytest.mark.parametrize("cell", [1, 3, 4], ids=lambda i: f"cell{i}")
def test_simulate_serve_batch_equals_reference(policy, cell):
    kind, tenants, inj, kw = SIM_GRID[cell]
    got = tsc.simulate_serve_batch(_trace(tlg, kind, 5, tenants), policy, n_trials=3,
                                   injection=_inj(tsc, inj), seed0=7, **kw)
    want = jsc.simulate_serve_batch(_trace(jlg, kind, 5, tenants), policy, n_trials=3,
                                    injection=_inj(jsc, inj), seed0=7, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert_sim_equal(a, b, f"{policy}/cell{cell}/trial{i}")
    # and each batched trial is the scalar oracle's run
    one = tsc.simulate_serve(_trace(tlg, kind, 5, tenants), policy, injection=_inj(tsc, inj),
                             seed=8, **kw)
    assert_sim_equal(got[1], one, "batch vs scalar")


def test_shard_latency_model_equals_reference():
    draws = []
    for sc in (tsc, jsc):
        m = sc.ShardLatencyModel(16, 0.5, _inj(sc, "hot"), seed=2)
        draws.append(np.stack([m.step() for _ in range(300)]))
    assert np.array_equal(draws[0], draws[1])


def test_golden_serve_trace_fixture():
    """The reference's committed trace fixture, applied to the port as it is."""
    with open(os.path.join(FIXTURES, "golden_serve_trace.json")) as f:
        g = json.load(f)
    trace = tlg.poisson_trace(g["rate"], g["n_requests"], seed=g["trace_seed"],
                              mean_tokens=g["mean_tokens"], max_tokens=g["max_tokens"])
    r = tsc.simulate_serve(trace, g["policy"], injection=tsc.StragglerInjection(**g["injection"]),
                           seed=g["inj_seed"])
    got = np.where(np.isfinite(r.t_complete), r.t_complete, -1.0)
    np.testing.assert_allclose(got, np.asarray(g["t_complete"]), rtol=0, atol=1e-9)
    assert r.topups == g["topups"]
    assert round(r.attainment, 9) == g["attainment"]


def test_golden_serve_batch_fixture():
    """The reference's committed trial-batched fixture, applied to the port."""
    with open(os.path.join(FIXTURES, "golden_serve_batch.json")) as f:
        spec = json.load(f)
    classes = tuple(tlg.SLOClass(**c) for c in spec["classes"])
    trace = tlg.bursty_trace(
        spec["rate"], spec["n_requests"], seed=spec["trace_seed"],
        mean_tokens=spec["mean_tokens"], max_tokens=spec["max_tokens"], classes=classes,
        mean_prefill=spec["mean_prefill"], max_prefill=spec["max_prefill"])
    results = tsc.simulate_serve_batch(
        trace, spec["policy"], n_trials=spec["n_trials"],
        injection=tsc.StragglerInjection(**spec["injection"]), seed0=spec["seed0"],
        tenant_parity=spec["tenant_parity"])
    for i, (r, want) in enumerate(zip(results, spec["trials"])):
        got_tc = [float(t) if np.isfinite(t) else -1.0 for t in r.t_complete]
        np.testing.assert_allclose(got_tc, want["t_complete"], atol=1e-9, err_msg=f"trial {i}")
        assert r.topups == want["topups"]
        assert r.attainment == pytest.approx(want["attainment"], abs=1e-9)
        np.testing.assert_allclose(r.class_attainment, want["class_attainment"], atol=1e-9)
        assert r.occupancy == pytest.approx(want["occupancy"], abs=1e-9)
        assert int(r.step_prefill.sum()) == want["prefill_tokens"]


# --------------------------------------------------------------------------
# the deadline-aware parity rule through the port's scheduler's slack
# --------------------------------------------------------------------------
@pytest.mark.parametrize("tenant", [False, True])
def test_deadline_parity_levels_equal_reference(tenant):
    levels = []
    for ad, lg in ((tad, tlg), (jad, jlg)):
        r = np.random.default_rng(9)
        # cheap-spike priors, so a calm stretch relaxes and slack decides
        cheap = dict(onset_prior=1e-4, spike_prior=2.0)
        pol = (ad.TenantDeadlineParity(ad.ParityController(16), classes=_classes(lg), **cheap)
               if tenant else ad.DeadlineAwareParity(ad.ParityController(16), **cheap))
        out = []
        for step in range(200):  # calm, a straggling burst, calm
            lat = 1e-3 * (1.0 + 0.1 * r.random(16))
            lat[r.random(16) < (0.3 if 100 <= step < 103 else 0.0)] *= 40.0
            pol.observe(lat)
            slack = r.uniform(-5, 40, 2) if tenant else float(r.uniform(-5, 40))
            out.append((pol.level(4, slack), pol.calm))
        levels.append(out)
    assert levels[0] == levels[1]
    assert len({lv for lv, _ in levels[0]}) > 1


# --------------------------------------------------------------------------
# HealthMonitor and peel_decode_plan
# --------------------------------------------------------------------------
def test_health_monitor_equals_reference():
    rng = np.random.default_rng(29)
    block = rng.random((7, 8)) + 1e-3
    block[0, 3] = np.inf
    block[4, :] = np.inf
    secs = 0.01 * (1 + np.arange(8))[:, None] * (1 + 0.1 * np.arange(5)) + 1e-3 * rng.random((8, 5))
    mons = [HealthMonitor(8), JaxHealthMonitor(8)]
    for mon in mons:
        assert np.array_equal(mon.shard_latencies(), np.ones(8))
        for row in block[:3]:
            mon.observe_step_latencies(row)
        mon.observe_step_latencies(block[3:])   # a fused block's [K, n] rows
        for w in range(8):
            for k in range(5):
                mon.record(w, 100.0, float(secs[w, k]))
    a, b = mons
    assert np.array_equal(a.shard_latencies(), b.shard_latencies())
    assert np.array_equal(a.mean_rates(), b.mean_rates())
    assert np.array_equal(a.straggler_mask(), b.straggler_mask())
    assert np.array_equal(a.microbatch_weights(), b.microbatch_weights())
    assert np.array_equal(a.reallocate(1000).loads, b.reallocate(1000).loads)
    with pytest.raises(ValueError):
        a.observe_step_latencies(np.ones(5))


def test_peel_decode_plan_equals_reference():
    from repro.core.encoding import LTCode as JaxLTCode

    r, m = 60, 3
    rng = np.random.default_rng(0)
    a = rng.standard_normal((r, m))
    plan, jplan = LTCode(r, seed=1).plan(120), JaxLTCode(r, seed=1).plan(120)
    assert np.array_equal(plan.indices, jplan.indices)
    assert np.array_equal(plan.coeffs, jplan.coeffs)
    coded = np.zeros((120, m))
    for j in range(120):
        coded[j] = (plan.coeffs[j][:, None] * a[plan.indices[j]]).sum(0)
    received = rng.random(120) < 0.9
    y, ok, nrec = peel_decode_plan(coded, plan, received)
    jy, jok, jnrec = jax_peel_decode_plan(coded, jplan, received)
    assert np.array_equal(y, jy) and ok == jok and nrec == jnrec
    if ok:
        np.testing.assert_allclose(y, a, atol=1e-8)


# --------------------------------------------------------------------------
# the engine's prefill/decode seams (tiny port model, CPU)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_model():
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.registry import build_model

    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
                      n_kv_heads=2, d_ff=64, vocab=64)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


def test_engine_queue_one_token_request_emits_exactly_one(tiny_model):
    from repro_torch.serve import Request, ServeEngine

    cfg, model, params = tiny_model
    eng = ServeEngine(model, params, n_slots=2, s_max=32, device="cpu")
    for i in range(4):
        eng.submit(Request(uid=i, prompt=np.arange(3 + i) % 64, max_new_tokens=1))
    done = eng.run()
    assert len(done) == 4
    assert all(len(r.out_tokens) == 1 for r in done)


def test_engine_queue_eos_at_prefill_frees_slot(tiny_model):
    from repro_torch.serve import Request, ServeEngine

    cfg, model, params = tiny_model
    probe = ServeEngine(model, params, n_slots=1, s_max=32, device="cpu")
    probe.submit(Request(uid=0, prompt=np.arange(5) % 64, max_new_tokens=3))
    first_tok = probe.run()[0].out_tokens[0]
    eng = ServeEngine(model, params, n_slots=1, s_max=32, eos_token=first_tok, device="cpu")
    eng.submit(Request(uid=0, prompt=np.arange(5) % 64, max_new_tokens=3))
    eng.submit(Request(uid=1, prompt=(np.arange(4) * 7 + 1) % 64, max_new_tokens=2))
    by_uid = {r.uid: r for r in eng.run()}
    assert by_uid[0].out_tokens == [first_tok]
    assert len(by_uid[1].out_tokens) >= 1


class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_engine_prefill_budget_staggers_admissions(tiny_model):
    """With a budget of one prompt a step, four simultaneous arrivals
    prefill over four steps, and every request gets its token budget."""
    from repro_torch.serve import Request, ServeEngine, TraceScheduler, replay_trace

    cfg, model, params = tiny_model
    rng = np.random.default_rng(2)
    prompt_len = 6
    n_tokens = np.array([3, 3, 3, 3], np.int64)
    trace = replay_trace(np.zeros(4), n_tokens, t_token=0.5, slo_factor=50.0, queue_grace=100.0)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32) for _ in range(4)]

    def run(budget):
        sched = TraceScheduler(trace, 4, t_step_init=0.5, payloads=[
            Request(uid=i, prompt=p, max_new_tokens=int(n_tokens[i]))
            for i, p in enumerate(prompts)])
        clock = _FakeClock()
        eng = ServeEngine(model, params, n_slots=4, s_max=32, scheduler=sched, clock=clock,
                          prefill_budget=budget, device="cpu")
        occupancy = []
        for _ in range(60):
            if sched.finished:
                break
            busy = eng.step()
            occupancy.append(int(eng._active.sum()))
            clock.now += 0.5
            if busy == 0 and not sched.finished:
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                clock.now = max(clock.now, nxt)
        assert sched.finished
        assert sorted(len(r.out_tokens) for r in eng.completed) == sorted(n_tokens)
        assert all(r.deadline is not None and r.sched_idx is not None for r in eng.completed)
        return occupancy

    staged = run(prompt_len)
    eager = run(None)
    assert eager[0] == 4
    assert staged[0] == 1
    assert max(staged) <= 4


def test_engine_refuses_foreign_payloads(tiny_model):
    from repro_torch.serve import Request, ServeEngine, TraceScheduler, replay_trace

    cfg, model, params = tiny_model
    trace = replay_trace(np.zeros(1), np.array([3]))
    for payload, err in ((object(), TypeError),
                         (Request(uid=0, prompt=np.arange(4), max_new_tokens=5), ValueError)):
        sched = TraceScheduler(trace, 2, payloads=[payload])
        eng = ServeEngine(model, params, n_slots=2, s_max=16, scheduler=sched,
                          clock=_FakeClock(), device="cpu")
        with pytest.raises(err):
            eng.step()
