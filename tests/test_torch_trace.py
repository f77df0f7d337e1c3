"""The port's tracer (``repro_torch.utils.trace``) and the serving engine's
spans, first-token events and counters on the CPU, each over the scalar
path (``macro_steps=1``) and the fused path (``macro_steps=4``, the CPU loop
of a fused block)."""
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.adaptive import ParityController
from repro_torch.models.registry import build_model
from repro_torch.serve import Request, ServeEngine, TraceScheduler, replay_trace
from repro_torch.serve.engine import CHOOSE_K_REASONS
from repro_torch.utils.trace import (NULL, Tracer, current_tracer, report_lines, self_times, summarize,
                                     tracing)

N_BLOCKS = 16
PATHS = {"scalar": 1, "fused": 4}
ARCHS = ["phi3-mini-3.8b", "zamba2-1.2b"]

# each span's parent, as the engine and the model open them
PARENTS = {
    "engine.init": {None},
    "engine.macro_step": {None},
    "engine.admit": {"engine.macro_step"},
    "engine.prefill": {"engine.admit"},
    "engine.splice": {"engine.macro_step"},
    "engine.control": {"engine.macro_step"},
    "engine.raise": {"engine.control"},
    "engine.decode": {"engine.macro_step"},
    "engine.block": {"engine.macro_step"},
    "engine.capture": {"engine.block"},
    "engine.apply": {"engine.macro_step"},
}
MODEL_PARENTS = {"engine.prefill", "engine.decode", "engine.block", "engine.capture"}


def _model(arch):
    cfg = get_config(arch, smoke=True).scaled(dtype="float32", coded=True, coded_parity=2)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def models():
    return {arch: _model(arch) for arch in ARCHS}


class TickClock:
    """Advances on every read."""

    def __init__(self, tick=0.1):
        self.now, self.tick = 0.0, tick

    def __call__(self):
        self.now += self.tick
        return self.now


def _persistent_latency():
    """Three persistent stragglers: the controller raises the parity."""
    def latency_fn():
        lat = np.full(N_BLOCKS, 1e-3)
        lat[[2, 5, 9]] = 0.5
        return lat

    return latency_fn


def _wave(entry, path, tracer=None, n_slots=4, n_req=8, max_new=11, raise_=False):
    """A queue of equal requests in two waves (so the fused path fuses),
    served by ``macro_step()`` calls; returns (engine, requests, calls)."""
    cfg, model, params = entry
    eng = ServeEngine(model, params, n_slots=n_slots, s_max=48, macro_steps=PATHS[path],
                      latency_fn=_persistent_latency() if raise_ else None,
                      parity_controller=ParityController(N_BLOCKS) if raise_ else None,
                      parity_topup=1 if raise_ else 0, topup_patience=2, device="cpu",
                      tracer=tracer)
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 5 + i % 3).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n_req)]
    for r in reqs:
        eng.submit(r)
    calls = 0
    while eng.queue or eng._active.any():
        eng.macro_step()
        calls += 1
    return eng, reqs, calls


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_nest_and_self_time_is_the_uncovered_part(models, path):
    tr = Tracer(clock=time.perf_counter)
    eng, _, calls = _wave(models["phi3-mini-3.8b"], path, tr, raise_=True)
    assert eng.parity_events and tr.spans
    by_id = {s.id: s for s in tr.spans}
    names = {s.name for s in tr.spans}
    assert {"engine.init", "engine.admit", "engine.prefill", "engine.splice", "engine.control",
            "engine.raise", "engine.decode", "engine.apply", "model.embed", "model.attn",
            "model.mlp", "model.head"} <= names
    assert ("engine.block" in names) == (path == "fused") == (eng.macro_blocks > 0)
    assert summarize(tr.spans)["engine.macro_step"]["count"] == calls
    kids: dict[int, list] = {}
    for s in tr.spans:
        parent = None if s.parent is None else by_id[s.parent]
        want = MODEL_PARENTS if s.name.startswith("model.") else PARENTS[s.name]
        assert (None if parent is None else parent.name) in want, (s.name, parent)
        assert s.t0 <= s.t1
        if parent is not None:
            assert parent.t0 <= s.t0 and s.t1 <= parent.t1
            kids.setdefault(parent.id, []).append(s)
        if s.name.startswith("model."):
            assert ("layer" in s.attrs) == (s.name in ("model.attn", "model.mlp"))
    top = max(ev["n_parity"] for ev in eng.parity_events)
    for s in tr.spans:
        if s.name == "engine.prefill":
            assert {"uid", "prompt_len"} <= set(s.attrs)
        if s.name == "engine.macro_step":
            assert s.attrs["k"] in (1, 2, 4)
        if s.name == "engine.control":   # the latencies choose a level at every step
            assert 0 <= s.attrs["n_parity"] <= top
        if s.name in ("engine.splice", "engine.decode"):
            assert 1 <= s.attrs["slots" if s.name == "engine.splice" else "active"] <= 4
        if s.name in ("engine.block", "engine.raise"):
            assert s.attrs["k" if s.name == "engine.block" else "n_parity"] in (2, 3, 4)
    own = self_times(tr.spans)
    for s in tr.spans:   # one thread: children never overlap
        covered = sum(c.t1 - c.t0 for c in kids.get(s.id, ()))
        assert own[s.id] == pytest.approx((s.t1 - s.t0) - covered, abs=1e-12)
        assert own[s.id] >= -1e-12
    # a synthetic parent whose children overlap and stick out: covered once, clipped
    from repro_torch.utils.trace import SpanRec

    syn = [SpanRec(0, None, "p", 0.0, 10.0, {}, False), SpanRec(1, 0, "c", 2.0, 5.0, {}, False),
           SpanRec(2, 0, "c", 4.0, 6.0, {}, False), SpanRec(3, 0, "c", 9.0, 12.0, {}, False)]
    assert self_times(syn)[0] == pytest.approx(10.0 - 4.0 - 1.0)


@pytest.mark.parametrize("path", list(PATHS))
def test_report_lines_read_every_span_and_attribute(models, path):
    tr = Tracer(clock=time.perf_counter)
    _, _, calls = _wave(models["phi3-mini-3.8b"], path, tr, raise_=True)
    lines = report_lines(tr.spans)
    spans = [ln for ln in lines if ln.startswith("span ")]
    assert {ln.split(":")[0][len("span "):] for ln in spans} == {s.name for s in tr.spans}
    selfs = [float(ln.rsplit("self ", 1)[1].split()[0]) for ln in spans]
    assert selfs == sorted(selfs, reverse=True)
    attrs = {ln.split(":")[0][len("attr "):]: ln for ln in lines if ln.startswith("attr ")}
    assert set(attrs) == {f"{s.name} {k}" for s in tr.spans for k in s.attrs}
    # a macro_step's k takes few values: each with its count, and they sum to the calls
    by_k = attrs["engine.macro_step k"].split(": ", 1)[1].split(", ")
    assert sum(int(item.split(": ")[1].split(" x")[0]) for item in by_k) == calls
    # eight requests, eight uids: each with its count
    assert attrs["engine.prefill uid"].count(": 1 x ") == 8
    # past eight values, their range and the slowest value's mean
    from repro_torch.utils.trace import SpanRec

    syn = [SpanRec(i, None, "p", 0.0, 1e-3 * (1 + (i == 4)), {"uid": i}, False) for i in range(9)]
    assert report_lines(syn)[-1] == "attr p uid: 9 values 0-8, slowest 4 at 2.000 ms mean"


@pytest.mark.parametrize("path", list(PATHS))
def test_tracer_on_and_off_give_the_same_tokens_and_counts(models, path):
    off, off_reqs, _ = _wave(models["phi3-mini-3.8b"], path, raise_=True)
    on, on_reqs, _ = _wave(models["phi3-mini-3.8b"], path, Tracer(clock=time.perf_counter),
                           raise_=True)
    assert [r.out_tokens for r in on_reqs] == [r.out_tokens for r in off_reqs]
    assert on.sync_count == off.sync_count and on.tokens_emitted == off.tokens_emitted
    assert on.macro_blocks == off.macro_blocks and on.counters == off.counters
    assert current_tracer() is None   # the engine's context is its own


def _sched_engine(entry, path, tracer):
    cfg, model, params = entry
    rng = np.random.default_rng(17)
    t_arrival = np.array([0.0, 0.0, 0.3, 4.0, 4.0])
    n_tokens = np.array([12, 12, 6, 9, 14])
    trace = replay_trace(t_arrival, n_tokens, t_token=0.5, slo_factor=50.0, queue_grace=50.0)
    payloads = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 4 + i).astype(np.int32),
                        max_new_tokens=int(n_tokens[i])) for i in range(len(n_tokens))]
    sched = TraceScheduler(trace, 2, t_step_init=0.5, payloads=payloads)
    clock = TickClock()
    eng = ServeEngine(model, params, n_slots=2, s_max=40, scheduler=sched, clock=clock,
                      macro_steps=PATHS[path], device="cpu", tracer=tracer)
    return eng, sched, clock


@pytest.mark.parametrize("path", list(PATHS))
def test_first_token_event_is_the_stamp_the_scheduler_got(models, path):
    tr = Tracer()   # on the engine's ticking clock: every span reads it too
    eng, sched, clock = _sched_engine(models["phi3-mini-3.8b"], path, tr)
    got: dict[int, float] = {}
    on_token = sched.on_token

    def spy(idx, t):
        got.setdefault(idx, t)
        return on_token(idx, t)

    sched.on_token = spy
    calls = 0
    while not sched.finished and calls < 500:
        if eng.macro_step() == 0:
            clock.now = max(clock.now, sched.next_arrival() or clock.now)
        calls += 1
    assert sched.finished and eng.completed
    first = {e.attrs["uid"]: e.t for e in tr.events if e.name == "first_token"}
    assert first == {r.uid: got[r.sched_idx] for r in eng.completed}
    assert (eng.macro_blocks > 0) == (path == "fused")
    assert sum(n for k, n in eng.counters.items() if k.startswith("choose_k.")) == calls


@pytest.mark.parametrize("path", list(PATHS))
def test_choose_k_counters_sum_to_the_calls(models, path):
    eng, _, calls = _wave(models["phi3-mini-3.8b"], path, raise_=True)
    c = eng.counters
    reasons = {k for k in c if k.startswith("choose_k.") and not k.startswith("choose_k.fused.")}
    assert reasons == {f"choose_k.{r}" for r in CHOOSE_K_REASONS}
    assert sum(n for k, n in c.items() if k.startswith("choose_k.")) == calls
    fused = sum(n for k, n in c.items() if k.startswith("choose_k.fused."))
    if path == "scalar":
        assert c["choose_k.k_max"] == calls and fused == 0
    else:
        assert fused > 0 and c["choose_k.queue"] > 0 and c["choose_k.k_max"] == 0


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
@pytest.mark.parametrize("path", list(PATHS))
def test_kv_live_bytes_from_lengths_and_leaf_shapes(models, path, arch):
    n_slots, s_max = 4, 48
    eng, reqs, _ = _wave(models[arch], path, n_slots=n_slots, n_req=7)
    leaves = list(_leaves(eng.cache))
    reserved = sum(t.numel() * t.element_size() for _, t in leaves)
    pos = sum(t.numel() * t.element_size() // (n_slots * s_max) for n, t in leaves
              if n in ("k", "v"))
    fixed = sum(t.numel() * t.element_size() // n_slots for n, t in leaves
                if n not in ("k", "v"))
    assert pos > 0 and fixed > 0
    want, steps = 0, 0
    for r in reqs:   # a decoded step d of a request holds its prompt and d more positions
        s, d_max = len(r.prompt), len(r.out_tokens) - 1
        want += sum(fixed + pos * (s + d) for d in range(1, d_max + 1))
    c = eng.counters
    assert c["kv.reserved_bytes"] == reserved
    assert c["kv.live_bytes"] == want
    assert c["kv.steps"] == eng._steps and eng._kv_live == 0   # every request retired
    assert 0 < c["kv.live_bytes"] < c["kv.steps"] * reserved


def test_no_tracer_means_no_span_and_no_clock_read(models):
    cfg, model, params = models["phi3-mini-3.8b"]
    reads = []
    eng = ServeEngine(model, params, n_slots=2, s_max=32, device="cpu",
                      clock=lambda: reads.append(1) or 0.0)
    eng.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=3))
    eng.run()
    assert eng.tracer is None and not reads
    assert NULL.__enter__() is None   # the shared stand-in enters any number of times
    with tracing(None):
        assert current_tracer() is None
    tr = Tracer(clock=lambda: 1.0)
    with tracing(tr), tr.span("x", a=1) as sp:
        assert current_tracer() is tr and sp.attrs == {"a": 1}
    assert current_tracer() is None and tr.spans[0].name == "x" and not tr.spans[0].profiled
