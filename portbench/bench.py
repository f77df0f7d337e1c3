"""One run of one cell: load, warm up, measure, check, report.

The program is ``repro_torch``, driven through its public entry points as
its launcher's trace mode drives it (``repro_torch/launch/serve.py``):
``models.registry.build_model``, ``serve.ServeEngine`` with
``macro_step()``, and in an open loop a ``serve.TraceScheduler`` over the
cell's arrivals, or in a closed loop ``ServeEngine.submit``.  The harness
stamps every request's first and last token itself, from its
``out_tokens`` after each ``macro_step()``: the engine hands tokens back
at that boundary.

Set-up (``setup_s``) runs from process start to the window's first
request: the seeded weights, the engine (its cache and the coded head),
and warm-up traffic that serves the cell's longest prompt, makes the one
parity raise a cell's straggler model calls for, and fills every slot so
that each fused-block bucket (K = 16, 8, 4, 2) is captured.  The window
then starts from an empty engine.  After it closes the peak memory is
read, the engine is freed, and a sample of finished requests is held to
the configuration's plain fp32 reference (``reference/``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np

from portbench import devtrace, weights, yardstick
from portbench.reference.common import Precision, exact_fp32, gaps
from portbench.traffic import gen

HERE = Path(__file__).resolve().parent
WARM_ARRIVAL = (-3000.0, -2000.0)   # the warm-up rounds' arrival times on the scheduler's clock
WARM_DEADLINE_S = 1e5
TRACE_SLICE_S = 3.0                 # the profiled slice a --trace 1 run serves past its window


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def port_config(cfg: dict, smoke: bool = False):
    """The port's ModelConfig of a configuration file (its ``smoke`` sizes
    when ``smoke``)."""
    from repro_torch.models.config import ModelConfig, coded_blocks

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    if smoke:
        kw.update(cfg["smoke"])
    mc = ModelConfig(**kw)
    if mc.coded and coded_blocks(mc) != cfg["coded_blocks"]:
        raise ValueError(f"{cfg['name']}: the port codes its head over {coded_blocks(mc)} "
                         f"blocks, the file states {cfg['coded_blocks']}")
    return mc


def reference_module(cfg: dict):
    path = HERE / cfg["reference"]
    spec = importlib.util.spec_from_file_location(f"portbench_ref_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------
class WallClock:
    """Seconds on the host's monotonic clock from a movable origin: the
    scheduler's and the harness's one clock."""

    def __init__(self):
        self.base = time.monotonic()

    def __call__(self) -> float:
        return time.monotonic() - self.base

    def set(self, t: float) -> None:
        """Make the clock read ``t`` now."""
        self.base = time.monotonic() - t

    def sleep(self, dt: float) -> None:
        time.sleep(max(0.0, dt))


class TickClock(WallClock):
    """A clock that advances ``tick`` seconds on every read and sleeps by
    moving itself: a run on it serves the same requests in the same order
    whatever the host's speed (the CPU tests)."""

    def __init__(self, tick: float):
        self.t, self.tick = 0.0, tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t

    def set(self, t: float) -> None:
        self.t = t

    def sleep(self, dt: float) -> None:
        self.t += max(0.0, dt)


# ---------------------------------------------------------------------------
# request records
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Rec:
    uid: int
    prompt: np.ndarray
    out_len: int
    due: float | None = None          # window clock: arrival (open) or send (closed)
    t_admit: float | None = None
    t_first: float | None = None
    t_last: float | None = None
    n: int = 0
    done: bool = False
    rejected: bool = False
    req: object = None                # the engine's Request

    def row(self) -> dict:
        return {"due": self.due, "t_admit": self.t_admit, "t_first": self.t_first,
                "t_last": self.t_last, "n": self.n, "prompt_len": int(len(self.prompt)),
                "out_len": self.out_len, "done": self.done, "rejected": self.rejected}


class Driver:
    """Calls ``macro_step()`` and keeps the books: token stamps, counters,
    the prompt length of every prefill, the call's kind, the harness's
    spans."""

    def __init__(self, eng, clock, recs: dict[int, Rec]):
        self.eng, self.clock, self.recs = eng, clock, recs
        self.seen_completed = 0
        self.calls = 0
        self.fused_tokens = 0
        self.served: dict[int, int] = {}   # tokens seen, by uid, of every request
        self.prefill_lens: list[int] = []  # prompt lengths of the prefills, in order
        self.traced = False
        self.labels: dict[str, str] = {}
        self.window = False

    def span(self, name: str):
        if not self.traced:
            return nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def call(self) -> tuple[int, list]:
        """One macro_step(); returns (its active count, the engine's
        requests that completed in it)."""
        eng = self.eng
        tok0, blk0 = eng.tokens_emitted, eng.macro_blocks
        t0 = self.clock()
        name = f"pb:call{self.calls}"
        with self.span(name):
            busy = eng.macro_step()
        t1 = self.clock()
        with self.span("pb:admission"):
            fused = eng.macro_blocks > blk0
            if fused and self.window:
                self.fused_tokens += eng.tokens_emitted - tok0
            finished = eng.completed[self.seen_completed:]
            self.seen_completed = len(eng.completed)
            admitted = False
            for r in [r for r in eng.slots if r is not None] + list(finished):
                n, was = len(r.out_tokens), self.served.get(r.uid, 0)
                if n == was:
                    continue
                self.served[r.uid] = n
                if was == 0:
                    admitted = True
                    self.prefill_lens.append(len(r.prompt))
                rec = self.recs.get(r.uid)
                if rec is not None:
                    if rec.n == 0:
                        rec.t_first = t1
                        if rec.t_admit is None:
                            rec.t_admit = t0
                    rec.n, rec.t_last = n, t1
            for r in finished:
                self.served.pop(r.uid, None)
                rec = self.recs.get(r.uid)
                if rec is not None:
                    rec.done = True
            self.labels[name] = "prefill" if admitted else "fused_block" if fused else "scalar_step"
            self.calls += 1
        return busy, finished


class Loop:
    """The cell's clients: an open loop's arrivals go through the
    TraceScheduler; a closed loop's clients each send their next request
    from the pool when the last completes."""

    def __init__(self, drv, eng, sched, traffic, recs, clock, Request):
        self.drv, self.eng, self.sched, self.traffic = drv, eng, sched, traffic
        self.recs, self.clock, self.Request = recs, clock, Request
        self.nxt = 0

    def _send(self) -> None:
        if self.nxt >= self.traffic.n:
            raise RuntimeError("the closed loop's request pool ran out: raise pool_per_s")
        rec = self.recs[self.nxt]
        self.nxt += 1
        rec.due = self.clock()
        rec.req = self.Request(uid=rec.uid, prompt=rec.prompt, max_new_tokens=rec.out_len)
        self.eng.submit(rec.req)

    def start(self) -> None:
        if self.traffic.loop == "closed":
            for _ in range(self.traffic.clients):
                self._send()

    def serve(self, until: float) -> None:
        """Serve until the clock reads ``until``."""
        drv, clock = self.drv, self.clock
        while clock() < until:
            busy, done = drv.call()
            if self.traffic.loop == "closed":
                with drv.span("pb:admission"):
                    for _ in done:
                        self._send()
            elif busy == 0:
                na = self.sched.next_arrival()
                with drv.span("pb:client_wait"):
                    clock.sleep((until if na is None else min(na, until)) - clock())


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------
def run(workload: dict, seed: int, seconds: float, trace: bool, *, device, t_start: float,
        smoke: bool = False, fault=None, control: bool = False,
        traffic_overrides: dict | None = None, clock: WallClock | None = None) -> dict:
    """One run of ``workload`` (its BENCHMARK.json entry).  Returns the
    record the metric readers read (``metrics/__init__.py``) with the
    check's numbers under ``check``.  ``fault`` (tests only) breaks the
    engine underneath; ``control`` also reads the lower-precision
    control's gaps on the same requests; ``traffic_overrides`` (a rate
    sweep's) replace entries of the traffic file; ``clock`` (tests: a TickClock)
    replaces the wall clock of the scheduler and the harness."""
    import torch

    from repro_torch.models.registry import build_model

    cfg = load_config(workload["config"])
    mc = port_config(cfg, smoke)
    cfg_run = {**cfg, **(cfg["smoke"] if smoke else {})}
    tp = gen.load(workload["traffic"], smoke, traffic_overrides)
    traffic = gen.draw(workload["traffic"], seed, seconds, smoke, traffic_overrides)
    model = build_model(mc)
    phases = {"start": time.monotonic() - t_start}
    params = weights.make(model, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["weights"] = time.monotonic() - t_start
    prompts = gen.token_ids(seed, traffic.prompt_len, mc.vocab)
    recs = {i: Rec(i, prompts[i], int(traffic.out_len[i])) for i in range(traffic.n)}
    n_slots, s_max = int(tp["slots"]), int(tp["s_max"])
    if int(traffic.prompt_len.max() + traffic.out_len.max()) > s_max:
        raise ValueError("the traffic's longest request does not fit s_max")

    from repro_torch.serve import Request, ServeEngine

    warm = tp["warmup"]
    rng = gen.seeded_rng(seed, 3)
    warm_prompt = lambda n: rng.integers(0, mc.vocab, n)  # noqa: E731
    warm_reqs = []
    if "raise_new_tokens" in warm:        # round A: the longest prompt, and the raise
        warm_reqs.append(Request(uid=-1, prompt=warm_prompt(int(tp["prompt"]["max"])),
                                 max_new_tokens=int(warm["raise_new_tokens"])))
    if warm.get("longest"):              # the traffic's n_slots longest prompts, longest last
        lens = sorted(int(x) for x in np.sort(traffic.prompt_len)[-n_slots:])
    else:
        lens = [int(warm["prompt"])] * n_slots
    round_b = [Request(uid=-2 - i, prompt=warm_prompt(n),
                       max_new_tokens=int(warm["graph_new_tokens"])) for i, n in enumerate(lens)]

    latency_fn, policy, sched = None, None, None
    clock = WallClock() if clock is None else clock
    if "stragglers" in tp:
        latency_fn, policy = _stragglers(tp, mc, seed)
    if traffic.loop == "open":
        sched = _scheduler(tp, traffic, recs, warm_reqs, round_b, n_slots, Request,
                           seconds if trace else None)
    eng = ServeEngine(model, params, n_slots=n_slots, s_max=s_max, latency_fn=latency_fn,
                      parity_policy=policy,
                      parity_topup=int(tp.get("parity", {}).get("topup", 0)),
                      topup_patience=int(tp.get("parity", {}).get("patience", 4)),
                      scheduler=sched, clock=clock if sched is not None else None,
                      macro_steps=int(tp["macro_steps"]), device=device)
    if fault is not None:
        fault(eng)
    phases["engine"] = time.monotonic() - t_start
    drv = Driver(eng, clock, {})
    _warm_up(drv, eng, sched, clock, warm_reqs, round_b, tp, phases, t_start)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    # ---- the window ------------------------------------------------------
    drv.recs, drv.window = recs, True
    # what set-up made stays alive for the run: out of the collector's
    # sight, so no collection in the window walks it
    gc.collect()
    gc.freeze()
    c0 = (eng.tokens_emitted, eng.sync_count, eng.macro_blocks)
    clock.set(0.0)
    setup_s = time.monotonic() - t_start
    loop = Loop(drv, eng, sched, traffic, recs, clock, Request)
    loop.start()
    loop.serve(seconds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = clock()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counters = {"tokens": eng.tokens_emitted - c0[0], "syncs": eng.sync_count - c0[1],
                "macro_blocks": eng.macro_blocks - c0[2], "fused_tokens": drv.fused_tokens,
                "calls": drv.calls}
    if sched is not None:
        res = sched.results()
        for i, rec in recs.items():
            j = i + len(warm_reqs) + len(round_b)
            rec.rejected = bool(res["rejected"][j])
            if np.isfinite(res["t_admit"][j]):
                rec.t_admit = float(res["t_admit"][j])
    due = [r for r in recs.values() if r.due is not None and r.due < seconds]
    rows = [r.row() for r in due]
    finished = [r for r in due if r.done]
    tr = None
    if trace:   # the profiled slice serves on past the window, which stays untouched
        drv.window = False
        tr = _profile(drv, loop, TRACE_SLICE_S, device)
        tr["bound_s"] = _bounds(cfg_run, eng, tr, n_slots)
    parity_events = list(eng.parity_events)
    n_parity = eng.model.cfg.coded_parity if mc.coded else 0

    # ---- free the program, then the reference ------------------------------
    gc.unfreeze()
    del eng, drv, sched
    params.pop("lm_head_coded", None)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check = _check(cfg_run, tp, params, finished, seed, device, control)
    return {"cfg": cfg_run, "traffic": tp, "loop": traffic.loop, "n_slots": n_slots,
            "setup_s": setup_s, "window_s": window_s, "peak_bytes": peak,
            "requests": rows, "counters": counters, "trace": tr,
            "check": check, "parity_events": parity_events, "n_parity": n_parity,
            "setup_phases": phases,
            "attempted": len(due), "failed": sum(r.rejected for r in due)}


def _stragglers(tp: dict, mc, seed: int):
    """Per-shard latencies of a seeded model, seen through the port's
    ``runtime.HealthMonitor`` (as ``chip_smoke.py::phase_trace_serve``):
    persistent stragglers, and each other shard late on a share of steps;
    deadline-aware parity over a ParityController."""
    from repro_torch.core.adaptive import DeadlineAwareParity, ParityController
    from repro_torch.models.config import coded_blocks
    from repro_torch.runtime import HealthMonitor

    st, par = tp["stragglers"], tp["parity"]
    nb = coded_blocks(mc)
    rng = gen.seeded_rng(seed, 4)
    monitor = HealthMonitor(n_workers=nb)
    slow = np.zeros(nb, bool)
    slow[list(st["persistent"])] = True

    def latency_fn():
        lat = st["base_s"] * (1.0 + st["jitter"] * rng.random(nb))
        late = slow | (rng.random(nb) < st["late_prob"])
        lat[late] *= st["slow_factor"]
        monitor.observe_step_latencies(lat)
        return monitor.shard_latencies()

    if par["policy"] != "deadline":
        raise ValueError(f"unknown parity policy {par['policy']!r}")
    return latency_fn, DeadlineAwareParity(ParityController(nb, decay=par["decay"]))


def _scheduler(tp, traffic, recs, warm_reqs, round_b, n_slots, Request, slice_from=None):
    """A TraceScheduler over the warm-up rounds (far before the window's
    clock starts) and the window's arrivals, with the traffic file's
    per-token deadlines.  With ``slice_from`` (a traced run) the arrivals
    go on past it, the window's first seconds again, for the profiled
    slice to serve; those requests count in no metric."""
    from repro_torch.serve import TraceScheduler, replay_trace

    slo = tp["slo"]
    t_tok = slo["t_token_s"]
    t = [WARM_ARRIVAL[0]] * len(warm_reqs) + [WARM_ARRIVAL[1]] * len(round_b)
    n = [r.max_new_tokens for r in warm_reqs + round_b]
    d = [x + WARM_DEADLINE_S for x in t]
    payloads = list(warm_reqs) + list(round_b)
    for i, rec in recs.items():
        ta = float(traffic.t_arrival[i])
        rec.due = ta
        t.append(ta)
        n.append(rec.out_len)
        d.append(ta + slo["queue_grace"] * t_tok + slo["slo_factor"] * rec.out_len * t_tok)
        rec.req = Request(uid=i, prompt=rec.prompt, max_new_tokens=rec.out_len)
        payloads.append(rec.req)
    if slice_from is not None:
        again = [i for i in recs if traffic.t_arrival[i] < TRACE_SLICE_S + 1.0]
        for j, i in enumerate(again):
            ta = slice_from + float(traffic.t_arrival[i])
            t.append(ta)
            n.append(recs[i].out_len)
            d.append(ta + slo["queue_grace"] * t_tok + slo["slo_factor"] * recs[i].out_len * t_tok)
            payloads.append(Request(uid=len(recs) + j, prompt=recs[i].prompt,
                                    max_new_tokens=recs[i].out_len))
    trace = replay_trace(t, n, deadline=d)
    return TraceScheduler(trace, n_slots, t_step_init=t_tok, payloads=payloads)


def _warm_up(drv, eng, sched, clock, warm_reqs, round_b, tp, phases, t_start) -> None:
    """Round A (if any) serves the longest prompt and runs scalar steps
    until the parity raise; round B fills every slot in one admission pass
    (with ``warmup.longest``, the traffic's longest prompts, longest last:
    the most memory a pass of its prefills holds), with one budget of
    2 K_max tokens: the prefill's, one scalar step's (the call that
    admits), then fused blocks of K_max, K_max / 2, ..., 2, so that each
    bucket is captured."""
    def drain(reqs, offset):
        clock.set(offset)
        if sched is None:
            for r in reqs:
                eng.submit(r)
        want = {r.uid for r in reqs}
        while any(not r.done for r in reqs) or any(
                s is not None and s.uid in want for s in eng.slots):
            drv.call()

    if warm_reqs:
        drain(warm_reqs, WARM_ARRIVAL[0])
        want = int(tp["parity"]["topup"])
        if len(eng.parity_events) != want:
            raise RuntimeError(f"warm-up made {len(eng.parity_events)} parity raises, "
                               f"the cell expects {want} before its window")
        phases["warm_raise"] = time.monotonic() - t_start
    drain(round_b, WARM_ARRIVAL[1])
    phases["warm_graphs"] = time.monotonic() - t_start
    want, k = set(), 2
    while k <= int(tp["macro_steps"]):
        want.add(k)
        k *= 2
    have = {g["k"] for g in eng.graph_log}
    if eng.device.type == "cuda" and not want <= have:
        raise RuntimeError(f"warm-up captured fused blocks K = {sorted(have)}, "
                           f"not every bucket of {sorted(want)}")


def _profile(drv, loop, seconds: float, device) -> dict:
    """Serve on for ``seconds`` under torch.profiler, counted from when it
    has started (its start takes seconds on the card), inside a
    ``pb:slice`` span; returns the slice's reduction (``devtrace.reduce``),
    the hand-written launches in it and the prompt length of each prefill."""
    import torch

    from repro_torch.kernels import kernel_wrappers

    def launches():
        return {k: fn.launches for k, fn in kernel_wrappers().items()}

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    l0, p0 = launches(), len(drv.prefill_lens)
    prof = devtrace.profiler()
    drv.traced = True
    with prof:
        with torch.profiler.record_function("pb:slice"):
            loop.serve(drv.clock() + seconds)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    drv.traced = False
    out = devtrace.reduce(prof, drv.labels)
    l1 = launches()
    out["launches"] = {k: l1[k] - l0[k] for k in l0}
    out["prefills"] = drv.prefill_lens[p0:]
    return out


def _bounds(cfg: dict, eng, tr: dict, n_slots: int) -> dict:
    """The yardstick's seconds for every hand-written launch in the slice:
    B2 once a prefill (x of one column) and once a decoded step (x of
    n_slots columns), at the head the engine holds; B5 and B6 once a Mamba
    block a prefill, at the prompt's cells."""
    out = {}
    launches, prefills = tr["launches"], tr["prefills"]
    which = {}
    if cfg.get("coded"):
        w = eng.params["lm_head_coded"]
        nb = cfg["coded_blocks"]
        n_data = nb - eng.model.cfg.coded_parity
        br, m = w.shape[0] // nb, w.shape[1]
        steps = launches["coded_matvec_decode"] - len(prefills)
        one, w1 = yardstick.bound_s(*yardstick.coded_matvec_decode(n_data, nb, br, m, 1))
        wide, wn = yardstick.bound_s(*yardstick.coded_matvec_decode(n_data, nb, br, m, n_slots))
        if steps >= 0:
            out["coded_matvec_decode"] = len(prefills) * one + steps * wide
            which["coded_matvec_decode"] = f"B=1 by {w1}, B={n_slots} by {wn}"
    if cfg["family"] == "hybrid" and prefills:
        for k, fn in (("ssd_chunk", yardstick.ssd_chunk), ("ssd_combine", yardstick.ssd_combine)):
            if launches[k] != cfg["n_layers"] * len(prefills):
                continue
            tot, by = 0.0, set()
            for s in prefills:
                t, b = yardstick.bound_s(*fn(*yardstick.ssd_cells(cfg, s)))
                tot += cfg["n_layers"] * t
                by.add(b)
            out[k] = tot
            which[k] = "by " + "/".join(sorted(by))
    tr["bound_by"] = which
    return out


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------
def sample(finished: list[Rec], k: int, seed: int) -> list[Rec]:
    """The finished request with the most served tokens and k - 1 others
    drawn from the seed."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (r.n, -r.uid))
    rest = [r for r in finished if r is not longest]
    rng = gen.seeded_rng(seed, 5)
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def _check(cfg: dict, tp: dict, params: dict, finished: list[Rec], seed: int, device,
           control: bool) -> dict:
    """The numbers that decide ``correct``, each beside its limit: the
    widest gap by which a served token's logit lies below the plain fp32
    reference's best (over a seeded sample of finished requests, the
    longest among them), finished requests whose token count differs
    from their budget, and that the window finished a request at all."""
    import torch

    ref = reference_module(cfg)
    chk = tp["check"]
    picked = sample(finished, int(chk["sample"]), seed)
    widest, widest_ctrl, n_tok = 0.0, 0.0, 0
    with torch.no_grad(), exact_fp32():
        for rec in picked:
            prompt = torch.as_tensor(rec.prompt, dtype=torch.long, device=device)
            served = torch.as_tensor(rec.req.out_tokens, dtype=torch.long, device=device)
            lg = ref.served_logits(params, cfg, prompt, served, Precision())
            widest = max(widest, float(gaps(lg, served).max()))
            n_tok += len(served)
            if control:
                lc = ref.served_logits(params, cfg, prompt, served, Precision(control=True))
                widest_ctrl = max(widest_ctrl, float(gaps(lg, lc.argmax(dim=1)).max()))
            del lg
    limit = chk.get("max_gap")
    out = {
        "max_gap": {"value": widest, "limit": limit},
        "len_mismatch": {"value": sum(len(r.req.out_tokens) != r.out_len for r in finished),
                         "limit": 0},
        "finished_min": {"value": len(finished), "limit": 1},
        "sampled_tokens": n_tok,
    }
    if control:
        out["control_max_gap"] = widest_ctrl
    out["correct"] = bool(
        limit is not None and widest <= limit and out["len_mismatch"]["value"] == 0
        and len(finished) >= 1)
    return out
