"""Trace-driven serving scheduler: admission control, SLO slack, and the
model-time traffic simulator (DESIGN.md §10).

The paper's claim is that BPCC's partial results buy robustness against
uncertain stragglers; on the serving side that robustness is only worth
something if it survives *traffic* — open-loop arrivals, per-request
deadlines, queueing.  This module is the control plane for that:

  * ``TraceScheduler`` — drives an ``ArrivalTrace`` (serve/loadgen.py)
    through a slot-limited CONTINUOUS-BATCHING engine (DESIGN.md §13).
    Requests arrive open-loop, queue per SLO class, and join/leave the
    decode batch at step granularity: admission is weighted fair queuing
    over the trace's tenant classes (admit from the backlogged class
    minimizing normalized virtual service ``(served_c + 1) / weight_c``,
    FIFO within a class), prefill is disaggregated from decode — each
    step's token budget (``step_budget``, default ``2 × n_slots``) first
    reserves one token per decode-ready slot, then spends the remainder
    on prefill chunks and the first tokens of fresh admissions — and a
    departing request's slot is reusable the same step.  Admission
    control rejects a request whose projected completion (``now +
    (n_tokens + ceil(n_prefill / pf_nominal)) × est_step_time``) already
    overshoots its deadline — a doomed request would only burn a slot
    that a feasible one needs (goodput protection).  The scheduler never
    admits beyond slot capacity, never lets per-step prefill + decode
    tokens exceed the step budget (both property-tested), and keeps an
    EW estimate of the observed step time, which is also what converts
    deadline slack into "slack steps" — globally
    (``min_slack_steps`` → ``core.adaptive.DeadlineAwareParity``) or per
    SLO class (``class_slack_steps`` →
    ``core.adaptive.TenantDeadlineParity``).
  * ``StragglerInjection`` / ``ShardLatencyModel`` — per-shard two-state
    Markov straggling (healthy/slow regimes, geometric sojourns) plus
    multiplicative noise.  The mask the engine commits to each step is
    computed from backward-looking EW latency *estimates* (what a real
    health monitor knows); the realized latencies are only observed after —
    so a fresh straggler costs every policy its detection lag, and policies
    differ only in what they do with the same information.
  * ``simulate_serve`` — the deterministic model-time serving loop: one
    batched decode step at a time, step duration = body compute + the
    slowest KEPT shard's realized latency + decode/re-encode overheads.
    It reuses the real ``ParityController`` posterior and the real
    ``DeadlineAwareParity`` rule, so the simulated policies are the ones
    the live engine runs, not re-implementations.
  * ``simulate_serve_batch`` — the trial-batched mirror (the
    ``simulate_adaptive_batch`` pattern): T independent trials advanced in
    lockstep rounds, the shard-latency data plane ([T, n_shards] RNG
    realization, regime updates, kept-set max, EW estimates) evaluated as
    trial-axis array ops with every float expression term-for-term
    identical to the scalar loop, the per-trial control plane (WFQ
    admission, token emission, the parity policy's posterior) driven by
    the SAME scalar objects the oracle uses.  Bit-identical per trial to
    ``simulate_serve`` by construction — asserted across the full trace ×
    injection × policy grid in tests/test_serve_batch.py and per bench
    cell — which is what lets benchmarks/serve_bench.py sweep 10⁵+
    requests per cell.

Policies simulated (the serve benchmark's three arms):

  uncoded   — the head is TP-sharded with no parity: every step waits for
              the slowest of all ``n_shards`` realized latencies.
  fixed     — parity budget ``k``: every step keeps the ``n_shards - k``
              estimate-fastest shards and pays the masked-decode overhead.
  adaptive  — ``DeadlineAwareParity``: parity level per step from the
              straggler posterior AND the tightest admitted request's SLO
              slack; healthy relaxed steps drop nobody (no overhead, best
              conditioning), pressured steps escalate to the full budget;
              a posterior that saturates the budget for ``topup_patience``
              consecutive steps raises it (the serving analogue of the
              executor's reserve top-up — one-off re-encode cost, then the
              extra laggard is droppable).

Everything is numpy + model time, deterministic in the seed.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, ClassVar

import numpy as np

from repro_torch.core.adaptive import (
    DeadlineAwareParity,
    ParityController,
    TenantDeadlineParity,
)
from repro_torch.core.results import ResultMapping
from repro_torch.serve.loadgen import ArrivalTrace

__all__ = [
    "ScheduledRequest",
    "TraceScheduler",
    "StragglerInjection",
    "ShardLatencyModel",
    "ServeSimResult",
    "simulate_serve",
    "simulate_serve_batch",
    "weighted_percentile",
]


def weighted_percentile(values: np.ndarray, weights: np.ndarray, q: float) -> float:
    """THE token-latency percentile definition (one home, shared by
    ``ServeSimResult`` and the serve benchmark's pooled cells): the
    smallest value whose cumulative weight reaches q% of the total."""
    values = np.asarray(values)
    if values.size == 0:
        return float("nan")
    order = np.argsort(values, kind="stable")
    cw = np.cumsum(np.asarray(weights, np.float64)[order])
    k = int(np.searchsorted(cw, q / 100.0 * cw[-1]))
    return float(values[order][min(k, len(order) - 1)])


# --------------------------------------------------------------------------
# Scheduler
# --------------------------------------------------------------------------
@dataclass
class ScheduledRequest:
    """One request's lifecycle under the scheduler (all times absolute)."""

    idx: int
    t_arrival: float
    n_tokens: int
    deadline: float
    payload: Any = None  # engine-side attachment (prompt Request)
    t_admit: float = np.nan
    t_complete: float = np.inf
    tokens_done: int = 0
    rejected: bool = False
    n_prefill: int = 0  # prompt tokens to process before the first decode
    tenant: int = 0  # SLO class index into trace.classes
    prefill_left: int = 0  # remaining prefill debt (0 = decode-ready)

    @property
    def admitted(self) -> bool:
        return np.isfinite(self.t_admit)

    @property
    def done(self) -> bool:
        return np.isfinite(self.t_complete)

    @property
    def slo_met(self) -> bool:
        return self.done and self.t_complete <= self.deadline

    @property
    def remaining(self) -> int:
        return self.n_tokens - self.tokens_done


class TraceScheduler:
    """Open-loop continuous-batching admission control over an
    ``ArrivalTrace``.

    The caller (simulator or live engine) calls, per step boundary:

      ``decode_ready()``          -> admission-ordered active requests with
                                     zero prefill debt (each is owed one
                                     decode token this step)
      ``consume_prefill(budget)`` -> spend prefill budget on existing debts
                                     in admission order
      ``admit(now, free_slots, prefill_budget)``
                                  -> WFQ admission into free slots (never
                                     beyond capacity); newly admitted
                                     requests spend prefill budget on their
                                     debt and their first decode token
      ``on_token(idx, now)``      -> one token emitted for an active request
                                     (records completion when the last one
                                     lands; the slot frees the same step)
      ``observe_step(dt)``        -> EW update of the step-time estimate

    ``min_slack_steps(now)`` / ``class_slack_steps(now)`` are the
    deadline-aware parity policies' inputs: the tightest admitted
    request's (deadline - now)/est_step - (remaining + remaining prefill
    steps), +inf when nothing is active — globally or per SLO class.

    Weighted fair queuing: arrivals queue FIFO per tenant class; each
    admission goes to the backlogged class minimizing the normalized
    virtual service ``(served_c + 1) / weight_c`` (ties to the lowest
    class index — the first-occurrence argmin, which is what keeps the
    batched mirror bit-identical).  ``served_c`` counts admissions only:
    an infeasible head is rejected without consuming service, so a class
    that keeps sending doomed requests cannot starve the others — and a
    backlogged class can never be starved because its virtual service
    stops advancing the moment it stops being picked (property-tested in
    tests/test_serve_batch.py).
    """

    def __init__(
        self,
        trace: ArrivalTrace,
        n_slots: int,
        *,
        t_step_init: float = 1.0,
        ew_decay: float = 0.8,
        admission: str = "deadline",
        payloads: list | None = None,
        step_budget: int | None = None,
    ):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        if admission not in ("deadline", "all"):
            raise ValueError(f"admission must be deadline|all, got {admission!r}")
        if not 0.0 <= ew_decay < 1.0 or t_step_init <= 0:
            raise ValueError("bad scheduler config")
        if payloads is not None and len(payloads) != trace.n_requests:
            raise ValueError("payloads length must match the trace")
        self.trace = trace
        self.n_slots = int(n_slots)
        self.step_budget = 2 * self.n_slots if step_budget is None else int(step_budget)
        if self.step_budget < self.n_slots:
            raise ValueError("step_budget must cover one decode token per slot")
        # nominal prefill tokens per step, for deadline projection: what is
        # left of the budget once every slot decodes
        self.pf_nominal = max(1, self.step_budget - self.n_slots)
        self.admission = admission
        self._ew_decay = float(ew_decay)
        self._est = float(t_step_init)
        self.requests = [
            ScheduledRequest(
                idx=i,
                t_arrival=float(trace.t_arrival[i]),
                n_tokens=int(trace.n_tokens[i]),
                deadline=float(trace.deadline[i]),
                payload=payloads[i] if payloads is not None else None,
                n_prefill=int(trace.n_prefill[i]),
                tenant=int(trace.tenant[i]),
                prefill_left=int(trace.n_prefill[i]),
            )
            for i in range(trace.n_requests)
        ]
        self.n_classes = trace.n_classes
        self._weights = [float(c.weight) for c in trace.classes]
        self._served = [0] * self.n_classes  # admissions per class (WFQ)
        self._queues: list[deque[int]] = [deque() for _ in range(self.n_classes)]
        self._next = 0  # trace cursor (arrival order)
        self._active: dict[int, ScheduledRequest] = {}  # admission-ordered
        # per-admit transients, read by the caller after each admit() call
        self.step_joined: list[int] = []  # admitted idxs decoding THIS step
        self.admit_prefill_spent = 0  # prefill debt tokens spent in admit()

    # ---- state views ----------------------------------------------------
    @property
    def est_step_time(self) -> float:
        return self._est

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def free_slots(self) -> int:
        return self.n_slots - self.n_active

    @property
    def finished(self) -> bool:
        """Every request is either completed or rejected."""
        return (
            self._next >= len(self.requests)
            and not self._active
            and all(not q for q in self._queues)
        )

    def next_arrival(self) -> float | None:
        """Arrival time of the next not-yet-admitted request (None if the
        trace is exhausted): the earliest of the per-class backlog heads
        and the trace cursor."""
        cand = [self.requests[q[0]].t_arrival for q in self._queues if q]
        if self._next < len(self.requests):
            cand.append(self.requests[self._next].t_arrival)
        return min(cand) if cand else None

    def pending(self, now: float) -> int:
        """Requests waiting for admission as of ``now``: the per-class
        backlogs plus trace-cursor arrivals with ``t_arrival <= now`` that
        a ``_pump`` would enqueue.  Non-mutating — the engine's macro-step
        K policy polls this between admission passes (DESIGN.md §14), and
        peeking must not advance the cursor."""
        n = sum(len(q) for q in self._queues)
        i = self._next
        while i < len(self.requests) and self.requests[i].t_arrival <= now:
            n += 1
            i += 1
        return n

    @property
    def has_prefill_debt(self) -> bool:
        """True while any admitted request still owes prefill tokens —
        the continuous-batching state where step budget must keep flowing
        to prefill chunks, so fused macro-steps stay at K=1."""
        return any(r.prefill_left > 0 for r in self._active.values())

    def _extra_steps(self, n_prefill: int) -> int:
        """Estimated steps the given prefill debt costs at the nominal
        per-step prefill budget (ceil division; 0 when no prefill)."""
        return -(-int(n_prefill) // self.pf_nominal)

    def min_slack_steps(self, now: float) -> float:
        """Tightest admitted request's deadline slack, in estimated steps
        (decode tokens still owed plus remaining prefill steps)."""
        if not self._active:
            return np.inf
        est = max(self._est, 1e-12)
        return min(
            (r.deadline - now) / est
            - (r.remaining + self._extra_steps(r.prefill_left))
            for r in self._active.values()
        )

    def class_slack_steps(self, now: float) -> np.ndarray:
        """Per-SLO-class tightest admitted slack in estimated steps, +inf
        for classes with nothing admitted (``TenantDeadlineParity`` input).
        The per-request term is float-identical to ``min_slack_steps``."""
        slacks = np.full(self.n_classes, np.inf)
        if not self._active:
            return slacks
        est = max(self._est, 1e-12)
        for r in self._active.values():
            s = (r.deadline - now) / est - (
                r.remaining + self._extra_steps(r.prefill_left)
            )
            if s < slacks[r.tenant]:
                slacks[r.tenant] = s
        return slacks

    # ---- caller hooks ---------------------------------------------------
    def observe_step(self, dt: float) -> None:
        """EW estimate of the per-step time (slack conversion + admission)."""
        if dt <= 0:
            return
        d = self._ew_decay
        self._est = d * self._est + (1.0 - d) * float(dt)

    def decode_ready(self) -> list[int]:
        """Admission-ordered active request idxs with zero prefill debt —
        the decode batch owed one token each this step."""
        return [i for i, r in self._active.items() if r.prefill_left == 0]

    def consume_prefill(self, budget: int) -> tuple[int, list[int]]:
        """Spend up to ``budget`` prefill tokens on existing debts in
        admission order.  Returns (tokens spent, idxs whose debt just hit
        zero — they may join decode this step if the caller still has a
        token of budget for each)."""
        spent = 0
        cleared: list[int] = []
        for r in self._active.values():
            if spent >= budget:
                break
            if r.prefill_left > 0:
                c = min(r.prefill_left, budget - spent)
                r.prefill_left -= c
                spent += c
                if r.prefill_left == 0:
                    cleared.append(r.idx)
        return spent, cleared

    def _pump(self, now: float) -> None:
        """Move every arrival <= now from the trace cursor into its class's
        FIFO backlog."""
        while self._next < len(self.requests):
            req = self.requests[self._next]
            if req.t_arrival > now:
                break
            self._queues[req.tenant].append(req.idx)
            self._next += 1

    def _wfq_pick(self) -> int | None:
        """Backlogged class with the least normalized virtual service
        ``(served + 1) / weight``; first-occurrence (lowest index) on ties,
        matching ``np.argmin`` in the batched mirror."""
        best = None
        best_v = np.inf
        for c in range(self.n_classes):
            if not self._queues[c]:
                continue
            v = (self._served[c] + 1) / self._weights[c]
            if v < best_v:
                best, best_v = c, v
        return best

    def admit(
        self,
        now: float,
        free_slots: int | None = None,
        prefill_budget: int | None = None,
    ) -> list[ScheduledRequest]:
        """Admit queued arrivals (arrival <= now) into free slots by
        weighted fair queuing over SLO classes (FIFO within a class).
        Infeasible requests — projected completion already past the
        deadline — are rejected without consuming a slot or virtual
        service.  The returned list never exceeds the free capacity, and
        total admitted occupancy never exceeds ``n_slots``.

        ``prefill_budget`` is this step's remaining new-work token budget:
        every admission costs at least one token from it (its first decode
        token, or its first prefill chunk), so per-step prefill + decode
        tokens can never exceed the caller's step budget.  Admission stops
        when the budget cannot start the WFQ-chosen head.  ``None`` (the
        live engine's slot-refill path, and the pre-continuous-batching
        callers) disables budget accounting: admitted requests keep their
        full debt and zero-debt admissions join decode immediately.

        After the call, ``step_joined`` holds the admitted idxs that decode
        this very step and ``admit_prefill_spent`` the prefill debt tokens
        spent on fresh admissions.
        """
        self._pump(now)
        cap = (
            self.free_slots if free_slots is None else min(free_slots, self.free_slots)
        )
        budget = prefill_budget
        self.step_joined = []
        self.admit_prefill_spent = 0
        out: list[ScheduledRequest] = []
        while cap > 0:
            c = self._wfq_pick()
            if c is None:
                break
            req = self.requests[self._queues[c][0]]
            if (
                self.admission == "deadline"
                and now
                + (req.n_tokens + self._extra_steps(req.n_prefill)) * self._est
                > req.deadline
            ):
                req.rejected = True
                self._queues[c].popleft()
                continue
            if budget is not None and budget < 1:
                break  # cannot start the head this step; try next step
            self._queues[c].popleft()
            req.t_admit = now
            self._active[req.idx] = req
            self._served[c] += 1
            out.append(req)
            cap -= 1
            if budget is None:
                if req.prefill_left == 0:
                    self.step_joined.append(req.idx)
                continue
            if req.n_prefill == 0:
                budget -= 1  # the first decode token
                self.step_joined.append(req.idx)
            else:
                chunk = min(req.prefill_left, budget)
                req.prefill_left -= chunk
                budget -= chunk
                self.admit_prefill_spent += chunk
                if req.prefill_left == 0 and budget >= 1:
                    budget -= 1  # prefill cleared AND first token affordable
                    self.step_joined.append(req.idx)
        assert self.n_active <= self.n_slots
        return out

    def on_token(self, idx: int, now: float) -> bool:
        """One token emitted for active request ``idx`` at time ``now``;
        returns True when the request just completed (slot is freed)."""
        req = self._active[idx]
        req.tokens_done += 1
        if req.tokens_done >= req.n_tokens:
            req.t_complete = now
            del self._active[idx]
            return True
        return False

    def on_finish(self, idx: int, now: float) -> None:
        """Force-complete an active request (engine-side early finish, e.g.
        EOS before the token budget).  No-op if already completed."""
        req = self._active.pop(idx, None)
        if req is not None and not req.done:
            req.t_complete = now

    def active_requests(self) -> list[ScheduledRequest]:
        return list(self._active.values())

    # ---- outcome arrays -------------------------------------------------
    def results(self) -> dict[str, np.ndarray]:
        return {
            "t_arrival": np.array([r.t_arrival for r in self.requests]),
            "t_admit": np.array([r.t_admit for r in self.requests]),
            "t_complete": np.array([r.t_complete for r in self.requests]),
            "deadline": np.array([r.deadline for r in self.requests]),
            "n_tokens": np.array([r.n_tokens for r in self.requests], np.int64),
            "slo_met": np.array([r.slo_met for r in self.requests], bool),
            "rejected": np.array([r.rejected for r in self.requests], bool),
            "tenant": np.array([r.tenant for r in self.requests], np.int64),
            "n_prefill": np.array([r.n_prefill for r in self.requests], np.int64),
        }


# --------------------------------------------------------------------------
# Shard latency model (straggler injection)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class StragglerInjection:
    """Per-shard two-state Markov straggling.

    onset       — per-shard per-step probability a healthy shard turns slow
                  (stationary slow fraction = onset·persistence /
                  (1 + onset·persistence)).
    slow_factor — latency multiplier while slow.
    persistence — mean steps a slow regime lasts (geometric sojourn).
    noise       — multiplicative healthy jitter: latency × (1 + noise·U).
    """

    onset: float
    slow_factor: float = 50.0
    persistence: float = 25.0
    noise: float = 0.1

    def __post_init__(self):
        if not 0.0 <= self.onset < 1.0 or self.slow_factor < 1.0:
            raise ValueError(f"bad injection {self}")
        if self.persistence < 1.0 or self.noise < 0.0:
            raise ValueError(f"bad injection {self}")


class ShardLatencyModel:
    """Seeded per-step shard latencies under ``StragglerInjection``."""

    def __init__(
        self,
        n_shards: int,
        t_shard: float,
        injection: StragglerInjection | None,
        seed: int = 0,
    ):
        self.n_shards = int(n_shards)
        self.t_shard = float(t_shard)
        self.injection = injection
        self._rng = np.random.default_rng(seed)
        self.slow = np.zeros(self.n_shards, bool)

    def step(self) -> np.ndarray:
        """Advance regimes one step and draw this step's realized latencies."""
        inj = self.injection
        lat = self.t_shard * (
            1.0 + (inj.noise if inj else 0.1) * self._rng.random(self.n_shards)
        )
        if inj is not None and inj.onset > 0.0:
            u = self._rng.random(self.n_shards)
            recover = self.slow & (u < 1.0 / inj.persistence)
            onset = ~self.slow & (u < inj.onset)
            self.slow = (self.slow & ~recover) | onset
            lat = np.where(self.slow, lat * inj.slow_factor, lat)
        return lat


# --------------------------------------------------------------------------
# The model-time serving simulator
# --------------------------------------------------------------------------
@dataclass(eq=False)
class ServeSimResult(ResultMapping):
    """One policy's full run over a trace (absolute model time).

    Shares the unified result surface (``core.results.ResultMapping``,
    DESIGN.md §15): ``res["t_complete"]`` / ``dict(res)`` work exactly as
    they do on the executor's ``TaskResult`` and the MC ``SimResult``.
    """

    policy: str
    t_complete: np.ndarray  # [R] inf where rejected
    t_admit: np.ndarray  # [R] nan where rejected
    slo_met: np.ndarray  # [R] bool
    rejected: np.ndarray  # [R] bool
    step_times: np.ndarray  # [S] per-step durations
    step_tokens: np.ndarray  # [S] decode tokens emitted per step
    parity_levels: np.ndarray  # [S] shards dropped per step
    topups: int  # parity-budget raises performed
    makespan: float
    attainment: float  # fraction of ALL requests meeting their SLO
    goodput: float  # SLO-met tokens per model-time unit
    throughput: float  # all completed tokens per model-time unit
    step_prefill: np.ndarray = field(default=None)  # [S] prefill tokens/step
    tenant: np.ndarray = field(default=None)  # [R] SLO class per request
    class_attainment: np.ndarray = field(default=None)  # [C] per-class SLO
    class_max_wait: np.ndarray = field(default=None)  # [C] worst queue wait
    occupancy: float = 0.0  # mean decode tokens per step / n_slots

    PAYLOAD_FIELDS: ClassVar[tuple[str, ...]] = (
        "policy", "slo_met", "rejected", "step_tokens", "parity_levels",
        "topups", "tenant",
    )
    TIMING_FIELDS: ClassVar[tuple[str, ...]] = (
        "t_complete", "t_admit", "step_times", "makespan",
    )

    def token_latency_percentile(self, q: float) -> float:
        """Percentile of per-token decode latency (each emitted token's
        latency is the duration of the step that produced it)."""
        return weighted_percentile(self.step_times, self.step_tokens, q)


def _finalize_serve(
    policy: str,
    sched: TraceScheduler,
    trace: ArrivalTrace,
    t: float,
    step_times: list[float],
    step_tokens: list[int],
    step_prefill: list[int],
    parity_levels: list[int],
    topups: int,
    n_slots: int,
) -> ServeSimResult:
    """Outcome aggregation shared verbatim by the scalar loop and the
    batched mirror (one home, so per-trial results cannot drift)."""
    res = sched.results()
    makespan = max(t - float(trace.t_arrival[0]), 1e-12)
    good_tokens = int(res["n_tokens"][res["slo_met"]].sum())
    done = np.isfinite(res["t_complete"])
    done_tokens = int(res["n_tokens"][done].sum())
    n_classes = trace.n_classes
    class_att = np.ones(n_classes)
    class_wait = np.zeros(n_classes)
    admitted = np.isfinite(res["t_admit"])
    wait = np.where(admitted, res["t_admit"] - res["t_arrival"], 0.0)
    for c in range(n_classes):
        sel = res["tenant"] == c
        if sel.any():
            class_att[c] = float(res["slo_met"][sel].mean())
        if (sel & admitted).any():
            class_wait[c] = float(wait[sel & admitted].max())
    step_tok = np.asarray(step_tokens, np.int64)
    return ServeSimResult(
        policy=policy,
        t_complete=res["t_complete"],
        t_admit=res["t_admit"],
        slo_met=res["slo_met"],
        rejected=res["rejected"],
        step_times=np.asarray(step_times),
        step_tokens=step_tok,
        parity_levels=np.asarray(parity_levels, np.int64),
        topups=topups,
        makespan=makespan,
        attainment=float(res["slo_met"].mean()) if len(res["slo_met"]) else 1.0,
        goodput=good_tokens / makespan,
        throughput=done_tokens / makespan,
        step_prefill=np.asarray(step_prefill, np.int64),
        tenant=res["tenant"],
        class_attainment=class_att,
        class_max_wait=class_wait,
        occupancy=float(step_tok.mean() / n_slots) if len(step_tok) else 0.0,
    )


def _make_parity_policy(
    trace: ArrivalTrace,
    n_shards: int,
    controller_decay: float,
    escalate_steps: float,
    tenant_parity: bool,
) -> DeadlineAwareParity:
    """The parity policy both engines instantiate (one home, so the scalar
    oracle and the batched mirror cannot configure it differently)."""
    ctrl = ParityController(n_shards, decay=controller_decay)
    if tenant_parity:
        return TenantDeadlineParity(
            ctrl, classes=trace.classes, escalate_steps=escalate_steps
        )
    return DeadlineAwareParity(ctrl, escalate_steps=escalate_steps)


def simulate_serve(
    trace: ArrivalTrace,
    policy: str,
    *,
    n_shards: int = 16,
    parity: int = 4,
    n_slots: int = 8,
    t_body: float = 0.5,
    t_shard: float = 0.5,
    injection: StragglerInjection | None = None,
    seed: int = 0,
    decode_overhead: float = 0.03,
    reencode_cost: float = 30.0,
    parity_max: int = 8,
    topup_patience: int = 4,
    escalate_steps: float = 8.0,
    controller_decay: float = 0.45,
    est_decay: float = 0.5,
    admission: str = "deadline",
    max_steps: int = 500_000,
    step_budget: int | None = None,
    tenant_parity: bool = False,
) -> ServeSimResult:
    """Deterministic model-time run of one policy over one trace.

    Step anatomy (one batched decode step over the continuous batch):

      T = t_body                       (attention/MLP stack, unsharded here)
        + max over KEPT shards of the realized head-shard latency
        + decode_overhead              (iff any shard was dropped: the
                                        recovery matmul + conditioning guard
                                        of the non-systematic read-off)
        + reencode_cost                (iff this step raised the parity
                                        budget: one on-device re-encode +
                                        re-jit, the engine's ``_raise_parity``)

    Continuous batching: each step carries ``step_budget`` tokens (default
    ``2 × n_slots``).  One token is reserved per decode-ready slot; the
    remainder pays down prefill debts in admission order and starts fresh
    WFQ admissions (a request whose prefill clears emits its first decode
    token the same step — the prefill forward pass produces it — when a
    budget token remains).  A completing request's slot frees at the end
    of the step, so the step's admissions already see it.  With a
    zero-prefill single-class trace and the default budget the loop is
    bit-identical to the pre-continuous-batching simulator (the committed
    golden fixture still verifies).

    The kept set is the ``n_shards - nu`` fastest by the EW latency
    ESTIMATE (what ``first_decodable_mask`` sees in the live engine); the
    realized latencies are only revealed after the mask commits, so a fresh
    straggler costs every policy the same detection lag.  ``tenant_parity``
    swaps the adaptive policy's scalar min-slack input for the per-class
    vector (``TenantDeadlineParity``): each SLO class converts its own
    slack at its own escalation threshold and the step runs at the max.
    """
    if policy not in ("uncoded", "fixed", "adaptive"):
        raise ValueError(f"policy must be uncoded|fixed|adaptive, got {policy!r}")
    if not 0 <= parity <= parity_max < n_shards:
        raise ValueError("need 0 <= parity <= parity_max < n_shards")
    shards = ShardLatencyModel(n_shards, t_shard, injection, seed=seed)
    nominal = t_body + t_shard * (1.0 + 0.5 * (injection.noise if injection else 0.1))
    sched = TraceScheduler(
        trace,
        n_slots,
        t_step_init=nominal,
        admission=admission,
        step_budget=step_budget,
    )
    # a reactive posterior (decay ~0.45: one laggard step convicts, one
    # healthy step acquits) keeps the adaptive policy's detection lag at
    # the same single step the EW estimate already costs every policy
    dap = _make_parity_policy(
        trace, n_shards, controller_decay, escalate_steps, tenant_parity
    )
    lat_est = np.full(n_shards, t_shard * 1.05)  # EW latency estimates
    budget = int(parity)
    saturated = 0
    topups = 0
    t = 0.0
    step_times: list[float] = []
    step_tokens: list[int] = []
    step_prefill: list[int] = []
    parity_levels: list[int] = []
    for _ in range(max_steps):
        if sched.finished:
            break
        # ---- continuous-batching token budget ---------------------------
        emit = sched.decode_ready()  # one reserved token each
        pf_budget = sched.step_budget - len(emit)
        spent, cleared = sched.consume_prefill(pf_budget)
        pf_budget -= spent
        for i in cleared:
            if pf_budget >= 1:  # first token rides the final prefill chunk
                pf_budget -= 1
                emit.append(i)
        sched.admit(t, prefill_budget=pf_budget)
        emit.extend(sched.step_joined)
        prefill_tokens = spent + sched.admit_prefill_spent
        if sched.n_active == 0:
            nxt = sched.next_arrival()
            if nxt is None:
                break
            t = max(t, nxt)
            continue
        # ---- choose this step's parity level from ESTIMATES only --------
        extra = 0.0
        if policy == "uncoded":
            nu = 0
        elif policy == "fixed":
            nu = budget
        else:
            believed = int((dap.controller.posterior > 0.5).sum())
            if believed > budget:
                saturated += 1
                if saturated >= topup_patience and budget < parity_max:
                    budget += 1
                    topups += 1
                    saturated = 0
                    extra += reencode_cost
            else:
                saturated = 0
            slack = (
                sched.class_slack_steps(t)
                if tenant_parity
                else sched.min_slack_steps(t)
            )
            nu = dap.level(budget, slack)
        kept = np.argsort(lat_est, kind="stable")[: n_shards - nu]
        # ---- realize the step -------------------------------------------
        lat = shards.step()
        wait = float(lat[kept].max())
        dt = t_body + wait + (decode_overhead if nu > 0 else 0.0) + extra
        t += dt
        # monitoring sees every shard's completion (late results still
        # arrive); estimates and the posterior update from realized times
        d = est_decay
        lat_est = d * lat_est + (1.0 - d) * lat
        if policy == "adaptive":  # the posterior only steers this policy
            dap.observe(lat)
        sched.observe_step(dt)
        for i in emit:
            sched.on_token(i, t)
        step_times.append(dt)
        step_tokens.append(len(emit))
        step_prefill.append(prefill_tokens)
        parity_levels.append(nu)
    else:
        raise RuntimeError(f"simulate_serve exceeded max_steps={max_steps}")
    return _finalize_serve(
        policy,
        sched,
        trace,
        t,
        step_times,
        step_tokens,
        step_prefill,
        parity_levels,
        topups,
        n_slots,
    )


class _BatchedShardRNG:
    """Per-trial shard-latency streams with block-buffered draws.

    Bit-identity contract with ``ShardLatencyModel``: a numpy Generator
    fills a C-contiguous ``random((B, 2, n))`` block from the same stream
    positions as B successive (noise, regime) ``random(n)`` call pairs, so
    slicing the buffer row by row reproduces the scalar model's draws
    exactly — including the one-draw-per-step layout when the injection
    has no onset (the scalar model skips the regime draw entirely).  Idle
    trials draw nothing (their pointer does not advance), matching the
    scalar loop's idle-jump iterations.
    """

    def __init__(
        self,
        n_shards: int,
        t_shard: float,
        injection: StragglerInjection | None,
        seeds: list[int],
        block: int = 512,
    ):
        self.n_shards = int(n_shards)
        self.t_shard = float(t_shard)
        self.injection = injection
        self._two = injection is not None and injection.onset > 0.0
        self._block = int(block)
        self._rngs = [np.random.default_rng(s) for s in seeds]
        self._bufs: list[np.ndarray | None] = [None] * len(seeds)
        self._ptrs = [self._block] * len(seeds)
        self.slow = np.zeros((len(seeds), self.n_shards), bool)

    def _draw(self, i: int) -> np.ndarray:
        if self._ptrs[i] >= self._block:
            shape = (self._block, 2 if self._two else 1, self.n_shards)
            self._bufs[i] = self._rngs[i].random(shape)
            self._ptrs[i] = 0
        out = self._bufs[i][self._ptrs[i]]
        self._ptrs[i] += 1
        return out

    def step(self, trials: list[int]) -> np.ndarray:
        """Advance the given trials one busy step; returns their realized
        latencies as [len(trials), n_shards] — float-identical to each
        trial's ``ShardLatencyModel.step()``."""
        rows = np.stack([self._draw(i) for i in trials])
        inj = self.injection
        lat = self.t_shard * (
            1.0 + (inj.noise if inj else 0.1) * rows[:, 0]
        )
        if self._two:
            u = rows[:, 1]
            slow = self.slow[trials]
            recover = slow & (u < 1.0 / inj.persistence)
            onset = ~slow & (u < inj.onset)
            slow = (slow & ~recover) | onset
            self.slow[trials] = slow
            lat = np.where(slow, lat * inj.slow_factor, lat)
        return lat


def simulate_serve_batch(
    trace: ArrivalTrace,
    policy: str,
    *,
    n_trials: int,
    n_shards: int = 16,
    parity: int = 4,
    n_slots: int = 8,
    t_body: float = 0.5,
    t_shard: float = 0.5,
    injection: StragglerInjection | None = None,
    seed0: int = 0,
    decode_overhead: float = 0.03,
    reencode_cost: float = 30.0,
    parity_max: int = 8,
    topup_patience: int = 4,
    escalate_steps: float = 8.0,
    controller_decay: float = 0.45,
    est_decay: float = 0.5,
    admission: str = "deadline",
    max_steps: int = 500_000,
    step_budget: int | None = None,
    tenant_parity: bool = False,
    rng_block: int = 512,
) -> list[ServeSimResult]:
    """Trial-batched ``simulate_serve``: trials ``i = 0..n_trials-1`` run
    seed ``seed0 + i`` over the same trace in lockstep rounds, and trial i
    is BIT-IDENTICAL to ``simulate_serve(..., seed=seed0 + i)`` (the
    batched-engine contract; asserted in tests/test_torch_serve_traffic.py).

    What is batched: the shard-latency data plane — RNG realization
    (block-buffered per trial), straggler regime updates, the kept-set max
    over estimate-sorted realized latencies, the EW estimate update, and
    the step-duration arithmetic — all evaluated as [active_trials,
    n_shards] array ops whose float expressions are term-for-term those of
    the scalar loop (max over a fixed subset and elementwise FMA-free
    arithmetic are reassociation-safe).  What stays per-trial scalar: the
    control plane — WFQ admission, prefill-debt bookkeeping, token
    emission, and the ``DeadlineAwareParity`` posterior — which reuses the
    EXACT objects the oracle runs (``TraceScheduler``, the policy from
    ``_make_parity_policy``), so divergence there is impossible by
    construction rather than by re-implementation.

    Wall-clock: the small-array numpy overhead that dominates the scalar
    loop (a dozen ~16-element kernel launches per step) is amortized
    across the trial axis, which is what lets benchmarks/serve_bench.py
    sweep 10⁵+ requests per cell.
    """
    if n_trials < 1:
        raise ValueError("need at least one trial")
    if policy not in ("uncoded", "fixed", "adaptive"):
        raise ValueError(f"policy must be uncoded|fixed|adaptive, got {policy!r}")
    if not 0 <= parity <= parity_max < n_shards:
        raise ValueError("need 0 <= parity <= parity_max < n_shards")
    T = int(n_trials)
    nominal = t_body + t_shard * (1.0 + 0.5 * (injection.noise if injection else 0.1))
    scheds = [
        TraceScheduler(
            trace,
            n_slots,
            t_step_init=nominal,
            admission=admission,
            step_budget=step_budget,
        )
        for _ in range(T)
    ]
    daps = [
        _make_parity_policy(
            trace, n_shards, controller_decay, escalate_steps, tenant_parity
        )
        for _ in range(T)
    ]
    stream = _BatchedShardRNG(
        n_shards,
        t_shard,
        injection,
        [seed0 + i for i in range(T)],
        block=rng_block,
    )
    lat_est = np.full((T, n_shards), t_shard * 1.05)
    budget = [int(parity)] * T
    saturated = [0] * T
    topups = [0] * T
    t = np.zeros(T)
    iters = [0] * T
    alive = [True] * T
    step_times: list[list[float]] = [[] for _ in range(T)]
    step_tokens: list[list[int]] = [[] for _ in range(T)]
    step_prefill: list[list[int]] = [[] for _ in range(T)]
    parity_levels: list[list[int]] = [[] for _ in range(T)]
    emits: list[list[int]] = [[] for _ in range(T)]
    pf: list[int] = [0] * T
    while any(alive):
        busy: list[int] = []
        nus: list[int] = []
        extras: list[float] = []
        for i in range(T):
            if not alive[i]:
                continue
            sched = scheds[i]
            if sched.finished:
                alive[i] = False
                continue
            iters[i] += 1
            if iters[i] > max_steps:
                raise RuntimeError(f"simulate_serve exceeded max_steps={max_steps}")
            now = float(t[i])
            # ---- continuous-batching token budget (scalar loop verbatim)
            emit = sched.decode_ready()
            pf_budget = sched.step_budget - len(emit)
            spent, cleared = sched.consume_prefill(pf_budget)
            pf_budget -= spent
            for r in cleared:
                if pf_budget >= 1:
                    pf_budget -= 1
                    emit.append(r)
            sched.admit(now, prefill_budget=pf_budget)
            emit.extend(sched.step_joined)
            pf[i] = spent + sched.admit_prefill_spent
            if sched.n_active == 0:
                nxt = sched.next_arrival()
                if nxt is None:
                    alive[i] = False
                else:
                    t[i] = max(now, nxt)
                continue
            # ---- parity level from ESTIMATES only (scalar loop verbatim)
            extra = 0.0
            if policy == "uncoded":
                nu = 0
            elif policy == "fixed":
                nu = budget[i]
            else:
                dap = daps[i]
                believed = int((dap.controller.posterior > 0.5).sum())
                if believed > budget[i]:
                    saturated[i] += 1
                    if saturated[i] >= topup_patience and budget[i] < parity_max:
                        budget[i] += 1
                        topups[i] += 1
                        saturated[i] = 0
                        extra += reencode_cost
                else:
                    saturated[i] = 0
                slack = (
                    sched.class_slack_steps(now)
                    if tenant_parity
                    else sched.min_slack_steps(now)
                )
                nu = dap.level(budget[i], slack)
            busy.append(i)
            nus.append(nu)
            extras.append(extra)
            emits[i] = emit
        if not busy:
            continue
        act = np.asarray(busy)
        nu_a = np.asarray(nus, np.int64)
        # ---- realize the round: [A, n_shards] data plane ----------------
        est = lat_est[act]
        order = np.argsort(est, axis=1, kind="stable")
        lat = stream.step(busy)
        lat_by_est = np.take_along_axis(lat, order, axis=1)
        keep = np.arange(n_shards)[None, :] < (n_shards - nu_a)[:, None]
        wait = np.where(keep, lat_by_est, -np.inf).max(axis=1)
        dt = (
            t_body
            + wait
            + np.where(nu_a > 0, decode_overhead, 0.0)
            + np.asarray(extras)
        )
        t[act] += dt
        lat_est[act] = est_decay * est + (1.0 - est_decay) * lat
        for j, i in enumerate(busy):
            if policy == "adaptive":
                daps[i].observe(lat[j])
            scheds[i].observe_step(float(dt[j]))
            now = float(t[i])
            for r in emits[i]:
                scheds[i].on_token(r, now)
            step_times[i].append(float(dt[j]))
            step_tokens[i].append(len(emits[i]))
            step_prefill[i].append(pf[i])
            parity_levels[i].append(int(nu_a[j]))
    return [
        _finalize_serve(
            policy,
            scheds[i],
            trace,
            float(t[i]),
            step_times[i],
            step_tokens[i],
            step_prefill[i],
            parity_levels[i],
            topups[i],
            n_slots,
        )
        for i in range(T)
    ]
