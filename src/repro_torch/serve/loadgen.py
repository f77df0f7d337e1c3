"""Open-loop traffic generation for the serving layer (DESIGN.md §10).

The serve engine so far consumed a PRE-LOADED queue: every request exists at
t = 0 and nobody has a deadline, so "requests per second under stragglers"
was never a measurable quantity.  This module makes traffic first-class: an
``ArrivalTrace`` is an open-loop schedule of (arrival time, decode tokens,
absolute deadline) triples — open-loop meaning arrivals do NOT react to the
system's backlog (the standard way to expose an overloaded serving system;
a closed loop self-throttles and hides the collapse).

Three generators, mirroring how serving systems are actually driven:

  * ``poisson_trace``  — memoryless arrivals at a constant rate (the M/ side
    of the queueing model; what a large population of independent users
    aggregates to).
  * ``bursty_trace``   — a two-state Markov-modulated Poisson process: an
    ON state at ``burst_factor`` × the base rate for ``duty`` of the time.
    Bursts are what actually kill SLOs — a trace with the same mean rate
    but bursty arrivals queues far deeper.
  * ``replay_trace``   — arrivals replayed from explicit arrays (a recorded
    production trace, or a committed fixture so CI runs the exact same
    traffic every time).

Deadlines are per-request token SLOs: ``deadline = arrival +
queue_grace * t_token + slo_factor * n_tokens * t_token`` — a fixed
queueing allowance plus a per-token budget at ``slo_factor`` × the nominal
healthy step time.  All times are in abstract model-time units (the
simulator uses t_token ~ 1.0; the real engine feeds wall-clock seconds).

Multi-tenant SLO classes (DESIGN.md §13): every request carries a tenant
class index into ``ArrivalTrace.classes`` — an ``SLOClass`` names the
tenant's weighted-fair-queuing ``weight`` (admission share under
contention), its deadline terms (``slo_factor``/``queue_grace``), and the
``share`` of generated requests it receives.  A trace built without
``classes`` has the single default class, which makes every tenant-aware
code path degrade exactly to the pre-tenant behaviour.  Requests also
carry ``n_prefill`` — prompt tokens that must be processed before the
first decode token; the continuous-batching scheduler draws them from the
same per-step token budget decode uses.  Generators default to
``mean_prefill=0`` so existing single-class traces are bit-identical to
what they were before tenants existed.

Everything here is numpy-only and deterministic in the seed — the same
discipline as ``core.simulator``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "SLOClass",
    "ArrivalTrace",
    "poisson_trace",
    "bursty_trace",
    "replay_trace",
]


@dataclass(frozen=True)
class SLOClass:
    """One tenant SLO class: WFQ weight + deadline terms + traffic share.

    weight      — weighted-fair-queuing admission weight (> 0): under
                  contention class c receives admissions in proportion to
                  ``weight_c`` (see ``TraceScheduler``).
    slo_factor  — per-token deadline budget multiple for this class.
    queue_grace — fixed queueing allowance (in t_token units).
    share       — fraction of generated requests assigned to this class
                  (generators only; shares are normalized internally).
    escalate_steps — slack threshold (in estimated steps) below which the
                  per-tenant deadline parity policy starts escalating for
                  this class (``core.adaptive.TenantDeadlineParity``).
    """

    name: str = "default"
    weight: float = 1.0
    slo_factor: float = 4.0
    queue_grace: float = 30.0
    share: float = 1.0
    escalate_steps: float = 8.0

    def __post_init__(self):
        if self.weight <= 0 or self.share < 0:
            raise ValueError(f"bad SLO class {self}")
        if self.slo_factor <= 0 or self.queue_grace < 0 or self.escalate_steps <= 0:
            raise ValueError(f"bad SLO class {self}")


_DEFAULT_CLASSES = (SLOClass(),)


@dataclass(frozen=True)
class ArrivalTrace:
    """An open-loop request schedule: sorted arrivals, token demands, SLOs.

    ``n_prefill`` (prompt tokens to process before the first decode token)
    and ``tenant`` (index into ``classes``) default to zeros — a trace
    without prefill demand or tenants behaves exactly as before either
    existed."""

    t_arrival: np.ndarray  # [R] float64, nondecreasing
    n_tokens: np.ndarray  # [R] int64, decode tokens requested (>= 1)
    deadline: np.ndarray  # [R] float64, absolute completion deadline
    kind: str = "replay"
    n_prefill: np.ndarray | None = None  # [R] int64, prompt tokens (>= 0)
    tenant: np.ndarray | None = None  # [R] int64, index into classes
    classes: tuple[SLOClass, ...] = _DEFAULT_CLASSES

    def __post_init__(self):
        t = np.asarray(self.t_arrival, np.float64)
        n = np.asarray(self.n_tokens, np.int64)
        d = np.asarray(self.deadline, np.float64)
        if not (len(t) == len(n) == len(d)):
            raise ValueError("trace arrays disagree on request count")
        if len(t) and (np.diff(t) < 0).any():
            raise ValueError("arrivals must be sorted nondecreasing")
        if (n < 1).any():
            raise ValueError("every request needs >= 1 token")
        if (d <= t).any():
            raise ValueError("deadlines must fall after arrivals")
        p = (
            np.zeros(len(t), np.int64)
            if self.n_prefill is None
            else np.asarray(self.n_prefill, np.int64)
        )
        c = (
            np.zeros(len(t), np.int64)
            if self.tenant is None
            else np.asarray(self.tenant, np.int64)
        )
        if len(p) != len(t) or len(c) != len(t):
            raise ValueError("n_prefill/tenant length must match the trace")
        if (p < 0).any():
            raise ValueError("n_prefill must be >= 0")
        if not self.classes:
            raise ValueError("trace needs at least one SLO class")
        if len(c) and ((c < 0) | (c >= len(self.classes))).any():
            raise ValueError("tenant indices out of range for classes")
        object.__setattr__(self, "t_arrival", t)
        object.__setattr__(self, "n_tokens", n)
        object.__setattr__(self, "deadline", d)
        object.__setattr__(self, "n_prefill", p)
        object.__setattr__(self, "tenant", c)
        object.__setattr__(self, "classes", tuple(self.classes))

    @property
    def n_requests(self) -> int:
        return len(self.t_arrival)

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    def class_weights(self) -> np.ndarray:
        return np.array([c.weight for c in self.classes], np.float64)

    @property
    def total_tokens(self) -> int:
        return int(self.n_tokens.sum())

    def offered_load(self, n_slots: int, t_token: float) -> float:
        """Mean offered utilization: token demand / slot-capacity over the
        arrival horizon (> 1 means the trace overloads the system even with
        every step at the nominal healthy time)."""
        horizon = (
            float(self.t_arrival[-1] - self.t_arrival[0])
            if self.n_requests > 1
            else 1.0
        )
        horizon = max(horizon, t_token)
        return self.total_tokens * t_token / (n_slots * horizon)


def _finish(
    t: np.ndarray,
    n: np.ndarray,
    *,
    t_token: float,
    slo_factor: float,
    queue_grace: float,
    kind: str,
    classes: tuple[SLOClass, ...] | None = None,
    tenant: np.ndarray | None = None,
    n_prefill: np.ndarray | None = None,
) -> ArrivalTrace:
    if classes is None:
        # Pre-tenant path: deadline terms come from the scalar arguments so
        # existing traces are bit-identical to before tenants existed.
        d = t + queue_grace * t_token + slo_factor * n * t_token
        return ArrivalTrace(
            t_arrival=t, n_tokens=n, deadline=d, kind=kind, n_prefill=n_prefill
        )
    cls = tuple(classes)
    ten = np.zeros(len(t), np.int64) if tenant is None else tenant
    grace = np.array([c.queue_grace for c in cls], np.float64)[ten]
    factor = np.array([c.slo_factor for c in cls], np.float64)[ten]
    d = t + grace * t_token + factor * n * t_token
    return ArrivalTrace(
        t_arrival=t,
        n_tokens=n,
        deadline=d,
        kind=kind,
        n_prefill=n_prefill,
        tenant=ten,
        classes=cls,
    )


def _draw_tokens(
    rng: np.random.Generator, n: int, mean_tokens: float, max_tokens: int
) -> np.ndarray:
    """Geometric-ish token demand (short requests dominate, a long tail),
    clipped to [1, max_tokens]."""
    raw = rng.geometric(p=min(1.0, 1.0 / max(mean_tokens, 1.0)), size=n)
    return np.clip(raw, 1, max_tokens).astype(np.int64)


def _draw_tenancy(
    rng: np.random.Generator,
    n: int,
    classes: tuple[SLOClass, ...] | None,
    mean_prefill: float,
    max_prefill: int,
) -> tuple[np.ndarray | None, np.ndarray | None]:
    """Tenant assignment + prompt lengths, drawn AFTER every pre-existing
    draw so the default (no classes, no prefill) leaves the generator's
    output bit-identical to the pre-tenant generators."""
    tenant = None
    if classes is not None:
        shares = np.array([c.share for c in classes], np.float64)
        if shares.sum() <= 0:
            raise ValueError("class shares must sum > 0")
        tenant = rng.choice(len(classes), size=n, p=shares / shares.sum())
        tenant = tenant.astype(np.int64)
    prefill = None
    if mean_prefill > 0.0:
        raw = rng.geometric(p=min(1.0, 1.0 / max(mean_prefill, 1.0)), size=n)
        prefill = np.clip(raw, 1, max(1, max_prefill)).astype(np.int64)
    return tenant, prefill


def poisson_trace(
    rate: float,
    n_requests: int,
    *,
    seed: int = 0,
    mean_tokens: float = 24.0,
    max_tokens: int = 128,
    t_token: float = 1.0,
    slo_factor: float = 4.0,
    queue_grace: float = 30.0,
    classes: tuple[SLOClass, ...] | None = None,
    mean_prefill: float = 0.0,
    max_prefill: int = 512,
) -> ArrivalTrace:
    """Constant-rate memoryless arrivals: ``rate`` requests per model-time
    unit, inter-arrival gaps ~ Exp(rate)."""
    if rate <= 0 or n_requests < 1:
        raise ValueError("rate and n_requests must be positive")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    t = np.cumsum(gaps)
    n = _draw_tokens(rng, n_requests, mean_tokens, max_tokens)
    tenant, prefill = _draw_tenancy(rng, n_requests, classes, mean_prefill, max_prefill)
    return _finish(
        t,
        n,
        t_token=t_token,
        slo_factor=slo_factor,
        queue_grace=queue_grace,
        kind="poisson",
        classes=classes,
        tenant=tenant,
        n_prefill=prefill,
    )


def bursty_trace(
    rate: float,
    n_requests: int,
    *,
    seed: int = 0,
    burst_factor: float = 6.0,
    duty: float = 0.2,
    mean_sojourn: float = 40.0,
    mean_tokens: float = 24.0,
    max_tokens: int = 128,
    t_token: float = 1.0,
    slo_factor: float = 4.0,
    queue_grace: float = 30.0,
    classes: tuple[SLOClass, ...] | None = None,
    mean_prefill: float = 0.0,
    max_prefill: int = 512,
) -> ArrivalTrace:
    """Two-state MMPP with the SAME mean rate as ``poisson_trace(rate)``:
    the process alternates OFF (rate_off) and ON (rate_on = burst_factor ×
    rate_off) regimes; state sojourns are exponential with mean
    ``mean_sojourn`` × duty (ON) and × (1 - duty) (OFF), so the ON state is
    occupied ``duty`` of the time and the time-average rate equals
    ``rate``."""
    if not 0.0 < duty < 1.0 or burst_factor < 1.0:
        raise ValueError("need 0 < duty < 1 and burst_factor >= 1")
    rng = np.random.default_rng(seed)
    # solve rate_off from the duty-weighted mean: duty*bf*ro + (1-duty)*ro = rate
    rate_off = rate / (duty * burst_factor + (1.0 - duty))
    rate_on = burst_factor * rate_off
    t = np.empty(n_requests)
    now = 0.0
    on = False
    seg_end = rng.exponential(mean_sojourn * (1.0 - duty))
    i = 0
    while i < n_requests:
        r = rate_on if on else rate_off
        gap = rng.exponential(1.0 / r)
        if now + gap < seg_end:
            now += gap
            t[i] = now
            i += 1
        else:
            now = seg_end
            on = not on
            seg_end = now + rng.exponential(
                mean_sojourn * (duty if on else (1.0 - duty))
            )
    n = _draw_tokens(rng, n_requests, mean_tokens, max_tokens)
    tenant, prefill = _draw_tenancy(rng, n_requests, classes, mean_prefill, max_prefill)
    return _finish(
        t,
        n,
        t_token=t_token,
        slo_factor=slo_factor,
        queue_grace=queue_grace,
        kind="bursty",
        classes=classes,
        tenant=tenant,
        n_prefill=prefill,
    )


def replay_trace(
    t_arrival,
    n_tokens,
    *,
    deadline=None,
    t_token: float = 1.0,
    slo_factor: float = 4.0,
    queue_grace: float = 30.0,
    classes: tuple[SLOClass, ...] | None = None,
    tenant=None,
    n_prefill=None,
) -> ArrivalTrace:
    """Arrivals replayed from explicit arrays (recorded traffic / fixtures).
    ``deadline`` may be given absolutely; otherwise the standard per-token
    SLO is applied (per-tenant terms when ``classes`` is given)."""
    t = np.asarray(t_arrival, np.float64)
    n = np.asarray(n_tokens, np.int64)
    ten = None if tenant is None else np.asarray(tenant, np.int64)
    pre = None if n_prefill is None else np.asarray(n_prefill, np.int64)
    if deadline is not None:
        return ArrivalTrace(
            t_arrival=t,
            n_tokens=n,
            deadline=np.asarray(deadline, np.float64),
            kind="replay",
            n_prefill=pre,
            tenant=ten,
            classes=_DEFAULT_CLASSES if classes is None else tuple(classes),
        )
    return _finish(
        t,
        n,
        t_token=t_token,
        slo_factor=slo_factor,
        queue_grace=queue_grace,
        kind="replay",
        classes=classes,
        tenant=ten,
        n_prefill=pre,
    )
