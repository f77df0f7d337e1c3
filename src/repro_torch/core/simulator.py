"""Event-driven simulator for batch-processing coded computing (paper §4).

Reproduces the paper's MATLAB simulation methodology exactly:

  * each worker draws one straggling realization per task
    (seconds-per-row = alpha_i + X/mu_i, X ~ Exp(1)), so batch k of size b_i
    arrives at  k * b_i * rate_i  — matching Eq. (3)'s T_{k,i},
  * optional unexpected stragglers (paper §5.3.1): with probability
    ``straggler_prob`` a worker's observed time is ``straggler_slowdown``
    (3x in the paper) times the actual computing time,
  * the task completes at the earliest t where the master has enough rows:
      - uncoded schemes need *every* assigned row (max over workers of the
        last-batch arrival),
      - coded schemes need ``required`` total rows where per-worker
        contribution is capped at its own load:  sum_i min(l_i, s_i(t) b_i).

Provides both completion-time sampling (Figs 3, 5, 8, 10, 11) and the
E[S(t)] accumulation trajectories (Figs 6, 9).

Performance: the Monte-Carlo hot loop is ARRAY-VECTORIZED across trials —
one [trials, events] arrival matrix per scheme, batched stable argsort /
cumsum / count-below instead of a per-trial Python event merge (the paper
sweeps are minutes of scalar looping otherwise; see benchmarks/decode_bench
for the measured speedup).  The scalar single-trial functions
(``completion_time``, ``accumulation_curve_scalar``) are KEPT as the
reference oracles; the batched paths reproduce them bit-for-bit on fixed
seeds (asserted in tests/test_simulator.py) because they evaluate the exact
same float expressions — same event template, same stable tie-break order,
same summation order where it matters.

Copied from ``repro.core.simulator``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.
The tests hold the copy bit-equal to the reference on the same seeds.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import ClassVar

import numpy as np

from repro_torch.core.allocation import Allocation, allocate
from repro_torch.core.distributions import ShiftedExp
from repro_torch.core.encoding import required_rows
from repro_torch.core.results import ResultMapping
from repro_torch.utils.prng import derive, rng as _rng, rng_scratch_iter as _rng_scratch_iter

__all__ = [
    "SimResult",
    "AdaptiveSimResult",
    "DecodeCostModel",
    "batch_arrival_schedule",
    "sample_rates",
    "sample_rates_batch",
    "completion_time",
    "completion_times_batch",
    "completion_time_with_decode",
    "completion_times_with_decode_batch",
    "simulate_scheme",
    "simulate_adaptive_scheme",
    "accumulation_curve",
    "accumulation_curve_scalar",
]


@dataclass(frozen=True, eq=False)
class SimResult(ResultMapping):
    """Monte-Carlo summary for one (scheme, scenario) cell.

    Shares the unified result surface (``core.results.ResultMapping``,
    DESIGN.md §15) with the executor's ``TaskResult``: dict-style access
    works, and the stable spelling ``res["t_complete"]`` resolves to the
    per-trial completion array whichever engine produced the result.
    """

    scheme: str
    times: np.ndarray  # [n_trials] completion times
    required: int      # rows the master needed
    tau: float         # analytic tau* (nan for uncoded)
    # decode-inclusive curves (None unless simulate_scheme got a decode_cost)
    times_decode_terminal: np.ndarray | None = None
    times_decode_pipelined: np.ndarray | None = None

    LEGACY_ALIASES: ClassVar[dict[str, str]] = {
        "t_complete": "times",  # the unified stable name (TaskResult parity)
        "t_decode": "times_decode_terminal",
        "t_decode_pipelined": "times_decode_pipelined",
    }
    PAYLOAD_FIELDS: ClassVar[tuple[str, ...]] = ("scheme", "required", "tau")
    TIMING_FIELDS: ClassVar[tuple[str, ...]] = (
        "times", "times_decode_terminal", "times_decode_pipelined",
    )

    @property
    def mean(self) -> float:
        return float(self.times.mean())

    @property
    def p99(self) -> float:
        return float(np.quantile(self.times, 0.99))


def sample_rates(
    workers: list[ShiftedExp],
    seed: int,
    straggler_prob: float = 0.0,
    straggler_slowdown: float = 3.0,
) -> np.ndarray:
    """Per-worker seconds-per-row for one task realization.

    One service-time draw per worker per task (the paper's model: batches of
    a task share the realization), then the unexpected-straggler multiplier.
    Workers may be any service-time model (ShiftedExp / Weibull / Pareto);
    draws come off one shared Generator in worker order.
    """
    g = _rng(seed)
    rates = np.array([w._draw(g) for w in workers], dtype=np.float64)
    if straggler_prob > 0.0:
        hit = g.uniform(size=len(workers)) < straggler_prob
        rates = np.where(hit, rates * straggler_slowdown, rates)
    return rates


def sample_rates_batch(
    workers: list[ShiftedExp],
    seeds: np.ndarray,
    straggler_prob: float = 0.0,
    straggler_slowdown: float = 3.0,
) -> np.ndarray:
    """[trials, n_workers] rate matrix — one ``sample_rates`` row per seed.

    Per-trial Generators are kept (the paper's seeding contract), but each
    trial's draws are array-sized: numpy Generators consume the bit stream
    identically for ``exponential(size=n)`` and n scalar calls, so every row
    is bit-identical to ``sample_rates`` (asserted in tests).  Clusters with
    non-shifted-exp members fall back to per-worker scalar draws in the same
    stream order — still bit-identical to ``sample_rates``, just not array-
    vectorized (mixed families have no common array sampler).
    """
    n = len(workers)
    if not all(type(w) is ShiftedExp for w in workers):
        rates = np.empty((len(seeds), n), dtype=np.float64)
        if straggler_prob > 0.0:
            hits = np.empty((len(seeds), n), dtype=bool)
            for t, g in enumerate(_rng_scratch_iter(seeds)):
                rates[t] = [w._draw(g) for w in workers]
                hits[t] = g.uniform(size=n) < straggler_prob
            return np.where(hits, rates * straggler_slowdown, rates)
        for t, g in enumerate(_rng_scratch_iter(seeds)):
            rates[t] = [w._draw(g) for w in workers]
        return rates
    alphas = np.array([w.alpha for w in workers], dtype=np.float64)
    mus = np.array([w.mu for w in workers], dtype=np.float64)
    draws = np.empty((len(seeds), n), dtype=np.float64)
    if straggler_prob > 0.0:
        hits = np.empty((len(seeds), n), dtype=bool)
        for t, g in enumerate(_rng_scratch_iter(seeds)):
            draws[t] = g.exponential(size=n)   # stream order as sample_rates:
            hits[t] = g.uniform(size=n) < straggler_prob  # exp first, then unif
    else:
        for t, g in enumerate(_rng_scratch_iter(seeds)):
            draws[t] = g.exponential(size=n)
    rates = alphas[None, :] + draws / mus[None, :]
    if straggler_prob > 0.0:
        rates = np.where(hits, rates * straggler_slowdown, rates)
    return rates


# --------------------------------------------------------------------------
# completion time: scalar oracle + batched hot path
# --------------------------------------------------------------------------
def _event_template(alloc: Allocation) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rate-independent batch-arrival events, in the canonical merge order.

    Worker i delivers batch k (of b_i rows, last batch clipped to l_i) at
    k*b_i*rate_i; events are laid out worker-major, k ascending — the same
    order the scalar loop concatenates them in, so a stable sort over the
    realized times tie-breaks identically.  Returns (kb, rows, widx):
    kb[e] = k*b of event e, rows[e] = rows it delivers, widx[e] = its worker.
    """
    kb: list[np.ndarray] = []
    ev_rows: list[np.ndarray] = []
    widx: list[np.ndarray] = []
    for i, (l, p) in enumerate(zip(alloc.loads, alloc.batches)):
        if l == 0:
            continue
        b = int(np.ceil(l / p))
        ks = np.arange(1, int(p) + 1, dtype=np.float64)
        cum = np.minimum(ks * b, l)               # cumulative rows after batch k
        kb.append(ks * b)                         # Eq. (3): arrival = k*b*rate
        ev_rows.append(np.diff(np.concatenate([[0.0], cum])))
        widx.append(np.full(int(p), i, dtype=np.int64))
    return np.concatenate(kb), np.concatenate(ev_rows), np.concatenate(widx)


def batch_arrival_schedule(
    alloc: Allocation, rates: np.ndarray
) -> list[tuple[float, int, int, int]]:
    """The EMULATOR's merged batch-arrival schedule, sorted by (t, wid, lo):
    (t_model, worker, global_row_lo, n_rows) per batch.

    This is the event algebra ``cluster._Worker`` executes — p_i clamped to
    the load, batch k of b_i = ceil(l_i / p_i) rows delivered at
    ``min(k·b_i, l_i) · rate_i`` (a short LAST batch arrives when its rows
    are done) — shared by the executor's master merge and
    benchmarks/streaming_bench so they cannot drift apart.  NOTE the
    deliberate difference from ``_event_template`` above: the paper's
    Eq. (3) model (and all simulator figures) keeps the unclipped k·b_i
    arrival for the short last batch.
    """
    offsets = np.concatenate([[0], np.cumsum(alloc.loads)])
    schedule: list[tuple[float, int, int, int]] = []
    for i, (l, p) in enumerate(zip(alloc.loads, alloc.batches)):
        l = int(l)
        if l == 0:
            continue
        pw = max(1, min(int(p), l))
        b = -(-l // pw)  # ceil
        for k in range(1, pw + 1):
            lo, hi = (k - 1) * b, min(k * b, l)
            if lo >= hi:
                break
            schedule.append(
                (hi * float(rates[i]), i, int(offsets[i]) + lo, hi - lo)
            )
    schedule.sort()
    return schedule


def completion_time(alloc: Allocation, rates: np.ndarray, required: int) -> float:
    """Earliest time the master can recover the result, given realized rates.

    Scalar single-trial REFERENCE (the oracle ``completion_times_batch`` is
    tested against bit-for-bit).  Uncoded: all workers must deliver their
    full load -> max_i l_i * rate_i.  Coded: merge per-batch arrival events
    and stop at ``required`` rows, capping each worker at its own l_i
    (paper: min(l_i, s_i b_i)).
    """
    loads = alloc.loads
    if not alloc.coded:
        return float(np.max(loads * rates))
    kb, rws, widx = _event_template(alloc)
    t = kb * rates[widx]
    order = np.argsort(t, kind="stable")
    csum = np.cumsum(rws[order])
    idx = int(np.searchsorted(csum, required - 1e-9))
    if idx >= len(t):
        return float(t[order][-1])  # even all rows are not enough (cannot happen
        # for valid allocations; defensive)
    return float(t[order][idx])


def completion_times_batch(
    alloc: Allocation, rates: np.ndarray, required: int
) -> np.ndarray:
    """Vectorized ``completion_time`` over a [trials, n_workers] rate matrix.

    Instead of materializing and sorting the [trials, events] arrival matrix
    (the scalar loop's O(E log E) per trial — E is the total batch count,
    ~q events for the paper's p_i = ⌊ℓ̂_i⌋ default), this exploits that the
    accumulated-rows curve S(t) = Σ_i min(l_i, s_i(t)·b_i) is a monotone step
    function evaluable in O(workers): a vectorized float bisection brackets
    the crossing S(t) >= required down to adjacent float64s, at which point
    the bracket's upper end IS the crossing event's time, bit-exactly.

    Two details keep it bit-identical to the scalar oracle:

      * arrived-batch counts are polished against the *exact* event-time
        expression ``(k*b) * rate`` (the float product the oracle sorts),
        because ``floor(t / (b*rate))`` can disagree by 1 ulp at boundaries;
      * S(t) sums integer-valued floats, so summation order cannot matter.

    The oracle's defensive tail (required never reached -> last event) falls
    out naturally: the predicate never fires and the initial upper bound —
    the latest last-batch arrival — is returned unchanged.
    """
    rates = np.asarray(rates, dtype=np.float64)
    if rates.ndim != 2:
        raise ValueError(f"rates must be [trials, workers], got {rates.shape}")
    loads = alloc.loads.astype(np.float64)
    if not alloc.coded:
        return np.max(loads[None, :] * rates, axis=1)
    batches = alloc.batches.astype(np.float64)
    active = loads > 0
    b = np.where(active, np.ceil(loads / batches), 0.0)[None, :]    # [1, N]
    p = np.where(active, batches, 0.0)[None, :]
    v = required - 1e-9
    # inf where inactive: t/inf = 0 arrived batches, no divide warnings
    br = b * rates
    br = np.where(br > 0.0, br, np.inf)                             # [T, N]

    def counts(t, br_, rates_):  # t [..., 1] -> [..., N] batches arrived by t
        # exact wrt the oracle's event expression (k*b)*rate: the float
        # division below is within 1 ulp of the true count, one up/down
        # polish fixes the boundary cases where they disagree
        k = np.clip(np.floor(t / br_), 0.0, p)
        kn = np.minimum(k + 1.0, p)
        k = np.where((kn * b) * rates_ <= t, kn, k)
        return np.where(((k * b) * rates_ > t) & (k > 0.0), k - 1.0, k)

    def rows_lower(t):  # t [T] -> [T] S(t), exact except possible OVERcount
        # bisection-only evaluator: keeps the up-polish (an undercount could
        # park ``lo`` at/after the crossing event and phase 2 would miss it)
        # but drops the down-polish — a 1-ulp overcount merely lands ``hi``
        # one float early, and phase 2 never relies on rows(hi) >= v.
        tt = t[:, None]
        k = np.clip(np.floor(tt / br), 0.0, p)
        kn = np.minimum(k + 1.0, p)
        k = np.where((kn * b) * rates <= tt, kn, k)
        return np.minimum(loads[None, :], k * b).sum(axis=-1)

    def rows_many(tc):  # tc [T, C] candidate times -> [T, C]
        k = counts(tc[:, :, None], br[:, None, :], rates[:, None, :])
        return np.minimum(loads[None, None, :], k * b).sum(axis=-1)

    hi = np.max((p * b) * rates, axis=1)          # latest last-batch arrival
    lo = np.zeros_like(hi)
    # phase 1 — bisect until each bracket is narrower than the tightest
    # event spacing (b_i * rate_i), i.e. holds at most ONE event per worker.
    # invariant: rows(lo) < v; rows(hi) >= v unless required is unreachable.
    spacing = 0.5 * np.min(br, axis=1)
    while True:
        mid = 0.5 * (lo + hi)
        go = (mid > lo) & (mid < hi) & (hi - lo > spacing)
        if not go.any():
            break
        ok = rows_lower(mid) >= v
        hi = np.where(go & ok, mid, hi)
        lo = np.where(go & ~ok, mid, lo)
    # phase 2 — snap: the crossing event is some worker's FIRST arrival
    # after lo (at most one candidate per worker fits in the bracket);
    # evaluate S exactly at every candidate, take the earliest that crosses.
    kn = counts(lo[:, None], br, rates) + 1.0                       # [T, N]
    valid = kn <= p
    cand = np.where(valid, (kn * b) * rates, 0.0)  # 0 placeholder: S(0) < v
    s_at = rows_many(cand)                                          # [T, N]
    cand = np.where(valid & (s_at >= v), cand, np.inf)
    t_star = cand.min(axis=1)
    # unreachable-required tail (oracle: return the very last event)
    return np.where(np.isfinite(t_star), t_star, hi)


# --------------------------------------------------------------------------
# Decode-overlap cost model: pipelined vs terminal decode completion
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class DecodeCostModel:
    """Master-side decode cost for the overlap model (DESIGN.md §7).

    ingest_per_row — seconds of incremental decode work per ingested coded
    row (peeling propagation / Gram accumulation); residual — flat seconds of
    post-threshold work (back-substitution / ripple drain).  Calibrate from
    ``benchmarks/streaming_bench.py`` measurements.
    """

    ingest_per_row: float
    residual: float = 0.0

    def __post_init__(self):
        if self.ingest_per_row < 0 or self.residual < 0:
            raise ValueError(f"decode costs must be >= 0, got {self}")


def completion_time_with_decode(
    alloc: Allocation,
    rates: np.ndarray,
    required: int,
    cost: DecodeCostModel | None,
) -> tuple[float, float]:
    """(terminal, pipelined) completion including master decode work — the
    scalar single-trial REFERENCE for ``completion_times_with_decode_batch``.

    Terminal: the master waits for the threshold crossing, then decodes
    everything — arrival of the crossing event + ingest work for every
    consumed batch + the residual.  Pipelined: each batch's ingest work
    overlaps the wait for the next arrival (a busy-time recurrence
    ``busy = max(t_k, busy) + w_k``), leaving only work that could not be
    hidden, + the residual.  With ``cost=None`` (overlap accounting off) both
    reduce EXACTLY to ``completion_time`` — bit-identical, asserted in
    tests.  Uncoded schemes have no decode: both equal the plain completion.
    """
    if cost is None or not alloc.coded:
        base = completion_time(alloc, rates, required)
        return base, base
    kb, rws, widx = _event_template(alloc)
    t = kb * rates[widx]
    order = np.argsort(t, kind="stable")
    ts, rw = t[order], rws[order]
    csum = np.cumsum(rw)
    idx = int(np.searchsorted(csum, required - 1e-9))
    idx = min(idx, len(ts) - 1)  # oracle's defensive tail: last event
    w = rw * cost.ingest_per_row
    cw = np.cumsum(w)                                  # W_k, 1-based prefixes
    terminal = float(ts[idx] + cw[idx] + cost.residual)
    # busy_K = W_K + max_{k<=K}(t_k − W_{k−1}): the busy-time recurrence
    # busy = max(t_k, busy) + w_k in closed form.  Max is rounding-free, so
    # fixing the summation association (prefix sums) makes the batched path
    # reproducible bit-for-bit; the naive recurrence agrees to ~1 ulp
    # (cross-checked in tests).
    wshift = np.concatenate([[0.0], cw[:-1]])
    busy = float(np.max((ts - wshift)[: idx + 1]) + cw[idx])
    return terminal, busy + cost.residual


def completion_times_with_decode_batch(
    alloc: Allocation,
    rates: np.ndarray,
    required: int,
    cost: DecodeCostModel | None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ``completion_time_with_decode`` over [trials, workers].

    Unlike ``completion_times_batch`` (which bisects to avoid materializing
    events), the pipelined busy-time needs every pre-crossing event, so this
    materializes the [trials, events] arrival matrix and uses the prefix-max
    identity  busy_K = W_K + max_{k<=K}(t_k − W_{k−1})  with W = cumsum(w).
    Summation/merge order matches the scalar oracle exactly.
    """
    rates = np.asarray(rates, dtype=np.float64)
    if rates.ndim != 2:
        raise ValueError(f"rates must be [trials, workers], got {rates.shape}")
    if cost is None or not alloc.coded:
        base = completion_times_batch(alloc, rates, required)
        return base, base
    kb, rws, widx = _event_template(alloc)
    t = kb[None, :] * rates[:, widx]                       # [T, E]
    order = np.argsort(t, axis=1, kind="stable")
    ts = np.take_along_axis(t, order, axis=1)
    rw = rws[order]                                        # [T, E]
    csum = np.cumsum(rw, axis=1)
    # crossing index per trial (defensive clamp to the last event)
    idx = (csum >= required - 1e-9).argmax(axis=1)
    missed = csum[:, -1] < required - 1e-9
    idx = np.where(missed, csum.shape[1] - 1, idx)
    w = rw * cost.ingest_per_row
    cw = np.cumsum(w, axis=1)                              # W_k (1-based prefix)
    take = np.arange(len(idx)), idx
    terminal = ts[take] + cw[take] + cost.residual
    wshift = np.concatenate([np.zeros((cw.shape[0], 1)), cw[:, :-1]], axis=1)
    busy = np.maximum.accumulate(ts - wshift, axis=1)[take] + cw[take]
    return terminal, busy + cost.residual


def simulate_scheme(
    scheme: str,
    r: int,
    workers: list[ShiftedExp],
    *,
    p: int | np.ndarray | None = None,
    n_trials: int = 100,
    seed: int = 0,
    straggler_prob: float = 0.0,
    straggler_slowdown: float = 3.0,
    code_kind: str = "gaussian",
    overhead: float = 0.13,
    decode_cost: DecodeCostModel | None = None,
) -> SimResult:
    """Monte-Carlo the completion time of one scheme (paper §4.1.3: 100 runs).

    All trials run through the batched event merge; per-trial seeds are the
    same ``derive(seed, scheme, trial)`` stream as always, so results are
    bit-identical to the scalar loop this replaces.  With ``decode_cost``
    set, ``times_decode_terminal`` / ``times_decode_pipelined`` carry the
    decode-inclusive completion curves (terminal vs overlap-pipelined).
    """
    kw = {}
    if scheme == "bpcc":
        kw["p"] = p
    alloc = allocate(scheme, r, workers, **kw)
    required = required_rows(r, code_kind, overhead) if alloc.coded else r
    seeds = np.array([derive(seed, scheme, trial) for trial in range(n_trials)])
    rates = sample_rates_batch(workers, seeds, straggler_prob, straggler_slowdown)
    times = completion_times_batch(alloc, rates, required)
    term, pipe = (None, None)
    if decode_cost is not None:
        term, pipe = completion_times_with_decode_batch(
            alloc, rates, required, decode_cost
        )
    return SimResult(
        scheme=scheme, times=times, required=required, tau=alloc.tau,
        times_decode_terminal=term, times_decode_pipelined=pipe,
    )


# --------------------------------------------------------------------------
# Adaptive BPCC under drift and churn: static vs adaptive vs oracle
# --------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class AdaptiveSimResult(ResultMapping):
    """Monte-Carlo comparison of one scheme under mid-task churn.

    times_static   — completion with the t=0 allocation, never revisited
                     (np.inf when deaths make recovery unreachable);
    times_adaptive — completion with epoch-boundary monotone top-ups from
                     the online rate posterior (DESIGN.md §8); per trial
                     guaranteed <= times_static (top-ups only add arrivals);
    times_oracle   — completion when Algorithm 1 is solved at t=0 with the
                     workers' true post-churn effective models and the dead
                     workers excluded (the known-rates reference the
                     adaptive loop tries to recover);
    topup_rows     — reserve rows the adaptive policy consumed, per trial.
    """

    scheme: str
    times_static: np.ndarray
    times_adaptive: np.ndarray
    times_oracle: np.ndarray
    topup_rows: np.ndarray
    required: int
    tau: float

    LEGACY_ALIASES: ClassVar[dict[str, str]] = {
        "t_complete": "times_adaptive",  # the arm under test (stable name)
    }
    PAYLOAD_FIELDS: ClassVar[tuple[str, ...]] = (
        "scheme", "topup_rows", "required", "tau",
    )
    TIMING_FIELDS: ClassVar[tuple[str, ...]] = (
        "times_static", "times_adaptive", "times_oracle",
    )


def _oracle_allocation(scheme, r_alloc, workers, churn, p=None):
    """Known-rates allocation: Algorithm 1 given every survivor's FINAL rate
    regime (seconds-per-row scaled by its last churn multiplier), dead
    workers excluded — what a clairvoyant master would have allocated.

    The p = None BPCC oracle runs at Algorithm 1's p_i = ⌊ℓ̂_i⌋ default,
    i.e. the p → ∞ regime — solved with ``infimum_allocation``'s closed
    forms (one oracle per churn realization; N brentq roots each would
    dominate the whole batched sweep otherwise)."""
    from repro_torch.core.adaptive import padded_allocation
    from repro_torch.core.allocation import infimum_allocation
    from repro_torch.core.distributions import as_shifted_exp

    n = len(workers)
    cc = churn.compiled(n)
    alive = np.flatnonzero(np.isinf(cc.death))
    if len(alive) == 0:
        alive = np.arange(n)  # everyone dies: degenerate, allocate anyway
    eff = []
    for i in alive:
        w = as_shifted_exp(workers[i])
        m = cc.mults[i, cc.nseg[i] - 1]  # final regime multiplier
        eff.append(ShiftedExp(mu=w.mu / m, alpha=w.alpha * m))
    if scheme == "bpcc" and p is None:
        sub = _infimum_cached(r_alloc, tuple(eff))
    else:
        kw = {"p": p} if scheme == "bpcc" else {}
        sub = allocate(scheme, r_alloc, eff, **kw)
    return padded_allocation(sub, alive, n)


@lru_cache(maxsize=1024)
def _infimum_cached(r: int, workers: tuple[ShiftedExp, ...]):
    from repro_torch.core.allocation import infimum_allocation

    return infimum_allocation(r, list(workers))


def simulate_adaptive_scheme(
    scheme: str,
    r: int,
    workers: list[ShiftedExp],
    *,
    churn=None,
    policy=None,
    p: int | np.ndarray | None = None,
    n_trials: int = 100,
    seed: int = 0,
    straggler_prob: float = 0.0,
    straggler_slowdown: float = 3.0,
    code_kind: str = "gaussian",
    overhead: float = 0.13,
    engine: str = "batch",
) -> AdaptiveSimResult:
    """Monte-Carlo static vs adaptive vs known-rates-oracle completion under
    drift and churn.

    ``churn`` is a ``cluster.straggler.ChurnPolicy`` (or None); ``policy`` a
    ``core.adaptive.ReallocationPolicy`` (None -> a default enabled one).
    Rates use the same ``derive(seed, scheme, trial)`` stream as
    ``simulate_scheme``; churn draws use an independent
    ``derive(seed, "churn", trial)`` stream.

    ``engine`` picks the trajectory evaluator: ``"batch"`` (default) runs
    all trials in lockstep through ``simulate_adaptive_batch`` — the fast
    path; ``"scalar"`` loops ``simulate_adaptive`` per trial — the oracle
    the batch path reproduces BIT-identically per trial (fuzzed in
    tests/test_adaptive_batch.py, timed in benchmarks/adaptive_bench.py);
    ``"scalar-algorithm1"`` additionally re-solves each epoch with the
    original iterative Algorithm 1 (the pre-batching engine, kept as the
    benchmark's wall-clock baseline — its trajectories differ slightly
    from the closed-form re-solve).

    Off-switch equivalence: with ``churn`` falsy AND ``policy.enabled``
    False, ``times_static``, ``times_adaptive`` and ``times_oracle`` are all
    the plain ``completion_times_batch`` result — BIT-identical to
    ``simulate_scheme(...).times`` (asserted in tests/test_adaptive.py).
    """
    from repro_torch.core.adaptive import ReallocationPolicy, simulate_adaptive

    if engine not in ("batch", "scalar", "scalar-algorithm1"):
        raise ValueError(
            f"engine must be batch|scalar|scalar-algorithm1, got {engine!r}"
        )
    if policy is None:
        policy = ReallocationPolicy()
    kw = {"p": p} if scheme == "bpcc" else {}
    alloc = allocate(scheme, r, workers, **kw)
    required = required_rows(r, code_kind, overhead) if alloc.coded else r
    seeds = np.array([derive(seed, scheme, trial) for trial in range(n_trials)])
    rates = sample_rates_batch(workers, seeds, straggler_prob, straggler_slowdown)

    if not churn and not policy.enabled:
        base = completion_times_batch(alloc, rates, required)
        return AdaptiveSimResult(
            scheme=scheme, times_static=base, times_adaptive=base.copy(),
            times_oracle=base.copy(), topup_rows=np.zeros(n_trials, np.int64),
            required=required, tau=alloc.tau,
        )

    horizon = alloc.tau
    if not np.isfinite(horizon):  # uncoded schemes: expected slowest worker
        mean_rates = np.array([w.mean_time(1.0) for w in workers])
        horizon = float(np.max(alloc.loads * mean_rates))
    reserve = int(np.ceil(policy.reserve_frac * alloc.total_rows))
    from repro_torch.core.adaptive import ChurnSchedule, control_margin

    margin = control_margin(policy, code_kind, overhead)
    scheds = [
        churn.sample(len(workers), horizon, derive(seed, "churn", t))
        if churn else ChurnSchedule()
        for t in range(n_trials)
    ]
    o_allocs = [
        _oracle_allocation(scheme, r, workers, sched, p=p) if sched else alloc
        for sched in scheds
    ]

    if engine == "batch":
        from repro_torch.core.adaptive import simulate_adaptive_batch

        if policy.enabled:
            tr = simulate_adaptive_batch(
                alloc, workers, rates, required=required,
                capacity=alloc.total_rows + reserve, churn=scheds, policy=policy,
                required_margin=margin,
            )
            t_adapt, topup = tr.t_complete, tr.topup_rows
            # free by the monotone top-up invariant: the static trajectory
            # is the adaptive trace with reserve-row events masked out
            t_static = tr.static_completion(alloc.total_rows, required)
        else:
            t_static = simulate_adaptive_batch(
                alloc, workers, rates, required=required, churn=scheds,
                policy=None,
            ).t_complete
            t_adapt, topup = t_static.copy(), np.zeros(n_trials, np.int64)
        churned = np.array([bool(s) for s in scheds])
        if churned.any():
            t_oracle = simulate_adaptive_batch(
                o_allocs, workers, rates, required=required, churn=scheds,
                policy=None,
            ).t_complete
            t_oracle = np.where(churned, t_oracle, t_static)
        else:  # no churn anywhere: the oracle IS the static trajectory
            t_oracle = t_static.copy()
        return AdaptiveSimResult(
            scheme=scheme, times_static=t_static, times_adaptive=t_adapt,
            times_oracle=t_oracle, topup_rows=np.asarray(topup, np.int64),
            required=required, tau=alloc.tau,
        )

    t_static = np.empty(n_trials)
    t_adapt = np.empty(n_trials)
    t_oracle = np.empty(n_trials)
    topup = np.zeros(n_trials, np.int64)

    for t in range(n_trials):
        sched = scheds[t]
        t_static[t] = simulate_adaptive(
            alloc, workers, rates[t], required=required, churn=sched, policy=None
        ).t_complete
        if policy.enabled:
            tr = simulate_adaptive(
                alloc, workers, rates[t], required=required,
                capacity=alloc.total_rows + reserve, churn=sched, policy=policy,
                required_margin=margin,
                resolve="algorithm1" if engine == "scalar-algorithm1" else "closed",
            )
            t_adapt[t] = tr.t_complete
            topup[t] = tr.topup_rows
        else:
            t_adapt[t] = t_static[t]
        if sched:
            t_oracle[t] = simulate_adaptive(
                o_allocs[t], workers, rates[t], required=required, churn=sched,
                policy=None,
            ).t_complete
        else:
            t_oracle[t] = t_static[t]
    return AdaptiveSimResult(
        scheme=scheme, times_static=t_static, times_adaptive=t_adapt,
        times_oracle=t_oracle, topup_rows=topup, required=required,
        tau=alloc.tau,
    )


# --------------------------------------------------------------------------
# E[S(t)] accumulation: scalar oracle + batched hot path
# --------------------------------------------------------------------------
def accumulation_curve_scalar(
    alloc: Allocation,
    workers: list[ShiftedExp],
    t_grid: np.ndarray,
    *,
    n_trials: int = 100,
    seed: int = 0,
    straggler_prob: float = 0.0,
    straggler_slowdown: float = 3.0,
) -> np.ndarray:
    """Per-trial-loop REFERENCE for ``accumulation_curve`` (kept as oracle).

    S(t) = sum_i min(l_i, floor(t / (b_i rate_i)) * b_i).
    """
    t_grid = np.asarray(t_grid, dtype=np.float64)
    acc = np.zeros_like(t_grid)
    b = np.ceil(alloc.loads / alloc.batches).astype(np.float64)
    loads = alloc.loads.astype(np.float64)
    for trial in range(n_trials):
        rates = sample_rates(
            workers, derive(seed, "curve", trial), straggler_prob, straggler_slowdown
        )
        # batches received by t: floor(t / (b_i * rate_i)), capped at p_i
        per_batch_t = b * rates  # time per batch
        k = np.floor(t_grid[:, None] / per_batch_t[None, :])
        k = np.clip(k, 0, alloc.batches[None, :].astype(np.float64))
        acc += np.minimum(loads[None, :], k * b[None, :]).sum(axis=1)
    return acc / n_trials


def accumulation_curve(
    alloc: Allocation,
    workers: list[ShiftedExp],
    t_grid: np.ndarray,
    *,
    n_trials: int = 100,
    seed: int = 0,
    straggler_prob: float = 0.0,
    straggler_slowdown: float = 3.0,
) -> np.ndarray:
    """Mean rows received by time t (E[S(t)], Figs 6/9), averaged over trials.

    Vectorized across trials: one [grid, trials, workers] tensor.  The
    summands min(l_i, k·b_i) are integer-valued floats, so float64 addition
    is exact in any order and the result matches the scalar oracle exactly.
    """
    t_grid = np.asarray(t_grid, dtype=np.float64)
    b = np.ceil(alloc.loads / alloc.batches).astype(np.float64)
    loads = alloc.loads.astype(np.float64)
    seeds = np.array([derive(seed, "curve", trial) for trial in range(n_trials)])
    rates = sample_rates_batch(workers, seeds, straggler_prob, straggler_slowdown)
    per_batch_t = b[None, :] * rates                       # [T, N] time per batch
    k = np.floor(t_grid[:, None, None] / per_batch_t[None, :, :])   # [G, T, N]
    k = np.clip(k, 0, alloc.batches[None, None, :].astype(np.float64))
    s = np.minimum(loads[None, None, :], k * b[None, None, :]).sum(axis=2)
    return s.sum(axis=1) / n_trials
