"""Adaptive BPCC: online rate estimation + mid-task reallocation (DESIGN.md §8).

The paper's allocation (Algorithm 1) is computed once, from *prior* rate
parameters, and never revisited: a worker whose rate drifts after allocation
degrades t_complete exactly like the uncoded baseline.  But BPCC's batch
granularity is precisely the online signal that makes mid-task correction
possible — the master observes per-worker batch inter-arrival times *during*
the task.  This module turns that signal into a control loop:

  * ``OnlineRateEstimator`` — per-worker sufficient statistics over observed
    batch inter-arrival rates (decayed count / sum / relaxed minimum), with a
    conjugate-style prior blend: the posterior for a worker with no
    observations is its nominal profile, and the posterior converges to the
    realized rate as arrivals accumulate.  Non-shifted-exp priors
    (Weibull/Pareto) enter through their ``as_shifted_exp`` surrogate, and
    the posterior shift respects the surrogate quantile floor (alpha never
    collapses below ``floor_quantile``×mean — the same 1%-quantile idiom as
    ``distributions.Weibull.to_shifted_exp``), so Eq. (18)/(20) stay finite.
  * ``ChurnSchedule`` — mid-task disturbances as model-time events: rate
    regime switches (slowdown/speedup multipliers), worker death, late join.
  * ``ReallocationPolicy`` — at model-time epoch boundaries the master
    re-solves Algorithm 1 from the posterior rates for the rows still
    needed, and **tops up** workers whose posterior-optimal share exceeds
    their undelivered backlog with fresh coded rows from a reserve pool.
    The top-up is MONOTONE: rows already distributed are never clawed back,
    so every statically-scheduled arrival happens identically and decode
    correctness (which depends only on the received row set) is untouched.
  * ``simulate_adaptive`` — the pure model-time event engine shared by the
    cluster emulator and the Monte-Carlo simulator, so the two can never
    drift apart.  With the policy off and no churn it reproduces
    ``batch_arrival_schedule`` bit-for-bit.
  * ``simulate_adaptive_batch`` / ``BatchedRateEstimator`` — the same
    engine with all trials of a Monte-Carlo cell advanced in lockstep as
    [trials, workers] arrays (DESIGN.md §9): the sweep hot path, per-trial
    BIT-identical to the scalar engine above (fuzzed in
    tests/test_adaptive_batch.py).  The per-epoch Algorithm-1 re-solve both
    engines share is ``reallocation_targets`` — Theorem 6's closed forms,
    root-free and batchable.
  * ``ParityController`` — the serving-side consumer: a per-shard straggler
    posterior from recent latency observations picks the parity level
    (how many laggards to drop) per decode step.

Information discipline (who may know what): the engine *generates* arrivals
from the realized rates and the churn schedule, but the estimator/policy see
only (a) arrivals with t <= the epoch boundary (the executor's model-time
watermark), (b) join events — cluster membership is control-plane
information, and (c) censored silence — "no batch for longer than
``stale_factor`` × expected" is itself an observation, which is how deaths
and severe slowdowns are detected without an oracle.

Copied from ``repro.core.adaptive``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.
The tests hold the copy bit-equal to the reference on the same seeds.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.allocation import Allocation
from repro_torch.core.distributions import ShiftedExp, as_shifted_exp

__all__ = [
    "EstimatorConfig",
    "OnlineRateEstimator",
    "BatchedRateEstimator",
    "ChurnEvent",
    "ChurnSchedule",
    "CompiledChurn",
    "ReallocationPolicy",
    "AdaptiveTrace",
    "BatchedAdaptiveTrace",
    "simulate_adaptive",
    "simulate_adaptive_batch",
    "reallocation_targets",
    "control_margin",
    "padded_allocation",
    "ParityController",
    "DeadlineAwareParity",
    "TenantDeadlineParity",
    "ReplicationController",
]

_ALPHA_FLOOR = 1e-12
_EXCESS_FLOOR = 1e-9   # relative floor on (mean - alpha): keeps mu finite
_MU_ALPHA_CAP = 50.0   # posterior mu*alpha ceiling (paper range is ~1)


# --------------------------------------------------------------------------
# Online rate estimation
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class EstimatorConfig:
    """Knobs of the per-worker rate posterior.

    decay          — per-epoch forgetting on the sufficient statistics; 1.0
                     is the stationary (no-drift) MLE, lower tracks regime
                     switches faster at the cost of variance.
    prior_count    — pseudo-observations the nominal profile contributes;
                     the posterior mean is the precision-weighted blend.
    floor_quantile — the posterior shift alpha never drops below this
                     fraction of the posterior mean rate (the Weibull
                     shift-0 surrogate idiom: keeps ℓ̂ ~ 1/alpha finite).
    stale_factor   — a worker silent for longer than this multiple of its
                     expected next-batch time yields a censored observation.
    """

    decay: float = 0.8
    prior_count: float = 2.0
    floor_quantile: float = 0.01
    stale_factor: float = 2.0

    def __post_init__(self):
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")
        if self.prior_count < 0 or self.stale_factor <= 0:
            raise ValueError(f"bad estimator config {self}")
        if not 0.0 <= self.floor_quantile < 1.0:
            raise ValueError(f"floor_quantile must be in [0, 1), got {self}")


class OnlineRateEstimator:
    """Sufficient-statistics posterior over per-worker seconds-per-row.

    Observations are effective rates of completed batches: for a batch of
    ``rows`` rows whose processing spanned [t_start, t_arrival], the
    observation is (t_arrival - t_start) / rows — under the paper's model
    (Eq. 3) an i.i.d. draw of alpha + X/mu within one rate regime.

    Statistics per worker (exponentially forgotten by ``decay()``):
      n    — decayed observation count (weighted by rows: a 100-row batch
             pins the rate harder than a 1-row batch),
      s    — decayed rows-weighted sum of observed rates,
      m    — relaxed running minimum: new observations pull it down hard,
             ``decay()`` relaxes it toward the current mean so an upward
             alpha drift is eventually forgotten too.

    ``posterior(i)`` maps the statistics to a ShiftedExp by the §5.2
    moment/MLE correspondence — alpha from the (prior-blended, shrunk)
    minimum, mu from 1/(mean excess) — with the quantile floor applied.
    """

    def __init__(self, priors: list[ShiftedExp], cfg: EstimatorConfig | None = None):
        self.cfg = cfg or EstimatorConfig()
        self.priors = [as_shifted_exp(w) for w in priors]
        n = len(self.priors)
        self._n = np.zeros(n)
        self._s = np.zeros(n)
        self._m = np.full(n, np.inf)

    @property
    def n_workers(self) -> int:
        return len(self.priors)

    def observe(self, worker: int, seconds_per_row: float, rows: float = 1.0) -> None:
        """One completed-batch rate observation, weighted by its row count."""
        if seconds_per_row <= 0 or rows <= 0:
            raise ValueError("rate and rows must be positive")
        self._n[worker] += rows
        self._s[worker] += rows * seconds_per_row
        self._m[worker] = min(self._m[worker], seconds_per_row)

    def observe_censored(self, worker: int, elapsed_spr: float, rows: float = 1.0) -> None:
        """Silence as signal: the next batch has NOT arrived after
        ``elapsed_spr`` seconds-per-expected-row, so the current rate is at
        least that.  Fed as a plain observation at the lower bound (biased
        low for the true rate — conservative), but only when it would raise
        the posterior mean; a censored bound below the mean carries no
        information the arrivals didn't."""
        if elapsed_spr > self.mean_rate(worker):
            # the bound must not drag the minimum (shift) statistic down
            self._n[worker] += rows
            self._s[worker] += rows * elapsed_spr

    def decay(self) -> None:
        """One epoch of forgetting; relaxes the minimum toward the mean."""
        d = self.cfg.decay
        if d >= 1.0:
            return
        have = self._n > 0
        mean = np.where(have, self._s / np.maximum(self._n, 1e-300), 0.0)
        self._n *= d
        self._s *= d
        relax = np.isfinite(self._m) & have
        self._m[relax] += (1.0 - d) * (mean[relax] - self._m[relax])

    def mean_rate(self, worker: int) -> float:
        """Posterior mean seconds-per-row (prior-blended)."""
        w = self.priors[worker]
        c = self.cfg.prior_count
        prior_rate = w.alpha + 1.0 / w.mu
        return float(
            (self._s[worker] + c * prior_rate) / (self._n[worker] + c)
            if (self._n[worker] + c) > 0
            else prior_rate
        )

    def rates(self) -> np.ndarray:
        return np.array([self.mean_rate(i) for i in range(self.n_workers)])

    def posterior(self, worker: int) -> ShiftedExp:
        w = self.priors[worker]
        c = self.cfg.prior_count
        n = self._n[worker]
        mean = self.mean_rate(worker)
        m = self._m[worker] if np.isfinite(self._m[worker]) else w.alpha
        # precision-weighted shrink of the observed minimum toward the prior
        # shift; the min of n exponentials overshoots alpha by ~1/(n mu), so
        # the prior pull doubles as a small-sample bias guard
        alpha = (n * m + c * w.alpha) / max(n + c, 1e-300)
        alpha = max(alpha, self.cfg.floor_quantile * mean, _ALPHA_FLOOR)
        alpha = min(alpha, mean * (1.0 - _EXCESS_FLOOR))
        excess = max(mean - alpha, _EXCESS_FLOOR * mean, 1e-300)
        # cap mu*alpha: near-deterministic observations would send the
        # straggle rate to infinity and underflow Eq. (9)'s Lambert-W branch
        mu = min(1.0 / excess, _MU_ALPHA_CAP / alpha)
        return ShiftedExp(mu=mu, alpha=alpha)

    def posteriors(self) -> list[ShiftedExp]:
        return [self.posterior(i) for i in range(self.n_workers)]

    def posterior_params(self) -> tuple[np.ndarray, np.ndarray]:
        """(mu [N], alpha [N]) of the per-worker posteriors — the re-solve
        inputs ``reallocation_targets`` consumes."""
        posts = self.posteriors()
        return (
            np.array([p.mu for p in posts], dtype=np.float64),
            np.array([p.alpha for p in posts], dtype=np.float64),
        )


class BatchedRateEstimator:
    """``OnlineRateEstimator`` in array form: ``[trials, workers]`` decayed
    sufficient statistics updated in lockstep (DESIGN.md §9).

    Every trial's statistics evolve through EXACTLY the float expressions of
    the scalar estimator — all updates are elementwise (or, for the
    rows-weighted sums, applied with ``np.add.at`` in the scalar observation
    order) — so a trial's posterior is bit-identical to running a scalar
    ``OnlineRateEstimator`` on that trial's observation stream (fuzzed in
    tests/test_adaptive_batch.py).  Priors are shared across trials (the
    paper's setting: one cluster, many Monte-Carlo realizations).
    """

    def __init__(
        self,
        priors: list[ShiftedExp],
        n_trials: int,
        cfg: EstimatorConfig | None = None,
    ):
        self.cfg = cfg or EstimatorConfig()
        self.priors = [as_shifted_exp(w) for w in priors]
        n = len(self.priors)
        self.n_trials = int(n_trials)
        self._prior_rate = np.array([w.alpha + 1.0 / w.mu for w in self.priors])
        self._prior_alpha = np.array([w.alpha for w in self.priors])
        self._n = np.zeros((self.n_trials, n))
        self._s = np.zeros((self.n_trials, n))
        self._m = np.full((self.n_trials, n), np.inf)

    @property
    def n_workers(self) -> int:
        return len(self.priors)

    def observe_at(
        self,
        tidx: np.ndarray,
        widx: np.ndarray,
        seconds_per_row: np.ndarray,
        rows: np.ndarray,
    ) -> None:
        """A flat batch of completed-batch observations at (trial, worker)
        slots.  ``np.add.at`` applies them strictly in the given order, so as
        long as each slot's observations arrive in the scalar order (batch
        index ascending) the accumulated sums are bit-identical to the scalar
        ``observe`` loop."""
        np.add.at(self._n, (tidx, widx), rows)
        np.add.at(self._s, (tidx, widx), rows * seconds_per_row)
        np.minimum.at(self._m, (tidx, widx), seconds_per_row)

    def observe_censored_where(
        self, mask: np.ndarray, elapsed_spr: np.ndarray, rows: np.ndarray
    ) -> np.ndarray:
        """Lockstep censored-silence observation (at most one per slot per
        epoch): where ``mask`` and the bound exceeds the posterior mean, add
        the bound as a plain observation — the scalar ``observe_censored``
        gate, elementwise.  Returns the [T, N] mask of slots that actually
        registered the silence (the death/hard-slowdown evidence flags)."""
        fired = mask & (elapsed_spr > self.mean_rates())
        self._n = np.where(fired, self._n + rows, self._n)
        self._s = np.where(fired, self._s + rows * elapsed_spr, self._s)
        return fired

    def decay(self, mask: np.ndarray | None = None) -> None:
        """One epoch of forgetting for trials where ``mask`` is True."""
        d = self.cfg.decay
        if d >= 1.0:
            return
        rows = np.ones(self.n_trials, bool) if mask is None else mask
        have = self._n > 0
        mean = np.where(have, self._s / np.maximum(self._n, 1e-300), 0.0)
        upd = rows[:, None]
        self._n = np.where(upd, self._n * d, self._n)
        self._s = np.where(upd, self._s * d, self._s)
        relax = np.isfinite(self._m) & have & upd
        with np.errstate(invalid="ignore"):  # +inf entries are masked out
            self._m = np.where(
                relax, self._m + (1.0 - d) * (mean - self._m), self._m
            )

    def mean_rates(self) -> np.ndarray:
        """[T, N] posterior mean seconds-per-row (prior-blended)."""
        c = self.cfg.prior_count
        denom = self._n + c
        blended = (self._s + c * self._prior_rate[None, :]) / np.where(
            denom > 0, denom, 1.0
        )
        return np.where(denom > 0, blended, self._prior_rate[None, :])

    def posterior_params(self) -> tuple[np.ndarray, np.ndarray]:
        """(mu [T, N], alpha [T, N]) — the scalar ``posterior`` arithmetic,
        elementwise over the whole trial batch."""
        c = self.cfg.prior_count
        mean = self.mean_rates()
        m = np.where(np.isfinite(self._m), self._m, self._prior_alpha[None, :])
        alpha = (self._n * m + c * self._prior_alpha[None, :]) / np.maximum(
            self._n + c, 1e-300
        )
        alpha = np.maximum(
            np.maximum(alpha, self.cfg.floor_quantile * mean), _ALPHA_FLOOR
        )
        alpha = np.minimum(alpha, mean * (1.0 - _EXCESS_FLOOR))
        excess = np.maximum(
            np.maximum(mean - alpha, _EXCESS_FLOOR * mean), 1e-300
        )
        mu = np.minimum(1.0 / excess, _MU_ALPHA_CAP / alpha)
        return mu, alpha


# --------------------------------------------------------------------------
# Churn: mid-task disturbances in model time
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ChurnEvent:
    """One disturbance: at model time ``t`` worker ``worker`` ...

    kind="rate"  — switches to a new rate regime: observed seconds-per-row
                   becomes ``factor`` × the base realized rate (factor > 1
                   is a slowdown; REPLACES any earlier multiplier),
    kind="death" — stops producing forever (in-flight batches after t are
                   lost; the master is NOT told — it must infer),
    kind="join"  — becomes available (a worker with join > 0 processes
                   nothing earlier; joins are control-plane information the
                   master does see).
    """

    t: float
    worker: int
    kind: str
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in ("rate", "death", "join"):
            raise ValueError(f"unknown churn kind {self.kind!r}")
        if self.t < 0 or (self.kind == "rate" and self.factor <= 0):
            raise ValueError(f"bad churn event {self}")


@dataclass(frozen=True)
class CompiledChurn:
    """One schedule's events compiled to padded per-worker arrays.

    join [N], death [N]; times/mults [N, S] — ascending rate-switch
    breakpoints per worker (times[:, 0] = 0.0, mult 1.0) padded with +inf
    breakpoints (mult 1.0, never consumed: every breakpoint walk terminates
    on ``times[j] >= death`` and inf >= death always holds); nseg [N] —
    valid breakpoint count per worker (>= 1).
    """

    join: np.ndarray
    death: np.ndarray
    times: np.ndarray
    mults: np.ndarray
    nseg: np.ndarray


_COMPILE_CACHE: dict[tuple, CompiledChurn] = {}


def _compile_churn(events: tuple[ChurnEvent, ...], n_workers: int) -> CompiledChurn:
    key = (events, n_workers)
    hit = _COMPILE_CACHE.get(key)
    if hit is not None:
        return hit
    if len(_COMPILE_CACHE) > 4096:
        _COMPILE_CACHE.clear()
    _COMPILE_CACHE[key] = out = _compile_churn_uncached(events, n_workers)
    return out


def _compile_churn_uncached(events: tuple[ChurnEvent, ...], n_workers: int) -> CompiledChurn:
    join = np.zeros(n_workers)
    death = np.full(n_workers, np.inf)
    tlists: list[list[float]] = [[0.0] for _ in range(n_workers)]
    mlists: list[list[float]] = [[1.0] for _ in range(n_workers)]
    for ev in sorted(events, key=lambda e: (e.t, e.worker, e.kind)):
        if ev.worker < 0 or ev.worker >= n_workers:
            raise ValueError(f"churn event for unknown worker: {ev}")
        if ev.kind == "rate":
            tlists[ev.worker].append(ev.t)
            mlists[ev.worker].append(ev.factor)
        elif ev.kind == "death":
            death[ev.worker] = min(death[ev.worker], ev.t)
        else:  # join
            join[ev.worker] = max(join[ev.worker], ev.t)
    nseg = np.array([len(t) for t in tlists], dtype=np.int64)
    s = int(nseg.max())
    times = np.full((n_workers, s), np.inf)
    mults = np.ones((n_workers, s))
    for i, (tl, ml) in enumerate(zip(tlists, mlists)):
        times[i, : len(tl)] = tl
        mults[i, : len(ml)] = ml
    return CompiledChurn(join=join, death=death, times=times, mults=mults, nseg=nseg)


@dataclass(frozen=True)
class ChurnSchedule:
    """A set of churn events for one task realization."""

    events: tuple[ChurnEvent, ...] = ()

    def __bool__(self) -> bool:
        return len(self.events) > 0

    def compiled(self, n_workers: int) -> CompiledChurn:
        """The one-time compiled event-array form (cached per worker count):
        both the scalar and the batched engines consume THIS, so a schedule
        is sorted/validated once per realization, not once per event walk."""
        cache = self.__dict__.setdefault("_compiled", {})
        if n_workers not in cache:
            cache[n_workers] = _compile_churn(self.events, n_workers)
        return cache[n_workers]

    def timeline(self, n_workers: int):
        """Per-worker piecewise-constant view: (join[n], death[n],
        times[i] ascending breakpoint list, mults[i] multiplier from each
        breakpoint on).  times[i][0] is always 0.0 with multiplier 1.0.
        Back-compat list view of :meth:`compiled`."""
        c = self.compiled(n_workers)
        times = [list(c.times[i, : c.nseg[i]]) for i in range(n_workers)]
        mults = [list(c.mults[i, : c.nseg[i]]) for i in range(n_workers)]
        return c.join.copy(), c.death.copy(), times, mults


# --------------------------------------------------------------------------
# Reallocation policy
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ReallocationPolicy:
    """Epoch-boundary monotone top-up from posterior rates.

    enabled        — master switch; False runs the engine with churn but no
                     adaptation (the static comparator).
    epoch_frac     — epoch length as a fraction of the static allocation's
                     predicted tau* (absolute fallback when tau is nan).
    reserve_frac   — extra coded rows encoded up front for top-ups, as a
                     fraction of the static allocation's total.
    scheme         — the allocation re-solved at each epoch (Algorithm 1:
                     'bpcc', or its p=1 restriction 'hcmm').
    min_topup_frac — hysteresis: a threshold shortfall smaller than this
                     fraction of the rows still needed is ignored (keeps
                     the no-drift case from churning rows on noise).
    topup_margin   — assign this fraction more than the computed shortfall
                     (coded rows are cheap; a second-guess epoch is not).
    threshold_margin — the control loop aims for (1 + this) × the recovery
                     threshold.  Rows a dead worker never delivers are a
                     *non-uniform* erasure (e.g. they take systematic LT
                     rows with them), so the count threshold alone can
                     leave an undecodable received set; the executor raises
                     this to 2×eps for LT codes.
    max_epochs     — hard bound on control iterations.
    topup_batches  — cap on the batch count of one top-up chunk.  The
                     re-solve's p_i = ⌊ℓ̂_i⌋ default sits in the p → ∞
                     regime, which for a mid-task chunk would mean
                     row-granular streaming; the paper's Fig. 11 p-sweep is
                     flat far below that, so finer batching buys no
                     completion time while multiplying per-batch return
                     overhead (and event-algebra work) in emulator and
                     reality alike.
    estimator      — posterior configuration (see EstimatorConfig).
    """

    enabled: bool = True
    epoch_frac: float = 0.125
    reserve_frac: float = 0.5
    scheme: str = "bpcc"
    min_topup_frac: float = 0.02
    topup_margin: float = 0.25
    threshold_margin: float = 0.1
    max_epochs: int = 256
    topup_batches: int = 32
    estimator: EstimatorConfig = field(default_factory=EstimatorConfig)

    def __post_init__(self):
        if self.epoch_frac <= 0 or self.reserve_frac < 0 or self.max_epochs < 1:
            raise ValueError(f"bad policy {self}")
        if self.scheme not in ("bpcc", "hcmm"):
            raise ValueError(f"reallocation scheme must be bpcc|hcmm, got {self.scheme}")
        if self.min_topup_frac < 0 or self.topup_margin < 0 or self.threshold_margin < 0:
            raise ValueError(f"bad policy {self}")
        if self.topup_batches < 1:
            raise ValueError(f"topup_batches must be >= 1, got {self}")


def control_margin(policy: ReallocationPolicy, code_kind: str, overhead: float) -> float:
    """The control loop's threshold margin for a code family — THE single
    definition both the executor and the simulator use, so the two adaptive
    trajectories cannot drift apart.  LT peeling under permanent row loss
    sees a non-uniform erasure (lost systematic rows must be re-derived
    from soliton rows), so LT aims 2x the code's eps above the count
    threshold; dense codes decode from any r rows and keep the policy's
    own margin."""
    if code_kind in ("lt", "systematic_lt"):
        return max(policy.threshold_margin, 2.0 * overhead)
    return policy.threshold_margin


def reallocation_targets(
    scheme: str,
    r_rem: np.ndarray,
    mu: np.ndarray,
    alpha: np.ndarray,
    active: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """The control loop's Algorithm-1 re-solve, in closed form over a whole
    trial batch (DESIGN.md §9).

    r_rem [T] — rows still needed per trial; mu/alpha [T, N] — posterior
    ShiftedExp parameters; active [T, N] — workers the policy may use.
    Returns (tau_f [T], p_f [T, N]): the posterior-optimal remaining
    completion time and the per-worker batch counts for top-up chunks.

    Instead of iterating Eq. (7)'s root + the §3.2 repair loop per (trial,
    epoch) — the scalar engine's dominant cost, unbatchable because brentq
    is sequential — the re-solve is evaluated at Algorithm 1's own operating
    point.  The policy's default p_i = ⌊ℓ̂_i⌋ sits in the p → ∞ regime where
    Theorem 6 / Corollary 6.1 give τ* and ℓ̂ in closed form (Eq. 18/20, via
    E₁); the HCMM re-solve is the p = 1 end, closed via Lemma 1's W₋₁ branch
    (Eq. 9) and Eq. (13).  Both are elementwise special-function math plus a
    worker-ordered masked sum, so a trial's targets are bit-identical
    whether solved alone or inside a [trials, workers] batch — the property
    the batched engine's bit-identity rests on (fuzzed in tests).
    """
    from scipy import special

    r_rem = np.asarray(r_rem, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    alpha = np.asarray(alpha, dtype=np.float64)
    active = np.asarray(active, dtype=bool)
    t, n = mu.shape
    if scheme == "bpcc":
        # Theorem 6 Eq. (18): per-worker rate term at p -> infinity,
        # 1/alpha * (1 - e^{mu a} * (e^{-mu a} - mu a E1(mu a)))
        c = np.minimum(mu * alpha, 700.0)  # exp guard, as in allocation.py
        int_exp_inv = np.exp(-c) - c * special.exp1(c)
        term = (1.0 - np.exp(c) * int_exp_inv) / alpha
    elif scheme == "hcmm":
        # Lemma 1 Eq. (9): lambda at p = 1 via the W-1 Lambert branch, then
        # Eq. (13)'s beta term at p = 1: (1 - e^{-mu (lam - alpha)}) / lam
        z = -np.exp(-alpha * mu - 1.0)
        lam = (-(special.lambertw(z, k=-1).real) - 1.0) / mu
        expo = np.clip(-mu * (lam - alpha), -745.0, 50.0)
        term = (1.0 - np.exp(expo)) / lam
    else:
        raise ValueError(f"reallocation scheme must be bpcc|hcmm, got {scheme}")
    # masked sum in worker order: inactive workers add exactly 0.0, so the
    # partial sums match a sum over the active sublist bit-for-bit
    denom = np.zeros(t)
    for i in range(n):
        denom = denom + np.where(active[:, i], term[:, i], 0.0)
    denom = np.maximum(denom, 1e-300)
    tau_f = r_rem / denom
    if scheme == "hcmm":
        p_f = np.ones((t, n), dtype=np.int64)
    else:
        # Corollary 6.1 Eq. (20): lhat_i = r / (alpha_i * denom); the §4.2.2
        # default p_i = floor(lhat_i), clipped to [1, r] as in bpcc_allocation
        lhat = tau_f[:, None] / alpha
        p_f = np.clip(
            np.floor(lhat), 1.0, np.maximum(r_rem, 1.0)[:, None]
        ).astype(np.int64)
    p_f = np.where(active, p_f, 1)
    return tau_f, p_f


def padded_allocation(alloc: Allocation, active: np.ndarray, n_workers: int) -> Allocation:
    """Scatter an allocation over ``active`` worker indices into an
    n_workers-wide one (zeros elsewhere) — late-join scenarios and the
    known-rates oracle allocate over a subset of the cluster."""
    loads = np.zeros(n_workers, dtype=np.int64)
    batches = np.ones(n_workers, dtype=np.int64)
    loads[np.asarray(active)] = alloc.loads
    batches[np.asarray(active)] = alloc.batches
    return Allocation(
        loads=loads, batches=batches, tau=alloc.tau, scheme=alloc.scheme,
        coded=alloc.coded,
    )


# --------------------------------------------------------------------------
# The model-time event engine
# --------------------------------------------------------------------------
@dataclass
class AdaptiveTrace:
    """Full deterministic trajectory of one (static or adaptive) task.

    events        — (t_model, worker, global_row_lo, n_rows) per batch that
                    actually arrives, sorted by (t, worker, lo): exactly the
                    merged order the executor's watermark master consumes.
    t_complete    — earliest event time with cumulative rows >= required
                    (np.inf if the assignment can never deliver enough —
                    e.g. deaths under the static policy).
    rows_assigned — final per-worker totals, initial loads + top-ups.
    topup_rows    — total reserve rows handed out.
    capacity_used — highest global row index assigned + 1 (what must be
                    encoded).
    reallocations — one record per epoch that changed the assignment.
    required      — the recovery threshold the trace was run against.
    """

    events: list[tuple[float, int, int, int]]
    t_complete: float
    rows_assigned: np.ndarray
    topup_rows: int
    capacity_used: int
    reallocations: list[dict]
    required: int


class _WorkerStream:
    """One worker's assigned chunks expanded into batch-arrival arrays.

    Chunks are processed sequentially; a chunk assigned at an epoch starts
    at max(worker-free time, epoch time, join).  Expansion is vectorized
    over the chunk's batch boundaries and is EXACT for the static case:
    with no churn the arrival of cumulative row c is 0.0 + c*rate — the
    same float product ``batch_arrival_schedule`` sorts.
    """

    def __init__(self, wid, rate, join, death, times, mults):
        self.wid = wid
        self.rate = float(rate)
        self.join = float(join)
        self.death = float(death)
        # ascending breakpoints, times[0] == 0.0; +inf-padded rows of a
        # CompiledChurn are fine (the breakpoint walk terminates on them)
        self.times = np.asarray(times, dtype=np.float64)
        self.mults = np.asarray(mults, dtype=np.float64)
        self.free_t = self.join       # when the worker can start new work
        self.assigned = 0             # rows assigned (master view)
        self.t = np.empty(0)          # batch arrival times (inf = lost)
        self.t_start = np.empty(0)    # when each batch began processing
        self.lo = np.empty(0, np.int64)
        self.n = np.empty(0, np.int64)
        self.obs_ptr = 0              # estimator feed position

    def add_chunk(self, lo: int, n_rows: int, b: int, t_assign: float) -> None:
        """Append ``n_rows`` rows at global offset ``lo``, streamed back in
        batches of ``b`` (last batch short), processing from
        max(free time, t_assign, join)."""
        self.assigned += n_rows
        s0 = max(self.free_t, t_assign, self.join)
        ks = np.arange(1, -(-n_rows // b) + 1, dtype=np.float64)
        hi = np.minimum(ks * b, float(n_rows))          # within-chunk cum rows
        if not np.isfinite(s0) or s0 >= self.death:
            arr = np.full(len(hi), np.inf)
            starts = np.full(len(hi), np.inf)
            # the MASTER still expects processing from the assignment time —
            # a finite first-batch start is what lets censor() notice that a
            # worker which died while idle never delivers its top-up
            starts[0] = max(t_assign, self.join)
            self.free_t = np.inf
        else:
            arr, starts = self._arrivals(s0, hi)
            self.free_t = arr[-1] if np.isfinite(arr[-1]) else np.inf
        lo_arr = lo + np.concatenate([[0.0], hi[:-1]]).astype(np.int64)
        n_arr = np.diff(np.concatenate([[0.0], hi])).astype(np.int64)
        self.t = np.concatenate([self.t, arr])
        self.t_start = np.concatenate([self.t_start, starts])
        self.lo = np.concatenate([self.lo, lo_arr])
        self.n = np.concatenate([self.n, n_arr])

    def _arrivals(self, s0: float, hi: np.ndarray):
        """Arrival time of each cumulative row target in ``hi`` for a busy
        period starting at s0, under the piecewise rate multipliers."""
        j0 = int(np.searchsorted(self.times, s0, side="right")) - 1
        ts = [s0]
        sprs = [self.rate * self.mults[j0]]
        for j in range(j0 + 1, len(self.times)):
            if self.times[j] >= self.death:
                break
            ts.append(self.times[j])
            sprs.append(self.rate * self.mults[j])
        rows_cum = [0.0]
        for i in range(1, len(ts)):
            rows_cum.append(rows_cum[-1] + (ts[i] - ts[i - 1]) / sprs[i - 1])
        rows_max = np.inf
        if np.isfinite(self.death):
            rows_max = rows_cum[-1] + (self.death - ts[-1]) / sprs[-1]
        ts_a, cum_a, spr_a = map(np.asarray, (ts, rows_cum, sprs))
        k = np.clip(np.searchsorted(cum_a, hi, side="right") - 1, 0, len(ts_a) - 1)
        arr = ts_a[k] + (hi - cum_a[k]) * spr_a[k]
        arr = np.where(hi <= rows_max, arr, np.inf)
        starts = np.concatenate([[s0], arr[:-1]])
        return arr, starts

    # ---- master-visible views ------------------------------------------
    def delivered_by(self, t_e: float) -> int:
        idx = int(np.searchsorted(self.t, t_e, side="right"))
        return int(self.n[:idx].sum())

    def feed_estimator(self, est: OnlineRateEstimator, t_e: float) -> None:
        """Feed completed-batch rate observations with arrival <= t_e."""
        idx = int(np.searchsorted(self.t, t_e, side="right"))
        for k in range(self.obs_ptr, idx):
            span = self.t[k] - self.t_start[k]
            if span > 0 and self.n[k] > 0:
                est.observe(self.wid, span / self.n[k], rows=float(self.n[k]))
        self.obs_ptr = idx

    def censor(self, est: OnlineRateEstimator, t_e: float) -> None:
        """Silence check: pending next batch overdue at t_e -> censored obs.

        The evidence weight is the number of rows the worker SHOULD have
        delivered during the silence at its posterior mean rate (capped at
        its backlog) — one overdue 1-row batch after 100 expected-row times
        is 100 rows' worth of evidence, not 1, which is what lets a death
        or a hard slowdown overcome a long rows-weighted history quickly."""
        idx = int(np.searchsorted(self.t, t_e, side="right"))
        if idx >= len(self.t):
            return
        start = self.t_start[idx]
        if not np.isfinite(start) or start > t_e:
            return
        rows = float(max(self.n[idx], 1))
        elapsed_spr = (t_e - start) / rows
        mean = est.mean_rate(self.wid)
        if elapsed_spr > est.cfg.stale_factor * mean:
            backlog = float(self.assigned - int(self.n[:idx].sum()))
            weight = min(max((t_e - start) / max(mean, 1e-300), rows), backlog)
            est.observe_censored(self.wid, elapsed_spr, rows=weight)

    def has_pending(self, t_e: float) -> bool:
        idx = int(np.searchsorted(self.t, t_e, side="right"))
        return bool(np.isfinite(self.t[idx:]).any())


def _merged_events(streams: list[_WorkerStream]):
    """All finite arrivals merged in (t, worker, lo) order + cumulative rows."""
    ts = np.concatenate([s.t for s in streams])
    wid = np.concatenate([np.full(len(s.t), s.wid, np.int64) for s in streams])
    lo = np.concatenate([s.lo for s in streams])
    n = np.concatenate([s.n for s in streams])
    fin = np.isfinite(ts)
    ts, wid, lo, n = ts[fin], wid[fin], lo[fin], n[fin]
    order = np.lexsort((lo, wid, ts))
    return ts[order], wid[order], lo[order], n[order]


def simulate_adaptive(
    alloc: Allocation,
    workers: list,
    rates: np.ndarray,
    *,
    required: int,
    capacity: int | None = None,
    churn: ChurnSchedule | None = None,
    policy: ReallocationPolicy | None = None,
    required_margin: float | None = None,
    resolve: str = "closed",
) -> AdaptiveTrace:
    """Deterministic model-time trajectory of one task — static or adaptive.

    alloc    — the t=0 allocation (from the *prior* worker models).
    workers  — prior service-time models (estimator priors; any family).
    rates    — realized base seconds-per-row per worker (one draw per task,
               the paper's model), BEFORE churn multipliers.
    required — coded-row recovery threshold (r(1+eps) for LT, r for dense).
    capacity — total encodable rows; rows beyond ``alloc.total_rows`` form
               the top-up reserve.  Default: no reserve.
    churn    — mid-task disturbances (None = stationary).
    policy   — reallocation policy; None or ``enabled=False`` gives the
               static trajectory (initial chunks only).
    required_margin — override for ``policy.threshold_margin`` (the control
               loop's target is required × (1 + margin); ``t_complete``
               always measures the true ``required`` crossing).
    resolve  — how the epoch re-solve is computed: "closed" (default) uses
               the root-free closed forms of :func:`reallocation_targets`
               (shared with ``simulate_adaptive_batch``, hence the
               bit-identity contract); "algorithm1" keeps the original
               per-epoch iterative Algorithm-1 solve (Eq. (7) roots + the
               §3.2 repair loop) — the pre-batching engine, retained as the
               wall-clock baseline ``benchmarks/adaptive_bench.py`` times
               the fast path against.

    Monotonicity: the adaptive trajectory contains every static arrival at
    the identical time (top-ups only append work), so
    ``t_complete(adaptive) <= t_complete(static)`` trial by trial.

    Bit-identity: with no churn and no policy the event list equals
    ``batch_arrival_schedule(alloc, rates)`` exactly (same float products,
    same (t, worker, lo) tie-break) — asserted in tests/test_adaptive.py.
    """
    n_workers = len(alloc.loads)
    if len(rates) != n_workers or len(workers) != n_workers:
        raise ValueError("alloc/workers/rates disagree on worker count")
    capacity = int(capacity if capacity is not None else alloc.total_rows)
    if capacity < alloc.total_rows:
        raise ValueError("capacity below the initial allocation's total")
    cc = (churn or ChurnSchedule()).compiled(n_workers)
    join, death = cc.join, cc.death

    offsets = np.concatenate([[0], np.cumsum(alloc.loads)])
    streams = []
    for i in range(n_workers):
        s = _WorkerStream(i, rates[i], join[i], death[i], cc.times[i], cc.mults[i])
        l, p = int(alloc.loads[i]), int(alloc.batches[i])
        if l > 0:
            pw = max(1, min(p, l))
            s.add_chunk(int(offsets[i]), l, -(-l // pw), t_assign=0.0)
        streams.append(s)

    reserve_cursor = int(alloc.total_rows)
    reallocations: list[dict] = []
    adapting = policy is not None and policy.enabled and alloc.coded
    if adapting:
        margin = policy.threshold_margin if required_margin is None else required_margin
        target = int(np.ceil(required * (1.0 + margin)))
        priors = [as_shifted_exp(w) for w in workers]
        est = OnlineRateEstimator(priors, policy.estimator)
        tau0 = alloc.tau
        if not np.isfinite(tau0):
            tau0 = float(np.max(alloc.loads * np.array([w.alpha + 1.0 / w.mu for w in priors])))
        epoch_len = policy.epoch_frac * tau0
        for e in range(1, policy.max_epochs + 1):
            t_e = e * epoch_len
            received = sum(s.delivered_by(t_e) for s in streams)
            if received >= target:
                break
            est.decay()
            for s in streams:
                s.feed_estimator(est, t_e)
                s.censor(est, t_e)
            r_rem = target - received
            active = np.flatnonzero(join <= t_e)  # joins are control-plane
            avail = capacity - reserve_cursor
            if len(active) == 0 or avail <= 0:
                if not any(s.has_pending(t_e) for s in streams):
                    break
                continue
            # Re-solve Algorithm 1 for the rows still needed from the
            # posterior rates (closed form, see reallocation_targets):
            # tau_f is the posterior-optimal remaining completion, the
            # deadline the top-up aims at.  Each worker can deliver
            # cap_i = tau_f / mean_rate_i rows by that deadline (the
            # mean-rate projection — Eq. (14)'s d_i = tau/λ_i carries the
            # w.h.p. straggling margin and would over-credit slow workers).
            # Backlog beyond cap_i arrives too late to count, so the
            # threshold shortfall at the deadline is
            #   r_rem - sum_i min(backlog_i, cap_i)
            # and it is covered by topping up workers with SPARE deliverable
            # capacity (cap_i > backlog_i: they would otherwise idle before
            # the deadline).  Workers with no spare gain nothing from extra
            # rows — their throughput, not their assignment, binds.
            if resolve == "algorithm1":
                from repro_torch.core.allocation import allocate

                posts = est.posteriors()
                fresh = allocate(
                    policy.scheme, int(r_rem), [posts[i] for i in active]
                )
                tau_f = fresh.tau
                p_w = np.ones(n_workers, np.int64)
                p_w[active] = fresh.batches
            else:
                mu_p, al_p = est.posterior_params()
                act = np.zeros(n_workers, dtype=bool)
                act[active] = True
                tau_b, p_b = reallocation_targets(
                    policy.scheme, np.array([float(r_rem)]), mu_p[None, :],
                    al_p[None, :], act[None, :],
                )
                tau_f = float(tau_b[0])
                p_w = p_b[0]
            mean_rates = est.rates()
            cap = np.zeros(n_workers)
            cap[active] = tau_f / np.maximum(mean_rates[active], 1e-300)
            backlog = np.array(
                [s.assigned - s.delivered_by(t_e) for s in streams], np.float64
            )
            shortfall = r_rem - float(np.minimum(backlog, cap).sum())
            spare = np.maximum(cap - backlog, 0.0)
            spare[join > t_e] = 0.0
            if shortfall < max(1.0, policy.min_topup_frac * r_rem) or not spare.any():
                if not any(s.has_pending(t_e) for s in streams) and shortfall >= 1:
                    # idle cluster, threshold unreached: assign regardless
                    spare = np.zeros(n_workers)
                    spare[active] = 1.0 / np.maximum(mean_rates[active], 1e-300)
                else:
                    continue
            want = min(shortfall * (1.0 + policy.topup_margin), float(avail))
            raw = want * spare / spare.sum()
            topup = np.floor(raw).astype(np.int64)
            deficit = int(round(want)) - int(topup.sum())
            if deficit > 0:  # spread remainder to the largest fractional parts
                order = np.argsort(-(raw - topup))
                topup[order[:deficit]] += 1
            total = int(topup.sum())
            if total > avail:
                topup = (topup * (avail / total)).astype(np.int64)
                total = int(topup.sum())
            if total == 0:
                continue
            batches_by_worker = p_w
            for i in np.flatnonzero(topup):
                nrows = int(topup[i])
                # resolve="algorithm1" reproduces the pre-batching engine,
                # which streamed top-ups at the re-solve's own granularity
                # (row-level for the p_i = ⌊ℓ̂_i⌋ default); the closed-form
                # engine caps chunk batching at the Fig.-11 flat region
                cap_b = nrows if resolve == "algorithm1" else policy.topup_batches
                pw = max(1, min(int(batches_by_worker[i]), cap_b, nrows))
                streams[i].add_chunk(
                    reserve_cursor, nrows, -(-nrows // pw), t_assign=t_e
                )
                reserve_cursor += nrows
            reallocations.append({
                "t": float(t_e),
                "topup_rows": total,
                "workers_topped": int((topup > 0).sum()),
                "reserve_left": int(capacity - reserve_cursor),
                "posterior_rates": [round(float(x), 9) for x in est.rates()],
            })

    ts, wid, lo, n = _merged_events(streams)
    csum = np.cumsum(n)
    idx = int(np.searchsorted(csum, required - 1e-9))
    t_complete = float(ts[idx]) if idx < len(ts) else np.inf
    return AdaptiveTrace(
        events=[(float(t), int(w), int(l), int(k)) for t, w, l, k in zip(ts, wid, lo, n)],
        t_complete=t_complete,
        rows_assigned=np.array([s.assigned for s in streams], np.int64),
        topup_rows=int(reserve_cursor - alloc.total_rows),
        capacity_used=int(reserve_cursor),
        reallocations=reallocations,
        required=int(required),
    )


# --------------------------------------------------------------------------
# The batched model-time engine: all trials of a cell in lockstep
# --------------------------------------------------------------------------
class _BatchedWorkerStream:
    """All trials' assigned chunks for ONE worker as [trials, events] arrays.

    The trial-batched mirror of ``_WorkerStream``: the same chunk expansion
    and piecewise-rate arrival algebra, evaluated elementwise over the trial
    axis, with every float expression kept term-for-term identical to the
    scalar stream (the bit-identity contract, fuzzed in tests).  Events are
    stored padded (t = +inf, n = 0 beyond ``cnt[t]``); within each trial the
    arrival column is nondecreasing with all lost/padded entries at +inf, so
    the scalar ``searchsorted`` views become masked counts.
    """

    def __init__(self, wid, rate, join, death, times, mults, nseg):
        self.wid = wid
        self.rate = np.asarray(rate, dtype=np.float64)        # [T]
        self.join = np.asarray(join, dtype=np.float64)
        self.death = np.asarray(death, dtype=np.float64)
        self.times = np.asarray(times, dtype=np.float64)      # [T, S]
        self.mults = np.asarray(mults, dtype=np.float64)
        self.nseg = np.asarray(nseg, dtype=np.int64)
        t = len(self.rate)
        self.n_trials = t
        self._rows = np.arange(t)
        self.free_t = self.join.copy()
        self.assigned = np.zeros(t, np.int64)
        self.obs_ptr = np.zeros(t, np.int64)
        self.cnt = np.zeros(t, np.int64)
        self.t = np.empty((t, 0))
        self.t_start = np.empty((t, 0))
        self.lo = np.empty((t, 0), np.int64)
        self.n = np.empty((t, 0), np.int64)
        # incremental-scan band: every column < _band is delivered in every
        # trial (epoch boundaries are nondecreasing and rows are sorted), so
        # per-epoch scans touch only [_band:]; _base_rows carries the rows
        # those columns contributed per trial
        self._band = 0
        self._base_rows = np.zeros(t, np.int64)
        # wide-store fast path: per-trial finite-event counts (pending test
        # in O(T)) and a lazily rebuilt prefix-row-sum table (searchsorted
        # delivered counts in O(T log E) instead of an [T, E] scan)
        self._nfin = np.zeros(t, np.int64)
        self._cumn: np.ndarray | None = None

    # ---- chunk assignment ----------------------------------------------
    def add_chunk(self, sel, lo, nrows, b, t_assign: float) -> None:
        """Append per-trial chunks where ``sel``: ``nrows[t]`` rows at global
        offset ``lo[t]``, streamed in batches of ``b[t]`` (last batch short),
        processing from max(free time, t_assign, join) — the scalar
        ``add_chunk`` over the selected trials (work is compressed to the
        selected rows: later epochs usually top up a shrinking subset)."""
        rows = np.flatnonzero(sel)
        if len(rows) == 0:
            return
        nrows_c = np.asarray(nrows, np.int64)[rows]
        b_c = np.asarray(b, np.int64)[rows]
        k_count = -(-nrows_c // b_c)
        kmax = int(k_count.max())
        ks = np.arange(1, kmax + 1, dtype=np.float64)                 # [K]
        hi = np.minimum(ks[None, :] * b_c[:, None].astype(np.float64),
                        nrows_c.astype(np.float64)[:, None])          # [R, K]
        kvalid = np.arange(kmax)[None, :] < k_count[:, None]
        join_c = self.join[rows]
        death_c = self.death[rows]
        s0 = np.maximum(np.maximum(self.free_t[rows], t_assign), join_c)
        dead = ~np.isfinite(s0) | (s0 >= death_c)
        with np.errstate(invalid="ignore", divide="ignore"):
            arr, starts = self._arrivals(rows, np.where(dead, 0.0, s0), hi, death_c)
        arr = np.where(dead[:, None], np.inf, arr)
        starts = np.where(dead[:, None], np.inf, starts)
        # the MASTER still expects processing from the assignment time
        # (see the scalar stream: lets censoring see idle deaths)
        starts[:, 0] = np.where(dead, np.maximum(t_assign, join_c), starts[:, 0])
        arr_last = arr[np.arange(len(rows)), k_count - 1]
        free_new = np.where(np.isfinite(arr_last), arr_last, np.inf)
        self.free_t[rows] = np.where(dead, np.inf, free_new)
        zeros = np.zeros((len(rows), 1))
        lo_arr = np.asarray(lo, np.int64)[rows][:, None] + np.concatenate(
            [zeros, hi[:, :-1]], axis=1
        ).astype(np.int64)
        n_arr = np.diff(np.concatenate([zeros, hi], axis=1), axis=1).astype(np.int64)
        self._scatter(rows, kvalid, k_count, arr, starts, lo_arr, n_arr)
        self.assigned[rows] += nrows_c

    def _arrivals(self, rows, s0, hi, death_c):
        """Arrival time of each cumulative row target in ``hi`` under the
        piecewise rate multipliers — the scalar ``_arrivals`` with the
        segment walk unrolled over the (small, padded) breakpoint axis,
        compressed to the selected trial rows."""
        times = self.times[rows]
        mults = self.mults[rows]
        nseg = self.nseg[rows]
        rate = self.rate[rows]
        r, s_max = times.shape
        rws = np.arange(r)
        j0 = (times <= s0[:, None]).sum(axis=1) - 1                   # [R]
        seg_t = np.empty((r, s_max))
        seg_spr = np.empty((r, s_max))
        seg_t[:, 0] = s0
        seg_spr[:, 0] = rate * mults[rws, j0]
        n_valid = np.ones(r, np.int64)
        for s in range(1, s_max):
            j = j0 + s
            jc = np.minimum(j, s_max - 1)
            tj = times[rws, jc]
            mj = mults[rws, jc]
            # the scalar walk breaks at the first breakpoint >= death;
            # times ascend, so the valid set is a prefix
            ok = (j < nseg) & (tj < death_c)
            seg_t[:, s] = np.where(ok, tj, np.inf)
            seg_spr[:, s] = np.where(ok, rate * mj, seg_spr[:, s - 1])
            n_valid += ok
        rows_cum = np.zeros((r, s_max))
        for s in range(1, s_max):
            rows_cum[:, s] = rows_cum[:, s - 1] + (
                seg_t[:, s] - seg_t[:, s - 1]
            ) / seg_spr[:, s - 1]
        lastc = n_valid - 1
        rows_max = np.where(
            np.isfinite(death_c),
            rows_cum[rws, lastc]
            + (death_c - seg_t[rws, lastc]) / seg_spr[rws, lastc],
            np.inf,
        )
        # searchsorted(cum, hi, 'right') - 1 as a masked count (padding rows
        # are +inf/nan and never counted), clipped to the valid segments
        k = (rows_cum[:, None, :] <= hi[:, :, None]).sum(axis=2) - 1  # [R, K]
        k = np.clip(k, 0, n_valid[:, None] - 1)
        rws2 = rws[:, None]
        arr = seg_t[rws2, k] + (hi - rows_cum[rws2, k]) * seg_spr[rws2, k]
        arr = np.where(hi <= rows_max[:, None], arr, np.inf)
        starts = np.concatenate([s0[:, None], arr[:, :-1]], axis=1)
        return arr, starts

    def _scatter(self, rows, kvalid, k_count, arr, starts, lo_arr, n_arr) -> None:
        need = int((self.cnt[rows] + k_count).max())
        cap = self.t.shape[1]
        grew = need > cap
        if grew:
            grow = max(need - cap, cap)  # amortized doubling
            t_ = self.n_trials
            self.t = np.concatenate([self.t, np.full((t_, grow), np.inf)], 1)
            self.t_start = np.concatenate(
                [self.t_start, np.full((t_, grow), np.inf)], 1
            )
            self.lo = np.concatenate([self.lo, np.zeros((t_, grow), np.int64)], 1)
            self.n = np.concatenate([self.n, np.zeros((t_, grow), np.int64)], 1)
        kmax = kvalid.shape[1]
        cnt_r = self.cnt[rows]
        if (k_count == kmax).all() and (cnt_r == cnt_r[0]).all():
            # aligned dense slab (always the case for shared initial chunks):
            # one block assignment instead of a flat fancy scatter
            c0 = int(cnt_r[0])
            sl = slice(c0, c0 + kmax)
            self.t[rows, sl] = arr
            self.t_start[rows, sl] = starts
            self.lo[rows, sl] = lo_arr
            self.n[rows, sl] = n_arr
            self._nfin[rows] += np.isfinite(arr).sum(axis=1)
        else:
            ridx, kidx = np.nonzero(kvalid)
            tidx = rows[ridx]
            cols = self.cnt[tidx] + kidx
            self.t[tidx, cols] = arr[ridx, kidx]
            self.t_start[tidx, cols] = starts[ridx, kidx]
            self.lo[tidx, cols] = lo_arr[ridx, kidx]
            self.n[tidx, cols] = n_arr[ridx, kidx]
            np.add.at(self._nfin, tidx, np.isfinite(arr[ridx, kidx]))
        m0 = int(cnt_r.min())  # first column any trial changed
        self.cnt[rows] += k_count
        if self._cumn is not None and not grew:
            # appends only touch columns >= m0: refresh the prefix-sum tail
            self._cumn[:, m0 + 1:] = self._cumn[:, [m0]] + np.cumsum(
                self.n[:, m0:], axis=1, dtype=np.int64
            )
        else:
            self._cumn = None  # rebuilt lazily by the next delivered()

    # ---- master-visible views ------------------------------------------
    def delivered(self, t_e: float) -> tuple[np.ndarray, np.ndarray]:
        """(arrived-batch count [T], delivered rows [T]) by model time t_e.

        Narrow stores scan the not-yet-everywhere-delivered column band
        (epoch boundaries are nondecreasing); wide stores binary-search each
        trial's sorted arrival row and read the rows off a prefix-sum table.
        Both return the same integers — counts, not float expressions."""
        s = self._band
        cap = self.t.shape[1]
        if cap - s > 256:
            if self._cumn is None:
                self._cumn = np.concatenate(
                    [np.zeros((self.n_trials, 1), np.int64),
                     np.cumsum(self.n, axis=1, dtype=np.int64)], axis=1,
                )
            idx = np.empty(self.n_trials, np.int64)
            for t in range(self.n_trials):
                idx[t] = np.searchsorted(self.t[t], t_e, side="right")
            return idx, self._cumn[np.arange(self.n_trials), idx]
        m = self.t[:, s:] <= t_e
        idx = s + m.sum(axis=1)
        rows = self._base_rows + (self.n[:, s:] * m).sum(axis=1)
        ns = int(idx.min()) if len(idx) else 0
        if ns > s:
            self._base_rows = self._base_rows + self.n[:, s:ns].sum(axis=1)
            self._band = ns
        return idx, rows

    def pending_after(self, idx: np.ndarray) -> np.ndarray:
        """Whether a finite (deliverable) event remains beyond arrival index
        ``idx`` — the scalar ``has_pending`` as a finite-count comparison
        (events <= t_e are exactly the first idx, all finite)."""
        return idx < self._nfin


def _collect_observations(st: _BatchedWorkerStream, idx, sel):
    """Flat (trial, spr, rows) arrays for the scalar feed_estimator loop:
    events in [obs_ptr, idx) per selected trial, batch index ascending —
    np.nonzero's row-major order preserves exactly the scalar observation
    order within each (trial, worker) slot.  Only the column band any
    selected trial's window touches is scanned."""
    empty = (np.empty(0, np.int64),) * 3
    if st.t.shape[1] == 0 or not sel.any():
        return empty
    so = int(st.obs_ptr[sel].min())
    hi = int(idx[sel].max())
    if hi <= so:
        return empty
    pos = np.arange(so, hi)[None, :]
    m = sel[:, None] & (pos >= st.obs_ptr[:, None]) & (pos < idx[:, None])
    with np.errstate(invalid="ignore"):  # inf - inf on padded slots
        span = st.t[:, so:hi] - st.t_start[:, so:hi]
    nloc = st.n[:, so:hi]
    m &= (span > 0) & (nloc > 0)
    tidx, kidx = np.nonzero(m)
    rows = nloc[tidx, kidx].astype(np.float64)
    spr = span[tidx, kidx] / rows
    return tidx, spr, rows


@dataclass
class BatchedAdaptiveTrace:
    """Trial-batched :class:`AdaptiveTrace`: one cell's trials in lockstep.

    Per-trial fields are arrays over the leading trial axis; the merged
    event lists are kept in sorted padded-array form (``events_for_trial``
    materializes one trial's list, bit-identical to the scalar trace).
    """

    t_complete: np.ndarray        # [T]
    rows_assigned: np.ndarray     # [T, N]
    topup_rows: np.ndarray        # [T]
    capacity_used: np.ndarray     # [T]
    reallocations: list[list[dict]]
    required: int
    events_t: np.ndarray          # [T, E] sorted, +inf padded
    events_w: np.ndarray
    events_lo: np.ndarray
    events_n: np.ndarray

    def events_for_trial(self, t: int) -> list[tuple[float, int, int, int]]:
        fin = np.isfinite(self.events_t[t])
        return [
            (float(a), int(b), int(c), int(d))
            for a, b, c, d in zip(
                self.events_t[t][fin], self.events_w[t][fin],
                self.events_lo[t][fin], self.events_n[t][fin],
            )
        ]

    def static_completion(self, total_rows: int, required: int) -> np.ndarray:
        """The STATIC trajectory's per-trial completion, read off this
        (adaptive) trace for free: the monotone top-up invariant keeps every
        static arrival in the adaptive event list at its identical time, and
        top-up rows are exactly those with global offset >= ``total_rows``
        — so masking reserve events recovers the static merge bit-for-bit
        (the sort comparator is total: no two events share (t, wid, lo))."""
        init = self.events_lo < total_rows
        fin = np.isfinite(self.events_t) & init
        csum = np.cumsum(np.where(fin, self.events_n, 0), axis=1)
        okm = (csum >= required - 1e-9) & fin
        has = okm.any(axis=1)
        first = okm.argmax(axis=1)
        t = self.events_t.shape[0]
        return np.where(has, self.events_t[np.arange(t), first], np.inf)


def simulate_adaptive_batch(
    alloc,
    workers: list,
    rates: np.ndarray,
    *,
    required: int,
    capacity: int | None = None,
    churn=None,
    policy: ReallocationPolicy | None = None,
    required_margin: float | None = None,
) -> BatchedAdaptiveTrace:
    """All trials of one (drift x churn x scheme) cell through
    :func:`simulate_adaptive`'s event algebra in lockstep (DESIGN.md §9).

    rates [trials, workers] — realized base seconds-per-row per trial;
    churn — None, one ``ChurnSchedule`` shared by all trials, or a length-T
    sequence of per-trial schedules (each compiled once to event arrays);
    alloc — the shared t=0 ``Allocation``, or a length-T sequence of
    per-trial allocations (static engine only: ``policy`` must be off).

    Trials advance together through the shared epoch boundaries (the epoch
    grid depends only on the shared allocation's tau*); the per-epoch
    estimator updates are [T, N] array ops, the Algorithm-1 re-solve is the
    closed-form :func:`reallocation_targets` over the whole batch, and
    finished trials freeze behind a running mask.  Per-trial results are
    BIT-identical to running ``simulate_adaptive`` trial by trial — same
    float expressions, same orders where rounding is order-sensitive —
    asserted exhaustively in tests/test_adaptive_batch.py.
    """
    rates = np.asarray(rates, dtype=np.float64)
    if rates.ndim != 2:
        raise ValueError(f"rates must be [trials, workers], got {rates.shape}")
    n_trials, n_workers = rates.shape
    if len(workers) != n_workers:
        raise ValueError("workers/rates disagree on worker count")

    # ---- per-trial allocations ------------------------------------------
    if isinstance(alloc, Allocation):
        allocs = [alloc] * n_trials
        shared = alloc
    else:
        allocs = list(alloc)
        if len(allocs) != n_trials:
            raise ValueError("need one allocation per trial")
        shared = None
    loads = np.stack([a.loads for a in allocs])                  # [T, N]
    batches = np.stack([a.batches for a in allocs])
    total_rows = loads.sum(axis=1)
    coded = all(a.coded for a in allocs)
    if capacity is None:
        cap_arr = total_rows.copy()
    else:
        cap_arr = np.full(n_trials, int(capacity), np.int64)
    if (cap_arr < total_rows).any():
        raise ValueError("capacity below the initial allocation's total")

    # ---- churn: compiled per-trial event arrays -------------------------
    if churn is None or isinstance(churn, ChurnSchedule):
        churns = [churn or ChurnSchedule()] * n_trials
    else:
        churns = [c or ChurnSchedule() for c in churn]
        if len(churns) != n_trials:
            raise ValueError("need one churn schedule per trial")
    comp = [c.compiled(n_workers) for c in churns]
    s_max = max(c.times.shape[1] for c in comp)
    join = np.stack([c.join for c in comp])                      # [T, N]
    death = np.stack([c.death for c in comp])
    times = np.full((n_trials, n_workers, s_max), np.inf)
    mults = np.ones((n_trials, n_workers, s_max))
    nseg = np.stack([c.nseg for c in comp])
    for t, c in enumerate(comp):
        times[t, :, : c.times.shape[1]] = c.times
        mults[t, :, : c.mults.shape[1]] = c.mults

    # ---- initial chunks --------------------------------------------------
    offsets = np.concatenate(
        [np.zeros((n_trials, 1), np.int64), np.cumsum(loads, axis=1)], axis=1
    )
    streams: list[_BatchedWorkerStream] = []
    for i in range(n_workers):
        st = _BatchedWorkerStream(
            i, rates[:, i], join[:, i], death[:, i],
            times[:, i], mults[:, i], nseg[:, i],
        )
        sel = loads[:, i] > 0
        pw = np.maximum(1, np.minimum(batches[:, i], loads[:, i]))
        st.add_chunk(sel, offsets[:, i], loads[:, i], -(-loads[:, i] // pw), 0.0)
        streams.append(st)

    reserve_cursor = total_rows.astype(np.int64).copy()
    realloc: list[list[dict]] = [[] for _ in range(n_trials)]
    adapting = policy is not None and policy.enabled and coded
    if adapting:
        if shared is None:
            raise ValueError("the adaptive engine needs a shared allocation")
        margin = policy.threshold_margin if required_margin is None else required_margin
        target = int(np.ceil(required * (1.0 + margin)))
        priors = [as_shifted_exp(w) for w in workers]
        est = BatchedRateEstimator(priors, n_trials, policy.estimator)
        tau0 = shared.tau
        if not np.isfinite(tau0):
            tau0 = float(np.max(
                shared.loads * np.array([w.alpha + 1.0 / w.mu for w in priors])
            ))
        epoch_len = policy.epoch_frac * tau0
        running = np.ones(n_trials, bool)
        for e in range(1, policy.max_epochs + 1):
            if not running.any():
                break
            t_e = e * epoch_len
            deliv_idx = np.empty((n_trials, n_workers), np.int64)
            deliv_rows = np.empty((n_trials, n_workers), np.int64)
            for i, st in enumerate(streams):
                deliv_idx[:, i], deliv_rows[:, i] = st.delivered(t_e)
            received = deliv_rows.sum(axis=1)
            running = running & (received < target)
            if not running.any():
                break
            est.decay(mask=running)
            # feed: completed-batch observations in scalar order, then the
            # lockstep censored-silence pass (cross-worker independence of
            # the posterior keeps feed-then-censor == the scalar interleave;
            # one fused observe_at per epoch — slots differ across workers,
            # so concatenating their flat streams preserves per-slot order)
            obs_t: list[np.ndarray] = []
            obs_w: list[np.ndarray] = []
            obs_spr: list[np.ndarray] = []
            obs_rows: list[np.ndarray] = []
            with np.errstate(invalid="ignore"):
                for i, st in enumerate(streams):
                    tidx, spr, rows = _collect_observations(
                        st, deliv_idx[:, i], running
                    )
                    if len(tidx):
                        obs_t.append(tidx)
                        obs_w.append(np.full(len(tidx), i))
                        obs_spr.append(spr)
                        obs_rows.append(rows)
                    st.obs_ptr = np.where(running, deliv_idx[:, i], st.obs_ptr)
                if obs_t:
                    est.observe_at(
                        np.concatenate(obs_t), np.concatenate(obs_w),
                        np.concatenate(obs_spr), np.concatenate(obs_rows),
                    )
                mean_rates = est.mean_rates()
                # censored-silence pass, fused over workers: gather each
                # stream's next-pending (start, rows) column into [T, N]
                # panels, then one vectorized stale/weight computation —
                # the per-(trial, worker) arithmetic is elementwise, so
                # fusing across workers changes nothing bit-wise
                pend = np.zeros((n_trials, n_workers), bool)
                start_p = np.full((n_trials, n_workers), np.inf)
                rows_p = np.ones((n_trials, n_workers))
                assigned_p = np.empty((n_trials, n_workers), np.int64)
                for i, st in enumerate(streams):
                    assigned_p[:, i] = st.assigned
                    capn = st.t.shape[1]
                    if capn == 0:
                        continue
                    idx = deliv_idx[:, i]
                    p_i = running & (idx < st.cnt)
                    if not p_i.any():
                        continue
                    col = np.minimum(idx, capn - 1)
                    pend[:, i] = p_i
                    start_p[:, i] = st.t_start[st._rows, col]
                    rows_p[:, i] = np.maximum(st.n[st._rows, col], 1)
                pend &= np.isfinite(start_p) & (start_p <= t_e)
                cen_mask = np.zeros((n_trials, n_workers), bool)
                cen_elapsed = np.zeros((n_trials, n_workers))
                cen_weight = np.zeros((n_trials, n_workers))
                if pend.any():
                    elapsed = (t_e - start_p) / rows_p
                    stale = pend & (
                        elapsed > est.cfg.stale_factor * mean_rates
                    )
                    if stale.any():
                        backlog_p = (assigned_p - deliv_rows).astype(np.float64)
                        weight = np.minimum(
                            np.maximum(
                                (t_e - start_p)
                                / np.maximum(mean_rates, 1e-300),
                                rows_p,
                            ),
                            backlog_p,
                        )
                        cen_mask = stale
                        cen_elapsed = np.where(stale, elapsed, 0.0)
                        cen_weight = np.where(stale, weight, 0.0)
            if cen_mask.any():
                est.observe_censored_where(cen_mask, cen_elapsed, cen_weight)
            r_rem = (target - received).astype(np.float64)
            active = join <= t_e
            avail = cap_arr - reserve_cursor
            has_pend = np.zeros(n_trials, bool)
            for i, st in enumerate(streams):
                has_pend |= st.pending_after(deliv_idx[:, i])
            grp_a = running & (~active.any(axis=1) | (avail <= 0))
            running = running & ~(grp_a & ~has_pend)  # idle + exhausted: stop
            solve = running & ~grp_a
            if not solve.any():
                continue
            mu_p, al_p = est.posterior_params()
            tau_f, p_f = reallocation_targets(
                policy.scheme, r_rem, mu_p, al_p, active
            )
            mean_rates = est.mean_rates()
            inv_mean = 1.0 / np.maximum(mean_rates, 1e-300)
            cap_rows = np.where(active, tau_f[:, None] * inv_mean, 0.0)
            backlog = np.empty((n_trials, n_workers))
            for i, st in enumerate(streams):
                backlog[:, i] = (st.assigned - deliv_rows[:, i]).astype(np.float64)
            shortfall = r_rem - np.minimum(backlog, cap_rows).sum(axis=1)
            spare = np.maximum(cap_rows - backlog, 0.0)
            spare = np.where(join <= t_e, spare, 0.0)
            blocked = (
                shortfall < np.maximum(1.0, policy.min_topup_frac * r_rem)
            ) | ~spare.any(axis=1)
            idle_fire = blocked & ~has_pend & (shortfall >= 1)
            spare = np.where(
                idle_fire[:, None], np.where(active, inv_mean, 0.0), spare
            )
            doing = solve & (~blocked | idle_fire)
            if not doing.any():
                continue
            want = np.minimum(
                shortfall * (1.0 + policy.topup_margin), avail.astype(np.float64)
            )
            ssum = spare.sum(axis=1)
            with np.errstate(invalid="ignore", divide="ignore"):
                raw = np.where(
                    doing[:, None], want[:, None] * spare / ssum[:, None], 0.0
                )
            topup = np.floor(raw).astype(np.int64)
            deficit = np.rint(want).astype(np.int64) - topup.sum(axis=1)
            order = np.argsort(-(raw - topup), axis=1)
            ranks = np.empty_like(order)
            np.put_along_axis(
                ranks, order, np.broadcast_to(np.arange(n_workers), order.shape), 1
            )
            topup = topup + (
                doing[:, None] & (ranks < np.maximum(deficit, 0)[:, None])
            )
            total = topup.sum(axis=1)
            over = total > avail
            if over.any():
                with np.errstate(invalid="ignore", divide="ignore"):
                    scaled = (
                        topup * (avail.astype(np.float64) / total)[:, None]
                    ).astype(np.int64)
                topup = np.where(over[:, None], scaled, topup)
                total = topup.sum(axis=1)
            doing = doing & (total > 0)
            if not doing.any():
                continue
            topup = np.where(doing[:, None], topup, 0)
            total = topup.sum(axis=1)
            excl = np.concatenate(
                [np.zeros((n_trials, 1), np.int64), np.cumsum(topup, axis=1)[:, :-1]],
                axis=1,
            )
            lo_base = reserve_cursor[:, None] + excl
            for i, st in enumerate(streams):
                seli = doing & (topup[:, i] > 0)
                if not seli.any():
                    continue
                nrows = topup[:, i]
                pw = np.maximum(
                    1, np.minimum(np.minimum(p_f[:, i], policy.topup_batches), nrows)
                )
                st.add_chunk(seli, lo_base[:, i], nrows, -(-nrows // pw), t_e)
            reserve_cursor = np.where(doing, reserve_cursor + total, reserve_cursor)
            for t in np.flatnonzero(doing):
                realloc[t].append({
                    "t": float(t_e),
                    "topup_rows": int(total[t]),
                    "workers_topped": int((topup[t] > 0).sum()),
                    "reserve_left": int(cap_arr[t] - reserve_cursor[t]),
                    "posterior_rates": [
                        round(float(x), 9) for x in mean_rates[t]
                    ],
                })

    # ---- merge: all workers' events, sorted (t, wid, lo) per trial -------
    ts = np.concatenate([st.t for st in streams], axis=1)
    wid = np.concatenate(
        [np.full_like(st.lo, st.wid) for st in streams], axis=1
    )
    lo = np.concatenate([st.lo for st in streams], axis=1)
    nn = np.concatenate([st.n for st in streams], axis=1)
    order = np.lexsort((lo, wid, ts), axis=-1)
    trows = np.arange(n_trials)[:, None]
    ts = ts[trows, order]
    wid = wid[trows, order]
    lo = lo[trows, order]
    nn = nn[trows, order]
    fin = np.isfinite(ts)
    csum = np.cumsum(np.where(fin, nn, 0), axis=1)
    okm = (csum >= required - 1e-9) & fin
    has = okm.any(axis=1)
    first = okm.argmax(axis=1)
    t_complete = np.where(has, ts[np.arange(n_trials), first], np.inf)
    return BatchedAdaptiveTrace(
        t_complete=t_complete,
        rows_assigned=np.stack([st.assigned for st in streams], axis=1),
        topup_rows=(reserve_cursor - total_rows).astype(np.int64),
        capacity_used=reserve_cursor.copy(),
        reallocations=realloc,
        required=int(required),
        events_t=ts, events_w=wid, events_lo=lo, events_n=nn,
    )


# --------------------------------------------------------------------------
# Serving-side consumer: parity level from the straggler posterior
# --------------------------------------------------------------------------
class ParityController:
    """Pick the coded LM head's parity level per decode step.

    Feeds on the per-shard latency vector the serving engine already reads
    (``latency_fn``) and keeps an exponentially-weighted straggler posterior
    per shard: the fraction of recent steps the shard was a laggard
    (latency > ``threshold`` × the step's median, or unreachable).
    ``parity_level`` is the number of shards currently believed straggling,
    clamped to the code's parity budget — so a healthy step drops nobody
    (best conditioning, no wasted work) while a persistently slow shard is
    dropped within a few steps (never waiting on it again until it recovers).
    """

    def __init__(self, n_blocks: int, decay: float = 0.7, threshold: float = 2.0):
        if not 0.0 <= decay < 1.0 or threshold <= 1.0 or n_blocks < 1:
            raise ValueError("bad ParityController config")
        self.n_blocks = n_blocks
        self.decay = decay
        self.threshold = threshold
        self.posterior = np.zeros(n_blocks)

    def observe(self, latency: np.ndarray) -> None:
        lat = np.asarray(latency, dtype=np.float64)
        if lat.shape != (self.n_blocks,):
            raise ValueError(f"latency must be [{self.n_blocks}], got {lat.shape}")
        finite = np.isfinite(lat)
        med = float(np.median(lat[finite])) if finite.any() else 1.0
        lag = (~finite) | (lat > self.threshold * max(med, 1e-300))
        self.posterior = self.decay * self.posterior + (1.0 - self.decay) * lag

    def parity_level(self, max_parity: int) -> int:
        """Shards to drop this step: the posterior-majority straggler count."""
        return int(min(max_parity, int((self.posterior > 0.5).sum())))

    def observe_block(self, latencies: np.ndarray) -> None:
        """Fold a fused macro-step's ``[K, n_blocks]`` latency block in, one
        row per decode step IN ORDER — the posterior trajectory is exactly K
        scalar :meth:`observe` calls (DESIGN.md §14), so the fused decode
        path converges identically to the scalar loop."""
        lats = np.asarray(latencies, dtype=np.float64)
        if lats.ndim != 2 or lats.shape[1] != self.n_blocks:
            raise ValueError(
                f"latency block must be [K, {self.n_blocks}], got {lats.shape}"
            )
        for row in lats:
            self.observe(row)


class ReplicationController:
    """Training-side analogue of ``ParityController``: pick the gradient-
    coding replication level s per step from online worker-speed posteriors.

    Feeds on the per-worker step latencies the train launcher already
    measures and keeps an exponentially-weighted *multiplier* posterior per
    worker (latency over the step's lower-quartile baseline, so a healthy
    worker sits near 1 and a 3×-slow worker converges to ~3 within a few
    steps; the 25th percentile stays a healthy reference even when a
    majority of workers are slow, where the median would not).  Unlike the
    parity controller — which only counts convicted stragglers — this one
    prices the actual trade replication controls: raising s costs every
    worker (s+1)× the compute, but lets the step finish at the (m−s)-th
    fastest message instead of the slowest.

    The baseline decision is the cost-model argmin over allowed levels,

        s* = argmin_s  (s+1) · sort(mult)[m−s−1],

    which degrades to s=0 (uncoded) on a homogeneous cluster — replication
    is bought only when the posterior says stragglers are slow enough to
    pay for it.  The same formula with the TRUE multipliers is the
    known-rates oracle the train bench compares against.

    On top of it sits a CVaR-style tail term: the argmin alone is blind to
    *onsets* — a kept worker turning slow THIS step stalls the whole step
    at (s+1)·spike before any posterior can react, and when onsets are
    p99-frequent that is exactly what the step-time tail is made of.  The
    controller keeps EW estimates of the per-worker onset rate and of the
    spike magnitude, and scores each level by

        risk(s) = (s+1) · [ (1−q)·srt[m−s−1] + tail_risk·q·srt1[m−s−1] ],

    where q = (m−s)·onset_rate and srt1 is the sorted posterior with one
    healthy worker replaced by a spike.  A margin level (s = believed-slow
    + 1) makes srt1[m−s−1] healthy — the onset is absorbed by the spare
    message — so under violent spikes (10–50×) the risk term buys one
    level of slack, while under mild 3× spikes or rare onsets the premium
    isn't worth it and the pure argmin wins.  ``tail_risk`` is the
    weight of the tail branch relative to the mean (≈ how many mean-steps
    one blown p99 step is worth); 0 recovers the plain argmin.
    """

    def __init__(
        self,
        n_workers: int,
        decay: float = 0.7,
        cap: float = 1e3,
        tail_risk: float = 10.0,
        conviction: float = 2.0,
        onset_prior: float = 1e-3,
        spike_prior: float = 10.0,
        rate_decay: float = 0.995,
        spike_decay: float = 0.9,
    ):
        if not 0.0 <= decay < 1.0 or n_workers < 1 or cap < 1.0:
            raise ValueError("bad ReplicationController config")
        if tail_risk < 0 or conviction <= 1.0 or onset_prior < 0:
            raise ValueError("bad ReplicationController risk config")
        if not 0.0 < rate_decay < 1.0 or not 0.0 < spike_decay < 1.0:
            raise ValueError("decays must be in (0, 1)")
        self.n_workers = int(n_workers)
        self.decay = float(decay)
        self.cap = float(cap)
        self.tail_risk = float(tail_risk)
        self.conviction = float(conviction)
        self.mult = np.ones(n_workers, dtype=np.float64)
        self._onset_rate = float(onset_prior)
        self._spike = float(spike_prior)
        self._rate_decay = float(rate_decay)
        self._spike_decay = float(spike_decay)
        self._prev_convicted = np.zeros(n_workers, dtype=bool)

    def observe(self, latency: np.ndarray) -> None:
        """Fold one step's per-worker latencies into the posteriors.

        Latencies are normalized by the step's lower-quartile baseline;
        unreachable workers (inf/nan) count as ``cap``-slow and re-earn
        their place on recovery.
        """
        lat = np.asarray(latency, dtype=np.float64)
        if lat.shape != (self.n_workers,):
            raise ValueError(f"latency must be [{self.n_workers}], got {lat.shape}")
        finite = np.isfinite(lat)
        base = float(np.percentile(lat[finite], 25)) if finite.any() else 1.0
        base = max(base, 1e-300)
        obs = np.where(finite, np.clip(lat / base, 0.0, self.cap), self.cap)
        self.mult = self.decay * self.mult + (1.0 - self.decay) * obs
        convicted = self.mult > self.conviction
        new = convicted & ~self._prev_convicted
        healthy_prev = int((~self._prev_convicted).sum())
        rd = self._rate_decay
        self._onset_rate = rd * self._onset_rate + (1.0 - rd) * (
            float(new.sum()) / max(healthy_prev, 1)
        )
        if convicted.any():
            sd = self._spike_decay
            self._spike = sd * self._spike + (1.0 - sd) * float(
                self.mult[convicted].mean()
            )
        self._prev_convicted = convicted

    @staticmethod
    def step_cost(mult: np.ndarray, s: int) -> float:
        """Predicted relative step time at replication s for worker
        multipliers ``mult``: every worker does (s+1)× the work, the step
        completes at the (m−s)-th fastest arrival (cyclic-code geometry)."""
        m = len(mult)
        if not 0 <= s < m:
            raise ValueError(f"s={s} out of range for {m} workers")
        return float((s + 1) * np.sort(np.asarray(mult, np.float64))[m - s - 1])

    def replication(self, levels) -> int:
        """Risk-adjusted cost-model argmin over the allowed levels."""
        levels = sorted(set(int(s) for s in levels))
        if not levels:
            raise ValueError("no replication levels given")
        m = self.n_workers
        srt = np.sort(self.mult)
        # one previously-healthy worker spikes: drop the fastest, add a spike
        srt1 = np.sort(np.append(srt[1:], max(self._spike, srt[0])))

        def risk(s: int) -> float:
            base = self.step_cost(self.mult, s)  # validates the level
            q = min((m - s) * self._onset_rate, 1.0)
            return (1.0 - q) * base + self.tail_risk * q * (
                (s + 1) * srt1[m - s - 1]
            )

        return min(levels, key=risk)


class DeadlineAwareParity:
    """Pick the per-step parity level from SLO slack + spike economics, not
    straggler history alone (DESIGN.md §10).

    The ``ParityController`` answers "how many shards does the posterior
    believe are straggling?" — a purely backward-looking signal.  Under
    traffic with per-request deadlines (serve/scheduler.py) the master
    additionally knows the tightest admitted request's SLO slack, and can
    price the one real trade the parity level controls:

      dropping the FULL budget every step (fixed-parity) pays the masked
      decode every step — the recovery matmul plus the conditioning guard
      of a non-systematic read-off — but hedges against slow-regime
      onsets: a kept shard that turns slow mid-step costs ~the slowdown
      factor in deadline budget before any estimate can react;

      dropping NOTHING on a conviction-free step is free and
      best-conditioned, but keeps every shard exposed to the next onset.

    The policy prices that trade from online evidence: an EW estimate of
    the cluster-wide onset rate (posterior upcrossings) and of the spike
    magnitude (laggard latency over the step median).  Relaxing below the
    full budget is allowed only when (a) no shard is currently convicted,
    (b) the window is evidenced-calm (``calm_patience`` conviction-free
    steps), and (c) the expected onset cost of the extra kept shards —
    onset_rate × (budget/n_blocks) × spike — is below the decode overhead
    saved (``relax_overhead``, in units of the healthy shard time).  In a
    violent environment the estimates veto relaxation and the policy
    tracks fixed-parity exactly (while the engine's posterior-saturation
    top-up can still RAISE the budget past fixed's, DESIGN.md §9); in calm
    or mild environments it relaxes and wins the overhead back.  Scarce
    slack escalates unconditionally: urgency = clip(1 -
    slack/escalate_steps, 0, 1) raises the floor toward the full budget,
    so a request about to miss its deadline never waits on an unconvicted
    laggard.

    With infinite slack (no deadline-bearing traffic) the policy is
    EXACTLY ``controller.parity_level`` (the degradation property,
    asserted in tests/test_serve_traffic.py), so a deployment without
    deadlines loses nothing by wiring it in.
    """

    def __init__(
        self,
        controller: ParityController,
        escalate_steps: float = 8.0,
        calm_patience: int = 8,
        relax_overhead: float = 0.04,
        onset_prior: float = 8e-3,
        spike_prior: float = 25.0,
        rate_decay: float = 0.998,
        spike_decay: float = 0.9,
    ):
        if escalate_steps <= 0 or calm_patience < 1:
            raise ValueError("escalate_steps and calm_patience must be positive")
        if not 0.0 < rate_decay < 1.0 or not 0.0 < spike_decay < 1.0:
            raise ValueError("decays must be in (0, 1)")
        if relax_overhead < 0 or onset_prior < 0 or spike_prior < 1:
            raise ValueError("bad DeadlineAwareParity economics")
        self.controller = controller
        self.escalate_steps = float(escalate_steps)
        self.calm_patience = int(calm_patience)
        self.relax_overhead = float(relax_overhead)
        self.rate_decay = float(rate_decay)
        self.spike_decay = float(spike_decay)
        self._calm_steps = 0
        self._onset_rate = float(onset_prior)   # P(>=1 onset) per step, EW
        self._spike = float(spike_prior)        # laggard slowdown multiple, EW

    def observe(self, latency: np.ndarray) -> None:
        lat = np.asarray(latency, dtype=np.float64)
        prev = self.controller.posterior > 0.5
        self.controller.observe(lat)
        conv = self.controller.posterior > 0.5
        # onset evidence: a shard newly crossing conviction this step
        d = self.rate_decay
        self._onset_rate = d * self._onset_rate + (1.0 - d) * float(
            (conv & ~prev).any()
        )
        # spike magnitude: how bad is a laggard, in healthy-shard units
        finite = np.isfinite(lat)
        med = float(np.median(lat[finite])) if finite.any() else 1.0
        med = max(med, 1e-300)
        lag = (~finite) | (lat > self.controller.threshold * med)
        if lag.any():
            mult = float(
                np.where(finite, lat, med * self._spike)[lag].mean() / med
            )
            s = self.spike_decay
            self._spike = s * self._spike + (1.0 - s) * mult
        self._calm_steps = 0 if conv.any() else self._calm_steps + 1

    def observe_block(self, latencies: np.ndarray) -> None:
        """Row-wise fold of a fused macro-step's ``[K, n_blocks]`` latency
        block — posterior AND economics trajectories (onset rate, spike,
        calm window) exactly match K scalar :meth:`observe` calls."""
        lats = np.asarray(latencies, dtype=np.float64)
        if lats.ndim != 2 or lats.shape[1] != self.controller.n_blocks:
            raise ValueError(
                f"latency block must be [K, {self.controller.n_blocks}],"
                f" got {lats.shape}"
            )
        for row in lats:
            self.observe(row)

    @property
    def calm(self) -> bool:
        """No convicted shard for the last ``calm_patience`` steps."""
        return self._calm_steps >= self.calm_patience

    def relax_worthwhile(self, max_parity: int) -> bool:
        """Expected onset cost of keeping ``max_parity`` extra shards for a
        step vs the masked-decode overhead those drops would cost."""
        exposure = max_parity / max(self.controller.n_blocks, 1)
        return self._onset_rate * exposure * self._spike < self.relax_overhead

    def _level_one(
        self, max_parity: int, slack_steps: float, escalate_steps: float
    ) -> int:
        """One slack → parity conversion at a given escalation threshold.
        Float-identical to the pre-tenant ``level`` when ``escalate_steps``
        is ``self.escalate_steps`` — the per-tenant subclass reuses this per
        SLO class."""
        base = self.controller.parity_level(max_parity)
        if not np.isfinite(slack_steps):
            return base
        urgency = min(max(1.0 - slack_steps / escalate_steps, 0.0), 1.0)
        floor = int(np.ceil(urgency * max_parity))
        if base > 0 or not self.calm or not self.relax_worthwhile(max_parity):
            floor = max_parity
        return int(min(max_parity, max(base, floor)))

    def level(self, max_parity: int, slack_steps: float) -> int:
        """Parity level for this step given the tightest request's slack
        (in units of estimated steps; +inf = no deadline pressure)."""
        return self._level_one(max_parity, slack_steps, self.escalate_steps)


class TenantDeadlineParity(DeadlineAwareParity):
    """Per-tenant slack → parity: each SLO class converts ITS OWN tightest
    slack into a parity demand at its own escalation threshold, and the
    step runs at the maximum over classes (DESIGN.md §13).

    Rationale: a premium class with ``escalate_steps=16`` starts hedging
    while a best-effort class with ``escalate_steps=4`` is still relaxed —
    the global policy would let the batch-wide min slack (usually the
    best-effort backlog) dictate parity for everyone, either over-paying
    decode overhead for tenants that do not need it or reacting too late
    for tenants that do.  Evidence state (onset rate, spike magnitude,
    calm window) stays GLOBAL — stragglers are a cluster property, not a
    tenant property — so ``observe`` is inherited unchanged.

    With a single class whose ``escalate_steps`` equals the policy's own,
    ``level_classes([s])`` is EXACTLY ``DeadlineAwareParity.level(s)`` (the
    degradation property, asserted in tests/test_serve_batch.py)."""

    def __init__(self, controller: ParityController, classes=(), **kw):
        super().__init__(controller, **kw)
        esc = [float(getattr(c, "escalate_steps", c)) for c in classes]
        if not esc:
            esc = [self.escalate_steps]
        if any(e <= 0 for e in esc):
            raise ValueError("class escalate_steps must be positive")
        self.class_escalate = tuple(esc)

    def level_classes(self, max_parity: int, slack_steps) -> int:
        """Parity for this step: max over per-class slack conversions.
        ``slack_steps[c]`` is class c's tightest admitted slack (+inf when
        the class has nothing admitted)."""
        slacks = np.asarray(slack_steps, np.float64)
        if len(slacks) != len(self.class_escalate):
            raise ValueError("slack vector length != number of classes")
        return max(
            self._level_one(max_parity, float(s), e)
            for s, e in zip(slacks, self.class_escalate)
        )

    def level(self, max_parity: int, slack_steps) -> int:
        """Accept either the global scalar slack (degraded mode) or the
        per-class vector."""
        if np.ndim(slack_steps) == 0:
            return super().level(max_parity, float(slack_steps))
        return self.level_classes(max_parity, slack_steps)
