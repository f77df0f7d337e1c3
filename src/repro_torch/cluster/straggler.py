"""Unexpected-straggler injection (paper §5.3.1) + mid-task churn sampling.

"the probability of a worker node to be a straggler is set to 0.2, and the
straggler is emulated by delaying the return of computing results such that
the computing time observed by the master node is three times of the actual
computing time."

``StragglerPolicy`` is the paper's disturbance: a per-task multiplicative
slowdown drawn once, before the task starts.  ``ChurnPolicy`` extends the
scenario space to *mid-task* disturbances (DESIGN.md §8): rate regime
switches (drift), worker death, and late joins, sampled as a
``core.adaptive.ChurnSchedule`` of model-time events that the static
allocation cannot react to but the adaptive reallocation loop can.

Copied from ``repro.cluster.straggler``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.
The tests hold the copy bit-equal to the reference on the same seeds.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.adaptive import ChurnEvent, ChurnSchedule
from repro_torch.utils.prng import rng as _rng

__all__ = [
    "StragglerPolicy",
    "MarkovStragglerPolicy",
    "MarkovStragglerStream",
    "ChurnPolicy",
]


@dataclass(frozen=True)
class StragglerPolicy:
    """Bernoulli(prob) straggler draw per (worker, task); observed time x slowdown."""

    prob: float = 0.0
    slowdown: float = 3.0

    def draw(self, n_workers: int, seed: int) -> np.ndarray:
        """Multiplier per worker for this task: slowdown where hit, else 1."""
        if self.prob <= 0.0:
            return np.ones(n_workers)
        g = _rng(seed)
        hit = g.uniform(size=n_workers) < self.prob
        return np.where(hit, self.slowdown, 1.0)


@dataclass(frozen=True)
class MarkovStragglerPolicy:
    """Per-worker two-state Markov straggling for the training path.

    The serve bench's ``StragglerInjection`` (serve/scheduler.py) with the
    same semantics, reused per *training step* instead of per decode step:

    onset       — per-worker per-step probability a healthy worker turns slow
                  (stationary slow fraction = onset·persistence /
                  (1 + onset·persistence)).
    slow_factor — compute-time multiplier while slow.
    persistence — mean steps a slow regime lasts (geometric sojourn).
    noise       — multiplicative healthy jitter: time × (1 + noise·U).
    """

    onset: float = 0.0
    slow_factor: float = 3.0
    persistence: float = 25.0
    noise: float = 0.1

    def __post_init__(self):
        if not 0.0 <= self.onset < 1.0 or self.slow_factor < 1.0:
            raise ValueError(f"bad Markov straggler policy {self}")
        if self.persistence < 1.0 or self.noise < 0.0:
            raise ValueError(f"bad Markov straggler policy {self}")

    @property
    def stationary_slow_fraction(self) -> float:
        return self.onset * self.persistence / (1.0 + self.onset * self.persistence)

    @classmethod
    def from_stationary(
        cls,
        prob: float,
        slow_factor: float = 3.0,
        persistence: float = 25.0,
        noise: float = 0.1,
    ) -> "MarkovStragglerPolicy":
        """Policy whose stationary slow fraction equals the paper's i.i.d.
        straggler probability (§5.3.1's prob=0.2, slowdown=3 maps here)."""
        if not 0.0 <= prob < 1.0:
            raise ValueError(f"prob must be in [0, 1), got {prob}")
        onset = prob / (persistence * (1.0 - prob))
        return cls(onset=onset, slow_factor=slow_factor,
                   persistence=persistence, noise=noise)

    def stream(self, n_workers: int, seed: int = 0) -> "MarkovStragglerStream":
        return MarkovStragglerStream(n_workers, self, seed)


class MarkovStragglerStream:
    """Seeded per-step worker compute-time multipliers under
    ``MarkovStragglerPolicy`` (mirrors serve's ``ShardLatencyModel``)."""

    def __init__(self, n_workers: int, policy: MarkovStragglerPolicy, seed: int = 0):
        self.n_workers = int(n_workers)
        self.policy = policy
        self._rng = np.random.default_rng(seed)
        self.slow = np.zeros(self.n_workers, bool)

    def step(self) -> np.ndarray:
        """Advance regimes one step; realized multiplier per worker (≥ 1)."""
        pol = self.policy
        mult = 1.0 + pol.noise * self._rng.random(self.n_workers)
        if pol.onset > 0.0:
            u = self._rng.random(self.n_workers)
            recover = self.slow & (u < 1.0 / pol.persistence)
            onset = ~self.slow & (u < pol.onset)
            self.slow = (self.slow & ~recover) | onset
            mult = np.where(self.slow, mult * pol.slow_factor, mult)
        return mult


@dataclass(frozen=True)
class ChurnPolicy:
    """Random mid-task churn generator (drift regime switches + deaths).

    Per worker, independently:
      * with probability ``drift_prob`` the worker switches rate regime at a
        time uniform in ``window`` (as fractions of the task horizon): with
        probability ``speedup_frac`` its observed seconds-per-row becomes
        1/(1 + drift_mag·U) of the base draw (a speedup), otherwise
        (1 + drift_mag·U) times it (a slowdown), U ~ U[0.5, 1] so a sampled
        drift is never vanishingly small;
      * with probability ``death_prob`` the worker dies at a time uniform in
        ``window`` — batches after that instant are lost, and the master is
        never told (detection is the estimator's job, DESIGN.md §8).

    ``sample`` draws one ``ChurnSchedule`` per (task, seed) realization with
    a fixed per-worker stream order, so schedules are deterministic in the
    seed exactly like every other draw in the framework.
    """

    drift_prob: float = 0.0
    drift_mag: float = 2.0
    speedup_frac: float = 0.25
    death_prob: float = 0.0
    window: tuple[float, float] = (0.1, 0.6)

    def __post_init__(self):
        if not 0.0 <= self.drift_prob <= 1.0 or not 0.0 <= self.death_prob <= 1.0:
            raise ValueError(f"probabilities must be in [0, 1], got {self}")
        if self.drift_mag < 0 or not 0.0 <= self.speedup_frac <= 1.0:
            raise ValueError(f"bad churn policy {self}")
        if not 0.0 <= self.window[0] < self.window[1]:
            raise ValueError(f"bad churn window {self.window}")

    def __bool__(self) -> bool:
        return self.drift_prob > 0.0 or self.death_prob > 0.0

    def sample(self, n_workers: int, horizon: float, seed: int) -> ChurnSchedule:
        """One churn realization; ``horizon`` scales the event-time window
        (pass the static allocation's tau*)."""
        if horizon <= 0 or not np.isfinite(horizon):
            raise ValueError(f"horizon must be positive/finite, got {horizon}")
        g = _rng(seed)
        w0, w1 = self.window
        events: list[ChurnEvent] = []
        for i in range(n_workers):
            # fixed six-draw stream per worker keeps schedules seed-stable
            u_d, u_t, u_mag, u_dir, u_death, u_td = g.uniform(size=6)
            if self.drift_prob > 0.0 and u_d < self.drift_prob and self.drift_mag > 0:
                t = horizon * (w0 + (w1 - w0) * u_t)
                mag = 1.0 + self.drift_mag * (0.5 + 0.5 * u_mag)
                factor = 1.0 / mag if u_dir < self.speedup_frac else mag
                events.append(ChurnEvent(t=float(t), worker=i, kind="rate", factor=factor))
            if self.death_prob > 0.0 and u_death < self.death_prob:
                t = horizon * (w0 + (w1 - w0) * u_td)
                events.append(ChurnEvent(t=float(t), worker=i, kind="death"))
        return ChurnSchedule(tuple(events))
