"""Shifted-exponential batch-completion model (paper Eq. 3 / Eq. 21).

The paper models the waiting time for the master to receive the k-th batch
from worker i as

    Pr[T_{k,i} <= t] = 1 - exp(-mu_i * (t / (k * b_i) - alpha_i)),   t >= k b_i alpha_i

i.e. the time to produce ``rows`` coded rows is ``rows * (alpha + E/mu)`` in
expectation, where E ~ Exp(1).  Equivalently  T(rows) = rows * (alpha + X/mu)
with X ~ Exp(1) drawn once per (worker, task) — the *scale* grows linearly
with the assigned rows, matching Eq. (21): Pr[T <= t] = 1 - e^{-(mu/r)(t - alpha r)}.

This module provides:
  * sampling of batch-arrival times for a worker (used by the simulator and
    the cluster emulator),
  * the CDF/mean utilities used by the allocation math,
  * maximum-likelihood estimation of (mu, alpha) from observed completion
    times — the procedure of paper §5.2 (Table 1), reused online by
    ``repro.runtime.health``.

Copied from ``repro.core.distributions``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.
The tests hold the copy bit-equal to the reference on the same seeds.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.utils.prng import rng as _rng


@dataclass(frozen=True)
class ShiftedExp:
    """Per-worker straggling model: straggle rate ``mu`` and shift ``alpha``.

    Both are positive; larger mu = less straggling, larger alpha = slower
    deterministic per-row compute.
    """

    mu: float
    alpha: float

    def __post_init__(self):
        if self.mu <= 0 or self.alpha <= 0:
            raise ValueError(f"mu and alpha must be positive, got {self}")

    # ---- distribution of the time to finish `rows` rows ---------------
    def cdf(self, t: np.ndarray | float, rows: float) -> np.ndarray:
        """Pr[T(rows) <= t] per Eq. (3) with k*b_i == rows."""
        t = np.asarray(t, dtype=np.float64)
        z = self.mu * (t / rows - self.alpha)
        return np.where(t >= rows * self.alpha, 1.0 - np.exp(-np.clip(z, 0.0, 700.0)), 0.0)

    def mean_time(self, rows: float) -> float:
        """E[T(rows)] = rows * (alpha + 1/mu)."""
        return rows * (self.alpha + 1.0 / self.mu)

    def quantile(self, p: float, rows: float) -> float:
        """Inverse CDF."""
        return rows * (self.alpha - np.log1p(-p) / self.mu)

    # ---- sampling ------------------------------------------------------
    def sample_task_rate(self, seed: int, n: int = 1) -> np.ndarray:
        """Sample per-task effective seconds-per-row:  alpha + X/mu, X~Exp(1).

        One draw applies to the *whole* task of a worker: batch k of size b
        completes at  k*b*(alpha + X/mu), matching the paper's model where
        T_{k,i} is the k-batch waiting time and batches of one task share the
        same straggling realization (the EC2 behaviour §5.2 fits).
        """
        g = _rng(seed)
        return self.alpha + g.exponential(1.0, size=n) / self.mu

    def _draw(self, g: np.random.Generator) -> float:
        """One seconds-per-row draw from a shared Generator (simulator hot
        path; the draw order/stream must match ``sample_task_rate``)."""
        return self.alpha + g.exponential(1.0) / self.mu

    def to_shifted_exp(self) -> "ShiftedExp":
        return self

    def batch_arrival_times(self, loads_rows: np.ndarray, seed: int) -> np.ndarray:
        """Arrival times of cumulative row counts ``loads_rows`` (1-D, ascending)."""
        rate = self.sample_task_rate(seed, 1)[0]
        return np.asarray(loads_rows, dtype=np.float64) * rate


# --------------------------------------------------------------------------
# Heterogeneity beyond shifted-exponential (survey scenarios, arXiv:2008.09048)
# --------------------------------------------------------------------------
# Weibull and Pareto service-time models share the ShiftedExp interface
# (sample_task_rate / _draw / cdf / mean_time / quantile), so the simulator
# and the cluster emulator run them end to end.  The paper's Algorithm 1 is
# derived for the shifted-exponential CDF only, so for load allocation each
# model exposes ``to_shifted_exp()`` — a surrogate matching the essential
# infimum (the deterministic shift) and the mean excess (1/mu); the
# allocation is then the paper's, while the *realized* completion times come
# from the true heavy- or light-tailed distribution.

_EPS_ALPHA = 1e-12  # ShiftedExp requires alpha > 0; floor for shift-free models


@dataclass(frozen=True)
class Weibull:
    """Per-row service time  shift + scale * W,  W ~ Weibull(k) (unit scale).

    k < 1 is heavier-tailed than exponential (long straggler tails), k > 1
    lighter (more deterministic workers); k = 1 recovers ShiftedExp with
    mu = 1/scale exactly.
    """

    k: float
    scale: float
    shift: float = 0.0

    def __post_init__(self):
        if self.k <= 0 or self.scale <= 0 or self.shift < 0:
            raise ValueError(f"need k, scale > 0 and shift >= 0, got {self}")

    def mean_rate(self) -> float:
        """E[seconds-per-row]."""
        from scipy.special import gamma

        return self.shift + self.scale * float(gamma(1.0 + 1.0 / self.k))

    def cdf(self, t: np.ndarray | float, rows: float) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        z = np.clip((t / rows - self.shift) / self.scale, 0.0, None)
        return np.where(t >= rows * self.shift, 1.0 - np.exp(-(z**self.k)), 0.0)

    def mean_time(self, rows: float) -> float:
        return rows * self.mean_rate()

    def quantile(self, p: float, rows: float) -> float:
        return rows * (self.shift + self.scale * (-np.log1p(-p)) ** (1.0 / self.k))

    def sample_task_rate(self, seed: int, n: int = 1) -> np.ndarray:
        g = _rng(seed)
        return self.shift + self.scale * g.weibull(self.k, size=n)

    def _draw(self, g: np.random.Generator) -> float:
        return self.shift + self.scale * g.weibull(self.k)

    def to_shifted_exp(self) -> ShiftedExp:
        """Surrogate for Algorithm 1: alpha = shift, 1/mu = mean excess.

        A shift of 0 (the Weibull essential infimum) is replaced by the 1%
        service-time quantile: Eq. (18)/(20) scale as 1/alpha, so a
        zero-ish alpha sends the closed forms (and the p_i = ⌊ℓ̂_i⌋
        default) to infinity — the percentile keeps the math finite while
        staying faithful to "the fastest this worker realistically is".
        """
        from scipy.special import gamma

        excess = self.scale * float(gamma(1.0 + 1.0 / self.k))
        if self.shift > 0.0:
            alpha = self.shift  # true essential infimum, use it verbatim
        else:
            alpha = max(
                self.scale * float((-np.log1p(-0.01)) ** (1.0 / self.k)), _EPS_ALPHA
            )
        return ShiftedExp(mu=1.0 / excess, alpha=alpha)

    def batch_arrival_times(self, loads_rows: np.ndarray, seed: int) -> np.ndarray:
        rate = self.sample_task_rate(seed, 1)[0]
        return np.asarray(loads_rows, dtype=np.float64) * rate


@dataclass(frozen=True)
class Pareto:
    """Per-row service time  xm * (1 + P),  P ~ Lomax(a)  — i.e. Pareto with
    minimum ``xm`` and tail index ``a`` (heavy tail; finite mean needs a > 1).

    The canonical heavy-tailed straggler model: a small fraction of tasks is
    arbitrarily slow, stressing coded schemes far harder than shifted-exp.
    """

    xm: float
    a: float

    def __post_init__(self):
        if self.xm <= 0 or self.a <= 1.0:
            raise ValueError(f"need xm > 0 and tail index a > 1, got {self}")

    def mean_rate(self) -> float:
        return self.xm * self.a / (self.a - 1.0)

    def cdf(self, t: np.ndarray | float, rows: float) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        lo = rows * self.xm
        with np.errstate(divide="ignore"):
            tail = (lo / np.maximum(t, lo)) ** self.a
        return np.where(t >= lo, 1.0 - tail, 0.0)

    def mean_time(self, rows: float) -> float:
        return rows * self.mean_rate()

    def quantile(self, p: float, rows: float) -> float:
        return rows * self.xm * float((1.0 - p) ** (-1.0 / self.a))

    def sample_task_rate(self, seed: int, n: int = 1) -> np.ndarray:
        g = _rng(seed)
        return self.xm * (1.0 + g.pareto(self.a, size=n))

    def _draw(self, g: np.random.Generator) -> float:
        return self.xm * (1.0 + g.pareto(self.a))

    def to_shifted_exp(self) -> ShiftedExp:
        """Surrogate for Algorithm 1: alpha = xm, 1/mu = mean excess xm/(a-1)."""
        return ShiftedExp(mu=(self.a - 1.0) / self.xm, alpha=self.xm)

    def batch_arrival_times(self, loads_rows: np.ndarray, seed: int) -> np.ndarray:
        rate = self.sample_task_rate(seed, 1)[0]
        return np.asarray(loads_rows, dtype=np.float64) * rate


ServiceTimeModel = ShiftedExp | Weibull | Pareto


def as_shifted_exp(worker) -> ShiftedExp:
    """Shifted-exponential surrogate of any service-time model (identity for
    ShiftedExp) — what the allocation layer feeds to the paper's math."""
    if isinstance(worker, ShiftedExp):
        return worker
    return worker.to_shifted_exp()


def sample_heterogeneous_cluster(
    n_workers: int, seed: int, mu_range: tuple[float, float] = (1.0, 50.0)
) -> list[ShiftedExp]:
    """Paper §4.1.3: mu_i ~ U[1, 50], alpha_i = 1/mu_i."""
    g = _rng(seed)
    mus = g.uniform(mu_range[0], mu_range[1], size=n_workers)
    return [ShiftedExp(mu=float(m), alpha=float(1.0 / m)) for m in mus]


def estimate_parameters(times: np.ndarray, rows: float) -> ShiftedExp:
    """Estimate (mu, alpha) from i.i.d. completion times of a `rows`-row task.

    Paper §5.2: t0 = min(t) identifies alpha = t0 / rows; the exponential tail
    rate is the MLE  mu = 1 / mean(t/rows - alpha).  A small-sample bias
    correction (n/(n-1)) is applied to the tail mean.
    """
    times = np.asarray(times, dtype=np.float64)
    if times.ndim != 1 or times.size < 2:
        raise ValueError("need >= 2 samples")
    t0 = float(times.min())
    alpha = t0 / rows
    excess = times / rows - alpha
    n = times.size
    tail_mean = float(excess.sum() / max(n - 1, 1))  # exclude the zero at argmin
    if tail_mean <= 0:
        tail_mean = 1e-12
    return ShiftedExp(mu=1.0 / tail_mean, alpha=max(alpha, 1e-12))
