"""Online (mu, alpha) estimation + straggler detection — paper §5.2, live.

On EC2 the paper measured each instance type offline (Table 1).  On a real
pod, per-worker effective throughput drifts (multi-tenancy, thermals,
failing hosts), so the framework estimates the shifted-exponential
parameters *online* from observed completion times and feeds them back into
Algorithm 1 — the BPCC load allocation tracks the cluster as it degrades.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.allocation import Allocation, bpcc_allocation
from repro_torch.core.distributions import ShiftedExp, estimate_parameters

__all__ = ["HealthMonitor"]


@dataclass
class HealthMonitor:
    n_workers: int
    window: int = 64                     # observations kept per worker
    prior: ShiftedExp = field(default_factory=lambda: ShiftedExp(mu=1e4, alpha=1e-4))
    latency_decay: float = 0.6           # EW decay of per-shard step latencies
    _obs: list[deque] = field(init=False)
    _lat: np.ndarray | None = field(init=False, default=None)

    def __post_init__(self):
        self._obs = [deque(maxlen=self.window) for _ in range(self.n_workers)]

    # ---- ingestion ------------------------------------------------------
    def record(self, worker: int, rows: float, seconds: float) -> None:
        """One observed task: ``rows`` of work took ``seconds`` (observed)."""
        if rows <= 0 or seconds <= 0:
            raise ValueError("rows and seconds must be positive")
        self._obs[worker].append(seconds / rows)  # normalized seconds-per-row

    def observe_step_latencies(self, latencies) -> None:
        """One serving step's realized per-shard latencies [n_workers]
        (np.inf = no result), or a ``[K, n_workers]`` block from a fused
        macro-step — folded row by row, so the EW trajectory is exactly K
        scalar calls (DESIGN.md §14).  Feeds the EW estimates the serving
        engine's ``latency_fn`` reads — the backward-looking signal the
        per-step erasure mask is committed from (DESIGN.md §10).
        Unreachable shards decay toward a large-but-finite penalty so a
        recovered shard can re-earn its place."""
        lat = np.asarray(latencies, dtype=np.float64)
        if lat.ndim == 2 and lat.shape[1] == self.n_workers:
            for row in lat:
                self.observe_step_latencies(row)
            return
        if lat.shape != (self.n_workers,):
            raise ValueError(f"latencies must be [{self.n_workers}], got {lat.shape}")
        finite = np.isfinite(lat)
        cap = 1e3 * (np.median(lat[finite]) if finite.any() else 1.0)
        lat = np.where(finite, lat, cap)
        if self._lat is None:
            self._lat = lat.copy()
        else:
            d = self.latency_decay
            self._lat = d * self._lat + (1.0 - d) * lat

    def shard_latencies(self) -> np.ndarray:
        """EW per-shard step-latency estimates (the ``latency_fn`` source);
        uniform ones before any observation."""
        if self._lat is None:
            return np.ones(self.n_workers)
        return self._lat.copy()

    # ---- estimation -----------------------------------------------------
    def estimate(self, worker: int) -> ShiftedExp:
        obs = np.asarray(self._obs[worker], dtype=np.float64)
        if obs.size < 2:
            return self.prior
        return estimate_parameters(obs, rows=1.0)

    def estimates(self) -> list[ShiftedExp]:
        return [self.estimate(i) for i in range(self.n_workers)]

    def mean_rates(self) -> np.ndarray:
        """Expected seconds-per-row per worker under current estimates."""
        return np.array([w.alpha + 1.0 / w.mu for w in self.estimates()])

    # ---- consumers ------------------------------------------------------
    def reallocate(self, r: int, p: int | None = None) -> Allocation:
        """Re-run the paper's Algorithm 1 with the live estimates."""
        return bpcc_allocation(r, self.estimates(), p=p)

    def straggler_mask(self, slowdown: float = 2.0) -> np.ndarray:
        """1 = healthy; 0 = current rate exceeds ``slowdown`` x cluster median."""
        rates = self.mean_rates()
        med = np.median(rates)
        return (rates <= slowdown * med).astype(np.float64)

    def microbatch_weights(self) -> np.ndarray:
        """DP microbatch re-balancing: work inversely proportional to the
        estimated per-row time (the Load-Balanced rule of paper §4.1.1,
        reused for data-parallel shard sizing)."""
        rates = self.mean_rates()
        w = 1.0 / rates
        return w / w.sum()
