"""Serving-side parity control: the straggler posterior that picks the
coded head's parity level per decode step.

A copy of ``repro.core.adaptive.ParityController`` (numpy); the other
adaptive controllers join with the slices that use them.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ParityController"]


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
