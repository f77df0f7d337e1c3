"""Mask-keyed decoder cache for the block-MDS code, and the first-decodable mask.

Every erasure pattern of at most ``n_parity`` blocks gets its recovery
pseudo-inverse computed once, host-side in float64 (numpy, as in the
reference ``repro.core.decoding``), then kept as float32 device tensors:

    table [n_patterns, n_data, n_blocks]   recovery matrices
    lut   [2^n_blocks]                     mask bit-pattern -> table row

``recovery(mask)`` turns the 0/1 mask into its bit pattern with a dot
against powers of two and gathers the table row, on the mask's device: no
host sync and no ``torch.linalg`` on the step path.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

__all__ = [
    "MAX_LUT_BLOCKS",
    "MAX_LUT_PATTERNS",
    "DecoderCache",
    "cacheable",
    "decodable_patterns",
    "decoder_cache_stats",
    "first_decodable_mask",
    "get_decoder_cache",
]

# a lut over bitmasks needs 2^n_blocks entries; beyond 20 blocks the cache
# refuses and callers fall back to the SVD decode
MAX_LUT_BLOCKS = 20
# the table holds sum_e C(n_blocks, e) matrices; cap the pattern count too
MAX_LUT_PATTERNS = 8192


def decodable_patterns(n_blocks: int, n_parity: int) -> int:
    """Number of erasure patterns a DecoderCache would precompute."""
    return sum(math.comb(n_blocks, e) for e in range(n_parity + 1))


def cacheable(n_data: int, n_parity: int) -> bool:
    """Whether this code geometry fits the DecoderCache bounds."""
    n_blocks = n_data + n_parity
    return (
        n_blocks <= MAX_LUT_BLOCKS
        and decodable_patterns(n_blocks, n_parity) <= MAX_LUT_PATTERNS
    )


class DecoderCache:
    """Precomputed recovery matrices for every erasure pattern <= n_parity.

    Masks with more than ``n_parity`` erasures are not decodable; the lut
    maps them to row 0, the full-mask (identity-prefix) recovery, so the
    gather stays total.  Callers that can observe such masks check survivor
    counts themselves.
    """

    builds = 0  # class-wide build counter (one per geometry per process)

    def __init__(self, n_data: int, n_parity: int, generator: np.ndarray | None = None):
        n_blocks = n_data + n_parity
        if n_blocks > MAX_LUT_BLOCKS:
            raise ValueError(
                f"DecoderCache lut would need 2^{n_blocks} entries; "
                f"use the SVD fallback beyond {MAX_LUT_BLOCKS} blocks"
            )
        n_patterns = decodable_patterns(n_blocks, n_parity)
        if n_patterns > MAX_LUT_PATTERNS:
            raise ValueError(
                f"DecoderCache would precompute {n_patterns} patterns "
                f"(> {MAX_LUT_PATTERNS}); use the SVD fallback for "
                f"high-parity geometries"
            )
        self.n_data, self.n_parity, self.n_blocks = n_data, n_parity, n_blocks
        if generator is None:
            from repro_torch.core.coded_ops import block_mds_generator_np

            generator = block_mds_generator_np(n_blocks, n_data)
        b = np.asarray(generator, np.float64)

        mats: list[np.ndarray] = []
        lut = np.zeros(1 << n_blocks, np.int32)
        full = (1 << n_blocks) - 1
        for n_erased in range(n_parity + 1):
            for pat in itertools.combinations(range(n_blocks), n_erased):
                erased = np.zeros(n_blocks, bool)
                erased[list(pat)] = True
                bm = b * (~erased)[:, None]
                pinv = np.linalg.pinv(bm)
                # one Newton–Schulz step polishes the float64 pinv, so the
                # float32 cast is the only error the hot path sees
                pinv = pinv @ (2.0 * np.eye(n_blocks) - bm @ pinv)
                pinv[:, erased] = 0.0  # garbage columns exactly dead
                bits = int(np.sum((1 << np.arange(n_blocks))[~erased]))
                lut[bits] = len(mats)
                mats.append(pinv.astype(np.float32))
        if lut[full] != 0:  # full mask is pattern 0 (also the lut default)
            raise AssertionError("full-mask pattern must be table row 0")
        self.table = np.stack(mats)                       # [P, n_data, n_blocks]
        self.lut = lut                                    # [2^n_blocks]
        self.pows = (1 << np.arange(n_blocks, dtype=np.int64)).astype(np.int32)
        self.recovery_calls = 0
        self._dev: dict[torch.device, tuple[torch.Tensor, ...]] = {}
        DecoderCache.builds += 1

    def tables(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(table, lut, pows) as tensors on ``device``, uploaded once."""
        device = torch.device(device)
        dev = self._dev.get(device)
        if dev is None:
            dev = self._dev[device] = (
                torch.as_tensor(self.table, device=device),
                torch.as_tensor(self.lut, device=device),
                torch.as_tensor(self.pows, device=device),
            )
        return dev

    def index(self, mask: torch.Tensor) -> torch.Tensor:
        """Table row [1] (int32) for a 0/1 (or bool) survivor mask."""
        _table, lut, pows = self.tables(mask.device)
        bits = ((mask > 0.5).to(torch.int32) * pows).sum().reshape(1)
        return lut.index_select(0, bits)

    def recovery(self, mask: torch.Tensor) -> torch.Tensor:
        """The cached [n_data, n_blocks] recovery matrix for this mask."""
        self.recovery_calls += 1
        table, _lut, _pows = self.tables(mask.device)
        return table.index_select(0, self.index(mask))[0]


def first_decodable_mask(
    latency: np.ndarray, n_data: int, n_parity: int
) -> np.ndarray:
    """0/1 mask keeping the FIRST decodable subset of coded blocks.

    ``latency`` [n_blocks] — per-shard arrival-time estimates (np.inf =
    dead).  Keeps the ``n_data`` earliest shards (stable index tie-break),
    so the decode never waits for the slowest ``n_parity``.  If fewer than
    ``n_data`` shards are finite the finite ones are kept (an undecodable
    mask the caller must handle).
    """
    latency = np.asarray(latency, dtype=np.float64)
    n_blocks = n_data + n_parity
    if latency.shape != (n_blocks,):
        raise ValueError(f"latency must be [{n_blocks}], got {latency.shape}")
    mask = np.zeros(n_blocks, dtype=np.float64)
    finite = np.isfinite(latency)
    if finite.sum() <= n_data:
        mask[finite] = 1.0
        return mask
    keep = np.argsort(latency, kind="stable")[:n_data]
    mask[keep] = 1.0
    return mask


_DECODER_CACHES: dict[tuple[int, int], DecoderCache] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def get_decoder_cache(n_data: int, n_parity: int) -> DecoderCache:
    """Process-lifetime memoized DecoderCache (one per code geometry)."""
    key = (n_data, n_parity)
    if key not in _DECODER_CACHES:
        _CACHE_STATS["misses"] += 1
        _DECODER_CACHES[key] = DecoderCache(n_data, n_parity)
    else:
        _CACHE_STATS["hits"] += 1
    return _DECODER_CACHES[key]


def decoder_cache_stats() -> dict:
    """Copy of the process-lifetime get_decoder_cache hit/miss counters."""
    return dict(_CACHE_STATS)
