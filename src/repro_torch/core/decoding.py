"""Decoders for coded computation: the task form's streaming decoders and
the serving head's mask-keyed decoder cache.

  * ``StreamingLTDecoder`` / ``StreamingLSDecoder`` (factory
    ``StreamingDecoder.for_plan``) — the master's incremental decode path:
    batches are ingested as they arrive so recovery overlaps waiting.
    ``peel_decode_np`` and ``ls_decode_np`` are the one-shot references,
    each a single-ingest streaming run.  Numpy and scipy, copied from
    ``repro.core.decoding``; the tests hold them bit-equal to the reference.
  * ``DecoderCache`` — every erasure pattern of at most ``n_parity`` blocks
    gets its recovery pseudo-inverse computed once, host-side in float64
    (numpy, as in the reference), then kept as float32 device tensors:

        table [n_patterns, n_data, n_blocks]   recovery matrices
        lut   [2^n_blocks]                     mask bit-pattern -> table row

    ``recovery(mask)`` turns the 0/1 mask into its bit pattern with a dot
    against powers of two and gathers the table row, on the mask's device:
    no host sync and no ``torch.linalg`` on the step path.
"""
from __future__ import annotations

import itertools
import math
from collections import deque

import numpy as np
import scipy.linalg
import torch

from repro_torch.core.encoding import EncodePlan

__all__ = [
    "StreamingDecoder",
    "StreamingLSDecoder",
    "StreamingLTDecoder",
    "ls_decode",
    "ls_decode_np",
    "masked_pinv_decode",
    "peel_decode_np",
    "peel_decode_torch",
    "MAX_LUT_BLOCKS",
    "MAX_LUT_PATTERNS",
    "DecoderCache",
    "cacheable",
    "decodable_patterns",
    "decoder_cache_stats",
    "first_decodable_mask",
    "get_decoder_cache",
]

# --------------------------------------------------------------------------
# Streaming LT (peeling) decoder
# --------------------------------------------------------------------------
class StreamingLTDecoder:
    """Online peeling decoder: ingest coded rows as they arrive, propagate
    releases immediately.

    The decode is defined as a PURE FUNCTION OF THE ROW SEQUENCE: each row is
    processed to a ripple fixpoint before the next one, so how the stream is
    chunked into batches cannot change a single bit of the result — streaming
    arrival-by-arrival is bit-identical to the one-shot decode of the same
    rows in the same order (``peel_decode_np`` IS a single-ingest run of this
    class; asserted exhaustively in tests/test_streaming_decode.py).  The
    canonical schedule:

      * on arrival a row is reduced by its already-known members with one
        dot product (member order as stored in the plan row),
      * a degree-1 row enters a FIFO ripple; releases cascade breadth-first,
        subtracting the freshly recovered source from registered rows in
        their arrival order.

    Different arrival ORDERS recover the same source set (peeling to a
    fixpoint is confluent) but may associate float subtractions differently —
    equality across orders is exact structurally and ~1e-12 numerically.

    Per-row state uses the classic id-sum/coeff-sum trick, so a degree-1
    row's remaining member is read off in O(1); total work is O(nnz), same as
    the one-shot decoder this replaces, but spread across arrivals — the
    post-threshold residual (``finalize``) is a single dtype cast.
    """

    def __init__(self, r: int):
        self.r = int(r)
        self.known = np.zeros(self.r, dtype=bool)
        self.n_recovered = 0
        self.rows_ingested = 0
        self._y: np.ndarray | None = None      # [r, m] float64, lazy (m unknown)
        self._dtype = None
        self._vals: list[np.ndarray | None] = []   # pending-row residual values
        self._deg: list[int] = []
        self._idsum: list[int] = []
        self._cfsum: list[float] = []
        self._inv: list[list[tuple[int, float]]] = [[] for _ in range(self.r)]
        self._ripple: deque[int] = deque()

    @property
    def decodable(self) -> bool:
        return self.n_recovered >= self.r

    def ingest(self, coded: np.ndarray, indices: np.ndarray, coeffs: np.ndarray) -> int:
        """Feed one arriving batch of coded rows; returns sources recovered
        so far.  Rows are processed strictly one at a time (see class doc)."""
        coded = np.asarray(coded)
        if coded.ndim == 1:
            coded = coded[:, None]
        if self._y is None:
            self._y = np.zeros((self.r, coded.shape[1]), dtype=np.float64)
            self._dtype = coded.dtype
        for i in range(coded.shape[0]):
            self._ingest_row(coded[i], indices[i], coeffs[i])
            self._drain()
        self.rows_ingested += coded.shape[0]
        return self.n_recovered

    def _ingest_row(self, val: np.ndarray, idx_row: np.ndarray, cof_row: np.ndarray):
        live = np.flatnonzero(cof_row)
        members = idx_row[live].astype(np.int64)
        cfs = cof_row[live].astype(np.float64)
        val = val.astype(np.float64)
        kn = self.known[members]
        if kn.any():
            val = val - cfs[kn] @ self._y[members[kn]]
        else:
            val = val.copy()
        unknown = members[~kn]
        ucfs = cfs[~kn]
        deg = len(unknown)
        if deg == 0:
            return  # fully redundant row
        rid = len(self._deg)
        self._vals.append(val)
        self._deg.append(deg)
        self._idsum.append(int(unknown.sum()))
        self._cfsum.append(float(ucfs.sum()))
        if deg == 1:
            self._ripple.append(rid)
        else:
            for s, c in zip(unknown, ucfs):
                self._inv[int(s)].append((rid, float(c)))

    def _drain(self):
        while self._ripple and self.n_recovered < self.r:
            j = self._ripple.popleft()
            if self._deg[j] != 1:
                continue
            src = self._idsum[j]
            cf = self._cfsum[j]
            self._deg[j] = 0
            if self.known[src] or cf == 0.0:
                self._vals[j] = None
                continue
            ysrc = self._vals[j] / cf
            self._y[src] = ysrc
            self.known[src] = True
            self.n_recovered += 1
            self._vals[j] = None
            for t, c in self._inv[src]:
                if self._deg[t] <= 0:
                    continue
                self._vals[t] -= c * ysrc
                self._idsum[t] -= src
                self._cfsum[t] -= c
                self._deg[t] -= 1
                if self._deg[t] == 1:
                    self._ripple.append(t)
            self._inv[src] = []

    def finalize(self) -> tuple[np.ndarray, bool, int]:
        """(y [r, m], ok, n_recovered).  Pure — callable repeatedly, e.g. on
        every retry target; all numeric work already happened at ingest."""
        y = self._y if self._y is not None else np.zeros((self.r, 0), np.float64)
        dt = self._dtype if self._dtype is not None else np.float64
        return y.astype(dt, copy=False), self.decodable, self.n_recovered


# --------------------------------------------------------------------------
# Streaming least-squares (Gaussian code) decoder
# --------------------------------------------------------------------------
class StreamingLSDecoder:
    """Rank-updating LS decode for dense codes: warm normal equations +
    warm Cholesky, so the post-threshold decode is O(r²) back-substitution
    (plus a small Woodbury tail) instead of a from-scratch solve.

    As batches arrive, rows accumulate into GᵀG / Gᵀy via BLAS flushes.  To
    keep the decode a pure function of the ROW SEQUENCE (so any chunking of
    the same stream is bit-identical to the one-shot ``ls_decode_np``, which
    is a single-ingest run of this class), flushes happen at fixed GLOBAL
    row-count boundaries (multiples of ``block``), never at batch
    boundaries.  Once the flushed row count reaches ``r`` the Cholesky
    factor of GᵀG + reg·I is refreshed — the warm factorization — and
    re-refreshed every ``max(block, r // 8)`` further flushed rows, so the
    total refactorization work stays O(r³) amortized however long the
    stream runs (a naive per-flush refresh would be O(r⁴/block) over an
    ε-overhead stream at large r).

    ``finalize`` is pure and cheap: rows newer than the warm factor (flushed
    since the last refresh + the staged tail) join via a Woodbury
    correction — O(r²·(tail + nrhs)) with tail < r/8 + block — else one
    Cholesky from the accumulated Gram (still far less work than the
    terminal path's Gram build + solve; measured in
    benchmarks/streaming_bench.py).
    """

    def __init__(
        self,
        g_full: np.ndarray,
        nrhs: int = 1,
        *,
        reg: float = 1e-10,
        block: int = 64,
        warm: bool = True,
    ):
        self._g = np.asarray(g_full)
        self.r = self._g.shape[1]
        self.reg = float(reg)
        self.block = int(block)
        self.warm = bool(warm)
        self.rows_ingested = 0
        self._gtg = np.zeros((self.r, self.r), dtype=np.float64)
        self._gty = np.zeros((self.r, nrhs), dtype=np.float64)
        self._staged_ids: list[np.ndarray] = []
        self._staged_vals: list[np.ndarray] = []
        self._n_staged = 0
        self._n_flushed = 0
        self._chol = None       # scipy cho_factor of gtg + reg I at last refresh
        self._chol_rows = 0     # n_flushed the factor covers
        self._since_warm: list[np.ndarray] = []  # row ids flushed after it
        self._refresh_rows = max(self.block, self.r // 8)

    @property
    def decodable(self) -> bool:
        return self.rows_ingested >= self.r

    def ingest(self, row_ids: np.ndarray, vals: np.ndarray) -> int:
        """Feed one arriving batch: plan row ids + their coded values."""
        row_ids = np.asarray(row_ids, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        if vals.ndim == 1:
            vals = vals[:, None]
        self._staged_ids.append(row_ids)
        self._staged_vals.append(vals)
        self._n_staged += len(row_ids)
        self.rows_ingested += len(row_ids)
        if self._n_staged >= self.block:
            # one concatenation, then flush whole blocks by slicing (the
            # boundaries stay at fixed global row counts, so this is the
            # same flush sequence however the stream was chunked)
            ids = np.concatenate(self._staged_ids)
            vs = np.concatenate(self._staged_vals)
            n_blocks = self._n_staged // self.block
            for j in range(n_blocks):
                sl = slice(j * self.block, (j + 1) * self.block)
                self._flush_rows(ids[sl], vs[sl])
            rem = self._n_staged - n_blocks * self.block
            self._staged_ids = [ids[n_blocks * self.block :]] if rem else []
            self._staged_vals = [vs[n_blocks * self.block :]] if rem else []
            self._n_staged = rem
        return self.rows_ingested

    def _flush_rows(self, ids: np.ndarray, vs: np.ndarray):
        g = self._g[ids].astype(np.float64)
        self._gtg += g.T @ g
        self._gty += g.T @ vs
        self._n_flushed += self.block
        if not self.warm or self._n_flushed < self.r:
            return
        if self._n_flushed - self._chol_rows >= self._refresh_rows:
            a = self._gtg + self.reg * np.eye(self.r)
            self._chol = scipy.linalg.cho_factor(a, lower=True)
            self._chol_rows = self._n_flushed
            self._since_warm = []
        else:
            self._since_warm.append(ids)

    def _tail(self) -> tuple[np.ndarray, np.ndarray]:
        if self._n_staged == 0:
            return (np.zeros(0, np.int64), np.zeros((0, self._gty.shape[1])))
        return np.concatenate(self._staged_ids), np.concatenate(self._staged_vals)

    def finalize(self) -> tuple[np.ndarray, bool, int]:
        """(y [r, nrhs], ok, rows_ingested).  Pure: accumulation state is not
        mutated, so it can be called at every retry target and ingest can
        continue afterwards."""
        ids, vs = self._tail()
        vt = self._g[ids].astype(np.float64)             # [t, r] staged rows
        b = self._gty + vt.T @ vs
        if self._chol is not None:
            # warm path: A = L Lᵀ covers the flushed rows AT THE LAST
            # REFRESH; everything newer — flushed-since-warm (whose values
            # are already inside gty) and the staged tail — folds in by
            # Woodbury: (A + VᵀV)⁻¹ b = z − W (I + V W)⁻¹ V z, W = A⁻¹Vᵀ
            v_ids = (
                np.concatenate(self._since_warm + [ids])
                if self._since_warm
                else ids
            )
            v = self._g[v_ids].astype(np.float64) if len(v_ids) else vt
            z = scipy.linalg.cho_solve(self._chol, b)
            if len(v_ids):
                w = scipy.linalg.cho_solve(self._chol, v.T)
                c = np.eye(len(v_ids)) + v @ w
                z = z - w @ np.linalg.solve(c, v @ z)
            y = z
        else:
            a = self._gtg + vt.T @ vt + self.reg * np.eye(self.r)
            y = scipy.linalg.cho_solve(scipy.linalg.cho_factor(a, lower=True), b)
        return y, self.decodable, self.rows_ingested


# --------------------------------------------------------------------------
# Plan-keyed facade + one-shot references
# --------------------------------------------------------------------------
class StreamingDecoder:
    """Incremental decoder for an ``EncodePlan``: routes LT-family plans to
    the peeling decoder and dense (Gaussian) plans to the warm-LS decoder,
    behind one ``ingest(row_ids, vals)`` / ``finalize()`` interface keyed by
    plan row ids — what the cluster master feeds from its arrival queue."""

    def __init__(self, plan: EncodePlan, nrhs: int = 1, **ls_kw):
        self.plan = plan
        self.kind = "gaussian" if plan.kind == "gaussian" else "lt"
        if self.kind == "gaussian":
            self._ls = StreamingLSDecoder(plan.dense_generator(), nrhs, **ls_kw)
            self._lt = None
        else:
            self._lt = StreamingLTDecoder(plan.r)
            self._ls = None

    @classmethod
    def for_plan(cls, plan: EncodePlan, nrhs: int = 1, **ls_kw) -> "StreamingDecoder":
        return cls(plan, nrhs, **ls_kw)

    @property
    def rows_ingested(self) -> int:
        d = self._lt or self._ls
        return d.rows_ingested

    @property
    def decodable(self) -> bool:
        d = self._lt or self._ls
        return d.decodable

    def ingest(self, row_ids: np.ndarray, vals: np.ndarray) -> int:
        row_ids = np.asarray(row_ids, dtype=np.int64)
        if self._lt is not None:
            return self._lt.ingest(
                vals, self.plan.indices[row_ids], self.plan.coeffs[row_ids]
            )
        return self._ls.ingest(row_ids, vals)

    def finalize(self) -> tuple[np.ndarray, bool, int]:
        d = self._lt or self._ls
        return d.finalize()


def peel_decode_np(
    coded: np.ndarray,
    indices: np.ndarray,
    coeffs: np.ndarray,
    r: int,
) -> tuple[np.ndarray, bool, int]:
    """One-shot peeling decode of LT-coded rows — O(nnz).

    coded   [n, m]       — received coded rows (any subset/order of the plan)
    indices [n, d_max]   — source members per received row
    coeffs  [n, d_max]   — coefficients (0 = padding)
    returns (y [r, m], ok, n_recovered)

    Defined as a single-ingest ``StreamingLTDecoder`` run, which makes it THE
    reference the streaming path is bit-identical to: decoding a stream batch
    by batch equals calling this on the same rows in the same order.
    """
    dec = StreamingLTDecoder(r)
    dec.ingest(coded, indices, coeffs)
    y, ok, n_rec = dec.finalize()
    if y.shape[1] == 0 and coded.size == 0:
        y = np.zeros((r, coded.shape[1] if coded.ndim == 2 else 1), coded.dtype)
    return y.astype(coded.dtype, copy=False), ok, n_rec


def ls_decode_np(
    g_rows: np.ndarray,
    vals: np.ndarray,
    *,
    reg: float = 1e-10,
    block: int = 64,
) -> tuple[np.ndarray, bool, int]:
    """One-shot LS decode of dense-coded rows (host reference).

    g_rows [n, r] — received generator rows; vals [n, m] — their coded
    values.  Defined as a single-ingest ``StreamingLSDecoder`` run (same
    flush schedule), so streaming any chunking of the same row sequence is
    bit-identical to this one-shot call.
    """
    g_rows = np.asarray(g_rows)
    vals = np.asarray(vals)
    nrhs = 1 if vals.ndim == 1 else vals.shape[1]
    dec = StreamingLSDecoder(g_rows, nrhs, reg=reg, block=block)
    dec.ingest(np.arange(len(g_rows)), vals)
    return dec.finalize()


def peel_decode_torch(coded: torch.Tensor, membership: torch.Tensor, r: int):
    """Peeling with dense membership [n, r] (float coefficients; 0 = absent).

    The counterpart of the reference's ``peel_decode_jax``: fixed shapes,
    one source symbol per iteration, the reference's pivot choice (the
    first degree-1 row, its first member).  The reference's
    ``lax.while_loop`` becomes ``r`` guarded iterations with no host sync:
    each effective iteration clears a nonzero column, so at most ``r`` do
    anything, and once the ripple is empty or all ``r`` are known the rest
    change nothing.  Returns (y [r, m], known [r] bool).
    """
    vals = coded.to(torch.float32).clone()
    w = membership.to(torch.float32).clone()
    y = torch.zeros((r, coded.shape[1]), dtype=coded.dtype, device=coded.device)
    known = torch.zeros(r, dtype=torch.bool, device=coded.device)
    for _ in range(r):
        ones = (w != 0).sum(dim=1) == 1
        live = ones.any() & ~known.all()
        j = ones.to(torch.int32).argmax()          # first degree-1 row
        wj = w[j]
        src = (wj != 0).to(torch.int32).argmax()   # its member
        yv = (vals[j] / wj[src]).to(y.dtype)
        y[src] = torch.where(live & ~known[src], yv, y[src])
        known[src] = known[src] | live
        col = w[:, src]
        vals = vals - torch.where(live, col[:, None] * y[src][None, :], 0.0)
        w[:, src] = torch.where(live, 0.0, col)
    return y, known


def ls_decode(g_rows: torch.Tensor, coded: torch.Tensor) -> torch.Tensor:
    """Solve G y = coded for y given >= r received rows of a dense code
    (normal equations with a 1e-6 ridge)."""
    gtg = g_rows.T @ g_rows
    gty = g_rows.T @ coded
    eye = torch.eye(gtg.shape[0], dtype=gtg.dtype, device=gtg.device)
    return torch.linalg.solve(gtg + 1e-6 * eye, gty)


def masked_pinv_decode(
    g_full: torch.Tensor, coded_full: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Any-r-of-q recovery with a fixed-shape erasure mask.

    g_full [q, r] full dense generator, coded_full [q, m] all coded results
    (stragglers' entries are garbage), mask [q] 1.0 where the row arrived.
    y = (Gᵀ M G + λI)⁻¹ Gᵀ M ŷ with λ = 1e-7·tr(GᵀMG)/r: erased rows get
    zero weight, so garbage never enters the solve; one step of iterative
    refinement recovers most of the fp32 solve error.
    """
    m = mask.to(g_full.dtype)[:, None]
    gm = g_full * m
    gtg = gm.T @ g_full
    gty = gm.T @ (coded_full * m)
    lam = 1e-7 * torch.trace(gtg) / gtg.shape[0]
    a = gtg + lam * torch.eye(gtg.shape[0], dtype=gtg.dtype, device=gtg.device)
    y = torch.linalg.solve(a, gty)
    return y + torch.linalg.solve(a, gty - a @ y)



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
