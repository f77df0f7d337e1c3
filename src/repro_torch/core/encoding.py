"""Erasure codes for coded computation.

Two code families, matching the paper's usage:

  * ``LTCode`` — Luby Transform fountain code with the robust-soliton degree
    distribution and a peeling decoder (paper §5.1, following Mallick et al.
    [40]).  Recovery needs any ``r(1+eps)`` coded rows; the paper uses
    eps = 0.13.  Encoding is sparse: coded row j = sum of ``deg_j`` source
    rows (coefficients 1), so the encode is a gather+add — implemented both
    here (numpy, the host encode) and as a CUDA kernel for the device encode
    of reserve rows (``repro_torch.kernels.lt_encode``).

  * ``GaussianCode`` — dense i.i.d. N(0, 1/r) generator; any r rows are
    full-rank w.p. 1 (the generic "H with any-r-rows-independent" code of
    paper §2.2.2).  Decoding is a least-squares solve; used on the SPMD path
    where fixed shapes + masked pseudo-inverse fit XLA.

Both produce an ``EncodePlan`` that worker-side sharding consumes: the plan
rows are laid out worker-major in the order of ``Allocation.loads`` so worker
i owns plan rows [offset_i, offset_i + l_i).

Copied from ``repro.core.encoding``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.
The tests hold the copy bit-equal to the reference on the same seeds.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from repro_torch.utils.prng import derive, rng as _rng

DEFAULT_OVERHEAD = 0.13  # paper §5.1: eps = 0.13


# --------------------------------------------------------------------------
# Plans
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class EncodePlan:
    """A q×r generator in padded-sparse form.

    indices  [q, d_max] int32 — source-row ids per coded row (padded)
    coeffs   [q, d_max] float32 — coefficients (0 where padded)
    r, q     — source rows / coded rows
    kind     — 'lt' | 'gaussian' | 'systematic_lt'
    """

    indices: np.ndarray
    coeffs: np.ndarray
    r: int
    q: int
    kind: str

    def __post_init__(self):
        assert self.indices.shape == self.coeffs.shape
        assert self.indices.shape[0] == self.q

    @property
    def d_max(self) -> int:
        return self.indices.shape[1]

    @cached_property
    def degrees(self) -> np.ndarray:
        return (self.coeffs != 0).sum(axis=1).astype(np.int32)

    def dense_generator(self) -> np.ndarray:
        """Materialize G as a dense [q, r] float32 matrix (tests / LS decode)."""
        g = np.zeros((self.q, self.r), dtype=np.float32)
        rows = np.repeat(np.arange(self.q), self.d_max)
        cols = self.indices.reshape(-1)
        vals = self.coeffs.reshape(-1)
        np.add.at(g, (rows, cols), vals)
        return g

    def slice_rows(self, start: int, stop: int) -> "EncodePlan":
        return EncodePlan(
            indices=self.indices[start:stop],
            coeffs=self.coeffs[start:stop],
            r=self.r,
            q=stop - start,
            kind=self.kind,
        )


def required_rows(r: int, kind: str, overhead: float = DEFAULT_OVERHEAD) -> int:
    """Rows needed for recovery w.h.p.: r for dense codes, r(1+eps) for LT."""
    if kind == "gaussian":
        return r
    return int(np.ceil(r * (1.0 + overhead)))


# --------------------------------------------------------------------------
# Robust soliton
# --------------------------------------------------------------------------
def robust_soliton(r: int, c: float = 0.03, delta: float = 0.5) -> np.ndarray:
    """Robust-soliton pmf over degrees 1..r (Luby 2002)."""
    if r < 2:
        return np.array([1.0])
    d = np.arange(1, r + 1, dtype=np.float64)
    rho = np.zeros(r)
    rho[0] = 1.0 / r
    rho[1:] = 1.0 / (d[1:] * (d[1:] - 1.0))
    s = c * np.log(r / delta) * np.sqrt(r)
    s = min(max(s, 1.0 + 1e-9), float(r))
    pivot = int(np.floor(r / s))
    tau = np.zeros(r)
    if pivot >= 2:
        dd = np.arange(1, pivot, dtype=np.float64)
        tau[: pivot - 1] = s / (dd * r)
    if 1 <= pivot <= r:
        tau[pivot - 1] = s * np.log(s / delta) / r if s > delta else tau[pivot - 1]
    pmf = rho + tau
    return pmf / pmf.sum()


# --------------------------------------------------------------------------
# Code families
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class LTCode:
    """Luby-Transform code over the reals (coefficients = 1)."""

    r: int
    seed: int = 0
    c: float = 0.03
    delta: float = 0.5
    systematic_prefix: bool = True  # first r coded rows = identity (common trick:
    # lets the uncoded fast path reuse the same storage, and guarantees the
    # no-straggler case decodes instantly)

    def plan(self, q: int) -> EncodePlan:
        if q < self.r and not self.systematic_prefix:
            raise ValueError("q must be >= r")
        g = _rng(derive(self.seed, "lt", self.r, q))
        pmf = robust_soliton(self.r, self.c, self.delta)
        n_random = q - self.r if self.systematic_prefix else q
        n_random = max(n_random, 0)
        degs = g.choice(np.arange(1, self.r + 1), size=n_random, p=pmf) if n_random else (
            np.zeros(0, np.int64)
        )
        d_max = int(max(int(degs.max()) if n_random else 1, 1))
        idx = np.zeros((q, d_max), dtype=np.int32)
        cof = np.zeros((q, d_max), dtype=np.float32)
        row = 0
        if self.systematic_prefix:
            n_sys = min(self.r, q)
            idx[:n_sys, 0] = np.arange(n_sys, dtype=np.int32)
            cof[:n_sys, 0] = 1.0
            row = n_sys
        for j in range(n_random):
            d = int(degs[j])
            members = g.choice(self.r, size=d, replace=False)
            idx[row + j, :d] = members
            cof[row + j, :d] = 1.0
        kind = "systematic_lt" if self.systematic_prefix else "lt"
        return EncodePlan(indices=idx, coeffs=cof, r=self.r, q=q, kind=kind)


@dataclass(frozen=True)
class GaussianCode:
    """Dense random code: G ~ N(0, 1/r); any r rows invertible a.s."""

    r: int
    seed: int = 0

    def plan(self, q: int) -> EncodePlan:
        g = _rng(derive(self.seed, "gauss", self.r, q))
        dense = (g.standard_normal((q, self.r)) / np.sqrt(self.r)).astype(np.float32)
        # padded-sparse with d_max = r (fully dense)
        idx = np.broadcast_to(np.arange(self.r, dtype=np.int32), (q, self.r)).copy()
        return EncodePlan(indices=idx, coeffs=dense, r=self.r, q=q, kind="gaussian")


# --------------------------------------------------------------------------
# Encoding (host, numpy)
# --------------------------------------------------------------------------
# bound on encode_matrix's gather buffer, in bytes
ENCODE_GATHER_BYTES = 256 << 20
# column pieces start on multiples of this: numpy's einsum takes the columns
# in SIMD blocks, and a piece that began mid-block would move columns
# between its vector body and its scalar tail, which round differently
_COLUMN_ALIGN = 1024


def encode_matrix(
    a: np.ndarray, plan: EncodePlan, max_bytes: int = ENCODE_GATHER_BYTES
) -> np.ndarray:
    """Â = G A:  Â[j] = Σ_d coeffs[j,d] * A[indices[j,d]], summed in table order.

    The reference gathers ``a[plan.indices[s:e]]`` for 4096 rows at a time:
    a [4096, d_max, m] buffer in which padding dominates (an LT plan's d_max
    is its largest degree, some hundred times its mean degree), about 15 TB
    at the paper's r = 5,000 and m = 500,000 (d_max 1,850).  This copy
    differs in form only.  It groups the rows by their count of nonzero coefficients,
    gathers just those entries (in table order), and cuts each group into
    pieces of rows, and of columns where one row is too wide, whose gather
    buffer stays within ``max_bytes`` (a column piece is at least 1024
    columns wide).  Every output element is the same einsum over the same
    terms in the same order; the skipped terms are 0·A[i], exact zeros for
    finite A, so the result equals the reference's bit for bit (the tests
    assert ``np.array_equal``).  With m = 1 numpy reduces over the table
    axis itself, in partial sums placed by table position, so there the
    padded rows are kept, in pieces of rows.
    """
    r, m = a.shape
    if r != plan.r:
        raise ValueError(f"A has {r} rows, plan expects {plan.r}")
    out = np.empty((plan.q, m), dtype=np.result_type(a.dtype, np.float32))
    if m == 1:
        n_rows = max(1, max_bytes // (plan.d_max * a.itemsize))
        for s in range(0, plan.q, n_rows):
            e = min(s + n_rows, plan.q)
            out[s:e] = np.einsum("cd,cdm->cm", plan.coeffs[s:e], a[plan.indices[s:e]])
        return out
    nonzero = plan.coeffs != 0
    degrees = nonzero.sum(axis=1)
    for k in np.unique(degrees).tolist():
        rows = np.flatnonzero(degrees == k)
        if k == 0:
            out[rows] = 0
            continue
        # the k nonzero entries of each row, in table order
        idx = plan.indices[rows][nonzero[rows]].reshape(len(rows), k)
        cof = plan.coeffs[rows][nonzero[rows]].reshape(len(rows), k)
        row_bytes = k * m * a.itemsize
        n_rows = max(1, max_bytes // row_bytes)
        width = m
        if row_bytes > max_bytes:
            fit = max_bytes // (k * a.itemsize)
            width = max(_COLUMN_ALIGN, fit - fit % _COLUMN_ALIGN)
        for s in range(0, len(rows), n_rows):
            e = min(s + n_rows, len(rows))
            for c0 in range(0, m, width):
                c1 = min(c0 + width, m)
                gathered = a[idx[s:e], c0:c1]  # [rows, k, columns]
                out[rows[s:e], c0:c1] = np.einsum("cd,cdm->cm", cof[s:e], gathered)
    return out
