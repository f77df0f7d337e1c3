"""Load allocation — the paper's Algorithm 1 and all benchmark schemes.

Implements, in closed correspondence with the paper:

  * ``solve_lambda``        — unique positive root of Eq. (7)
  * ``lambda_infimum``      — Lemma 1, Eq. (8):  inf λ_i = α_i        (p→∞)
  * ``lambda_supremum``     — Lemma 1, Eq. (9):  −(W(−e^{−αμ−1})+1)/μ (p=1)
  * ``beta``                — Eq. (13)
  * ``tau_star``            — Eq. (12):  τ* = r/β
  * ``bpcc_allocation``     — Algorithm 1 (with the ℓ_i ≥ p_i repair loop of §3.2)
  * ``tau_star_infimum``    — Theorem 6, Eq. (18) (closed form via E₁)
  * ``tau_star_supremum``   — Theorem 6, Eq. (19)   [see note on the paper typo]
  * ``load_infimum``        — Corollary 6.1, Eq. (20):  ℓ̂_i
  * ``hcmm_allocation``     — HCMM (Reisizadeh et al.) ≡ BPCC with p_i = 1
  * ``uniform_allocation``  — Uniform Uncoded
  * ``load_balanced_allocation`` — Load-Balanced Uncoded: ℓ_i ∝ μ_i/(μ_iα_i+1)

Note on Eq. (19): as printed in the paper the right-hand side equals β at
p_i = 1 (it is missing the leading ``r /``).  Dimensional analysis and
Theorem 5 (τ* monotone decreasing in p, so sup at p=1) give
``sup τ* = r / β(p=1)``; that is what we implement, and what the paper's own
Fig. 1 values are consistent with.

Copied from ``repro.core.allocation``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.
The tests hold the copy bit-equal to the reference on the same seeds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
from scipy import optimize, special

from repro_torch.core.distributions import ShiftedExp, as_shifted_exp

__all__ = [
    "Allocation",
    "solve_lambda",
    "lambda_infimum",
    "lambda_supremum",
    "eq7_lhs",
    "beta_term",
    "beta",
    "tau_star",
    "bpcc_allocation",
    "infimum_allocation",
    "hcmm_allocation",
    "uniform_allocation",
    "load_balanced_allocation",
    "tau_star_infimum",
    "tau_star_supremum",
    "load_infimum",
]


# --------------------------------------------------------------------------
# Eq. (7):  sum_{k=1..p} (1/p + mu*lam/k) * exp(-mu*(lam*p/k - alpha)) = 1
# --------------------------------------------------------------------------
def eq7_lhs(lam: float, mu: float, alpha: float, p: int) -> float:
    """Left-hand side of Eq. (7), evaluated stably."""
    k = np.arange(1, p + 1, dtype=np.float64)
    expo = -mu * (lam * p / k - alpha)
    expo = np.clip(expo, -745.0, 50.0)  # exp underflow guard; LHS<=e^50 is plenty
    return float(np.sum((1.0 / p + mu * lam / k) * np.exp(expo)))


def lambda_infimum(mu: float, alpha: float) -> float:
    """Lemma 1 Eq. (8): inf λ = α, attained as p → ∞."""
    del mu
    return alpha


def lambda_supremum(mu: float, alpha: float) -> float:
    """Lemma 1 Eq. (9): sup λ = −(W₋₁(−e^{−αμ−1}) + 1)/μ, attained at p = 1.

    The W₋₁ branch is required for the positive root (the W₀ branch gives the
    trivial negative solution).
    """
    z = -np.exp(-alpha * mu - 1.0)
    w = special.lambertw(z, k=-1)
    lam = float((-(w.real) - 1.0) / mu)
    return lam


def solve_lambda(mu: float, alpha: float, p: int) -> float:
    """Unique positive root λ of Eq. (7) for one worker (brentq, bracketed
    by Lemma 1: α < λ <= sup λ)."""
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    if p == 1:
        return lambda_supremum(mu, alpha)
    lo = alpha * (1.0 + 1e-13) if alpha > 0 else 1e-300
    hi = lambda_supremum(mu, alpha) * (1.0 + 1e-12)
    f = lambda lam: eq7_lhs(lam, mu, alpha, p) - 1.0
    flo, fhi = f(lo), f(hi)
    if flo <= 0.0:
        # numerically already at the infimum (huge p): λ ≈ α
        return alpha
    # Lemma 1 puts the root inside (α, sup λ]; numerically the upper end can
    # still evaluate positive for extreme (mu, alpha) — e.g. online-estimated
    # posteriors with a huge mu*alpha product — so re-bracket by doubling
    for _ in range(64):
        if fhi <= 0.0 or not np.isfinite(hi):
            break
        hi *= 2.0
        fhi = f(hi)
    if fhi > 0.0 or not np.isfinite(hi):  # pragma: no cover - last resort
        return alpha
    return float(optimize.brentq(f, lo, hi, xtol=1e-15, rtol=1e-14, maxiter=200))


# --------------------------------------------------------------------------
# Eq. (13) beta and Eq. (12) tau*
# --------------------------------------------------------------------------
def beta_term(lam: float, mu: float, alpha: float, p: int) -> float:
    """One summand of Eq. (13):  (1/λ)(1 − (1/p) Σ_k e^{−μ(λp/k − α)})."""
    k = np.arange(1, p + 1, dtype=np.float64)
    expo = np.clip(-mu * (lam * p / k - alpha), -745.0, 50.0)
    return float((1.0 - np.exp(expo).sum() / p) / lam)


def beta(lams: np.ndarray, workers: list[ShiftedExp], ps: np.ndarray) -> float:
    """Eq. (13)."""
    return float(
        sum(beta_term(l, w.mu, w.alpha, int(p)) for l, w, p in zip(lams, workers, ps))
    )


def tau_star(r: int, lams: np.ndarray, workers: list[ShiftedExp], ps: np.ndarray) -> float:
    """Eq. (12): τ* = r / β."""
    return r / beta(lams, workers, ps)


# --------------------------------------------------------------------------
# Theorem 6 / Corollary 6.1 closed forms
# --------------------------------------------------------------------------
def _int_exp_inv(c: float) -> float:
    """∫₀¹ e^{−c/x} dx  =  e^{−c} − c·E₁(c)   (substitute v = c/x)."""
    if c <= 0:
        raise ValueError("c must be positive")
    return float(np.exp(-c) - c * special.exp1(c))


def tau_star_infimum(r: int, workers: list[ShiftedExp]) -> float:
    """Theorem 6 Eq. (18): inf τ* as every p_i → ∞."""
    workers = [as_shifted_exp(w) for w in workers]
    denom = sum(
        (1.0 - np.exp(min(w.mu * w.alpha, 700.0)) * _int_exp_inv(w.mu * w.alpha)) / w.alpha
        for w in workers
    )
    return r / denom


def tau_star_supremum(r: int, workers: list[ShiftedExp]) -> float:
    """Theorem 6 Eq. (19) with the missing ``r /`` restored: τ*(p=1) = r/β(p=1)."""
    workers = [as_shifted_exp(w) for w in workers]
    lams = np.array([lambda_supremum(w.mu, w.alpha) for w in workers])
    ps = np.ones(len(workers), dtype=np.int64)
    return tau_star(r, lams, workers, ps)


def load_infimum(r: int, workers: list[ShiftedExp]) -> np.ndarray:
    """Corollary 6.1 Eq. (20): ℓ̂_i = limit of ℓ_i* as all p_j → ∞."""
    workers = [as_shifted_exp(w) for w in workers]
    denom = sum(
        (1.0 - np.exp(min(w.mu * w.alpha, 700.0)) * _int_exp_inv(w.mu * w.alpha)) / w.alpha
        for w in workers
    )
    return np.array([r / (w.alpha * denom) for w in workers])


# --------------------------------------------------------------------------
# Allocation result container
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Allocation:
    """A concrete load allocation for one coded (or uncoded) task.

    loads[i]   - number of rows assigned to worker i (integer)
    batches[i] - number of batches p_i worker i streams its rows back in
    tau        - the scheme's predicted completion time (np.nan if N/A)
    scheme     - scheme name
    coded      - whether rows are coded (recovery from any r(1+eps) rows)
    """

    loads: np.ndarray
    batches: np.ndarray
    tau: float
    scheme: str
    coded: bool
    lams: np.ndarray = field(default_factory=lambda: np.array([]))

    def __post_init__(self):
        object.__setattr__(self, "loads", np.asarray(self.loads, dtype=np.int64))
        object.__setattr__(self, "batches", np.asarray(self.batches, dtype=np.int64))
        if (self.loads < 0).any():
            raise ValueError("negative load")
        if (self.batches < 1).any():
            raise ValueError("batches must be >= 1")

    @property
    def total_rows(self) -> int:
        return int(self.loads.sum())

    def batch_sizes(self) -> np.ndarray:
        """b_i = ceil(l_i / p_i) (paper: last batch may be smaller)."""
        return np.ceil(self.loads / np.maximum(self.batches, 1)).astype(np.int64)


# --------------------------------------------------------------------------
# Algorithm 1 (BPCC) and the three benchmark schemes
# --------------------------------------------------------------------------
def bpcc_allocation(
    r: int,
    workers: list[ShiftedExp],
    p: int | np.ndarray | None = None,
) -> Allocation:
    """Paper Algorithm 1.

    ``p`` may be a scalar (same batch count everywhere), a vector, or None —
    None selects the paper's §4.2.2 default p_i = ⌊ℓ̂_i⌋ (max useful batches,
    one row per batch in the limit), clamped to >= 1.

    The §3.2 constraint ℓ_i >= p_i is enforced by the repair loop: any p_i
    exceeding the resulting ⌊ℓ_i⌉ is reduced and the system re-solved.
    """
    n = len(workers)
    if n == 0:
        raise ValueError("need at least one worker")
    if r < 1:
        raise ValueError("r must be positive")
    # Weibull/Pareto (and any future service-time model) run Algorithm 1 on
    # their shifted-exponential surrogate — the paper's Eq. (7) system is
    # derived for that CDF only (see distributions.as_shifted_exp).
    workers = [as_shifted_exp(w) for w in workers]
    if p is None:
        # ⌊ℓ̂_i⌋ capped at r: one row per batch is already the finest useful
        # granularity, and ℓ̂ ~ 1/alpha explodes for near-zero shifts (e.g.
        # surrogate-converted heavy-tail models) — without the cap the
        # Eq. (7) solver would materialize arange(1, ℓ̂) for absurd ℓ̂
        ps = np.clip(np.floor(load_infimum(r, workers)), 1, max(r, 1)).astype(np.int64)
    else:
        ps = np.broadcast_to(np.asarray(p, dtype=np.int64), (n,)).copy()
        if (ps < 1).any():
            raise ValueError("p must be >= 1")

    for _repair in range(64):
        lams = np.array([solve_lambda(w.mu, w.alpha, int(pi)) for w, pi in zip(workers, ps)])
        b = beta(lams, workers, ps)
        tau = r / b
        loads_f = tau / lams  # Eq. (14): ℓ_i* = r/(β λ_i) = τ*/λ_i
        loads = np.rint(loads_f).astype(np.int64)  # the paper's ⌊⌉ rounding
        loads = np.maximum(loads, 1)
        bad = ps > loads
        if not bad.any():
            return Allocation(
                loads=loads, batches=ps, tau=float(tau), scheme="bpcc", coded=True, lams=lams
            )
        ps = np.where(bad, np.maximum(loads, 1), ps)
    raise RuntimeError("p-repair loop failed to converge")  # pragma: no cover


def infimum_allocation(r: int, workers: list[ShiftedExp]) -> Allocation:
    """BPCC at the p → ∞ operating point, entirely in closed form.

    Theorem 6 / Corollary 6.1 give τ* and ℓ̂_i without root-finding:
    loads = ⌊ℓ̂_i⌉, batches = the §4.2.2 default ⌊ℓ̂_i⌋ (clipped to [1, r]),
    tau = Eq. (18).  This is the limit Algorithm 1's own p_i = ⌊ℓ̂_i⌋
    default approaches; the adaptive simulator's known-rates oracle uses it
    for p = None cells so the oracle re-allocation per churn realization
    costs O(N) special functions instead of N brentq solves (DESIGN.md §9).
    """
    workers = [as_shifted_exp(w) for w in workers]
    lhat = load_infimum(r, workers)
    loads = np.maximum(np.rint(lhat).astype(np.int64), 1)
    ps = np.clip(np.floor(lhat), 1, max(r, 1)).astype(np.int64)
    ps = np.minimum(ps, loads)  # the §3.2 constraint l_i >= p_i
    return Allocation(
        loads=loads, batches=ps, tau=tau_star_infimum(r, workers),
        scheme="bpcc", coded=True,
    )


def hcmm_allocation(r: int, workers: list[ShiftedExp]) -> Allocation:
    """HCMM — BPCC restricted to p_i = 1 (whole-result return)."""
    alloc = bpcc_allocation(r, workers, p=1)
    return Allocation(
        loads=alloc.loads,
        batches=alloc.batches,
        tau=alloc.tau,
        scheme="hcmm",
        coded=True,
        lams=alloc.lams,
    )


def uniform_allocation(r: int, workers: list[ShiftedExp]) -> Allocation:
    """Uniform Uncoded: ℓ_i = r/N (remainder spread over the first workers)."""
    n = len(workers)
    base = r // n
    loads = np.full(n, base, dtype=np.int64)
    loads[: r - base * n] += 1
    return Allocation(
        loads=loads, batches=np.ones(n, np.int64), tau=np.nan, scheme="uniform", coded=False
    )


def load_balanced_allocation(r: int, workers: list[ShiftedExp]) -> Allocation:
    """Load-Balanced Uncoded: ℓ_i ∝ μ_i/(μ_iα_i + 1), Σ ℓ_i = r.

    The weight is 1/E[per-row time]: a row costs alpha + 1/mu in expectation,
    i.e. (mu alpha + 1)/mu.
    """
    n = len(workers)
    workers = [as_shifted_exp(w) for w in workers]
    w = np.array([wk.mu / (wk.mu * wk.alpha + 1.0) for wk in workers])
    raw = r * w / w.sum()
    loads = np.floor(raw).astype(np.int64)
    # distribute the remainder to the largest fractional parts
    deficit = r - int(loads.sum())
    order = np.argsort(-(raw - loads))
    loads[order[:deficit]] += 1
    return Allocation(
        loads=loads, batches=np.ones(n, np.int64), tau=np.nan, scheme="load_balanced", coded=False
    )


SCHEMES = {
    "uniform": uniform_allocation,
    "load_balanced": load_balanced_allocation,
    "hcmm": hcmm_allocation,
    "bpcc": bpcc_allocation,
}


@lru_cache(maxsize=1024)
def _allocate_cached(
    scheme: str, r: int, workers: tuple[ShiftedExp, ...], pkey
) -> Allocation:
    kw = {}
    if pkey is not None:
        kw["p"] = np.asarray(pkey, dtype=np.int64) if isinstance(pkey, tuple) else pkey
    return SCHEMES[scheme](r, list(workers), **kw)


def allocate(scheme: str, r: int, workers: list[ShiftedExp], **kw) -> Allocation:
    """Dispatch by scheme name ('uniform' | 'load_balanced' | 'hcmm' | 'bpcc').

    Memoized: allocations are deterministic in (scheme, r, workers, p), and
    the paper sweeps (benchmarks, Monte-Carlo figures) re-solve the same
    cells hundreds of times — Algorithm 1's root-finding dominated the
    vectorized simulator's wall-clock before caching.  ``Allocation`` is a
    frozen dataclass; treat the returned (shared) instance as read-only.
    """
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; options {sorted(SCHEMES)}")
    extra = {k: v for k, v in kw.items() if k != "p"}
    if extra:  # unknown kwargs: direct uncached call preserves error behavior
        return SCHEMES[scheme](r, workers, **kw)
    p = kw.get("p")
    if isinstance(p, np.ndarray):
        pkey = tuple(int(x) for x in p.ravel())
    elif p is None:
        pkey = None
    else:
        pkey = int(p)
    return _allocate_cached(scheme, int(r), tuple(workers), pkey)
