"""Coded gradient aggregation — straggler tolerance for data-parallel training.

Port of ``repro.core.gradient_coding``.  A data-parallel gradient step is a
linear aggregation, sum_j g_j over microbatch shards, so the paper's
redundancy idea applies to it (gradient coding, Tandon et al.):

  * **FRC (fractional repetition)** — workers in groups of (s+1); every
    worker of a group computes the same group-sum of shards.  Tolerates any
    s stragglers; decode = one survivor per group.  Requires (s+1) | n.
  * **CRC (cyclic repetition)** — worker i holds shards {i..i+s} (mod n)
    with coefficients drawn so that any n-s rows span the all-ones vector;
    decode solves a tiny least-squares problem for v with vᵀ(MB) = 1ᵀ.

``GradCode``, ``frc_code`` and ``cyclic_code`` are numpy, copied from the
reference (the tests hold them bit-equal).  The decode weights are tensors
on the mask's device with fixed shapes: the aggregation is
``sum_i v_i(mask) * msg_i``, and ``ok`` is a 0-dim bool tensor, never a
Python branch, so a step never waits on the host for it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.utils.prng import rng as _rng

__all__ = [
    "GradCode",
    "frc_code",
    "cyclic_code",
    "decode_weights",
    "decode_weights_checked",
]


@dataclass(frozen=True)
class GradCode:
    """Assignment + encoding for coded gradient aggregation.

    B [n_workers, n_shards] — worker i sends  msg_i = sum_j B[i,j] grad_j.
    Any mask with >= n_workers - s survivors admits v(mask) with
    vᵀ (M B) = 1ᵀ, so  sum_i v_i m_i msg_i = sum_j grad_j  exactly (FRC) or
    to LS precision (CRC).
    """

    b: np.ndarray          # [n, n_shards]
    s: int                 # straggler tolerance
    kind: str              # 'frc' | 'cyclic'

    @property
    def n_workers(self) -> int:
        return self.b.shape[0]

    @property
    def n_shards(self) -> int:
        return self.b.shape[1]

    def shards_of(self, worker: int) -> np.ndarray:
        return np.flatnonzero(self.b[worker])

    @property
    def replication(self) -> float:
        """Compute overhead: shards evaluated per worker (s+1 for both kinds)."""
        return float((self.b != 0).sum() / self.n_workers)


def frc_code(n_workers: int, s: int) -> GradCode:
    """Fractional repetition code: groups of (s+1) identical workers."""
    if n_workers % (s + 1) != 0:
        raise ValueError(f"(s+1)={s + 1} must divide n_workers={n_workers}")
    n_groups = n_workers // (s + 1)
    b = np.zeros((n_workers, n_workers), dtype=np.float64)
    for g in range(n_groups):
        shard_block = slice(g * (s + 1), (g + 1) * (s + 1))
        for w in range(g * (s + 1), (g + 1) * (s + 1)):
            b[w, shard_block] = 1.0
    return GradCode(b=b, s=s, kind="frc")


def cyclic_code(n_workers: int, s: int, seed: int = 0) -> GradCode:
    """Cyclic repetition, Tandon et al. Algorithm-2 construction.

    Draw H [s, n] with columns summing to zero (so H·1 = 0, i.e. the all-ones
    vector lies in null(H)); build each row of B inside null(H) with support
    {i..i+s} mod n.  Any (n−s) rows of B then span null(H) ∋ 1 — the *span
    condition* that makes exact decode possible for every ≤ s-straggler
    pattern.  (Random coefficients on the support do NOT satisfy this.)
    """
    n = n_workers
    if s == 0:
        # degenerate no-redundancy code: B = I (worker i sends grad_i)
        return GradCode(b=np.eye(n, dtype=np.float64), s=0, kind="cyclic")
    for attempt in range(64):  # resample H if an unlucky draw gives huge coeffs
        g = _rng(seed + 1000003 * attempt)
        h = g.standard_normal((s, n))
        h[:, -1] = -h[:, :-1].sum(axis=1)  # columns sum to 0  ->  H 1 = 0
        b = np.zeros((n, n), dtype=np.float64)
        ok = True
        for i in range(n):
            cols = (i + np.arange(s + 1)) % n
            sub = h[:, cols[1:]]
            if np.linalg.cond(sub) > 1e4:
                ok = False
                break
            b[i, cols[0]] = 1.0
            # remaining s coefficients solve  H[:, cols] · B[i, cols]ᵀ = 0
            b[i, cols[1:]] = np.linalg.solve(sub, -h[:, cols[0]])
        if ok and np.abs(b).max() < 50.0:
            return GradCode(b=b, s=s, kind="cyclic")
    raise RuntimeError("could not draw a well-conditioned cyclic code")  # pragma: no cover


def decode_weights(code: GradCode, mask: torch.Tensor) -> torch.Tensor:
    """v(mask) with vᵀ (M B) = 1ᵀ — the recombination weights.

    Unchecked variant: with > s stragglers the returned weights are garbage
    (FRC: zero selector for a dead group; CRC: LS on a rank-deficient
    generator).  Callers that feed live masks must use
    :func:`decode_weights_checked` and act on the ``ok`` flag.
    """
    v, _ = decode_weights_checked(code, mask)
    return v


def decode_weights_checked(
    code: GradCode, mask: torch.Tensor, *, tol: float = 1e-3
) -> tuple[torch.Tensor, torch.Tensor]:
    """(v, ok) — recombination weights [n] fp32 and a 0-dim bool tensor, on
    the mask's device.

    FRC: exact closed form — first survivor of each group gets weight 1;
    ``ok`` iff every (s+1)-group has at least one survivor.
    CRC: pseudo-inverse (SVD, ``rtol`` 1e-6) of the (n x n) masked
    generator + two refinement steps; ``ok`` iff at least n-s messages
    survive (the span condition guarantees decode) AND the LS residual
    ||A v - 1||_inf stays under ``tol`` (guards numerical rank loss).
    """
    m = torch.as_tensor(mask).to(torch.float32)
    if code.kind == "frc":
        n, s1 = code.n_workers, code.s + 1
        groups = m.reshape(n // s1, s1)
        # weight 1 for the first alive worker in each group, 0 elsewhere
        first = torch.cumsum(groups, dim=1) * groups  # 1 at first alive, >1 after
        sel = (first == 1.0).to(torch.float32)
        ok = torch.all(groups.sum(dim=1) >= 1.0)
        return sel.reshape(n), ok
    b = torch.as_tensor(code.b, dtype=torch.float32, device=m.device)
    a = (b * m[:, None]).T                   # [n_shards, n]:  A v = 1
    pinv = torch.linalg.pinv(a, rtol=1e-6)   # SVD — avoids cond² of normal eqs
    ones = torch.ones(code.n_shards, dtype=torch.float32, device=m.device)
    v = pinv @ ones
    for _ in range(2):                       # refinement against A itself
        v = v + pinv @ (ones - a @ v)
    enough = m.sum() >= code.n_workers - code.s
    resid_ok = torch.max(torch.abs(a @ v - ones)) < tol
    return v * m, torch.logical_and(enough, resid_ok)
