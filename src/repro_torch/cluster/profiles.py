"""Worker profiles: the paper's Table 1 EC2 estimates + scenario builders.

Table 1 (measured on Amazon EC2, §5.2) gives per-instance-type straggling
parameter mu and shift alpha for the shifted-exponential model in Eq. (21):

    Pr[T <= t] = 1 - exp(-(mu/r) (t - alpha r)),  t >= alpha r.

alpha is seconds-per-row of deterministic work; mu is the straggle rate of
the multiplicative exponential tail.

Copied from ``repro.cluster.profiles``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.
The tests hold the copy bit-equal to the reference on the same seeds.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.distributions import ShiftedExp, sample_heterogeneous_cluster

__all__ = [
    "WorkerProfile",
    "EC2_PROFILES",
    "ec2_scenario",
    "paper_sim_scenario",
    "churn_scenario",
    "late_join_scenario",
]


@dataclass(frozen=True)
class WorkerProfile:
    """A named worker with a latency model."""

    name: str
    model: ShiftedExp

    @property
    def mu(self) -> float:
        return self.model.mu

    @property
    def alpha(self) -> float:
        return self.model.alpha


# Paper Table 1 — estimated computing parameters of EC2 instance types.
EC2_PROFILES: dict[str, ShiftedExp] = {
    "r4.xlarge": ShiftedExp(mu=9.4257e4, alpha=1.7577e-4),
    "r4.2xlarge": ShiftedExp(mu=9.2554e4, alpha=1.6050e-4),
    "t2.medium": ShiftedExp(mu=2.1589e4, alpha=5.1863e-4),
    "t2.large": ShiftedExp(mu=3.9017e4, alpha=2.2527e-4),
}

# Paper §5.1 experiment scenarios: (r, [instance type x count, ...])
_EC2_SCENARIOS: dict[int, tuple[int, list[tuple[str, int]]]] = {
    1: (5_000, [("r4.2xlarge", 1), ("r4.xlarge", 2), ("t2.large", 2)]),
    2: (10_000, [("r4.2xlarge", 2), ("r4.xlarge", 4), ("t2.large", 4)]),
    3: (15_000, [("r4.2xlarge", 4), ("r4.xlarge", 6)]),
    4: (20_000, [("r4.2xlarge", 7), ("r4.xlarge", 8)]),
}


def ec2_scenario(idx: int) -> tuple[int, list[WorkerProfile]]:
    """Paper §5.1 Scenario ``idx`` -> (r, worker profiles)."""
    try:
        r, spec = _EC2_SCENARIOS[idx]
    except KeyError:
        raise ValueError(f"scenario must be 1..4, got {idx}") from None
    workers = []
    for kind, count in spec:
        for j in range(count):
            workers.append(WorkerProfile(name=f"{kind}-{j}", model=EC2_PROFILES[kind]))
    return r, workers


# Paper §4.1.2 simulation scenarios: (r, N); mu_i ~ U[1,50], alpha_i = 1/mu_i.
_SIM_SCENARIOS: dict[int, tuple[int, int]] = {
    1: (10_000, 10),
    2: (20_000, 10),
    3: (10_000, 20),
    4: (20_000, 20),
}


def paper_sim_scenario(idx: int, seed: int = 0) -> tuple[int, list[ShiftedExp]]:
    """Paper §4.1.2 Scenario ``idx`` -> (r, sampled heterogeneous workers)."""
    try:
        r, n = _SIM_SCENARIOS[idx]
    except KeyError:
        raise ValueError(f"scenario must be 1..4, got {idx}") from None
    return r, sample_heterogeneous_cluster(n, seed=seed)


# --------------------------------------------------------------------------
# Churn scenarios (DESIGN.md §8) — the §4.1.2 clusters + mid-task disturbances
# --------------------------------------------------------------------------
def churn_scenario(
    idx: int,
    *,
    drift_mag: float = 2.0,
    churn_rate: float = 0.3,
    death_prob: float = 0.0,
    seed: int = 0,
):
    """Paper §4.1.2 Scenario ``idx`` with mid-task churn:
    (r, workers, ChurnPolicy).  Feed the policy's ``sample(n, tau, seed)``
    to the executor/simulator as a per-task ``ChurnSchedule``."""
    from repro_torch.cluster.straggler import ChurnPolicy

    r, workers = paper_sim_scenario(idx, seed=seed)
    return r, workers, ChurnPolicy(
        drift_prob=churn_rate, drift_mag=drift_mag, death_prob=death_prob
    )


def late_join_scenario(idx: int, *, join_frac: float = 0.3, seed: int = 0):
    """Paper §4.1.2 Scenario ``idx`` where the LAST worker is absent from
    the initial allocation and joins at ``join_frac`` × the static tau*:
    (r, workers, initial Allocation over the others, ChurnSchedule with the
    join event).  Only the adaptive reallocation loop can use the joiner —
    the static assignment was fixed before it existed."""
    from repro_torch.core.adaptive import ChurnEvent, ChurnSchedule, padded_allocation
    from repro_torch.core.allocation import allocate

    r, workers = paper_sim_scenario(idx, seed=seed)
    sub = allocate("bpcc", r, workers[:-1])
    alloc = padded_allocation(sub, np.arange(len(workers) - 1), len(workers))
    churn = ChurnSchedule((
        ChurnEvent(t=join_frac * sub.tau, worker=len(workers) - 1, kind="join"),
    ))
    return r, workers, alloc, churn
