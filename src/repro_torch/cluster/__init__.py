"""Heterogeneous-cluster executor — the paper's EC2/MPI experiments, locally.

A master/worker executor that performs the *real* computation (numpy/JAX
matvec on real data, real LT encode + peeling decode) behind a backend seam
(DESIGN.md §15): the model-time thread emulator injects per-worker shifted
exponential latency (paper Eq. 3 / Table 1) plus optional unexpected
stragglers (paper §5.3.1: 3x observed delay with probability 0.2) and is
deterministic in the seed; the wall-clock process/thread backends run the
same task algebra over real OS processes and report true wall seconds.

Copied from ``repro.cluster``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.
The tests hold the copy bit-equal to the reference on the same seeds.
"""
from repro_torch.cluster.profiles import (  # noqa: F401
    EC2_PROFILES,
    WorkerProfile,
    ec2_scenario,
    paper_sim_scenario,
)
from repro_torch.cluster.straggler import ChurnPolicy, StragglerPolicy  # noqa: F401
from repro_torch.cluster.api import TaskResult, TaskSpec  # noqa: F401
from repro_torch.cluster.backend import (  # noqa: F401
    BACKENDS,
    ExecBackend,
    ModelTimeBackend,
    ProcessBackend,
    get_backend,
)
from repro_torch.cluster.executor import ClusterEmulator  # noqa: F401
