"""Runtime services of the port: the straggler ``HealthMonitor``.
Checkpointing and elastic recovery are not ported yet."""
from repro_torch.runtime.health import HealthMonitor  # noqa: F401
