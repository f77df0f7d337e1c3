"""Runtime services of the port (``repro.runtime``): the straggler
``HealthMonitor``, checkpoints and elastic re-gridding."""
from repro_torch.runtime.checkpoint import (  # noqa: F401
    gc_checkpoints,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    wait_for_saves,
)
from repro_torch.runtime.health import HealthMonitor  # noqa: F401
from repro_torch.runtime.elastic import (  # noqa: F401
    plan_mesh_shape,
    shrink_mesh,
)
