"""Device placement (port of ``repro.sharding``): the coded serving head's
mesh, one code block per device."""
from repro_torch.sharding.policy import (  # noqa: F401
    HeadMesh,
    serve_head_mesh,
    shard_coded_head,
    validate_coded_head_mesh,
)
