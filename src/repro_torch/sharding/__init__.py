"""Device placement (port of ``repro.sharding``): the sharding policy's
specs on a logical mesh, and the coded serving head's mesh, one code block
per device."""
from repro_torch.sharding.policy import (  # noqa: F401
    HeadMesh,
    ShardingPolicy,
    make_policy,
    param_specs,
    serve_head_mesh,
    shard_coded_head,
    validate_coded_head_mesh,
)
