"""The production mesh, as a unit of reckoning.

Port of ``repro.launch.mesh``.  The reference's mesh is a TPU v5e pod:
16 x 16 = 256 chips, two pods for 512, with axes 'pod' (the slow link
between pods), 'data' (DP and FSDP) and 'model' (TP and EP).  The port
runs on one H100, so :func:`make_production_mesh` returns a *logical*
mesh that holds no devices: its axis sizes are what the sharding policy
(``repro_torch.sharding.policy``) divides shapes by, and what the dry run
(``repro_torch.launch.dryrun``) divides a step's bytes and FLOPs by.  It
names no hardware of the port's own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

__all__ = ["LogicalMesh", "make_production_mesh", "make_mesh", "dp_axes", "model_axis_size"]


@dataclass(frozen=True)
class LogicalMesh:
    """Named axes and their sizes, in order; no devices.  ``shape`` is a
    mapping, as a ``jax.sharding.Mesh``'s is."""

    shape: dict = field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "shape", dict(self.shape))
        if any(int(n) < 1 for n in self.shape.values()):
            raise ValueError(f"mesh axes must have positive sizes: {self.shape}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> LogicalMesh:
    """A logical mesh of the given axis sizes and names."""
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} sizes for {len(axes)} axes")
    return LogicalMesh(dict(zip(axes, shape)))


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The reference's production mesh as a logical mesh: ``{"data": 16,
    "model": 16}`` (256 chips), or ``{"pod": 2, "data": 16, "model": 16}``
    (512) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)
