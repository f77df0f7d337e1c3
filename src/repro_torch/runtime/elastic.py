"""Elastic re-gridding: shrink the logical (data, model) grid after a death.

Port of ``repro.runtime.elastic`` for one card.  The reference meshes real
devices; here the grid holds logical device ids, all on one CUDA device (the
same logical-device idea as ``repro_torch.sharding.HeadMesh``).  The
node-failure protocol of the train launcher:

  1. failure detected (unrecoverable coded steps) -> drop the dead ids,
  2. ``plan_mesh_shape`` picks the largest (data, model) grid that fits the
     survivors while keeping the model (TP) axis intact,
  3. the last checkpoint is restored (``runtime.checkpoint``) and the data
     pipeline keeps its global batch over fewer DP slices.

The reference's ``reshard`` (device_put onto a new mesh) has nothing to
move on one card and is left out.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["LogicalMesh", "plan_mesh_shape", "make_mesh_from_devices", "shrink_mesh"]


@dataclass(frozen=True)
class LogicalMesh:
    """A grid of logical device ids: the counterpart of a jax ``Mesh``
    (``devices`` an id array of the grid's shape, ``shape`` by axis name)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def plan_mesh_shape(n_devices: int, model: int = 16, pod: int | None = None):
    """Largest (data, model) (or (pod, data, model)) grid fitting n_devices.

    TP width is preserved; leftover devices idle (a real deployment drains
    them).  Returns (shape tuple, axis names tuple)."""
    if n_devices < model:
        # degrade TP last — halve until it fits (weights must still fit HBM;
        # the caller should re-check memory_analysis after a TP shrink)
        while model > 1 and n_devices < model:
            model //= 2
    if pod:
        data = n_devices // (model * pod)
        if data < 1:
            raise ValueError("not enough devices for the requested pod count")
        return (pod, data, model), ("pod", "data", "model")
    data = n_devices // model
    if data < 1:
        raise ValueError("not enough devices")
    return (data, model), ("data", "model")


def make_mesh_from_devices(devices, shape, axes) -> LogicalMesh:
    n = int(np.prod(shape))
    dev = np.asarray(list(devices)[:n]).reshape(shape)
    return LogicalMesh(dev, tuple(axes))


def shrink_mesh(mesh: LogicalMesh, dead: set[int]) -> LogicalMesh:
    """New grid from the survivors of ``mesh`` (drops whole DP slices)."""
    alive = [int(d) for d in mesh.devices.flat if int(d) not in dead]
    model = mesh.shape.get("model", 1)
    pod = mesh.shape.get("pod", None)
    shape, axes = plan_mesh_shape(len(alive), model=model, pod=None if pod is None else pod)
    return make_mesh_from_devices(alive, shape, axes)
