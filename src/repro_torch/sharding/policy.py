"""The coded serving head's mesh: one code block per device.

Port of the coded-head part of ``repro.sharding.policy`` (the TPU mesh
policies are not ported).  The reference runs the sharded head as one
program over a 1-D ``jax.sharding.Mesh``; here a single controller holds
the mesh as an explicit tuple of ``torch.device``s, one per code block.
A device may be named more than once: sixteen logical devices on one card
(``(cuda:0,) * 16``) are the counterpart of the reference's tests, which
force sixteen host devices onto one CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["HeadMesh", "serve_head_mesh", "shard_coded_head", "validate_coded_head_mesh"]


def _present(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index resolved; raises
    ValueError for a card this machine does not have."""
    d = torch.device(device)
    if d.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = d.index if d.index is not None else (torch.cuda.current_device() if n else 0)
        if index >= n:
            raise ValueError(f"HeadMesh names {d}, but this machine has {n} CUDA device(s)")
        d = torch.device("cuda", index)
    return d


@dataclass(frozen=True)
class HeadMesh:
    """A 1-D head mesh: ``devices[i]`` holds code block i.  The counterpart
    of a 1-D ``Mesh`` with one axis named ``axis``."""

    devices: tuple[torch.device, ...]
    axis: str = "model"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a HeadMesh needs at least one device")
        object.__setattr__(self, "devices", tuple(_present(d) for d in self.devices))


def serve_head_mesh(n_blocks: int, axis: str = "model") -> HeadMesh:
    """A head mesh with one card per coded head block: the first
    ``n_blocks`` CUDA devices.  Raises with fewer, as the reference does;
    name a device repeatedly in a ``HeadMesh`` to put several blocks on one
    card."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < n_blocks:
        raise ValueError(
            f"serve_head_mesh needs {n_blocks} devices (one per code block), have {n}")
    return HeadMesh(tuple(torch.device("cuda", i) for i in range(n_blocks)), axis)


def validate_coded_head_mesh(mesh: HeadMesh, n_blocks: int, axis: str = "model") -> None:
    """Raise ValueError unless ``mesh`` has axis ``axis`` with exactly one
    device per code block."""
    if axis != mesh.axis:
        raise ValueError(f"mesh has no {axis!r} axis (axes: {(mesh.axis,)})")
    size = len(mesh.devices)
    if size != n_blocks:
        raise ValueError(
            f"coded head has {n_blocks} blocks but mesh axis {axis!r} has "
            f"{size} devices; the sharded head wants exactly one block per "
            f"device (erasure = dropping a device's output)"
        )


def shard_coded_head(w_coded: torch.Tensor, mesh: HeadMesh) -> tuple[torch.Tensor, ...]:
    """Place the coded head [n_blocks*br, in] on the mesh: block i on
    ``mesh.devices[i]``.  The counterpart of ``coded_head_sharding`` and the
    ``device_put`` after it.  A block whose device is the weight's own is a
    view, not a copy, so on one card the placement adds no memory."""
    n_blocks = len(mesh.devices)
    if w_coded.dim() != 2 or w_coded.shape[0] % n_blocks:
        raise ValueError(
            f"coded head {tuple(w_coded.shape)} does not split into {n_blocks} row blocks")
    return tuple(blk if dev == blk.device else blk.to(dev)
                 for blk, dev in zip(w_coded.chunk(n_blocks), mesh.devices))
