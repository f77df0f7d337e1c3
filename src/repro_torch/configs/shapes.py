"""Assigned input shapes (one set, shared by all 10 LM archs).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV /
recurrent cache of length ``seq``), NOT ``train_step``.  ``long_500k``
requires a sub-quadratic decode path and therefore only runs for the
SSM/hybrid archs (skip recorded per-arch in DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

__all__ = ["Workload", "SHAPES", "applicable", "cells"]


@dataclass(frozen=True)
class Workload:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, Workload] = {
    "train_4k": Workload("train_4k", "train", 4_096, 256),
    "prefill_32k": Workload("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Workload("decode_32k", "decode", 32_768, 128),
    "long_500k": Workload("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-not)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, (
            "pure full-attention arch: 524k-token decode needs a sub-quadratic "
            "path (SSM/hybrid only); skipped per assignment"
        )
    return True, ""


def cells(cfg: ModelConfig) -> list[Workload]:
    """All runnable (arch x shape) cells for one arch."""
    return [w for n, w in SHAPES.items() if applicable(cfg, n)[0]]
