"""repro_torch — the BPCC coded-serving system in PyTorch, for one NVIDIA H100.

A second package beside the JAX reference ``repro``; its module tree mirrors
``repro`` (``repro/X/y.py`` has its counterpart at ``repro_torch/X/y.py``).
It never imports ``jax`` or ``repro``.

Importing the package pins float32 matmuls to full float32, as XLA computes
them: no TF32 in cuBLAS or cuDNN, and bf16 GEMMs reduce in float32.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__all__ = ["default_device"]


def default_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the one named, else ``cuda``.

    Raises when no device was named and CUDA is absent — nothing silently
    moves to the CPU; tests pass ``device="cpu"``.  A CUDA device without an
    index resolves to the current one (``cuda`` -> ``cuda:0``), so devices
    compare equal to those of the tensors made on them.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
