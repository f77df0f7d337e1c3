"""Carry a parameter tree from numpy into the port.

The JAX reference initialises with ``jax.random``, whose bits torch cannot
reproduce; the differential tests therefore convert the reference's param
pytree leaf by leaf (``np.asarray`` on each) and hand it to the port, so
both packages compute the same function.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["params_from_numpy"]


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no numpy-native torch route
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_numpy(tree: Any, device) -> Any:
    """Nested dicts and lists of arrays -> the same dicts and lists of
    tensors on ``device`` (dtypes kept)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    return _leaf(tree, device)
