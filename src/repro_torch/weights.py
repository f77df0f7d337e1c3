"""Carry a parameter tree, or a whole train state, from numpy into the port and back.

The JAX reference initialises with ``jax.random``, whose bits torch cannot
reproduce; the differential tests therefore convert the reference's param
pytree leaf by leaf (``np.asarray`` on each) and hand it to the port, so
both packages compute the same function.  ``train_state_from_numpy`` does
the same for a train state (params, AdamW moments — int8 ``QTensor``s
included —, ``step`` and the compression residual ``err``), and
``train_state_to_numpy`` is its inverse.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.optim.quant import QTensor

__all__ = ["params_from_numpy", "train_state_from_numpy", "train_state_to_numpy"]


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


def _is_qtensor(x) -> bool:
    """A quantized moment of either package (duck-typed: the reference's
    QTensor is a jax pytree class this module never imports)."""
    return all(hasattr(x, a) for a in ("q", "scale", "shape", "pow"))


def train_state_from_numpy(tree: Any, device) -> Any:
    """A train state {"params", "opt": {"m", "v", "step"}[, "err"]} whose
    leaves are arrays (numpy or anything ``np.asarray`` takes) -> the same
    dicts and lists of tensors on ``device``; quantized moments become the
    port's ``QTensor`` with the same shape and companding exponent."""
    if isinstance(tree, dict):
        return {k: train_state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [train_state_from_numpy(v, device) for v in tree]
    if _is_qtensor(tree):
        return QTensor(q=_leaf(tree.q, device), scale=_leaf(tree.scale, device),
                       shape=tuple(tree.shape), pow=int(tree.pow))
    return _leaf(tree, device)


def train_state_to_numpy(tree: Any) -> Any:
    """The inverse: tensors -> numpy arrays, a ``QTensor`` -> a ``QTensor``
    of numpy arrays.  bf16 tensors come back as float32 (exact: numpy has
    no bf16 without ``ml_dtypes``); cast them on the receiving side."""
    if isinstance(tree, dict):
        return {k: train_state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [train_state_to_numpy(v) for v in tree]
    if isinstance(tree, QTensor):
        return QTensor(q=train_state_to_numpy(tree.q), scale=train_state_to_numpy(tree.scale),
                       shape=tree.shape, pow=tree.pow)
    t = tree.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy().copy()
