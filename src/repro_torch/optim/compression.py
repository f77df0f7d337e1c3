"""Gradient-message compression with error feedback.

Port of ``repro.optim.compression``.  Quantize the gradient message to int8
before the exchange and carry the quantization residual into the next step:
error feedback keeps the *accumulated* update unbiased, so convergence
matches fp32 aggregation asymptotically.  The coded train step
(``repro_torch.train.loop``) compresses each leaf's message buffer in
place with :func:`compress_leaf_`, the arithmetic that
:func:`compress_with_feedback` runs on a tree.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.quant import QTensor, dequantize, quantize
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["init_error_state", "compress_leaf_", "compress_with_feedback", "decompress"]


def init_error_state(grads_template: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_template)


def compress_leaf_(msg: torch.Tensor, err: torch.Tensor) -> tuple[QTensor, torch.Tensor]:
    """One leaf's exchange, in ``msg``'s own buffer (fp32): corrected =
    msg + err, sent = dequantize(quantize(corrected)), and ``msg`` becomes
    the residual corrected - sent.  Returns (the quantized message, sent)."""
    corrected = msg.add_(err)
    q = quantize(corrected)
    sent = dequantize(q)
    corrected.sub_(sent)
    return q, sent


def compress_with_feedback(grads: Any, err: Any) -> tuple[Any, Any]:
    """Returns (quantized message tree, new error state)."""
    msgs, residuals = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        r = g.to(torch.float32, copy=True)
        msgs.append(compress_leaf_(r, e)[0])
        residuals.append(r)
    return tree_unflatten(grads, msgs), tree_unflatten(grads, residuals)


def decompress(msgs: Any) -> Any:
    return tree_map(dequantize, msgs, is_leaf=lambda x: isinstance(x, QTensor))
