"""Shape-preserving int8 quantization (optimizer moments, gradient messages).

Port of ``repro.optim.quant``.  8-bit Adam moments cut optimizer state from
8 to about 2 bytes a parameter.  ``q`` keeps the source tensor's shape
(int8) and ``scale`` its leading dims with one fp32 scale per trailing row,
so both follow the parameter's layout.  ``pow=4`` companding stores
|x|^(1/4), covering about 8.5 decades with bounded relative error: plain
max-scaled int8 zeroes every element far below its row's max, which for
Adam's second moment collapses 1/sqrt(v) and the optimizer diverges.

``QTensor`` is a plain dataclass here (the reference registers a pytree
class); ``repro_torch.utils.tree`` treats it as a node whose children are
``q`` and ``scale``, in that order.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["QTensor", "quantize", "dequantize"]


@dataclass
class QTensor:
    q: torch.Tensor        # int8, same shape as the source tensor
    scale: torch.Tensor    # fp32 [..., 1] — the max |x| of each trailing row
    shape: tuple           # original shape
    pow: int = 1           # companding exponent


def _int_pow(x: torch.Tensor, k: int) -> torch.Tensor:
    """x ** k for an integer k >= 1 by repeated squaring, multiplying in the
    order ``lax.integer_pow`` does (so x ** 4 is (x * x) * (x * x))."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def quantize(x: torch.Tensor, pow: int = 1) -> QTensor:
    """Per-row scales (one fp32 scale per trailing vector, keepdims max).

    Rounding is half to even (``torch.round``, as ``jnp.round``) and the
    codes are clipped to ±127.
    """
    shape = tuple(x.shape)
    xf = x.to(torch.float32)
    if xf.dim() == 0:
        xf = xf[None]
    scale = torch.clamp_min(torch.amax(torch.abs(xf), dim=-1, keepdim=True), 1e-30)
    y = xf / scale
    if pow != 1:
        y = torch.sign(y) * torch.abs(y) ** (1.0 / pow)
    q = torch.clamp(torch.round(127.0 * y), -127, 127).to(torch.int8)
    if x.dim() == 0:
        q = q[0]
    return QTensor(q=q.reshape(shape), scale=scale, shape=shape, pow=pow)


def dequantize(t: QTensor) -> torch.Tensor:
    qf = t.q.to(torch.float32)
    if qf.dim() == 0:
        qf = qf[None]
    y = qf / 127.0
    if t.pow != 1:
        y = torch.sign(y) * _int_pow(torch.abs(y), t.pow)
    return (y * t.scale).reshape(t.shape)
