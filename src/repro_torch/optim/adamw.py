"""AdamW with optional int8 moments.

Port of ``repro.optim.adamw``, written out rather than ``torch.optim.AdamW``
because the reference's step differs from it: the gradient is clipped by
its global norm inside the step, weight decay (decoupled) applies only to
leaves with ``ndim >= 2``, the moments may be fp32, bf16 or int8
(``QTensor``, companded with ``pow=4`` and requantized every step), and the
step returns ``grad_norm`` and ``lr`` as metrics.  State is a dict of
trees mirroring the params: ``m``, ``v`` and an int32 ``step``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.optim.quant import QTensor, dequantize, quantize
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "global_norm", "SLICE_ELEMENTS"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # float32 | bfloat16 | int8

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), self.lr, dtype=torch.float32, device=step.device)


def _is_q(x) -> bool:
    return isinstance(x, QTensor)


def _zeros_moment(p: torch.Tensor, kind: str):
    if kind == "int8":
        return quantize(torch.zeros(p.shape, dtype=torch.float32, device=p.device), pow=4)
    return torch.zeros(p.shape, dtype=getattr(torch, kind), device=p.device)


def init_opt_state(params: Any, cfg: AdamWConfig) -> dict:
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(lambda p: _zeros_moment(p, cfg.moment_dtype), params),
        "v": tree_map(lambda p: _zeros_moment(p, cfg.moment_dtype), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


# a leaf with more elements than this is updated in slices of whole trailing
# rows (about 256 MB of fp32 a slice): an int8 moment keeps one scale a row,
# so a slice's result has the whole leaf's bits, and the update's fp32
# temporaries stay the size of a slice
SLICE_ELEMENTS = 1 << 26


def _rows(x, lo: int, hi: int):
    """Trailing rows [lo, hi) of a leaf viewed as [rows, last] (a QTensor:
    its codes' rows and their scales)."""
    if _is_q(x):
        last = x.q.shape[-1]
        return QTensor(q=x.q.reshape(-1, last)[lo:hi], scale=x.scale.reshape(-1, 1)[lo:hi],
                       shape=(hi - lo, last), pow=x.pow)
    return x.reshape(-1, x.shape[-1])[lo:hi]


def _empty_like(x):
    if _is_q(x):
        return QTensor(q=torch.empty_like(x.q), scale=torch.empty_like(x.scale), shape=x.shape,
                       pow=x.pow)
    return torch.empty_like(x)


def _write_rows(dst, src, lo: int, hi: int) -> None:
    if _is_q(dst):
        _rows(dst, lo, hi).q.copy_(src.q)
        _rows(dst, lo, hi).scale.copy_(src.scale)
    else:
        _rows(dst, lo, hi).copy_(src)


def adamw_update(
    params: Any, grads: Any, state: dict, cfg: AdamWConfig
) -> tuple[Any, dict, dict]:
    """One AdamW step; returns (new_params, new_state, metrics).  Nothing
    is updated in place: ``params`` and ``state`` stay valid.

    ``grads`` is a tree like ``params``, or a list of its leaves in leaf
    order.  A list is consumed: each entry is set to None as soon as its
    leaf's update is made, so the gradient's memory is given back while the
    new state's is taken (the caller keeps no other reference to it).  The
    global norm is taken over every gradient first.  A leaf of more than
    ``SLICE_ELEMENTS`` elements (and at least two dims) is updated in
    slices of whole trailing rows, with the bits of the whole-leaf update."""
    g_leaves = grads if isinstance(grads, list) else tree_leaves(grads)
    step = state["step"] + 1
    lr = cfg.lr_at(step)
    gn = global_norm(g_leaves)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gn, 1e-12), 1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v, decay: bool):
        g = g.to(torch.float32) * clip
        mf = dequantize(m) if _is_q(m) else m.to(torch.float32)
        vf = dequantize(v) if _is_q(v) else v.to(torch.float32)
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
        delta = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        if decay:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        if _is_q(m):
            return new_p, quantize(mf, pow=4), quantize(vf, pow=4)
        return new_p, mf.to(m.dtype), vf.to(v.dtype)

    def upd_leaf(p, g, m, v):
        decay = p.dim() >= 2
        if p.numel() <= SLICE_ELEMENTS or p.dim() < 2:
            return upd(p, g, m, v, decay)
        out = (torch.empty_like(p), _empty_like(m), _empty_like(v))
        n_rows = p.numel() // p.shape[-1]
        step_rows = max(1, SLICE_ELEMENTS // p.shape[-1])
        for lo in range(0, n_rows, step_rows):
            hi = min(lo + step_rows, n_rows)
            part = upd(*(_rows(x, lo, hi) for x in (p, g, m, v)), decay)
            for dst, src in zip(out, part):
                _write_rows(dst, src, lo, hi)
        return out

    out = []
    for i, (p, m, v) in enumerate(zip(tree_leaves(params), tree_leaves(state["m"], _is_q),
                                      tree_leaves(state["v"], _is_q))):
        out.append(upd_leaf(p, g_leaves[i], m, v))
        if g_leaves is grads:
            grads[i] = None
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    new_state = {"m": new_m, "v": new_v, "step": step}
    return new_params, new_state, {"grad_norm": gn, "lr": lr}
