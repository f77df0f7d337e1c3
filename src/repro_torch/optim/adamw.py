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

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "global_norm"]


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


def adamw_update(
    params: Any, grads: Any, state: dict, cfg: AdamWConfig
) -> tuple[Any, dict, dict]:
    """One AdamW step; returns (new_params, new_state, metrics).  Nothing
    is updated in place: the inputs stay valid."""
    step = state["step"] + 1
    lr = cfg.lr_at(step)
    gn = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gn, 1e-12), 1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        mf = dequantize(m) if _is_q(m) else m.to(torch.float32)
        vf = dequantize(v) if _is_q(v) else v.to(torch.float32)
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
        delta = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        if _is_q(m):
            return new_p, quantize(mf, pow=4), quantize(vf, pow=4)
        return new_p, mf.to(m.dtype), vf.to(v.dtype)

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads),
        tree_leaves(state["m"], _is_q), tree_leaves(state["v"], _is_q))]
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    new_state = {"m": new_m, "v": new_v, "step": step}
    return new_params, new_state, {"grad_norm": gn, "lr": lr}
