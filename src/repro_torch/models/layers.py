"""Shared layer primitives: plain functions over dicts of tensors.

A layer is ``init_*(generator, ...) -> params`` plus
``apply(params, x, ...) -> y``.  Block params carry a leading layer axis
(the reference's stacked ``[n_layers, ...]`` layout).  Port of
``repro.models.layers``; the rounding points follow the reference: norms and
RoPE in fp32 cast back, weights cast to the activation dtype at use.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]

_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Phi(-2)
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))   # Phi(2)


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
def truncated_normal(shape, std: float, dtype, generator: torch.Generator,
                     device) -> torch.Tensor:
    """Normal(0, std) truncated to [-2 std, 2 std], drawn in fp32 by inverse
    CDF from ``generator`` (torch cannot reproduce jax.random's bits; tests
    carry the reference's params over instead).  On the ``meta`` device it
    draws nothing and takes no generator: a tensor of the shape and dtype
    alone (``Model.param_shapes``)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(2.0 * _LO - 1.0, 2.0 * _HI - 1.0, generator=generator)
    t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
    return t.to(dtype)


def dense_init(shape, dtype, generator, device, fan_in=None) -> torch.Tensor:
    """Truncated-normal init scaled by 1/sqrt(fan_in) (fan_in = shape[-2])."""
    fan = fan_in if fan_in is not None else shape[-2]
    return truncated_normal(shape, 1.0 / math.sqrt(max(fan, 1)), dtype, generator, device)


def embed_init(shape, dtype, generator, device) -> torch.Tensor:
    return truncated_normal(shape, 1.0, dtype, generator, device)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x.dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2] (fp32)."""
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rotation's (cos, sin) [..., S, head_dim // 2] fp32 at ``positions``
    [..., S]: computed once, they serve every layer that ropes at those
    positions (``apply_rope_table``)."""
    inv = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions[..., None].to(torch.float32) * inv  # [..., S, hd/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope_table(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, Hd] rotated by a ``rope_table`` (pairwise halves), fp32 math."""
    cos, sin = cos[..., None, :], sin[..., None, :]     # broadcast over heads
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, Hd], positions [..., S] -> rotated x (pairwise halves), fp32 math."""
    return apply_rope_table(x, *rope_table(positions, x.shape[-1], theta))


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------
def init_mlp(generator, d_model: int, d_ff: int, kind: str, dtype, device,
             lead: tuple[int, ...] = ()) -> Params:
    def w(shape):
        return dense_init(lead + shape, dtype, generator, device)

    if kind == "swiglu":
        return {"w_gate": w((d_model, d_ff)), "w_up": w((d_model, d_ff)),
                "w_down": w((d_ff, d_model))}
    return {"w_up": w((d_model, d_ff)), "w_down": w((d_ff, d_model))}


def mlp_apply(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x [..., D] -> [..., D].  swiglu | relu2 (squared ReLU) | gelu (tanh form)."""
    dt = x.dtype
    if kind == "swiglu":
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        h = g * torch.sigmoid(g) * u
    elif kind == "relu2":
        h = torch.square(torch.relu(x @ p["w_up"].to(dt)))
    elif kind == "gelu":
        h = F.gelu(x @ p["w_up"].to(dt), approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return h @ p["w_down"].to(dt)
