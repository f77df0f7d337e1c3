"""Seeded weights in the port's parameter tree, made on the device.

The tree's layout and served dtypes are the port's (``Model.param_shapes``
cast as ``Model.prepare`` casts): layer matmul weights in the activation
dtype, everything else as the configuration's ``param_dtype``.  Every leaf
of one dtype is a view into one flat buffer, filled from one
``torch.Generator`` on the device by one ``normal_`` call, clamped to
two standard deviations (a truncated normal, as the port's own init) and
scaled per leaf by 1 / sqrt(fan-in); the projections that write into the
residual stream (``w_o``, ``w_down``, ``out_proj``) also by
1 / sqrt(2 n_layers), GPT-2's init for deep residual networks.  Without
that scale a random zamba2-1.2b amplifies a perturbation of its input
some forty-fold over its 38 blocks (a bf16 rounding of the embedding,
0.2 %, moves the last hidden state by 8.8 % in fp32), and no bf16
program could be held to an fp32 reference.  Norms start at one and the
Mamba per-head parameters take the port's init.  The coded head is derived from
the plain LM head by ``repro_torch.core.coded_ops.encode_blocks``, the call
``Model.init`` makes.  The reference reads the same tensors.
"""
from __future__ import annotations

import math

import torch


RESIDUAL_OUT = ("w_o", "w_down", "out_proj")


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def _fan_in(name: str, shape: tuple[int, ...], cfg) -> int:
    if name in ("w_q", "w_k", "w_v"):
        return shape[-3]
    if name == "w_o":
        return shape[-3] * shape[-2]
    if name == "conv_w":
        return cfg.conv_width
    return shape[-2]


def _per_head(name: str, shape, cfg, device) -> torch.Tensor | None:
    """The port's init of the Mamba per-head parameters and of the norms."""
    f32 = dict(dtype=torch.float32, device=device)
    if name == "a_log":
        h = shape[-1]
        return torch.log(torch.linspace(1.0, 16.0, h, **f32)).expand(shape).clone()
    if name == "dt_bias":
        return torch.zeros(shape, **f32)
    if name in ("d_skip", "gate_norm", "final_norm") or name.startswith(("ln", "norm")):
        return torch.ones(shape, **f32)
    return None


def make(model, seed: int, device) -> dict:
    """The served params of ``model`` (a ``repro_torch`` Model) from
    ``seed``: a dict in the port's layout, ``lm_head_coded`` included when
    the config is coded."""
    from repro_torch.core.coded_ops import encode_blocks
    from repro_torch.models.config import coded_blocks

    cfg = model.cfg
    shapes = model.prepare(model.param_shapes())
    shapes.pop("lm_head_coded", None)
    params = _copy_tree(shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    random_leaves: dict[torch.dtype, list] = {}
    for path, meta in _walk(shapes):
        fixed = _per_head(str(path[-1]), tuple(meta.shape), cfg, device)
        if fixed is not None:
            _set(params, path, fixed.to(meta.dtype))
        else:
            random_leaves.setdefault(meta.dtype, []).append((path, meta))
    for dtype, leaves in random_leaves.items():
        flat = torch.empty(sum(m.numel() for _, m in leaves), dtype=dtype, device=device)
        flat.normal_(generator=gen).clamp_(-2.0, 2.0)
        at = 0
        for path, meta in leaves:
            n = meta.numel()
            leaf = flat[at:at + n].view(meta.shape)
            at += n
            name = str(path[-1])
            if name != "embed":
                scale = 1.0 / math.sqrt(max(_fan_in(name, tuple(meta.shape), cfg), 1))
                if name in RESIDUAL_OUT:
                    scale /= math.sqrt(2 * cfg.n_layers)
                leaf.mul_(scale)
            _set(params, path, leaf)
    if cfg.coded:
        head = params["lm_head"] if "lm_head" in params else params["embed"].T
        nb = coded_blocks(cfg)
        params["lm_head_coded"] = encode_blocks(
            head.T.to(torch.float32), nb - cfg.coded_parity, cfg.coded_parity
        ).to(getattr(torch, cfg.param_dtype))
    return params
