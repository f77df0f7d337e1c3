"""Train step builder: remat, microbatch accumulation, (coded) gradient
aggregation, AdamW.

Port of ``repro.train.loop``.  The step is a plain function of (state,
batch, mask) on the params' device; nothing in it waits on the host.

  * plain mode — one backward per microbatch, gradients ``g / m``
    accumulated in fp32;
  * gradient-coding mode — the per-microbatch gradients are combined into
    ``n_workers`` redundant messages ``msg_i = sum_j B[i,j] g_j`` (FRC/CRC,
    ``repro_torch.core.gradient_coding``); a straggler mask drops messages
    and the decode weights recover the gradient sum.  This is the paper's
    coded-computation idea on the training path.

A batch holds tokens and labels [B, S], and for the vlm and encdec families
``img_embed`` [B, n_img, D] or ``frames`` [B, S_src, D]: every entry goes
to the params' device and is split into microbatches along B.  The
gradients reach AdamW as a list of leaves, which the update releases leaf
by leaf (``optim.adamw.adamw_update``).

Unrecoverable masks (> s stragglers, or a whole FRC group dead) set
``metrics["ok"] = 0`` and the step is an identity on params and the whole
optimizer state, ``step`` included: ``torch.where`` on the 0-dim ``ok``
selects the old bits.  With ``TrainConfig.compression`` the coded messages
are int8-quantized with error feedback (``optim.compression``); the
residual rides in ``state["err"]`` and is carried forward whether or not
the step was skipped (residuals live at the sender).

The reference's ``grad_shardings`` (a sharding constraint on the gradient
accumulator of a TPU mesh) has no counterpart on one card and is left out.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.gradient_coding import (
    GradCode,
    cyclic_code,
    decode_weights_checked,
    frc_code,
)
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.compression import compress_leaf_
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["TrainConfig", "TrainState", "make_train_step", "init_train_state"]

TrainState = dict  # {"params": tree, "opt": dict[, "err": tree]}


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    aux_weight: float = 0.01
    gradient_coding: str | None = None   # None | 'frc' | 'cyclic'
    gc_stragglers: int = 1               # tolerated stragglers s
    compression: str | None = None       # None | 'int8' (coded messages only)

    def __post_init__(self):
        if self.compression is not None and self.compression != "int8":
            raise ValueError(f"unknown compression {self.compression!r}")
        if self.compression is not None and self.gradient_coding is None:
            raise ValueError(
                "compression wraps the coded message exchange; it requires "
                "gradient_coding to be set"
            )


def _to_device(batch: dict, device) -> dict:
    """A batch (numpy or tensors) on ``device``; integer arrays as int64."""
    out = {}
    for k, x in batch.items():
        t = torch.as_tensor(x)
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(device)
    return out


def _split_microbatches(batch: dict, m: int) -> list[dict]:
    for x in batch.values():
        if x.shape[0] % m != 0:
            raise ValueError(f"batch {x.shape[0]} not divisible by microbatches {m}")
    parts = {k: torch.chunk(x, m) for k, x in batch.items()}
    return [{k: p[j] for k, p in parts.items()} for j in range(m)]


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    train_cfg: TrainConfig = TrainConfig(),
) -> Callable:
    """Returns ``step(state, batch, straggler_mask=None) -> (state, metrics)``.

    ``straggler_mask`` (only in gradient-coding mode) is a [n_workers] 0/1
    vector: which coded gradient messages arrived this round.  Metrics are
    0-dim tensors: the model's own (ce/aux/tokens) on every path, ``loss``,
    ``grad_norm``, ``lr`` and — in coded mode — ``ok``: 1.0 if the mask was
    decodable, 0.0 if the step was skipped (params and optimizer state pass
    through unchanged).  The step makes new tensors; the state it was given
    stays valid.  ``step.gradients(state, batch, straggler_mask=None)`` is
    the same step without its update (see ``gradients``): a check that
    compares two steps' gradients reads them there, whatever the moments'
    dtype.
    """
    m = train_cfg.microbatches
    code: GradCode | None = None
    if train_cfg.gradient_coding == "frc":
        code = frc_code(m, train_cfg.gc_stragglers)
    elif train_cfg.gradient_coding == "cyclic":
        code = cyclic_code(m, train_cfg.gc_stragglers)
    elif train_cfg.gradient_coding is not None:
        raise ValueError(f"unknown gradient coding {train_cfg.gradient_coding!r}")
    compress = train_cfg.compression is not None
    bmat = None if code is None else code.b.astype(np.float32)  # [n, n_shards]

    def grad_fn(params, mb):
        """(loss, metrics, gradient leaves in leaf order) of one batch."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, metrics = model.loss(tree_unflatten(params, leaves), mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def plain_grads(params, batch):
        if m == 1:
            return grad_fn(params, batch)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        losses, mets = [], []
        for mb in _split_microbatches(batch, m):
            loss, metrics, grads = grad_fn(params, mb)
            for a, g in zip(acc, grads):
                a.add_(g.to(torch.float32) / m)
            losses.append(loss)
            mets.append(metrics)
        metrics = {k: torch.stack([x[k] for x in mets]).mean(0) for k in mets[0]}
        return torch.stack(losses).mean(), metrics, acc

    def coded_grads(params, batch, mask, err):
        """n_workers == microbatches; message_i = sum_j B[i,j] grad_j.

        Loss/metrics are decoded with the same recombination weights as the
        gradients (w = vᵀ M B, per-shard weights): with an all-ones mask w
        is exactly 1ᵀ and this equals the plain microbatch mean; under a
        decodable mask it is the survivor-decoded mean.
        """
        msgs = [torch.zeros((m,) + tuple(p.shape), dtype=torch.float32, device=p.device)
                for p in tree_leaves(params)]
        losses, mets = [], []
        for j, mb in enumerate(_split_microbatches(batch, m)):
            loss, metrics, grads = grad_fn(params, mb)
            for ms, g in zip(msgs, grads):
                g = g.to(torch.float32)
                for i in range(m):  # a zero coefficient adds nothing
                    if bmat[i, j] != 0.0:
                        ms[i].add_(g if bmat[i, j] == 1.0 else g * float(bmat[i, j]))
            losses.append(loss)
            mets.append(metrics)
            del grads

        new_err = err
        if compress:
            # leaf by leaf: each message buffer becomes its residual
            residuals = []
            for k, e in enumerate(tree_leaves(err)):
                residuals.append(msgs[k])
                msgs[k] = compress_leaf_(msgs[k], e)[1]
            new_err = tree_unflatten(err, residuals)

        dev = msgs[0].device
        v, ok = decode_weights_checked(code, mask)
        vm = v * mask
        grads = []
        for k in range(len(msgs)):
            grads.append(torch.tensordot(vm, msgs[k], dims=1) / m)
            msgs[k] = None
        w = vm @ torch.as_tensor(bmat, device=dev)  # [n_shards] weights for per-shard scalars
        loss = torch.dot(w, torch.stack(losses)) / m
        metrics = {key: torch.dot(w, torch.stack([x[key] for x in mets])) / m for key in mets[0]}
        return loss, metrics, grads, new_err, ok

    def gradients(state: TrainState, batch: dict, straggler_mask=None):
        """The step without its update: (loss, metrics, the gradient leaves
        in leaf order, the new compression residual or None, ``ok`` or
        None).  Coded: the decoded gradient under ``straggler_mask``."""
        params = state["params"]
        dev = tree_leaves(params)[0].device
        batch = _to_device(batch, dev)
        if code is None:
            return (*plain_grads(params, batch), None, None)
        mask = (torch.ones(m, dtype=torch.float32, device=dev) if straggler_mask is None
                else torch.as_tensor(straggler_mask, dtype=torch.float32).to(dev))
        err = state.get("err")
        if compress and err is None:
            raise KeyError(
                "compression is enabled but state has no 'err' tree; "
                "build the state with init_train_state(..., train_cfg=cfg)"
            )
        return coded_grads(params, batch, mask, err)

    def step(state: TrainState, batch: dict, straggler_mask=None):
        params = state["params"]
        loss, metrics, grads, new_err, ok = gradients(state, batch, straggler_mask)
        # a list of leaves: the update releases each gradient as it is used
        grads = list(grads)
        new_params, new_opt, opt_metrics = adamw_update(params, grads, state["opt"], opt_cfg)
        out = {"loss": loss, **metrics, **opt_metrics}
        if ok is not None:
            # unrecoverable mask: identity step — never apply a garbage
            # gradient; the select runs on the device, into the new tensors
            def keep_old(new, old):
                return torch.where(ok, new, old, out=new)

            new_params = tree_map(keep_old, new_params, params)
            new_opt = tree_map(keep_old, new_opt, state["opt"])
            out["ok"] = ok.to(torch.float32)
        new_state = {"params": new_params, "opt": new_opt}
        if new_err is not None:
            new_state["err"] = new_err
        return new_state, out

    step.gradients = gradients
    return step


def init_train_state(
    model: Model,
    generator: torch.Generator | None,
    opt_cfg: AdamWConfig,
    train_cfg: TrainConfig | None = None,
    device=None,
) -> TrainState:
    """Seeded params on ``device`` (default: CUDA; ``Model.init``), zero
    moments, and with compression a zero ``err`` tree [m, *p.shape]."""
    params = model.init(generator, device)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    if train_cfg is not None and train_cfg.compression is not None:
        m = train_cfg.microbatches
        state["err"] = tree_map(
            lambda p: torch.zeros((m,) + tuple(p.shape), dtype=torch.float32, device=p.device),
            params)
    return state
