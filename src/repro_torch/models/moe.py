"""Mixture-of-Experts with capacity-based scatter/gather dispatch.

Port of ``repro.models.moe``.  Dispatch never forms a [T, E, C] one-hot:

  1. top-k routing in fp32 (softmax over the router's logits, the top-k
     gates renormalized); ties go to the lower expert id, as ``lax.top_k``
     breaks them (a stable sort, where ``torch.topk`` promises no order);
  2. position-in-expert by a cumsum over the flattened (T·k) assignments
     within each of ``dispatch_groups`` groups, capacity
     C = max(1, ceil(int(cf·k·T) / (E·G))) a group;
  3. a scatter of the tokens into a [E·G·C + 1, D] buffer whose last row
     collects the capacity-dropped assignments and is discarded;
  4. batched expert GEMMs [E, G·C, D] x [E, D, F] (plain ``torch.einsum``:
     the reference computes them outside any Pallas kernel);
  5. a gather of each assignment's row, gate-weighted, summed over k, plus
     the shared expert where the config has one.

Every shape is static and nothing reads a value on the host, so a decode
step through here can be captured in a CUDA graph.  The scatter adds each
token into a zero row of its own (kept slots are unique), so its bits do
not depend on the order of the adds; only the discarded overflow row sees
several.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, init_mlp, mlp_apply

__all__ = ["Routing", "init_moe", "moe_apply", "moe_apply_loop", "route"]


def init_moe(generator, d_model: int, d_ff: int, n_experts: int, kind: str, shared: bool,
             dtype, device, lead: tuple[int, ...] = ()) -> Params:
    def w(shape, fan):
        return dense_init(lead + shape, dtype, generator, device, fan_in=fan)

    p: Params = {
        "router": dense_init(lead + (d_model, n_experts), torch.float32, generator, device),
        "w_up": w((n_experts, d_model, d_ff), d_model),
        "w_down": w((n_experts, d_ff, d_model), d_ff),
    }
    if kind == "swiglu":
        p["w_gate"] = w((n_experts, d_model, d_ff), d_model)
    if shared:
        p["shared"] = init_mlp(generator, d_model, d_ff, kind, dtype, device, lead)
    return p


class Routing(NamedTuple):
    """One call's routing: per (token, k) assignment, flattened token-major."""

    probs: torch.Tensor    # [T, E] fp32 router softmax
    ids: torch.Tensor      # [T, k] expert ids
    gates: torch.Tensor    # [T, k] renormalized fp32 gates
    keep: torch.Tensor     # [T*k] bool: within its expert's capacity
    slot: torch.Tensor     # [T*k] row of the dispatch buffer (E*G*C = overflow)
    cap: int               # capacity of one expert within one group
    groups: int            # dispatch groups actually used


def route(p: Params, xf: torch.Tensor, *, top_k: int, capacity_factor: float,
          dispatch_groups: int = 1) -> Routing:
    """Routing of tokens xf [T, D]: expert choice, gates, capacity and slots."""
    t = xf.shape[0]
    e = p["router"].shape[-1]
    g_ = dispatch_groups if (t * top_k) % dispatch_groups == 0 else 1
    logits = xf.to(torch.float32) @ p["router"]                      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :top_k], ids[:, :top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    cap = int(max(1, -(-int(capacity_factor * top_k * t) // (e * g_))))  # ceil
    ids_f = ids.reshape(-1)
    tg = (t * top_k) // g_
    experts = torch.arange(e, device=xf.device)
    onehot = (ids_f.reshape(g_, tg)[..., None] == experts).to(torch.int32)  # [G, tg, E]
    pos = torch.cumsum(onehot, dim=1) - 1                              # local count
    pos = torch.gather(pos, 2, ids_f.reshape(g_, tg, 1)).reshape(-1)
    keep = pos < cap
    grp = torch.arange(t * top_k, device=xf.device) // tg
    slot = torch.where(keep, (ids_f * g_ + grp) * cap + pos, e * g_ * cap)
    return Routing(probs, ids, gates, keep, slot, cap, g_)


def _experts(p: Params, h: torch.Tensor, kind: str) -> torch.Tensor:
    """The batched expert FFN over h [E, C, D] in h's dtype."""
    dt = h.dtype
    up = torch.einsum("ecd,edf->ecf", h, p["w_up"].to(dt))
    if kind == "swiglu":
        g = torch.einsum("ecd,edf->ecf", h, p["w_gate"].to(dt))
        act = g * torch.sigmoid(g) * up
    elif kind == "relu2":
        act = torch.square(torch.relu(up))
    elif kind == "gelu":
        act = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return torch.einsum("ecf,efd->ecd", act, p["w_down"].to(dt))


def moe_apply(
    p: Params,
    x: torch.Tensor,          # [B, S, D]
    *,
    top_k: int,
    capacity_factor: float,
    kind: str,
    dispatch_groups: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,D], the Switch load-balancing aux loss, an fp32 scalar)."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    t = b * s
    xf = x.reshape(t, d)
    r = route(p, xf, top_k=top_k, capacity_factor=capacity_factor,
              dispatch_groups=dispatch_groups)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    experts = torch.arange(e, device=x.device)
    me = (r.ids[:, 0, None] == experts).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(me * r.probs.mean(dim=0))

    # dispatch: scatter into [E*G*C (+1 overflow), D]
    rows = e * r.groups * r.cap
    # each token k times in a row (repeat_interleave would size its output
    # on the host: a sync a CUDA graph cannot hold)
    xrep = xf[:, None].expand(t, top_k, d).reshape(t * top_k, d)         # [T*k, D]
    buf = torch.zeros((rows + 1, d), dtype=x.dtype, device=x.device).index_add_(
        0, r.slot, xrep)
    y_exp = _experts(p, buf[:rows].reshape(e, r.groups * r.cap, d), kind)

    # combine: gather own slot, gate-weight, sum over k
    y_buf = torch.cat([y_exp.reshape(rows, d), torch.zeros((1, d), dtype=x.dtype,
                                                           device=x.device)])
    w = (r.gates.reshape(-1) * r.keep).to(x.dtype)
    y_tok = y_buf[r.slot] * w[:, None]                                 # [T*k, D]
    y = y_tok.reshape(t, top_k, d).sum(dim=1) if top_k > 1 else y_tok
    if "shared" in p:  # llama4's always-on shared expert
        y = y + mlp_apply(p["shared"], xf, kind)
    return y.reshape(b, s, d), aux


def moe_apply_loop(p: Params, x: torch.Tensor, *, top_k: int, capacity_factor: float,
                   kind: str, dispatch_groups: int = 1) -> torch.Tensor:
    """The same function token by token, as a check of ``moe_apply``: each
    kept (token, k) assignment through its expert's own weights, gate-
    weighted and summed over k, with ``route``'s keep mask; plus the shared
    expert.  A Python loop over tokens, slow by design."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    r = route(p, xf, top_k=top_k, capacity_factor=capacity_factor,
              dispatch_groups=dispatch_groups)
    ids, keep = r.ids.tolist(), r.keep.reshape(-1, top_k).tolist()
    w = r.gates.to(x.dtype)
    rows = []
    for ti in range(xf.shape[0]):
        outs = []
        for j in range(top_k):
            ex = ids[ti][j]
            h = xf[ti][None, None]                                       # [1, 1, D]
            y = _experts({k: v[ex:ex + 1] for k, v in p.items() if k.startswith("w_")}, h,
                         kind)[0, 0]
            outs.append(y * w[ti, j] if keep[ti][j] else torch.zeros_like(y))
        rows.append(torch.stack(outs).sum(dim=0) if top_k > 1 else outs[0])
    y = torch.stack(rows)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xf, kind)
    return y.reshape(b, s, d)
