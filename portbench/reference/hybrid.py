"""Plain fp32 reference of a Mamba-2 hybrid (the port's ``hybrid``
family, zamba2): per block x += mamba(rmsnorm(x)); after every
``attn_every``-th block the one shared attention + SwiGLU block, each
application attending only its own positions.  The SSD is the chunked
state-space-duality form (Dao and Gu, arXiv 2405.21060), written here
again in fp32: the quadratic term inside each chunk, a recurrence of
the state across chunks."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import F32, Precision, attention, logits, rmsnorm, swiglu


def ssd(x, dt, a, b, c, chunk: int):
    """y [S, H, P] of x [S, H, P], step sizes dt [S, H], per-head decay
    rates a [H] (negative), b, c [S, G, N]: y_t = C_t h_t with
    h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T, h_0 = 0."""
    s, n_h, p = x.shape
    g, n = b.shape[1:]
    b = b.repeat_interleave(n_h // g, dim=1)                      # [S, H, N]
    c = c.repeat_interleave(n_h // g, dim=1)
    xd = x * dt[..., None]
    la = dt * a                                                    # log decay [S, H]
    y = torch.empty_like(x)
    state = torch.zeros((n_h, p, n), dtype=F32, device=x.device)
    for s0 in range(0, s, chunk):
        s1 = min(s0 + chunk, s)
        cum = torch.cumsum(la[s0:s1], dim=0)                        # [q, H]
        seg = cum[:, None, :] - cum[None, :, :]                     # [l, j, H]: sum over (j, l]
        q = s1 - s0
        causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
        decay = torch.where(causal[..., None], torch.exp(seg.clamp_max(0.0)), 0.0)
        cb = torch.einsum("lhn,jhn->ljh", c[s0:s1], b[s0:s1])
        y_in = torch.einsum("ljh,ljh,jhp->lhp", cb, decay, xd[s0:s1])
        y_state = torch.einsum("lhn,hpn,lh->lhp", c[s0:s1], state, torch.exp(cum))
        y[s0:s1] = y_in + y_state
        to_end = torch.exp(cum[-1][None] - cum)                     # [q, H]
        state = state * torch.exp(cum[-1])[:, None, None] + torch.einsum(
            "jhp,jhn,jh->hpn", xd[s0:s1], b[s0:s1], to_end)
    return y


def mamba(p: dict, u: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    d_in = cfg["ssm_expand"] * cfg["d_model"]
    g, n, hd = cfg["ssm_groups"], cfg["ssm_state"], cfg["ssm_head_dim"]
    n_h = d_in // hd
    width = cfg["conv_width"]
    zxbcdt = prec.mm(u, p["in_proj"])
    z, xbc, dtv = torch.split(zxbcdt, [d_in, d_in + 2 * g * n, n_h], dim=-1)
    w = p["conv_w"].to(F32)                                        # [W, C]
    padded = torch.cat([xbc.new_zeros((width - 1, xbc.shape[1])), xbc])
    conv = sum(padded[i:i + len(xbc)] * w[i] for i in range(width))
    xbc = F.silu(conv)
    x, b, c = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    dt = F.softplus(dtv + p["dt_bias"].to(F32))
    a = -torch.exp(p["a_log"].to(F32))
    x = x.reshape(-1, n_h, hd)
    y = ssd(x, dt, a, b.reshape(-1, g, n), c.reshape(-1, g, n), cfg["ssm_chunk"])
    y = y + x * p["d_skip"].to(F32)[:, None]
    y = y.reshape(-1, d_in) * F.silu(z)
    y = rmsnorm(y, p["gate_norm"], cfg["norm_eps"])
    return prec.mm(y, p["out_proj"])


def hidden(weights: dict, cfg: dict, tokens: torch.Tensor, prec: Precision) -> torch.Tensor:
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    sp = weights["shared_attn"]
    x = prec.act(weights["embed"][tokens].to(F32))
    for i, blk in enumerate(weights["blocks"]):
        x = prec.act(x + mamba(blk["mamba"], rmsnorm(x, blk["ln1"], eps), cfg, prec))
        if (i + 1) % cfg["attn_every"] == 0:
            x = prec.act(x + attention(sp["attn"], rmsnorm(x, sp["ln1"], eps), theta, prec))
            x = prec.act(x + swiglu(sp["mlp"], rmsnorm(x, sp["ln2"], eps), prec))
    return x


def served_logits(weights: dict, cfg: dict, prompt: torch.Tensor, served: torch.Tensor,
                  prec: Precision) -> torch.Tensor:
    seq = torch.cat([prompt, served[:-1]])
    h = hidden(weights, cfg, seq, prec)
    return logits(weights, h[len(prompt) - 1:], cfg["norm_eps"])
