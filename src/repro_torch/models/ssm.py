"""Mamba-2 (SSD — state-space duality) blocks.

Port of ``repro.models.ssm``.  The chunked SSD algorithm (Dao & Gu,
arXiv:2405.21060) splits the sequence into chunks of Q: within a chunk the
terms are matmul-shaped, and a short recurrence over chunks carries the
running state [H, P, N].  The prefill of every block runs it through
``kernels.ops.ssd_forward``, whose intra-chunk terms are the hand-written
``ssd_chunk`` and ``ssd_combine`` kernels on a CUDA tensor (their plain
versions on the CPU).  ``ssd_chunked`` is the reference's einsum oracle,
kept for tests.  Decode is the O(1) recurrent update, in plain torch.

Structure per block (as the reference, biases omitted):
  in_proj -> [z | xBC | dt], causal depthwise conv(width w) on xBC, silu,
  SSD over heads (A scalar/head, B/C grouped), +D skip, gate by silu(z),
  RMSNorm, out_proj.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, dense_init, rmsnorm

__all__ = [
    "ssd_chunked",
    "ssd_decode_step",
    "init_mamba_block",
    "mamba_block_apply",
    "init_mamba_state",
]

NEG_INF = -1e30
CONV_DTYPE = torch.bfloat16  # the conv cache a prefill hands to decode


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., Q] -> [..., Q, Q]: sum_{k=j+1..i} x_k for i >= j, -inf above diag."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, d, torch.full((), NEG_INF, dtype=d.dtype, device=d.device))


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros appended on the sequence axis (1) of [B, S, ...]."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], dim=1)


def ssd_chunked(
    x: torch.Tensor,    # [B, S, H, P]   (pre-multiplied by dt)
    da: torch.Tensor,   # [B, S, H]      (dt * A, negative)
    b_: torch.Tensor,   # [B, S, G, N]
    c_: torch.Tensor,   # [B, S, G, N]
    chunk: int,
    h0: torch.Tensor | None = None,  # [B, H, P, N] initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in einsums (the oracle); returns (y [B,S,H,P],
    final_state [B,H,P,N])."""
    bsz, s_orig, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    q = min(chunk, s_orig)
    if s_orig % q != 0:
        # dt = 0 at padding: decay exp(0) = 1 and no state contribution
        pad = q - s_orig % q
        x, da, b_, c_ = (_pad_seq(t, pad) for t in (x, da, b_, c_))
    s = x.shape[1]
    nc = s // q
    rep = h // g
    f32 = torch.float32

    xc = x.reshape(bsz, nc, q, h, p)
    dac = da.reshape(bsz, nc, q, h).permute(0, 3, 1, 2)              # [B, H, nc, Q]
    bh = torch.repeat_interleave(b_.reshape(bsz, nc, q, g, n), rep, dim=3)
    ch = torch.repeat_interleave(c_.reshape(bsz, nc, q, g, n), rep, dim=3)

    da_cum = torch.cumsum(dac, dim=-1)                               # [B,H,nc,Q]
    ell = torch.exp(_segsum(dac.to(f32)))                            # [B,H,nc,Q,Q]
    cb = torch.einsum("bclhn,bcshn->bhcls", ch, bh)
    y_diag = torch.einsum("bhcls,bhcls,bcshp->bclhp", cb.to(f32), ell, xc.to(f32))

    decay_states = torch.exp(da_cum[..., -1:] - da_cum)              # [B,H,nc,Q]
    states = torch.einsum("bcshn,bhcs,bcshp->bchpn", bh.to(f32), decay_states, xc.to(f32))

    total_decay = torch.exp(da_cum[..., -1])                         # [B,H,nc]
    carry = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device) if h0 is None \
        else h0.to(f32)
    states_in = []
    for k in range(nc):                                              # state entering chunk k
        states_in.append(carry)
        carry = carry * total_decay[:, :, k, None, None] + states[:, k]
    states_in = torch.stack(states_in, dim=1)                        # [B,nc,H,P,N]

    out_decay = torch.exp(da_cum)                                    # [B,H,nc,Q]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", ch.to(f32), states_in, out_decay)
    y = (y_diag + y_off).reshape(bsz, s, h, p)[:, :s_orig]
    return y.to(x.dtype), carry


def ssd_decode_step(
    state: torch.Tensor,  # [B, H, P, N] fp32
    x: torch.Tensor,      # [B, H, P]   (pre-multiplied by dt)
    da: torch.Tensor,     # [B, H]      (dt * A)
    b_: torch.Tensor,     # [B, G, N]
    c_: torch.Tensor,     # [B, G, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent update; returns (y [B,H,P], new_state)."""
    rep = x.shape[1] // b_.shape[1]
    f32 = torch.float32
    bh = torch.repeat_interleave(b_, rep, dim=1).to(f32)  # [B,H,N]
    ch = torch.repeat_interleave(c_, rep, dim=1).to(f32)
    new = state * torch.exp(da.to(f32))[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", x.to(f32), bh)
    y = torch.einsum("bhpn,bhn->bhp", new, ch)
    return y.to(x.dtype), new


# --------------------------------------------------------------------------
# Mamba-2 block
# --------------------------------------------------------------------------
def init_mamba_block(generator: torch.Generator, cfg: ModelConfig, dtype, device,
                     lead: tuple[int, ...] = ()) -> Params:
    """One block's params, with a leading ``lead`` axis on every leaf."""
    d, din = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    conv_ch = din + 2 * g * n
    f32 = dict(dtype=torch.float32, device=device)

    def per_head(t: torch.Tensor) -> torch.Tensor:
        return t.expand(lead + t.shape).clone()

    return {
        "in_proj": dense_init(lead + (d, 2 * din + 2 * g * n + h), dtype, generator, device),
        "conv_w": dense_init(lead + (cfg.conv_width, conv_ch), dtype, generator, device,
                             fan_in=cfg.conv_width),
        "dt_bias": per_head(torch.zeros(h, **f32)),
        "a_log": per_head(torch.log(torch.linspace(1.0, 16.0, h, **f32))),
        "d_skip": per_head(torch.ones(h, **f32)),
        "gate_norm": per_head(torch.ones(din, **f32)),
        "out_proj": dense_init(lead + (din, d), dtype, generator, device, fan_in=din),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, cache: torch.Tensor | None):
    """Depthwise causal conv1d.  xbc [B,S,C], w [W,C]; cache [B,W-1,C] for
    decode (returns the updated cache, in xbc's dtype, as the reference)."""
    width = w.shape[0]
    if cache is None:
        pad = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[2]))
        full = torch.cat([pad, xbc], dim=1)
        new_cache = None
    else:
        full = torch.cat([cache.to(xbc.dtype), xbc], dim=1)
        new_cache = full[:, -(width - 1):]
    s = xbc.shape[1]
    out = full[:, 0:s] * w[0].to(xbc.dtype)
    for i in range(1, width):
        out = out + full[:, i:i + s] * w[i].to(xbc.dtype)
    return F.silu(out), new_cache


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    din, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return torch.split(zxbcdt, [din, din + 2 * g * n, cfg.n_ssm_heads], dim=-1)


def _conv_tail(cfg: ModelConfig, xbc: torch.Tensor) -> torch.Tensor:
    """The last (W-1) conv inputs of a prefill — the decode conv cache (bf16).
    A prompt shorter than W-1 gives fewer rows, as the reference."""
    return xbc[:, -(cfg.conv_width - 1):].to(CONV_DTYPE)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_block_apply(
    p: Params,
    cfg: ModelConfig,
    u: torch.Tensor,
    state: dict | None = None,
    ssd_kernel_mode: str | None = None,
):
    """u [B,S,D] -> (y [B,S,D], state).

    With ``state`` (ssm [B,H,P,N] fp32, conv [B,W-1,C]) runs one decode
    step (S == 1) and returns the new state.  Without, a prefill: S is
    zero-padded to a multiple of the chunk (dt = 0 at the pad, so the final
    state is untouched), the SSD runs through ``kernels.ops.ssd_forward``
    (kernel mode ``ssd_kernel_mode``: None is by device) and y is cut back
    to S; the state is the final SSM state and the conv tail."""
    din, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    pdim = cfg.ssm_head_dim
    dt_ = u.dtype

    zxbcdt = u @ p["in_proj"].to(dt_)
    z, xbc_in, dtv = _split_in_proj(cfg, zxbcdt)
    xbc, new_conv = _causal_conv(xbc_in, p["conv_w"], None if state is None else state["conv"])
    x, b_, c_ = torch.split(xbc, [din, g * n, g * n], dim=-1)
    x = x.reshape(*x.shape[:-1], h, pdim)
    b_ = b_.reshape(*b_.shape[:-1], g, n)
    c_ = c_.reshape(*c_.shape[:-1], g, n)
    dtv = _softplus(dtv.to(torch.float32) + p["dt_bias"])           # [B,S,H]
    a = -torch.exp(p["a_log"])                                      # [H]
    xdt = x * dtv[..., None].to(dt_)
    da = dtv * a

    if state is None:
        from repro_torch.kernels.ops import ssd_forward

        s = u.shape[1]
        q = min(cfg.ssm_chunk, s)
        pad = -s % q
        args = (xdt, da, b_, c_)
        if pad:
            args = tuple(_pad_seq(t, pad) for t in args)
        y, final = ssd_forward(*args, cfg.ssm_chunk, mode=ssd_kernel_mode)
        y = y[:, :s]
        new_state = {"ssm": final, "conv": _conv_tail(cfg, xbc_in)}
    else:
        y1, new_ssm = ssd_decode_step(state["ssm"], xdt[:, 0], da[:, 0], b_[:, 0], c_[:, 0])
        y = y1[:, None]
        new_state = {"ssm": new_ssm, "conv": new_conv}

    y = y + x * p["d_skip"][:, None].to(dt_)
    y = y.reshape(*y.shape[:-2], din)
    y = y * F.silu(z)
    y = rmsnorm(y, p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(dt_), new_state


def init_mamba_state(cfg: ModelConfig, batch: int, device, lead: tuple[int, ...] = ()) -> dict:
    """Decode-time recurrent state: ssm [*lead, B, H, P, N] fp32 and conv
    [*lead, B, W-1, C] bf16, zeros."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm": torch.zeros(lead + (batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, conv_ch), dtype=CONV_DTYPE,
                            device=device),
    }
