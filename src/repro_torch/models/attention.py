"""Grouped-query self-attention: full (prefill) and decode (KV cache).

Layout: activations [B, S, D]; per-head tensors [B, S, H, Hd]; KV caches
[B, S_max, KVH, Hd] in bf16.  Port of ``repro.models.attention``, rounding
where the reference does: QKᵀ is formed in the activation dtype and only
then cast to fp32, the softmax runs in fp32, and the probabilities are cast
back to the value dtype before PV.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import Params, apply_rope, dense_init

NEG_INF = -1e30
# the reference switches to a chunked online-softmax SDPA from here on
CHUNKED_ATTN_THRESHOLD = 8192


def init_attn(generator, d_model: int, n_heads: int, n_kv: int, head_dim: int, dtype,
              device, lead: tuple[int, ...] = ()) -> Params:
    def w(shape, fan):
        return dense_init(lead + shape, dtype, generator, device, fan_in=fan)

    return {
        "w_q": w((d_model, n_heads, head_dim), d_model),
        "w_k": w((d_model, n_kv, head_dim), d_model),
        "w_v": w((d_model, n_kv, head_dim), d_model),
        "w_o": w((n_heads, head_dim, d_model), n_heads * head_dim),
    }


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q [B,Sq,H,Hd], k/v [B,Sk,KVH,Hd], mask [B,1,1,Sq,Sk] or None."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, sq, kvh, h // kvh, hd)
    logits = torch.einsum("bqgmd,bkgd->bgmqk", q, k).to(torch.float32)
    logits = logits / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bgmqk,bkgd->bqgmd", probs, v)
    return out.reshape(b, sq, h, hd)


def _causal_mask5(sq: int, sk: int, device) -> torch.Tensor:
    ar_k = torch.arange(sk, device=device)
    ar_q = torch.arange(sq, device=device)
    return (ar_k[None, :] <= ar_q[:, None])[None, None, None]


def _qkv(p: Params, x: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["w_q"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["w_k"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["w_v"].to(dt))
    return q, k, v


def attention_full(p: Params, x: torch.Tensor, positions: torch.Tensor, theta: float,
                   *, causal: bool = True) -> torch.Tensor:
    """Full self-attention over [B, S, D] (prefill)."""
    s = x.shape[1]
    if s >= CHUNKED_ATTN_THRESHOLD:
        raise NotImplementedError(
            f"sequences of {s} >= {CHUNKED_ATTN_THRESHOLD} need the chunked SDPA, not ported yet")
    q, k, v = _qkv(p, x)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    out = _sdpa(q, k, v, _causal_mask5(s, s, x.device) if causal else None)
    return torch.einsum("bshk,hkd->bsd", out, p["w_o"].to(x.dtype))


def attention_decode(
    p: Params,
    x: torch.Tensor,            # [B, 1, D] — one new token per sequence
    cache_k: torch.Tensor,      # [B, S_max, KVH, Hd]
    cache_v: torch.Tensor,
    pos: torch.Tensor,          # [B] int — write/attend position per sequence
    theta: float,
    aligned: bool = False,      # all sequences share pos[0]
) -> torch.Tensor:
    """One decode step; returns out [B,1,D].

    The new token's K/V are written into the caches IN PLACE: an indexed
    write at ``pos`` with the same result as the reference's one-hot
    rewrite (a position past ``S_max`` writes nothing); with ``aligned``
    one slice at ``pos[0]``, clamped into the cache as
    ``dynamic_update_slice`` clamps.  No host sync.
    """
    dt = x.dtype
    q, k, v = _qkv(p, x)
    q = apply_rope(q, pos[:, None], theta)
    k = apply_rope(k, pos[:, None], theta)

    s_max = cache_k.shape[1]
    if aligned:
        at = pos[:1].clamp(max=s_max - 1).to(torch.long)
        cache_k.index_copy_(1, at, k.to(cache_k.dtype))
        cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    else:
        rows = torch.arange(pos.shape[0], device=pos.device)
        at = pos.clamp(max=s_max - 1).to(torch.long)
        keep = (pos < s_max)[:, None, None]
        for cache, new in ((cache_k, k), (cache_v, v)):
            cache[rows, at] = torch.where(keep, new[:, 0].to(cache.dtype), cache[rows, at])
    mask = (torch.arange(s_max, device=pos.device)[None, :] <= pos[:, None])
    out = _sdpa(q, cache_k.to(dt), cache_v.to(dt), mask[:, None, None, None, :])
    return torch.einsum("bshk,hkd->bsd", out, p["w_o"].to(dt))
