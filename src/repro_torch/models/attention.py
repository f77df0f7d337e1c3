"""Grouped-query attention: full, serving prefill, decode (KV cache) and cross.

Layout: activations [B, S, D]; per-head tensors [B, S, H, Hd]; KV caches
[B, S_max, KVH, Hd] in bf16.  Port of ``repro.models.attention``, rounding
where the reference does: QKᵀ is formed in the activation dtype and only
then cast to fp32, the softmax runs in fp32, and the probabilities are cast
back to the value dtype before PV.  From ``CHUNKED_ATTN_THRESHOLD`` tokens
on, full and cross attention run ``_sdpa_chunked``, the reference's
online-softmax SDPA in fp32, which never forms the [Sq, Sk] logits.

A serving prefill's causal self-attention, which also writes the KV cache,
is ``attention_prefill``: Q, K and V projected once, K roped once, from one
rope table a forward.  On the card, at a head dimension of 64 or 128 below
``CHUNKED_ATTN_THRESHOLD`` tokens with bf16 activations, it runs the
hand-written kernel ``kernels.prefill_attn`` (``prefill_path`` says which
route a prefill takes); elsewhere its plain version, which computes what
``attention_full`` and the cache write did.  The kernel keeps QKᵀ in fp32
where the plain version rounds it to bf16 first: more precise, not less.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.prefill_attn import HEAD_DIMS as PREFILL_KERNEL_HEAD_DIMS
from repro_torch.kernels.prefill_attn import prefill_attn_cuda
from repro_torch.models.layers import Params, apply_rope, apply_rope_table, dense_init

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
    # a fill, not a host copy, so a decode step can be captured in a CUDA graph
    logits = logits / torch.sqrt(torch.full((), hd, dtype=torch.float32, device=q.device))
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bgmqk,bkgd->bqgmd", probs, v)
    return out.reshape(b, sq, h, hd)


def _sdpa_chunked(q, k, v, *, causal: bool, q_chunk: int = 1024,
                  kv_chunk: int = 2048) -> torch.Tensor:
    """Online-softmax SDPA over query and KV chunks, all in fp32: never
    forms the [Sq, Sk] logits.  The reference's loop as it computes it: a
    running max, denominator and weighted accumulator carried over the KV
    chunks of each query chunk; a causal chunk past the diagonal is masked,
    not skipped.  A length that is no multiple of its chunk falls back to
    the dense ``_sdpa``, as the reference's does."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    gs = h // kvh
    qc, kc = min(q_chunk, sq), min(kv_chunk, sk)
    if sq % qc or sk % kc:
        return _sdpa(q, k, v, _causal_mask5(sq, sk, q.device) if causal else None)
    scale = 1.0 / torch.sqrt(torch.full((), hd, dtype=torch.float32, device=q.device))
    qr = q.reshape(b, sq // qc, qc, kvh, gs, hd)
    kr = k.reshape(b, sk // kc, kc, kvh, hd)
    vr = v.reshape(b, sk // kc, kc, kvh, hd)
    ar_q = torch.arange(qc, device=q.device)
    ar_k = torch.arange(kc, device=q.device)
    out = torch.empty((b, sq // qc, qc, kvh, gs, hd), dtype=torch.float32, device=q.device)
    for qi in range(sq // qc):
        qblk = qr[:, qi].to(torch.float32)                          # [B,qc,KVH,gs,Hd]
        m = torch.full((b, qc, kvh, gs), NEG_INF, dtype=torch.float32, device=q.device)
        den = torch.zeros((b, qc, kvh, gs), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, qc, kvh, gs, hd), dtype=torch.float32, device=q.device)
        for kj in range(sk // kc):
            logits = torch.einsum("bqgmd,bkgd->bqgmk", qblk,
                                  kr[:, kj].to(torch.float32)) * scale
            if causal:
                msk = (kj * kc + ar_k)[None, :] <= (qi * qc + ar_q)[:, None]
                logits = torch.where(msk[None, :, None, None, :], logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            den = den * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqgmk,bkgd->bqgmd", p, vr[:, kj].to(torch.float32))
            m = m_new
        out[:, qi] = acc / torch.clamp_min(den, 1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(v.dtype)


def _causal_mask5(sq: int, sk: int, device) -> torch.Tensor:
    ar_k = torch.arange(sk, device=device)
    ar_q = torch.arange(sq, device=device)
    return (ar_k[None, :] <= ar_q[:, None])[None, None, None]


def _mask_pad_heads(out: torch.Tensor, n_real: int | None) -> torch.Tensor:
    """Zero the outputs of padding heads (``cfg.pad_heads``): the function
    then equals the unpadded model exactly."""
    if n_real is None or n_real >= out.shape[2]:
        return out
    mask = (torch.arange(out.shape[2], device=out.device) < n_real).to(out.dtype)
    return out * mask[None, None, :, None]


def _qkv(p: Params, x: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["w_q"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["w_k"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["w_v"].to(dt))
    return q, k, v


def attention_full(p: Params, x: torch.Tensor, positions: torch.Tensor, theta: float,
                   *, causal: bool = True, n_real: int | None = None) -> torch.Tensor:
    """Full self-attention over [B, S, D] (prefill; ``causal=False`` for an
    encoder).  ``n_real`` masks the padding heads' outputs."""
    s = x.shape[1]
    q, k, v = _qkv(p, x)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    if s >= CHUNKED_ATTN_THRESHOLD:
        out = _sdpa_chunked(q, k, v, causal=causal)
    else:
        out = _sdpa(q, k, v, _causal_mask5(s, s, x.device) if causal else None)
    out = _mask_pad_heads(out, n_real)
    return torch.einsum("bshk,hkd->bsd", out, p["w_o"].to(x.dtype))


def prefill_path(x: torch.Tensor, head_dim: int) -> str:
    """The route ``attention_prefill`` takes over x [B, S, D]: ``'kernel'``,
    or why not: ``'device'`` (not a CUDA tensor), ``'dtype'`` (activations
    not bf16), ``'head_dim'`` (not in ``PREFILL_KERNEL_HEAD_DIMS``),
    ``'long'`` (S from ``CHUNKED_ATTN_THRESHOLD`` on: the fp32
    ``_sdpa_chunked``, whose precision the kernel's bf16 P would lower)."""
    if not x.is_cuda:
        return "device"
    if x.dtype != torch.bfloat16:
        return "dtype"
    if head_dim not in PREFILL_KERNEL_HEAD_DIMS:
        return "head_dim"
    if x.shape[1] >= CHUNKED_ATTN_THRESHOLD:
        return "long"
    return "kernel"


def attention_prefill(p: Params, x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor],
                      cache_k_rows: torch.Tensor, cache_v_rows: torch.Tensor,
                      n_real: int | None = None) -> torch.Tensor:
    """Causal self-attention of a serving prefill over x [B, S, D], which
    also writes the layer's cache rows: ``cache_k_rows`` and
    ``cache_v_rows`` [B, S, KVH, Hd] (views of the cache's rows [:S],
    written in place) get the roped K and the V.  ``rope``: the forward's
    ``layers.rope_table`` (cos, sin) at the prompt's positions.  ``n_real``
    masks the padding heads' outputs.  Returns out [B, S, D]; the route is
    ``prefill_path``'s."""
    q, k, v = _qkv(p, x)
    if prefill_path(x, q.shape[-1]) == "kernel":
        out = prefill_attn_cuda(q.contiguous(), k.contiguous(), v.contiguous(), *rope,
                                cache_k_rows, cache_v_rows)
    else:
        out = _attention_prefill_plain(q, k, v, rope, cache_k_rows, cache_v_rows)
    out = _mask_pad_heads(out, n_real)
    return torch.einsum("bshk,hkd->bsd", out, p["w_o"].to(x.dtype))


def _attention_prefill_plain(q, k, v, rope, cache_k_rows, cache_v_rows) -> torch.Tensor:
    """The prefill kernel's plain version: ``attention_full``'s rope and
    SDPA on the projected q, k, v [B, S, *, Hd], the cache rows written as
    the reference's prefill writes them (the roped K and the V, cast to
    the cache's dtype)."""
    s = q.shape[1]
    q = apply_rope_table(q, *rope)
    k = apply_rope_table(k, *rope)
    cache_k_rows.copy_(k)
    cache_v_rows.copy_(v)
    if s >= CHUNKED_ATTN_THRESHOLD:
        return _sdpa_chunked(q, k, v, causal=True)
    return _sdpa(q, k, v, _causal_mask5(s, s, q.device))


def attention_decode(
    p: Params,
    x: torch.Tensor,            # [B, 1, D] — one new token per sequence
    cache_k: torch.Tensor,      # [B, S_max, KVH, Hd]
    cache_v: torch.Tensor,
    pos: torch.Tensor,          # [B] int — write/attend position per sequence
    theta: float,
    n_real: int | None = None,
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
    out = _mask_pad_heads(out, n_real)
    return torch.einsum("bshk,hkd->bsd", out, p["w_o"].to(dt))


# --------------------------------------------------------------------------
# Cross-attention (VLM image layers, enc-dec decoder)
# --------------------------------------------------------------------------
def init_cross_attn(generator, d_model: int, n_heads: int, n_kv: int, head_dim: int, dtype,
                    device, gated: bool = False, lead: tuple[int, ...] = ()) -> Params:
    p = init_attn(generator, d_model, n_heads, n_kv, head_dim, dtype, device, lead)
    if gated:  # tanh-gated (llama-vision style); tanh(0) = 0 at init
        p["gate"] = torch.zeros(lead, dtype=torch.float32, device=device)
    return p


def _gated(p: Params, y: torch.Tensor) -> torch.Tensor:
    if "gate" in p:
        y = torch.tanh(p["gate"]).to(y.dtype) * y
    return y


def cross_attention(p: Params, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """x [B,Sq,D] attends over memory [B,Sk,D] (no RoPE, no causal mask)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["w_q"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", memory.to(dt), p["w_k"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", memory.to(dt), p["w_v"].to(dt))
    if max(x.shape[1], memory.shape[1]) >= CHUNKED_ATTN_THRESHOLD:
        out = _sdpa_chunked(q, k, v, causal=False)
    else:
        out = _sdpa(q, k, v, None)
    return _gated(p, torch.einsum("bshk,hkd->bsd", out, p["w_o"].to(dt)))


def precompute_cross_kv(p: Params, memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention K/V of a request, computed once (decode reads them)."""
    k = torch.einsum("bsd,dhk->bshk", memory, p["w_k"].to(memory.dtype))
    v = torch.einsum("bsd,dhk->bshk", memory, p["w_v"].to(memory.dtype))
    return k, v


def cross_attention_cached(p: Params, x: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of x [B,1,D] over cached K/V [B,Sk,KVH,Hd], every
    row attended (the reference pads an engine slot's rows with zeros and
    attends them too)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["w_q"].to(dt))
    out = _sdpa(q, k.to(dt), v.to(dt), None)
    return _gated(p, torch.einsum("bshk,hkd->bsd", out, p["w_o"].to(dt)))
