"""Serving prefill attention as a hand-written Hopper kernel.

``prefill_attn_cuda`` launches ``csrc/prefill_attn.cu``: from a prefill
layer's projected q [B, S, H, Hd] and k, v [B, S, KVH, Hd] (bf16, head
dimension 64 or 128, S below ``attention.CHUNKED_ATTN_THRESHOLD``) and the
forward's rope table, a prologue writes the roped K and the V into the
layer's cache rows [:S], bit-identical to ``layers.apply_rope_table``'s
rows, and a causal GQA flash attention over the rotated q and those rows
gives out [B, S, H, Hd] with no [S, S] tensor.  It replaces no TPU kernel:
the reference's attention is plain jnp.  Its plain version is
``repro_torch.models.attention._attention_prefill_plain``; the routing
wrapper is ``attention.attention_prefill``.  The source note in
``csrc/prefill_attn.cu`` gives its design, its bound and its rounding (fp32
logits, where the plain version rounds them to bf16).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import count_launch, refuse_grad, thin_rows
from repro_torch.kernels._build import c_function

__all__ = ["HEAD_DIMS", "TILE", "prefill_attn_cuda"]

HEAD_DIMS = (64, 128)  # the kernel's template instances
TILE = 64              # csrc/prefill_attn.cu kRows: query rows a block, KV rows a tile


def prefill_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor) -> torch.Tensor:
    """q [B, S, H, Hd], k and v [B, S, KVH, Hd] contiguous bf16 as
    projected; cos and sin [1 or B, S, Hd / 2] contiguous fp32
    (``layers.rope_table``); cache_k and cache_v [B, S, KVH, Hd] bf16 views
    of the cache's rows [:S] (rows contiguous, batches any distance apart),
    written in place.  Returns the causal attention out [B, S, H, Hd] bf16.
    Two launches, the prologue and the attention, counted once in
    ``.launches`` and once in ``.prologue_launches``."""
    refuse_grad(prefill_attn_cuda, q, k, v, cos, sin, cache_k, cache_v)
    named = (("q", q), ("k", k), ("v", v), ("cos", cos), ("sin", sin), ("cache_k", cache_k),
             ("cache_v", cache_v))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in named[:3] + named[5:]:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    for name, t in named[3:5]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must be [B, S, heads, Hd]")
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dimension {hd} is not one of {HEAD_DIMS}")
    if s < 1 or kvh < 1 or h % kvh:
        raise ValueError(f"S {s}, {h} heads over {kvh} KV heads")
    kv_shape = (b, s, kvh, hd)
    for name, t in named[:3]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k", k), ("v", v), ("cache_k", cache_k), ("cache_v", cache_v)):
        if tuple(t.shape) != kv_shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, not {kv_shape}")
    row = (kvh * hd, hd, 1)
    if cache_k.stride()[1:] != row or cache_v.stride() != cache_k.stride():
        raise ValueError(f"cache rows must be contiguous with the same strides, got "
                         f"{cache_k.stride()} and {cache_v.stride()}")
    if cos.shape != sin.shape or cos.dim() != 3 or cos.shape[0] not in (1, b) \
            or tuple(cos.shape[1:]) != (s, hd // 2):
        raise ValueError(f"cos {tuple(cos.shape)} and sin {tuple(sin.shape)} must be "
                         f"[1 or {b}, {s}, {hd // 2}]")
    if not (cos.is_contiguous() and sin.is_contiguous()):
        raise ValueError("cos and sin must be contiguous")
    s_pad = -(-s // TILE) * TILE
    vt = torch.empty((b, kvh, hd, s_pad), dtype=torch.bfloat16, device=q.device)
    out = torch.empty_like(q)
    rope_bstride = 0 if cos.shape[0] == 1 else s * hd // 2
    err = thin_rows.call_on(q.device, _entry(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            cos.data_ptr(), sin.data_ptr(), rope_bstride, cache_k.data_ptr(),
                            cache_v.data_ptr(), cache_k.stride(0), vt.data_ptr(), out.data_ptr(),
                            b, s, h, kvh, hd)
    count_launch(prefill_attn_cuda, engine="prologue")
    if err != 0:
        raise RuntimeError(f"prefill_attn launch failed: cudaError {err}")
    return out


prefill_attn_cuda.launches = 0
prefill_attn_cuda.captured = 0
prefill_attn_cuda.prologue_launches = 0
prefill_attn_cuda.prologue_captured = 0


@functools.lru_cache(maxsize=None)
def _entry():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return c_function("prefill_attn", "prefill_attn",
                      [p, p, p, p, p, ll, p, p, ll, p, p, i, i, i, i, i, p])
