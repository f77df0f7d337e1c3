"""Encoder-decoder LM (seamless-m4t backbone).

Port of ``repro.models.encdec``.  The modality frontend is a stub, as in
the reference: the caller supplies precomputed frame embeddings [B, S_src,
D] (what the w2v-BERT speech encoder would emit).  This module is the
transformer backbone (a bidirectional encoder over the frames, a causal
decoder with cross-attention over the encoder's memory) and its serving
path: the decoder's self-attention KV cache and the precomputed cross K/V.
Encoder and decoder layers are stacked on a leading layer axis; the loops
are Python loops.  The head is uncoded, as the reference's is: its
``init_encdec`` makes no coded head and its prefill and decode read the
plain ``lm_head``, whatever ``cfg.coded`` says.

Training: ``encdec_loss`` is the chunked cross-entropy over
``encdec_forward`` (no aux loss).  With ``cfg.remat`` and grad mode on,
every encoder and decoder layer runs under activation checkpointing (the
reference's ``jax.checkpoint`` of its scan bodies), and the stacked layer
params are split once a leaf (``_unstack``), so a backward stacks each
leaf's gradient once.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.models.attention import (
    attention_decode,
    attention_full,
    cross_attention,
    cross_attention_cached,
    init_attn,
    init_cross_attn,
    precompute_cross_kv,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Params,
    apply_rope,
    dense_init,
    embed_init,
    init_mlp,
    mlp_apply,
    rmsnorm,
)
from repro_torch.models.transformer import (
    KV_DTYPE,
    _dtype,
    _last_logits,
    _layer,
    _remat,
    _unstack,
    chunked_ce,
)

__all__ = [
    "init_encdec",
    "encdec_encode",
    "encdec_forward",
    "encdec_loss",
    "encdec_init_cache",
    "encdec_prefill",
    "encdec_decode_step",
]


def init_encdec(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    pdt = _dtype(cfg.param_dtype)
    d, hd, h, kv = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads

    def ones(n):
        return torch.ones((n, d), dtype=torch.float32, device=device)

    ne, nd = cfg.enc_layers, cfg.n_layers
    return {
        "embed": embed_init((cfg.vocab, d), pdt, generator, device),
        "enc_blocks": {
            "ln1": ones(ne),
            "attn": init_attn(generator, d, h, kv, hd, pdt, device, lead=(ne,)),
            "ln2": ones(ne),
            "mlp": init_mlp(generator, d, cfg.d_ff, cfg.mlp, pdt, device, lead=(ne,)),
        },
        "dec_blocks": {
            "ln1": ones(nd),
            "attn": init_attn(generator, d, h, kv, hd, pdt, device, lead=(nd,)),
            "lnx": ones(nd),
            "xattn": init_cross_attn(generator, d, h, kv, hd, pdt, device, lead=(nd,)),
            "ln2": ones(nd),
            "mlp": init_mlp(generator, d, cfg.d_ff, cfg.mlp, pdt, device, lead=(nd,)),
        },
        "enc_norm": torch.ones(d, dtype=torch.float32, device=device),
        "final_norm": torch.ones(d, dtype=torch.float32, device=device),
        "lm_head": dense_init((d, cfg.vocab), pdt, generator, device),
    }


def _enc_layer(lp: Params, x: torch.Tensor, positions: torch.Tensor, *,
               cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    x = x + attention_full(lp["attn"], h, positions, cfg.rope_theta, causal=False)
    return x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg.mlp)


def encdec_encode(params: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, S_src, D] (stub frontend output) -> encoder memory, in the
    activation dtype (non-causal self-attention)."""
    x = frames.to(_dtype(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    body = partial(_enc_layer, cfg=cfg)
    for lp in _unstack(params["enc_blocks"], cfg.enc_layers):
        x = _remat(cfg, body, lp, x, positions)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(lp: Params, x: torch.Tensor, memory: torch.Tensor, positions: torch.Tensor, *,
               cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    x = x + attention_full(lp["attn"], h, positions, cfg.rope_theta)
    x = x + cross_attention(lp["xattn"], rmsnorm(x, lp["lnx"], cfg.norm_eps), memory)
    return x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg.mlp)


def _decoder(params: Params, cfg: ModelConfig, memory: torch.Tensor, tokens: torch.Tensor,
             cache: Params | None = None) -> torch.Tensor:
    """The decoder over the target tokens [B, S_tgt] against ``memory``;
    final hidden states.  With ``cache`` each layer's roped K, V and its
    cross K/V are written into it (the prefill); without, each layer runs
    under ``_remat`` (training)."""
    adt = _dtype(cfg.dtype)
    s = tokens.shape[1]
    x = params["embed"][tokens].to(adt)
    positions = torch.arange(s, device=tokens.device)[None, :]
    if cache is None:
        body = partial(_dec_layer, cfg=cfg)
        for lp in _unstack(params["dec_blocks"], cfg.n_layers):
            x = _remat(cfg, body, lp, x, memory, positions)
        return rmsnorm(x, params["final_norm"], cfg.norm_eps)
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_blocks"], i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        k = torch.einsum("bsd,dhk->bshk", h, lp["attn"]["w_k"].to(adt))
        v = torch.einsum("bsd,dhk->bshk", h, lp["attn"]["w_v"].to(adt))
        cache["k"][i, :, :s] = apply_rope(k, positions, cfg.rope_theta).to(KV_DTYPE)
        cache["v"][i, :, :s] = v.to(KV_DTYPE)
        ck, cv = precompute_cross_kv(lp["xattn"], memory)
        cache["ck"][i], cache["cv"][i] = ck.to(KV_DTYPE), cv.to(KV_DTYPE)
        x = _dec_layer(lp, x, memory, positions, cfg=cfg)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def encdec_forward(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decode over [B, S_tgt] given source frames; returns the
    final decoder hidden states [B, S_tgt, D]."""
    return _decoder(params, cfg, encdec_encode(params, cfg, frames), tokens)


def encdec_loss(params: Params, cfg: ModelConfig,
                batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """batch: frames [B, S_src, D], tokens [B, S], labels [B, S] -> (the
    mean token CE, {"ce", "aux": 0, "tokens"}); the head is the plain
    ``lm_head``."""
    hidden = encdec_forward(params, cfg, batch["frames"], batch["tokens"])
    ce, cnt = chunked_ce(hidden, params["lm_head"], batch["labels"], cfg.logit_chunk,
                         onehot_pick=cfg.onehot_ce)
    aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    return ce, {"ce": ce, "aux": aux, "tokens": cnt}


def encdec_init_cache(cfg: ModelConfig, batch: int, s_max: int, s_src: int, device) -> Params:
    """The decoder's bf16 K/V [n_layers, batch, s_max, kv, hd] and cross K/V
    [n_layers, batch, s_src, kv, hd]."""
    hd = cfg.resolved_head_dim
    kv_shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, hd)
    cross_shape = (cfg.n_layers, batch, s_src, cfg.n_kv_heads, hd)
    return {
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
        "k": torch.zeros(kv_shape, dtype=KV_DTYPE, device=device),
        "v": torch.zeros(kv_shape, dtype=KV_DTYPE, device=device),
        "ck": torch.zeros(cross_shape, dtype=KV_DTYPE, device=device),
        "cv": torch.zeros(cross_shape, dtype=KV_DTYPE, device=device),
    }


def encdec_prefill(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor, s_max: int | None = None):
    """Encode the source and run the decoder over the target prefix: (last
    logits [B, vocab] fp32 from the uncoded head, the cache with the
    self-attention K/V zero-padded to ``s_max`` and the cross K/V, one row
    a source frame)."""
    b, s = tokens.shape
    s_max = s_max or s
    if s_max < s:
        raise ValueError(f"cache capacity {s_max} < prompt length {s}")
    memory = encdec_encode(params, cfg, frames)
    cache = encdec_init_cache(cfg, b, s_max, frames.shape[1], tokens.device)
    cache["pos"].fill_(s)
    hidden = _decoder(params, cfg, memory, tokens, cache)
    return _last_logits(params, hidden), cache


def encdec_decode_step(params: Params, cfg: ModelConfig, cache: Params,
                       tokens: torch.Tensor):
    """One decoder step against the cached self and cross K/V: (logits
    [B, vocab] fp32, the cache with ``pos + 1``; K/V written in place)."""
    pos = cache["pos"]
    x = params["embed"][tokens][:, None].to(_dtype(cfg.dtype))
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_blocks"], i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        x = x + attention_decode(lp["attn"], h, cache["k"][i], cache["v"][i], pos,
                                 cfg.rope_theta)
        hx = rmsnorm(x, lp["lnx"], cfg.norm_eps)
        x = x + cross_attention_cached(lp["xattn"], hx, cache["ck"][i], cache["cv"][i])
        x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg.mlp)
    hidden = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _last_logits(params, hidden), dict(cache, pos=pos + 1)
