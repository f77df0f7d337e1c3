"""Decoder-only LM (dense family) with the BPCC coded LM head.

Port of the dense path of ``repro.models.transformer`` (``Model`` refuses
other families and padded heads).  Params are a dict of tensors in the
reference's layout, block params stacked on a leading layer axis; the layer
loop is a Python loop over that axis.  The KV cache is bf16 whatever the
activation dtype, and decode updates it in place.

The last-position logits go through ``_last_logits``: with ``cfg.coded``
the head matvec runs on the coded blocks (``kernels.ops.coded_head_matvec``)
so any ``coded_parity`` erased shards (``head_mask`` zeros) still give exact
logits.  On CUDA tensors it runs as the fused hand-written kernel
(``head_kernel_mode`` None or ``'cuda'``); with a ``head_mesh`` (a
``repro_torch.sharding.HeadMesh``) it runs one code block per device.  The
head mesh and kernel mode are explicit arguments where the reference reads
contextvars.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import attention_decode, attention_full, init_attn
from repro_torch.models.config import ModelConfig, coded_blocks
from repro_torch.models.layers import (
    Params,
    apply_rope,
    dense_init,
    embed_init,
    init_mlp,
    mlp_apply,
    rmsnorm,
)

__all__ = [
    "init_lm",
    "lm_init_cache",
    "lm_prefill",
    "lm_decode_step",
    "cast_matmul_weights",
]

KV_DTYPE = torch.bfloat16


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _coded_blocks(cfg: ModelConfig) -> int:
    """Total coded blocks for the serving head = TP width (one per shard)."""
    return coded_blocks(cfg)


# ==========================================================================
# init
# ==========================================================================
def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    """Full parameter dict; block params stacked on a leading layer axis."""
    pdt = _dtype(cfg.param_dtype)
    d, hd, n = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    params: Params = {
        "embed": embed_init((cfg.vocab, d), pdt, generator, device),
        "final_norm": torch.ones(d, dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, cfg.vocab), pdt, generator, device)
    params["blocks"] = {
        "ln1_0": torch.ones((n, d), dtype=torch.float32, device=device),
        "attn_0": init_attn(generator, d, cfg.n_heads, cfg.n_kv_heads, hd, pdt, device,
                            lead=(n,)),
        "ln2_0": torch.ones((n, d), dtype=torch.float32, device=device),
        "mlp_0": init_mlp(generator, d, cfg.d_ff, cfg.mlp, pdt, device, lead=(n,)),
    }
    if cfg.coded:
        from repro_torch.core.coded_ops import encode_blocks

        head = params["lm_head"] if "lm_head" in params else params["embed"].T
        nb = _coded_blocks(cfg)
        params["lm_head_coded"] = encode_blocks(
            head.T.to(torch.float32), nb - cfg.coded_parity, cfg.coded_parity
        ).to(pdt)
    return params


def cast_matmul_weights(params: Params, cfg: ModelConfig) -> Params:
    """A shallow copy whose block matmul weights are already in the
    activation dtype.  Every layer casts its weight at use; casting once
    here gives the same bits and turns those casts into no-ops.  Norm
    weights, embeddings and heads stay as they are."""
    adt = _dtype(cfg.dtype)
    out = dict(params)
    out["blocks"] = {
        name: ({k: w.to(adt) for k, w in sub.items()} if isinstance(sub, dict) else sub)
        for name, sub in params["blocks"].items()
    }
    return out


def _layer(blocks: Params, i: int) -> Params:
    """Layer ``i``'s params: views into the stacked tensors."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in blocks.items()}


# ==========================================================================
# caches
# ==========================================================================
def lm_init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> Params:
    """Decode cache: per-slot positions and bf16 K/V stacked on layers,
    k/v [n_layers, batch, s_max, n_kv_heads, head_dim]."""
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
        "blocks": {"attn_0": {
            "k": torch.zeros(shape, dtype=KV_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=KV_DTYPE, device=device),
        }},
    }


# ==========================================================================
# prefill / decode
# ==========================================================================
def lm_prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                     # [B, S]
    s_max: int | None = None,                 # cache capacity (>= S; default S)
    head_mask: torch.Tensor | None = None,    # coded-head erasure mask [n_blocks]
    head_kernel_mode: str | None = None,
    head_mesh=None,
) -> tuple[torch.Tensor, Params]:
    """Full forward that also emits the KV cache (zero-padded to ``s_max``)
    and the last position's logits [B, vocab] fp32."""
    adt = _dtype(cfg.dtype)
    b, s = tokens.shape
    s_max = s_max or s
    if s_max < s:
        raise ValueError(f"cache capacity {s_max} < prompt length {s}")
    x = params["embed"][tokens].to(adt)
    positions = torch.arange(s, device=tokens.device)[None, :]
    cache = lm_init_cache(cfg, b, s_max, tokens.device)
    cache["pos"].fill_(s)
    kc, vc = cache["blocks"]["attn_0"]["k"], cache["blocks"]["attn_0"]["v"]
    for i in range(cfg.n_layers):
        gp = _layer(params["blocks"], i)
        h = rmsnorm(x, gp["ln1_0"], cfg.norm_eps)
        attn = gp["attn_0"]
        k = torch.einsum("bsd,dhk->bshk", h, attn["w_k"].to(adt))
        v = torch.einsum("bsd,dhk->bshk", h, attn["w_v"].to(adt))
        kc[i, :, :s] = apply_rope(k, positions, cfg.rope_theta).to(KV_DTYPE)
        vc[i, :, :s] = v.to(KV_DTYPE)
        x = x + attention_full(attn, h, positions, cfg.rope_theta)
        h2 = rmsnorm(x, gp["ln2_0"], cfg.norm_eps)
        x = x + mlp_apply(gp["mlp_0"], h2, cfg.mlp)
    hidden = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _last_logits(params, hidden, cfg, head_mask, head_kernel_mode, head_mesh), cache


def lm_decode_step(
    params: Params,
    cfg: ModelConfig,
    cache: Params,
    tokens: torch.Tensor,                     # [B] — one new token per sequence
    head_mask: torch.Tensor | None = None,
    head_kernel_mode: str | None = None,
    head_mesh=None,
) -> tuple[torch.Tensor, Params]:
    """One decoding step: (logits [B, vocab] fp32, cache).  The cache's K/V
    tensors are updated in place; the returned dict carries ``pos + 1``."""
    adt = _dtype(cfg.dtype)
    pos = cache["pos"]
    x = params["embed"][tokens][:, None].to(adt)  # [B,1,D]
    kc, vc = cache["blocks"]["attn_0"]["k"], cache["blocks"]["attn_0"]["v"]
    for i in range(cfg.n_layers):
        gp = _layer(params["blocks"], i)
        h = rmsnorm(x, gp["ln1_0"], cfg.norm_eps)
        x = x + attention_decode(gp["attn_0"], h, kc[i], vc[i], pos, cfg.rope_theta,
                                 aligned=cfg.aligned_decode)
        h2 = rmsnorm(x, gp["ln2_0"], cfg.norm_eps)
        x = x + mlp_apply(gp["mlp_0"], h2, cfg.mlp)
    hidden = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    new_cache = {"pos": pos + 1, "blocks": cache["blocks"]}
    return (_last_logits(params, hidden, cfg, head_mask, head_kernel_mode, head_mesh),
            new_cache)


def _last_logits(
    params: Params,
    hidden: torch.Tensor,
    cfg: ModelConfig,
    head_mask: torch.Tensor | None = None,
    head_kernel_mode: str | None = None,
    head_mesh=None,
) -> torch.Tensor:
    """Last-position logits [B, vocab] fp32.  With ``cfg.coded`` the head
    matvec runs on the coded blocks: any ``coded_parity`` erased shards
    (``head_mask`` zeros) still yield exact logits.  With ``head_mesh`` it
    runs one code block per device (``coded_block_matmul``); the coded head
    may then be the blocks ``sharding.shard_coded_head`` placed."""
    last = hidden[:, -1]
    if cfg.coded and "lm_head_coded" in params:
        from repro_torch.kernels.ops import coded_head_matvec

        nb = _coded_blocks(cfg)
        mask = head_mask
        if mask is None:
            mask = torch.ones(nb, dtype=torch.float32, device=hidden.device)
        w = params["lm_head_coded"]
        if isinstance(w, torch.Tensor):
            w = w.to(torch.float32)
        else:
            w = tuple(blk.to(torch.float32) for blk in w)
        y = coded_head_matvec(
            w,
            last.to(torch.float32).T.contiguous(),
            mask,
            nb - cfg.coded_parity,
            cfg.coded_parity,
            mesh=head_mesh,
            axis=head_mesh.axis if head_mesh is not None else "model",
            kernel_mode=head_kernel_mode,
        )
        return y[: cfg.vocab].T.to(hidden.device)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return last.to(torch.float32) @ head.to(torch.float32)
