"""Decoder-only LM (dense, moe, vlm, ssm and hybrid) with the BPCC coded LM head.

Port of ``repro.models.transformer``.  Params are a dict of tensors in the
reference's layout.  The attention families stack their layers in
*groups* of ``group_period(cfg)`` layers on a leading group axis, with
per-layer keys ``ln1_j``, ``attn_j``, ``ln2_j`` and ``mlp_j`` or ``moe_j``:

  dense, dbrx (moe_every=1)  : period 1
  llama4 (moe_every=2)       : period 2, [dense-FFN layer, MoE layer]
  vlm (cross_attn_every=5)   : period 5, the last layer of a group with a
                               tanh-gated image cross-attention (``lnx_j``,
                               ``xattn_j``)

ssm blocks are stacked on a layer axis; hybrid (zamba2) blocks are a
Python list beside one *shared* attention+MLP block applied after every
``attn_every``-th Mamba block.  Layer loops are Python loops.  The KV caches
are bf16 whatever the activation dtype, and decode updates them in place;
a vlm cache also holds each group's image cross K/V (``ck``/``cv``),
written once by the prefill.  The Mamba states of a decode step are new
tensors (their conv cache takes the activation dtype, as the reference's
does).  Every Mamba block's prefill runs the SSD kernels
(``ssd_kernel_mode``: None is by device).  ``cfg.pad_heads`` pads the
self-attention heads and masks the padding heads' outputs, so the function
is the unpadded model's.

The last-position logits go through ``_last_logits``: with ``cfg.coded``
the head matvec runs on the coded blocks (``kernels.ops.coded_head_matvec``)
so any ``coded_parity`` erased shards (``head_mask`` zeros) still give exact
logits.  On CUDA tensors it runs as the fused hand-written kernel
(``head_kernel_mode`` None or ``'cuda'``; ``'auto'`` picks its launch per
shape); with a ``head_mesh`` (a ``repro_torch.sharding.HeadMesh``) it runs
one code block per device.  The head mesh and kernel mode are explicit
arguments; where they are None the reference's contexts
(``repro_torch.sharding.ctx``) supply them.

Training: ``lm_forward`` (with the vlm image and the summed MoE aux loss)
and ``lm_loss`` (chunked cross-entropy).  With ``cfg.remat`` every group
(zamba2: every ``_hybrid_layer``) runs under ``torch.utils.checkpoint``,
and the loss recomputes each sequence chunk's fp32 logits in the backward,
so [B, S, V] fp32 logits are never resident.  Weights are cast to the
activation dtype at use inside the graph, so the gradients reach the fp32
leaves (training never calls ``cast_matmul_weights``).
"""
from __future__ import annotations

import math
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    attention_decode,
    attention_full,
    cross_attention,
    cross_attention_cached,
    init_attn,
    init_cross_attn,
    precompute_cross_kv,
)
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
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.ssm import init_mamba_block, init_mamba_state, mamba_block_apply

__all__ = [
    "init_lm",
    "lm_forward",
    "lm_loss",
    "chunked_ce",
    "lm_init_cache",
    "lm_prefill",
    "lm_decode_step",
    "cast_matmul_weights",
    "group_period",
]

KV_DTYPE = torch.bfloat16


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _coded_blocks(cfg: ModelConfig) -> int:
    """Total coded blocks for the serving head = TP width (one per shard)."""
    return coded_blocks(cfg)


def group_period(cfg: ModelConfig) -> int:
    """Layers a stacked group holds (the reference's scan period)."""
    if cfg.family == "moe":
        return max(cfg.moe_every, 1)
    if cfg.family == "vlm":
        return max(cfg.cross_attn_every, 1)
    return 1


def _n_real(cfg: ModelConfig) -> int | None:
    """The real head count where ``pad_heads`` pads the heads, else None."""
    return cfg.n_heads if cfg.pad_heads else None


# ==========================================================================
# init
# ==========================================================================
def _init_groups(cfg: ModelConfig, generator, pdt, device) -> Params:
    """The attention families' groups, stacked on a leading group axis: per
    layer j of a group its norms, self-attention (``n_heads + pad_heads``
    heads) and MLP, the group's last layer a MoE (moe) or with a gated
    cross-attention (vlm)."""
    d, hd, r = cfg.d_model, cfg.resolved_head_dim, group_period(cfg)
    if cfg.n_layers % r:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by period {r}")
    lead = (cfg.n_layers // r,)
    g: Params = {}
    for j in range(r):
        g[f"ln1_{j}"] = torch.ones(lead + (d,), dtype=torch.float32, device=device)
        g[f"attn_{j}"] = init_attn(generator, d, cfg.n_heads + cfg.pad_heads, cfg.n_kv_heads, hd,
                                   pdt, device, lead=lead)
        g[f"ln2_{j}"] = torch.ones(lead + (d,), dtype=torch.float32, device=device)
        if cfg.family == "moe" and j == r - 1:
            g[f"moe_{j}"] = init_moe(generator, d, cfg.d_ff, cfg.n_experts, cfg.mlp,
                                     cfg.shared_expert, pdt, device, lead=lead)
        else:
            g[f"mlp_{j}"] = init_mlp(generator, d, cfg.d_ff, cfg.mlp, pdt, device, lead=lead)
        if cfg.family == "vlm" and j == r - 1:
            g[f"lnx_{j}"] = torch.ones(lead + (d,), dtype=torch.float32, device=device)
            g[f"xattn_{j}"] = init_cross_attn(generator, d, cfg.n_heads, cfg.n_kv_heads, hd, pdt,
                                              device, gated=True, lead=lead)
    return g


def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    """Full parameter dict: the attention families' groups and ssm blocks
    stacked on a leading axis, hybrid blocks a list beside the shared
    attention block."""
    pdt = _dtype(cfg.param_dtype)
    d, hd, n = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    params: Params = {
        "embed": embed_init((cfg.vocab, d), pdt, generator, device),
        "final_norm": torch.ones(d, dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, cfg.vocab), pdt, generator, device)
    if cfg.family == "ssm":
        params["blocks"] = {
            "ln1": torch.ones((n, d), dtype=torch.float32, device=device),
            "mamba": init_mamba_block(generator, cfg, pdt, device, lead=(n,)),
        }
    elif cfg.family == "hybrid":
        params["blocks"] = [
            {"ln1": torch.ones(d, dtype=torch.float32, device=device),
             "mamba": init_mamba_block(generator, cfg, pdt, device)}
            for _ in range(n)
        ]
        params["shared_attn"] = {
            "ln1": torch.ones(d, dtype=torch.float32, device=device),
            "attn": init_attn(generator, d, cfg.n_heads, cfg.n_kv_heads, hd, pdt, device),
            "ln2": torch.ones(d, dtype=torch.float32, device=device),
            "mlp": init_mlp(generator, d, cfg.d_ff, cfg.mlp, pdt, device),
        }
    else:
        params["blocks"] = _init_groups(cfg, generator, pdt, device)
    if cfg.coded:
        from repro_torch.core.coded_ops import encode_blocks

        head = params["lm_head"] if "lm_head" in params else params["embed"].T
        nb = _coded_blocks(cfg)
        params["lm_head_coded"] = encode_blocks(
            head.T.to(torch.float32), nb - cfg.coded_parity, cfg.coded_parity
        ).to(pdt)
    return params


# the Mamba block's matmul weights; its per-head and norm params stay fp32
MAMBA_MATMUL_WEIGHTS = ("in_proj", "out_proj", "conv_w")
# fp32 leaves of a layer's sub-modules: the MoE router (routing is fp32)
# and the cross-attention's tanh gate
KEEP_FP32 = ("router", "gate")


def cast_matmul_weights(params: Params, cfg: ModelConfig) -> Params:
    """A shallow copy whose block matmul weights are already in the
    activation dtype.  Every layer casts its weight at use; casting once
    here gives the same bits and turns those casts into no-ops.  Norm
    weights, the Mamba per-head params, the router, the cross-attention
    gate, embeddings and heads stay as they are."""
    adt = _dtype(cfg.dtype)

    def cast_sub(sub: Params) -> Params:
        return {k: (cast_sub(w) if isinstance(w, dict) else w if k in KEEP_FP32 else w.to(adt))
                for k, w in sub.items()}

    def cast_mamba(mp: Params) -> Params:
        return {k: (w.to(adt) if k in MAMBA_MATMUL_WEIGHTS else w) for k, w in mp.items()}

    def cast_block(blk: Params) -> Params:
        return {name: (cast_mamba(sub) if name == "mamba" else
                       cast_sub(sub) if isinstance(sub, dict) else sub)
                for name, sub in blk.items()}

    out = dict(params)
    for key in ("blocks", "enc_blocks", "dec_blocks"):
        if isinstance(params.get(key), list):
            out[key] = [cast_block(blk) for blk in params[key]]
        elif key in params:
            out[key] = cast_block(params[key])
    if "shared_attn" in params:
        out["shared_attn"] = cast_block(params["shared_attn"])
    return out


def _layer(blocks: Params, i: int) -> Params:
    """Layer ``i``'s params: views into the stacked tensors."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in blocks.items()}


def _unstack(blocks: Params, n: int) -> list[Params]:
    """Each layer's params from the stacked ones, one ``unbind`` a leaf (so
    a backward stacks each leaf's gradient once, not layer by layer)."""
    per_leaf = {k: (_unstack(v, n) if isinstance(v, dict) else torch.unbind(v))
                for k, v in blocks.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


# ==========================================================================
# forward (train)
# ==========================================================================
def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``cfg.remat`` and
    grad mode are on (the reference's per-layer ``jax.checkpoint``)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _ffn(gp: Params, j: int, h2: torch.Tensor, cfg: ModelConfig):
    """Layer j's feed-forward: its MoE (with its aux loss) or its MLP (aux None)."""
    if f"moe_{j}" in gp:
        return moe_apply(gp[f"moe_{j}"], h2, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, kind=cfg.mlp,
                         dispatch_groups=cfg.moe_dispatch_groups)
    return mlp_apply(gp[f"mlp_{j}"], h2, cfg.mlp), None


def _group_full(gp: Params, x, positions, img, *, cfg: ModelConfig, kv: Params | None = None,
                g: int = 0):
    """One group over the full sequence: (x, its MoE aux loss).  The vlm
    cross-attention runs where an image is given.  With ``kv`` (the cache's
    blocks) each layer's roped K and V are written into group ``g`` of it,
    as the prefill's cache."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    r = group_period(cfg)
    for j in range(r):
        h = rmsnorm(x, gp[f"ln1_{j}"], cfg.norm_eps)
        attn = gp[f"attn_{j}"]
        if kv is not None:
            s = h.shape[1]
            k = torch.einsum("bsd,dhk->bshk", h, attn["w_k"].to(h.dtype))
            v = torch.einsum("bsd,dhk->bshk", h, attn["w_v"].to(h.dtype))
            kv[f"attn_{j}"]["k"][g, :, :s] = apply_rope(k, positions, cfg.rope_theta).to(KV_DTYPE)
            kv[f"attn_{j}"]["v"][g, :, :s] = v.to(KV_DTYPE)
        x = x + attention_full(attn, h, positions, cfg.rope_theta, n_real=_n_real(cfg))
        if cfg.family == "vlm" and j == r - 1 and img is not None:
            hx = rmsnorm(x, gp[f"lnx_{j}"], cfg.norm_eps)
            x = x + cross_attention(gp[f"xattn_{j}"], hx, img)
        y, a = _ffn(gp, j, rmsnorm(x, gp[f"ln2_{j}"], cfg.norm_eps), cfg)
        x = x + y
        if a is not None:
            aux = aux + a
    return x, aux


def _mamba_layer(gp: Params, x, *, cfg: ModelConfig):
    h, _ = mamba_block_apply(gp["mamba"], cfg, rmsnorm(x, gp["ln1"], cfg.norm_eps))
    return x + h


def _hybrid_layer(gp, sp, x, positions, *, cfg: ModelConfig, use_attn: bool):
    x = _mamba_layer(gp, x, cfg=cfg)
    if use_attn:
        x = _shared_attn_apply(sp, cfg, x, positions)
    return x


def lm_forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                     # [B, S]
    img: torch.Tensor | None = None,          # [B, n_img, D] (vlm stub frontend)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden [B,S,D] in the activation dtype, the MoE aux
    loss summed over the MoE layers: 0 for the other families).  Every
    Mamba block's SSD runs the SSD kernels on a CUDA tensor (their plain
    versions on the CPU), through ``SSDScan`` when the step takes
    gradients."""
    adt = _dtype(cfg.dtype)
    x = params["embed"][tokens].to(adt)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    img = img.to(adt) if img is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        for i, gp in enumerate(params["blocks"]):
            body = partial(_hybrid_layer, cfg=cfg, use_attn=_uses_shared_attn(cfg, i))
            x = _remat(cfg, body, gp, params["shared_attn"], x, positions)
    elif cfg.family == "ssm":
        body = partial(_mamba_layer, cfg=cfg)
        for gp in _unstack(params["blocks"], cfg.n_layers):
            x = _remat(cfg, body, gp, x)
    else:
        body = partial(_group_full, cfg=cfg)
        for gp in _unstack(params["blocks"], cfg.n_layers // group_period(cfg)):
            x, a = _remat(cfg, body, gp, x, positions, img)
            aux = aux + a
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


# ==========================================================================
# loss (chunked cross-entropy — never keeps [B,S,V] fp32 logits)
# ==========================================================================
def _ce_chunk(h: torch.Tensor, head: torch.Tensor, lab: torch.Tensor, onehot_pick: bool):
    """(sum of token NLL, count of valid tokens) over one chunk, fp32."""
    logits = h.to(torch.float32) @ head.to(torch.float32)            # [B,c,V]
    lse = torch.logsumexp(logits, dim=-1)
    valid = lab >= 0
    idx = torch.clamp_min(lab, 0).to(torch.int64)
    if onehot_pick:
        hot = torch.nn.functional.one_hot(idx, logits.shape[-1]).to(torch.float32)
        pick = torch.einsum("bcv,bcv->bc", logits, hot)
    else:
        pick = torch.take_along_dim(logits, idx[..., None], dim=-1)[..., 0]
    nll = (lse - pick) * valid
    return nll.sum(), valid.sum().to(torch.float32)


def chunked_ce(
    hidden: torch.Tensor,    # [B, S, D]
    head: torch.Tensor,      # [D, V]
    labels: torch.Tensor,    # [B, S] int; -1 = padding (ignored)
    chunk: int,
    onehot_pick: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean token CE + token count, over sequence chunks in order.

    Under grad mode each chunk runs under ``torch.utils.checkpoint``: its
    fp32 logits [B, c, V] are freed after the forward and recomputed in the
    backward, so no chunk's logits stay alive for it (at glm4-9b's vocabulary
    each 1,024 tokens' logits take 0.62 GB)."""
    b, s, _ = hidden.shape
    c = min(chunk, s)
    if s % c != 0:
        c = math.gcd(s, c) or s
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for k in range(0, s, c):
        args = (hidden[:, k:k + c], head, labels[:, k:k + c], onehot_pick)
        if torch.is_grad_enabled():
            nll, n = checkpoint(_ce_chunk, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            nll, n = _ce_chunk(*args)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp_min(cnt, 1.0), cnt


def lm_loss(
    params: Params,
    cfg: ModelConfig,
    batch: dict[str, torch.Tensor],
    aux_weight: float = 0.01,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """batch: tokens [B,S], labels [B,S] (+ img_embed [B, n_img, D] for vlm)
    -> (loss, {"ce", "aux", "tokens"}).  ``aux_weight`` weighs the summed
    MoE aux loss; the model's loss always uses its default, as the
    reference's does."""
    hidden, aux = lm_forward(params, cfg, batch["tokens"], batch.get("img_embed"))
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    ce, cnt = chunked_ce(hidden, head, batch["labels"], cfg.logit_chunk,
                         onehot_pick=cfg.onehot_ce)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "tokens": cnt}


# ==========================================================================
# caches
# ==========================================================================
def lm_init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> Params:
    """Decode cache: per-slot positions and, by family,

      * dense, moe, vlm: bf16 K/V of each layer j of a group stacked on
                groups, ``blocks["attn_j"]`` [n_groups, batch, s_max, kv, hd];
                vlm also the image cross K/V of each group's last layer,
                ``blocks["xattn_j"]`` ``ck``/``cv`` [n_groups, batch,
                img_tokens, kv, hd];
      * ssm:    Mamba states stacked on layers (``init_mamba_state``);
      * hybrid: a list of per-layer Mamba states, and bf16 K/V
                [n_apps, batch, s_max, kv, hd] for the shared block, one
                slice per application (n_apps = n_layers // attn_every).
    """
    cache: Params = {"pos": torch.zeros(batch, dtype=torch.int32, device=device)}
    if cfg.family == "ssm":
        cache["blocks"] = {"mamba": init_mamba_state(cfg, batch, device, lead=(cfg.n_layers,))}
        return cache
    kv = (batch, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.family == "hybrid":
        cache["blocks"] = [{"mamba": init_mamba_state(cfg, batch, device)}
                           for _ in range(cfg.n_layers)]
        n_apps = cfg.n_layers // cfg.attn_every
        cache["shared_attn"] = {
            "k": torch.zeros((n_apps,) + kv, dtype=KV_DTYPE, device=device),
            "v": torch.zeros((n_apps,) + kv, dtype=KV_DTYPE, device=device),
        }
        return cache
    r = group_period(cfg)
    lead = (cfg.n_layers // r,)
    cache["blocks"] = {f"attn_{j}": {
        "k": torch.zeros(lead + kv, dtype=KV_DTYPE, device=device),
        "v": torch.zeros(lead + kv, dtype=KV_DTYPE, device=device),
    } for j in range(r)}
    if cfg.family == "vlm":
        xkv = lead + (batch, cfg.img_tokens, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["blocks"][f"xattn_{r - 1}"] = {
            "ck": torch.zeros(xkv, dtype=KV_DTYPE, device=device),
            "cv": torch.zeros(xkv, dtype=KV_DTYPE, device=device),
        }
    return cache


# ==========================================================================
# prefill / decode
# ==========================================================================
def lm_prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                     # [B, S]
    img: torch.Tensor | None = None,          # [B, n_img, D] (vlm: required)
    s_max: int | None = None,                 # cache capacity (>= S; default S)
    head_mask: torch.Tensor | None = None,    # coded-head erasure mask [n_blocks]
    head_kernel_mode: str | None = None,
    head_mesh=None,
    ssd_kernel_mode: str | None = None,
) -> tuple[torch.Tensor, Params]:
    """Full forward that also emits the decode cache (K/V zero-padded to
    ``s_max``; the vlm image cross K/V, one row an image token; Mamba
    states and conv tails) and the last position's logits [B, vocab] fp32.
    A vlm prefill needs ``img``: the reference fails without one."""
    adt = _dtype(cfg.dtype)
    b, s = tokens.shape
    s_max = s_max or s
    if s_max < s:
        raise ValueError(f"cache capacity {s_max} < prompt length {s}")
    if cfg.family == "vlm" and img is None:
        raise ValueError("a vlm prefill needs the request's image embeddings (img_embed)")
    x = params["embed"][tokens].to(adt)
    positions = torch.arange(s, device=tokens.device)[None, :]
    cache = lm_init_cache(cfg, b, s_max, tokens.device)
    cache["pos"].fill_(s)
    if cfg.family in ("ssm", "hybrid"):
        x = _prefill_mamba(params, cfg, x, positions, cache, ssd_kernel_mode)
    else:
        x = _prefill_groups(params, cfg, x, positions, img, cache)
    hidden = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _last_logits(params, hidden, cfg, head_mask, head_kernel_mode, head_mesh), cache


def _prefill_groups(params, cfg, x, positions, img, cache) -> torch.Tensor:
    """The attention families' groups, each writing its K/V into the cache;
    a vlm group also its image cross K/V (``precompute_cross_kv``)."""
    r, n_groups = group_period(cfg), cfg.n_layers // group_period(cfg)
    blocks = cache["blocks"]
    if img is not None:
        img = img.to(x.dtype)
        xkv = (n_groups,) + tuple(img.shape[:2]) + blocks[f"xattn_{r - 1}"]["ck"].shape[-2:]
        blocks[f"xattn_{r - 1}"] = {n: torch.empty(xkv, dtype=KV_DTYPE, device=x.device)
                                    for n in ("ck", "cv")}
    for g in range(n_groups):
        gp = _layer(params["blocks"], g)
        x, _ = _group_full(gp, x, positions, img, cfg=cfg, kv=blocks, g=g)
        if cfg.family == "vlm":
            xa = blocks[f"xattn_{r - 1}"]
            ck, cv = precompute_cross_kv(gp[f"xattn_{r - 1}"], img)
            xa["ck"][g], xa["cv"][g] = ck.to(KV_DTYPE), cv.to(KV_DTYPE)
    return x


def _mamba_layers(params: Params, cfg: ModelConfig) -> list[Params]:
    """Each Mamba layer's params: views into the stacked ssm blocks, or the
    hybrid list as it is."""
    if cfg.family == "hybrid":
        return params["blocks"]
    return [_layer(params["blocks"], i) for i in range(cfg.n_layers)]


def _mamba_cache(cfg: ModelConfig, states: list[dict]) -> Params:
    """Per-layer Mamba states in the family's cache layout: stacked on a
    layer axis (ssm) or a list (hybrid)."""
    if cfg.family == "hybrid":
        return [{"mamba": st} for st in states]
    return {"mamba": {k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv")}}


def _mamba_states(cfg: ModelConfig, blocks: Params) -> list[dict]:
    """The inverse of ``_mamba_cache``: each layer's state dict."""
    if cfg.family == "hybrid":
        return [blk["mamba"] for blk in blocks]
    st = blocks["mamba"]
    return [{"ssm": st["ssm"][i], "conv": st["conv"][i]} for i in range(cfg.n_layers)]


def _uses_shared_attn(cfg: ModelConfig, i: int) -> bool:
    """zamba2: the shared block follows every ``attn_every``-th Mamba block."""
    return cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0


def _prefill_mamba(params, cfg, x, positions, cache, ssd_kernel_mode) -> torch.Tensor:
    """The Mamba blocks (and, for hybrid, the shared block after every
    ``attn_every``-th, each application writing its own K/V slice).  Each
    block's final state and conv tail (which may be shorter than W-1 rows)
    go into the cache."""
    adt, s = x.dtype, x.shape[1]
    states, app = [], 0
    for i, gp in enumerate(_mamba_layers(params, cfg)):
        h, st = mamba_block_apply(gp["mamba"], cfg, rmsnorm(x, gp["ln1"], cfg.norm_eps),
                                  ssd_kernel_mode=ssd_kernel_mode)
        x = x + h
        states.append(st)
        if _uses_shared_attn(cfg, i):
            sp = params["shared_attn"]
            hh = rmsnorm(x, sp["ln1"], cfg.norm_eps)
            k = torch.einsum("bsd,dhk->bshk", hh, sp["attn"]["w_k"].to(adt))
            v = torch.einsum("bsd,dhk->bshk", hh, sp["attn"]["w_v"].to(adt))
            cache["shared_attn"]["k"][app, :, :s] = apply_rope(
                k, positions, cfg.rope_theta).to(KV_DTYPE)
            cache["shared_attn"]["v"][app, :, :s] = v.to(KV_DTYPE)
            x = _shared_attn_apply(sp, cfg, x, positions)
            app += 1
    cache["blocks"] = _mamba_cache(cfg, states)
    return x


def _shared_attn_apply(sp: Params, cfg: ModelConfig, x, positions) -> torch.Tensor:
    h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
    x = x + attention_full(sp["attn"], h, positions, cfg.rope_theta)
    h2 = rmsnorm(x, sp["ln2"], cfg.norm_eps)
    return x + mlp_apply(sp["mlp"], h2, cfg.mlp)


def lm_decode_step(
    params: Params,
    cfg: ModelConfig,
    cache: Params,
    tokens: torch.Tensor,                     # [B] — one new token per sequence
    head_mask: torch.Tensor | None = None,
    head_kernel_mode: str | None = None,
    head_mesh=None,
) -> tuple[torch.Tensor, Params]:
    """One decoding step: (logits [B, vocab] fp32, cache).  K/V tensors are
    updated in place (the cross K/V only read); the returned dict carries
    ``pos + 1`` and the new Mamba states."""
    adt = _dtype(cfg.dtype)
    pos = cache["pos"]
    x = params["embed"][tokens][:, None].to(adt)  # [B,1,D]
    new_cache = dict(cache, pos=pos + 1)
    if cfg.family in ("ssm", "hybrid"):
        old, states, app = _mamba_states(cfg, cache["blocks"]), [], 0
        for i, gp in enumerate(_mamba_layers(params, cfg)):
            h, st = mamba_block_apply(gp["mamba"], cfg, rmsnorm(x, gp["ln1"], cfg.norm_eps),
                                      state=old[i])
            x = x + h
            states.append(st)
            if _uses_shared_attn(cfg, i):
                kv = cache["shared_attn"]
                x = _shared_attn_decode(params["shared_attn"], cfg, kv["k"][app], kv["v"][app],
                                        x, pos)
                app += 1
        new_cache["blocks"] = _mamba_cache(cfg, states)
    else:
        r, blocks = group_period(cfg), cache["blocks"]
        for g in range(cfg.n_layers // r):
            gp = _layer(params["blocks"], g)
            for j in range(r):
                h = rmsnorm(x, gp[f"ln1_{j}"], cfg.norm_eps)
                kv = blocks[f"attn_{j}"]
                x = x + attention_decode(gp[f"attn_{j}"], h, kv["k"][g], kv["v"][g], pos,
                                         cfg.rope_theta, n_real=_n_real(cfg),
                                         aligned=cfg.aligned_decode)
                if cfg.family == "vlm" and j == r - 1:
                    hx = rmsnorm(x, gp[f"lnx_{j}"], cfg.norm_eps)
                    xa = blocks[f"xattn_{j}"]
                    x = x + cross_attention_cached(gp[f"xattn_{j}"], hx, xa["ck"][g], xa["cv"][g])
                x = x + _ffn(gp, j, rmsnorm(x, gp[f"ln2_{j}"], cfg.norm_eps), cfg)[0]
    hidden = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (_last_logits(params, hidden, cfg, head_mask, head_kernel_mode, head_mesh),
            new_cache)


def _shared_attn_decode(sp: Params, cfg: ModelConfig, ck, cv, x, pos) -> torch.Tensor:
    """The zamba2 shared block at decode, on one application's K/V slice
    (views into the stacked cache, written in place)."""
    h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
    x = x + attention_decode(sp["attn"], h, ck, cv, pos, cfg.rope_theta)
    h2 = rmsnorm(x, sp["ln2"], cfg.norm_eps)
    return x + mlp_apply(sp["mlp"], h2, cfg.mlp)


def _last_logits(
    params: Params,
    hidden: torch.Tensor,
    cfg: ModelConfig | None = None,
    head_mask: torch.Tensor | None = None,
    head_kernel_mode: str | None = None,
    head_mesh=None,
) -> torch.Tensor:
    """Last-position logits [B, vocab] fp32.  With ``cfg.coded`` the head
    matvec runs on the coded blocks: any ``coded_parity`` erased shards
    (``head_mask`` zeros) still yield exact logits.  With ``head_mesh`` it
    runs one code block per device (``coded_block_matmul``); the coded head
    may then be the blocks ``sharding.shard_coded_head`` placed.  Without a
    config (the encoder-decoder) the head is uncoded.  Where
    ``head_kernel_mode`` or ``head_mesh`` is None, the ``sharding.ctx``
    context supplies it (``head_kernel_mode('auto')``: per-shape dispatch)."""
    last = hidden[:, -1]
    if cfg is not None and cfg.coded and "lm_head_coded" in params:
        from repro_torch.kernels.ops import coded_head_matvec
        from repro_torch.sharding.ctx import current_coded_head_mesh, current_head_kernel_mode

        if head_kernel_mode is None:
            head_kernel_mode = current_head_kernel_mode()
        axis = head_mesh.axis if head_mesh is not None else "model"
        if head_mesh is None and current_coded_head_mesh() is not None:
            head_mesh, axis = current_coded_head_mesh()

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
            axis=axis,
            kernel_mode=head_kernel_mode,
        )
        return y[: cfg.vocab].T.to(hidden.device)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return last.to(torch.float32) @ head.to(torch.float32)
