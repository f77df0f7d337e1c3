"""Decoder-only LM (dense, ssm and hybrid families) with the BPCC coded LM head.

Port of the dense, ssm and hybrid paths of ``repro.models.transformer``
(``Model`` refuses the other families and padded heads).  Params are a dict
of tensors in the reference's layout: dense and ssm block params stacked
on a leading layer axis, hybrid (zamba2) blocks a Python list beside one
*shared* attention+MLP block applied after every ``attn_every``-th Mamba
block; the layer loop is a Python loop.  The KV caches are bf16 whatever
the activation dtype, and decode updates them in place; the Mamba states
of a decode step are new tensors (their conv cache takes the activation
dtype, as the reference's does).  Every Mamba block's prefill runs the SSD
kernels (``ssd_kernel_mode``: None is by device).

The last-position logits go through ``_last_logits``: with ``cfg.coded``
the head matvec runs on the coded blocks (``kernels.ops.coded_head_matvec``)
so any ``coded_parity`` erased shards (``head_mask`` zeros) still give exact
logits.  On CUDA tensors it runs as the fused hand-written kernel
(``head_kernel_mode`` None or ``'cuda'``); with a ``head_mesh`` (a
``repro_torch.sharding.HeadMesh``) it runs one code block per device.  The
head mesh and kernel modes are explicit arguments where the reference reads
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
from repro_torch.models.ssm import init_mamba_block, init_mamba_state, mamba_block_apply

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
    """Full parameter dict: dense and ssm blocks stacked on a leading layer
    axis, hybrid blocks a list beside the shared attention block."""
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


# the Mamba block's matmul weights; its per-head and norm params stay fp32
MAMBA_MATMUL_WEIGHTS = ("in_proj", "out_proj", "conv_w")


def cast_matmul_weights(params: Params, cfg: ModelConfig) -> Params:
    """A shallow copy whose block matmul weights are already in the
    activation dtype.  Every layer casts its weight at use; casting once
    here gives the same bits and turns those casts into no-ops.  Norm
    weights, the Mamba per-head params, embeddings and heads stay as they
    are."""
    adt = _dtype(cfg.dtype)

    def cast_all(sub: Params) -> Params:
        return {k: w.to(adt) for k, w in sub.items()}

    def cast_mamba(mp: Params) -> Params:
        return {k: (w.to(adt) if k in MAMBA_MATMUL_WEIGHTS else w) for k, w in mp.items()}

    def cast_block(blk: Params) -> Params:
        return {name: (cast_mamba(sub) if name == "mamba" else
                       cast_all(sub) if isinstance(sub, dict) else sub)
                for name, sub in blk.items()}

    out = dict(params)
    if isinstance(params["blocks"], list):
        out["blocks"] = [cast_block(blk) for blk in params["blocks"]]
    else:
        out["blocks"] = cast_block(params["blocks"])
    if "shared_attn" in params:
        out["shared_attn"] = cast_block(params["shared_attn"])
    return out


def _layer(blocks: Params, i: int) -> Params:
    """Layer ``i``'s params: views into the stacked tensors."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in blocks.items()}


# ==========================================================================
# caches
# ==========================================================================
def lm_init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> Params:
    """Decode cache: per-slot positions and, by family,

      * dense:  bf16 K/V stacked on layers, [n_layers, batch, s_max, kv, hd];
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
    cache["blocks"] = {"attn_0": {
        "k": torch.zeros((cfg.n_layers,) + kv, dtype=KV_DTYPE, device=device),
        "v": torch.zeros((cfg.n_layers,) + kv, dtype=KV_DTYPE, device=device),
    }}
    return cache


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
    ssd_kernel_mode: str | None = None,
) -> tuple[torch.Tensor, Params]:
    """Full forward that also emits the decode cache (K/V zero-padded to
    ``s_max``; Mamba states and conv tails) and the last position's logits
    [B, vocab] fp32."""
    adt = _dtype(cfg.dtype)
    b, s = tokens.shape
    s_max = s_max or s
    if s_max < s:
        raise ValueError(f"cache capacity {s_max} < prompt length {s}")
    x = params["embed"][tokens].to(adt)
    positions = torch.arange(s, device=tokens.device)[None, :]
    cache = lm_init_cache(cfg, b, s_max, tokens.device)
    cache["pos"].fill_(s)
    if cfg.family in ("ssm", "hybrid"):
        x = _prefill_mamba(params, cfg, x, positions, cache, ssd_kernel_mode)
    else:
        x = _prefill_dense(params, cfg, x, positions, cache)
    hidden = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _last_logits(params, hidden, cfg, head_mask, head_kernel_mode, head_mesh), cache


def _prefill_dense(params, cfg, x, positions, cache) -> torch.Tensor:
    adt, s = x.dtype, x.shape[1]
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
    updated in place; the returned dict carries ``pos + 1`` and the new
    Mamba states."""
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
        kc, vc = cache["blocks"]["attn_0"]["k"], cache["blocks"]["attn_0"]["v"]
        for i in range(cfg.n_layers):
            gp = _layer(params["blocks"], i)
            h = rmsnorm(x, gp["ln1_0"], cfg.norm_eps)
            x = x + attention_decode(gp["attn_0"], h, kc[i], vc[i], pos, cfg.rope_theta,
                                     aligned=cfg.aligned_decode)
            h2 = rmsnorm(x, gp["ln2_0"], cfg.norm_eps)
            x = x + mlp_apply(gp["mlp_0"], h2, cfg.mlp)
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
