"""Model facade: one object per architecture with a uniform train and serve API.

    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    loss, metrics = model.loss(params, {"tokens": tokens, "labels": labels})
    hidden = model.forward(params, tokens)      # img=... (vlm), frames=... (encdec)
    cache = model.init_cache(batch, s_max)
    logits, cache1 = model.prefill(params, {"tokens": tokens}, s_max=s_max)
    logits, cache = model.decode_step(params, cache, tokens)
    shapes = model.param_shapes()               # meta tensors (the dry run)

Port of ``repro.models.registry`` for all six families (dense, moe, ssm,
hybrid, vlm, encdec) and padded heads.  A vlm prefill takes the request's
image embeddings as ``batch["img_embed"]`` [B, n_img, D], an encdec
prefill its source frames as ``batch["frames"]`` [B, S_src, D]; a train
batch carries them beside its tokens and labels.  ``loss`` and ``forward``
cover all six families.  Every entry point runs on CUDA unless a device is
named (``device="cpu"`` in tests).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import default_device
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

__all__ = ["Model", "build_model"]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator | None = None, device=None) -> Any:
        """Seeded random params on ``device`` (default: CUDA).  Without a
        generator, one seeded with 0 on that device."""
        device = default_device(device)
        if generator is None and device.type != "meta":  # meta draws nothing
            generator = torch.Generator(device=device).manual_seed(0)
        if self.cfg.family == "encdec":
            return ed.init_encdec(self.cfg, generator, device)
        return tf.init_lm(self.cfg, generator, device)

    def param_shapes(self) -> Any:
        """The params' tree as ``meta`` tensors (no memory, no draws)."""
        return self.init(device="meta")

    # ---- training -------------------------------------------------------
    def loss(self, params, batch: dict):
        """(loss, metrics) of a batch {"tokens", "labels"} [B, S], with
        "img_embed" (vlm) or "frames" (encdec); the train objective (chunked
        CE, plus 0.01 x the MoE aux loss).  Takes the params as they are: a
        train step never calls :meth:`prepare`, so gradients reach the fp32
        leaves."""
        if self.cfg.family == "encdec":
            return ed.encdec_loss(params, self.cfg, batch)
        return tf.lm_loss(params, self.cfg, batch)

    def forward(self, params, tokens, **kw):
        """Final hidden states [B, S, D] in the activation dtype; ``frames``
        (encdec, required) or ``img`` (vlm) as keywords."""
        if self.cfg.family == "encdec":
            return ed.encdec_forward(params, self.cfg, kw["frames"], tokens)
        return tf.lm_forward(params, self.cfg, tokens, kw.get("img"))[0]

    # ---- serving ----------------------------------------------------------
    def prepare(self, params: Any) -> Any:
        """Params with the layer matmul weights cast to the activation dtype
        once (same bits as the per-use cast); see ``cast_matmul_weights``."""
        return tf.cast_matmul_weights(params, self.cfg)

    def init_cache(self, batch: int, s_max: int, device=None) -> Any:
        device = default_device(device)
        if self.cfg.family == "encdec":
            return ed.encdec_init_cache(self.cfg, batch, s_max, s_max, device)
        return tf.lm_init_cache(self.cfg, batch, s_max, device)

    def cache_shapes(self, batch: int, s_max: int) -> Any:
        return self.init_cache(batch, s_max, device="meta")

    def prefill(self, params, batch: dict, s_max: int | None = None,
                head_mask=None, head_kernel_mode: str | None = None, head_mesh=None,
                ssd_kernel_mode: str | None = None):
        """``ssd_kernel_mode`` is the kernel mode of every Mamba block's SSD
        (None: by device).  The encdec head is uncoded and takes no head
        arguments, as the reference's."""
        if self.cfg.family == "encdec":
            return ed.encdec_prefill(params, self.cfg, batch["frames"], batch["tokens"],
                                     s_max=s_max)
        return tf.lm_prefill(params, self.cfg, batch["tokens"], batch.get("img_embed"),
                             s_max=s_max, head_mask=head_mask,
                             head_kernel_mode=head_kernel_mode, head_mesh=head_mesh,
                             ssd_kernel_mode=ssd_kernel_mode)

    def decode_step(self, params, cache, tokens, head_mask=None,
                    head_kernel_mode: str | None = None, head_mesh=None):
        if self.cfg.family == "encdec":
            return ed.encdec_decode_step(params, self.cfg, cache, tokens)
        return tf.lm_decode_step(params, self.cfg, cache, tokens, head_mask=head_mask,
                                 head_kernel_mode=head_kernel_mode, head_mesh=head_mesh)

    # ---- dry-run input stand-ins -----------------------------------------
    def input_specs(self, kind: str, batch: int, seq: int) -> dict[str, Any]:
        """``meta`` tensors for every input of a step kind: 'train' (tokens
        and labels, int64), 'prefill' (tokens, int32) or 'decode' (one int32
        token a sequence; pair with ``cache_shapes(batch, seq)``), with
        "img_embed" [B, n_img, D] (vlm) or "frames" [B, S, D] (encdec) in
        bf16, as the reference's."""
        cfg = self.cfg
        d = cfg.d_model

        def t(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        if kind == "decode":
            return {"tokens": t((batch,), torch.int32)}
        if kind == "train":
            spec = {"tokens": t((batch, seq), torch.int64),
                    "labels": t((batch, seq), torch.int64)}
        elif kind == "prefill":
            spec = {"tokens": t((batch, seq), torch.int32)}
        else:
            raise ValueError(f"unknown step kind {kind!r}")
        if cfg.family == "vlm":
            spec["img_embed"] = t((batch, cfg.img_tokens, d), torch.bfloat16)
        if cfg.family == "encdec":
            spec["frames"] = t((batch, seq, d), torch.bfloat16)
        return spec


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)
