"""Model facade: one object per architecture with a uniform serving API.

    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    cache = model.init_cache(batch, s_max)
    logits, cache1 = model.prefill(params, {"tokens": tokens}, s_max=s_max)
    logits, cache = model.decode_step(params, cache, tokens)

Port of ``repro.models.registry`` for the dense, ssm and hybrid families;
every entry point runs on CUDA unless a device is named (``device="cpu"``
in tests).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import default_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

__all__ = ["Model", "build_model"]

PORTED_FAMILIES = ("dense", "ssm", "hybrid")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet "
                f"(ported: {', '.join(PORTED_FAMILIES)})")
        if self.cfg.pad_heads:
            raise NotImplementedError("pad_heads is not ported yet")

    def init(self, generator: torch.Generator | None = None, device=None) -> Any:
        """Seeded random params on ``device`` (default: CUDA).  Without a
        generator, one seeded with 0 on that device."""
        device = default_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return tf.init_lm(self.cfg, generator, device)

    def prepare(self, params: Any) -> Any:
        """Params with the layer matmul weights cast to the activation dtype
        once (same bits as the per-use cast); see ``cast_matmul_weights``."""
        return tf.cast_matmul_weights(params, self.cfg)

    def init_cache(self, batch: int, s_max: int, device=None) -> Any:
        return tf.lm_init_cache(self.cfg, batch, s_max, default_device(device))

    def prefill(self, params, batch: dict, s_max: int | None = None,
                head_mask=None, head_kernel_mode: str | None = None, head_mesh=None,
                ssd_kernel_mode: str | None = None):
        """``ssd_kernel_mode`` is the kernel mode of every Mamba block's SSD
        (None: by device); the dense family has none."""
        return tf.lm_prefill(params, self.cfg, batch["tokens"], s_max=s_max,
                             head_mask=head_mask, head_kernel_mode=head_kernel_mode,
                             head_mesh=head_mesh, ssd_kernel_mode=ssd_kernel_mode)

    def decode_step(self, params, cache, tokens, head_mask=None,
                    head_kernel_mode: str | None = None, head_mesh=None):
        return tf.lm_decode_step(params, self.cfg, cache, tokens, head_mask=head_mask,
                                 head_kernel_mode=head_kernel_mode, head_mesh=head_mesh)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)
