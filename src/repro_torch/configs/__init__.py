"""Architecture registry for the configs the port serves (dense, ssm, hybrid).

    from repro_torch.configs import get_config
    cfg = get_config("glm4-9b")

Widths are copied letter for letter from ``repro.configs``; the other
families join as their model code is ported.
"""
from __future__ import annotations

from repro_torch.configs import glm4_9b, mamba2_130m, phi3_mini_3_8b, zamba2_1_2b
from repro_torch.models.config import ModelConfig

_MODULES = [glm4_9b, phi3_mini_3_8b, mamba2_130m, zamba2_1_2b]

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES: dict[str, ModelConfig] = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; options: {sorted(ARCHS)}") from None
