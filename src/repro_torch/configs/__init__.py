"""Architecture registry: the 10 assigned archs (copies of ``repro.configs``).

    from repro_torch.configs import ARCHS, SMOKES, get_config, SHAPES
    cfg = get_config("glm4-9b")

Widths are copied letter for letter from ``repro.configs``, as is
``shapes.py``.
"""
from __future__ import annotations

from repro_torch.configs import (
    dbrx_132b,
    glm4_9b,
    llama32_vision_11b,
    llama4_maverick_400b_a17b,
    mamba2_130m,
    nemotron4_15b,
    nemotron4_340b,
    phi3_mini_3_8b,
    seamless_m4t_large_v2,
    zamba2_1_2b,
)
from repro_torch.configs.shapes import SHAPES, Workload, applicable, cells  # noqa: F401
from repro_torch.models.config import ModelConfig

_MODULES = [
    llama4_maverick_400b_a17b,
    dbrx_132b,
    mamba2_130m,
    glm4_9b,
    nemotron4_15b,
    nemotron4_340b,
    phi3_mini_3_8b,
    zamba2_1_2b,
    llama32_vision_11b,
    seamless_m4t_large_v2,
]

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES: dict[str, ModelConfig] = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; options: {sorted(ARCHS)}") from None
