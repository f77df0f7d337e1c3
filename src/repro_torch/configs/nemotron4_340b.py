"""nemotron-4-340b [dense] — the largest dense cell (96L, d=18432).

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000, squared-ReLU
[arXiv:2402.16819; unverified].  param_count() -> 341B; training this cell
on 256 chips requires FSDP + int8 optimizer moments (DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256_000,
    mlp="relu2",
    rope_theta=1e4,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512
)
