"""zamba2-1.2b [hybrid] — Mamba2 backbone + one *shared* attention block.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf].  The shared attn+MLP block (weights shared across
applications) fires after every 6th Mamba block; each application keeps its
own KV cache.  Sub-quadratic decode -> runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32_000,
    mlp="swiglu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
    attn_every=6,
    rope_theta=1e4,
)

SMOKE = CONFIG.scaled(
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=8,
    ssm_chunk=16,
    attn_every=2,
)
