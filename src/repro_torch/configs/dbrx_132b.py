"""dbrx-132b [moe] — 16 experts top-4, fine-grained, every layer routed.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4
[hf:databricks/dbrx-base; unverified].  param_count() -> (130B, 36B).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100_352,
    mlp="swiglu",
    n_experts=16,
    top_k=4,
    moe_every=1,
    rope_theta=5e5,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    n_experts=4,
    top_k=2,
)
