"""llama4-maverick-400b-a17b [moe] — MoE, early fusion, interleaved experts.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Interleaved MoE (every
2nd layer routed + always-on shared expert) reproduces the 400B-total /
~17B-active split:  param_count() -> (392B, 18B).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202_048,
    mlp="swiglu",
    n_experts=128,
    top_k=1,
    moe_every=2,
    shared_expert=True,
    rope_theta=5e5,
)

SMOKE = CONFIG.scaled(
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    n_experts=8,
    img_tokens=16,
)
