"""phi3-mini-3.8b [dense] — RoPE SwiGLU, full MHA (kv == heads).

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064 [arXiv:2404.14219;
unverified].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab=32_064,
    mlp="swiglu",
    rope_theta=1e4,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=512
)
