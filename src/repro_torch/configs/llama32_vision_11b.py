"""llama-3.2-vision-11b [vlm] — text decoder with gated image cross-attn.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].  Every 5th layer carries a
tanh-gated cross-attention over image embeddings.  The vision frontend is a
STUB per assignment: ``input_specs()`` supplies precomputed patch
embeddings [B, 1024, d_model].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128_256,
    mlp="swiglu",
    cross_attn_every=5,
    img_tokens=1024,
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
    cross_attn_every=2,
    img_tokens=16,
)
