"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128 [arXiv:2405.21060;
unverified].  d_inner = 2*768 = 1536; head dim 48 -> 32 SSD heads (divides
the 16-wide TP axis cleanly; the reference uses headdim 64 / 24 heads —
noted in DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=48,
    ssm_groups=1,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=8,
    ssm_chunk=16,
)
