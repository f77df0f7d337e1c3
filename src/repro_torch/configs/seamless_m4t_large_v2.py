"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal backbone.

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596;
hf].  24 encoder + 24 decoder layers.  The speech frontend (w2v-BERT) is a
STUB per assignment: ``input_specs()`` supplies precomputed frame
embeddings [B, S_src, d_model].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256_206,
    mlp="swiglu",
    rope_theta=1e4,
)

SMOKE = CONFIG.scaled(
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
)
