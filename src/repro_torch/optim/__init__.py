"""Optimizer (port of ``repro.optim``): AdamW with fp32, bf16 or int8
moments, int8 gradient-message compression with error feedback, and LR
schedules."""
from repro_torch.optim.quant import QTensor, dequantize, quantize  # noqa: F401
from repro_torch.optim.adamw import AdamWConfig, adamw_update, global_norm, init_opt_state  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    compress_leaf_,
    compress_with_feedback,
    decompress,
    init_error_state,
)
from repro_torch.optim.schedule import constant, warmup_cosine  # noqa: F401
