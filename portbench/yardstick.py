"""The yardstick: the chip's peaks, the model FLOPs of served tokens and
each hand-written kernel's operations and bytes, frozen here so that a
change to the program does not move them.  The same work is counted
whatever implements it.

Peaks of one NVIDIA H100 SXM (the data sheet's dense rates): 989e12
operations a second, whatever the dtype (so no implementation, the
3 x bf16 fp32 engines included, reads over 100 %), and 3.35e12 bytes a
second of HBM.  A kernel's bound is the larger of its bytes (each input
byte read once, each output byte written once) over the bandwidth and its
operations over the operation rate.

Model FLOPs (``step_mfu``): 2 x the matmul weights a token passes through
(the LM head's vocabulary rows, not the embedding gather; the hybrid's
shared block once per application), causal attention over the context
actually held, and the SSD's recurrent form (4 H P N a token and Mamba
block).  A prefill computes the LM head for its last position only, as the
program does.  This corrects ``repro_torch/launch/dryrun.py::model_flops``,
which counts the embedding as matmul work, the hybrid's shared block once
and prefill attention in every block of a hybrid without causal halving.
"""
from __future__ import annotations

PEAK_OPS = 989e12       # operations / s
PEAK_BYTES = 3.35e12    # bytes / s


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """(the least time the chip could take, which of the two bounds it)."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---- model FLOPs ---------------------------------------------------------
def _attn_weights(cfg: dict) -> int:
    d, hd = cfg["d_model"], cfg["head_dim"]
    return 2 * d * cfg["n_heads"] * hd + 2 * d * cfg["n_kv_heads"] * hd


def _mlp_weights(cfg: dict) -> int:
    return (3 if cfg["mlp"] == "swiglu" else 2) * cfg["d_model"] * cfg["d_ff"]


def _mamba_weights(cfg: dict) -> int:
    d = cfg["d_model"]
    d_in = cfg["ssm_expand"] * d
    gn = cfg["ssm_groups"] * cfg["ssm_state"]
    n_h = d_in // cfg["ssm_head_dim"]
    conv = (d_in + 2 * gn) * cfg["conv_width"]
    return d * (2 * d_in + 2 * gn + n_h) + conv + d_in * d


def _attn_layers(cfg: dict) -> int:
    """Attention applications a token passes through."""
    if cfg["family"] == "hybrid":
        return cfg["n_layers"] // cfg["attn_every"]
    return cfg["n_layers"]


def token_matmul_weights(cfg: dict) -> int:
    """Matmul weights one token passes through below the LM head."""
    if cfg["family"] == "dense":
        return cfg["n_layers"] * (_attn_weights(cfg) + _mlp_weights(cfg))
    if cfg["family"] == "hybrid":
        return (cfg["n_layers"] * _mamba_weights(cfg)
                + _attn_layers(cfg) * (_attn_weights(cfg) + _mlp_weights(cfg)))
    raise ValueError(f"no FLOP count for family {cfg['family']!r}")


def _ssd_token(cfg: dict) -> int:
    if cfg["family"] != "hybrid":
        return 0
    d_in = cfg["ssm_expand"] * cfg["d_model"]
    n_h = d_in // cfg["ssm_head_dim"]
    return cfg["n_layers"] * 4 * n_h * cfg["ssm_head_dim"] * cfg["ssm_state"]


def head_flops(cfg: dict) -> int:
    return 2 * cfg["d_model"] * cfg["vocab"]


def prefill_flops(cfg: dict, s: int) -> float:
    """A prefill of ``s`` tokens: every position's layers, causal attention
    (position i attends i + 1 keys), the LM head once."""
    per_key = 4 * cfg["n_heads"] * cfg["head_dim"] * _attn_layers(cfg)
    return (s * (2 * token_matmul_weights(cfg) + _ssd_token(cfg))
            + per_key * s * (s + 1) / 2 + head_flops(cfg))


def decode_flops(cfg: dict, context: int) -> float:
    """One decoded token whose input sits at position ``context - 1``
    (attending ``context`` keys), the LM head included."""
    per_key = 4 * cfg["n_heads"] * cfg["head_dim"] * _attn_layers(cfg)
    return 2 * token_matmul_weights(cfg) + _ssd_token(cfg) + per_key * context + head_flops(cfg)


def request_flops(cfg: dict, prompt_len: int, served: int) -> float:
    """The model FLOPs of a request's prefill and its ``served`` - 1
    decoded tokens (the prefill gives the first)."""
    if served < 1:
        return 0.0
    total = prefill_flops(cfg, prompt_len)
    for j in range(1, served):
        total += decode_flops(cfg, prompt_len + j)
    return total


# ---- kernels -------------------------------------------------------------
def coded_matvec_decode(n_data: int, n_blocks: int, block_rows: int, m: int, b: int):
    """B2: y [n_data*br, B] = R . blocked(W_c x), W_c [n_blocks*br, m] fp32,
    x [m, B] fp32.  The work that these inputs need: the n_data blocks a
    decode reads (the erased or surplus ones are not needed), their
    products with x and the decode's combination."""
    rows = n_data * block_rows
    ops = 2.0 * rows * m * b + 2.0 * n_data * rows * b
    nbytes = 4.0 * (rows * m + m * b + rows * b + n_data * n_blocks)
    return ops, nbytes


def _causal_pairs(q: int) -> float:
    return q * (q + 1) / 2


def ssd_chunk(g: int, q: int, p: int, n: int, in_bytes: int = 2):
    """B5 over G cells: x [G, Q, P], b, c [G, Q, N] in ``in_bytes``, da
    [G, Q] fp32 in; y [G, Q, P], states [G, P, N], decay [G], cumsum
    [G, Q] fp32 out.  Operations: C B^T and its product with x over the
    causal pairs, the chunk's state."""
    ops = g * (2.0 * _causal_pairs(q) * n + 2.0 * _causal_pairs(q) * p + 2.0 * q * p * n)
    nbytes = g * (in_bytes * (q * p + 2 * q * n) + 4.0 * q
                  + 4.0 * (q * p + p * n + 1 + q))
    return ops, nbytes


def ssd_combine(g: int, q: int, p: int, n: int, in_bytes: int = 2):
    """B6 over G cells: c [G, Q, N] in ``in_bytes``, cumsum [G, Q] and the
    entering state [G, P, N] fp32 in; y_off [G, Q, P] fp32 out."""
    ops = g * 2.0 * q * n * p
    nbytes = g * (in_bytes * q * n + 4.0 * q + 4.0 * p * n + 4.0 * q * p)
    return ops, nbytes


def ssd_cells(cfg: dict, prompt_len: int) -> tuple[int, int, int, int]:
    """(G, Q, P, N) of one Mamba block's prefill SSD call at batch 1: the
    prompt zero-padded to whole chunks (Q = min(chunk, S))."""
    q = min(cfg["ssm_chunk"], prompt_len)
    s = -(-prompt_len // q) * q
    n_h = cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_head_dim"]
    return n_h * (s // q), q, cfg["ssm_head_dim"], cfg["ssm_state"]
