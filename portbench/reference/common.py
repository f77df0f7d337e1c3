"""What the references share: fp32 matmuls (optionally fake-quantized, for
the lower-precision control), RMSNorm, RoPE, causal GQA attention in query
blocks, SwiGLU, and the gap of served tokens below the best logit."""
from __future__ import annotations

import contextlib
import math

import torch

F32 = torch.float32
FP8_MAX = 448.0      # largest finite float8_e4m3fn
Q_BLOCK = 1024       # query rows of one attention block


@contextlib.contextmanager
def exact_fp32():
    """fp32 matmuls without TF32 for the duration."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale for the tensor."""
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return ((t / scale).to(torch.float8_e4m3fn).to(F32)) * scale


class Precision:
    """fp32 throughout, or (``control``) fp8 where the program holds bf16:
    every layer matmul's two operands and its product, and the residual
    stream after each block, rounded through float8 e4m3 (one scale a
    tensor): the precision below the served bf16."""

    def __init__(self, control: bool = False):
        self.control = control

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as the precision holds it."""
        return fp8(x) if self.control else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., K] @ w [K, N] in fp32, w read from any dtype."""
        w = w.to(F32)
        if self.control:
            return fp8(fp8(x) @ fp8(w))
        return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.to(F32)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, hd], rotated at positions 0..S-1 by (first half, second
    half) pairs, frequency theta^(-2i/hd)."""
    s, _, hd = x.shape
    inv = theta ** (-torch.arange(0, hd, 2, dtype=F32, device=x.device) / hd)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, h: torch.Tensor, theta: float, prec: Precision) -> torch.Tensor:
    """Causal GQA self-attention of h [S, D]; weights w_q [D, H, hd], w_k,
    w_v [D, KV, hd], w_o [H, hd, D]."""
    s, d = h.shape
    n_h, hd = p["w_q"].shape[-2:]
    n_kv = p["w_k"].shape[-2]
    q = rope(prec.mm(h, p["w_q"].reshape(d, n_h * hd)).view(s, n_h, hd), theta)
    k = rope(prec.mm(h, p["w_k"].reshape(d, n_kv * hd)).view(s, n_kv, hd), theta)
    v = prec.mm(h, p["w_v"].reshape(d, n_kv * hd)).view(s, n_kv, hd)
    g = n_h // n_kv
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)          # [H, S, hd]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty((s, n_h, hd), dtype=F32, device=h.device)
    for a in range(0, s, Q_BLOCK):
        b = min(a + Q_BLOCK, s)
        qb = q[a:b].transpose(0, 1)                              # [H, q, hd]
        scores = (qb @ k[:, :b].transpose(1, 2)) / math.sqrt(hd)  # [H, q, b]
        keys = torch.arange(b, device=h.device)
        causal = keys[None, :] <= keys[a:b, None]
        scores = scores.masked_fill(~causal, float("-inf"))
        out[a:b] = (torch.softmax(scores, dim=-1) @ v[:, :b]).transpose(0, 1)
    return prec.mm(out.reshape(s, n_h * hd), p["w_o"].reshape(n_h * hd, d))


def swiglu(p: dict, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    g = prec.mm(h, p["w_gate"])
    return prec.mm(g * torch.sigmoid(g) * prec.mm(h, p["w_up"]), p["w_down"])


def logits(weights: dict, hidden: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain, uncoded LM head of the final hidden rows [n, D]: fp32
    logits [n, vocab], the head always in fp32."""
    head = weights["lm_head"] if "lm_head" in weights else weights["embed"].T
    return rmsnorm(hidden, weights["final_norm"], eps) @ head.to(F32)


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's reference logit lies below the reference's best
    at its position: [n] >= 0."""
    picked = ref_logits.gather(1, tokens[:, None].to(torch.long))[:, 0]
    return ref_logits.amax(dim=1) - picked
