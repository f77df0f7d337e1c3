"""Plain fp32 reference of a dense decoder (the port's ``dense`` family):
per layer x += attn(rmsnorm(x)); x += swiglu(rmsnorm(x)); then the final
norm and the plain LM head.  Weights in the port's stacked layout
(``blocks`` with a leading layer axis, period 1)."""
from __future__ import annotations

import torch

from portbench.reference.common import F32, Precision, attention, logits, rmsnorm, swiglu


def hidden(weights: dict, cfg: dict, tokens: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The last layer's output rows [S, D] (before the final norm) of one
    sequence ``tokens`` [S]."""
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    blocks = weights["blocks"]
    x = prec.act(weights["embed"][tokens].to(F32))
    for i in range(cfg["n_layers"]):
        attn = {k: w[i] for k, w in blocks["attn_0"].items()}
        mlp = {k: w[i] for k, w in blocks["mlp_0"].items()}
        x = prec.act(x + attention(attn, rmsnorm(x, blocks["ln1_0"][i], eps), theta, prec))
        x = prec.act(x + swiglu(mlp, rmsnorm(x, blocks["ln2_0"][i], eps), prec))
    return x


def served_logits(weights: dict, cfg: dict, prompt: torch.Tensor, served: torch.Tensor,
                  prec: Precision) -> torch.Tensor:
    """Reference logits [n, vocab] at each position where one of the n
    ``served`` tokens was chosen: the prompt's last and each fed-back
    served token but the last."""
    seq = torch.cat([prompt, served[:-1]])
    h = hidden(weights, cfg, seq, prec)
    return logits(weights, h[len(prompt) - 1:], cfg["norm_eps"])
