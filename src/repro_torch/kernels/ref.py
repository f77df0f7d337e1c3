"""Plain PyTorch versions of the hand-written kernels (the ground truth in tests).

Each function is the mathematical definition, with no tiling or layout
concerns; the kernels must match these to fp32 tolerance.  The CPU path of
every wrapper runs them, and ``chip_smoke.py`` holds each kernel against
its plain version on the card.  Port of ``repro.kernels.ref``.
"""
from __future__ import annotations

import torch

__all__ = ["ref_coded_matvec_decode", "ref_gaussian_encode"]


def ref_coded_matvec_decode(
    a: torch.Tensor, x: torch.Tensor, rec: torch.Tensor
) -> torch.Tensor:
    """Fused matmul+decode: y = R · blocked(A x).

    a [n_blocks*br, M], x [M] or [M, B], rec [n_data, n_blocks] ->
    [n_data*br(, B)] fp32: the block matmul, then the recovery contraction
    over the block axis.
    """
    squeeze = x.dim() == 1
    xc = x[:, None] if squeeze else x
    n_data, nb = rec.shape
    br = a.shape[0] // nb
    yc = a.to(torch.float32) @ xc.to(torch.float32)
    y = torch.einsum("db,brc->drc", rec.to(torch.float32), yc.reshape(nb, br, -1))
    y = y.reshape(n_data * br, -1)
    return y[:, 0] if squeeze else y


def ref_gaussian_encode(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Â = G A — dense generator slice [q, r] times source [r, M]; fp32."""
    return g.to(torch.float32) @ a.to(torch.float32)
