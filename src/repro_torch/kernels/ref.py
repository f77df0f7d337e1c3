"""Plain PyTorch versions of the hand-written kernels (the ground truth in tests).

Each function is the mathematical definition, with no tiling or layout
concerns; the kernels must match these to fp32 tolerance.  The CPU path of
every wrapper runs them, and ``chip_smoke.py`` holds each kernel against
its plain version on the card.  Port of ``repro.kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core.encoding import ENCODE_GATHER_BYTES

__all__ = [
    "ref_coded_matvec",
    "ref_coded_matvec_decode",
    "ref_gaussian_encode",
    "ref_lt_encode",
    "ref_masked_pinv",
    "ref_ssd_chunk",
    "ref_ssd_combine",
]


def ref_coded_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x (x may be [M] or thin [M, B]); fp32 accumulation."""
    return a.to(torch.float32) @ x.to(torch.float32)


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


def ref_lt_encode(
    a: torch.Tensor, indices: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """Â[j] = Σ_d coeffs[j,d] · A[indices[j,d]] — padded-sparse generator; fp32.

    a [r, M], indices [q, d_max], coeffs [q, d_max] (0 = padding) -> [q, M].
    The sum runs over d in table order, one table column at a time:
    out[j] += coeffs[j,d] · A[indices[j,d]], product and sum each rounded
    to fp32.  Only the rows whose entry d is nonzero are gathered, in pieces
    of at most ``ENCODE_GATHER_BYTES`` (the host encode's bound), so no
    [q, d_max, M] buffer is made; a padding entry adds nothing (0 · A[i] is
    an exact zero for finite A).
    """
    a = a.to(torch.float32)
    coeffs = coeffs.to(device=a.device, dtype=torch.float32)
    indices = indices.to(device=a.device, dtype=torch.int64)
    q, m = indices.shape[0], a.shape[1]
    out = torch.zeros((q, m), dtype=torch.float32, device=a.device)
    nonzero = coeffs != 0
    step = max(1, ENCODE_GATHER_BYTES // max(1, 4 * m))
    for d in torch.nonzero(nonzero.any(dim=0)).flatten().tolist():
        rows = torch.nonzero(nonzero[:, d]).flatten()
        for s in range(0, rows.numel(), step):
            rs = rows[s : s + step]
            out[rs] += coeffs[rs, d, None] * a[indices[rs, d]]
    return out


def ref_masked_pinv(mask: torch.Tensor, gen: torch.Tensor) -> torch.Tensor:
    """rec = pinv(diag(m) B, rtol 1e-6) · diag(m), fp32: mask [nb] or
    [M, nb], gen B [nb, n] -> [n, nb] or [M, n, nb], the pseudo-inverse
    taken in float64 (``torch.linalg.pinv``), so the erased columns are
    exactly zero and a mask with fewer than n survivors gets the least-norm
    pseudo-inverse."""
    m = mask.to(torch.float64)
    bm = gen.to(torch.float64) * m[..., :, None]
    return (torch.linalg.pinv(bm, rtol=1e-6) * m[..., None, :]).to(torch.float32)


def ref_ssd_chunk(x: torch.Tensor, da: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Intra-chunk SSD terms for every (batch*head, chunk) cell, batched.

    x  [G, Q, P]  (pre-multiplied by dt)
    da [G, Q]     (dt * A)
    b  [G, Q, N]  (head-expanded)
    c  [G, Q, N]
    returns (y_diag [G,Q,P], states [G,P,N], total_decay [G], da_cumsum [G,Q]),
    all fp32.  L_ij = exp(cum_i - cum_j) is selected to 0 above the diagonal
    (where the exponent may overflow), as ``jnp.where`` does.
    """
    f32 = torch.float32
    x, b, c = x.to(f32), b.to(f32), c.to(f32)
    cum = torch.cumsum(da.to(f32), dim=-1)                  # [G, Q]
    diff = cum[..., :, None] - cum[..., None, :]            # [G, Q, Q]
    q = x.shape[-2]
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    ell = torch.where(mask, torch.exp(diff), torch.zeros((), dtype=f32, device=x.device))
    cb = torch.einsum("gln,gsn->gls", c, b)
    y = torch.einsum("gls,gls,gsp->glp", cb, ell, x)
    decay_states = torch.exp(cum[..., -1:] - cum)           # [G, Q]
    states = torch.einsum("gsp,gs,gsn->gpn", x, decay_states, b)
    return y, states, torch.exp(cum[..., -1]), cum


def ref_ssd_combine(c: torch.Tensor, cum: torch.Tensor, states_in: torch.Tensor) -> torch.Tensor:
    """Inter-chunk output: y_off[l] = exp(cum_l) * C_l . state_in.

    c [G, Q, N], cum [G, Q], states_in [G, P, N] -> [G, Q, P] fp32."""
    f32 = torch.float32
    return torch.einsum("gln,gpn,gl->glp", c.to(f32), states_in.to(f32),
                        torch.exp(cum.to(f32)))
