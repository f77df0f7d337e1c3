"""The masked generator's pseudo-inverse, as a hand-written CUDA kernel.

``masked_pinv_cuda`` launches ``csrc/masked_pinv.cu``: for each fp32 mask
m [nb] and the float64 generator B [nb, n], rec = pinv(diag(m) B, rtol
1e-6) · diag(m) in fp32 [n, nb], by a one-sided Jacobi SVD in float64 in
one thread block, with no host read.  It replaces no TPU kernel (the
reference computes it in jnp); it is the recovery matrix of the coded-head
decodes the DecoderCache does not serve (``core.coded_ops.svd_recovery``),
so those decodes run inside a CUDA graph.  Its plain version is
``repro_torch.kernels.ref.ref_masked_pinv``; the mode-switching wrapper is
``repro_torch.kernels.ops.masked_pinv``.

The kernel's arithmetic (the sweeps, pairs in round-robin order
(:func:`round_robin`), the cutoff and the formula) is emulated in float64
torch in ``tests/test_torch_masked_pinv.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import count_launch, refuse_grad, thin_rows
from repro_torch.kernels._build import c_function

__all__ = ["MAX_SWEEPS", "masked_pinv_cuda", "round_robin", "smem_bytes"]

MAX_SWEEPS = 30        # csrc/masked_pinv.cu kMaxSweeps
MAX_WARPS = 16         # warps a block at most: one a column pair of a round


def smem_bytes(nb: int, n: int) -> int:
    """Dynamic shared memory of one block: A [n, nb], V [n, n] and
    |a_j|^2 [n], float64."""
    return 8 * (n * nb + n * n + n)


def round_robin(n: int) -> list[list[tuple[int, int]]]:
    """The kernel's pair order for n columns: n rounded up to even (np),
    np - 1 rounds of np / 2 disjoint pairs (column np - 1 stays, the others
    turn), each pair (p, q) with p < q; pairs with the padding column n of
    an odd n are left out."""
    np_ = n + (n & 1)
    turn = np_ - 1
    rounds = []
    for r in range(turn):
        pairs = []
        for k in range(np_ // 2):
            a, b = (turn, r) if k == 0 else ((r + k) % turn, (r - k + turn) % turn)
            p, q = min(a, b), max(a, b)
            if q < n:
                pairs.append((p, q))
        rounds.append(pairs)
    return rounds


def masked_pinv_cuda(mask: torch.Tensor, gen: torch.Tensor,
                     sweeps: torch.Tensor | None = None) -> torch.Tensor:
    """mask [nb] or [M, nb] fp32, gen [nb, n] float64 (n <= nb), both
    contiguous on one CUDA device -> rec [n, nb] (or [M, n, nb]) fp32.
    One launch, counted, one block a mask.  ``sweeps`` (int32 [M], or [1]
    for one mask) gets each block's sweep count."""
    refuse_grad(masked_pinv_cuda, mask, gen)
    for name, t in (("mask", mask), ("gen", gen)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mask.dtype != torch.float32:
        raise TypeError(f"mask must be float32, got {mask.dtype}")
    if gen.dtype != torch.float64:
        raise TypeError(f"gen must be float64, got {gen.dtype}")
    if gen.device != mask.device:
        raise ValueError(f"gen is on {gen.device}, mask on {mask.device}")
    if gen.dim() != 2 or mask.dim() not in (1, 2):
        raise ValueError("gen must be 2-D, mask 1-D or 2-D")
    nb, n = gen.shape
    n_masks = mask.shape[0] if mask.dim() == 2 else 1
    if mask.shape[-1] != nb:
        raise ValueError(f"mask has {mask.shape[-1]} blocks, gen has {nb} rows")
    if not 1 <= n <= nb or n_masks < 1:
        raise ValueError(f"gen [{nb}, {n}] outside 1 <= n_data <= n_blocks, or no mask")
    smem = smem_bytes(nb, n)
    if smem > thin_rows.SMEM_PER_BLOCK:
        raise ValueError(f"gen [{nb}, {n}] needs {smem} bytes of shared memory for A and V, "
                         f"over the {thin_rows.SMEM_PER_BLOCK} a block can use")
    if sweeps is not None and (sweeps.dtype != torch.int32 or sweeps.numel() != n_masks
                               or sweeps.device != mask.device or not sweeps.is_contiguous()):
        raise ValueError(f"sweeps must be a contiguous int32 [{n_masks}] on {mask.device}")
    out = torch.empty(mask.shape[:-1] + (n, nb), dtype=torch.float32, device=mask.device)
    warps = min(MAX_WARPS, max(1, (n + (n & 1)) // 2))
    err = thin_rows.call_on(mask.device, _entry(), mask.data_ptr(), gen.data_ptr(),
                            out.data_ptr(), None if sweeps is None else sweeps.data_ptr(),
                            n_masks, nb, n, 32 * warps, smem)
    count_launch(masked_pinv_cuda)
    if err != 0:
        raise RuntimeError(f"masked_pinv launch failed: cudaError {err}")
    return out


masked_pinv_cuda.launches = 0
masked_pinv_cuda.captured = 0


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return c_function("masked_pinv", "masked_pinv", [p, p, p, p, i, i, i, i, i, p])
