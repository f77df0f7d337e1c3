"""Block-MDS coded linear layer — the paper's straggler-tolerant matvec.

The output rows of a weight matrix are split into ``n_data`` blocks and
``n_parity`` extra blocks hold random linear combinations of them, so any
``n_data`` surviving blocks recover the output with a tiny
(n_data x n_data) solve.  Erasing a block never changes a shape — only the
0/1 survivor mask — so one step program serves every erasure pattern.

PyTorch port of ``repro.core.coded_ops`` (single-device part).  The
generator search is the reference's numpy code, copied, so both packages
encode with bit-equal generators.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "block_mds_generator",
    "block_mds_generator_np",
    "CodedLinear",
    "encode_blocks",
    "decode_blocks",
    "decode_blocks_svd",
    "svd_recovery",
]

_GEN_CACHE: dict[tuple[int, int], np.ndarray] = {}


def _worst_erasure_cond(b: np.ndarray, n_parity: int, max_patterns: int = 4096) -> float:
    """Worst condition number of the surviving-rows matrix over erasure
    patterns of size n_parity (exhaustive when feasible, else sampled)."""
    n_blocks = b.shape[0]
    pats = itertools.combinations(range(n_blocks), n_parity)
    g = np.random.Generator(np.random.PCG64(0))
    all_pats = list(itertools.islice(pats, max_patterns + 1))
    if len(all_pats) > max_patterns:
        all_pats = [
            tuple(g.choice(n_blocks, size=n_parity, replace=False))
            for _ in range(max_patterns)
        ]
    worst = 1.0
    for pat in all_pats:
        keep = np.ones(n_blocks, bool)
        keep[list(pat)] = False
        s = np.linalg.svd(b[keep], compute_uv=False)
        worst = max(worst, s[0] / max(s[-1], 1e-300))
    return worst


def block_mds_generator_np(
    n_blocks: int, n_data: int, n_seeds: int = 32
) -> np.ndarray:
    """Systematic generator B [n_blocks, n_data] (numpy, float64): identity
    on top, unit-norm Gaussian parity rows below.  The seed is chosen once
    per (n_blocks, n_data) by minimizing the worst surviving-submatrix
    condition number, and cached for the process lifetime."""
    if n_blocks < n_data:
        raise ValueError(f"need n_blocks >= n_data, got {n_blocks} < {n_data}")
    n_parity = n_blocks - n_data
    eye = np.eye(n_data, dtype=np.float64)
    if n_parity == 0:
        return eye
    key = (n_blocks, n_data)
    if key not in _GEN_CACHE:
        best, best_cond = None, np.inf
        for seed in range(n_seeds):
            g = np.random.Generator(np.random.PCG64(1234 + seed))
            parity = g.standard_normal((n_parity, n_data))
            parity /= np.linalg.norm(parity, axis=1, keepdims=True)
            b = np.concatenate([eye, parity], axis=0)
            c = _worst_erasure_cond(b, n_parity)
            if c < best_cond:
                best, best_cond = b, c
        _GEN_CACHE[key] = best
    return _GEN_CACHE[key]


def block_mds_generator(
    n_blocks: int, n_data: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """:func:`block_mds_generator_np` as a tensor."""
    return torch.as_tensor(block_mds_generator_np(n_blocks, n_data), dtype=dtype,
                           device=device)


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    """w [out, in] zero-padded to [rows, in] (contiguous)."""
    if w.shape[0] == rows:
        return w.contiguous()
    wp = w.new_zeros((rows, w.shape[1]))
    wp[: w.shape[0]] = w
    return wp


def encode_blocks(w: torch.Tensor, n_data: int, n_parity: int) -> torch.Tensor:
    """Encode weight rows into (n_data + n_parity) blocks.

    w [out, in] -> [n_blocks * ceil(out/n_data), in] (row-padded).  Block j
    (j >= n_data) = sum_i B[j, i] * block_i.  Done once, offline, as a plain
    einsum (the on-device re-encode is ``kernels.ops.encode_blocks_device``).
    """
    out, inner = w.shape
    br = -(-out // n_data)
    blocks = _pad_rows(w, n_data * br).reshape(n_data, br, inner)
    b = block_mds_generator(n_data + n_parity, n_data, dtype=w.dtype, device=w.device)
    coded = torch.einsum("bd,dri->bri", b, blocks)
    return coded.reshape((n_data + n_parity) * br, inner)


def _masked_flat(y_coded: torch.Tensor, mask: torch.Tensor, n_blocks: int):
    m = mask.to(torch.float32)
    flat = y_coded.to(torch.float32) * m.reshape((n_blocks,) + (1,) * (y_coded.dim() - 1))
    return m, flat.reshape(n_blocks, -1)


def decode_blocks_svd(
    y_coded: torch.Tensor, mask: torch.Tensor, n_data: int, n_parity: int
) -> torch.Tensor:
    """Reference decode: pseudo-inverse of the masked generator (rtol 1e-6)
    plus two refinement steps against the unsquared operator."""
    n_blocks = n_data + n_parity
    b = block_mds_generator(n_blocks, n_data, device=y_coded.device)
    m, flat = _masked_flat(y_coded, mask, n_blocks)
    bm = b * m[:, None]
    pinv = torch.linalg.pinv(bm, rtol=1e-6)
    sol = pinv @ flat
    for _ in range(2):
        sol = sol + pinv @ (flat - bm @ sol)
    return sol.reshape((n_data,) + tuple(y_coded.shape[1:])).to(y_coded.dtype)


def svd_recovery(mask: torch.Tensor, n_data: int, n_parity: int) -> torch.Tensor:
    """[n_data, n_blocks] fp32 recovery matrix for any mask, on its device:
    the masked generator's pseudo-inverse (rtol 1e-6), taken in float64 so
    no refinement is needed, with the erased columns exactly zero.  The
    decode of geometries the DecoderCache refuses, as a matrix the fused
    kernel takes."""
    m = mask.to(torch.float64)
    b = block_mds_generator(n_data + n_parity, n_data, dtype=torch.float64, device=mask.device)
    rec = torch.linalg.pinv(b * m[:, None], rtol=1e-6) * m[None, :]
    return rec.to(torch.float32)


def decode_blocks(
    y_coded: torch.Tensor, mask: torch.Tensor, n_data: int, n_parity: int
) -> torch.Tensor:
    """Recover the data blocks from any ``n_data`` surviving coded blocks.

    y_coded [n_blocks, br, ...] (erased entries may hold garbage); mask
    [n_blocks], 1.0 where the block survived.  The decode is the mask-keyed
    ``DecoderCache`` gather plus one small matmul; geometries too wide for
    the cache fall back to :func:`decode_blocks_svd`.
    """
    from repro_torch.core.decoding import cacheable, get_decoder_cache

    n_blocks = n_data + n_parity
    if not cacheable(n_data, n_parity):
        return decode_blocks_svd(y_coded, mask, n_data, n_parity)
    rec = get_decoder_cache(n_data, n_parity).recovery(mask)
    _, flat = _masked_flat(y_coded, mask, n_blocks)
    sol = rec @ flat
    return sol.reshape((n_data,) + tuple(y_coded.shape[1:])).to(y_coded.dtype)


@dataclass(frozen=True)
class CodedLinear:
    """A straggler-tolerant linear layer: y = W x with n_parity redundancy."""

    n_data: int
    n_parity: int
    out_features: int

    @property
    def n_blocks(self) -> int:
        return self.n_data + self.n_parity

    @property
    def block_rows(self) -> int:
        return -(-self.out_features // self.n_data)

    def encode(self, w: torch.Tensor) -> torch.Tensor:
        return encode_blocks(w, self.n_data, self.n_parity)

    def apply(
        self,
        w_coded: torch.Tensor,
        x: torch.Tensor,
        mask: torch.Tensor,
        *,
        kernel_mode: str | None = None,
    ) -> torch.Tensor:
        """x [in, batch] -> y [out, batch]; w_coded [n_blocks*br, in].

        Every mode is one fused matmul+decode
        (``kernels.ops.coded_matvec_decode``) with a [n_data, n_blocks]
        recovery matrix.  ``kernel_mode``:

          * ``None`` — by device: the hand-written kernel on a CUDA tensor,
            its plain version on a CPU tensor;
          * ``'cuda'`` (the reference's ``'compile'``) — the kernel;
          * ``'off'`` (the reference's ``'interpret'``) — the plain version;
          * ``'svd'`` — by device, with the recovery matrix taken from the
            masked generator's pseudo-inverse (:func:`svd_recovery`) instead
            of the DecoderCache.

        Geometries the DecoderCache refuses take :func:`svd_recovery` too,
        and still run the kernel on a CUDA tensor.  The plain version sums
        the block matmul, then the recovery contraction, as the reference's
        default path does.
        """
        from repro_torch.core.decoding import cacheable, get_decoder_cache
        from repro_torch.kernels.ops import coded_matvec_decode

        if kernel_mode == "svd" or not cacheable(self.n_data, self.n_parity):
            rec = svd_recovery(mask, self.n_data, self.n_parity)
        else:
            rec = get_decoder_cache(self.n_data, self.n_parity).recovery(mask)
        mode = None if kernel_mode == "svd" else kernel_mode
        return coded_matvec_decode(w_coded, x, rec, mode=mode)[: self.out_features]
