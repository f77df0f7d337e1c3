"""Block-MDS coded linear layer — the paper's straggler-tolerant matvec.

The output rows of a weight matrix are split into ``n_data`` blocks and
``n_parity`` extra blocks hold random linear combinations of them, so any
``n_data`` surviving blocks recover the output with a tiny
(n_data x n_data) solve.  Erasing a block never changes a shape — only the
0/1 survivor mask — so one step program serves every erasure pattern.

PyTorch port of ``repro.core.coded_ops``: the single-device
``CodedLinear``, the mesh-sharded ``coded_block_matmul`` and the BPCC
batch/row forms.  The generator search is the reference's numpy code,
copied, so both packages encode with bit-equal generators.
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
    "bpcc_batched_matvec",
    "coded_block_matmul",
    "encode_blocks",
    "decode_blocks",
    "decode_blocks_svd",
    "row_coded_matvec",
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


def coded_block_matmul(
    mesh,
    axis: str,
    w_coded,
    x: torch.Tensor,
    mask: torch.Tensor,
    n_data: int,
    n_parity: int,
    kernel_mode: str | None = None,
) -> torch.Tensor:
    """The mesh-sharded form of ``CodedLinear.apply``, run by one
    controller over a ``repro_torch.sharding.HeadMesh``: for each code
    block, x goes to the block's device and the local product
    ``kernels.ops.coded_matvec`` runs there (the hand-written kernel on a
    CUDA tensor); the coded outputs are gathered on ``mesh.devices[0]``
    (the reference's ``all_gather``) and decoded there by
    :func:`decode_blocks` with the mask-keyed DecoderCache.  Erased blocks
    are still computed, as in the reference; the decode's zero columns
    drop them.

    ``w_coded`` is the coded head [n_blocks*br, in], or its blocks as
    ``sharding.shard_coded_head`` placed them.  A tensor is split on every
    call: free where a block's device is the weight's own, a copy
    elsewhere.  Returns y [n_data*br, batch] fp32 on ``mesh.devices[0]``.
    """
    from repro_torch.kernels.ops import coded_matvec
    from repro_torch.sharding.policy import shard_coded_head, validate_coded_head_mesh

    n_blocks = n_data + n_parity
    validate_coded_head_mesh(mesh, n_blocks, axis)
    blocks = shard_coded_head(w_coded, mesh) if isinstance(w_coded, torch.Tensor) else w_coded
    if len(blocks) != n_blocks:
        raise ValueError(f"{len(blocks)} placed blocks for a code of {n_blocks}")
    home = mesh.devices[0]
    ys = [coded_matvec(w, x.to(w.device), mode=kernel_mode).to(home) for w in blocks]
    y_all = torch.cat(ys).reshape(n_blocks, blocks[0].shape[0], -1)
    y = decode_blocks(y_all, mask.to(home), n_data, n_parity)
    return y.reshape(n_data * blocks[0].shape[0], -1)


# --------------------------------------------------------------------------
# BPCC batch streaming and the row-level coded matvec
# --------------------------------------------------------------------------
def bpcc_batched_matvec(
    a_rows: torch.Tensor, x: torch.Tensor, p: int, arrived: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One worker's BPCC loop: process ``p`` row-batches, mask by arrival.

    a_rows [l, m] (l divisible by p), x [m] or [m, b], arrived [p] 0/1 —
    which batches reached the master by the deadline.  Returns
    (y [l, ...] with unarrived batches zeroed, rows_delivered scalar).
    The reference's ``lax.scan`` over batches, as a loop.
    """
    l = a_rows.shape[0]
    if l % p != 0:
        raise ValueError(f"rows {l} not divisible by batches {p}")
    b = l // p
    arrived = arrived.to(x.dtype)
    rows = torch.zeros((), dtype=x.dtype, device=x.device)
    ys = []
    for k, batch in enumerate(a_rows.reshape(p, b, *a_rows.shape[1:])):
        ys.append((batch @ x) * arrived[k])
        rows = rows + arrived[k] * b
    return torch.cat(ys), rows


def row_coded_matvec(
    a_hat: torch.Tensor, x: torch.Tensor, g_full: torch.Tensor, row_mask: torch.Tensor
) -> torch.Tensor:
    """Fine-grained path: ŷ = Â x, recover y from the surviving rows.

    a_hat [q, m], g_full [q, r] dense Gaussian generator, row_mask [q].
    O(r²) decode — kept for fidelity and cross-validation.
    """
    from repro_torch.core.decoding import masked_pinv_decode

    y_hat = a_hat @ x
    if y_hat.dim() == 1:
        return masked_pinv_decode(g_full, y_hat[:, None], row_mask)[:, 0]
    return masked_pinv_decode(g_full, y_hat, row_mask)
