"""Mode-switching wrappers over the hand-written kernels.

``mode``:

  * ``None`` — by the tensor's device: the kernel on a CUDA tensor, the
    plain PyTorch version on a CPU tensor;
  * ``'cuda'`` — the kernel; raises on a CPU tensor;
  * ``'off'`` — the plain version (``repro_torch.kernels.ref``), on any device.

The reference's ``'compile'`` maps to ``'cuda'`` and ``'interpret'`` to
``'off'``.  ``'auto'`` (per-shape dispatch) is not ported yet.  On a CUDA
tensor a kernel mode launches the kernel or raises: nothing falls back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.kernels import ref as _ref

__all__ = [
    "coded_matvec_decode",
    "coded_head_matvec",
    "gaussian_encode",
    "lt_encode",
    "encode_rows",
    "encode_blocks_device",
]

_MODES = {"off": "off", "interpret": "off", "cuda": "cuda", "compile": "cuda"}


def resolve_mode(mode: str | None, t: torch.Tensor) -> str:
    """'cuda' or 'off' for a requested mode and the tensor it will run on."""
    if mode is None:
        return "cuda" if t.is_cuda else "off"
    if mode == "auto":
        raise NotImplementedError("kernel mode 'auto' (per-shape dispatch) is not ported yet")
    try:
        resolved = _MODES[mode]
    except KeyError:
        raise ValueError(f"unknown kernel mode {mode!r}; options: {sorted(_MODES)}") from None
    if resolved == "cuda" and not t.is_cuda:
        raise ValueError(f"kernel mode {mode!r} needs CUDA tensors, got a tensor on {t.device}")
    return resolved


def coded_matvec_decode(a, x, rec, mode: str | None = None):
    """Fused coded block matmul + erasure decode: y = R · blocked(A x).

    ``rec`` is the mask-keyed [n_data, n_blocks] recovery matrix from
    ``repro_torch.core.decoding.DecoderCache.recovery(mask)``.
    """
    if resolve_mode(mode, a) == "off":
        return _ref.ref_coded_matvec_decode(a, x, rec)
    from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda

    return coded_matvec_decode_cuda(a, x.contiguous(), rec.contiguous())


def coded_head_matvec(
    w_coded,
    x,
    mask,
    n_data: int,
    n_parity: int,
    *,
    mesh=None,
    kernel_mode: str | None = None,
):
    """The serving coded-head matvec: w_coded [(n_data+n_parity)*br, in],
    x [in, batch], mask [n_blocks] -> y [n_data*br, batch] fp32, through
    ``CodedLinear.apply`` (single device).  The mesh-sharded head is a
    later slice."""
    if mesh is not None:
        raise NotImplementedError("the mesh-sharded coded head is not ported yet")
    from repro_torch.core.coded_ops import CodedLinear

    br = w_coded.shape[0] // (n_data + n_parity)
    cl = CodedLinear(n_data=n_data, n_parity=n_parity, out_features=n_data * br)
    return cl.apply(w_coded, x, mask, kernel_mode=kernel_mode)


def gaussian_encode(g, a, mode: str | None = None):
    """Â = G A for a dense generator slice (fp32)."""
    if resolve_mode(mode, a) == "off":
        return _ref.ref_gaussian_encode(g, a)
    from repro_torch.kernels.lt_encode import gaussian_encode_cuda

    return gaussian_encode_cuda(g.contiguous(), a.contiguous())


def lt_encode(a, indices, coeffs, mode: str | None = None):
    """Â[j] = Σ_d coeffs[j,d] · A[indices[j,d]] for a padded-sparse degree
    table (coefficient 0 = padding); fp32 [q, M]."""
    if resolve_mode(mode, a) == "off":
        return _ref.ref_lt_encode(a, indices, coeffs)
    from repro_torch.kernels.lt_encode import lt_encode_cuda

    return lt_encode_cuda(a.contiguous(), indices.contiguous(), coeffs.contiguous())


def encode_rows(a, plan, start: int, stop: int, mode: str | None = None, device=None):
    """Encode plan rows [start, stop) on a device — the reserve top-up path.

    Dense (Gaussian) plans go through ``gaussian_encode`` with the generator
    slice ``plan.coeffs[start:stop]``; LT plans through ``lt_encode`` on the
    degree-table slice.  ``a`` (numpy or a tensor) is cast to fp32, as the
    reference's ``jnp.asarray`` does with x64 off.  It runs on ``device``,
    else on ``a``'s device if ``a`` is a tensor, else on the card
    (``repro_torch.default_device``).  Returns the [stop - start, M] fp32
    coded rows on that device.
    """
    if not 0 <= start <= stop <= plan.q:
        raise ValueError(f"bad plan row range [{start}, {stop}) for q={plan.q}")
    if device is None and isinstance(a, torch.Tensor):
        dev = a.device
    else:
        dev = default_device(device)
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)

    def table(x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x[start:stop]), device=dev)

    if plan.kind == "gaussian":
        # a dense plan's coeffs ARE the generator (indices = arange(r))
        return gaussian_encode(table(plan.coeffs), a, mode)
    return lt_encode(a, table(plan.indices), table(plan.coeffs), mode)


def encode_blocks_device(w, n_data: int, n_parity: int, mode: str | None = None):
    """Block-MDS weight encode through the encode kernel.

    ``coded_ops.encode_blocks``'s einsum restructured as
    B [n_blocks, n_data] @ blocks [n_data, br*in], so a parity re-encode
    runs on the device.  w [out, in] -> [(n_data+n_parity)*br, in] fp32.
    """
    from repro_torch.core.coded_ops import _pad_rows, block_mds_generator

    out, inner = w.shape
    br = -(-out // n_data)
    blocks = _pad_rows(w.to(torch.float32), n_data * br).reshape(n_data, br * inner)
    b = block_mds_generator(n_data + n_parity, n_data, device=w.device)
    coded = gaussian_encode(b, blocks, mode)
    return coded.reshape((n_data + n_parity) * br, inner)
