"""Mode-switching wrappers over the hand-written kernels.

``mode``:

  * ``None`` — by the tensor's device: the kernel on a CUDA tensor, the
    plain PyTorch version on a CPU tensor;
  * ``'cuda'`` — the kernel; raises on a CPU tensor;
  * ``'off'`` — the plain version (``repro_torch.kernels.ref``), on any device;
  * ``'auto'`` — per-shape dispatch (``repro_torch.kernels.dispatch``): the
    measured table, else the cost model, decides per (op, shape, dtype,
    backend); on a CUDA tensor that is always the kernel, at its own launch
    plan, and never the plain version or a library call; on a CPU tensor
    the plain version.

The reference's ``'compile'`` maps to ``'cuda'`` and ``'interpret'`` to
``'off'``.  On a CUDA tensor a kernel mode launches the kernel or raises:
nothing falls back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.kernels import ref as _ref

__all__ = [
    "coded_matvec",
    "coded_matvec_decode",
    "coded_head_matvec",
    "gaussian_encode",
    "lt_encode",
    "masked_pinv",
    "encode_rows",
    "encode_blocks_device",
    "ssd_forward",
    "SSDScan",
]

_MODES = {"off": "off", "interpret": "off", "cuda": "cuda", "compile": "cuda"}


def resolve_mode(mode: str | None, t: torch.Tensor) -> str:
    """'cuda' or 'off' for a requested mode and the tensor it will run on
    (None and 'auto': by the tensor's device)."""
    if mode is None or mode == "auto":
        return "cuda" if t.is_cuda else "off"
    try:
        resolved = _MODES[mode]
    except KeyError:
        options = sorted([*_MODES, "auto"])
        raise ValueError(f"unknown kernel mode {mode!r}; options: None, {options}") from None
    if resolved == "cuda" and not t.is_cuda:
        raise ValueError(f"kernel mode {mode!r} needs CUDA tensors, got a tensor on {t.device}")
    return resolved


def coded_matvec(a, x, mode: str | None = None):
    """y = A x for a [R, M] and x [M] or thin [M, B]; fp32 out.  The
    reference's Pallas tile knobs (``block_r``, ``block_m``) have no
    counterpart."""
    if mode == "auto":
        from repro_torch.kernels.dispatch import backend_of, choose_matvec, dtype_of
        from repro_torch.sharding.ctx import current_macro_step_k

        b = x.shape[1] if x.dim() == 2 else 1
        mode = choose_matvec(a.shape[0], a.shape[1], b, dtype_of(a), backend=backend_of(a),
                             macro_k=current_macro_step_k()).mode
    if resolve_mode(mode, a) == "off":
        return _ref.ref_coded_matvec(a, x)
    from repro_torch.kernels.coded_matvec import coded_matvec_cuda

    return coded_matvec_cuda(a, x.contiguous())


def coded_matvec_decode(a, x, rec, mode: str | None = None):
    """Fused coded block matmul + erasure decode: y = R · blocked(A x).

    ``rec`` is the mask-keyed [n_data, n_blocks] recovery matrix from
    ``repro_torch.core.decoding.DecoderCache.recovery(mask)``.
    """
    if mode == "auto":
        from repro_torch.kernels.dispatch import backend_of, choose_matvec_decode, dtype_of
        from repro_torch.sharding.ctx import current_macro_step_k

        b = x.shape[1] if x.dim() == 2 else 1
        mode = choose_matvec_decode(a.shape[0], a.shape[1], b, rec.shape[0], rec.shape[1],
                                    dtype_of(a), backend=backend_of(a),
                                    macro_k=current_macro_step_k()).mode
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
    axis: str = "model",
    kernel_mode: str | None = None,
):
    """The serving coded-head matvec: w_coded [(n_data+n_parity)*br, in],
    x [in, batch], mask [n_blocks] -> y [n_data*br, batch] fp32.

      * ``mesh`` given (a ``repro_torch.sharding.HeadMesh``) —
        ``core.coded_ops.coded_block_matmul``: one code block per device,
        the local product through :func:`coded_matvec` (the hand-written
        kernel on a CUDA tensor), a gather of the small coded outputs and
        the mask-keyed DecoderCache decode.  Erasing a device's output is
        zeroing its block in the mask.  ``w_coded`` may also be the blocks
        ``sharding.shard_coded_head`` placed once.
      * no mesh — ``CodedLinear.apply``: one fused block matmul + decode.

    ``kernel_mode='auto'`` resolves per shape (``repro_torch.kernels.dispatch``):
    per local block on the mesh, per head shape without.
    """
    from repro_torch.core.coded_ops import CodedLinear, coded_block_matmul

    if mesh is not None:
        return coded_block_matmul(mesh, axis, w_coded, x, mask, n_data, n_parity,
                                  kernel_mode=kernel_mode)
    br = w_coded.shape[0] // (n_data + n_parity)
    cl = CodedLinear(n_data=n_data, n_parity=n_parity, out_features=n_data * br)
    return cl.apply(w_coded, x, mask, kernel_mode=kernel_mode)


def gaussian_encode(g, a, mode: str | None = None):
    """Â = G A for a dense generator slice (fp32)."""
    if mode == "auto":
        from repro_torch.kernels.dispatch import backend_of, choose_encode, dtype_of

        mode = choose_encode("gaussian", g.shape[0], g.shape[1], a.shape[1],
                             dtype=dtype_of(a), backend=backend_of(a)).mode
    if resolve_mode(mode, a) == "off":
        return _ref.ref_gaussian_encode(g, a)
    from repro_torch.kernels.lt_encode import gaussian_encode_cuda

    return gaussian_encode_cuda(g.contiguous(), a.contiguous())


def lt_encode(a, indices, coeffs, mode: str | None = None):
    """Â[j] = Σ_d coeffs[j,d] · A[indices[j,d]] for a padded-sparse degree
    table (coefficient 0 = padding); fp32 [q, M]."""
    if mode == "auto":
        from repro_torch.kernels.dispatch import backend_of, choose_encode, dtype_of

        mode = choose_encode("lt", indices.shape[0], a.shape[0], a.shape[1],
                             d_max=indices.shape[1], dtype=dtype_of(a),
                             backend=backend_of(a)).mode
    if resolve_mode(mode, a) == "off":
        return _ref.ref_lt_encode(a, indices, coeffs)
    from repro_torch.kernels.lt_encode import lt_encode_cuda

    return lt_encode_cuda(a.contiguous(), indices.contiguous(), coeffs.contiguous())


def masked_pinv(mask, gen, mode: str | None = None):
    """rec = pinv(diag(m) B, rtol 1e-6) · diag(m), fp32 [n, nb] (or
    [M, n, nb] for masks [M, nb]), for the float64 generator B [nb, n] on
    the mask's device; ``'auto'`` is by device (one kernel, no shape to
    choose for)."""
    if resolve_mode(mode, mask) == "off":
        if mask.is_cuda and torch.cuda.is_current_stream_capturing():
            raise NotImplementedError(
                "masked_pinv's plain version (torch.linalg.pinv) syncs the host and cannot be "
                "captured in a CUDA graph; run the kernel (mode None, 'auto' or 'cuda')")
        return _ref.ref_masked_pinv(mask, gen)
    from repro_torch.kernels.masked_pinv import masked_pinv_cuda

    return masked_pinv_cuda(mask.to(torch.float32).contiguous(), gen.contiguous())


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


def ssd_forward(
    x: torch.Tensor,    # [B, S, H, P] (pre-multiplied by dt)
    da: torch.Tensor,   # [B, S, H]
    b: torch.Tensor,    # [B, S, G, N]
    c: torch.Tensor,    # [B, S, G, N]
    chunk: int,
    mode: str | None = None,
    h0: torch.Tensor | None = None,  # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full SSD through the chunk kernels and the inter-chunk recurrence.

    The counterpart of the reference's ``kernels.ops.ssd_forward``, equal
    to ``repro_torch.models.ssm.ssd_chunked`` (the oracle): B and C are
    expanded over heads and the inputs cut into [B*H*nc, Q, F] cells; the
    chunk kernel gives each cell's diagonal output, state and decay; a loop
    over the nc chunks carries the state into each chunk; the combine
    kernel adds what that state contributes.  S must be a multiple of
    Q = min(chunk, S).  Returns (y [B,S,H,P] in x's dtype, final state
    [B,H,P,N] fp32).
    """
    kernel = resolve_mode(mode, x) == "cuda"
    bsz, s, h, p = x.shape
    g_, n = b.shape[2], b.shape[3]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} must divide chunk {q} on the kernel path")
    nc = s // q
    rep = h // g_
    # head-expand + flatten to per-(b,h,chunk) cells
    bh = torch.repeat_interleave(b, rep, dim=2)
    ch = torch.repeat_interleave(c, rep, dim=2)

    def cells(t, feat):  # [B,S,H,F] -> [B*H*nc, Q, F]
        t = t.reshape(bsz, nc, q, h, feat).permute(0, 3, 1, 2, 4)
        return t.reshape(bsz * h * nc, q, feat).contiguous()

    xc = cells(x, p)
    bc = cells(bh, n)
    cc = cells(ch, n)
    dac = da.to(torch.float32).reshape(bsz, nc, q, h).permute(0, 3, 1, 2)
    dac = dac.reshape(bsz * h * nc, q).contiguous()

    if kernel:
        from repro_torch.kernels.ssd_scan import ssd_chunk_cuda, ssd_combine_cuda

        y, st, dec, cum = ssd_chunk_cuda(xc, dac, bc, cc)
    else:
        y, st, dec, cum = _ref.ref_ssd_chunk(xc, dac, bc, cc)

    # inter-chunk recurrence, sequential over nc: the state entering each chunk
    st_r = st.reshape(bsz * h, nc, p, n)
    dec_r = dec.reshape(bsz * h, nc)
    carry = (
        torch.zeros((bsz * h, p, n), dtype=torch.float32, device=x.device)
        if h0 is None
        else h0.reshape(bsz * h, p, n).to(torch.float32)
    )
    states_in = torch.empty_like(st_r)
    for k in range(nc):
        states_in[:, k] = carry
        carry = carry * dec_r[:, k, None, None] + st_r[:, k]
    states_in = states_in.reshape(bsz * h * nc, p, n)

    if kernel:
        y_off = ssd_combine_cuda(cc, cum, states_in)
    else:
        y_off = _ref.ref_ssd_combine(cc, cum, states_in)

    y_tot = (y + y_off).reshape(bsz, h, nc, q, p).permute(0, 2, 3, 1, 4)
    y_tot = y_tot.reshape(bsz, s, h, p).to(x.dtype)
    return y_tot, carry.reshape(bsz, h, p, n)


class SSDScan(torch.autograd.Function):
    """The full SSD under autograd: the forward is :func:`ssd_forward` (the
    hand-written ``ssd_chunk`` and ``ssd_combine`` on a CUDA tensor), the
    backward differentiates ``repro_torch.models.ssm.ssd_chunked`` — the
    einsum form the reference differentiates — recomputed at the saved
    inputs, as XLA's remat recomputes it.

        y, final = SSDScan.apply(x, da, b, c, chunk, mode)

    The kernels have no backward of their own, and they write into tensors
    with no ``grad_fn``; a train step reaches them only through here.
    """

    @staticmethod
    def forward(ctx, x, da, b, c, chunk: int, mode: str | None = None):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)   # an unused output's grad stays None
        ctx.save_for_backward(x, da, b, c)
        return ssd_forward(x, da, b, c, chunk, mode=mode)

    @staticmethod
    def backward(ctx, gy, gfinal):
        from repro_torch.models.ssm import ssd_chunked

        needs = ctx.needs_input_grad[:4]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        pairs = [(k, g) for k, g in enumerate((gy, gfinal)) if g is not None]
        if not pairs or not any(needs):
            return (None,) * 6
        with torch.enable_grad():
            outs = ssd_chunked(*inputs, ctx.chunk)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad([outs[k] for k, _ in pairs], wrt,
                                         [g for _, g in pairs], allow_unused=True))
        return (*(next(grads) if n else None for n in needs), None, None)
