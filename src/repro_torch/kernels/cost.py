"""Analytical kernel cost model: the roofline half of the autotuner.

Port of ``repro.kernels.cost``.  ``kernel_mode='auto'``
(``repro_torch.kernels.dispatch``) prices each candidate implementation of
an (op, shape) with it where the measured table has not seen the shape.
On the ``'cpu'`` backend every constructor, prior and number is the
reference's, copied: the CPU candidates (``default``, ``svd``, ``fused``
for ``coded_linear``; ``ref`` for the rest) are the plain PyTorch paths.

On ``'cuda'`` every candidate is a hand-written kernel; neither a plain
version nor a library call is ever one (the plain versions are test
oracles, as the reference never dispatches to the Pallas interpreter):

  * ``coded_linear`` — ``fused`` (the decode kernel with the DecoderCache's
    recovery matrix) and ``svd`` (the same kernel with
    ``core.coded_ops.svd_recovery``'s matrix, one launch of the
    ``masked_pinv`` kernel, priced by ``svd_us`` per unit of svd_n3 in
    place of the DecoderCache's eager ops); both inside a fused block
    (``macro_k > 1``) as out of one, since a CUDA graph holds both;
  * ``coded_matvec``, ``coded_matvec_decode``, ``gaussian_encode``,
    ``lt_encode`` — ``cuda``.

A candidate's cost is priced against a :class:`HostHardware`:

    t_us = dispatch·launches + node_us·nodes + svd_us·svd_n3
           + step_us·grid_steps + combine(flops/gemm_flops, bytes/mem_bw)

``combine`` is ``max`` where DMA overlaps compute (the H100) and ``+`` on
the CPU host.  The reference's Pallas tile choosers have no counterpart:
each kernel launches at its own plan (``thin_rows.head_plan``,
``wide_rows.wide_plan``, ``lt_encode.gaussian_plan``), so a decision on the
card carries no launch parameters.  A head kernel is one launch at any
width of x.  From ``wide_rows.WIDE_MIN_B`` columns it runs on the wide
engine, and the card's costs count what that engine adds:
- the split of x into its pieces, one more node;
- the pieces written and read once;
- the weight read once a column tile of up to 256 columns;
- the tensor cores' six bf16 products for every fp32 one.
Nor do the reference's ``fit_hardware`` and DecoderCache economics
(``recommended_max_patterns``, ``decoder_cache_worthwhile``) have one:
nothing in the port calls them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.kernels.wide_rows import GAUSSIAN_WIDE_MIN_Q as _GAUSSIAN_WIDE_MIN_Q
from repro_torch.kernels.wide_rows import MAX_TILE_COLS as _WIDE_COLS
from repro_torch.kernels.wide_rows import WIDE_MIN_B as _WIDE_MIN_B

__all__ = [
    "HostHardware",
    "CPU_HOST",
    "H100_HOST",
    "KernelCost",
    "MODEL_ERROR_FLAG",
    "MODEL_ERROR_BOUND",
    "coded_linear_costs",
    "matvec_costs",
    "matvec_decode_costs",
    "encode_costs",
    "candidate_costs",
    "predict_best",
    "preset",
    "model_error",
]

MODEL_ERROR_FLAG = 2.0    # a cell the model misses by more than this is flagged
MODEL_ERROR_BOUND = 4.0   # no committed winner may miss by more (tests, chip_smoke.py)

_F32 = 4  # bytes


@dataclass(frozen=True)
class HostHardware:
    """Calibratable execution-cost constants for one backend."""

    name: str
    gemm_flops: float    # sustained f32 dot throughput, flop/s
    mem_bw: float        # sustained memory bandwidth, bytes/s
    dispatch_us: float   # fixed per-call overhead (the launch floor)
    node_us: float       # per extra op of a call (graph size proxy)
    svd_us: float        # per unit of svd_n3 (small-SVD work)
    overlap: bool        # True: max(compute, memory) roofline; False: sum
    step_us: float = 0.5  # per grid-step overhead (the reference's Pallas grids)

    def as_dict(self) -> dict:
        return {
            "name": self.name, "gemm_flops": self.gemm_flops,
            "mem_bw": self.mem_bw, "dispatch_us": self.dispatch_us,
            "node_us": self.node_us, "svd_us": self.svd_us,
            "overlap": self.overlap, "step_us": self.step_us,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HostHardware":
        return cls(**{k: d[k] for k in (
            "name", "gemm_flops", "mem_bw", "dispatch_us", "node_us",
            "svd_us", "overlap", "step_us",
        )})


# the reference's CPU prior, copied (its jitted XLA-CPU paths)
CPU_HOST = HostHardware(
    name="cpu-host", gemm_flops=5e10, mem_bw=1.0e10,
    dispatch_us=50.0, node_us=5.0, svd_us=0.05, overlap=False,
)

# One NVIDIA H100 SXM: fp32 outside the tensor cores and HBM3 at their data
# sheet rates (67 TFLOP/s, 3.35 TB/s).  dispatch_us is one ctypes launch of
# a hand-written kernel from Python (32.7 µs), node_us one small eager torch
# op (9.8 µs), both on the host clock; svd_us prices
# core/coded_ops.py::svd_recovery (one masked_pinv launch: the float64
# Jacobi pinv of the masked generator on the card, 90.7 µs a call at
# (14, 2), its host time or its device time, the longer) per unit of
# nb * n_data^2.  All three as ``autotune.measure_host`` measured them on
# an H100 80GB HBM3 at 700 W (a table's ``meta.measured_host``; the host
# numbers vary up to 2x between machines).  Kernels have no grid-step
# cost: their grids are persistent.
H100_HOST = HostHardware(
    name="h100", gemm_flops=67e12, mem_bw=3.35e12,
    dispatch_us=32.7, node_us=9.8, svd_us=0.0289, overlap=True, step_us=0.0,
)

_PRESETS = {"cpu": CPU_HOST, "cuda": H100_HOST}


def preset(backend: str) -> HostHardware:
    """Hardware prior for a backend: ``'cpu'`` or ``'cuda'`` (the H100)."""
    try:
        return _PRESETS[backend]
    except KeyError:
        raise ValueError(f"no hardware prior for backend {backend!r}; "
                         f"options: {sorted(_PRESETS)}") from None


@dataclass(frozen=True)
class KernelCost:
    """Cost features of one candidate implementation at one shape."""

    flops: float          # dot FLOPs (FMA work)
    bytes: float          # device-memory traffic of materializing ops
    nodes: int            # materializing ops besides the call (graph size proxy)
    svd_n3: float = 0.0   # small-SVD work scale (nb * n_data^2), svd impl only
    grid_steps: int = 0   # the reference's Pallas grid size; 0 on the card

    def compute_us(self, hw: HostHardware) -> float:
        return self.flops / hw.gemm_flops * 1e6

    def memory_us(self, hw: HostHardware) -> float:
        return self.bytes / hw.mem_bw * 1e6

    def predicted_us(self, hw: HostHardware) -> float:
        c, m = self.compute_us(hw), self.memory_us(hw)
        roof = max(c, m) if hw.overlap else c + m
        return (hw.dispatch_us + hw.node_us * self.nodes
                + hw.svd_us * self.svd_n3 + hw.step_us * self.grid_steps + roof)

    def predicted_block_us(self, hw: HostHardware, k: int) -> float:
        """Cost of ``k`` fused iterations launched as one block (a CUDA
        graph on the card): the dispatch floor is paid once, the body k
        times.  ``k=1`` is exactly :meth:`predicted_us`."""
        per_iter = self.predicted_us(hw) - hw.dispatch_us
        return hw.dispatch_us + max(1, int(k)) * per_iter


def model_error(predicted_us: float, measured_us: float) -> float:
    """Symmetric ratio error: max/min of (predicted, measured), >= 1."""
    lo, hi = sorted([max(predicted_us, 1e-9), max(measured_us, 1e-9)])
    return hi / lo


# --------------------------------------------------------------------------
# per-op candidate cost constructors
# --------------------------------------------------------------------------
# eager ops of a call besides its kernel: DecoderCache.recovery's mask
# index and two gathers; lt_encode's CSR compaction.  svd_recovery has
# none: its one masked_pinv launch is priced by svd_n3
_CUDA_NODES = {"fused": 6, "lt": 10}


# the wide engine's fp32 product is six bf16 piece products on the tensor
# cores (989 TFLOP/s dense bf16 on an H100); priced at the fp32 rate
# gemm_flops holds (67 TFLOP/s), that is 6 x 67 / 989 of the fp32 work
_WIDE_FLOP_SCALE = 6 * 67e12 / 989e12


def _head_call(b: int, x_bytes: float) -> tuple[int, int, float, float]:
    """(weight reads, extra eager ops, extra bytes, flop scale) of a head
    kernel's call at x of ``b`` columns, one launch: the thin-row engine
    below WIDE_MIN_B columns reads the weight once and adds nothing; the
    wide engine reads it once a column tile, splits x in one more node and
    writes and reads the pieces (6 bytes an fp32 element of x) once."""
    if int(b) < _WIDE_MIN_B:
        return 1, 0, 0.0, 1.0
    return -(-int(b) // _WIDE_COLS), 1, 3.0 * x_bytes, _WIDE_FLOP_SCALE


def coded_linear_costs(
    out: int, inner: int, batch: int, n_data: int, n_parity: int,
    backend: str = "cpu",
) -> dict[str, KernelCost]:
    """Candidates for ``CodedLinear.apply`` at (out x inner x batch).

    On the CPU the reference's three (``default``, ``svd``, ``fused``); on
    the card the decode kernel with either recovery matrix.
    """
    nb = n_data + n_parity
    br = -(-out // n_data)
    rows = nb * br
    gemm = 2.0 * rows * inner * batch
    dec = 2.0 * n_data * nb * br * batch
    w_b = _F32 * rows * inner
    x_b = _F32 * inner * batch
    yc_b = _F32 * rows * batch
    out_b = _F32 * n_data * br * batch
    if backend == "cuda":
        reads, extra, extra_b, scale = _head_call(batch, x_b)
        fused = KernelCost(flops=scale * gemm + dec,
                           bytes=reads * w_b + x_b + out_b + _F32 * n_data * nb + extra_b,
                           nodes=_CUDA_NODES["fused"] + extra)
        return {"fused": fused,
                "svd": replace(fused, nodes=extra, svd_n3=float(nb * n_data * n_data))}
    costs = {
        # matmul -> reshape -> mask-multiply -> lut index ops -> rec gather
        # -> decode matmul -> slice: yc written, mask-mult read+write,
        # decode read — 4 passes over the coded partials
        "default": KernelCost(
            flops=gemm + dec, bytes=w_b + x_b + 4 * yc_b + out_b, nodes=14,
        ),
        # seed fallback: pinv (small SVD) + initial solve + 2 refinement
        # steps = 5 extra rec-sized matmuls' worth of passes over partials
        "svd": KernelCost(
            flops=gemm + 5.0 * dec, bytes=w_b + x_b + 6 * yc_b + out_b,
            nodes=20, svd_n3=float(nb * n_data * n_data),
        ),
        # two dots, partials round-trip exactly once
        "fused": KernelCost(
            flops=gemm + dec, bytes=w_b + x_b + 2 * yc_b + out_b, nodes=6,
        ),
    }
    return costs


def matvec_costs(r: int, m: int, b: int, backend: str = "cpu") -> dict[str, KernelCost]:
    """Candidates for the coded matvec y = A x ([r, m] x [m, b])."""
    gemm = 2.0 * r * m * b
    io = _F32 * (r * m + m * b + r * b)
    if backend == "cuda":
        reads, extra, extra_b, scale = _head_call(b, _F32 * m * b)
        return {"cuda": KernelCost(flops=scale * gemm,
                                   bytes=io + _F32 * (reads - 1) * r * m + extra_b, nodes=extra)}
    return {"ref": KernelCost(flops=gemm, bytes=io, nodes=3)}


def matvec_decode_costs(
    rows: int, m: int, b: int, n_data: int, n_blocks: int,
    backend: str = "cpu",
) -> dict[str, KernelCost]:
    """Candidates for the raw fused matmul+decode (rec already resolved)."""
    br = rows // n_blocks
    gemm = 2.0 * rows * m * b
    dec = 2.0 * n_data * n_blocks * br * b
    w_b, x_b = _F32 * rows * m, _F32 * m * b
    yc_b, out_b = _F32 * rows * b, _F32 * n_data * br * b
    if backend == "cuda":
        reads, extra, extra_b, scale = _head_call(b, x_b)
        return {"cuda": KernelCost(
            flops=scale * gemm + dec,
            bytes=reads * w_b + x_b + out_b + _F32 * n_data * n_blocks + extra_b, nodes=extra)}
    return {"ref": KernelCost(flops=gemm + dec, bytes=w_b + x_b + 2 * yc_b + out_b, nodes=5)}


def encode_costs(
    kind: str, q: int, r: int, m: int, d_max: int = 0, backend: str = "cpu",
    nnz: int | None = None,
) -> dict[str, KernelCost]:
    """Candidates for the encode kernels (dense gaussian / sparse LT).

    On the card ``gaussian_encode`` up to ``GAUSSIAN_WIDE_MIN_Q`` rows runs
    on its register engine, which reads A once a q-tile of at most 32 rows;
    above it on the tensor-core engine, which reads A once a column tile of
    up to 256 rows of G, takes six bf16 products an fp32 one and splits G
    in one more node (its pieces, 6 bytes an element, written and read
    once).  ``lt_encode`` reads each row of A it needs once (at most r of
    them: the slab engine stages a span's slab of them in shared memory
    once, the L2 engine keeps it in the L2) for ``nnz`` nonzero entries
    (default q * d_max).
    """
    if kind == "gaussian":
        gemm = 2.0 * q * r * m
        if backend == "cuda":
            if q <= _GAUSSIAN_WIDE_MIN_Q:
                reads = -(-q // 32)
                return {"cuda": KernelCost(
                    flops=gemm, bytes=_F32 * (q * r + reads * r * m + q * m), nodes=0)}
            reads, extra, extra_b, scale = _head_call(q, _F32 * q * r)
            return {"cuda": KernelCost(
                flops=scale * gemm,
                bytes=_F32 * (q * r + reads * r * m + q * m) + extra_b, nodes=extra)}
        io = _F32 * (q * r + r * m + q * m)
        return {"ref": KernelCost(flops=gemm, bytes=io, nodes=3)}
    if kind == "lt":
        if backend == "cuda":
            nz = q * max(1, d_max) if nnz is None else nnz
            return {"cuda": KernelCost(
                flops=2.0 * nz * m, bytes=_F32 * (min(r, nz) * m + q * m) + 12.0 * nz,
                nodes=_CUDA_NODES["lt"])}
        # gather + weighted accumulate: bandwidth-bound
        fma = 2.0 * q * d_max * m
        io = _F32 * (q * d_max * m + q * m + 2 * q * d_max)
        return {"ref": KernelCost(flops=fma, bytes=io, nodes=4)}
    raise ValueError(f"unknown encode kind {kind!r}")


def candidate_costs(op: str, backend: str, **geom) -> dict[str, KernelCost]:
    """Dispatch to the per-op constructor by table op name."""
    if backend not in _PRESETS:
        raise ValueError(f"unknown backend {backend!r}; options: {sorted(_PRESETS)}")
    if op == "coded_linear":
        return coded_linear_costs(
            geom["out"], geom["inner"], geom["batch"],
            geom["n_data"], geom["n_parity"], backend,
        )
    if op == "coded_matvec":
        return matvec_costs(geom["r"], geom["m"], geom["b"], backend)
    if op == "coded_matvec_decode":
        return matvec_decode_costs(
            geom["rows"], geom["m"], geom["b"],
            geom["n_data"], geom["n_blocks"], backend,
        )
    if op in ("gaussian_encode", "lt_encode"):
        return encode_costs(
            op.split("_")[0], geom["q"], geom["r"], geom["m"],
            geom.get("d_max", 0), backend, geom.get("nnz"),
        )
    raise ValueError(f"unknown op {op!r}")


def predict_best(
    op: str, backend: str, hw: HostHardware | None = None,
    macro_k: int = 1, **geom
) -> tuple[str, float, dict]:
    """Analytical winner for an unseen shape: (impl, predicted_us, params).

    On the card every candidate is a kernel at its own launch plan, so
    params are empty there as on the CPU.  ``macro_k > 1`` ranks
    candidates by the fused-block cost (:meth:`KernelCost.predicted_block_us`)
    and returns the per-iteration share (block / k); at ``macro_k=1`` both
    ranking and value are the per-call ones.
    """
    hw = hw or preset(backend)
    k = max(1, int(macro_k))
    costs = candidate_costs(op, backend, **geom)
    impl = min(costs, key=lambda c: costs[c].predicted_block_us(hw, k))
    return impl, costs[impl].predicted_block_us(hw, k) / k, {}
