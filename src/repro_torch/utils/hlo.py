"""Op-level FLOP and byte accounting of an eager program, and the roofline.

Port of ``repro.utils.hlo``.  The reference walks a compiled XLA module's
HLO text; the port makes no HLO.  Its counterpart of ``analyze_hlo`` is
:func:`analyze_ops`, which runs a function once under a
``TorchDispatchMode`` and counts every aten op it dispatches:

  * FLOPs by the formulas of torch's own ``FlopCounterMode``
    (``torch.utils.flop_counter.flop_registry``: matmuls, convolutions,
    attention), split by the dtype of the op's output, since the card's
    peak depends on it (bf16 and fp16 on the tensor cores, fp32 outside
    them; TF32 stays off);
  * bytes = Σ (operands + outputs) over every op that is not a view (an
    eager op materialises its output, as the HLO walk counts
    computation-level instructions).  An operand is counted at most at the
    size of its storage (a broadcast reads what is there); an indexed
    write in place (``index_put_``, ``index_copy_``, ...) counts its index
    and values and the rows it writes, not its whole destination;
    allocations that write nothing (``empty``) and views move nothing.

Run on ``meta`` tensors, nothing is computed or allocated; a kernel wrapper
given a meta tensor takes its plain version, as on the CPU, so the count
is of the plain program (the reference's dry run, compiling for CPU
placeholder devices, also lowers its jnp references).

Not ported: ``collective_bytes``, ``analyze_hlo``, ``_parse_computations``
and ``CollectiveStats``.  A single-process program has no collectives, so
the port reckons none: a roofline built without wire bytes reports
``collective_s`` as None.

Hardware constants: :data:`HW_H100` is the port's card (NVIDIA's data sheet
for the H100 SXM); :data:`HW_V5E` is the reference's TPU v5e, kept only so
that tests can hold :func:`roofline` to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = [
    "Hardware",
    "HW_V5E",
    "HW_H100",
    "OpCosts",
    "analyze_ops",
    "Roofline",
    "roofline",
]

@dataclass(frozen=True)
class Hardware:
    peak_flops: float     # per chip, bf16 (the tensor cores on a GPU)
    hbm_bw: float         # bytes/s per chip
    ici_bw: float         # bytes/s per link (NVLink a direction on a GPU)
    fp32_flops: float | None = None  # fp32 peak; None: the bf16 peak (the reference's)
    name: str = ""

    def peak_for(self, dtype: str) -> float:
        """The peak rate for matmuls of ``dtype`` (a name, as
        :attr:`OpCosts.flops_by_dtype` keys it): bf16 and fp16 at
        ``peak_flops``, every other type at ``fp32_flops``."""
        if dtype in ("bfloat16", "float16") or self.fp32_flops is None:
            return self.peak_flops
        return self.fp32_flops


# the reference's TPU v5e (its assignment's numbers)
HW_V5E = Hardware(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9, name="TPU v5e")

# NVIDIA H100 80GB HBM3 (SXM), 700 W, data sheet: 989 TFLOP/s dense bf16 on
# the tensor cores, 67 TFLOP/s fp32, 3.35 TB/s HBM3, NVLink 450 GB/s a direction
HW_H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9, fp32_flops=67e12,
                   name="NVIDIA H100 80GB HBM3, 700 W")


# --------------------------------------------------------------------------
# op-level accounting
# --------------------------------------------------------------------------
# allocations that write nothing, and views that torch does not mark as such
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default, torch.ops.aten._unsafe_view.default,
}

# indexed writes in place: the destination (the first operand, and the
# output, which is it) is touched only where the values land
_INDEXED_WRITES = {
    torch.ops.aten.index_put_.default, torch.ops.aten._index_put_impl_.default,
    torch.ops.aten.index_copy_.default, torch.ops.aten.index_add_.default,
    torch.ops.aten.index_fill_.int_Scalar, torch.ops.aten.index_fill_.int_Tensor,
    torch.ops.aten.scatter_.src, torch.ops.aten.scatter_.value,
    torch.ops.aten.scatter_add_.default, torch.ops.aten.scatter_reduce_.two,
}


@dataclass
class OpCosts:
    """What :func:`analyze_ops` counted in one run of a function."""

    flops: float = 0.0                                  # every counted op, all dtypes
    flops_by_dtype: dict[str, float] = field(default_factory=dict)
    hbm_bytes: float = 0.0                              # operands + outputs of non-view ops
    ops: int = 0                                        # ops that moved bytes
    outputs: Any = None                                 # what the function returned


def _tensor_bytes(t: torch.Tensor) -> int:
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):  # a tensor without storage
        return n


class _OpCounter(TorchDispatchMode):
    def __init__(self, costs: OpCosts):
        super().__init__()
        self.costs = costs
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in self.registry:
            f = float(self.registry[packet](*args, **kwargs, out_val=out))
            if f:
                outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
                dtype = str(outs[0].dtype).removeprefix("torch.") if outs else "float32"
                by = self.costs.flops_by_dtype
                by[dtype] = by.get(dtype, 0.0) + f
                self.costs.flops += f
        if func.is_view or func in _NO_TRAFFIC:
            return out
        if func in _INDEXED_WRITES:
            rest = [t for t in tree_flatten((args[1:], kwargs))[0] if isinstance(t, torch.Tensor)]
            # reads of the index and values, and the write of the values
            n = sum(_tensor_bytes(t) for t in rest) + (_tensor_bytes(rest[-1]) if rest else 0)
        else:
            n = sum(_tensor_bytes(t) for t in tree_flatten((args, kwargs, out))[0]
                    if isinstance(t, torch.Tensor))
        if n:
            self.costs.hbm_bytes += n
            self.costs.ops += 1
        return out


def analyze_ops(fn: Callable, *args, **kwargs) -> OpCosts:
    """Run ``fn(*args, **kwargs)`` once, counting its FLOPs (by dtype) and
    bytes op by op; the result is in ``.outputs``.  Give it ``meta``
    tensors to count a program of any size without computing it."""
    costs = OpCosts()
    with _OpCounter(costs):
        costs.outputs = fn(*args, **kwargs)
    return costs


# --------------------------------------------------------------------------
@dataclass
class Roofline:
    """Three-term roofline for one (per-device) program; the collective
    term is None where it was not reckoned."""

    compute_s: float
    memory_s: float
    collective_s: float | None
    flops: float
    hbm_bytes: float
    wire_bytes: float
    model_flops: float = 0.0   # analytic 6·N·D / 2·N·D useful FLOPs (per device)
    hw: Hardware = HW_H100

    def _terms(self) -> dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self._terms().values())

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much counted compute is useful."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on MFU: useful FLOPs / (this hardware's bf16 peak x
        bound-time).  The reference divides by the v5e peak whatever
        hardware it was given; the port uses its own ``hw``."""
        if self.bound_s <= 0:
            return 0.0
        return self.model_flops / (self.hw.peak_flops * self.bound_s)

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "model_flops": self.model_flops,
            "useful_fraction": self.useful_fraction,
            "mfu_bound": self.mfu_bound,
        }


def roofline(
    flops: float,
    hbm_bytes: float,
    wire_bytes: float | None,
    model_flops: float = 0.0,
    hw: Hardware = HW_H100,
    flops_by_dtype: dict[str, float] | None = None,
) -> Roofline:
    """All inputs are PER-DEVICE quantities of one step.  The compute term
    is ``flops`` over ``hw.peak_flops`` (the reference's), or with
    ``flops_by_dtype`` Σ each dtype's FLOPs over its own peak
    (:meth:`Hardware.peak_for`).  ``wire_bytes=None``: no collectives were
    reckoned, so ``collective_s`` is None and ``wire_bytes`` 0."""
    if flops_by_dtype is None:
        compute_s = flops / hw.peak_flops
    else:
        compute_s = sum(f / hw.peak_for(d) for d, f in flops_by_dtype.items())
    return Roofline(
        compute_s=compute_s,
        memory_s=hbm_bytes / hw.hbm_bw,
        collective_s=None if wire_bytes is None else wire_bytes / hw.ici_bw,
        flops=flops,
        hbm_bytes=hbm_bytes,
        wire_bytes=0.0 if wire_bytes is None else wire_bytes,
        model_flops=model_flops,
        hw=hw,
    )
