"""Table-driven kernel dispatch: the ``kernel_mode='auto'`` seam.

Port of ``repro.kernels.dispatch``.  Resolution precedence:

  1. **explicit mode** — a caller passing ``'cuda'``, ``'off'`` (or
     ``'svd'`` / None at the CodedLinear level) is never overridden;
     ``'auto'`` is the only mode that consults this module;
  2. **dispatch table** — ``reports/bench/cuda/autotune.json``, written on
     the card by ``python -m repro_torch.kernels.autotune``: per (op,
     shape, dtype, backend) the measured winner (for ``coded_linear`` its
     recovery source) beside the library call's time;
  3. **analytical fallback** — shapes the table has never seen are priced
     by the cost model (``repro_torch.kernels.cost``) with the table's
     hardware constants (or the backend's prior when there is no table).

The backend is the device of the tensor the wrapper will run on: ``'cuda'``
or ``'cpu'``.  On ``'cuda'`` a decision is always a hand-written kernel at
its own launch plan (no launch parameter is chosen: none measured worth
choosing) — :meth:`DispatchTable.lookup` refuses an entry that names a
plain version, a library call or the interpreter, as the reference
refuses interpreter rows — and on ``'cpu'`` the plain PyTorch version
(what the reference's CPU rows choose).  A missing or corrupt table is
never an error: ``'auto'`` degrades to the model, which on the card ranks
only the head's two recovery sources.

Decisions are memoized per (op, shape, dtype, backend, geometry, macro_k):
an eager decode step pays one dict lookup, and a CUDA-graph capture bakes
its decision in, as the reference's trace does.  ``set_table_path(path)``
re-points the table (None restores the default); ``invalidate()`` drops
the loaded table and every memoized decision.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.kernels import cost as _cost

__all__ = [
    "Decision",
    "DispatchTable",
    "backend_of",
    "dtype_of",
    "default_table_path",
    "get_table",
    "set_table_path",
    "invalidate",
    "choose_coded_linear",
    "choose_matvec",
    "choose_matvec_decode",
    "choose_encode",
]

TABLE_VERSION = 1
TABLE_ENV = "REPRO_TORCH_AUTOTUNE_TABLE"

# the kernel candidates of each op on the card ('svd': the decode kernel
# with svd_recovery's matrix from the masked_pinv kernel); a fused block (a
# CUDA graph) holds every one
_CUDA_IMPLS = {"coded_linear": ("fused", "svd")}


def default_table_path() -> str:
    """Committed table location (env ``REPRO_TORCH_AUTOTUNE_TABLE`` overrides)."""
    env = os.environ.get(TABLE_ENV)
    if env:
        return env
    return str(Path(__file__).resolve().parents[3]
               / "reports" / "bench" / "cuda" / "autotune.json")


def backend_of(t) -> str:
    """The dispatch backend of the tensor a wrapper will run on."""
    return "cuda" if t.is_cuda else "cpu"


def dtype_of(t) -> str:
    """A tensor's dtype as the table names it ('float32')."""
    return str(t.dtype).removeprefix("torch.")


@dataclass(frozen=True)
class Decision:
    """One resolved dispatch choice."""

    op: str
    impl: str                 # 'default' | 'svd' | 'fused' | 'ref' | 'cuda'
    mode: str | None          # kernels.ops mode ('off' / 'cuda') or None
    params: dict = field(default_factory=dict)   # launch kwargs (none on either backend)
    source: str = "model"     # 'table' | 'model'
    predicted_us: float | None = None
    measured_us: float | None = None

    @property
    def kernel_mode(self) -> str | None:
        """The CodedLinear.apply kernel_mode equivalent of this decision."""
        if self.impl == "default":
            return None
        if self.impl == "svd":
            return "svd"
        return self.mode


def _kernel_impls(op: str, backend: str) -> tuple[str, ...]:
    """The impls a decision may name: on the card the op's kernels."""
    if backend != "cuda":
        return ()
    return _CUDA_IMPLS.get(op, ("cuda",))


def _impl_mode(impl: str, backend: str) -> str | None:
    """kernels.ops mode for an impl on a backend: the plain version ('off')
    on the CPU, the kernel ('cuda') on the card; None for the CodedLinear
    paths whose recovery decides ('default', 'svd')."""
    if impl in ("default", "svd"):
        return None
    return "cuda" if backend == "cuda" else "off"


class DispatchTable:
    """Parsed ``autotune.json``: entry lookup + calibrated hardware."""

    def __init__(self, doc: dict):
        self.doc = doc
        self.entries: dict[tuple, dict] = {}
        for e in doc.get("entries", []):
            key = (e["op"], e["backend"], e["shape"], e.get("dtype", "float32"))
            self.entries[key] = e
        self._hw: dict[str, _cost.HostHardware] = {}
        for backend, hw in doc.get("hardware", {}).items():
            try:
                self._hw[backend] = _cost.HostHardware.from_dict(hw)
            except (KeyError, TypeError):
                pass

    @classmethod
    def load(cls, path: str) -> "DispatchTable | None":
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if not isinstance(doc, dict) or doc.get("version") != TABLE_VERSION:
            return None
        return cls(doc)

    def hardware(self, backend: str) -> _cost.HostHardware:
        return self._hw.get(backend) or _cost.preset(backend)

    def lookup(self, op: str, backend: str, shape: str,
               dtype: str = "float32", geometry: dict | None = None) -> dict | None:
        """The entry for this cell as a winner this backend may run, or
        None.  An interpreter entry is never dispatched, and on ``'cuda'``
        an entry whose impl or mode is not a kernel is refused."""
        e = self.entries.get((op, backend, shape, dtype))
        if e is None:
            return None
        if geometry:
            eg = e.get("geometry", {})
            if any(eg.get(k) != v for k, v in geometry.items()):
                return None
        if e.get("mode") == "interpret":  # never dispatch to the interpreter
            return None
        if backend == "cuda" and (e.get("impl") not in _kernel_impls(op, backend)
                                  or e.get("mode") != "cuda"):
            return None
        return e


_lock = threading.Lock()
_table_path: str | None = None
_table: DispatchTable | None = None
_loaded = False
_memo: dict[tuple, Decision] = {}


def set_table_path(path: str | None) -> None:
    """Point the singleton at ``path`` (None = back to the default)."""
    global _table_path
    with _lock:
        _table_path = path
    invalidate()


def invalidate() -> None:
    """Drop the loaded table and every memoized decision (reloaded lazily)."""
    global _table, _loaded
    with _lock:
        _table, _loaded = None, False
        _memo.clear()


def get_table() -> DispatchTable | None:
    global _table, _loaded
    with _lock:
        if not _loaded:
            _table = DispatchTable.load(_table_path or default_table_path())
            _loaded = True
        return _table


def _resolve(op: str, shape: str, geometry: dict | None,
             dtype: str, backend: str, macro_k: int = 1,
             **geom) -> Decision:
    macro_k = max(1, int(macro_k))
    key = (op, shape, dtype, backend, tuple(sorted((geometry or {}).items())), macro_k)
    d = _memo.get(key)
    if d is not None:
        return d
    table = get_table()
    d = None
    if table is not None:
        e = table.lookup(op, backend, shape, dtype, geometry)
        if e is not None:
            # table rows are measured per-call winners; the macro-step
            # amortization only adjusts the analytical fallback below
            d = Decision(
                op=op, impl=e["impl"],
                mode=e.get("mode") or _impl_mode(e["impl"], backend),
                params=dict(e.get("params", {})), source="table",
                predicted_us=e.get("predicted_us"), measured_us=e.get("us"),
            )
        hw = table.hardware(backend)
    else:
        hw = _cost.preset(backend)
    if d is None:
        impl, predicted, params = _cost.predict_best(
            op, backend, hw, macro_k=macro_k, **geom
        )
        d = Decision(op=op, impl=impl, mode=_impl_mode(impl, backend),
                     params=params, source="model", predicted_us=predicted)
    with _lock:
        _memo[key] = d
    return d


# --------------------------------------------------------------------------
# per-op choosers (shape keys as the reference's; ``backend`` is
# ``backend_of`` the tensor the call will run on)
# --------------------------------------------------------------------------
def choose_coded_linear(
    out: int, inner: int, batch: int, n_data: int, n_parity: int,
    dtype: str = "float32", *, backend: str, macro_k: int = 1,
) -> Decision:
    """``CodedLinear.apply`` dispatch; shape key ``outxinnerxbatch``.

    Geometries the DecoderCache refuses stay on the default path (on the
    card the kernel with ``svd_recovery``'s matrix).
    ``macro_k`` is the fused macro-step length of the enclosing block.
    """
    from repro_torch.core.decoding import cacheable

    if not cacheable(n_data, n_parity):
        return Decision(op="coded_linear", impl="default", mode=None, source="model")
    return _resolve(
        "coded_linear", f"{out}x{inner}x{batch}",
        {"n_data": n_data, "n_parity": n_parity}, dtype, backend,
        macro_k=macro_k,
        out=out, inner=inner, batch=batch, n_data=n_data, n_parity=n_parity,
    )


def choose_matvec(r: int, m: int, b: int, dtype: str = "float32", *,
                  backend: str, macro_k: int = 1) -> Decision:
    """``coded_matvec`` dispatch; shape key ``rxmxb``."""
    return _resolve("coded_matvec", f"{r}x{m}x{b}", None, dtype, backend,
                    macro_k=macro_k, r=r, m=m, b=b)


def choose_matvec_decode(
    rows: int, m: int, b: int, n_data: int, n_blocks: int,
    dtype: str = "float32", *, backend: str, macro_k: int = 1,
) -> Decision:
    """``coded_matvec_decode`` dispatch; shape key ``rowsxmxb``."""
    return _resolve(
        "coded_matvec_decode", f"{rows}x{m}x{b}",
        {"n_data": n_data, "n_blocks": n_blocks}, dtype, backend,
        macro_k=macro_k,
        rows=rows, m=m, b=b, n_data=n_data, n_blocks=n_blocks,
    )


def choose_encode(kind: str, q: int, r: int, m: int, d_max: int = 0,
                  dtype: str = "float32", *, backend: str) -> Decision:
    """Encode-kernel dispatch (``gaussian_encode`` / ``lt_encode``);
    shape key ``qxrxm``."""
    op = f"{kind}_encode"
    return _resolve(op, f"{q}x{r}x{m}", None, dtype, backend,
                    q=q, r=r, m=m, d_max=d_max)
