"""The executor's typed task surface: ``TaskSpec`` in, ``TaskResult`` out.

``run_task`` grew its options organically (scheme string + a drawer of
kwargs).  ``TaskSpec`` consolidates them into one validated dataclass —
construction fails fast with a clear message instead of producing a
nonsensical schedule three layers down — and ``TaskResult`` is the single
result shape for a distributed task, shared by every execution backend
(DESIGN.md §15).  Legacy call styles keep working through a deprecation
shim in ``ClusterEmulator.run_task`` (warns once, forwards here), and
legacy dict-style readers keep working through the :class:`ResultMapping`
shim (``res["t_complete"]``, ``dict(res)``).

Copied from ``repro.cluster.api``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.  The
one change is ``encode_mode``: it adds 'cuda' and 'device', defaults to
'device' (all of Â, static rows and reserve, encoded on the emulator's
device, so on the card unless the CPU is named; the reference's device modes
encode only the reserve slice there) and keeps None as the explicit host
encode; 'auto' is the per-shape dispatch of ``repro_torch.kernels.dispatch``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar

import numpy as np

from repro_torch.cluster.backend import BACKENDS, ExecBackend
from repro_torch.core.adaptive import ChurnSchedule, ReallocationPolicy
from repro_torch.core.allocation import Allocation
from repro_torch.core.results import ResultMapping

__all__ = ["TaskSpec", "TaskResult", "SCHEMES", "ENCODE_MODES"]

SCHEMES = ("uniform", "load_balanced", "hcmm", "bpcc")
# the reference's strings plus 'device' and 'cuda'; 'compile' means 'cuda'
# and 'interpret' means 'off', as in repro_torch.kernels.ops
ENCODE_MODES = ("device", None, "off", "interpret", "cuda", "compile", "auto")
CODES = ("lt", "gaussian")


@dataclass(frozen=True)
class TaskSpec:
    """One distributed coded matvec, fully specified.

    scheme      — allocation scheme: 'uniform' | 'load_balanced' | 'hcmm'
                  | 'bpcc' (Algorithm 1).
    p           — BPCC batch count (int, per-worker array, or None for the
                  p_i = ⌊ℓ̂_i⌋ default); ignored by the other schemes.
    code        — 'lt' (peeling decode, the paper's choice) | 'gaussian'
                  (dense, LS decode).
    overhead    — code overhead ε: the master targets r(1+ε) coded rows.
    alloc       — precomputed Allocation; None runs the scheme's allocator.
    streaming   — overlap decode with arrivals via StreamingDecoder (§7);
                  False keeps the one-shot terminal decode.
    adaptive    — ReallocationPolicy for epoch-boundary top-ups (§8).
    churn       — ChurnSchedule of mid-task disturbances (§8).
    encode_mode — encode of the coded rows Â, static and reserve (§9):
                  'device' (default: all of Â in one encode on the
                  emulator's device, the hand-written kernels on the card
                  and their plain versions on a named CPU) | None (host
                  numpy, the reference's default) | 'off' (the plain PyTorch
                  versions) | 'cuda' (the kernels; raises off the card) —
                  'interpret' means 'off' and 'compile' means 'cuda';
                  'auto' (per-shape dispatch: the kernel on the card,
                  the plain version on a named CPU).
    backend     — execution backend: 'model' (thread emulator, model-time,
                  the deterministic CI oracle) | 'process' (wall-clock OS
                  processes) | 'thread' (wall-clock light tier) | any
                  ExecBackend instance (§15).
    """

    scheme: str = "bpcc"
    p: int | np.ndarray | None = None
    code: str = "lt"
    overhead: float = 0.13
    alloc: Allocation | None = None
    streaming: bool = True
    adaptive: ReallocationPolicy | None = None
    churn: ChurnSchedule | None = None
    encode_mode: str | None = "device"
    backend: str | ExecBackend = "model"

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(
                f"scheme must be one of {SCHEMES}, got {self.scheme!r}"
            )
        if self.code not in CODES:
            raise ValueError(f"code must be one of {CODES}, got {self.code!r}")
        if not np.isfinite(self.overhead) or self.overhead < 0:
            raise ValueError(
                f"overhead must be finite and >= 0, got {self.overhead!r}"
            )
        if self.p is not None and not isinstance(self.p, np.ndarray):
            if not float(self.p).is_integer() or int(self.p) < 1:
                raise ValueError(
                    f"p must be a positive integer (or per-worker array), "
                    f"got {self.p!r}"
                )
        if isinstance(self.p, np.ndarray) and (np.asarray(self.p) < 1).any():
            raise ValueError("per-worker p entries must all be >= 1")
        if self.encode_mode not in ENCODE_MODES:
            raise ValueError(
                f"encode_mode must be one of {ENCODE_MODES}, "
                f"got {self.encode_mode!r}"
            )
        if self.alloc is not None and not isinstance(self.alloc, Allocation):
            raise TypeError(f"alloc must be an Allocation, got {self.alloc!r}")
        if self.adaptive is not None and not isinstance(
            self.adaptive, ReallocationPolicy
        ):
            raise TypeError(
                f"adaptive must be a ReallocationPolicy, got {self.adaptive!r}"
            )
        if self.churn is not None and not isinstance(self.churn, ChurnSchedule):
            raise TypeError(
                f"churn must be a ChurnSchedule, got {self.churn!r}"
            )
        if not isinstance(self.backend, ExecBackend) and (
            not isinstance(self.backend, str) or self.backend not in BACKENDS
        ):
            raise ValueError(
                f"backend must be one of {tuple(BACKENDS)} or an ExecBackend "
                f"instance, got {self.backend!r}"
            )


@dataclass(eq=False)
class TaskResult(ResultMapping):
    """Outcome of one distributed matvec — every backend returns this shape.

    The determinism contract (DESIGN.md §15) splits the fields:

    PAYLOAD (seed-deterministic, bit-identical across backends): ``y``,
    ``rows_received``, ``rows_mask``, ``ok``, ``scheme``, ``rows_assigned``,
    plus the non-timing projection ``arrival_order()``.

    TIMING (backend-specific clocks, never compared bitwise): ``t_complete``
    and the ``arrivals`` timestamps are MODEL seconds under the model-time
    backend and WALL seconds under wall-clock backends; ``t_decode`` /
    ``t_decode_ingest`` are always wall seconds of real decode work;
    ``t_wall`` is the end-to-end wall duration of the backend run (NaN for
    the model-time oracle, whose clock is not the claim under test).
    """

    y: np.ndarray               # recovered result [r] (or [r, nrhs])
    t_complete: float           # arrival time of the last needed batch
    t_decode: float             # wall-clock residual decode seconds (real work)
    rows_received: int          # coded rows consumed by the decoder
    ok: bool                    # decode success
    scheme: str
    arrivals: list[tuple[float, int, int]] = field(default_factory=list)
    # (t_report, worker, rows) per received batch — E[S(t)] curves (Fig 9)
    t_decode_ingest: float = 0.0  # overlapped (pre-threshold) decode seconds
    reallocations: list[dict] = field(default_factory=list)
    # adaptive mode: one record per epoch that topped up (DESIGN.md §8)
    rows_assigned: int = 0        # total coded rows assigned incl. top-ups
    backend: str = "model"        # which execution backend produced this
    t_wall: float = float("nan")  # end-to-end wall seconds (NaN: model oracle)
    rows_mask: np.ndarray | None = None
    # [rows_assigned] bool: which coded row slots the master consumed

    LEGACY_ALIASES: ClassVar[dict[str, str]] = {
        # pre-§15 readers indexed executor results with these spellings
        "T": "t_complete",
        "decode_s": "t_decode",
        "ingest_s": "t_decode_ingest",
        "rows": "rows_received",
    }
    PAYLOAD_FIELDS: ClassVar[tuple[str, ...]] = (
        "y", "rows_received", "ok", "scheme", "rows_assigned", "rows_mask",
    )
    TIMING_FIELDS: ClassVar[tuple[str, ...]] = (
        "t_complete", "t_decode", "t_decode_ingest", "t_wall",
    )

    def arrival_order(self) -> list[tuple[int, int]]:
        """(worker, rows) per consumed batch — ``arrivals`` stripped of its
        clock readings; part of the cross-backend bit-identity contract."""
        return [(w, n) for _t, w, n in self.arrivals]

    def rows_by_time(self, t_grid: np.ndarray) -> np.ndarray:
        """S(t) on a grid, from the recorded arrival events."""
        ts = np.array([a[0] for a in self.arrivals])
        rows = np.array([a[2] for a in self.arrivals])
        order = np.argsort(ts)
        ts, rows = ts[order], np.cumsum(rows[order])
        idx = np.searchsorted(ts, t_grid, side="right") - 1
        out = np.where(idx >= 0, rows[np.clip(idx, 0, None)], 0)
        return out.astype(np.float64)
