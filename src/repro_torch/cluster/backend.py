"""Execution backends for the cluster executor (DESIGN.md §15).

The executor's master is split from the machinery that *runs* workers and
*delivers* their coded batches.  A backend receives a :class:`TaskPlan` —
the master's precomputed batch-arrival algebra plus the encoded rows — and
yields batch events back to the master **in the deterministic merged
schedule order** (the per-worker watermark merge, DESIGN.md §7).  Because
every backend consumes behind the same watermark, the master's decode
trajectory — which rows are ingested, in which order, where it stops — is a
pure function of the seed, independent of the transport:

  * :class:`ModelTimeBackend` — the thread emulator (the CI oracle): each
    worker computes its batches for real (numpy matmul) and returns batch k
    at its model-scheduled time; reported times are MODEL seconds.
  * :class:`ProcessBackend` — the wall-clock backend: workers run as real
    OS processes (``tier="process"``, spawn context so no jax/fork hazards)
    or in-process threads (``tier="thread"``, the light tier for small
    tasks where process startup would dominate), return batches over a real
    IPC queue, and the master stamps each batch at dequeue — reported times
    are WALL seconds including scheduling jitter, pickling, and queue cost.
    ``pace=True`` (default) makes workers sleep until their model-scheduled
    time first, reproducing the paper's §5.3.1 straggler cells on
    homogeneous CI hosts; ``pace=False`` returns batches as fast as the
    hardware computes them (true throughput mode).

This module is deliberately numpy-only (no jax import): the spawn'd worker
processes re-import it and must start in milliseconds.

Copied from ``repro.cluster.backend``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.
The tests hold the copy bit-equal to the reference on the same seeds.
"""
from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

__all__ = [
    "TaskPlan",
    "ExecBackend",
    "ModelTimeBackend",
    "ProcessBackend",
    "BACKENDS",
    "get_backend",
]

# (t_report, wid, global_row_lo, vals) — t_report is model seconds for the
# model-time backend, wall seconds since task start for wall-clock backends
Event = tuple[float, int, int, np.ndarray]

_DONE_LO = -1   # sentinel row index: worker announces it has left the task
_READY_LO = -2  # sentinel row index: worker is up (module imports done)


@dataclass
class TaskPlan:
    """Everything a backend needs to run one distributed task.

    ``schedule`` is the merged batch-arrival algebra — (t_model, worker,
    global_row_lo, n_rows) sorted by (t, wid, lo) — shared with the master:
    the master consumes events in exactly this order, whatever order the
    transport physically delivers them in.
    """

    a_hat: np.ndarray                               # encoded rows [capacity, m]
    x: np.ndarray                                   # operand [m] or [m, nrhs]
    schedule: list[tuple[float, int, int, int]]     # (t_model, wid, lo, n)
    n_workers: int
    time_scale: float = 1.0
    deadline_s: float = 600.0                       # hard wall-clock guard

    def by_worker(self) -> dict[int, list[tuple[float, int, int]]]:
        out: dict[int, list[tuple[float, int, int]]] = {}
        for t_ev, wid, lo, n in self.schedule:
            out.setdefault(wid, []).append((t_ev, lo, n))
        return out


class ExecBackend:
    """Transport seam: deliver the plan's batches in merged schedule order."""

    name = "base"
    # True: event times / t_complete are wall seconds (jitter included) and
    # must never be compared bitwise against model-time runs; False: model
    # seconds, deterministic in the seed (the determinism contract, §15)
    wall_clock = False

    def events(self, plan: TaskPlan) -> Iterator[Event]:
        raise NotImplementedError


def _watermark_merge(
    plan: TaskPlan,
    out_q,
    alive: Callable[[], bool],
    t0: float,
    stamp_wall: bool,
    done_at_start: set[int] | None = None,
) -> Iterator[Event]:
    """Consume the real queue behind the schedule watermark.

    Yields one event per schedule entry, in schedule order; late physical
    deliveries park in ``pending`` until their turn.  ``stamp_wall`` selects
    the reported time: the dequeue timestamp (wall backends — includes IPC
    and scheduling jitter) or the worker's model time (the oracle).  A
    worker that left the task (DONE sentinel) can never deliver its
    remaining scheduled batches, so the merge gives up on those keys rather
    than blocking until the deadline.
    """
    deadline = t0 + plan.deadline_s
    pending: dict[tuple[int, int], tuple[float, np.ndarray]] = {}
    done: set[int] = set(done_at_start or ())
    for _t_sched, wid, lo, _n in plan.schedule:
        key = (wid, lo)
        while key not in pending and time.monotonic() < deadline:
            if wid in done and key not in pending:
                break  # this worker already left: the batch will never come
            try:
                t_model, w_ev, lo_ev, vals = out_q.get(timeout=1.0)
            except queue_mod.Empty:
                if not alive() and _queue_empty(out_q):
                    break  # defensive: a worker died without delivering
                continue
            if lo_ev == _DONE_LO:
                done.add(w_ev)
                continue
            if lo_ev == _READY_LO:  # late READY (a worker died pre-drain)
                continue
            t_stamp = time.monotonic() - t0
            pending[(w_ev, lo_ev)] = (t_stamp if stamp_wall else t_model, vals)
        if key not in pending:
            break  # deadline / dead worker: master decodes what it has
        t_rep, vals = pending.pop(key)
        yield (t_rep, wid, lo, vals)


def _queue_empty(q) -> bool:
    try:
        return q.empty()
    except (NotImplementedError, OSError):  # exotic mp platforms
        return True


def _await_ready(out_q, workers, timeout_s: float = 120.0) -> set[int]:
    """Collect one READY per worker before the pacing epoch starts.

    Returns the wids whose DONE arrived during bootstrap (a worker that
    crashed before go) so the merge can give up on their keys immediately;
    stops early if all workers die (their READYs never come).  Batches
    cannot appear here — workers compute nothing until go is set.
    """
    ready: set[int] = set()
    done: set[int] = set()
    deadline = time.monotonic() + timeout_s
    while len(ready | done) < len(workers) and time.monotonic() < deadline:
        try:
            _t, wid, lo, _vals = out_q.get(timeout=0.2)
        except queue_mod.Empty:
            if not any(w.is_alive() for w in workers):
                break
            continue
        if lo == _READY_LO:
            ready.add(wid)
        elif lo == _DONE_LO:
            done.add(wid)
    return done


# --------------------------------------------------------------------------
# the shared worker body: real numpy matmul per batch, optional pacing
# --------------------------------------------------------------------------
def _worker_main(
    wid: int,
    events: list[tuple[float, int, int, int]],  # (t_model, lo_local, lo_global, n)
    rows: np.ndarray,                           # this worker's coded rows only
    x: np.ndarray,
    out_q,
    stop,
    go,
    t0_box,
    time_scale: float,
    pace: bool,
) -> None:
    """One worker: compute each batch for real, return it over the queue.

    Module-level (spawn-picklable) and shared verbatim by the process and
    thread tiers — the primitives (queue/event/box) duck-type across
    ``multiprocessing`` and ``threading``.  With ``pace`` the batch is held
    until its model-scheduled wall time (t0 + t_model * time_scale); the
    sleep is interruptible so the master's stop signal ends workers early
    ("stop execution once the master receives sufficient results").
    """
    try:
        # READY handshake: the master sets the pacing epoch t0 only after
        # every worker is up, so process startup (interpreter + numpy
        # import, ~seconds on small hosts) cannot skew paced arrival stamps
        out_q.put((0.0, wid, _READY_LO, None))
        go.wait()
        t0 = t0_box.value
        for t_model, lo_local, lo_global, n in events:
            if stop.is_set():
                return
            vals = rows[lo_local : lo_local + n] @ x   # the real compute
            if pace:
                delay = t0 + t_model * time_scale - time.monotonic()
                if delay > 0 and stop.wait(timeout=delay):  # interruptible
                    return
            out_q.put((t_model, wid, lo_global, vals))
    finally:
        # always announce departure so the watermark can pass this worker,
        # whatever exit path the worker took
        out_q.put((float("inf"), wid, _DONE_LO, None))


def _worker_slices(plan: TaskPlan):
    """Pre-distribution: each worker gets ONLY its own coded rows.

    Returns wid -> (events with local offsets, contiguous row array).  The
    union of slices is one copy of ``a_hat`` spread across workers — what a
    real cluster ships at distribution time — so process startup pickles
    each worker's share, not n_workers full copies.
    """
    out: dict[int, tuple[list[tuple[float, int, int, int]], np.ndarray]] = {}
    for wid, evs in plan.by_worker().items():
        parts: list[np.ndarray] = []
        local: list[tuple[float, int, int, int]] = []
        off = 0
        for t_ev, lo, n in evs:
            parts.append(plan.a_hat[lo : lo + n])
            local.append((t_ev, off, lo, n))
            off += n
        rows = np.concatenate(parts) if parts else plan.a_hat[:0]
        out[wid] = (local, rows)
    return out


class _Box:
    """Thread-tier stand-in for ``multiprocessing.Value`` (.value only)."""

    def __init__(self, value: float = 0.0):
        self.value = value


# --------------------------------------------------------------------------
# backends
# --------------------------------------------------------------------------
class ModelTimeBackend(ExecBackend):
    """The deterministic CI oracle: emulated workers as threads, reported
    times in model seconds (bit-identical in the seed, DESIGN.md §7)."""

    name = "model"
    wall_clock = False

    def events(self, plan: TaskPlan) -> Iterator[Event]:
        out_q: queue_mod.Queue = queue_mod.Queue()
        stop = threading.Event()
        go = threading.Event()
        t0_box = _Box()
        slices = _worker_slices(plan)
        threads = [
            threading.Thread(
                target=_worker_main,
                args=(wid, *slices.get(wid, ([], plan.a_hat[:0])), plan.x,
                      out_q, stop, go, t0_box, plan.time_scale, True),
                daemon=True,
            )
            for wid in range(plan.n_workers)
        ]
        for t in threads:
            t.start()
        done0 = _await_ready(out_q, threads)
        t0 = time.monotonic()
        t0_box.value = t0
        go.set()
        try:
            yield from _watermark_merge(
                plan, out_q,
                alive=lambda: any(t.is_alive() for t in threads),
                t0=t0, stamp_wall=False, done_at_start=done0,
            )
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)


class ProcessBackend(ExecBackend):
    """Wall-clock backend: real OS processes (or the thread light tier).

    Non-timing outputs are bit-identical to :class:`ModelTimeBackend` for
    the same seed (the watermark merge fixes the consumption order); timing
    outputs are true wall seconds — scheduling jitter, pickling, and IPC
    included.  ``pace=False`` drops the model-time sleeps entirely: workers
    stream batches as fast as they compute, giving the executor's true
    requests-per-second (benchmarks/executor_bench.py).
    """

    name = "process"
    wall_clock = True

    def __init__(
        self,
        *,
        pace: bool = True,
        tier: str = "process",
        mp_context: str = "spawn",
    ):
        if tier not in ("process", "thread"):
            raise ValueError(f"tier must be process|thread, got {tier!r}")
        self.pace = pace
        self.tier = tier
        self.mp_context = mp_context
        self.name = tier  # TaskResult.backend reports which tier ran

    def events(self, plan: TaskPlan) -> Iterator[Event]:
        slices = _worker_slices(plan)
        if self.tier == "thread":
            out_q: queue_mod.Queue = queue_mod.Queue()
            stop, go, t0_box = threading.Event(), threading.Event(), _Box()

            def make(args):
                return threading.Thread(target=_worker_main, args=args,
                                        daemon=True)
        else:
            ctx = mp.get_context(self.mp_context)
            out_q = ctx.Queue()
            stop, go, t0_box = ctx.Event(), ctx.Event(), ctx.Value("d", 0.0)

            def make(args):
                return ctx.Process(target=_worker_main, args=args, daemon=True)

        workers = [
            make((wid, *slices.get(wid, ([], plan.a_hat[:0])), plan.x,
                  out_q, stop, go, t0_box, plan.time_scale, self.pace))
            for wid in range(plan.n_workers)
        ]
        for w in workers:
            w.start()
        # the READY handshake sets the pacing epoch t0 only once every
        # worker has finished bootstrapping (spawned interpreter + numpy
        # import can take seconds on small hosts): without it, paced
        # arrival stamps would measure process startup, not the schedule
        done0 = _await_ready(out_q, workers)
        t0 = time.monotonic()
        t0_box.value = t0
        go.set()
        try:
            yield from _watermark_merge(
                plan, out_q,
                alive=lambda: any(w.is_alive() for w in workers),
                t0=t0, stamp_wall=True, done_at_start=done0,
            )
        finally:
            stop.set()
            # keep draining while workers wind down: batches the master no
            # longer needs are still sitting in the IPC pipe, and a child's
            # queue feeder thread blocks on the full pipe at exit — without
            # this drain every teardown eats the join timeout + terminate
            deadline = time.monotonic() + 10.0
            while any(w.is_alive() for w in workers) \
                    and time.monotonic() < deadline:
                try:
                    out_q.get(timeout=0.05)
                except queue_mod.Empty:
                    pass
            for w in workers:
                w.join(timeout=1.0)
            if self.tier == "process":
                for w in workers:
                    if w.is_alive():
                        w.terminate()
                out_q.close()


# backend registry: the string surface of ``TaskSpec.backend`` / ``--backend``
BACKENDS: dict[str, Callable[[], ExecBackend]] = {
    "model": ModelTimeBackend,
    "process": lambda: ProcessBackend(tier="process"),
    "thread": lambda: ProcessBackend(tier="thread"),
}


def get_backend(spec: "str | ExecBackend") -> ExecBackend:
    """Resolve a backend name (or pass an instance through)."""
    if isinstance(spec, ExecBackend):
        return spec
    try:
        return BACKENDS[spec]()
    except KeyError:
        raise ValueError(
            f"unknown backend {spec!r}; options: {', '.join(BACKENDS)} "
            f"(or an ExecBackend instance)"
        ) from None
