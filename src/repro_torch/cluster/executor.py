"""Master/worker cluster executor behind a pluggable backend seam.

Faithful to the paper's EC2/MPI implementation (§5.1):

  * the master encodes A once (LT with peeling decode, eps = 0.13, exactly
    as the paper; or dense Gaussian with LS decode), pre-distributes the
    coded row blocks to workers, then broadcasts ``x``,
  * each worker computes its batches **for real** (numpy matmul per batch)
    and returns batch k at / after the model-scheduled observed time
    ``k * b_i * rate_i`` (rate drawn once per task from the shifted
    exponential — or Weibull/Pareto — times the unexpected-straggler
    multiplier),
  * the master consumes results from a queue behind a per-worker
    WATERMARK: it drew the realized rates itself, so the full batch-arrival
    schedule is known a priori and the queue is consumed in exactly that
    merged order — the consumption order, and with it every PAYLOAD field
    (decoded result, masks, row counts), is deterministic in the seed,
    independent of transport and scheduling jitter,
  * results feed an incremental ``StreamingDecoder`` (DESIGN.md §7) as they
    arrive, so decode work overlaps waiting; as soon as the accumulated rows
    reach the recovery threshold the master signals workers to stop (paper:
    "worker nodes will stop execution once the master node receives
    sufficient amount of results") and runs only the cheap residual decode,
  * completion time = arrival of the last needed batch; ``t_decode`` is the
    residual (post-threshold) decode and ``t_decode_ingest`` the overlapped
    ingest work, so paper-Fig.-8-style stacked timing stays reportable
    (terminal total ≈ residual + ingest).

WHERE the workers run — and which clock stamps the arrivals — is the
backend seam (DESIGN.md §15, ``cluster/backend.py``): ``backend="model"``
(default) is the thread emulator reporting deterministic MODEL seconds (the
CI oracle); ``backend="process"`` runs workers as real OS processes over a
real IPC queue and reports WALL seconds (true arrivals, scheduling jitter,
pickling and queue cost included); ``backend="thread"`` is the wall-clock
light tier.  Payload outputs are bit-identical across backends for the same
seed (asserted in tests/test_executor_wallclock.py).

The task surface is a typed :class:`TaskSpec` (``cluster/api.py``); the
legacy kwargs call style still works through a shim that warns once.

Adaptive mode (DESIGN.md §8): ``TaskSpec(adaptive=ReallocationPolicy(),
churn=ChurnSchedule(...))`` runs the same master merge over the trajectory
of ``core.adaptive.simulate_adaptive`` — reallocation epochs evaluated on
the deterministic model-time watermark, monotone top-ups drawn from a
reserve of extra coded rows encoded up front.  With both None the task
takes the original static path, bit-identical to before.

``time_scale`` compresses emulated seconds into wall seconds so the full
paper experiment grid runs in CI; model-backend *reported* times are in
model seconds.

Copied from ``repro.cluster.executor``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.  With
``encode_mode=None`` a task never touches torch, and the tests hold its
payload bit-equal to the reference's on the same seed.  By default
(``encode_mode='device'``) and in the other device modes the whole of Â —
the static rows and, under adaptive top-ups, the reserve slice — is encoded
in one ``repro_torch.kernels.ops.encode_rows`` call on the emulator's
``device`` (the card unless the CPU is named; without a card and with no
device named it raises, and nothing falls back to the host).  Its fp32 rows
are copied straight into the host buffer Â, whose dtype stays
``np.result_type(a.dtype, np.float32)``.  The reference's device modes
encode only the reserve slice there and the static rows on the host; the
trajectory (arrivals, reallocations, rows assigned, ``t_complete``) does not
depend on the mode.  ``last_encode`` records that encode's plan, size and
times.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from contextlib import closing

import numpy as np

from repro_torch.cluster.api import TaskResult, TaskSpec
from repro_torch.cluster.backend import ExecBackend, TaskPlan, get_backend
from repro_torch.cluster.profiles import WorkerProfile
from repro_torch.cluster.straggler import StragglerPolicy
from repro_torch.core.adaptive import control_margin, simulate_adaptive
from repro_torch.core.allocation import allocate
from repro_torch.core.decoding import StreamingDecoder, ls_decode_np, peel_decode_np
from repro_torch.core.encoding import (
    EncodePlan,
    GaussianCode,
    LTCode,
    encode_matrix,
    required_rows,
)
from repro_torch.core.simulator import batch_arrival_schedule
from repro_torch.utils.prng import derive

__all__ = ["ClusterEmulator", "TaskResult", "TaskSpec"]

_LEGACY_KWARGS = (
    "p", "code", "overhead", "alloc", "streaming", "adaptive", "churn",
    "encode_mode",
)
_warned_legacy = False


def _coerce_spec(spec, kwargs) -> TaskSpec:
    """Accept TaskSpec | scheme string (+ legacy kwargs, deprecated)."""
    global _warned_legacy
    if isinstance(spec, TaskSpec):
        if kwargs:
            raise TypeError(
                f"run_task(TaskSpec, ...) takes no extra task kwargs; fold "
                f"{sorted(kwargs)} into the TaskSpec"
            )
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"expected a TaskSpec or scheme string, got {spec!r}")
    unknown = set(kwargs) - set(_LEGACY_KWARGS)
    if unknown:
        raise TypeError(f"unknown run_task option(s): {sorted(unknown)}")
    if kwargs and not _warned_legacy:
        _warned_legacy = True
        warnings.warn(
            "run_task(scheme, p=..., code=..., ...) kwargs are deprecated; "
            "pass a cluster.TaskSpec instead (this warns once)",
            DeprecationWarning,
            stacklevel=3,
        )
    return TaskSpec(scheme=spec, **kwargs)


class ClusterEmulator:
    """Master + N heterogeneous workers (emulated or wall-clock)."""

    def __init__(
        self,
        profiles: list[WorkerProfile],
        *,
        time_scale: float = 1.0,
        straggler: StragglerPolicy | None = None,
        seed: int = 0,
        device=None,
    ):
        # validated at the API boundary: zero/negative/non-finite scales
        # used to silently produce schedules where every batch "arrives"
        # at t<=0 (or never), defeating the whole event algebra
        ts = float(time_scale)
        if not np.isfinite(ts) or ts <= 0.0:
            raise ValueError(
                f"time_scale must be a finite positive number of wall "
                f"seconds per model second, got {time_scale!r}"
            )
        self.profiles = profiles
        self.time_scale = ts
        self.straggler = straggler or StragglerPolicy(prob=0.0)
        self.seed = seed
        # where a device encode (TaskSpec.encode_mode) runs: resolved by
        # repro_torch.default_device only when one is asked for — the card
        # unless the caller names another device, as the tests name the CPU
        self.device = device
        # the last task's device encode: its plan (all of Â), rows, the
        # static and reserve rows among them, nonzeros, and the seconds of
        # its copy in, encode and copy out; None when the last task ran none
        # (uncoded schemes, encode_mode=None).  The reserve slice is
        # plan.slice_rows(static_rows, rows)
        self.last_encode: dict | None = None
        self._task_counter = 0

    # -- one distributed task --------------------------------------------
    def run_task(
        self,
        a: np.ndarray,
        x: np.ndarray,
        spec: TaskSpec | str = "bpcc",
        *,
        backend: str | ExecBackend | None = None,
        **legacy_kwargs,
    ) -> TaskResult:
        """Distributed y = A x under ``spec`` (a :class:`TaskSpec`, or a
        scheme string — legacy kwargs are accepted with a one-time
        DeprecationWarning and forwarded into a TaskSpec).

        ``backend`` overrides ``spec.backend`` for this call: 'model' (the
        deterministic model-time oracle) | 'process' | 'thread' (wall-clock)
        | an ``ExecBackend`` instance — same task algebra, same decode
        trajectory, different transport and clock (DESIGN.md §15).
        """
        spec = _coerce_spec(spec, legacy_kwargs)
        if backend is not None:
            spec = dataclasses.replace(spec, backend=backend)
        be = get_backend(spec.backend)

        r, m = a.shape
        if x.shape[0] != m:
            raise ValueError(f"x has {x.shape[0]} entries, A has {m} columns")
        task_id = self._task_counter
        self._task_counter += 1
        self.last_encode = None

        # accept WorkerProfile or bare service-time models
        models = [getattr(w, "model", w) for w in self.profiles]
        alloc = spec.alloc
        if alloc is None:
            kw = {"p": spec.p} if spec.scheme == "bpcc" else {}
            # the paper's tau* analysis assumes recovery once S(t) reaches
            # the required rows; LT peeling requires r(1+eps), so Algorithm 1
            # must size loads for that target — allocating for bare r leaves
            # total_rows below the decode threshold and the master degenerates
            # to a full drain (slowest-worker completion)
            r_alloc = r
            if spec.scheme in ("bpcc", "hcmm") and spec.code == "lt":
                r_alloc = required_rows(r, "lt", spec.overhead)
            alloc = allocate(spec.scheme, r_alloc, models, **kw)

        need = required_rows(
            r, "lt" if spec.code == "lt" else "gaussian", spec.overhead
        ) if alloc.coded else r

        # ---- realized rates: service-time draw x unexpected-straggler mult
        rates = np.array(
            [
                mdl.sample_task_rate(derive(self.seed, "rate", task_id, i), 1)[0]
                for i, mdl in enumerate(models)
            ]
        )
        rates *= self.straggler.draw(len(models), derive(self.seed, "strag", task_id))

        # ---- batch-arrival schedule: static merge, or the adaptive trace
        # (reallocation epochs on the model-time watermark, DESIGN.md §8)
        adaptive, churn = spec.adaptive, spec.churn
        if adaptive is None and churn is None:
            schedule = batch_arrival_schedule(alloc, rates)
            capacity = int(alloc.total_rows)
            reallocations: list[dict] = []
        else:
            reserve = 0
            if adaptive is not None and adaptive.enabled and alloc.coded:
                reserve = int(np.ceil(adaptive.reserve_frac * alloc.total_rows))
            margin = (
                control_margin(adaptive, spec.code, spec.overhead)
                if adaptive is not None else None
            )
            trace = simulate_adaptive(
                alloc, models, rates,
                required=need,
                capacity=alloc.total_rows + reserve,
                churn=churn,
                policy=adaptive,
                required_margin=margin,
            )
            schedule = trace.events
            capacity = max(int(alloc.total_rows), trace.capacity_used)
            reallocations = trace.reallocations

        # ---- encode & distribute (pre-stored in the paper; excluded from T)
        if alloc.coded:
            plan = (
                LTCode(r, seed=derive(self.seed, "code", task_id)).plan(capacity)
                if spec.code == "lt"
                else GaussianCode(r, seed=derive(self.seed, "code", task_id)).plan(
                    capacity
                )
            )
            # interleave coded rows across workers: a contiguous split would
            # pool the systematic prefix on the first workers, skewing the
            # received-set distribution the peeling decoder sees
            perm = np.random.Generator(
                np.random.PCG64(derive(self.seed, "perm", task_id))
            ).permutation(plan.q)
            plan = EncodePlan(
                indices=plan.indices[perm], coeffs=plan.coeffs[perm],
                r=plan.r, q=plan.q, kind=plan.kind,
            )
            if spec.encode_mode is not None:
                # all of Â, the pre-distributed static rows and the reserve
                # that top-up epochs hand out, in one encode on the device
                a_hat = self._encode_device(
                    a, plan, int(alloc.total_rows), spec.encode_mode
                )
            else:
                a_hat = encode_matrix(a, plan)
        else:
            plan = None
            a_hat = a

        task_plan = TaskPlan(
            a_hat=a_hat, x=x, schedule=schedule, n_workers=len(models),
            time_scale=self.time_scale,
        )
        return self._drain(
            task_plan, be,
            r=r, plan=plan, coded=alloc.coded, need=need, capacity=capacity,
            streaming=spec.streaming, scheme=spec.scheme,
            reallocations=reallocations,
        )

    def _encode_device(
        self, a: np.ndarray, plan: EncodePlan, static_rows: int, mode: str
    ) -> np.ndarray:
        """Every plan row through ``repro_torch.kernels.ops.encode_rows`` on
        the emulator's device ('device' mode: by that device, the kernel on
        the card and the plain version on the CPU): A goes to the device
        once, one encode, and the fp32 rows come back straight into the host
        buffer Â (``np.result_type(a.dtype, np.float32)``, as the host encode
        makes it).  The copies and the encode are timed apart (each ends in a
        device sync) and recorded in ``last_encode``."""
        import torch

        from repro_torch import default_device
        from repro_torch.kernels.ops import encode_rows

        dev = default_device(self.device)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        a_hat = np.empty((plan.q, a.shape[1]), dtype=np.result_type(a.dtype, np.float32))
        t0 = time.perf_counter()
        a_dev = torch.as_tensor(a, dtype=torch.float32, device=dev)
        sync()
        t1 = time.perf_counter()
        kernel_mode = None if mode == "device" else mode  # None: by device
        rows = encode_rows(a_dev, plan, 0, plan.q, mode=kernel_mode)
        sync()
        t2 = time.perf_counter()
        del a_dev
        torch.from_numpy(a_hat).copy_(rows)
        del rows
        t3 = time.perf_counter()
        self.last_encode = {
            "mode": mode, "device": str(dev), "kind": plan.kind, "plan": plan,
            "rows": plan.q, "static_rows": static_rows,
            "reserve_rows": plan.q - static_rows,
            "nonzeros": int(np.count_nonzero(plan.coeffs)),
            "h2d_s": t1 - t0, "encode_s": t2 - t1, "d2h_s": t3 - t2,
        }
        return a_hat

    # -- master merge + decode loop (backend-agnostic) --------------------
    def _drain(
        self, task_plan: TaskPlan, be: ExecBackend, *,
        r: int, plan: EncodePlan | None, coded: bool, need: int,
        capacity: int, streaming: bool, scheme: str,
        reallocations: list[dict],
    ) -> TaskResult:
        """Consume backend events in merged order, overlap decode, RETRY
        with more rows if the erasure pattern defeats the decoder (real
        systems keep draining the network rather than declaring failure at
        r(1+eps))."""
        x, schedule = task_plan.x, task_plan.schedule
        nrhs = 1 if x.ndim == 1 else x.shape[1]
        rows_arriving = int(sum(n for _t, _w, _lo, n in schedule))
        got_rows = np.zeros(capacity, dtype=bool)
        buf = np.zeros((capacity, nrhs), dtype=np.float64)
        arrivals: list[tuple[float, int, int]] = []
        rows_seen, t_complete = 0, np.inf
        # the r(1+eps) rule of thumb can exceed what the allocation encoded
        # (tight-redundancy grids); the drain target must stay reachable —
        # under churn only the rows that will actually arrive count
        target = min(need, rows_arriving if rows_arriving else capacity)
        t_decode = 0.0
        t_ingest = 0.0
        y, ok = np.zeros((r, nrhs)), False
        decoder = (
            StreamingDecoder.for_plan(plan, nrhs)
            if (streaming and coded)
            else None
        )

        def _decode_terminal():
            """One-shot decode of everything received (streaming=False)."""
            td0 = time.perf_counter()
            if not coded:
                res = buf[:r], bool(got_rows[:r].all())
            else:
                sel = np.flatnonzero(got_rows)
                if plan.kind == "gaussian":
                    # float64 normal equations (f32 squares the condition
                    # number and visibly corrupts large r); ls_decode_np is
                    # the streaming path's one-shot reference, so the two
                    # modes agree bit-for-bit on identical received sets
                    g = plan.dense_generator()[sel]
                    yy, okk, _ = ls_decode_np(g, buf[sel])
                    res = yy, okk
                else:
                    yy, okk, _ = peel_decode_np(
                        buf[sel], plan.indices[sel], plan.coeffs[sel], r
                    )
                    res = yy, okk
            return res, time.perf_counter() - td0

        def _decode_current():
            """Decode attempt at the current received set."""
            if decoder is None:
                return _decode_terminal()
            td0 = time.perf_counter()
            yy, okk, _ = decoder.finalize()
            return (yy, okk), time.perf_counter() - td0

        rows_at_last_attempt = -1

        def _process(ev) -> bool:
            """Consume one event in merged order; True when decode succeeded."""
            nonlocal rows_seen, t_complete, target, t_decode, t_ingest, y, ok
            nonlocal rows_at_last_attempt
            t_rep, wid, lo, vals = ev
            vals2 = vals.reshape(len(vals), nrhs)
            buf[lo : lo + len(vals2)] = vals2
            got_rows[lo : lo + len(vals2)] = True
            rows_seen += len(vals2)
            arrivals.append((t_rep, wid, len(vals2)))
            if decoder is not None:
                ti0 = time.perf_counter()
                decoder.ingest(np.arange(lo, lo + len(vals2)), vals2)
                t_ingest += time.perf_counter() - ti0
                # streaming: the decoder reports EXACT decodability (LT:
                # peeling recovered all r sources; Gaussian: >= r rows), so
                # the master stops at the true "sufficient amount of
                # results" — often before the r(1+eps) rule of thumb
                if not decoder.decodable:
                    return False
            elif rows_seen < target:
                return False
            # arrival of the last needed batch: under the model backend the
            # merge order IS time order, so the max equals the current event
            # time (bit-identical to the pre-seam behaviour); wall backends
            # can deliver out of order, so the max is the honest reading
            t_complete = max(t[0] for t in arrivals)
            (yy, okk), dt_dec = _decode_current()
            t_decode += dt_dec
            y, ok = yy, okk
            rows_at_last_attempt = rows_seen
            if not ok:  # undecodable erasure pattern: drain more rows
                target = min(
                    rows_arriving, max(target + max(r // 50, 1), rows_seen + 1)
                )
            return ok

        done = False
        tw0 = time.monotonic()
        with closing(be.events(task_plan)) as events:
            for ev in events:
                if _process(ev):
                    done = True
                    break
        # leaving the ``closing`` block stops workers deterministically, so
        # t_wall covers compute + transport + teardown — the end-to-end cost
        t_wall = time.monotonic() - tw0

        if not done and rows_seen and not ok and rows_seen != rows_at_last_attempt:
            # drained without ever attempting a decode at this received set
            # (rows exhausted below target): one final attempt on everything
            (y, ok), dt_dec = _decode_current()
            t_decode += dt_dec
            if arrivals:
                t_complete = max(a_[0] for a_ in arrivals)

        y = y if x.ndim > 1 else y[:, 0]
        return TaskResult(
            y=y,
            t_complete=float(t_complete),
            t_decode=float(t_decode),
            rows_received=int(rows_seen),
            ok=bool(ok),
            scheme=scheme,
            arrivals=arrivals,
            t_decode_ingest=float(t_ingest),
            reallocations=reallocations,
            rows_assigned=int(capacity),  # initial loads + any top-ups
            backend=be.name,
            t_wall=float(t_wall) if be.wall_clock else float("nan"),
            rows_mask=got_rows.copy(),
        )
