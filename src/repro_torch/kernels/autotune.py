"""Measure the kernels' candidates on the card -> the dispatch table.

    python -m repro_torch.kernels.autotune [--quick] [--reps N] [--out PATH]

The counterpart of the reference's ``tools/autotune.py`` for the H100: it
times every kernel candidate of each cell (``repro_torch.kernels.cost``:
for the coded head both recovery sources, else the one kernel, each at
its own launch plan), reconciles each with the cost model's prediction
(``model_error``; a cell missed by more than ``MODEL_ERROR_FLAG`` is
flagged, and no winner may miss by more than ``MODEL_ERROR_BOUND``), and
writes the per-shape table that ``kernel_mode='auto'`` reads
(``repro_torch.kernels.dispatch``), by default
``reports/bench/cuda/autotune.json``.  The winner is the default's
candidate (the first: the head's DecoderCache recovery) unless another is
faster by more than ``TIE``.  It never writes the reference's
``reports/bench/autotune.json``.

Timing: CUDA events around a turn of back-to-back calls of one candidate
(as the engine issues them: the host launches ahead while the device
works, so a call costs its device time or its host time, whichever is
longer), the candidates of a cell in interleaved turns (the order reversed
every turn), the median turn's µs a call kept.  Beside each cell the one
PyTorch call for the same function (``torch.matmul``, ``torch.sparse.mm``)
is timed the same way as ``library_us``: a yardstick, never a candidate.  The table names the
card and its power limit (``nvidia-smi``), torch and CUDA, and the host
costs the H100 prior carries (``measured_host``: one ctypes launch, one
small eager op, one ``svd_recovery``: a ``masked_pinv`` launch).

Cells: the five coded heads (glm4-9b, mamba2-130m, zamba2-1.2b,
llama-3.2-vision-11b, dbrx-132b at (14, 2)) at B = 1 and 4, a glm4-9b code
block at B = 1 and 4, the five (13, 3) parity raises, the Gaussian task's
whole plan G [564, 500] x A [500, 500000] and the LT task's reserve slice
(paper §5.1 scenario 1, its table from a run at m = 8 on the CPU: the task
runs in model time, so the table does not depend on m).  ``--quick``: the
glm4-9b head, block and raise at B = 4.  ``--ops gaussian_encode,lt_encode
--merge PATH`` measures only those ops' cells and writes them over the
same cells of the table at PATH, keeping its other entries and their
measurement's meta (``meta.remeasured`` records the merge).  Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[3]
DEFAULT_OUT = REPO / "reports" / "bench" / "cuda" / "autotune.json"
REFERENCE_TABLE = REPO / "reports" / "bench" / "autotune.json"

HEAD_ARCHS = ("glm4-9b", "mamba2-130m", "zamba2-1.2b", "llama-3.2-vision-11b", "dbrx-132b")
HEAD_GEOM = (14, 2)      # the served heads' (n_data, n_parity)
RAISE_GEOM = (13, 3)     # after one parity raise
BATCHES = (1, 4)
GAUSSIAN_TASK = (564, 500, 500_000)   # the Gaussian task's whole plan (all of Â)
LT_TASK_M = 500_000
ERASED = (3, 11)         # the two erased shards of every coded-head cell
TIE = 0.01               # a candidate must beat the default's by more than this share


def _head(arch: str, n_data: int) -> tuple[int, int]:
    """(block rows, d_model) of ``arch``'s coded head with n_data data blocks."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return -(-cfg.vocab // n_data), cfg.d_model


def cells(quick: bool = False) -> list[tuple[str, dict]]:
    """(op, geometry) of every cell, in the order they are measured."""
    nd, npar = HEAD_GEOM
    if quick:
        br, d = _head("glm4-9b", nd)
        rbr, _ = _head("glm4-9b", RAISE_GEOM[0])
        return [("coded_linear", dict(out=nd * br, inner=d, batch=4, n_data=nd, n_parity=npar)),
                ("coded_matvec", dict(r=br, m=d, b=4)),
                ("gaussian_encode", dict(q=16, r=RAISE_GEOM[0], m=rbr * d))]
    out = []
    for arch in HEAD_ARCHS:
        br, d = _head(arch, nd)
        out += [("coded_linear", dict(out=nd * br, inner=d, batch=b, n_data=nd, n_parity=npar))
                for b in BATCHES]
    br, d = _head("glm4-9b", nd)
    out += [("coded_matvec", dict(r=br, m=d, b=b)) for b in BATCHES]
    for arch in HEAD_ARCHS:
        rbr, d = _head(arch, RAISE_GEOM[0])
        out.append(("gaussian_encode", dict(q=16, r=RAISE_GEOM[0], m=rbr * d)))
    q, r, m = GAUSSIAN_TASK
    out.append(("gaussian_encode", dict(q=q, r=r, m=m)))
    out.append(("lt_encode", dict(m=LT_TASK_M)))  # q, r, d_max, nnz from the task's table
    return out


def shape_key(op: str, geom: dict) -> str:
    """The dispatch table's shape string for a cell (``dispatch.choose_*``)."""
    if op == "coded_linear":
        return f"{geom['out']}x{geom['inner']}x{geom['batch']}"
    if op == "coded_matvec":
        return f"{geom['r']}x{geom['m']}x{geom['b']}"
    return f"{geom['q']}x{geom['r']}x{geom['m']}"


def time_interleaved(fns: dict, reps: int, calls: int = 5) -> dict[str, float]:
    """Median µs a call of each callable: a turn is ``calls`` back-to-back
    calls between two CUDA events, the callables' turns interleaved (order
    reversed every turn); one untimed warm-up call each first."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    samples: dict[str, list[float]] = {k: [] for k in fns}
    names = list(fns)
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[name]()
            end.record()
            end.synchronize()
            samples[name].append(start.elapsed_time(end) * 1e3 / calls)
    return {k: statistics.median(v) for k, v in samples.items()}


def _host_us(fn, calls: int = 300) -> float:
    """Host µs a call of ``fn``, the device synchronized around the run."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def measure_host(reps: int) -> dict:
    """What the H100 prior's host terms stand for, measured: one ctypes
    launch of a kernel from Python (a [64, 64] coded_matvec), one small
    eager op, and ``svd_recovery`` (one ``masked_pinv`` launch) at (14, 2)
    per unit of nb * n_data^2."""
    import torch

    from repro_torch.core.coded_ops import svd_recovery
    from repro_torch.kernels.coded_matvec import coded_matvec_cuda

    dev = torch.device("cuda")
    a, x = torch.randn(64, 64, device=dev), torch.randn(64, device=dev)
    t = torch.zeros(16, device=dev)
    nd, npar = HEAD_GEOM
    mask = torch.ones(nd + npar, device=dev)
    mask[list(ERASED)] = 0.0
    svd = time_interleaved({"svd": lambda: svd_recovery(mask, nd, npar)}, reps)["svd"]
    return {"launch_us": _host_us(lambda: coded_matvec_cuda(a, x)),
            "eager_op_us": _host_us(lambda: t.add_(1.0)),
            "svd_recovery_us": svd,
            "svd_us_per_unit": svd / ((nd + npar) * nd * nd)}


def lt_task_table(seed: int = 0, reserve: bool = True):
    """The LT task's reserve slice, or with ``reserve=False`` its whole plan
    (all of Â: the static rows and the reserve), at paper §5.1 scenario 1
    (worker 0 dying and worker 1 slowing 5x as in the reference's executor
    test, times scaled by r / 400) from a run at m = 8 on the CPU: (r, its
    EncodePlan)."""
    from repro_torch.cluster import ClusterEmulator, TaskSpec, ec2_scenario
    from repro_torch.core.adaptive import ChurnEvent, ChurnSchedule, ReallocationPolicy

    r, workers = ec2_scenario(1)
    s = r / 400
    churn = ChurnSchedule((ChurnEvent(t=0.01 * s, worker=0, kind="death"),
                           ChurnEvent(t=0.008 * s, worker=1, kind="rate", factor=5.0)))
    rng = np.random.default_rng(seed)
    em = ClusterEmulator(workers, time_scale=1e-3, seed=seed, device="cpu")
    em.run_task(rng.standard_normal((r, 8)).astype(np.float32),
                rng.standard_normal(8).astype(np.float32),
                TaskSpec(scheme="bpcc", code="lt", adaptive=ReallocationPolicy(),
                         churn=churn, encode_mode="device"))
    enc = em.last_encode  # all of Â was encoded; the reserve is its tail
    if not reserve:
        return r, enc["plan"]
    return r, enc["plan"].slice_rows(enc["static_rows"], enc["rows"])


def _candidates(op: str, geom: dict, gen) -> tuple[dict, dict, object, str]:
    """The cell's tensors on the card and its candidates: ({impl: fn}, the
    default's first; geometry completed, library fn, library call)."""
    import torch

    dev = torch.device("cuda")
    if op == "coded_linear":
        from repro_torch.core.coded_ops import CodedLinear

        nd, npar = geom["n_data"], geom["n_parity"]
        br = -(-geom["out"] // nd)
        wc = torch.randn((nd + npar) * br, geom["inner"], device=dev, generator=gen)
        x = torch.randn(geom["inner"], geom["batch"], device=dev, generator=gen)
        mask = torch.ones(nd + npar, device=dev)
        mask[list(ERASED)] = 0.0
        cl = CodedLinear(nd, npar, geom["out"])
        fns = {"fused": lambda: cl.apply(wc, x, mask, kernel_mode="cuda"),
               "svd": lambda: cl.apply(wc, x, mask, kernel_mode="svd")}
        return fns, geom, lambda: torch.matmul(wc, x), "torch.matmul(W_c, x)"
    if op == "coded_matvec":
        from repro_torch.kernels.coded_matvec import coded_matvec_cuda

        a = torch.randn(geom["r"], geom["m"], device=dev, generator=gen)
        x = torch.randn(geom["m"], geom["b"], device=dev, generator=gen)
        return ({"cuda": lambda: coded_matvec_cuda(a, x)}, geom, lambda: torch.matmul(a, x),
                "torch.matmul(A, x)")
    if op == "gaussian_encode":
        from repro_torch.kernels.lt_encode import gaussian_encode_cuda

        g_ = torch.randn(geom["q"], geom["r"], device=dev, generator=gen) / geom["r"] ** 0.5
        a = torch.randn(geom["r"], geom["m"], device=dev, generator=gen)
        return ({"cuda": lambda: gaussian_encode_cuda(g_, a)}, geom,
                lambda: torch.matmul(g_, a), "torch.matmul(G, A)")
    if op == "lt_encode":
        from repro_torch.kernels.lt_encode import _lt_csr, lt_encode_cuda

        r, plan = lt_task_table()
        a = torch.randn(r, geom["m"], device=dev, generator=gen)
        i_t = torch.as_tensor(plan.indices, device=dev)
        c_t = torch.as_tensor(plan.coeffs, device=dev)
        csr = _lt_csr(i_t, c_t, r)
        sparse = torch.sparse_csr_tensor(csr.row_ptr, csr.cols.long(), csr.vals,
                                         size=(plan.q, r), check_invariants=False)
        geom = dict(q=plan.q, r=r, m=geom["m"], d_max=int(plan.indices.shape[1]),
                    nnz=int(np.count_nonzero(plan.coeffs)))
        fns = {"cuda": lambda: lt_encode_cuda(a, i_t, c_t)}
        return fns, geom, lambda: torch.sparse.mm(sparse, a), "torch.sparse.mm(CSR G, A)"
    raise ValueError(f"unknown op {op!r}")


def measure(cell_list, reps: int, seed: int = 0) -> list[dict]:
    """Time every candidate and the library call of each cell on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    measured = []
    for op, geom in cell_list:
        fns, geom, library, library_call = _candidates(op, geom, gen)
        us = time_interleaved({**fns, "library": library}, reps)
        rows = [{"impl": impl, "mode": "cuda", "params": {}, "us": us[impl]} for impl in fns]
        measured.append({"op": op, "geometry": geom, "candidates": rows,
                         "library_us": us["library"], "library_call": library_call})
        print(f"  {op} {shape_key(op, geom)}: "
              + "  ".join(f"{r['impl']}={r['us']:.1f}us" for r in rows)
              + f"  library={us['library']:.1f}us", flush=True)
        del fns, library
        torch.cuda.empty_cache()
    return measured


def winner(candidates: list[dict]) -> dict:
    """The default's candidate (the first) unless another is faster by
    more than ``TIE``: a smaller gain is noise."""
    best = min(candidates, key=lambda r: r["us"])
    return candidates[0] if candidates[0]["us"] <= best["us"] * (1 + TIE) else best


def build_table(measured: list[dict], meta: dict) -> dict:
    """Reconcile the measurements with the H100 prior and pick winners."""
    from repro_torch.kernels import cost

    hw = cost.preset("cuda")
    entries, n_flagged = [], 0
    for cell in measured:
        op, geom = cell["op"], cell["geometry"]
        costs = cost.candidate_costs(op, "cuda", **geom)
        for r in cell["candidates"]:
            r["predicted_us"] = costs[r["impl"]].predicted_us(hw)
            r["model_error"] = cost.model_error(r["predicted_us"], r["us"])
            r["flagged"] = r["model_error"] > cost.MODEL_ERROR_FLAG
            n_flagged += r["flagged"]
        win = winner(cell["candidates"])
        entries.append({
            "op": op, "shape": shape_key(op, geom), "dtype": "float32", "backend": "cuda",
            "geometry": ({k: geom[k] for k in ("n_data", "n_parity")}
                         if op == "coded_linear" else {}),
            "impl": win["impl"], "mode": win["mode"], "params": win["params"],
            "us": win["us"], "predicted_us": win["predicted_us"],
            "model_error": win["model_error"], "flagged": win["flagged"],
            "library_us": cell["library_us"], "library_call": cell["library_call"],
            "cell": geom, "source": "measured", "candidates": cell["candidates"],
        })
        if win["model_error"] > cost.MODEL_ERROR_FLAG:
            print(f"  FLAG {op} {shape_key(op, geom)}: winner {win['impl']} "
                  f"model_error {win['model_error']:.2f}x > {cost.MODEL_ERROR_FLAG}x")
    return {"version": 1, "generated_by": "python -m repro_torch.kernels.autotune",
            "backend": "cuda", "reps_interleaved": True, "meta": meta,
            "hardware": {"cuda": hw.as_dict()}, "flagged_cells": int(n_flagged),
            "entries": entries}


def card_meta() -> dict:
    """The card, its power limit and the software that measured."""
    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi unavailable"
    return {"card": smi, "device_name": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def tune(quick: bool = False, reps: int = 25, seed: int = 0,
         ops: tuple[str, ...] | None = None) -> dict:
    """Measure the grid of cells (of ``ops`` only, if given) on the card and
    return the table."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the autotuner measures on a CUDA device, and none is available")
    import repro_torch  # noqa: F401  (pins fp32 matmul precision)

    meta = card_meta()
    meta.update(quick=quick, reps=reps, seed=seed, measured_host=measure_host(reps))
    print(f"# autotune on {meta['card']} (torch {meta['torch']}, CUDA {meta['cuda']}): "
          f"quick={quick} reps={reps}; host {meta['measured_host']}", flush=True)
    grid = [(op, g) for op, g in cells(quick) if ops is None or op in ops]
    return build_table(measure(grid, reps, seed), meta)


def merge_table(base: dict, new: dict) -> dict:
    """``base`` with each of ``new``'s entries in place of base's entry of the
    same (op, shape, dtype, backend), the rest kept; ``meta.remeasured``
    records what ``new`` measured, on which card."""
    key = lambda e: (e["op"], e["shape"], e["dtype"], e["backend"])  # noqa: E731
    fresh = {key(e): e for e in new["entries"]}
    ops = sorted({e["op"] for e in new["entries"]})
    entries = [e for e in base["entries"] if key(e) not in fresh and e["op"] not in ops]
    doc = dict(base, entries=entries + list(fresh.values()))
    doc["flagged_cells"] = int(sum(e["flagged"] for e in doc["entries"]))
    doc["meta"] = dict(base["meta"], remeasured={"ops": ops, **new["meta"]})
    return doc


def write_table(doc: dict, out: str | os.PathLike) -> Path:
    out = Path(out).resolve()
    if out == REFERENCE_TABLE.resolve():
        raise ValueError(f"{out} is the reference's table; the port writes its own")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the glm4-9b head, code block and raise at B = 4 only")
    ap.add_argument("--reps", type=int, default=25, help="interleaved turns per cell")
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="table path (default: %(default)s)")
    ap.add_argument("--ops", default=None,
                    help="comma-separated ops whose cells alone are measured")
    ap.add_argument("--merge", default=None,
                    help="a table whose other entries the result keeps (with --ops)")
    args = ap.parse_args(argv)
    ops = tuple(args.ops.split(",")) if args.ops else None
    doc = tune(args.quick, args.reps, ops=ops)
    if args.merge:
        with open(args.merge) as f:
            doc = merge_table(json.load(f), doc)
    out = write_table(doc, args.out)
    for e in doc["entries"]:
        print(f"  {e['op']} {e['shape']}: {e['impl']} {e['us']:.1f}us "
              f"(library {e['library_us']:.1f}us, model {e['predicted_us']:.1f}us, "
              f"error {e['model_error']:.2f}x)")
    print(f"# wrote {out}: {len(doc['entries'])} entries, {doc['flagged_cells']} flagged")
    return 0


if __name__ == "__main__":
    sys.exit(main())
