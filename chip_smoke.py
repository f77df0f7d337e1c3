#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # as run on the card; needs one GPU
    python3 chip_smoke.py --profile    # also a torch.profiler window over engine steps

Phases, one JSON line each; any failure exits non-zero before the last line:

1. device: name, ``nvidia-smi`` name and power limit, kernel build seconds
   (one ``nvcc`` per source, started together);
2. kernels: the serving kernels against their plain PyTorch versions on the
   card, at the serving path's shapes (glm4-9b head at B = 1 and B = 4, the
   (13, 3) parity re-encode) and at ragged shapes; max error against the
   stated tolerance, kernel / plain / library times and the bound;
3. task, LT: the paper's coded task form (§5.1 scenario 1: r = 5,000, five
   EC2 workers, m = 500,000) through ``ClusterEmulator.run_task`` — Algorithm
   1, LT encode with the reserve rows encoded on the card by ``lt_encode``,
   adaptive top-ups under churn (worker 0 dies, worker 1 slows 5x), the
   streaming peeling decode — held to A·x in float64 and to a host-encode
   run of the same seed; then ``lt_encode`` against its plain version at
   that call's shapes and at ragged ones.  The reserve is encoded with
   ``TaskSpec``'s default ``encode_mode`` ('device': the card).  m is cut
   only if host memory is short, and the cut is printed;
4. task, Gaussian: the same at r = 500 (scenario 2's r/20, ten workers),
   m = 200,000, ``code="gaussian"``, the reserve encoded by
   ``gaussian_encode`` (printed as a cut: the host's dense static encode,
   run twice, sets the size);
5. head and serve: glm4-9b's coded head at full width under 0 and 2
   erasures; glm4-9b at full width and depth (seeded init on the card),
   4 slots, 6 requests of 16 prompt tokens and 8 new tokens, 3 persistent
   stragglers forcing one (14, 2) -> (13, 3) raise;
6. a ``kernels`` line with every kernel on every path it runs (launch
   counts read around that path's run), then the device line.

It imports nothing of JAX, and exits non-zero without CUDA or without the
repository's ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12           # H100 SXM fp32 outside the tensor cores (data sheet)
PAPER_M = 500_000            # the paper's width of A (benchmarks/paper_ec2.py)
GAUSSIAN_TASK_M = 200_000    # the Gaussian task's cut width (phase_task_gaussian)
TASK_TIME_SCALE = 10.0       # wall seconds per model second of the paced task runs


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time (ms) the card could take, and what sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|), both as floats."""
    return float((got - want).abs().max()), float(want.abs().max())


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------------------
def phase_device(torch):
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    nvcc_s = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in _build.ptxas_report(name).splitlines()
               if "registers" in ln or "spill" in ln]
        for name in _build.SOURCES
    }
    emit({"phase": "device", "torch_device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "nvcc_parallel_s": nvcc_s, "ptxas": ptxas})
    return smi


def phase_kernels(torch, gen, results: dict) -> None:
    from repro_torch.core.decoding import get_decoder_cache
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda
    from repro_torch.kernels.lt_encode import gaussian_encode_cuda

    dev = torch.device("cuda")
    rtol = 1e-4  # |kernel - plain| <= rtol * max(1, max|plain|): fp32, other sum order

    # ---- coded_matvec_decode: glm4-9b head (14 + 2 blocks of 10826 rows x 4096)
    # plus ragged shapes (odd br, M % 4 != 0 -> scalar loads, B up to 16)
    head_shapes = [("glm4-9b prefill", 14, 2, 10826, 4096, 1),
                   ("glm4-9b decode", 14, 2, 10826, 4096, 4),
                   ("glm4-9b decode after raise", 13, 3, 11658, 4096, 4),
                   ("ragged", 13, 3, 1001, 4097, 3),
                   ("ragged", 6, 2, 77, 516, 16)]
    for label, n_data, n_parity, br, m, b in head_shapes:
        nb = n_data + n_parity
        w = torch.randn(nb * br, m, device=dev, generator=gen)
        x = torch.randn(m, b, device=dev, generator=gen)
        cache = get_decoder_cache(n_data, n_parity)
        for erased in ((), (1, nb - 1)):
            mask = torch.ones(nb, device=dev)
            mask[list(erased)] = 0.0
            rec = cache.recovery(mask)
            got = ops.coded_matvec_decode(w, x, rec, mode="cuda")
            want = ref.ref_coded_matvec_decode(w, x, rec)
            torch.cuda.synchronize()
            err, scale = max_err(torch, got, want)
            tol = rtol * max(1.0, scale)
            row = {"phase": "kernel", "kernel": "coded_matvec_decode", "shape": label,
                   "w": [nb * br, m], "b": b, "erased": list(erased),
                   "max_abs_err": err, "tol": tol}
            if not erased and label in ("glm4-9b prefill", "glm4-9b decode"):
                iters = 20
                row["ms"] = time_ms(torch, lambda: ops.coded_matvec_decode(w, x, rec, mode="cuda"), iters)
                row["plain_ms"] = time_ms(torch, lambda: ref.ref_coded_matvec_decode(w, x, rec), iters)
                row["library_ms"] = time_ms(torch, lambda: torch.matmul(w, x), iters)
                row["library_call"] = "torch.matmul(W_c, x), the block product alone (partial yardstick)"
                n_bytes = 4 * (w.numel() + x.numel() + rec.numel() + n_data * br * b)
                n_ops = 2 * nb * br * m * b + 2 * n_data * nb * br * b
                row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops)
                results.setdefault("coded_matvec_decode", {})[label] = row
            emit(row)
            check(err <= tol, f"coded_matvec_decode {label} erased={erased}: {err} > {tol}")
        del w, x
    torch.cuda.empty_cache()

    # ---- gaussian_encode: the (13, 3) parity re-encode of the glm4-9b head,
    # G [16, 13] x A [13, 11658 * 4096], plus ragged shapes
    enc_shapes = [("glm4-9b raise", 16, 13, 11658 * 4096),
                  ("ragged", 33, 40, 257), ("ragged", 5, 3, 1001), ("ragged", 16, 14, 1)]
    for label, q, r, m in enc_shapes:
        g = torch.randn(q, r, device=dev, generator=gen)
        a = torch.randn(r, m, device=dev, generator=gen)
        got = ops.gaussian_encode(g, a, mode="cuda")
        want = ref.ref_gaussian_encode(g, a)
        torch.cuda.synchronize()
        err, scale = max_err(torch, got, want)
        tol = rtol * max(1.0, scale)
        row = {"phase": "kernel", "kernel": "gaussian_encode", "shape": label,
               "g": [q, r], "a": [r, m], "max_abs_err": err, "tol": tol}
        del got, want
        if label.startswith("glm4"):
            iters = 10
            row["ms"] = time_ms(torch, lambda: ops.gaussian_encode(g, a, mode="cuda"), iters)
            row["plain_ms"] = time_ms(torch, lambda: ref.ref_gaussian_encode(g, a), iters)
            row["library_ms"] = time_ms(torch, lambda: torch.matmul(g, a), iters)
            row["library_call"] = "torch.matmul(G, A)"
            n_bytes = 4 * (q * r + r * m + q * m)
            row["bound_ms"], row["bound_by"] = bound(n_bytes, 2 * q * r * m)
            results.setdefault("gaussian_encode", {})[label] = row
        emit(row)
        check(err <= tol, f"gaussian_encode {label}: {err} > {tol}")
        del g, a
    torch.cuda.empty_cache()
    # launches made for these comparisons are not the main path's
    coded_matvec_decode_cuda.launches = 0
    gaussian_encode_cuda.launches = 0


def _reset_launches() -> None:
    from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda
    from repro_torch.kernels.lt_encode import gaussian_encode_cuda, lt_encode_cuda

    for fn in (coded_matvec_decode_cuda, gaussian_encode_cuda, lt_encode_cuda):
        fn.launches = 0


def _launches() -> dict:
    from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda
    from repro_torch.kernels.lt_encode import gaussian_encode_cuda, lt_encode_cuda

    return {"coded_matvec_decode": coded_matvec_decode_cuda.launches,
            "gaussian_encode": gaussian_encode_cuda.launches,
            "lt_encode": lt_encode_cuda.launches}


def _host_peak_gb() -> float:
    """Peak resident memory of this process so far (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _mem_available_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("MemAvailable not in /proc/meminfo")


def _task_inputs(torch, r: int, m: int, seed: int):
    """A [r, m] and x [m], fp32, drawn on the card from ``seed``; A·x in
    float64 on the card (in row pieces); all three copied to the host."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    a_dev = torch.randn(r, m, device=dev, generator=gen)
    x_dev = torch.randn(m, device=dev, generator=gen)
    x64 = x_dev.double()
    step = max(1, (1 << 30) // (8 * m))
    y = torch.cat([a_dev[s:s + step].double() @ x64 for s in range(0, r, step)])
    out = a_dev.cpu().numpy(), x_dev.cpu().numpy(), y.cpu().numpy()
    del a_dev, x_dev, x64, y
    torch.cuda.empty_cache()
    return out


def _churn(r: int):
    """Worker 0 dies and worker 1 slows 5x: the reference's executor test,
    with its times scaled by r / 400."""
    from repro_torch.core.adaptive import ChurnEvent, ChurnSchedule

    s = r / 400
    return ChurnSchedule((ChurnEvent(t=0.01 * s, worker=0, kind="death"),
                          ChurnEvent(t=0.008 * s, worker=1, kind="rate", factor=5.0)))


def _run_task(torch, a, x, y_ref, workers, code: str, encode_mode,
              seed: int) -> tuple[dict, object, object]:
    """One ``run_task`` of the adaptive task form, its launches counted around
    it; returns (row, result, emulator)."""
    from repro_torch.cluster import ClusterEmulator, TaskSpec
    from repro_torch.core.adaptive import ReallocationPolicy

    spec = TaskSpec(scheme="bpcc", code=code, adaptive=ReallocationPolicy(),
                    churn=_churn(a.shape[0]), encode_mode=encode_mode)
    em = ClusterEmulator(workers, time_scale=TASK_TIME_SCALE, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    res = em.run_task(a, x, spec)
    wall = time.perf_counter() - t0
    launches = _launches()
    rel = float(np.abs(res.y - y_ref).max() / np.abs(y_ref).max())
    row = {"encode_mode": encode_mode, "ok": res.ok, "max_rel_err": rel,
           "t_complete": res.t_complete, "t_decode": res.t_decode,
           "t_decode_ingest": res.t_decode_ingest, "t_wall": res.t_wall,
           "run_task_wall_s": wall, "rows_assigned": res.rows_assigned,
           "rows_received": res.rows_received, "reallocations": len(res.reallocations),
           "launches": launches, "host_peak_gb": _host_peak_gb(),
           "device_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    enc = em.last_encode
    if enc is not None:
        row["encode"] = {k: enc[k] for k in ("kind", "rows", "nonzeros", "h2d_s",
                                             "encode_s", "d2h_s", "static_host_s")}
    return row, res, em


def _same_trajectory(dev_res, host_res) -> bool:
    return (dev_res.arrivals == host_res.arrivals
            and dev_res.reallocations == host_res.reallocations
            and dev_res.rows_assigned == host_res.rows_assigned)


def phase_task_lt(torch, args, results: dict, smi: str) -> None:
    """The paper's task form at scenario 1 through the port's run_task, the
    reserve rows LT-encoded on the card by TaskSpec's default encode_mode;
    then lt_encode at that call's shapes."""
    from repro_torch.cluster import ec2_scenario

    r, workers = ec2_scenario(1)
    m, cut = PAPER_M, None
    # host bytes per A byte, the process's peak on this path: A, the coded
    # rows (capacity ~1.75 r) held once by the master and once spread over
    # the workers, the static encode's buffer, and room for the reference
    # copy of y and the encode's pieces
    need_per_col = 6.0 * r * 4 / 1e9
    avail = _mem_available_gb()
    if need_per_col * m > 0.9 * avail:
        cut = {"m": int(0.9 * avail / need_per_col), "of_m": m,
               "reason": f"host memory: {avail:.1f} GB available, "
                         f"{need_per_col * m:.1f} GB reckoned at m = {m}"}
        emit({"phase": "cut", "task": "lt", **cut})
        m = cut["m"]
    t0 = time.perf_counter()
    a, x, y_ref = _task_inputs(torch, r, m, args.seed)
    inputs_s = time.perf_counter() - t0
    dev_row, dev_res, em = _run_task(torch, a, x, y_ref, workers, "lt", "device",
                                     args.seed)
    enc = em.last_encode
    check(enc is not None, "no device encode ran: the top-ups drew no reserve rows")
    plan = enc["plan"]
    static_total = dev_row["rows_assigned"] - enc["rows"]
    del em
    host_row, host_res, em = _run_task(torch, a, x, y_ref, workers, "lt", None,
                                       args.seed)
    del em
    row = {"phase": "task", "code": "lt", "scenario": 1, "r": r, "m": m,
           "cut": cut, "workers": [w.name for w in workers],
           "time_scale": TASK_TIME_SCALE, "inputs_s": inputs_s, "static_rows": static_total,
           "device_encode": dev_row, "host_encode": host_row,
           "same_trajectory": _same_trajectory(dev_res, host_res),
           "y_max_abs_diff_device_vs_host": float(np.abs(dev_res.y - host_res.y).max()),
           "card": smi}
    emit(row)
    results["task_lt"] = row
    check(dev_res.ok, "LT task (device encode) did not decode")
    check(dev_row["max_rel_err"] <= 2e-3, f"LT task rel err {dev_row['max_rel_err']} > 2e-3")
    check(dev_row["rows_assigned"] > static_total, "top-ups drew no reserve rows")
    check(dev_row["launches"]["lt_encode"] == 1, f"lt_encode launches {dev_row['launches']}")
    check(host_res.ok and host_row["max_rel_err"] <= 2e-3,
          f"LT task (host encode) rel err {host_row['max_rel_err']}")
    check(row["same_trajectory"], "device and host encode runs differ in arrivals, "
                                  "reallocations or rows assigned")
    del dev_res, host_res
    gc.collect()

    kernel_lt_encode(torch, a, plan, results)
    del a, x, y_ref, plan
    gc.collect()
    torch.cuda.empty_cache()


def kernel_lt_encode(torch, a_host, plan, results: dict) -> None:
    """lt_encode on the card against ref_lt_encode: the task phase's own call
    (A [r, m], its reserve slice of the plan) in full, and ragged shapes."""
    from repro_torch.core.encoding import LTCode
    from repro_torch.kernels import ref
    from repro_torch.kernels.lt_encode import lt_encode_cuda

    dev = torch.device("cuda")
    rtol = 1e-4  # |kernel - plain| <= rtol * max(1, max|plain|)
    gen = np.random.default_rng(7)
    shapes = [("task reserve slice", torch.as_tensor(a_host, device=dev),
               plan.indices, plan.coeffs)]
    # ragged: M % 4 != 0 (scalar loads); zeros mid-row with non-unit
    # coefficients and a degree-0 row; q = 1 with d_max = 1
    lt = LTCode(300, seed=3).plan(420)
    shapes.append(("ragged M % 4 != 0", torch.randn(300, 4097, device=dev),
                   lt.indices[300:], lt.coeffs[300:]))
    idx = gen.integers(0, 200, (70, 9)).astype(np.int32)
    cof = gen.standard_normal((70, 9)).astype(np.float32)
    cof[gen.random((70, 9)) < 0.4] = 0.0
    cof[5] = 0.0
    shapes.append(("ragged zeros mid-row", torch.randn(200, 1030, device=dev), idx, cof))
    shapes.append(("ragged q = 1, d_max = 1", torch.randn(3, 4100, device=dev),
                   np.array([[2]], np.int32), np.array([[0.5]], np.float32)))
    for label, a, idx, cof in shapes:
        i_t = torch.as_tensor(idx, device=dev)
        c_t = torch.as_tensor(cof, device=dev)
        got = lt_encode_cuda(a, i_t, c_t)
        want = ref.ref_lt_encode(a, i_t, c_t)
        torch.cuda.synchronize()
        err, scale = max_err(torch, got, want)
        tol = rtol * max(1.0, scale)
        nnz = int(np.count_nonzero(cof))
        q, d_max = idx.shape
        row = {"phase": "kernel", "kernel": "lt_encode", "shape": label,
               "a": list(a.shape), "q": q, "d_max": d_max, "nonzeros": nnz,
               "max_degree": int((cof != 0).sum(1).max()),
               "max_abs_err": err, "tol": tol}
        del got, want
        if label.startswith("task"):
            m = a.shape[1]
            row["ms"] = time_ms(torch, lambda: lt_encode_cuda(a, i_t, c_t), 5)
            row["plain_ms"] = time_ms(torch, lambda: ref.ref_lt_encode(a, i_t, c_t), 2, warmup=1)
            nz = c_t != 0
            csr = torch.sparse_csr_tensor(
                torch.nn.functional.pad(nz.sum(1).cumsum(0), (1, 0)),
                i_t[nz].long(), c_t[nz], size=(q, a.shape[0]), check_invariants=False)
            row["library_ms"] = time_ms(torch, lambda: torch.sparse.mm(csr, a), 3, warmup=1)
            row["library_call"] = "torch.sparse.mm(CSR generator [q, r], A)"
            # each input read once: the rows of A the table references, the
            # padded table; the output written once
            used_rows = int(torch.unique(i_t[nz]).numel())
            n_bytes = 4 * used_rows * m + 8 * q * d_max + 4 * q * m
            row["bound_ms"], row["bound_by"] = bound(n_bytes, 2 * nnz * m)
            row["a_rows_used"] = used_rows
            # the same, had every nonzero entry to stream its row of A anew
            row["bound_no_reuse_ms"] = bound(n_bytes + 4 * (nnz - used_rows) * m, 0)[0]
            results.setdefault("lt_encode", {})["task"] = row
            del csr
        emit(row)
        check(err <= tol, f"lt_encode {label}: {err} > {tol}")
        del a, i_t, c_t
        torch.cuda.empty_cache()
    lt_encode_cuda.launches = 0  # comparison launches are not the path's


def phase_task_gaussian(torch, args, results: dict, smi: str) -> None:
    """The task form with the Gaussian code at a stated cut, the reserve rows
    encoded by gaussian_encode on the card; then gaussian_encode at that
    call's shape."""
    from repro_torch.cluster import ec2_scenario
    from repro_torch.kernels import ref
    from repro_torch.kernels.lt_encode import gaussian_encode_cuda

    r_full, workers = ec2_scenario(2)
    r, m = r_full // 20, GAUSSIAN_TASK_M
    cut = {"r": r, "of_r": r_full, "m": m, "of_m": PAPER_M,
           "reason": "the host's static dense encode (numpy gather and einsum, "
                     "static rows x r x m multiply-adds, once in each of the two "
                     "runs): r/20 as benchmarks/paper_ec2.py, and m as wide as "
                     "keeps the phase within its share of the time limit"}
    emit({"phase": "cut", "task": "gaussian", **cut})
    a, x, y_ref = _task_inputs(torch, r, m, args.seed + 1)
    dev_row, dev_res, em = _run_task(torch, a, x, y_ref, workers, "gaussian", "device",
                                     args.seed)
    enc = em.last_encode
    check(enc is not None, "no device encode ran: the top-ups drew no reserve rows")
    host_row, host_res, _ = _run_task(torch, a, x, y_ref, workers, "gaussian", None,
                                      args.seed)
    row = {"phase": "task", "code": "gaussian", "scenario": 2, "r": r, "m": m,
           "cut": cut, "workers": [w.name for w in workers],
           "time_scale": TASK_TIME_SCALE,
           "device_encode": dev_row, "host_encode": host_row,
           "same_trajectory": _same_trajectory(dev_res, host_res),
           "y_max_abs_diff_device_vs_host": float(np.abs(dev_res.y - host_res.y).max()),
           "card": smi}
    emit(row)
    results["task_gaussian"] = row
    check(dev_res.ok and dev_row["max_rel_err"] <= 2e-3,
          f"Gaussian task rel err {dev_row['max_rel_err']}")
    check(dev_row["launches"]["gaussian_encode"] == 1,
          f"gaussian_encode launches {dev_row['launches']}")
    check(host_res.ok and host_row["max_rel_err"] <= 2e-3,
          f"Gaussian task (host encode) rel err {host_row['max_rel_err']}")
    check(row["same_trajectory"], "device and host encode runs differ in trajectory")

    # gaussian_encode at the task's shape: G [q, r] (the plan's reserve slice) x A
    dev = torch.device("cuda")
    g = torch.as_tensor(np.ascontiguousarray(enc["plan"].coeffs), device=dev)
    a_t = torch.as_tensor(a, device=dev)
    got = gaussian_encode_cuda(g, a_t)
    want = ref.ref_gaussian_encode(g, a_t)
    torch.cuda.synchronize()
    err, scale = max_err(torch, got, want)
    q = g.shape[0]
    krow = {"phase": "kernel", "kernel": "gaussian_encode", "shape": "task reserve slice",
            "g": [q, r], "a": [r, m], "max_abs_err": err, "tol": 1e-4 * max(1.0, scale),
            "ms": time_ms(torch, lambda: gaussian_encode_cuda(g, a_t), 20),
            "plain_ms": time_ms(torch, lambda: ref.ref_gaussian_encode(g, a_t), 20),
            "library_ms": time_ms(torch, lambda: torch.matmul(g, a_t), 20),
            "library_call": "torch.matmul(G, A)"}
    krow["bound_ms"], krow["bound_by"] = bound(4 * (q * r + r * m + q * m), 2 * q * r * m)
    emit(krow)
    check(err <= krow["tol"], f"gaussian_encode task shape: {err} > {krow['tol']}")
    results.setdefault("gaussian_encode", {})["task"] = krow
    gaussian_encode_cuda.launches = 0
    del g, a_t, got, want
    torch.cuda.empty_cache()


def phase_head(torch, params, cfg, gen) -> None:
    from repro_torch.models.transformer import _last_logits

    dev = torch.device("cuda")
    hidden = torch.randn(4, 1, cfg.d_model, device=dev, generator=gen)
    uncoded = hidden[:, -1] @ params["lm_head"]
    scale = float(uncoded.abs().max())
    for erased in ((), (0, 9)):
        mask = torch.ones(16, device=dev)
        mask[list(erased)] = 0.0
        got = _last_logits(params, hidden, cfg, mask, "cuda")
        torch.cuda.synchronize()
        rel = float((got - uncoded).abs().max()) / scale
        same_argmax = bool((got.argmax(-1) == uncoded.argmax(-1)).all())
        emit({"phase": "head", "arch": cfg.name, "w_coded": list(params["lm_head_coded"].shape),
              "erased": list(erased), "max_rel_err": rel, "tol": 1e-3,
              "argmax_equal": same_argmax})
        check(rel <= 1e-3, f"coded head erased={erased}: rel err {rel} > 1e-3")


def phase_serve(torch, args, results: dict, smi: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.adaptive import ParityController
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    dev = torch.device("cuda")
    full = get_config("glm4-9b")
    cfg = full.scaled(coded=True, coded_parity=2, n_layers=args.layers)
    if cfg.n_layers != full.n_layers:
        emit({"phase": "cut", "n_layers": cfg.n_layers, "of": full.n_layers})
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    emit({"phase": "init", "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "init_s": init_s,
          "param_gb": sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9})

    phase_head(torch, params, cfg, torch.Generator(device=dev).manual_seed(args.seed + 1))

    def latency_fn():  # three persistent stragglers: more than the budget of 2
        lat = np.full(16, 1e-3)
        lat[2] = lat[7] = lat[11] = 5e-2
        return lat

    eng = ServeEngine(model, params, n_slots=4, s_max=64, latency_fn=latency_fn,
                      parity_controller=ParityController(16, decay=0.5),
                      parity_topup=1, topup_patience=2,
                      head_kernel_mode="cuda", encode_mode="cuda", device=dev)
    del params  # the engine keeps bf16 layer weights and the fp32 heads
    rng = np.random.default_rng(args.seed)
    n_req, prompt_len, max_new = 6, 16, 8
    for i in range(n_req):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, prompt_len),
                           max_new_tokens=max_new))

    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    steps, syncs = eng._steps, eng.sync_count

    n_tok = sum(len(r.out_tokens) for r in done)
    tokens = {r.uid: r.out_tokens for r in done}
    check(len(done) == n_req, f"{len(done)} of {n_req} requests completed")
    check(all(len(t) == max_new for t in tokens.values()), "a request missed its token count")
    check(all(0 <= t < cfg.vocab for ts in tokens.values() for t in ts), "token out of vocab")
    check(len(eng.parity_events) == 1 and eng.parity_events[0]["n_parity"] == 3,
          f"parity events {eng.parity_events}")
    check(eng.model.cfg.coded_parity == 3 and tuple(eng.params["lm_head_coded"].shape) == (16 * 11658, 4096),
          "head not re-split to (13, 3)")
    check(launches["gaussian_encode"] == 1, f"gaussian_encode launches {launches}")
    check(launches["coded_matvec_decode"] == n_req + steps,
          f"coded_matvec_decode launches {launches} != {n_req} prefills + {steps} steps")

    # times after the counted run.  The model's prefill call alone (B = 1,
    # no engine around it), by CUDA events; then whole engine steps on a
    # refilled queue, host clock: the first step admits every slot, each
    # timed one decodes all of them (control plane, mask upload, model
    # call, argmax and its host copy) and admits none.
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (1, prompt_len)), device=dev)
    prefill_call_ms = time_ms(torch, lambda: eng._prefill1(prompt), 5)
    for i in range(eng.n_slots):
        eng.submit(Request(uid=n_req + i, prompt=rng.integers(0, cfg.vocab, prompt_len),
                           max_new_tokens=32))
    eng.step()
    n_timed = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        check(eng.step() == eng.n_slots, "a timed step did not decode every slot")
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_timed
    row = {"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers, "n_slots": 4,
           "s_max": 64, "requests": n_req, "prompt_len": prompt_len, "max_new": max_new,
           "tokens": n_tok, "decode_steps": steps, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "prefill_call_ms": prefill_call_ms,
           "step_ms": step_ms,
           "sync_count": syncs, "parity_events": eng.parity_events,
           "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": smi, "first_tokens": tokens[0]}
    emit(row)
    results["serve"] = row

    if args.profile:
        phase_profile(torch, eng)


def phase_profile(torch, eng) -> None:
    """Device time by kernel over 3 whole engine steps, every slot decoding
    (torch.profiler), and the device's busy share of the window's wall
    time; both read with the profiler on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            check(eng.step() == eng.n_slots, "a profiled step did not decode every slot")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = [{"kernel": evt.key[:100], "device_ms_per_step": evt.self_device_time_total / 1e3 / steps,
             "launches_per_step": evt.count / steps}
            for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    busy = sum(r["device_ms_per_step"] for r in rows)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.json"), "w") as f:
        json.dump({"wall_ms_per_step": wall_ms, "device_ms_per_step": busy, "kernels": rows},
                  f, indent=1)
    emit({"phase": "profile", "wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
          "busy_share": busy / wall_ms if wall_ms else None,
          "launches_per_step": sum(r["launches_per_step"] for r in rows), "top": rows[:10]})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="glm4-9b depth to serve (40 = full; widths are never cut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler window over 3 engine steps")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (pins fp32 matmul precision)

    torch.cuda.set_device(0)
    smi = phase_device(torch)
    results: dict = {}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_kernels(torch, gen, results)
    phase_task_lt(torch, args, results, smi)
    phase_task_gaussian(torch, args, results, smi)
    phase_serve(torch, args, results, smi)

    kernels = []
    for name, source, replaces, path, phase, shape in (
        ("coded_matvec_decode", "src/repro_torch/kernels/csrc/coded_decode.cu",
         "src/repro/kernels/coded_decode.py:65", "serve", results["serve"], "glm4-9b decode"),
        ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
         "src/repro/kernels/lt_encode.py:107", "serve", results["serve"], "glm4-9b raise"),
        ("lt_encode", "src/repro_torch/kernels/csrc/lt_encode.cu",
         "src/repro/kernels/lt_encode.py:61", "task lt", results["task_lt"], "task"),
        ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
         "src/repro/kernels/lt_encode.py:107", "task gaussian", results["task_gaussian"],
         "task"),
    ):
        r = results[name][shape]
        launches = phase.get("device_encode", phase)["launches"]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches[name], "max_abs_err": r["max_abs_err"],
                 "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "path": path, "shape": r["shape"]}
        if "cut" in phase:  # the task phases: the cut of r and m, or None
            entry.update(r=phase["r"], m=phase["m"], cut=phase["cut"])
        kernels.append(entry)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "results": results, "kernels": kernels}, f, indent=1)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
