"""Run one cell of BENCHMARK.json once on one NVIDIA GPU and print its result.

    python3 portbench/run.py --workload glm4-9b.chat --seed 7 --seconds 45 --trace 0

Loads the cell's configuration and traffic, makes the weights from the seed
on the card, warms up (set-up), serves the traffic for ``--seconds``
through the port (``repro_torch``), holds a sample of what it served to the
plain fp32 reference, and prints one JSON line last on standard output:
the end-to-end metrics with ``--trace 0``, the per-layer metrics (from a
profiled slice of the window) with ``--trace 1``.  Exits non-zero, with no
result, without a CUDA device, or when JAX or the JAX package ``repro`` is
loaded.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process, few threads: the harness and the program's host side are one
# Python thread; idle CPU worker threads only add jitter to its timings
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "1")
# the caching allocator grows its segments instead of keeping one a size:
# prefills of many lengths otherwise strand gigabytes between segments
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import guard

    bad = guard.forbidden_loaded()
    if bad:
        print(f"portbench: refusing to run with {bad} loaded", file=sys.stderr)
        return 3
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in bm["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: the cell needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench import bench, report

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rec = bench.run(wl, args.seed, args.seconds, bool(args.trace), device=device,
                    t_start=T_START)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"portbench: {bad} loaded by the end of the window; no result", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": wl["chips"],
           "memory_peak_bytes": int(rec["peak_bytes"])}
    if args.trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        for k, by in rec["trace"]["bound_by"].items():
            print(f"bound {k}: {by}", file=sys.stderr)
    print("set-up, seconds from process start: " + ", ".join(
        f"{k} {v:.2f}" for k, v in rec["setup_phases"].items()), file=sys.stderr)
    print(f"run: {rec['attempted']} requests due, {rec['failed']} refused, parity events "
          f"{rec['parity_events']}, sampled tokens {rec['check']['sampled_tokens']}",
          file=sys.stderr)
    line = report.result(bm, wl["name"], rec, bool(args.trace), dev)
    for s in report.check_lines(rec):
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(report.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
