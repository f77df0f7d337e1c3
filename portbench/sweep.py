"""The knee of an open-loop cell: its traffic at several rates, one process.

    python3 portbench/sweep.py --workload glm4-9b.chat --seconds 50 --rates 4,5,6,7

Each rate is one run of the cell with the traffic file's arrival rate
replaced.  Prints a JSON line a rate: the end-to-end metrics, requests due
and those that got a first token, and the median time to first token in
each quarter of the arrivals.  A rate the system sustains keeps those
medians level; past the knee they grow through the window as the backlog
does.  A cell's rate is set once, at about four fifths of the knee, and
written into its traffic file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=900)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from portbench import bench, report

    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next(w for w in bm["workloads"] if w["name"] == args.workload)
    device = torch.device("cuda", 0)
    for rate in (float(r) for r in args.rates.split(",")):
        t0 = time.monotonic()
        rec = bench.run(wl, args.seed, args.seconds, False, device=device, t_start=t0,
                        traffic_overrides={"arrivals": {"rate_per_s": rate}})
        metrics = {m: v["value"] for m, v in report.result(bm, wl["name"], rec, False,
                                                             {})["metrics"].items()}
        reqs, end = rec["requests"], rec["window_s"]
        ttft = [(r["t_first"] if r["t_first"] is not None else end) - r["due"] for r in reqs]
        q = max(1, len(ttft) // 4)
        print(json.dumps({"rate_per_s": rate, "metrics": metrics, "due": len(reqs),
                          "with_first_token": sum(r["t_first"] is not None for r in reqs),
                          "ttft_median_by_quarter_s": [float(np.median(ttft[i * q:(i + 1) * q]))
                                                       for i in range(4)]}), flush=True)
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
