"""The lower-precision control of a cell, on the chip: the readings that
its ``max_gap`` limit is set from.

    python3 portbench/control.py --workload glm4-9b.chat --seeds 11,12,13 --seconds 45

For each seed, one run of the cell as the benchmark runs it, then on the
same sampled requests the plain reference put in the program's place in
fp8 (every layer matmul's operands rounded through float8 e4m3, the
precision below the served bf16): the gap below the fp32 reference's best
of the token the control puts first at each position.  Prints a JSON line
a seed: the program's widest gap (a sound run's reading) and the
control's.  The benchmark's own runs never run the control.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import bench

    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next(w for w in bm["workloads"] if w["name"] == args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        rec = bench.run(wl, seed, args.seconds, False, device=device, t_start=t0, control=True)
        chk = rec["check"]
        print(json.dumps({"workload": wl["name"], "seed": seed,
                          "program_max_gap": chk["max_gap"]["value"],
                          "control_max_gap": chk["control_max_gap"],
                          "sampled_tokens": chk["sampled_tokens"],
                          "finished": chk["finished_min"]["value"],
                          "wall_s": time.monotonic() - t0}), flush=True)
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
