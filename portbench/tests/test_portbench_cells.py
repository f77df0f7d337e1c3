"""Each cell of BENCHMARK.json end to end on the CPU at its configuration's
smoke sizes (the port's plain kernels): a result line with the cell's
metrics, and the check passing."""
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

BM = json.loads((ROOT / "BENCHMARK.json").read_text())
# a cell kept out of BENCHMARK.json for a fault of the program on the card
# (PERF.md, Open questions); its files still run here at smoke sizes
KEPT_OUT = [{"name": "zamba2-1.2b.longprompt", "config": "zamba2-1.2b",
             "traffic": "longprompt-4k", "chips": 1}]
WORKLOADS = BM["workloads"] + KEPT_OUT
CELLS = [w["name"] for w in WORKLOADS]
SEED = 2 ** 31 + 11


def smoke_run(name, trace=False, seed=SEED, **kw):
    import torch

    from portbench import bench

    wl = next(w for w in WORKLOADS if w["name"] == name)
    return bench.run(wl, seed, 1.5, trace, device=torch.device("cpu"),
                     t_start=time.monotonic(), smoke=True, clock=bench.TickClock(0.01), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end(cell):
    from portbench import report

    rec = smoke_run(cell)
    line = report.result(BM, cell, rec, False, {"platform": "cpu"})
    json.loads(report.dumps(line))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, rec["check"]
    want = {m["name"] for m in report.cell_metrics(BM, cell, False)}
    assert set(line["metrics"]) == want
    for name in want - {"peak_mem_gb"}:
        assert line["metrics"][name]["value"] > 0, name
    assert rec["attempted"] > 0 and rec["counters"]["tokens"] > 0
    if "stragglers" in rec["traffic"]:
        assert [e["n_parity"] for e in rec["parity_events"]] == [3]


def test_traced_run_reads_per_layer_metrics():
    from portbench import report

    cell = "zamba2-1.2b.longprompt"
    rec = smoke_run(cell, trace=True)
    line = report.result(BM, cell, rec, True, {"platform": "cpu"})
    assert rec["trace"]["window_s"] > 0 and rec["trace"]["prefills"]
    assert "breakdown" in line and line["breakdown"]["idle_gaps"]
    # on the CPU no device operation runs: the roofline readers find nothing
    for name in ("fused_token_share", "syncs_per_token", "step_mfu", "device_idle_share"):
        assert name in line["metrics"], name
    assert "coded_matvec_decode_roofline" not in line["metrics"]
    assert line["metrics"]["step_mfu"]["value"] < 100
