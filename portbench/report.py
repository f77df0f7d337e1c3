"""The result line: a run's record read by the metric readers that
BENCHMARK.json names for its cell, with the device and the check."""
from __future__ import annotations

import json

from portbench.metrics import reader


def cell_metrics(bm: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``, each only where
    its ``workloads`` key (if any) names the cell."""
    group = bm["per_layer"] if trace else bm["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def result(bm: dict, workload: str, rec: dict, trace: bool, device: dict) -> dict:
    metrics = {}
    for m in cell_metrics(bm, workload, trace):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": rec["check"]["correct"], "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if trace and rec["trace"] is not None:
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = {k: v for k, v in rec["check"].items() if isinstance(v, dict)}
    return out


def check_lines(rec: dict) -> list[str]:
    """Each number compared, beside its limit, one a line."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in rec["check"].items() if isinstance(v, dict)]


def dumps(line: dict) -> str:
    return json.dumps(line, separators=(", ", ": "))
