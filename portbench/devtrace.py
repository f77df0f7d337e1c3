"""The device trace of a --trace 1 run: torch.profiler over a slice of the
window, reduced to device busy time, each kernel's device seconds and the
idle gaps by what the harness was doing.

The harness's own spans (``torch.profiler.record_function``, names
``pb:<label>``) bracket each of its calls into the engine and its own work
between them; a gap in which no operation ran on the device is labelled by
the span open at its midpoint: ``prefill`` (a macro_step that admitted),
``scalar_step``, ``fused_block``, ``admission`` (the harness stamping
tokens and sending requests) or ``client_wait`` (nothing to serve until
the next arrival).
"""
from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the substring of each hand-written kernel's symbol that names it in a trace
KERNEL_SYMBOLS = {"coded_matvec_decode": "DecodeTask", "ssd_chunk": "ssd_chunk_",
                  "ssd_combine": "ssd_combine_"}


def profiler():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for a, b in sorted(intervals):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    for a, b in merged:
        total += b - a
    return total, merged


def reduce(prof, labels: dict[str, str]) -> dict:
    """Busy and window seconds of the ``pb:slice`` span, device seconds a
    hand-written kernel, the ten device operations that took most time and
    the idle seconds by harness span.  ``labels`` maps a span's name to its
    label (a call's kind is known only after it returns)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    spans, dev = [], []
    lo = hi = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith("pb:"):
            if name == "pb:slice":
                lo, hi = ts, ts + dur
            else:
                spans.append((ts, ts + dur, labels.get(name, name[3:])))
        elif cat in DEVICE_CATS:
            dev.append((ts, ts + dur, name))
    if lo is None:
        raise RuntimeError("the trace has no pb:slice span")
    clipped = [(max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi]
    busy_us, merged = _union([(a, b) for a, b, _ in clipped])
    by_name: dict[str, float] = {}
    for a, b, n in clipped:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    kernel_s = {k: sum(t for n, t in by_name.items() if sym in n) / 1e6
                for k, sym in KERNEL_SYMBOLS.items()}
    # idle gaps, labelled by the innermost span open at the gap's midpoint
    spans.sort()
    gaps: dict[str, float] = {}
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        open_ = [s for s in spans if s[0] <= mid < s[1]]
        label = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "other"
        gaps[label] = gaps.get(label, 0.0) + (b - a)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (hi - lo) / 1e6,
        "kernel_s": kernel_s,
        "device_ops": [[n[:160], t / 1e6] for n, t in top_ops],
        "idle_gaps": [[n, t / 1e6] for n, t in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }
