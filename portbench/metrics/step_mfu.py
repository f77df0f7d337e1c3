"""Model FLOPs of the window's served tokens (prefills and decoded tokens,
by portbench.yardstick) over the chip's peak for the window's seconds."""
from portbench import yardstick


def read(run):
    cfg = run["cfg"]
    flops = sum(yardstick.request_flops(cfg, r["prompt_len"], r["n"]) for r in run["requests"])
    return 100.0 * flops / (yardstick.PEAK_OPS * run["window_s"]) if flops else None
