"""Median wait from when a request was due to its admission: the
scheduler's t_admit - t_arrival in the open loop, the harness's send stamp
to the start of the engine call that prefilled it in the closed loop."""
from portbench.metrics import percentile


def read(run):
    return percentile(((r["t_admit"] - r["due"]) * 1e3
                       for r in run["requests"] if r["t_admit"] is not None), 50)
