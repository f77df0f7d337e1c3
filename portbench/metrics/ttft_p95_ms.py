"""95th percentile, over every request due in the window, of the time from
when it was due (its scheduled arrival, or when its client sent it) to its
first token; a request refused or without a first token by the window's
end counts at the window's remaining length."""
from portbench.metrics import percentile


def read(run):
    end = run["window_s"]
    return percentile((((r["t_first"] if r["t_first"] is not None else end) - r["due"]) * 1e3
                       for r in run["requests"]), 95)
