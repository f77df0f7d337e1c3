"""95th percentile, over requests that got at least 2 tokens in the window,
of (last token's time - first token's time) / (tokens - 1)."""
from portbench.metrics import percentile


def read(run):
    return percentile(((r["t_last"] - r["t_first"]) / (r["n"] - 1) * 1e3
                       for r in run["requests"] if r["n"] >= 2), 95)
