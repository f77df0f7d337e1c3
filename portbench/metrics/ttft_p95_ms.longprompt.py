"""Time to first token's 95th percentile in the closed-loop long-prompt
cell: the same number as ``ttft_p95_ms``, a per-layer reading there since
its runs spread by 22 % (trimmed, in a set of 6; PERF.md) where no bound
the check allows can hold it."""
from portbench.metrics import reader

read = reader("ttft_p95_ms")
