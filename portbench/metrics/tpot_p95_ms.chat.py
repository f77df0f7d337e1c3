"""tpot_p95_ms in a cell whose host sets the pace (the device idle most of
the window), where the tail is a per-layer reading: the same number."""
from portbench.metrics import reader

read = reader("tpot_p95_ms")
