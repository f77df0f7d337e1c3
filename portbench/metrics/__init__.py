"""One reader a metric: ``metrics/<name>.py`` defines ``read(run) -> float
| None`` and is loaded by the name that ``BENCHMARK.json`` gives the
metric.  A reader that finds nothing to read returns None, and the metric
is left out of the result line.

``run`` is the record of one run (``portbench/bench.py::record``):

  cfg, traffic       the configuration and traffic files (dicts)
  loop, n_slots      "open" | "closed"; the engine's slots
  setup_s            process start to the window's first request
  window_s           the measured window's seconds
  peak_bytes         torch.cuda.max_memory_allocated() at the window's close
  requests           one dict a request due in the window: due, t_admit,
                     t_first, t_last (seconds on the window's clock, None
                     where it never happened), n (tokens served in the
                     window), prompt_len, out_len, done, rejected
  counters           over the window: tokens (emitted), syncs, fused_tokens,
                     macro_blocks, calls
  trace              None, or the profiled slice of a --trace 1 run: busy_s,
                     window_s, kernel_s {kernel: device seconds},
                     bound_s {kernel: seconds the yardstick allows}
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    """The ``read`` function of metric ``name``."""
    path = HERE / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(values, q: float) -> float | None:
    """The q-th percentile (linear between order statistics), None when empty."""
    import numpy as np

    v = np.asarray(list(values), np.float64)
    return float(np.percentile(v, q)) if v.size else None
