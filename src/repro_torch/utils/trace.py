"""In-memory spans and events of the serving engine and the model step.

A ``Tracer`` keeps what it records in memory, for one reader when the run
ends; nothing goes to a file.  ``span(name, **attrs)`` is a context
manager that records its id, its parent's id (the span open around it),
name, start, end and attributes; ``event(name, t, **attrs)`` records a
point in time.  Times come from the tracer's ``clock``, which
``serve.ServeEngine`` sets to its own clock when the caller left it None,
so request stamps and spans share one axis; a clock the caller brings must
read that axis too, without moving it.

While a ``torch.profiler`` records, each span also opens
``torch.profiler.record_function("rt:<name>")``, so it shows in the Chrome
trace beside the device operations; ``SpanRec.profiled`` marks those spans,
which pair with their annotations in order and by name.

With no tracer attached a span site costs one test: callers write
``tr.span(...) if tr else NULL``.  The engine hands its tracer to the model
code through a context variable (``tracing``, read by ``current_tracer``),
in the style of ``sharding.ctx``.  Counters are not the tracer's: they live
on the engine (``ServeEngine.counters``) and count with no tracer attached.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Callable, NamedTuple

import torch

__all__ = ["NULL", "EventRec", "SpanRec", "Tracer", "current_tracer", "report_lines", "self_times",
           "summarize", "tracing"]

# a span site's stand-in when no tracer is attached (a nullcontext can be
# entered any number of times)
NULL = contextlib.nullcontext()

_TRACER: ContextVar["Tracer | None"] = ContextVar("tracer", default=None)


class SpanRec(NamedTuple):
    id: int
    parent: int | None
    name: str
    t0: float
    t1: float
    attrs: dict
    profiled: bool        # a profiler recorded its rt:<name> annotation


class EventRec(NamedTuple):
    name: str
    t: float
    attrs: dict


class _Span:
    __slots__ = ("tr", "name", "attrs", "id", "parent", "t0", "rf")

    def __init__(self, tr: "Tracer", name: str, attrs: dict):
        self.tr, self.name, self.attrs = tr, name, attrs

    def __enter__(self) -> "_Span":
        tr = self.tr
        self.id = tr._next_id
        tr._next_id += 1
        self.parent = tr._stack[-1] if tr._stack else None
        tr._stack.append(self.id)
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function("rt:" + self.name)
            self.rf.__enter__()
        # the clock is read inside the annotation, so the span lies within it
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self.tr
        t1 = tr.clock()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        tr._stack.pop()
        tr.spans.append(SpanRec(self.id, self.parent, self.name, self.t0, t1, self.attrs,
                                self.rf is not None))
        return False


class Tracer:
    """Spans (``spans``, appended as each closes) and events (``events``)
    of one run, on ``clock`` (seconds)."""

    def __init__(self, clock: Callable[[], float] | None = None):
        self.clock = clock
        self.spans: list[SpanRec] = []
        self.events: list[EventRec] = []
        self._stack: list[int] = []
        self._next_id = 0

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def event(self, name: str, t: float, **attrs) -> None:
        self.events.append(EventRec(name, t, attrs))


def current_tracer() -> Tracer | None:
    """The tracer the engine attached for the model call, or None."""
    return _TRACER.get()


@contextlib.contextmanager
def tracing(tr: Tracer | None):
    """Record the enclosed model calls' spans on ``tr``; None is a no-op."""
    if tr is None:
        yield
        return
    token = _TRACER.set(tr)
    try:
        yield
    finally:
        _TRACER.reset(token)


def self_times(spans: list[SpanRec]) -> dict[int, float]:
    """Each span's self time, by id: its duration less the part of it that
    its child spans cover (the union of their intervals, clipped to it)."""
    kids: dict[int, list[tuple[float, float]]] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.t0, s.t1))
    out = {}
    for s in spans:
        covered, end = 0.0, s.t0
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, end), min(b, s.t1)
            if b > a:
                covered += b - a
                end = b
        out[s.id] = (s.t1 - s.t0) - covered
    return out


def summarize(spans: list[SpanRec]) -> dict[str, dict]:
    """Count, total seconds and self seconds of each span name."""
    own = self_times(spans)
    out: dict[str, dict] = {}
    for s in spans:
        d = out.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        d["count"] += 1
        d["total_s"] += s.t1 - s.t0
        d["self_s"] += own[s.id]
    return out


def report_lines(spans: list[SpanRec]) -> list[str]:
    """An operator's reading of ``spans``, one item a line: each name's
    count, total and self seconds, by self seconds; then each attribute by
    value, the spans' count and mean milliseconds, where it takes at most 8
    values (a macro_step's ``k``, a control's ``n_parity``), else the range
    of its values and the value whose spans were slowest."""
    out = [f"span {name}: {v['count']} x, {v['total_s']:.4f} s, self {v['self_s']:.4f} s"
           for name, v in sorted(summarize(spans).items(), key=lambda kv: -kv[1]["self_s"])]
    by: dict[tuple[str, str], dict] = {}
    for s in spans:
        for key, v in s.attrs.items():
            acc = by.setdefault((s.name, key), {}).setdefault(v, [0, 0.0])
            acc[0] += 1
            acc[1] += s.t1 - s.t0
    for (name, key), vals in sorted(by.items()):
        mean = {v: 1e3 * t / n for v, (n, t) in vals.items()}
        if len(vals) <= 8:
            out.append(f"attr {name} {key}: " + ", ".join(
                f"{v}: {n} x {mean[v]:.3f} ms" for v, (n, _) in sorted(vals.items())))
        else:
            slow = max(mean, key=mean.get)
            out.append(f"attr {name} {key}: {len(vals)} values {min(vals)}-{max(vals)}, "
                       f"slowest {slow} at {mean[slow]:.3f} ms mean")
    return out
