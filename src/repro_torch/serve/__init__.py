"""Continuous-batching serving engine with the coded LM head, open-loop
traffic (``loadgen``) and the trace-driven scheduler (``scheduler``)."""
from repro_torch.serve.engine import Request, ServeEngine  # noqa: F401
from repro_torch.serve.loadgen import (  # noqa: F401
    ArrivalTrace,
    SLOClass,
    bursty_trace,
    poisson_trace,
    replay_trace,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    ScheduledRequest,
    ServeSimResult,
    ShardLatencyModel,
    StragglerInjection,
    TraceScheduler,
    simulate_serve,
    simulate_serve_batch,
)
