"""Continuous-batching serving engine with the coded LM head."""
from repro_torch.serve.engine import Request, ServeEngine  # noqa: F401
