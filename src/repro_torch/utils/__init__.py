"""Deterministic PRNG helpers (port of ``repro.utils``)."""
