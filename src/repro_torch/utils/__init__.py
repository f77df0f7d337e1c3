"""Helpers (port of ``repro.utils``): deterministic PRNG, trees of tensors, and
op-level FLOP and byte counts with the roofline (``hlo``)."""
