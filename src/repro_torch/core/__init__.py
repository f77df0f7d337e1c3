"""Block-MDS coded ops, mask-keyed decoding and parity control (port of ``repro.core``)."""
