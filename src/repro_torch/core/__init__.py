"""The BPCC core (port of ``repro.core``): allocation, codes, simulator, adaptive
control, streaming and block-MDS decoding, coded ops and parity control."""
