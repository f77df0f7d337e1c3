"""Dense decoder LM with the BPCC coded head (PyTorch port of ``repro.models``)."""
