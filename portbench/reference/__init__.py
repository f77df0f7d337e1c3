"""Plain fp32 references of each configuration's forward pass.

Plain PyTorch with TF32 off, independent of the program: it imports
nothing of ``repro_torch`` (nor JAX) and reads only the seeded weights
that the benchmark made and handed to both sides.  One module per model
family, named by the configuration file's ``reference`` key.
"""
