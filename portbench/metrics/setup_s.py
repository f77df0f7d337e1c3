"""Process start to the first timed request: CUDA start, weights, the coded
head's encode, the cache, the warm-up traffic and its graph captures."""


def read(run):
    return run["setup_s"]
