"""torch.cuda.max_memory_allocated() over the whole run, set-up included,
read when the window closes: what the deployment must hold."""


def read(run):
    return run["peak_bytes"] / 1e9
