"""Device-to-host syncs a served token: the engine's sync_count over its
tokens_emitted, over the window."""


def read(run):
    c = run["counters"]
    return c["syncs"] / c["tokens"] if c["tokens"] else None
