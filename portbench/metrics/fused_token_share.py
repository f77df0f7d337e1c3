"""Share of the window's tokens emitted by macro_step() calls that ran a
fused block (the engine's macro_blocks counter rose)."""


def read(run):
    c = run["counters"]
    return 100.0 * c["fused_tokens"] / c["tokens"] if c["tokens"] else None
