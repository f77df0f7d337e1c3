"""Every prompt token prefilled plus every token served inside the window,
over the window's seconds."""


def read(run):
    reqs = run["requests"]
    prefilled = sum(r["prompt_len"] for r in reqs if r["n"] > 0)
    served = sum(r["n"] for r in reqs)
    return (prefilled + served) / run["window_s"]
