"""The ssd_combine kernel's share of its roofline over the profiled slice: the
yardstick's bound for every launch in the slice over the kernel's device
time in the trace."""


def read(run):
    t = run["trace"] or {}
    kernel_s, bound_s = t.get("kernel_s", {}).get("ssd_combine"), t.get("bound_s", {}).get("ssd_combine")
    return 100.0 * bound_s / kernel_s if kernel_s and bound_s else None
