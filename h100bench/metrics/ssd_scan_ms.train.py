"""Device ms a train step of the kernels launched inside the benchmark's
``ssd_scan`` range: the Mamba-2 chunked scan, forward (and its
recomputation) and backward, from the profiler's trace."""


def read(ctx):
    steps = ctx["work"].get("steps")
    seconds = ctx["summary"]["range_s"].get("ssd_scan", 0.0)
    if not steps or not seconds:
        return None
    return 1e3 * seconds / steps
