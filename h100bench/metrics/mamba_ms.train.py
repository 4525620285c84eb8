"""Device ms a train step of the kernels launched inside the benchmark's
``mamba`` range and none inside it (the scan counts as ``ssd_scan``): the
Mamba-2 mixer's projections, convolution, gated norm and their casts, in
the forward and its recomputation, from the profiler's trace."""


def read(ctx):
    steps = ctx["work"].get("steps")
    seconds = ctx["summary"]["range_s"].get("mamba", 0.0)
    if not steps or not seconds:
        return None
    return 1e3 * seconds / steps
