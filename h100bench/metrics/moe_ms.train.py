"""Device ms a train step of the kernels launched inside the benchmark's
``moe`` range and none inside it (the routed experts' products count as
``experts``): routing, the sort, gathers, the weighted combine and the
shared experts, in the forward and its recomputation, from the profiler's
trace."""


def read(ctx):
    steps = ctx["work"].get("steps")
    seconds = ctx["summary"]["range_s"].get("moe", 0.0)
    if not steps or not seconds:
        return None
    return 1e3 * seconds / steps
