"""The busiest expert's routed choices over the mean expert's, a routing
call at a time, averaged over the traced window's calls: the program's
device-side count of choices per expert (``moe.ROUTED``), read after the
window."""


def read(ctx):
    return ctx["work"].get("moe_load_max")
