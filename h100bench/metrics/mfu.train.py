"""The whole train step's share of the bf16 peak: the model FLOPs of the
steps in the traced window (6 x active params x tokens plus causal
attention, from the configuration) over the window's time, over 989 TFLOP/s."""

from work import PEAK_BF16_FLOPS


def read(ctx):
    w = ctx["work"]
    if not w.get("steps"):
        return None
    return 100.0 * w["steps"] * w["flops_per_step"] / ctx["window_s"] / PEAK_BF16_FLOPS
