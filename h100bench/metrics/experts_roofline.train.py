"""The routed experts' share of the bf16 peak: their products' FLOPs as a
remat step runs them (three products a pass over every (token, choice),
four passes: forward, recomputation, a backward of twice), counted from
the configuration's shapes, over the ``experts`` range's device time, over
989 TFLOP/s."""

from work import PEAK_BF16_FLOPS


def read(ctx):
    w = ctx["work"]
    seconds = ctx["summary"]["range_s"].get("experts", 0.0)
    if not w.get("steps") or not w.get("expert_flops_per_step") or not seconds:
        return None
    return 100.0 * w["steps"] * w["expert_flops_per_step"] / seconds / PEAK_BF16_FLOPS
