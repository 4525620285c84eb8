"""The Mamba-2 scan's share of the bf16 peak: the chunked SSD's FLOPs as a
remat step runs it (the work it needs: 2 (Q^2 N / (2 H / G) + Q^2 P / 2 +
2 Q N P) a chunk, a head and a row, the C.B scores once a group over the
causal half; four passes: forward, recomputation, a backward of twice),
counted from the configuration's shapes, over the ``ssd_scan`` range's
device time, over 989 TFLOP/s."""

from work import PEAK_BF16_FLOPS


def read(ctx):
    w = ctx["work"]
    seconds = ctx["summary"]["range_s"].get("ssd_scan", 0.0)
    if not w.get("steps") or not w.get("ssd_flops_per_step") or not seconds:
        return None
    return 100.0 * w["steps"] * w["ssd_flops_per_step"] / seconds / PEAK_BF16_FLOPS
