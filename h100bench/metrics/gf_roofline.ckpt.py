"""The GF(2^8) product kernel's share of its roofline: the bytes its calls
need (data read once, result written once, from each call's shapes) over
3.35 TB/s, over the kernel's device time in the trace."""

from work import PEAK_HBM_BYTES

KERNEL = "gf_matmul_kernel"


def read(ctx):
    seconds = sum(s for name, s in ctx["summary"]["kernels_s"].items() if KERNEL in name)
    nbytes = ctx["work"].get("gf_bytes", 0)
    if not seconds or not nbytes:
        return None
    return 100.0 * nbytes / PEAK_HBM_BYTES / seconds
