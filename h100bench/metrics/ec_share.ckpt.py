"""The share of the window's time spent inside the erasure layer's batched
encode and decode (``RSCode.encode_stripes``, ``RSCode.decode_stripes``,
host wall time of the benchmark's spans around them)."""


def read(ctx):
    ec = ctx["work"].get("ec_s")
    if not ec:
        return None
    return 100.0 * ec / ctx["window_s"]
