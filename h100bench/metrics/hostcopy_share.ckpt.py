"""The share of the traced window spent copying between the card and the
host: the program's ``ckpt.snapshot`` (a leaf's copy off the card),
``copy.h2d`` and ``copy.d2h`` spans (the erasure layer's uploads and
results), their union inside the window over it."""

import host_spans


def read(ctx):
    return host_spans.share(ctx, host_spans.HOST_COPIES)
