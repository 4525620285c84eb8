"""The share of the traced window spent inside the packet plane's reads:
the program's ``pp.read`` spans (one a cell read: request, the node's read
handler, the response stream, reassembly), their union inside the window
over it."""

import host_spans


def read(ctx):
    return host_spans.share(ctx, ("pp.read",))
