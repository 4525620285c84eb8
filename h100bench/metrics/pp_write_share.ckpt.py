"""The share of the traced window spent inside the packet plane's writes:
the program's ``pp.write`` spans (one a cell written: packetize, delivery,
the nodes' handlers, the ack), their union inside the window over it."""

import host_spans


def read(ctx):
    return host_spans.share(ctx, ("pp.write",))
