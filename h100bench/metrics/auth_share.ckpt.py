"""The share of the traced window spent in the storage nodes' capability
checks: the program's ``pp.auth`` spans (inside the packet plane's writes
and reads), their union inside the window over it."""

import host_spans


def read(ctx):
    return host_spans.share(ctx, ("pp.auth",))
