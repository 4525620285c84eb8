"""The share of the traced window in which the card is idle and no thread
has a span of the program open other than a wait: the idle time that no
host span names, over the window."""

import host_spans


def read(ctx):
    split = host_spans.window_split(ctx)
    if split is None:
        return None
    return 100.0 * split["idle_us"].get(None, 0.0) / split["window_us"]
