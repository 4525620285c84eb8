"""The share of the traced window in which no operation ran on the card."""


def read(ctx):
    busy = ctx["summary"]["busy_s"]
    if not busy:
        return None
    return 100.0 * (1.0 - busy / ctx["window_s"])
