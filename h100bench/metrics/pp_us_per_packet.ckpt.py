"""Host microseconds a packet in the packet plane: the time of the
program's ``pp.write`` and ``pp.read`` spans inside the traced window over
the packets they carried (each span's count taken in the share of it that
lies inside the window)."""

import host_spans


def read(ctx):
    split = host_spans.window_split(ctx)
    if split is None:
        return None
    packets = sum(split["packets"].get(name, 0.0) for name in host_spans.PACKET_SPANS)
    if not packets:
        return None
    return sum(split["span_us"].get(name, 0.0) for name in host_spans.PACKET_SPANS) / packets
