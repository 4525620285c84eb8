"""The readers of the program's host spans (``host_spans.py``) on a
synthetic Chrome trace and span list.

    python3 -m pytest -q h100bench/tests
"""

from __future__ import annotations

import gzip
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import harness as h  # noqa: E402
import host_spans  # noqa: E402
import tracing  # noqa: E402

SPAN_METRICS = ("pp_write_share.ckpt", "pp_read_share.ckpt", "pp_us_per_packet.ckpt",
                "auth_share.ckpt", "hostcopy_share.ckpt", "idle_unnamed.ckpt")


def row(t0, t1, name, thread=1, wait=False, packets=0):
    return (float(t0), float(t1), name, thread, wait, packets)


def test_spans_count_for_their_part_inside_the_window():
    spans = [row(0, 200, "pp.write", packets=10),       # half inside
             row(150, 250, "pp.write", thread=2),       # overlaps the first: counted once
             row(400, 600, "pp.read", packets=4),       # wholly inside
             row(1100, 1200, "pp.read", packets=99)]    # wholly outside
    out = host_spans.attribute((100.0, 1100.0), [], spans)
    assert out["window_us"] == 1000.0
    assert out["time_us"] == {"pp.write": 150.0, "pp.read": 200.0}
    assert out["span_us"] == {"pp.write": 200.0, "pp.read": 200.0}
    assert out["packets"] == {"pp.write": 5.0, "pp.read": 4.0}


def test_the_card_busy_is_owned_by_nobody_and_idle_by_the_latest_span():
    spans = [row(0, 1000, "ckpt.save", thread=1),
             row(200, 600, "ckpt.write", thread=2),
             row(300, 400, "pp.write", thread=2)]
    out = host_spans.attribute((0.0, 1000.0), [(100.0, 150.0), (350.0, 380.0)], spans)
    assert out["idle_us"] == pytest.approx({"ckpt.save": 100.0 + 50.0 + 400.0,
                                            "ckpt.write": 100.0 + 200.0,
                                            "pp.write": 50.0 + 20.0})
    assert None not in out["idle_us"]


def test_a_thread_that_only_waits_names_nothing():
    spans = [row(0, 1000, "ckpt.save", thread=1),
             row(100, 900, "ckpt.wait", thread=1, wait=True),
             row(200, 500, "ckpt.write", thread=2)]
    out = host_spans.attribute((0.0, 1000.0), [], spans)
    assert out["idle_us"] == pytest.approx({"ckpt.save": 200.0, "ckpt.write": 300.0,
                                            None: 500.0})


def test_a_long_span_owns_the_gaps_between_more_than_64_shorter_ones():
    """The lookup of ``tracing._Spans`` walks back at most 64 spans that
    started earlier, so it misses the outer span here; the sweep does not."""
    spans = [row(0, 10_000, "ckpt.restore")]
    spans += [row(100 * i + 10, 100 * i + 60, "pp.read") for i in range(90)]
    out = host_spans.attribute((0.0, 10_000.0), [], spans)
    assert out["idle_us"] == pytest.approx({"pp.read": 90 * 50.0,
                                            "ckpt.restore": 10_000.0 - 90 * 50.0})
    lookup = tracing._Spans([(t0, t1, name) for t0, t1, name, *_ in spans])
    assert lookup.at(100 * 80 + 80) is None          # the defect the sweep avoids


def trace_file(tmp_path: Path, base_ns: int) -> Path:
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1}

    events = [x("user_annotation", tracing.WINDOW, 1000.0, 1000.0),
              x("gpu_memcpy", "Memcpy DtoH", 900.0, 200.0),      # busy 1000-1100 inside
              x("kernel", "gf_matmul_kernel", 1500.0, 100.0)]
    path = tmp_path / "cell.json.gz"
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base_ns}, fh)
    return path


class FakeSpan:
    def __init__(self, name, t0_us, t1_us, base_ns, node=1, cat="host", **args):
        self.name, self.cat, self.node, self.resource = name, cat, node, f"host.{node}"
        self.t0 = base_ns + int(t0_us * 1000)
        self.t1 = base_ns + int(t1_us * 1000)
        self.args = args or None


def test_the_readers_over_a_traced_window(tmp_path, monkeypatch):
    base = 1_790_000_000_000_000_000
    path = trace_file(tmp_path, base)
    spans = [FakeSpan("ckpt.save", 900, 1500, base),
             FakeSpan("ckpt.snapshot", 950, 1100, base, bytes=1),
             FakeSpan("ckpt.wait", 1100, 1500, base, cat="wait"),
             FakeSpan("ckpt.write", 1100, 1500, base, node=2),
             FakeSpan("pp.write", 1200, 1400, base, node=2, packets=40),
             FakeSpan("pp.auth", 1200, 1250, base, node=2, ok=True),
             FakeSpan("copy.h2d", 1450, 1480, base, node=2, bytes=1),
             FakeSpan("ckpt.restore", 1600, 1900, base),
             FakeSpan("pp.read", 1600, 1700, base, packets=10)]
    monkeypatch.setattr(host_spans, "program_spans", lambda: (spans, 0))
    monkeypatch.setattr(host_spans, "trace_path", lambda: path)
    got = {name: h.reader_of(name)({}) for name in SPAN_METRICS}
    assert got["pp_write_share.ckpt"] == pytest.approx(20.0)
    assert got["pp_read_share.ckpt"] == pytest.approx(10.0)
    assert got["auth_share.ckpt"] == pytest.approx(5.0)
    assert got["pp_us_per_packet.ckpt"] == pytest.approx(300.0 / 50)
    assert got["hostcopy_share.ckpt"] == pytest.approx(10.0 + 3.0)   # 1000-1100, 1450-1480
    # idle and unnamed: 1900-2000 (over 1100-1500 the writer's thread names the idle card)
    assert got["idle_unnamed.ckpt"] == pytest.approx(10.0)


def test_readers_say_nothing_without_the_programs_spans(tmp_path, monkeypatch):
    path = trace_file(tmp_path, 0)
    monkeypatch.setattr(host_spans, "trace_path", lambda: path)
    monkeypatch.setattr(host_spans, "program_spans", lambda: None)
    assert all(h.reader_of(name)({}) is None for name in SPAN_METRICS)
    monkeypatch.setattr(host_spans, "program_spans", lambda: ([FakeSpan("pp.write", 1, 2, 0)],
                                                              3))
    assert all(h.reader_of(name)({}) is None for name in SPAN_METRICS)   # spans were dropped
