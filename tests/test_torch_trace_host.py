"""Host spans of the port's checkpoint plane (``repro_torch.trace.host``).

Off by default: a save and a restore record nothing.  Under
``torch.profiler`` (or after ``enable()``) they record the span tree on
every thread, the checkpoint writer's included, on the profiler's clock,
with per-request packet counts that add up to the router's.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy, StorageCluster
from repro_torch.checkpoint.manager import flatten
from repro_torch.trace import host, to_chrome_trace, write_chrome_trace
from repro_torch.trace.tracer import Span

K, M, STRIPE = 6, 3, 6 * 4096


@pytest.fixture(autouse=True)
def clean_buffer():
    host.enable(False)
    host.TRACER.clear()
    yield
    host.enable(False)
    host.TRACER.clear()


def tree():
    gen = torch.Generator().manual_seed(7)
    return {"params": {"w": torch.randn(64, 200, generator=gen),
                       "b": torch.randn(300, generator=gen)},
            "opt": [torch.randn(1000, generator=gen).to(torch.bfloat16)],
            "step": torch.tensor(11)}


def cluster_and_manager():
    cluster = StorageCluster(num_nodes=K + M + 1, node_capacity=1 << 22, device="cpu")
    manager = CheckpointManager(cluster, CheckpointPolicy(k=K, m=M, stripe_bytes=STRIPE))
    return cluster, manager


def stripes_of(t) -> int:
    return sum(max(1, -(-x.numel() * x.element_size() // STRIPE)) for _, x in flatten(t))


def save_and_degraded_restore(cluster, manager, t, step=3):
    manager.save(step, t)               # async: the writer thread does the work
    manager.wait()
    first = cluster.meta.lookup(manager._manifests[step]["leaves"][0]["stripes"][0]["oid"])
    for coord in first.data_coords[:M]:
        cluster.fail_node(coord.node)
    return manager.restore(step)


def by_name(name):
    return [s for s in host.TRACER.spans if s.name == name]


def test_nothing_is_recorded_without_a_profiler_or_enable():
    cluster, manager = cluster_and_manager()
    got = save_and_degraded_restore(cluster, manager, tree())
    assert set(got) == {"params/w", "params/b", "opt/0", "step"}
    assert len(host.TRACER) == 0 and host.TRACER.dropped == 0
    # off, every site gets the same shared no-op, false in a boolean test
    assert host.span("a", bytes=1) is host.span("b")
    assert not host.span("a")


def test_a_profiled_save_and_degraded_restore_record_the_span_tree():
    cluster, manager = cluster_and_manager()
    t = tree()
    with profile(activities=[ProfilerActivity.CPU]):
        assert host.span("probe")        # recording, on this thread and every other
        got = save_and_degraded_restore(cluster, manager, t)
    assert not host.span("probe")
    for path, x in flatten(t):
        assert torch.equal(got["/".join(map(str, path))], x)
    names = {s.name for s in host.TRACER.spans}
    assert names == {"ckpt.save", "ckpt.snapshot", "ckpt.wait", "ckpt.write", "ec.encode",
                     "pp.write", "pp.auth", "ckpt.restore", "pp.read", "ec.decode",
                     "ckpt.assemble"}
    by_id = {s.sid: s for s in host.TRACER.spans}
    (save,), (write,), (restore,) = by_name("ckpt.save"), by_name("ckpt.write"), \
        by_name("ckpt.restore")
    # the writer's root span sits on its own thread, caused by the save
    assert write.node != save.node and write.resource != save.resource
    assert write.parent == save.sid and write.rid == save.rid == 3
    assert save.args == {"leaves": 4, "bytes": sum(x.numel() * x.element_size()
                                                   for _, x in flatten(t))}
    assert write.args == {"leaves": 4}

    def root(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s

    for s in by_name("pp.write") + [s for s in by_name("ec.encode") if s.node == write.node]:
        assert root(s) is save and s.rid == 3
    # the degraded restore's verify re-encodes on the caller's thread
    verify = [s for s in by_name("ec.encode") if s.node == save.node]
    assert verify
    for s in by_name("pp.read") + by_name("ec.decode") + by_name("ckpt.assemble") + verify:
        assert root(s) is restore and s.rid == 3
    for s in by_name("pp.auth"):
        assert by_id[s.parent].name in ("pp.write", "pp.read") and s.args == {"ok": True}
    assert all(s.cat == host.WAIT for s in by_name("ckpt.wait"))
    assert all(s.cat == host.HOST for s in host.TRACER.spans if s.name != "ckpt.wait")
    assert all(s.t0 <= s.t1 for s in host.TRACER.spans)
    assert host.TRACER.dropped == 0


def test_one_pp_write_a_cell_whose_packets_add_up_to_the_routers():
    cluster, manager = cluster_and_manager()
    t = tree()
    before = cluster.router.packets_delivered
    host.enable()
    manager.save(5, t, blocking=True)
    host.enable(False)
    writes = by_name("pp.write")
    assert len(writes) == (K + M) * stripes_of(t)
    assert sum(s.args["packets"] for s in writes) == cluster.router.packets_delivered - before
    layouts = [cluster.meta.lookup(s["oid"]) for leaf in manager._manifests[5]["leaves"]
               for s in leaf["stripes"]]
    assert sum(s.args["bytes"] for s in writes) == sum((K + M) * lay.chunk_len
                                                      for lay in layouts)
    assert len(by_name("pp.auth")) == len(writes)


def test_pp_read_counts_the_request_and_its_response_stream():
    cluster, manager = cluster_and_manager()
    t = {"x": torch.arange(4000, dtype=torch.int32)}
    manager.save(1, t, blocking=True)
    host.enable()
    got = manager.restore(1)
    host.enable(False)
    assert torch.equal(got["x"], t["x"])
    reads = by_name("pp.read")
    (layout,) = [cluster.meta.lookup(s["oid"]) for s in manager._manifests[1]["leaves"][0]
                 ["stripes"]]
    assert len(reads) == K           # healthy: the data cells alone
    mtu = cluster.nodes[0].mtu
    from repro_torch.core.packets import RDMA_HEADER_SIZE

    per_cell = 1 + -(-layout.chunk_len // (mtu - RDMA_HEADER_SIZE))
    assert [s.args for s in reads] == [{"packets": per_cell, "bytes": layout.chunk_len}] * K


def test_snapshot_bytes_are_the_leaves_bytes():
    cluster, manager = cluster_and_manager()
    t = tree()
    host.enable()
    manager.save(0, t, blocking=True)
    host.enable(False)
    snaps = by_name("ckpt.snapshot")
    assert [s.args["bytes"] for s in snaps] == [x.numel() * x.element_size()
                                                for _, x in flatten(t)]


def test_a_span_starts_on_the_profilers_clock(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):    # the first range opened takes a while
            pass
        for _ in range(3):
            with record_function("probe"), host.span("probe.host"):
                time.sleep(0.002)
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    doc = json.loads(out.read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))
    ranges = sorted(float(e["ts"]) for e in doc["traceEvents"]
                    if e.get("name") == "probe" and e.get("ph") == "X")
    spans = sorted((s.t0 - base) / 1e3 for s in by_name("probe.host"))
    assert len(ranges) == len(spans) == 3
    for ts, t0 in zip(ranges, spans):
        assert abs(ts - t0) < 1e3      # microseconds: within 1 ms


def test_spans_past_the_bound_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(host, "TRACER", host.HostTracer(max_spans=3))
    host.enable()
    for i in range(5):
        with host.span("s", i=i):
            pass
    assert [s.args["i"] for s in host.TRACER.spans] == [0, 1, 2]
    assert host.TRACER.dropped == 2


def test_parents_and_rids_follow_the_thread_local_stack():
    host.enable()
    seen = {}

    def other(parent):
        with host.span("root", rid=9, parent=parent) as r:
            with host.span("leaf") as leaf:
                seen["ids"] = (r.sid, leaf.sid)

    with host.span("outer", rid=4) as outer:
        with host.span("inner", wait=True):
            pass
        worker = threading.Thread(target=other, args=(outer.sid,))
        worker.start()
        worker.join()
    spans = {s.name: s for s in host.TRACER.spans}
    assert spans["inner"].parent == outer.sid and spans["inner"].rid == 4
    assert spans["inner"].cat == host.WAIT
    assert spans["outer"].parent is None
    assert spans["root"].parent == outer.sid and spans["root"].rid == 9
    assert spans["leaf"].parent == seen["ids"][0] and spans["leaf"].rid == 9
    assert spans["leaf"].node == spans["root"].node != spans["outer"].node


def test_host_spans_export_with_the_simulators_exporter(tmp_path):
    host.enable()
    with host.span("ckpt.save", rid=2, leaves=1):
        with host.span("pp.write", packets=3, bytes=10):
            pass
    doc = write_chrome_trace(host.TRACER, str(tmp_path / "host.json"))
    events = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert events["pp.write"]["args"]["packets"] == 3 and events["pp.write"]["args"]["rid"] == 2
    assert events["ckpt.save"]["dur"] >= events["pp.write"]["dur"] >= 0
    # the simulator's own spans export as before: no id or parent among their fields
    sim = host.HostTracer()
    sim.spans.append(Span("x", "wire", 0.0, 1000.0, rid=1, resource="n1.egress"))
    assert to_chrome_trace(sim)["traceEvents"][-1]["args"] == {"rid": 1, "policy": "?"}
    assert isinstance(by_name("pp.write")[0], Span)
    assert np.isclose(events["ckpt.save"]["ts"], by_name("ckpt.save")[0].t0 / 1e3)
