"""The flight lane: analytic per-request schedules for streaming sPIN-EC.

The batched engine removes closure allocations and batches the per-tick
heap drain, but a 1 MiB sPIN-TriEC request still costs ~7800 heap events
(5+ per packet: egress/arrive/deliver plus the HPU pipeline steps).  The
flight lane replaces all of them with one computation at injection time:
the request's per-packet state is packed into NumPy arrays and stepped
through the same FIFO/pool recurrences the event path executes one
callback at a time —

* client egress — exclusive FIFO, so service ends are a plain ``cumsum``;
* node ingress — Lindley recurrence in closed form,
  ``end_i = S_i + max_{j<=i}(a_j - S_{j-1})`` (``np.maximum.accumulate``);
* HPU pools — an H-server frontier (heap of busy-until times) stepped in
  admission order, with the HH request gate and the handler-holds-HPU-
  until-egress-accepts coupling of :mod:`repro_torch.sim.pspin` reproduced in a
  tight scalar loop (the recurrence is coupled through emit bookings, so
  it cannot be expressed as a prefix scan);
* parity fan-in — the k intermediate streams are merged by ``argsort``
  and pushed through the same ingress/pool recurrences.

Only the k+m ack deliveries remain real events, so the request completes
through the untouched client ack path (`Protocol._register_ack`).

Contract (checked by ``tests/test_engines.py``):

* **Count metrics are exact**: packets sent, bytes in/out per node,
  handler counts, acks, completions, and the conservation ledger match
  the discrete engine bit-for-bit.
* **Times are deterministic but approximate**: a request books the whole
  of its packet schedule onto the persistent resource frontiers at issue
  time, so packet-level interleaving *across concurrently outstanding
  requests* is serialized in issue order.  Busy time (utilization) is
  exact; per-request latencies and queue-peak gauges deviate within a
  measured tolerance, converging in closed-loop steady state.
* **Engages only when nothing can perturb the schedule**: batched
  engines, no failure axes, no membership, no telemetry sampler, no
  duration cap (``Env.flight_lane`` + ``Workload`` guards).  Everything
  else falls back to the event-exact batched lane.
"""

from __future__ import annotations

import collections
import heapq

import numpy as np

from repro_torch.sim.network import _net_deliver
from repro_torch.sim.protocols import (
    ACK_WIRE,
    ec_data_ph_ns,
    ec_parity_ph_ns,
    write_header_extra,
)
from repro_torch.sim.pspin import HANDLER_NS


class _PoolLane:
    """Per-PsPIN-unit frontier: busy-until times of occupied HPUs (a
    heap, at most ``capacity`` entries) plus the starts of admitted-but-
    not-started handlers (the ``peak_queued`` gauge)."""

    __slots__ = ("active", "pending")

    def __init__(self):
        self.active: list[float] = []
        self.pending: collections.deque[float] = collections.deque()


class _Plan:
    """Static (size-dependent, request-independent) arrays for one
    (k, m, chunk) shape — shared by every request of that shape."""

    __slots__ = (
        "n", "w", "ser", "S", "Sx", "pns", "ph", "wp", "serp", "pnsp",
        "pcomp", "ser_all", "Sall", "sum_ser_all", "sum_Sx_all",
        "bytes_stream", "bytes_parity", "hh", "ch", "pch", "ackser",
        "pns_ack", "wp_tiled", "serp_tiled", "pnsp_tiled", "pcomp_tiled",
    )

    def __init__(self, cfg, pcfg, k: int, m: int, chunk: int, he: int):
        w = np.asarray(cfg.packets_of(chunk, he), dtype=np.float64)
        n = len(w)
        bpn = cfg.bytes_per_ns
        self.n = n
        self.w = w
        self.ser = w / bpn
        self.S = np.cumsum(self.ser)
        self.Sx = self.S - self.ser
        self.pns = np.asarray([pcfg.pipeline_ns(int(x)) for x in w])
        payload = w - cfg.rdma_header
        payload[0] -= he
        self.ph = np.asarray([ec_data_ph_ns(int(p), m) for p in payload])
        self.wp = cfg.rdma_header + payload
        self.serp = self.wp / bpn
        self.pnsp = np.asarray([pcfg.pipeline_ns(int(x)) for x in self.wp])
        self.pcomp = np.asarray([ec_parity_ph_ns(int(p)) for p in payload])
        # client send order is i-major, j-minor: k same-size packets per i
        self.ser_all = np.repeat(self.ser, k)
        self.Sall = np.cumsum(self.ser_all)
        self.sum_ser_all = float(self.Sall[-1])
        self.sum_Sx_all = float((self.Sall - self.ser_all).sum())
        self.bytes_stream = float(w.sum())
        self.bytes_parity = float(self.wp.sum())
        self.hh, _, self.ch = HANDLER_NS["ec_data_rs32"]
        self.pch = HANDLER_NS["ec_parity"][2]
        self.ackser = ACK_WIRE / bpn
        self.pns_ack = pcfg.pipeline_ns(ACK_WIRE)
        # parity fan-in: each data node contributes one emit per packet
        self.wp_tiled = np.tile(self.wp, k)
        self.serp_tiled = np.tile(self.serp, k)
        self.pnsp_tiled = np.tile(self.pnsp, k)
        self.pcomp_tiled = np.tile(self.pcomp, k)


def _lindley(a, ser, S, Sx, free_at):
    """Service-end times of a FIFO serial resource: arrivals ``a``
    (sorted), service times ``ser`` (cumsum ``S``, exclusive ``Sx``),
    frontier carry ``free_at``."""
    m = np.maximum.accumulate(a - Sx)
    if free_at > m[0]:
        m = np.maximum(m, free_at)
    return S + m


def _book_serial(res, a, ser, S, Sx):
    """Book one sorted arrival burst onto a FIFO resource, with the same
    accounting ``SerialResource.book`` keeps (busy/acquires/wait and the
    queue-depth peak, computed here via searchsorted instead of the
    pending-starts deque)."""
    end = _lindley(a, ser, S, Sx, res.free_at)
    starts = end - ser
    res.free_at = float(end[-1])
    res.busy_ns += float(S[-1])
    res.acquires += len(a)
    res.total_wait_ns += float((starts - a).sum())
    depth = int((np.arange(1, len(a) + 1)
                 - np.searchsorted(starts, a, side="right")).max())
    if depth > res.peak_queued:
        res.peak_queued = depth
    return end


class EcFlight:
    """Per-Env flight-lane state: persistent pool frontiers + plans."""

    def __init__(self, env):
        self.env = env
        self._lanes: dict[int, _PoolLane] = {}
        self._plans: dict[tuple, _Plan] = {}

    def _lane(self, node: int) -> _PoolLane:
        lane = self._lanes.get(node)
        if lane is None:
            lane = self._lanes[node] = _PoolLane()
        return lane

    def _plan(self, k: int, m: int, chunk: int, he: int) -> _Plan:
        key = (k, m, chunk, he)
        plan = self._plans.get(key)
        if plan is None:
            pcfg = self.env.pspin(1).cfg
            plan = self._plans[key] = _Plan(self.env.cfg, pcfg, k, m,
                                            chunk, he)
        return plan

    def _admit(self, lane: _PoolLane, pool, ready: float) -> float:
        """Admit one handler to an H-server FIFO pool at ``ready``;
        returns its start time and keeps the pool's wait/peak gauges."""
        active = lane.active
        while active and active[0] <= ready:
            heapq.heappop(active)
        if len(active) >= pool.capacity:
            start = heapq.heappop(active)
            pool.total_wait_ns += start - ready
            pend = lane.pending
            while pend and pend[0] <= ready:
                pend.popleft()
            pend.append(start)
            if len(pend) > pool.peak_queued:
                pool.peak_queued = len(pend)
        else:
            start = ready
        return start

    # ------------------------------------------------------------------
    # sPIN-TriEC (InterleavedEcInjector + SpinStreamSink/SpinParitySink)
    # ------------------------------------------------------------------

    def fly_ec(self, inj, pend) -> None:
        """Compute one interleaved-EC request's full schedule.  Runs at
        the injection event (``client_post_ns`` after issue), exactly
        where the event path would start sending packets."""
        p = inj.proto
        env = self.env
        net, sim = env.net, env.sim
        k, m = inj.k, inj.m
        p.mark_inject()
        size = p.req_size(pend)
        chunk = -(-size // k)
        he = write_header_extra(m)
        pl = self._plan(k, m, chunk, he)
        n = pl.n
        t = sim.now
        cl = pend.client
        rid = pend.rid
        pid = p.pid
        lat = env.cfg.link_latency_ns
        push = heapq.heappush

        # Coarse analytic spans: the flight lane computes the whole
        # schedule at once, so a sampled request gets one span per phase
        # (tagged ``analytic`` — traces stay honest about extrapolation)
        # instead of per-packet resource spans.
        tr = sim.tracer
        rec = None
        if tr is not None and tr.sampled(rid):
            fargs = {"analytic": True}

            def rec(name, cat, t0, t1, node=None, res=None):
                tr.record(name, cat, t0, t1, rid=rid, pid=pid, node=node,
                          resource=res, args=fargs)

        # -- client egress: exclusive FIFO, plain cumsum ----------------
        cnode = net.node(cl)
        eg = cnode.egress
        base = eg.free_at if eg.free_at > t else t
        ends_all = base + pl.Sall
        eg.free_at = float(ends_all[-1])
        eg.busy_ns += pl.sum_ser_all
        eg.acquires += k * n
        eg.total_wait_ns += k * n * (base - t) + pl.sum_Sx_all
        if k * n - 1 > eg.peak_queued:
            eg.peak_queued = k * n - 1  # the burst queues behind pkt 0
        cnode.bytes_out += k * pl.bytes_stream
        if rec is not None:
            rec("egress burst", "wire", base, float(ends_all[-1]),
                res="flight.wire")

        ack_times = []
        par_arrivals = [[] for _ in range(m)]  # per parity node
        ph_l = pl.ph.tolist()
        serp_l = pl.serp.tolist()

        # -- data nodes: ingress -> gated HH/PH pipeline -> parity emits
        for j in range(k):
            dnode = net.node(j + 1)
            unit = env.pspin(j + 1)
            pool = unit.hpus
            scale = unit.compute_scale
            lane = self._lane(j + 1)
            active = lane.active
            a = ends_all[j::k] + lat
            end = _book_serial(dnode.ingress, a, pl.ser, pl.S, pl.Sx)
            dnode.bytes_in += pl.bytes_stream
            deliver = end.tolist()
            pns_l = pl.pns.tolist()

            # HH (ungated, opens the request gate when it retires)
            start = self._admit(lane, pool, deliver[0] + pns_l[0])
            gate = start + pl.hh * scale
            push(active, gate)
            if len(active) > pool.peak:
                pool.peak = len(active)
            ht = pl.hh * scale
            st_ns = 0.0
            egf = dnode.egress.free_at
            eg_busy = 0.0
            eg_wait = 0.0
            last_fin = 0.0
            collect = [par_arrivals[pi].append for pi in range(m)]
            for i in range(n):
                # pre-gate packets re-enter the NIC pipeline at gate-open
                d = deliver[i]
                if d < gate:
                    d = gate
                start = self._admit(lane, pool, d + pns_l[i])
                cd = start + ph_l[i] * scale
                sp = serp_l[i]
                # the handler holds its HPU until egress accepted every
                # intermediate-parity emit (coupled recurrence)
                en = egf if egf > cd else cd
                for pi in range(m):
                    eg_wait += en - cd
                    en += sp
                    collect[pi](en + lat)
                egf = en
                eg_busy += m * sp
                push(active, en)
                if len(active) > pool.peak:
                    pool.peak = len(active)
                ht += en - start
                st_ns += en - cd
                if en > last_fin:
                    last_fin = en

            # CH: fires at the last PH retirement, acks the client
            start = self._admit(lane, pool, last_fin + pl.pns_ack)
            cd = start + pl.ch * scale
            st = egf if egf > cd else cd
            en = st + pl.ackser
            egf = en
            push(active, en)
            if len(active) > pool.peak:
                pool.peak = len(active)
            ht += en - start
            st_ns += en - cd
            eg_busy += pl.ackser
            eg_wait += st - cd
            ack_times.append((en + lat, j + 1, ("d", j)))

            dnode.egress.free_at = egf
            dnode.egress.busy_ns += eg_busy
            dnode.egress.acquires += m * n + 1
            dnode.egress.total_wait_ns += eg_wait
            dnode.bytes_out += m * pl.bytes_parity + ACK_WIRE
            unit.handler_count += n + 2
            unit.handler_time_ns += ht
            unit.stall_time_ns += st_ns
            if rec is not None:
                rec("data node", "hpu_exec", float(a[0]), en, node=j + 1,
                    res=f"flight.n{j + 1}")

        # -- parity nodes: merged fan-in -> XOR PHs -> stripe ack -------
        for pi in range(m):
            node_id = k + 1 + pi
            pnode = net.node(node_id)
            unit = env.pspin(node_id)
            pool = unit.hpus
            scale = unit.compute_scale
            lane = self._lane(node_id)
            active = lane.active

            arr = np.asarray(par_arrivals[pi])
            order = np.argsort(arr, kind="stable")
            a = arr[order]
            serp = pl.serp_tiled[order]
            Sp = np.cumsum(serp)
            end = _book_serial(pnode.ingress, a, serp, Sp, Sp - serp)
            pnode.bytes_in += k * pl.bytes_parity
            ready = (end + pl.pnsp_tiled[order]).tolist()
            comp = (pl.pcomp_tiled[order] * scale).tolist()

            last_fin = 0.0
            ht = 0.0
            for i in range(k * n):
                start = self._admit(lane, pool, ready[i])
                fin = start + comp[i]
                push(active, fin)
                if len(active) > pool.peak:
                    pool.peak = len(active)
                ht += comp[i]
                if fin > last_fin:
                    last_fin = fin

            # stripe-complete ack handler (counting predicate fires at
            # the chronologically last XOR retirement)
            start = self._admit(lane, pool, last_fin + pl.pns_ack)
            cd = start + pl.pch * scale
            peg = pnode.egress
            st = peg.free_at if peg.free_at > cd else cd
            en = st + pl.ackser
            push(active, en)
            if len(active) > pool.peak:
                pool.peak = len(active)
            peg.free_at = en
            peg.busy_ns += pl.ackser
            peg.acquires += 1
            peg.total_wait_ns += st - cd
            pnode.bytes_out += ACK_WIRE
            unit.handler_count += k * n + 1
            unit.handler_time_ns += ht + (en - start)
            unit.stall_time_ns += en - cd
            ack_times.append((en + lat, node_id, ("p", pi)))
            if rec is not None:
                rec("parity node", "hpu_exec", float(a[0]), en,
                    node=node_id, res=f"flight.n{node_id}")

        # -- acks travel back as real events through the normal client
        #    receive path, so completion/latency bookkeeping is untouched
        net.packets_sent += k * n * (1 + m) + k + m
        ack_times.sort()
        ci = cnode.ingress
        f = ci.free_at
        for t_a, src, tag in ack_times:
            st = t_a if t_a > f else f
            en = st + pl.ackser
            ci.busy_ns += pl.ackser
            ci.acquires += 1
            ci.total_wait_ns += st - t_a
            f = en
            sim.call(en, _net_deliver,
                     (cnode, src, cl, ACK_WIRE,
                      {"rid": rid, "ack": tag, "pid": pid}))
        ci.free_at = f
        if rec is not None:
            rec("acks", "wire", float(ack_times[0][0]), f, res="flight.wire")
