"""Admission + repair pacing: the control plane's actuator.

The paper's CPU-bypass claim (section VI) is measured with the NIC data
path to itself; under contention a background repair stream competes with
foreground traffic for the same links and HPU pools, and an unpaced
rebuild blows the foreground tail straight through its SLO.  The fix the
storage literature converges on is a token bucket: background work may
only inject bytes at a configured refill rate (with bounded burst), so
its interference is a dial instead of an accident.

:class:`TokenBucket` is the shared primitive — clock-agnostic (callers
pass ``now``; the sim feeds nanoseconds, the functional plane feeds
wall-clock seconds) and deterministic.  Two consumption modes:

  ``try_take``  admission control: take the tokens or refuse (the caller
                sheds the request and counts the drop);
  ``reserve``   pacing: always take, going into debt, and return how long
                the caller must delay so the configured rate holds (FIFO
                reservations — the classic leaky-bucket shaper).

:class:`RepairPacer` adapts the bucket to the functional plane's
wall-clock: ``StorageCluster.repair_node`` calls :meth:`RepairPacer.throttle`
per rebuilt shard and actually sleeps out the debt (injectable
clock/sleep keep tests fast and deterministic).
"""

from __future__ import annotations

import time


class TokenBucket:
    """Deterministic token bucket over an external clock.

    ``rate`` is tokens per time unit, ``burst`` the bucket depth; tokens
    are bytes everywhere in this repo.  ``now`` must be non-decreasing
    across calls (both the sim clock and ``time.monotonic`` guarantee
    this).
    """

    def __init__(self, rate: float, burst: float):
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        if burst <= 0:
            raise ValueError(f"burst must be positive, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)
        self.t_last = 0.0
        # ledger
        self.taken = 0
        self.shed = 0
        self.total_wait = 0.0

    def _refill(self, now: float) -> None:
        if now > self.t_last:
            self.level = min(self.burst, self.level + (now - self.t_last) * self.rate)
            self.t_last = now

    def available(self, now: float) -> float:
        self._refill(now)
        return max(0.0, self.level)

    def try_take(self, n: float, now: float) -> bool:
        """Admission: consume ``n`` tokens if the bucket holds them,
        else refuse (no debt — the request is shed)."""
        self._refill(now)
        if self.level >= n:
            self.level -= n
            self.taken += 1
            return True
        self.shed += 1
        return False

    def delay_until(self, n: float, now: float) -> float:
        """Time until the bucket could hold ``n`` tokens (nothing is
        consumed) — the backpressure delay for a closed-loop caller that
        waits instead of shedding."""
        self._refill(now)
        return max(0.0, (n - self.level) / self.rate)

    def reserve(self, n: float, now: float) -> float:
        """Pacing: consume ``n`` tokens unconditionally (the bucket may go
        negative) and return the delay after which the debt is repaid —
        the time the caller must wait before injecting.  Reservations are
        FIFO: back-to-back reserves queue behind each other's debt."""
        self._refill(now)
        self.level -= n
        self.taken += 1
        wait = max(0.0, -self.level / self.rate)
        self.total_wait += wait
        return wait


class RepairPacer:
    """Wall-clock shaper for functional-plane repair traffic.

    ``rate_MBps`` bounds the sustained rebuild byte rate;
    ``burst_bytes`` (default one second's worth) lets small repairs
    finish unthrottled.  ``clock``/``sleep`` are injectable for tests.
    """

    def __init__(
        self,
        rate_MBps: float,
        burst_bytes: float | None = None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        rate = rate_MBps * 1e6  # bytes per second
        self.bucket = TokenBucket(rate, burst_bytes if burst_bytes else rate)
        self._clock = clock
        self._sleep = sleep
        self._t0: float | None = None
        self.paced_bytes = 0
        self.paced_wait_s = 0.0

    def throttle(self, nbytes: int) -> float:
        """Account ``nbytes`` of repair traffic; sleep out any debt.
        Returns the wait that was served (seconds)."""
        now = self._clock()
        if self._t0 is None:
            # align the bucket clock to first use
            self._t0 = now
            self.bucket.t_last = 0.0
        wait = self.bucket.reserve(nbytes, now - self._t0)
        self.paced_bytes += nbytes
        if wait > 0:
            self.paced_wait_s += wait
            self._sleep(wait)
        return wait
