"""Bounded retry: capped exponential backoff with seeded jitter.

Shared by both planes — delays are in the caller's clock unit
(nanoseconds for the timed injectors, steps for the harness clients).
Jitter is drawn from a caller-owned ``random.Random`` so every schedule
stays seed-reproducible.  Exhaustion is a value (:class:`RetryExhausted`
records appended to ``ReplicationHarness.client_errors`` or surfaced via
``Protocol._register_failure``), not an exception: a client giving up on
one op is an outcome the run should record and survive, and the
linearizability checker treats the abandoned op as pending.
"""

from __future__ import annotations

import dataclasses
import random


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    base: float
    mult: float = 2.0
    cap: float | None = None
    jitter: float = 0.2
    max_attempts: int = 10

    def __post_init__(self) -> None:
        if self.base <= 0 or self.mult < 1.0:
            raise ValueError(f"bad backoff: base={self.base} mult={self.mult}")
        if not 0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Timeout before retry number ``attempt + 1`` (attempt 0 = the
        wait after the first send)."""
        d = self.base * (self.mult ** attempt)
        if self.cap is not None:
            d = min(d, self.cap)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return d


@dataclasses.dataclass(frozen=True)
class RetryExhausted:
    client: int
    op_id: int
    kind: str
    key: int
    attempts: int
