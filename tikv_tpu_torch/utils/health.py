"""Per-target transport circuit breaker.

A trimmed copy of the JAX package's ``utils/health.py``: ``CircuitOpen``
and ``CircuitBreaker``, which the client's per-store calls ride.  The
slow score, the slow trend and the ``HealthController`` the reference's
raftstore feeds wait for the raftstore's health controller.

Reference: client-go's per-store circuit breaking, and
components/health_controller/ for the store side.
"""

from __future__ import annotations

import threading
import time


class CircuitOpen(Exception):
    """A send was refused because the target's breaker is open."""

    def __init__(self, target):
        super().__init__(f"circuit open for {target}")
        self.target = target


class CircuitBreaker:
    """Per-target transport circuit breaker.

    Consecutive transport failures trip the breaker OPEN; after
    ``cooldown_s`` it goes HALF-OPEN and admits exactly ONE probe at a
    time — a success closes it, a failure re-opens (with the cooldown
    restarting).  Logical errors from a responsive server must NOT be
    recorded as failures: a NotLeader reply proves the store is alive.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 1.0):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._mu = threading.Lock()
        self._fails = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.trips = 0

    def state(self) -> str:
        with self._mu:
            if self._fails < self.threshold:
                return "closed"
            if time.monotonic() - self._opened_at < self.cooldown_s:
                return "open"
            return "half_open"

    def allow(self) -> bool:
        """→ True when a send may proceed.  In half-open, only one
        probe is admitted until it reports success/failure."""
        with self._mu:
            if self._fails < self.threshold:
                return True
            if time.monotonic() - self._opened_at < self.cooldown_s:
                return False
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self) -> None:
        with self._mu:
            self._fails = 0
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._mu:
            self._fails += 1
            self._probe_inflight = False
            if self._fails >= self.threshold:
                # trip, or re-open after a failed half-open probe — the
                # cooldown restarts either way
                self._opened_at = time.monotonic()
                if self._fails == self.threshold:
                    self.trips += 1

    def stats(self) -> dict:
        return {"state": self.state(), "consecutive_failures": self._fails,
                "trips": self.trips}
