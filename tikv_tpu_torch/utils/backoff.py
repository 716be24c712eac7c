"""Bounded exponential backoff with jitter + deadline propagation.

A copy of the JAX package's ``utils/backoff.py``.  The client's retries
(region lookup, the leader retry, 2PC, the SST ingest) and the raft
transport's reconnects use it.

Reference: client-go's retry.Backoffer (exponential sleep classes with
equal-jitter, budgeted by a per-request deadline that every nested RPC
inherits).  Fixed retry counts with constant sleeps — what the client
used before — behave badly under real faults: they hammer a recovering
leader in lockstep and give up after an arbitrary number of attempts
regardless of how much of the caller's time budget remains.

``Backoff`` owns both halves:

- the sleep schedule: ``base * 2^attempt`` capped at ``cap``, jittered
  over the upper half of the window (equal jitter) so concurrent
  retriers decorrelate;
- the deadline: ``sleep()`` never sleeps past it and returns False once
  it is exhausted, and ``rpc_timeout()`` clamps any per-RPC timeout to
  the remaining budget — the deadline propagates through every hop
  instead of each hop re-deciding its own patience.
"""

from __future__ import annotations

import random
import time
from typing import Optional


class Backoff:
    def __init__(self, base: float = 0.02, cap: float = 1.0,
                 deadline_s: Optional[float] = None,
                 rng: Optional[random.Random] = None,
                 jitter: tuple = (0.5, 1.0)):
        """``deadline_s``: total time budget from now (None = unbounded).
        ``rng``: jitter source — inject a seeded Random for
        deterministic schedules (the chaos harness does).
        ``jitter``: (lo, hi) fractions of the exponential window the
        delay is drawn from — (0.5, 1.0) is equal jitter; a narrower
        high band like (0.8, 1.0) trades decorrelation for a tighter
        growth guarantee (the raft transport wants the latter)."""
        self.base = base
        self.cap = cap
        self.attempt = 0
        self.jitter = jitter
        self._rng = rng if rng is not None else random
        self._deadline = (time.monotonic() + deadline_s
                          if deadline_s is not None else None)

    def remaining(self) -> float:
        if self._deadline is None:
            return float("inf")
        return self._deadline - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def rpc_timeout(self, want: float) -> float:
        """Clamp a per-RPC timeout to the remaining budget (always > 0;
        callers check expired() to stop retrying)."""
        return max(0.001, min(want, self.remaining()))

    def next_delay(self) -> float:
        window = min(self.cap, self.base * (2 ** self.attempt))
        # jittered within [lo, hi]·window: progress guarantees without
        # the full synchronized burst
        lo, hi = self.jitter
        return window * lo + self._rng.uniform(0, window * (hi - lo))

    def sleep(self, hint_s: Optional[float] = None) -> bool:
        """Back off once.  → False when the deadline is exhausted (the
        caller should raise its last error instead of sleeping).

        ``hint_s``: a server-supplied retry-after (the ``retry_after_ms``
        a busy read pool derives from its queue depth).  When given it
        replaces the blind exponential delay — the server knows its own
        drain rate better than our jitter schedule does — with a small
        jitter on top so hinted retriers still decorrelate."""
        from .failpoint import fail_point
        fail_point("backoff::before_sleep")
        if hint_s is not None and hint_s > 0:
            delay = hint_s * (1.0 + 0.1 * self._rng.random())
        else:
            delay = self.next_delay()
        rem = self.remaining()
        if rem <= 0:
            return False
        time.sleep(min(delay, rem))
        self.attempt += 1
        return not self.expired()
