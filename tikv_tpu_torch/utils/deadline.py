"""Request deadline propagation.

A copy of the JAX package's ``utils/deadline.py`` (client-go budgets every
request with a deadline that nested work inherits; the coprocessor checks
it at admission and between stages).  The rule is fail fast, not fail
late: work whose deadline has expired is shed with a typed
``DeadlineExceeded`` instead of being executed.  A deadline rides a
thread-local (``install``/``uninstall``/``current``), so the endpoint,
the cost router and the coalescer read it without a parameter through
every layer.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class DeadlineExceeded(Exception):
    """Typed shed error; ``stage`` names where the work was shed."""

    def __init__(self, stage: str = "admission",
                 overrun_ms: float = 0.0):
        super().__init__(f"deadline exceeded at {stage} "
                         f"(overrun {overrun_ms:.1f}ms)")
        self.stage = stage
        self.overrun_ms = overrun_ms


class Deadline:
    """An absolute time budget (monotonic clock)."""

    __slots__ = ("_at",)

    def __init__(self, budget_s: float):
        self._at = time.monotonic() + budget_s

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(ms / 1000.0)

    def remaining(self) -> float:
        return self._at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, stage: str) -> None:
        rem = self.remaining()
        if rem <= 0:
            raise DeadlineExceeded(stage, overrun_ms=-rem * 1e3)


_local = threading.local()


def install(d: Optional[Deadline]):
    """Make ``d`` the current thread's deadline → a token for
    ``uninstall`` (deadlines nest)."""
    prev = getattr(_local, "deadline", None)
    _local.deadline = d
    return prev


def uninstall(token) -> None:
    _local.deadline = token


def current() -> Optional[Deadline]:
    return getattr(_local, "deadline", None)


def check_current(stage: str) -> None:
    """Shed the calling work unit if the installed deadline expired; no-op
    when none is installed."""
    d = getattr(_local, "deadline", None)
    if d is not None:
        d.check(stage)
