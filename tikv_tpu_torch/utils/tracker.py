"""Per-request cost attribution: phases and labels of one request.

A trimmed copy of the calls the JAX package's ``utils/tracker.py`` offers
(components/tracker/src/lib.rs:16,32-40): a ``Tracker`` holds one
request's phase nanoseconds (``phases``) and labels (``labels``); the
serving layers attribute to whichever tracker is current in their context
(``install`` on the request's thread, ``adopt`` where a completion worker
or the coalescer's dispatcher takes the request over).  Phases the port
records: ``d2h_wait`` and ``host_materialize`` (the runner's fetch),
``completion_queue_wait`` (the completion pool), ``coalesce_wait`` (a
coalesced member's time in its window), ``host_exec`` (a request served
by the host pipeline) and ``shard_merge`` (the host's part of a mesh
request's cross-shard merge); labels ``backend``, ``router`` and
``degraded``.

The reference's span tree, follows-from links and trace buffer
(``tikv_tpu/utils/trace.py``) are not ported (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import contextvars
import threading
import time
from contextlib import contextmanager
from typing import Optional

_current: contextvars.ContextVar = contextvars.ContextVar("tracker",
                                                          default=None)


class Tracker:
    """One request's phases (name → ns) and labels (name → value)."""

    __slots__ = ("phases", "labels", "_mu")

    def __init__(self):
        self.phases: dict = {}
        self.labels: dict = {}
        self._mu = threading.Lock()

    def add(self, name: str, ns: int) -> None:
        with self._mu:
            self.phases[name] = self.phases.get(name, 0) + int(ns)

    def label(self, key: str, value: str) -> None:
        with self._mu:
            self.labels[key] = value


def install() -> tuple:
    """Create a tracker and make it current → (tracker, token for
    ``uninstall``)."""
    tr = Tracker()
    return tr, _current.set(tr)


def adopt(tr: Tracker) -> contextvars.Token:
    """Make an existing tracker current on this thread; pair with
    ``uninstall``."""
    return _current.set(tr)


def uninstall(token: contextvars.Token) -> None:
    _current.reset(token)


def current() -> Optional[Tracker]:
    return _current.get()


@contextmanager
def phase(name: str):
    """Attribute the enclosed wall time to ``name`` on the current tracker
    (nothing without one)."""
    tr = _current.get()
    if tr is None:
        yield None
        return
    t0 = time.perf_counter_ns()
    try:
        yield tr
    finally:
        tr.add(name, time.perf_counter_ns() - t0)


def add_phase(name: str, ns: int) -> None:
    """Attribute ``ns`` measured elsewhere to ``name``."""
    tr = _current.get()
    if tr is not None:
        tr.add(name, max(0, int(ns)))


def label(key: str, value: str) -> None:
    tr = _current.get()
    if tr is not None:
        tr.label(key, value)
