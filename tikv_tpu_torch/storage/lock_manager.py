"""Lock manager — pessimistic-lock waiters + deadlock detection.

A copy of the JAX package's ``storage/lock_manager.py``.  The port's node
gives its scheduler a ``LockManager`` over the local ``DeadlockDetector``:
a cycle through transactions waiting on this store is found, one across
stores is not (the proxy to the detector leader waits for the ``Detect``
RPC).

Reference: src/server/lock_manager/ — ``WaiterManager`` parks
pessimistic-lock requests that hit a conflicting lock until the holder
releases (or the wait times out), and the ``DeadlockDetector`` keeps a
wait-for graph, reporting a cycle to the waiter that would close it
(deadlock.rs; the reference elects the region-1 leader as the detector
authority — the networked path proxies detect calls the same way).
"""

from __future__ import annotations

import threading


class Deadlock(Exception):
    """The requested wait edge closes a cycle (deadlock.rs)."""

    def __init__(self, waiter_ts: int, holder_ts: int, key: bytes,
                 wait_chain=()):
        super().__init__(
            f"deadlock: txn {waiter_ts} waiting for {holder_ts}")
        self.waiter_ts = waiter_ts
        self.holder_ts = holder_ts
        self.key = key
        self.wait_chain = tuple(wait_chain)


class DeadlockDetector:
    """Wait-for graph with cycle check on edge insertion.

    ``detect(waiter, holder)`` adds waiter→holder and returns the cycle
    path if that edge closes one (the edge is NOT kept in that case —
    the waiter will error out, not wait).
    """

    def __init__(self):
        self._edges: dict[int, set[int]] = {}
        self._mu = threading.Lock()

    def detect(self, waiter_ts: int, holder_ts: int):
        with self._mu:
            # DFS from holder: a path back to waiter means a cycle
            stack = [(holder_ts, (holder_ts,))]
            seen = set()
            while stack:
                cur, path = stack.pop()
                if cur == waiter_ts:
                    return path
                if cur in seen:
                    continue
                seen.add(cur)
                for nxt in self._edges.get(cur, ()):
                    stack.append((nxt, path + (nxt,)))
            self._edges.setdefault(waiter_ts, set()).add(holder_ts)
            return None

    def remove_edge(self, waiter_ts: int, holder_ts: int) -> None:
        with self._mu:
            s = self._edges.get(waiter_ts)
            if s is not None:
                s.discard(holder_ts)
                if not s:
                    del self._edges[waiter_ts]

    def clean_up(self, txn_ts: int) -> None:
        """Txn finished: drop its outgoing edges (incoming edges die
        when their waiters wake and re-detect)."""
        with self._mu:
            self._edges.pop(txn_ts, None)


class WaiterManager:
    """Per-key wait queues (waiter_manager.rs)."""

    def __init__(self):
        self._waiters: dict[bytes, list] = {}
        self._mu = threading.Lock()

    def wait_for(self, key: bytes, timeout_s: float) -> bool:
        """Park until the key's lock is released or timeout.
        Returns True if woken (retry makes sense)."""
        ev = threading.Event()
        with self._mu:
            self._waiters.setdefault(key, []).append(ev)
        woken = ev.wait(timeout_s)
        with self._mu:
            lst = self._waiters.get(key)
            if lst is not None:
                try:
                    lst.remove(ev)
                except ValueError:
                    pass
                if not lst:
                    del self._waiters[key]
        return woken

    def wake_up(self, keys) -> None:
        with self._mu:
            events = []
            for k in keys:
                events.extend(self._waiters.get(k, ()))
        for ev in events:
            ev.set()


class LockManager:
    """Facade the scheduler talks to.

    ``detector``: a DeadlockDetector, or any object with the same
    detect/clean_up surface — the networked node injects a proxy that
    forwards to the cluster's detector leader (lock_manager/client.rs).
    """

    def __init__(self, detector=None):
        self.detector = detector if detector is not None \
            else DeadlockDetector()
        self.waiters = WaiterManager()

    def wait_for(self, waiter_ts: int, key: bytes, holder_ts: int,
                 timeout_s: float) -> bool:
        cycle = self.detector.detect(waiter_ts, holder_ts)
        if cycle:
            raise Deadlock(waiter_ts, holder_ts, key, cycle)
        try:
            return self.waiters.wait_for(key, timeout_s)
        finally:
            self.detector.remove_edge(waiter_ts, holder_ts)

    def on_release(self, txn_ts: int, keys) -> None:
        self.detector.clean_up(txn_ts)
        self.waiters.wake_up(keys)
