"""The busy signal and the completion pool of the serving path.

A trimmed copy of the JAX package's ``server/read_pool.py``:
``ServerIsBusy`` (:55), the rejection a shed request gets, with a
``retry_after_ms`` hint; and ``CompletionPool`` (:293), the small worker
pool on which deferred device fetches and their host finalizes run, so
requests in flight overlap their transfer waits.  The read pool's
admission control, its per-class service-time EWMAs and the resource
groups' shedding are not ported (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time

from ..utils import tracker


class ServerIsBusy(Exception):
    """Rejected now; ``retry_after_ms`` says when to try again (0: no
    hint)."""

    def __init__(self, reason: str = "read pool saturated",
                 retry_after_ms: int = 0):
        super().__init__(reason)
        self.reason = reason
        self.retry_after_ms = retry_after_ms


class CompletionPool:
    """Worker threads that overlap deferred device completions.

    A device request dispatches on its caller's thread and hands the
    blocking fetch and the host finalize here.  The workers spend their
    time inside the wait for the copy (the interpreter lock released), so
    ``workers`` fetches overlap.  Two priorities: ``high`` (small
    aggregate states) drains before ``normal`` (bulk row readbacks).  A
    task's result rides a ``concurrent.futures.Future``; its time in the
    queue is the request's ``completion_queue_wait`` phase.

    ``shutdown()`` lets the workers finish the queue, then joins them;
    the workers are daemon threads, started at the first submit."""

    def __init__(self, workers: int = 4):
        self._workers = max(1, workers)
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._high: list = []
        self._normal: list = []
        self._threads: list = []
        self._shutdown = False

    def submit(self, fn, priority: str = "normal") -> cf.Future:
        cur = tracker.current()
        if cur is not None:
            t_enq = time.perf_counter_ns()
            inner = fn

            def fn():
                tok = tracker.adopt(cur)
                try:
                    tracker.add_phase("completion_queue_wait",
                                      time.perf_counter_ns() - t_enq)
                finally:
                    tracker.uninstall(tok)
                return inner()
        fut: cf.Future = cf.Future()
        with self._mu:
            if self._shutdown:
                fut.set_exception(RuntimeError("completion pool is shut "
                                               "down"))
                return fut
            (self._high if priority == "high" else
             self._normal).append((fn, fut))
            if not self._threads:
                for i in range(self._workers):
                    t = threading.Thread(target=self._worker, daemon=True,
                                         name=f"copr-completion-{i}")
                    self._threads.append(t)
                    t.start()
            self._cv.notify()
        return fut

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop taking work; the workers finish the queue and exit, joined
        here."""
        with self._mu:
            self._shutdown = True
            self._cv.notify_all()
            threads = list(self._threads)
        for t in threads:
            t.join(timeout)

    def _worker(self) -> None:
        while True:
            with self._mu:
                while not self._high and not self._normal:
                    if self._shutdown:
                        return
                    self._cv.wait()
                fn, fut = (self._high or self._normal).pop(0)
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — rides the future
                fut.set_exception(e)
