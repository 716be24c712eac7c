"""Cross-request device batching: the cost router and the request
coalescer.

A trimmed copy of the JAX package's ``server/coalescer.py``.  Concurrent
device requests each paid their own launch and their own device→host
wait; the coalescer groups those that read one resident feed and share a
batch class (``DeviceRunner.batch_class``) into one dispatch:

- a ``("stack", ...)`` group (selections that differ only in their
  constants) runs as one ``sel_pred_batched`` launch with one shared
  fetch (``DeviceRunner.handle_batched``); a ``("share", ...)`` group
  (byte-identical plans) runs one solo dispatch whose fetch serves every
  member;
- a group closes on SIZE (``max_group`` members), WINDOW expiry
  (``window_ms``), deadline PRESSURE (a member is never held past the
  point where waiting would eat its remaining budget), the dispatcher
  running dry (PIPELINE: nothing staged or in flight, so the oldest open
  group goes early), or the ``copr::coalesce_window`` failpoint;
- IDLE BYPASS: a request that finds nothing parked and nothing in flight
  dispatches at once, so a serial workload never pays the window;
- each member resolves on the endpoint's completion pool: one fetch, N
  resolutions, each member's host gather on its own worker;
- a failed group never fails its members: a stacked launch that cannot
  run (``_BatchUnavailable``, the ``copr::coalesce_dispatch`` failpoint,
  any launch error) retries every member as a solo dispatch, counted in
  ``solo_degrade``; a fault in the shared fetch degrades each member to
  the host pipeline through the endpoint.

``CostRouter`` decides per request among four outcomes from a measured
cost model: ``device_batched``, ``device_solo``, ``host`` (the modeled
host cost clearly undercuts both device options; calibrated on the
endpoint's ``device_row_threshold``) and ``shed`` (the remaining deadline
cannot fit even the cheapest option: ``ServerIsBusy`` with a
``retry_after_ms`` hint).

Trimmed: the resource controller's fair selection of stacked members
(the reference leaves it off by default, so groups here are FIFO), RU
metering, trace spans and follows-from links, and ``submit_shared`` (the
plan IR's share class); ROADMAP.md queue 1 item 7 records them.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from collections import deque
from typing import Optional

from ..device.deferred import DeferredResult, _BatchUnavailable
from ..utils import deadline as dl_mod
from ..utils import tracker
from ..utils.failpoint import fail_point

DEVICE_BATCHED = "device_batched"
DEVICE_SOLO = "device_solo"
HOST = "host"
SHED = "shed"


def _resolver(d):
    """→ a call giving ``(result, degraded)`` for a runner's answer: a
    ``DeferredResult`` fetches (``degraded`` names a fetch that fell back
    to the host), a settled result is itself."""
    if isinstance(d, DeferredResult):
        return lambda: (d.result(), d.degraded)
    return lambda: (d, None)


class CostRouter:
    """Per-request admission from a measured cost model (coalescer.py:110).

    The launch cost is measured (an EWMA of observed group dispatch walls,
    seeded at ``LAUNCH_SEED_S``), and so is the group occupancy; the D2H
    bytes come from the runner's selectivity EWMAs for a selection (the
    packed mask, or less where the index or compact route undercuts it)
    and a small constant for an aggregation."""

    LAUNCH_SEED_S = 1.5e-3
    LAUNCH_ALPHA = 0.2
    OCC_ALPHA = 0.3
    # the modeled device→host rate: it only turns bytes into seconds
    D2H_BYTES_PER_S = 8e9
    AGG_D2H_BYTES = 1 << 16
    # the host model: at n == the endpoint's device_row_threshold the host
    # pipeline and a solo dispatch break even (what the threshold means),
    # so host cost is (n / threshold) × the live launch EWMA
    DEFAULT_ROW_THRESHOLD = 131072
    # the remaining budget must cover the cheapest option this many times
    SHED_MARGIN = 2.0
    # the host wins a device-vetted request only on a clear margin
    HOST_BIAS = 2.0

    def __init__(self, coalescer: "RequestCoalescer", runner):
        self._coalescer = coalescer
        self._runner = runner
        self._mu = threading.Lock()
        self.launch_ewma = self.LAUNCH_SEED_S
        self.occupancy_ewma = 1.0
        self.decisions: dict = {}

    def note_launch(self, wall_s: float, occupancy: int) -> None:
        """One group dispatched: fold its dispatch wall and its size into
        the model."""
        with self._mu:
            self.launch_ewma = (self.LAUNCH_ALPHA * wall_s +
                                (1 - self.LAUNCH_ALPHA) * self.launch_ewma)
            self.occupancy_ewma = (self.OCC_ALPHA * occupancy +
                                   (1 - self.OCC_ALPHA) *
                                   self.occupancy_ewma)

    def _d2h_bytes(self, dag, n: Optional[int]) -> float:
        """A member's modeled D2H payload: the packed mask (n/8) of a
        selection, scaled down by its selectivity EWMA where the index or
        compact route would undercut it; a small constant otherwise."""
        from ..device import selection as sm
        runner = self._runner
        plan = runner._analyze(dag)[0]
        if plan is None or plan.kind != "scan_sel" or not n:
            return float(self.AGG_D2H_BYTES)
        mask_bytes = n / 8.0
        pred = runner._sel_predict(runner._sel_keys(dag, plan))
        if pred is None:
            return mask_bytes
        route = sm.choose_route(n, pred * n, False)
        return float(min(mask_bytes,
                         sm.modeled_d2h_bytes(route, n, int(pred * n))))

    def _host_s_per_row(self, launch: float) -> float:
        ep = self._coalescer._endpoint
        thr = getattr(ep, "_device_row_threshold", 0) or \
            self.DEFAULT_ROW_THRESHOLD
        return launch / max(1, thr)

    def route(self, dag, storage) -> tuple:
        """→ ``(decision, batch_key, retry_after_ms)``: ``batch_key`` only
        for ``device_batched``, ``retry_after_ms`` only for ``shed``."""
        coal = self._coalescer
        est = getattr(storage, "estimated_rows", None)
        n = est() if callable(est) else None
        key = self._runner.batch_class(dag, storage) if coal.enabled \
            else None
        with self._mu:
            launch = self.launch_ewma
            occ = max(1.0, self.occupancy_ewma)
        busy = coal.busy()
        d2h_s = self._d2h_bytes(dag, n) / self.D2H_BYTES_PER_S
        # what each option consumes: dispatches serialize, so each member
        # in the backlog is about one launch ahead of this request; a
        # group absorbs the backlog max_group at a time.  The collection
        # wait is latency, not a cost: it enters the deadline terms only
        cost_solo = launch * (1.0 + busy) + d2h_s
        cost_batched = (launch * (1.0 + busy / coal.max_group) / occ +
                        d2h_s) if key is not None else float("inf")
        cost_host = n * self._host_s_per_row(launch) if n \
            else float("inf")
        wait = coal.expected_wait_s(key) if key is not None else 0.0
        best = min(cost_solo, cost_batched + wait, cost_host)
        dl = dl_mod.current()
        rem = dl.remaining() if dl is not None else None
        if rem is not None and rem < best * self.SHED_MARGIN:
            return self._note(SHED), None, max(1, int(best * 1e3))
        if cost_host * self.HOST_BIAS < min(cost_solo, cost_batched):
            return self._note(HOST), None, 0
        if key is not None and (
                rem is None or rem > 2.0 * self.SHED_MARGIN * cost_solo):
            # a budget too short for the whole window still batches: the
            # group's close tightens to its tightest member
            return self._note(DEVICE_BATCHED), key, 0
        return self._note(DEVICE_SOLO), None, 0

    def _note(self, decision: str) -> str:
        tracker.label("router", decision)
        with self._mu:
            self.decisions[decision] = self.decisions.get(decision, 0) + 1
        return decision

    def stats(self) -> dict:
        with self._mu:
            return {"launch_ewma_ms": round(self.launch_ewma * 1e3, 3),
                    "occupancy_ewma": round(self.occupancy_ewma, 3),
                    "decisions": dict(self.decisions)}


class _Member:
    """One request parked in a collection window."""

    __slots__ = ("dag", "storage", "future", "tracker", "deadline_at",
                 "t_submit_ns")

    def __init__(self, dag, storage, future, tr, deadline_at):
        self.dag = dag
        self.storage = storage
        self.future = future
        self.tracker = tr
        self.deadline_at = deadline_at
        self.t_submit_ns = time.perf_counter_ns()


class _Group:
    __slots__ = ("key", "members", "close_at", "window_close_at", "closed")

    def __init__(self, key, close_at: float):
        self.key = key
        self.members: list = []
        self.close_at = close_at            # only ever tightens
        self.window_close_at = close_at     # the untightened window
        self.closed = False


class RequestCoalescer:
    """The coalescing dispatcher (module doc), owned by an endpoint
    (``Endpoint(coalescer=...)`` binds it).  Its collector and dispatcher
    threads start at the first batched request; ``close()`` flushes every
    parked member and joins them."""

    # the post-dispatch reserve kept out of a member's deadline when its
    # group's close tightens: generous, since over-reserving only closes a
    # group a little early, while under-reserving would ack late
    RESERVE_FLOOR_S = 50e-3
    # a member spends at most this share of its remaining budget parked
    WAIT_FRACTION = 0.25

    def __init__(self, runner, window_ms: float = 2.0, max_group: int = 16):
        self._runner = runner
        self.window_s = max(0.0, window_ms) / 1e3
        self.max_group = max(1, int(max_group))
        self.enabled = True
        self.router = CostRouter(self, runner)
        self._endpoint = None
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._open: dict = {}
        self._ready: deque = deque()
        self._thread: Optional[threading.Thread] = None
        self._dispatcher: Optional[threading.Thread] = None
        # False: every group collects for its window (deterministic
        # tests); True: a lone request dispatches at once, and the
        # dispatcher feeds the oldest open group early when the device runs
        # dry (nothing staged, nothing unresolved)
        self.idle_bypass = True
        self._shutdown = False
        # members closed for dispatch whose futures have not resolved
        self._inflight = 0
        self.groups_dispatched = 0
        self.requests_coalesced = 0
        self.solo_degrade = 0
        self.occupancy_sum = 0
        self.max_observed_occupancy = 0
        self.closes: dict = {}

    # ---------------------------------------------------------- wiring

    def bind(self, endpoint) -> None:
        """Attach the owning endpoint (its completion pool, its row
        threshold)."""
        self._endpoint = endpoint

    def set_enabled(self, on: bool) -> None:
        """Off: the router routes every device request solo."""
        self.enabled = bool(on)

    def configure(self, window_ms: Optional[float] = None,
                  max_group: Optional[int] = None) -> None:
        with self._mu:
            if window_ms is not None:
                self.window_s = max(0.0, float(window_ms)) / 1e3
                self.enabled = window_ms > 0
            if max_group is not None:
                self.max_group = max(1, int(max_group))

    def route(self, dag, storage) -> tuple:
        return self.router.route(dag, storage)

    def busy(self) -> int:
        """The device backlog: members parked plus members dispatched and
        not yet resolved."""
        with self._mu:
            return self._inflight + sum(len(g.members)
                                        for g in self._open.values())

    def expected_wait_s(self, key) -> float:
        """The modeled collection wait of a request joining ``key`` now:
        the open group's remaining window, else half a window."""
        with self._mu:
            g = self._open.get(key)
            if g is not None and not g.closed:
                return max(0.0, g.close_at - time.monotonic())
        return self.window_s / 2.0

    # ---------------------------------------------------------- submit

    def submit(self, key, dag, storage) -> cf.Future:
        """Park one request in its group → a Future of ``(result,
        degraded)``.  Nothing here blocks beyond the group lock."""
        fut: cf.Future = cf.Future()
        dl = dl_mod.current()
        deadline_at = (time.monotonic() + dl.remaining()) \
            if dl is not None else None
        member = _Member(dag, storage, fut, tracker.current(), deadline_at)
        now = time.monotonic()
        reserve = max(self.RESERVE_FLOOR_S, 8.0 * self.router.launch_ewma)
        inline = False      # dispatch on this thread (after close only)
        with self._cv:
            if self._shutdown:
                g = _Group(key, now)
                g.members.append(member)
                g.closed = True
                self._inflight += 1
                self._note_close("shutdown")
                inline = True
            else:
                self._ensure_threads()
                g = self._open.get(key)
                if g is None or g.closed:
                    g = _Group(key, now + self.window_s)
                    self._open[key] = g
                g.members.append(member)
                if member.deadline_at is not None:
                    rem = member.deadline_at - now
                    g.close_at = min(g.close_at,
                                     member.deadline_at - reserve,
                                     now + self.WAIT_FRACTION * rem)
                parked = sum(len(og.members)
                             for og in self._open.values()) - 1
                reason = None
                if len(g.members) >= self.max_group:
                    reason = "size"
                elif fail_point("copr::coalesce_window") is not None:
                    reason = "failpoint"
                elif g.close_at <= now:
                    reason = "deadline"
                elif self.idle_bypass and self._inflight == 0 and \
                        parked == 0:
                    reason = "idle"
                if reason is not None:
                    self._close_locked(g, reason)
                # both loops wait on this condition: a tightened close_at
                # must wake the collector
                self._cv.notify_all()
        member.future.add_done_callback(self._on_member_done)
        if inline:
            self._dispatch(g)
        return fut

    # ----------------------------------------------------- group close

    def _note_close(self, reason: str) -> None:
        self.closes[reason] = self.closes.get(reason, 0) + 1

    def _close_locked(self, g: _Group, reason: str) -> None:
        if g.closed:
            return
        g.closed = True
        if self._open.get(g.key) is g:
            del self._open[g.key]
        self._ready.append(g)
        self._inflight += len(g.members)
        self._note_close(reason)
        self._cv.notify_all()

    def _on_member_done(self, _fut) -> None:
        with self._mu:
            self._inflight = max(0, self._inflight - 1)
            if self._inflight == 0:
                self._cv.notify_all()   # the device ran dry

    def _ensure_threads(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._collect_loop, daemon=True,
                name="copr-coalescer")
            self._thread.start()
        if self._dispatcher is None:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name="copr-dispatcher")
            self._dispatcher.start()

    def _collect_loop(self) -> None:
        """Closes the groups whose time is up; the dispatcher launches
        them, so group N+1 collects while group N launches."""
        while True:
            with self._cv:
                if self._shutdown:
                    return
                now = time.monotonic()
                nxt = None
                for g in list(self._open.values()):
                    if g.close_at <= now:
                        self._close_locked(
                            g, "window" if g.close_at >= g.window_close_at
                            else "deadline")
                    elif nxt is None or g.close_at < nxt:
                        nxt = g.close_at
                self._cv.wait(None if nxt is None
                              else max(1e-4, nxt - now))

    def _dispatch_loop(self) -> None:
        """Launches closed groups back to back; when nothing is staged or
        unresolved, closes the oldest open group early."""
        while True:
            g = None
            with self._cv:
                while not self._ready:
                    if self._shutdown:
                        return
                    if self.idle_bypass and self._inflight == 0 and \
                            self._open:
                        cand = min((og for og in self._open.values()
                                    if og.members),
                                   key=lambda og: og.close_at, default=None)
                        if cand is not None:
                            self._close_locked(cand, "pipeline")
                            break
                    self._cv.wait()
                if self._ready:
                    g = self._ready.popleft()
            if g is not None:
                self._dispatch(g)

    # -------------------------------------------------------- dispatch

    def _dispatch(self, group: _Group) -> None:
        members = group.members
        size = len(members)
        with self._mu:
            self.groups_dispatched += 1
            self.requests_coalesced += size
            self.occupancy_sum += size
            self.max_observed_occupancy = max(self.max_observed_occupancy,
                                              size)
        t0 = time.perf_counter()
        try:
            if fail_point("copr::coalesce_dispatch") is not None:
                raise _BatchUnavailable("copr::coalesce_dispatch")
            if group.key[0] == "stack" and size > 1:
                handle = self._runner.handle_batched(
                    [(m.dag, m.storage) for m in members])
                resolvers = [(lambda i=i: (handle.member_result(i), None))
                             for i in range(size)]
            else:
                # a singleton, or a share group of identical plans: one
                # solo dispatch whose memoized fetch serves every member
                d = self._runner.handle_request(
                    members[0].dag, members[0].storage, deferred=True)
                resolvers = [_resolver(d)] * size
        except Exception:   # noqa: BLE001 — a failed group never fails
            # its members: each retries as a solo dispatch
            self.router.note_launch(time.perf_counter() - t0, size)
            self._solo_fallback(members)
            return
        self.router.note_launch(time.perf_counter() - t0, size)
        t_dispatch_ns = time.perf_counter_ns()
        for m, resolve in zip(members, resolvers):
            self._complete(m, resolve, t_dispatch_ns - m.t_submit_ns)

    def _solo_fallback(self, members) -> None:
        with self._mu:
            self.solo_degrade += len(members)
        for m in members:
            t_ns = time.perf_counter_ns()
            try:
                d = self._runner.handle_request(m.dag, m.storage,
                                                deferred=True)
            except Exception as e:      # noqa: BLE001 — the member's wait
                # applies the endpoint's degrade policy to it
                if not m.future.done():
                    m.future.set_exception(e)
                continue
            self._complete(m, _resolver(d), t_ns - m.t_submit_ns)

    def _complete(self, m: _Member, resolve, wait_ns: int) -> None:
        """Hand the member's resolution (the shared fetch, then its own
        host gather) to the completion pool; its answer lands on the
        member's future."""
        def run_and_set():
            tok = tracker.adopt(m.tracker) if m.tracker is not None \
                else None
            try:
                tracker.add_phase("coalesce_wait", wait_ns)
                r = resolve()
            except BaseException as e:  # noqa: BLE001 — rides the future
                if not m.future.done():
                    m.future.set_exception(e)
                return
            finally:
                if tok is not None:
                    tracker.uninstall(tok)
            if not m.future.done():
                m.future.set_result(r)

        pool = self._endpoint._completion() if self._endpoint is not None \
            else None
        if pool is None:
            run_and_set()
            return
        f = pool.submit(run_and_set)
        if f.done() and f.exception() is not None and not m.future.done():
            # the pool is shut down: surface it, so the waiter degrades
            m.future.set_exception(f.exception())

    # -------------------------------------------------------- teardown

    def close(self) -> None:
        """Stop collecting, dispatch every open group (parked members must
        resolve) and join both threads."""
        with self._cv:
            self._shutdown = True
            for g in list(self._open.values()):
                self._close_locked(g, "shutdown")
            self._cv.notify_all()
            threads = [self._thread, self._dispatcher]
        for t in threads:
            if t is not None:
                t.join(timeout=5.0)
        with self._mu:
            leftovers = list(self._ready)
            self._ready.clear()
        for g in leftovers:
            self._dispatch(g)

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._mu:
            groups = self.groups_dispatched
            out = {
                "enabled": self.enabled,
                "window_ms": round(self.window_s * 1e3, 3),
                "max_group": self.max_group,
                "open_groups": len(self._open),
                "inflight": self._inflight,
                "groups_dispatched": groups,
                "requests_coalesced": self.requests_coalesced,
                "mean_occupancy": round(self.occupancy_sum / groups, 3)
                if groups else 0.0,
                "max_occupancy": self.max_observed_occupancy,
                "solo_degrade": self.solo_degrade,
                "closes": dict(self.closes),
            }
        out["router"] = self.router.stats()
        return out
