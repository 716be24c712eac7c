"""Device-state supervision: feed digests, the feed arena and the region
lifecycle hooks.

Counterpart of the JAX package's ``device/supervisor.py``:

- the digest contract (:68-89).  A feed plane's digest over its live
  prefix is

      digest(plane, n) = Σ_{i<n} bits(plane[i])·(2i+1)  mod 2^64.

  Odd weights make every single-position change detectable: a change d at
  position i moves the digest by d·(2i+1) mod 2^64, which is zero only
  when d is.  The runner records it from the host truth when a feed is
  built and re-hashes the resident plane on the device
  (``digest.plane_digest``) when it scrubs.  ``start_plane_digests``
  hashes a feed's planes on a thread pool in spans, so that the hash runs
  while the planes upload (or while a device split slices them);
- ``FeedArena`` (:496-930): the runner's explicitly owned device feeds,
  one bucket per feed anchor (a ``FeedLineage``, or the snapshot itself),
  with byte accounting, an optional budget, least-frequently- then
  least-recently-used eviction that skips the entries an in-flight request
  pinned, explicit drops, and a weakref backstop for anchors no lifecycle
  event reaches;
- ``SliceHealth`` and ``SliceHealthBoard`` (:218-470): a strike score per
  mesh slice, the failure domain of a placement runner
  (``DeviceRunner(mesh=..., placement=True)``): healthy → quarantined at
  ``DEFAULT_TRIP_STRIKES`` → half-open probe after a cooldown → healthy
  again with a decayed score, or quarantined again;
- ``DeviceStateSupervisor`` (:1071-), an ``Observer`` of the region
  lifecycle: a split slices the parent's cache lines and then its resident
  device feeds into the children (``on_region_split``; with placement on,
  the children are pinned to the parent's slice), a region change, a
  snapshot apply or a destroyed peer drops the superseded lines, and every
  retired line drops its device feeds (``on_line_retired`` →
  ``drop_feed``).  Its scrub (``scrub``, on demand or from a thread every
  ``scrub_interval`` seconds) re-hashes every resident plane and
  quarantines an anchor whose planes diverged from their record.  A role
  change drives the replica-feed state machine (``on_role_change``,
  :1199-1320): a demoted region's lines stay resident and patched, and a
  leader gain over them re-verifies their planes' digests instead of
  rebuilding (``promote_region``).

- ``RemintGovernor`` (:952-1068): bounded, priority-ordered admission of
  cold builds (``RegionColumnarCache.remint_gate``): hot regions first,
  the worst waiter shed past the queue's bound.

Trimmed (ROADMAP.md queue 1 item 6): the arena's residency metering, the
replica-feed state machine and the flight recorder.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import weakref
from typing import Callable, Optional, Sequence

import numpy as np

from ..raftstore.observer import Observer
from ..utils.failpoint import fail_point

# rows per step: the weights and products of one step stay in cache
_STEP = 1 << 20
# rows per job on a hashing pool: a plane of 10^8 rows is 6 jobs
_SPAN = 1 << 24
_MASK = (1 << 64) - 1


def _span_digest(arr: np.ndarray, lo: int, hi: int,
                 dtype: Optional[np.dtype] = None) -> int:
    """Σ_{lo≤i<hi} bits(arr[i], read as ``dtype``)·(2i+1) mod 2^64."""
    a = arr[lo:hi]
    if dtype is not None:
        a = a.astype(dtype, copy=False)
    a = np.ascontiguousarray(a)
    if a.dtype == np.bool_:
        u = a.view(np.uint8)
    else:
        u = a.view(np.dtype(f"u{a.dtype.itemsize}"))
    m_all = hi - lo
    step = min(m_all, _STEP)
    odd = 2 * np.arange(step, dtype=np.uint64) + np.uint64(1)
    w = np.empty(step, np.uint64)
    total = 0
    with np.errstate(over="ignore"):
        for at in range(0, m_all, _STEP):
            m = min(_STEP, m_all - at)
            np.add(odd[:m], np.uint64(2 * (lo + at)), out=w[:m])
            np.multiply(w[:m], u[at:at + m], out=w[:m])
            total += int(w[:m].sum(dtype=np.uint64))
    return total & _MASK


def host_plane_digest(arr: np.ndarray, n: int,
                      dtype: Optional[np.dtype] = None) -> int:
    """Host reference digest over the live prefix of one feed plane
    (its values cast to ``dtype`` first, when given)."""
    return _span_digest(arr, 0, n, dtype)


def hash_workers() -> int:
    """Threads for a hashing pool: the host's cores, at most 8."""
    return max(1, min(8, os.cpu_count() or 1))


def start_plane_digests(pool, planes: Sequence[tuple], n: int,
                        span: int = _SPAN) -> Callable[[], tuple]:
    """Queue the digests of ``planes`` — (array, dtype or None) pairs,
    each hashed over its first ``n`` rows — on the executor ``pool`` in
    jobs of ``span`` rows → a function that waits for them and returns
    the digests in order.  numpy releases the GIL inside each job, so the
    caller's uploads run while the pool hashes."""
    jobs = [[pool.submit(_span_digest, arr, lo, min(n, lo + span), dtype)
             for lo in range(0, n, span)] for arr, dtype in planes]

    def wait() -> tuple:
        return tuple(sum(f.result() for f in js) & _MASK for js in jobs)
    return wait


# ------------------------------------------------------ slice health

# a slice trips at this score: 1.0 a dispatch, fetch or scrub fault, 0.25 a
# latency outlier; each served request takes 0.5 off
DEFAULT_TRIP_STRIKES = 3.0
# seconds before a tripped slice (or one whose probe failed) is probed
DEFAULT_PROBE_COOLDOWN_S = 0.25


class SliceHealth:
    """Strike score and state of one mesh slice (supervisor.py:241).

    healthy --(score >= trip)--> quarantined --(cooldown, one probe at a
    time)--> healthy with the score at trip − 1 (decayed, not reset, so the
    placement penalty keeps the slice expensive and one more fault trips it
    again), or quarantined again with the cooldown restarted.  Faults:
    ``note_fault`` (weight 1.0; 0.25 a latency outlier when
    ``latency_outlier_s`` is set above 0); a served request decays the
    score by 0.5 (``note_ok``)."""

    __slots__ = ("idx", "_mu", "score", "state", "trip_strikes",
                 "cooldown_s", "latency_outlier_s", "strikes", "trips",
                 "readmits", "refusals", "probe_failures",
                 "launched_quarantined", "_opened_at", "_probe_inflight")

    def __init__(self, idx: int,
                 trip_strikes: float = DEFAULT_TRIP_STRIKES,
                 cooldown_s: float = DEFAULT_PROBE_COOLDOWN_S,
                 latency_outlier_s: Optional[float] = None):
        self.idx = idx
        self._mu = threading.Lock()
        self.score = 0.0
        self.state = "healthy"          # healthy | quarantined
        self.trip_strikes = trip_strikes
        self.cooldown_s = cooldown_s
        self.latency_outlier_s = latency_outlier_s
        self.strikes: dict = {}
        self.trips = 0
        self.readmits = 0
        # dispatches refused while quarantined (served on the host)
        self.refusals = 0
        self.probe_failures = 0
        # dispatches that launched while quarantined: stays 0
        self.launched_quarantined = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    def note_fault(self, kind: str, weight: float = 1.0) -> bool:
        """One strike → True when it tripped the slice."""
        with self._mu:
            self.strikes[kind] = self.strikes.get(kind, 0) + 1
            self.score += weight
            return self._maybe_trip_locked()

    def trip(self, kind: str) -> bool:
        """Quarantine now (a persistent death needs no three strikes) →
        True on the transition."""
        with self._mu:
            self.strikes[kind] = self.strikes.get(kind, 0) + 1
            self.score = max(self.score, self.trip_strikes)
            return self._maybe_trip_locked()

    def _maybe_trip_locked(self) -> bool:
        if self.state != "healthy" or self.score < self.trip_strikes:
            return False
        self.state = "quarantined"
        self.trips += 1
        self._opened_at = time.monotonic()
        self._probe_inflight = False
        return True

    def note_ok(self, latency_s: Optional[float] = None) -> bool:
        """A served request: decay the score, or strike 0.25 when its
        latency is an outlier → True when that strike tripped the slice
        (the caller fires the board's trip listeners)."""
        if latency_s is not None and self.latency_outlier_s and \
                self.latency_outlier_s > 0 and \
                latency_s >= self.latency_outlier_s:
            return self.note_fault("latency", weight=0.25)
        with self._mu:
            if self.state == "healthy":
                self.score = max(0.0, self.score - 0.5)
        return False

    def quarantined(self) -> bool:
        return self.state == "quarantined"

    def try_probe(self) -> bool:
        """→ True when a canary may run now: quarantined, cooled down, and
        no other probe in flight (half-open: one probe at a time)."""
        with self._mu:
            if self.state != "quarantined" or self._probe_inflight:
                return False
            if time.monotonic() - self._opened_at < self.cooldown_s:
                return False
            self._probe_inflight = True
            return True

    def probe_result(self, ok: bool) -> None:
        with self._mu:
            self._probe_inflight = False
            if self.state != "quarantined":
                return
            if ok:
                self.state = "healthy"
                self.score = max(0.0, self.trip_strikes - 1.0)
                self.readmits += 1
            else:
                self.probe_failures += 1
                self._opened_at = time.monotonic()

    def penalty(self) -> float:
        """The score over the trip threshold: the placement blend's health
        term (0 healthy, about 1 at the threshold)."""
        with self._mu:
            return self.score / self.trip_strikes \
                if self.trip_strikes > 0 else 0.0

    def reset(self) -> None:
        with self._mu:
            self.score = 0.0
            self.state = "healthy"
            self._probe_inflight = False

    def stats(self) -> dict:
        with self._mu:
            return {"slice": self.idx, "score": round(self.score, 3),
                    "state": self.state, "strikes": dict(self.strikes),
                    "trips": self.trips, "readmits": self.readmits,
                    "refusals": self.refusals,
                    "probe_failures": self.probe_failures,
                    "probe_inflight": self._probe_inflight,
                    "launched_quarantined": self.launched_quarantined}


class SliceHealthBoard:
    """The health of every slice of one mesh (supervisor.py:384), owned by
    the whole-mesh placement runner and shared with its placer, its slice
    runners and any degraded submesh runner, so every observation about a
    slice lands on one score.  Trip listeners ``fn(idx, reason)`` run on
    each healthy → quarantined transition, outside the board's lock."""

    def __init__(self, n_slices: int,
                 trip_strikes: float = DEFAULT_TRIP_STRIKES,
                 cooldown_s: float = DEFAULT_PROBE_COOLDOWN_S,
                 latency_outlier_s: Optional[float] = None):
        self._slices = [SliceHealth(i, trip_strikes=trip_strikes,
                                    cooldown_s=cooldown_s,
                                    latency_outlier_s=latency_outlier_s)
                        for i in range(n_slices)]
        self._mu = threading.Lock()
        self._listeners: list = []

    def __len__(self) -> int:
        return len(self._slices)

    def slice(self, i: int) -> SliceHealth:
        return self._slices[i]

    def add_trip_listener(self, fn) -> None:
        with self._mu:
            self._listeners.append(fn)

    def _fire_trip(self, idx: int, reason: str) -> None:
        with self._mu:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(idx, reason)
            except Exception:   # noqa: BLE001 — a listener must not
                pass            # break the scoring path

    def note_fault(self, idx: int, kind: str, weight: float = 1.0) -> None:
        if 0 <= idx < len(self._slices) and \
                self._slices[idx].note_fault(kind, weight=weight):
            self._fire_trip(idx, kind)

    def trip(self, idx: int, reason: str) -> None:
        if 0 <= idx < len(self._slices) and self._slices[idx].trip(reason):
            self._fire_trip(idx, reason)

    def quarantined_set(self) -> frozenset:
        return frozenset(i for i, s in enumerate(self._slices)
                         if s.quarantined())

    def penalty(self, i: int) -> float:
        return self._slices[i].penalty()

    def maybe_probe(self, canary) -> int:
        """Run ``canary(idx) -> bool`` for each quarantined slice whose
        cooldown has passed (one probe a slice at a time) and feed back
        the result; a canary that raises failed → how many ran."""
        ran = 0
        for s in self._slices:
            if not s.try_probe():
                continue
            ran += 1
            try:
                ok = bool(canary(s.idx))
            except Exception:   # noqa: BLE001 — a crashed canary failed
                ok = False
            s.probe_result(ok)
        return ran

    def reset(self) -> None:
        for s in self._slices:
            s.reset()

    def stats(self) -> list:
        return [s.stats() for s in self._slices]


# ------------------------------------------------------------ feed arena


def _bucket_nbytes(bucket: dict) -> int:
    """Device bytes held by one anchor's bucket: feed planes, and the
    tensors of the sparse slot ids cached in request memos."""
    total = 0
    for v in bucket.values():
        if not isinstance(v, dict):
            continue
        for a in v.get("flat", ()):
            total += int(getattr(a, "nbytes", 0))
        for a in v.get("sparse_slots", ()) or ():
            if isinstance(a, list):     # the slot ids' planes, one a shard
                total += sum(int(t.nbytes) for t in a)
    return total


class _ArenaEntry:
    __slots__ = ("ref", "bucket", "nbytes", "hits", "tick", "pins", "gen")

    def __init__(self, ref, gen: int):
        self.ref = ref
        self.bucket: dict = {}
        self.nbytes = 0
        self.hits = 0
        self.tick = 0
        self.pins = 0
        # pin tokens carry it: an unpin against a dropped-and-rebuilt
        # entry of the same anchor strips nothing
        self.gen = gen


class FeedArena:
    """Explicitly owned device feeds with byte accounting and a budget.

    One entry per feed anchor.  Reclamation is explicit: a retired cache
    line drops its anchor (``drop``).  A weakref finalizer is only a
    backstop for anchors that see no lifecycle event.  Eviction under the
    budget takes the least frequently used entry first, the least recently
    used among ties, and skips pinned entries (an in-flight request still
    reads their planes).  ``budget_bytes <= 0`` disables the budget."""

    def __init__(self, budget_bytes: int = 0):
        self._entries: dict = {}
        self._mu = threading.RLock()
        self._tick = 0
        self._gen = 0
        self._resident = 0
        self._pinned = 0
        self.budget_bytes = int(budget_bytes)
        self.evictions = 0
        self.rejections = 0
        self.drops = 0

    def bucket(self, anchor, create: bool = True) -> Optional[dict]:
        """The anchor's bucket (feeds and request memos), or None when it
        cannot be tracked (not weak-referenceable) or, with ``create``
        False, is not resident."""
        key = id(anchor)
        with self._mu:
            ent = self._entries.get(key)
            if ent is not None:
                self._tick += 1
                ent.hits += 1
                ent.tick = self._tick
                return ent.bucket
            if not create:
                return None
            try:
                ref = weakref.ref(anchor,
                                  lambda _r, k=key: self._gc_drop(k))
            except TypeError:
                return None
            self._tick += 1
            self._gen += 1
            ent = _ArenaEntry(ref, self._gen)
            ent.hits = 1
            ent.tick = self._tick
            self._entries[key] = ent
            return ent.bucket

    def _gc_drop(self, key: int) -> None:
        with self._mu:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._resident -= ent.nbytes
                if ent.pins > 0:
                    self._pinned = max(0, self._pinned - ent.nbytes)

    def pin(self, anchor):
        """Pin the anchor's current entry → a token for ``unpin``, or None
        when the anchor is not resident."""
        with self._mu:
            ent = self._entries.get(id(anchor))
            if ent is None:
                return None
            if ent.pins == 0:
                self._pinned += ent.nbytes
            ent.pins += 1
            return id(anchor), ent.gen

    def unpin(self, token) -> None:
        if token is None:
            return
        key, gen = token
        with self._mu:
            ent = self._entries.get(key)
            if ent is not None and ent.gen == gen and ent.pins > 0:
                ent.pins -= 1
                if ent.pins == 0:
                    self._pinned = max(0, self._pinned - ent.nbytes)
            # the release may be what an over-budget arena waited for
            if self.budget_bytes > 0:
                self._evict_until_locked(self.budget_bytes)

    def admit(self, anchor) -> bool:
        """Re-account ``anchor``'s bucket and enforce the budget, evicting
        other unpinned entries until the resident bytes fit.  → False when
        the entry could not fit even alone: its bucket is dropped (unless
        pinned) and the caller serves from its feed uncached."""
        key = id(anchor)
        with self._mu:
            ent = self._entries.get(key)
            if ent is None:
                return False
            fresh = _bucket_nbytes(ent.bucket)
            self._resident += fresh - ent.nbytes
            if ent.pins > 0:
                self._pinned = max(0, self._pinned + fresh - ent.nbytes)
            ent.nbytes = fresh
            budget = self.budget_bytes
            if budget > 0:
                self._evict_until_locked(budget, protect_key=key)
                if self._resident > budget and ent.pins == 0:
                    self._entries.pop(key, None)
                    self._resident -= ent.nbytes
                    self.rejections += 1
                    return False
        return True

    def _evict_until_locked(self, budget: int,
                            protect_key: Optional[int] = None) -> int:
        """Evict unpinned entries, least frequently then least recently
        used first, until the resident bytes fit ``budget`` → how many."""
        evicted = 0
        while self._resident > budget:
            victim_key = victim = None
            for k, e in self._entries.items():
                if k == protect_key or e.pins > 0 or e.nbytes <= 0:
                    continue
                if victim is None or (e.hits, e.tick) < (victim.hits,
                                                         victim.tick):
                    victim_key, victim = k, e
            if victim is None:
                break
            self._entries.pop(victim_key, None)
            self._resident -= victim.nbytes
            self.evictions += 1
            evicted += 1
        return evicted

    def enforce(self) -> int:
        """Evict against the current budget (after it shrank) → how
        many."""
        with self._mu:
            return self._evict_until_locked(self.budget_bytes) \
                if self.budget_bytes > 0 else 0

    def drop(self, anchor) -> int:
        """Drop the anchor's entry, pins included (in-flight requests keep
        their own references to the planes) → the bytes released from the
        accounting."""
        with self._mu:
            ent = self._entries.pop(id(anchor), None)
            if ent is None:
                return 0
            self._resident -= ent.nbytes
            if ent.pins > 0:
                self._pinned = max(0, self._pinned - ent.nbytes)
            self.drops += 1
            return ent.nbytes

    def drop_all(self) -> int:
        """Drop every entry, pins included → the bytes released."""
        with self._mu:
            freed = self._resident
            self.drops += len(self._entries)
            self._entries.clear()
            self._resident = 0
            self._pinned = 0
            return freed

    def resident_bytes(self) -> int:
        with self._mu:
            return self._resident

    def pinned_bytes(self) -> int:
        with self._mu:
            return self._pinned

    def entry_stats(self) -> list:
        """(anchor, hits, last tick, pins) of every entry whose anchor is
        alive: what the placer's rebalance picks its coldest anchor by."""
        with self._mu:
            rows = [(e.ref(), e.hits, e.tick, e.pins)
                    for e in list(self._entries.values())]
        return [r for r in rows if r[0] is not None]

    def items(self) -> list:
        """(anchor, bucket) of every entry whose anchor is alive."""
        with self._mu:
            pairs = [(e.ref(), e.bucket)
                     for e in list(self._entries.values())]
        return [(a, b) for a, b in pairs if a is not None]

    def stats(self) -> dict:
        with self._mu:
            return {"budget_bytes": self.budget_bytes,
                    "resident_bytes": self._resident,
                    "resident_lines": len(self._entries),
                    "pinned_lines": sum(1 for e in self._entries.values()
                                        if e.pins > 0),
                    "pinned_bytes": self._pinned,
                    "evictions": self.evictions,
                    "rejections": self.rejections, "drops": self.drops}


# ------------------------------------------------- lifecycle supervisor


class _RemintWaiter:
    __slots__ = ("key", "shed", "region_id")

    def __init__(self, key, region_id):
        self.key = key
        self.shed = False
        self.region_id = region_id


class RemintGovernor:
    """Bounded, priority-ordered admission of cold ``columnar_build``
    re-mints, wired as ``RegionColumnarCache.remint_gate``.

    When every invalidated region wants a rebuild at once, the governor
    caps concurrent builds at ``max_concurrent`` and parks the rest in a
    queue ordered by (RU debt, hottest region first, arrival); past
    ``max_queue`` waiters the worst one is shed with
    ``ServerIsBusy(retry_after_ms)``.  ``max_concurrent <= 0`` admits
    everything at once."""

    def __init__(self, max_concurrent: int = 2, max_queue: int = 32,
                 retry_after_ms: int = 50):
        self.max_concurrent = int(max_concurrent)
        self.max_queue = max(1, int(max_queue))
        self.retry_after_ms = int(retry_after_ms)
        self._cv = threading.Condition(threading.Lock())
        self._active = 0
        self._waiters: list = []
        self._seq = 0
        self.admitted = 0
        self.queued = 0
        self.shed = 0
        self.observed_max = 0       # peak concurrent builds granted
        self.peak_depth = 0         # deepest the queue got

    @staticmethod
    def _ru_debt() -> bool:
        """Whether the current request's tenant is in RU debt (debtors
        rebuild last).  Always False: the port has no resource controller
        yet (ROADMAP.md queue 1 item 7), so no tenant can owe."""
        return False

    def _grant_locked(self) -> bool:
        self._active += 1
        self.admitted += 1
        self.observed_max = max(self.observed_max, self._active)
        return True

    def acquire(self, region_id: int, heat: float = 0.0):
        """Block until a build permit is granted → a ticket for
        ``release`` (None when admission is off); raises ``ServerIsBusy``
        when this waiter is shed."""
        if self.max_concurrent <= 0:
            return None
        from ..server.read_pool import ServerIsBusy
        with self._cv:
            if self._active < self.max_concurrent and not self._waiters:
                return self._grant_locked()
            # the smaller key is admitted sooner: debt-free before
            # debtors, then the hottest region, then arrival order
            self._seq += 1
            w = _RemintWaiter((1 if self._ru_debt() else 0, -heat,
                               self._seq), region_id)
            self._waiters.append(w)
            self.queued += 1
            if len(self._waiters) > self.max_queue:
                worst = max(self._waiters, key=lambda x: x.key)
                self._waiters.remove(worst)
                worst.shed = True
                self.shed += 1
                self._cv.notify_all()
            self.peak_depth = max(self.peak_depth, len(self._waiters))
            while True:
                if w.shed:
                    raise ServerIsBusy("re-mint queue overloaded",
                                       retry_after_ms=self.retry_after_ms)
                if self._active < self.max_concurrent and \
                        min(self._waiters, key=lambda x: x.key) is w:
                    self._waiters.remove(w)
                    self._cv.notify_all()   # more slots may be free
                    return self._grant_locked()
                self._cv.wait()

    def release(self, ticket) -> None:
        if ticket is None:
            return
        with self._cv:
            self._active -= 1
            self._cv.notify_all()

    def stats(self) -> dict:
        with self._cv:
            return {"max_concurrent": self.max_concurrent,
                    "active": self._active, "depth": len(self._waiters),
                    "admitted": self.admitted, "queued": self.queued,
                    "shed": self.shed, "observed_max": self.observed_max,
                    "peak_depth": self.peak_depth}


class DeviceStateSupervisor(Observer):
    """Region lifecycle and scrub over device-resident state.

    Registered on a ``CoprocessorHost`` beside the ``DeltaSink``; installed
    as the columnar cache's ``on_line_retired`` hook, so every line the
    cache drops drops its device feeds (``runner.drop_feed``).  ``runner``
    may be None: the supervisor then drives the cache's lifecycle alone.
    ``delta_sink``: the sink whose region log a destroyed peer drops.
    ``scrub_interval`` > 0: ``start`` runs a scrub pass (and the placement
    mesh's slice probes) that often on a thread; ``scrub_max_lines`` (0:
    every line) bounds a pass.

    ``on_region_split`` runs before the generic ``on_region_changed``:
    the cache slices each parent line into child lines, then the runner
    slices the resident parent feeds into digest-verified child feeds,
    while the parent planes are still resident.  The ``device::device_split``
    failpoint, and any split that mints no child feed, count in
    ``split_fallbacks``: those children upload from host truth.  A split
    kernel that fails to build or launch raises.

    ``on_role_change(region_id, is_leader)`` (supervisor.py:1199-1320): a
    leader loss keeps the region's lines resident as replica feeds (the
    sink sees the follower's applies, so they stay patched) and counts a
    demotion; a leader gain over a replica feed, or over lines still
    resident, promotes it: ``promote_region`` re-hashes every resident
    plane of the region on the device (``runner.scrub_feed``, one
    ``digest.plane_digest`` a plane, under the dispatch lock), tracker
    phase ``replica_promote``, and builds nothing.  A divergence, or the
    ``copr::replica_promote`` failpoint, quarantines the anchor and
    invalidates the region's lines: the next request pays the cold build,
    counted in ``promotion_rebuilds``."""

    def __init__(self, runner=None, copr_cache=None, delta_sink=None,
                 scrub_interval: float = 0.0, scrub_max_lines: int = 0):
        self._runner = runner
        self._cache = copr_cache
        self._sink = delta_sink
        self._interval = scrub_interval
        self._scrub_max_lines = scrub_max_lines
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()
        # a bounded pass starts where the last one stopped, so every
        # resident line is reached in turn
        self._scrub_cursor = 0
        self.scrub_passes = 0
        self.scrub_divergences = 0
        self.quarantines = 0
        self._last_scrub: dict = {}
        self.lifecycle_invalidations = 0
        self.splits = 0                 # parent lines sliced on the device
        self.split_fallbacks = 0        # splits that fell back to upload
        # host-clock ms of the last split: the cache's line slicing and the
        # runner's device split
        self.split_phases_ms: dict = {}
        # the replica-feed state machine: the regions whose lines this store
        # keeps as follower feeds (demoted leaders, regions that served a
        # stale read)
        self._replica_feed_regions: set = set()
        self.promotions = 0             # leader gains over a warm feed
        self.promotion_rebuilds = 0     # promotions that failed to verify
        self.demotions = 0              # leader losses (lines kept)
        # the last promotion's verify: {lines, planes, divergences,
        # quarantined_regions, ms}
        self.last_promotion: dict = {}
        if copr_cache is not None and runner is not None:
            copr_cache.on_line_retired = self.on_line_retired

    def on_region_changed(self, region) -> None:
        """Split, merge or epoch change: the lines at superseded epochs
        can never be hit again — drop them (and their feeds) now."""
        if self._cache is None:
            return
        n = self._cache.invalidate_region(
            region.id, keep_epoch=region.epoch.version)
        if n:
            self._note_invalidations(n)

    def on_region_split(self, left, right, left_index,
                        right_index) -> None:
        import time
        from ..utils import tracker
        if self._cache is None or \
                not hasattr(self._cache, "split_lines"):
            return
        if fail_point("device::device_split") is not None:
            with self._mu:
                self.split_fallbacks += 1
            return
        with tracker.phase("device_split"):
            t0 = time.perf_counter()
            try:
                specs = self._cache.split_lines(left, right, left_index,
                                                right_index)
            except Exception:   # noqa: BLE001 — a split never fails apply
                import logging
                logging.getLogger(__name__).warning(
                    "device-side split failed; falling back to upload",
                    exc_info=True)
                specs = []
            t1 = time.perf_counter()
            children, parent = [], None
            for spec in specs:
                # a kernel that fails to build or launch raises through
                # here: only a child that mints no feed falls back
                ok = self._runner is not None and \
                    self._runner.split_resident_feeds(spec) == "split"
                with self._mu:
                    if ok:
                        self.splits += 1
                    else:
                        self.split_fallbacks += 1
                parent = spec["parent_lineage"]
                children += [spec[side]["lineage"] for side in
                             ("left", "right") if spec.get(side)]
            # the children serve where the parent's feeds were sliced
            placer = getattr(self._runner, "placer", None)
            if placer is not None and parent is not None:
                placer.adopt(parent, children)
            self.split_phases_ms = {
                "split_lines": (t1 - t0) * 1e3,
                "device_split": (time.perf_counter() - t1) * 1e3}

    # -- the replica-feed state machine -------------------------------

    def on_role_change(self, region_id: int, is_leader: bool) -> None:
        """A leader loss keeps the region's lines (a demotion); a leader
        gain over a replica feed, or over lines still resident, promotes
        it by a digest re-verify, never a build."""
        if self._cache is None:
            return
        if not is_leader:
            with self._mu:
                self.demotions += 1
                self._replica_feed_regions.add(region_id)
            return
        with self._mu:
            was_replica = region_id in self._replica_feed_regions
            self._replica_feed_regions.discard(region_id)
        if was_replica or self._cache.region_resident(region_id):
            self.promote_region(region_id)

    def note_replica_feed(self, region_id: int) -> None:
        """A stale read served from this store's line: the line is a live
        replica feed."""
        with self._mu:
            self._replica_feed_regions.add(region_id)

    def promote_region(self, region_id: int) -> bool:
        """Warm promotion of the region's replica feeds → True when every
        resident plane matched its recorded digest.  Otherwise (or when the
        ``copr::replica_promote`` failpoint fires) the region's lines are
        invalidated and the next request builds them again."""
        from ..utils import tracker
        ok = fail_point("copr::replica_promote") is None
        if ok:
            with tracker.phase("replica_promote"):
                ok = self._verify_region_digests(region_id)
        with self._mu:
            self.promotions += 1
            if not ok:
                self.promotion_rebuilds += 1
        if not ok:
            n = self._cache.invalidate_region(region_id)
            if n:
                self._note_invalidations(n)
        return ok

    def _verify_region_digests(self, region_id: int) -> bool:
        """Re-hash the region's resident feeds on the device against their
        records, each anchor under the runner's dispatch lock (a patch
        writes the planes in place); a diverged anchor is quarantined, as a
        scrub hit is.  No runner: trivially clean."""
        out = {"lines": 0, "planes": 0, "divergences": 0,
               "quarantined_regions": []}
        runner = self._runner
        t0 = time.perf_counter()
        clean = True
        if runner is not None and hasattr(runner, "arena_items"):
            dispatch_mu = getattr(runner, "_dispatch_mu", None) or \
                contextlib.nullcontext()
            for anchor, bucket in runner.arena_items():
                if getattr(anchor, "region_hint", None) != region_id:
                    continue
                with dispatch_mu:
                    feeds = [v for v in list(bucket.values())
                             if isinstance(v, dict) and "flat" in v and
                             v.get("digests") is not None]
                    diverged = False
                    for feed in feeds:
                        out["planes"] += len(feed["digests"])
                        if runner.scrub_feed(feed):
                            diverged = True
                            break
                    if diverged:
                        clean = False
                        out["divergences"] += 1
                        self._quarantine(runner, anchor, out)
                out["lines"] += bool(feeds)
        out["ms"] = (time.perf_counter() - t0) * 1e3
        self.last_promotion = out
        return clean

    def on_data_replaced(self, region_id: int, index: int) -> None:
        """A snapshot apply replaced the region's data: the sink has
        poisoned its coverage, and the lines can only rebuild — drop them
        now."""
        if self._cache is None:
            return
        n = self._cache.invalidate_region(region_id)
        if n:
            self._note_invalidations(n)

    def on_peer_destroyed(self, region_id: int) -> None:
        """The peer left this store: every line of the region dies, and its
        delta log with it."""
        if self._cache is not None:
            n = self._cache.invalidate_region(region_id)
            if n:
                self._note_invalidations(n)
        if self._sink is not None and hasattr(self._sink, "drop_region"):
            self._sink.drop_region(region_id)

    def on_line_retired(self, lineage) -> None:
        """The cache's retirement hook → explicit feed teardown."""
        if self._runner is not None and lineage is not None:
            self._runner.drop_feed(lineage)

    def _note_invalidations(self, n: int) -> None:
        with self._mu:
            self.lifecycle_invalidations += n

    # -- scrub --------------------------------------------------------

    def scrub(self, max_lines: Optional[int] = None) -> dict:
        """One scrub pass (supervisor.py:1354-1458): re-hash the resident
        planes of every anchor (``runner.scrub_feed``, one
        ``digest.plane_digest`` a plane) against the digests recorded at
        build and patch time; an anchor with a diverged plane is
        quarantined → {lines, planes, divergences, quarantined_regions,
        ms}.

        Each anchor's feeds are hashed under the runner's dispatch lock,
        on one device as on a mesh.  The reference hashes a single
        device's planes outside it (supervisor.py:1376-1379, :1433), since its
        patch makes new arrays; this port's patch writes the resident
        planes in place, and a patch landing between the copy of the
        record and the hash would pair new contents with the old record
        and quarantine a healthy feed.  The ``device::feed_corrupt``
        failpoint flips one bit of a resident plane; the same pass hashes
        and quarantines before the lock drops, so no request is served from
        the flipped plane.  ``max_lines`` (or ``scrub_max_lines``) bounds
        the pass, starting where the last one stopped."""
        out = {"lines": 0, "planes": 0, "divergences": 0,
               "quarantined_regions": []}
        runner = self._runner
        if runner is None or not hasattr(runner, "arena_items"):
            self._record_scrub(out, 0.0)
            return out
        limit = max_lines if max_lines is not None else \
            (self._scrub_max_lines or None)
        dispatch_mu = getattr(runner, "_dispatch_mu", None) or \
            contextlib.nullcontext()
        t0 = time.perf_counter()
        items = runner.arena_items()
        if limit is not None and items:
            start = self._scrub_cursor % len(items)
            items = items[start:] + items[:start]
            self._scrub_cursor = start + limit
        for anchor, bucket in items:
            if limit is not None and out["lines"] >= limit:
                break
            diverged = False
            with dispatch_mu:
                feeds = [v for v in list(bucket.values())
                         if isinstance(v, dict) and "flat" in v and
                         v.get("digests") is not None]
                for feed in feeds:
                    if fail_point("device::feed_corrupt") is not None:
                        # the injected fault: a bit flips on a resident
                        # plane; this pass must catch it
                        runner.corrupt_resident_plane(feed)
                for feed in feeds:
                    out["planes"] += len(feed["digests"])
                    if runner.scrub_feed(feed):
                        diverged = True
                        break
                if diverged:
                    self._quarantine(runner, anchor, out)
            if not feeds:
                continue
            out["lines"] += 1
            if diverged:
                out["divergences"] += 1
        self._record_scrub(out, time.perf_counter() - t0)
        return out

    def _quarantine(self, runner, anchor, out: dict) -> None:
        region = getattr(anchor, "region_hint", None)
        if region is not None:
            out["quarantined_regions"].append(region)
        runner.quarantine(anchor, reason="scrub divergence")
        with self._mu:
            self.quarantines += 1

    def _record_scrub(self, out: dict, elapsed_s: float) -> None:
        out["ms"] = elapsed_s * 1e3
        with self._mu:
            self.scrub_passes += 1
            self.scrub_divergences += out["divergences"]
            self._last_scrub = dict(out)

    # -- the scrub thread ---------------------------------------------

    def start(self) -> None:
        """Start the scrub thread (nothing without a ``scrub_interval``)."""
        if self._interval <= 0 or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="device-scrub")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        import logging
        while not self._stop.wait(self._interval):
            try:
                self.scrub()
            except Exception:   # noqa: BLE001 — a pass never ends the loop
                logging.getLogger(__name__).warning(
                    "device scrub pass failed", exc_info=True)
            # the quarantined slices' probes ride the same cadence: an idle
            # node re-admits them too
            probe = getattr(self._runner, "probe_quarantined", None)
            if callable(probe):
                try:
                    probe()
                except Exception:   # noqa: BLE001 — the same contract
                    logging.getLogger(__name__).warning(
                        "slice probe pass failed", exc_info=True)

    # -- observability ------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            out = {"lifecycle_invalidations": self.lifecycle_invalidations,
                   "promotions": self.promotions,
                   "promotion_rebuilds": self.promotion_rebuilds,
                   "demotions": self.demotions,
                   "replica_feeds": len(self._replica_feed_regions),
                   "splits": self.splits,
                   "split_fallbacks": self.split_fallbacks,
                   "scrub_passes": self.scrub_passes,
                   "scrub_divergences": self.scrub_divergences,
                   "quarantines": self.quarantines,
                   "last_scrub": dict(self._last_scrub)}
        if self._runner is not None and hasattr(self._runner, "hbm_stats"):
            out["hbm"] = self._runner.hbm_stats()
        return out
