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
- ``DeviceStateSupervisor`` (:1071-), an ``Observer`` of the region
  lifecycle: a split slices the parent's cache lines and then its resident
  device feeds into the children (``on_region_split``), a region change or
  a destroyed peer drops the superseded lines, and every retired line
  drops its device feeds (``on_line_retired`` → ``drop_feed``).

Trimmed (ROADMAP.md queue 1 item 6): the arena's residency metering, the
scrub thread and quarantine, the replica-feed state machine, the slice
health board and the flight recorder.
"""

from __future__ import annotations

import os
import threading
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


class DeviceStateSupervisor(Observer):
    """Region lifecycle over device-resident state.

    Registered on a ``CoprocessorHost``; installed as the columnar cache's
    ``on_line_retired`` hook, so every line the cache drops drops its
    device feeds (``runner.drop_feed``).  ``runner`` may be None: the
    supervisor then drives the cache's lifecycle alone.

    ``on_region_split`` runs before the generic ``on_region_changed``:
    the cache slices each parent line into child lines, then the runner
    slices the resident parent feeds into digest-verified child feeds,
    while the parent planes are still resident.  The ``device::device_split``
    failpoint, and any split that mints no child feed, count in
    ``split_fallbacks``: those children upload from host truth.  A split
    kernel that fails to build or launch raises."""

    def __init__(self, runner=None, copr_cache=None):
        self._runner = runner
        self._cache = copr_cache
        self._mu = threading.Lock()
        self.lifecycle_invalidations = 0
        self.splits = 0                 # parent lines sliced on the device
        self.split_fallbacks = 0        # splits that fell back to upload
        # host-clock ms of the last split: the cache's line slicing and the
        # runner's device split
        self.split_phases_ms: dict = {}
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
            self.split_phases_ms = {
                "split_lines": (t1 - t0) * 1e3,
                "device_split": (time.perf_counter() - t1) * 1e3}

    def on_peer_destroyed(self, region_id: int) -> None:
        """The peer left this store: every line of the region dies."""
        if self._cache is not None:
            n = self._cache.invalidate_region(region_id)
            if n:
                self._note_invalidations(n)

    def on_line_retired(self, lineage) -> None:
        """The cache's retirement hook → explicit feed teardown."""
        if self._runner is not None and lineage is not None:
            self._runner.drop_feed(lineage)

    def _note_invalidations(self, n: int) -> None:
        with self._mu:
            self.lifecycle_invalidations += n

    def stats(self) -> dict:
        with self._mu:
            out = {"lifecycle_invalidations": self.lifecycle_invalidations,
                   "splits": self.splits,
                   "split_fallbacks": self.split_fallbacks}
        if self._runner is not None and hasattr(self._runner, "hbm_stats"):
            out["hbm"] = self._runner.hbm_stats()
        return out
