"""Committed-write delta log for the incremental columnar cache.

A copy of the JAX package's ``copr/delta.py`` (reference precedents: the
region cache engine mirrors every engine write into its in-memory copy
instead of re-scanning, components/region_cache_memory_engine/src/
write_batch.rs; CDC's observer turns applied raft entries back into row
events, components/cdc/src/observer.rs).  A ``DeltaSink`` registers with a
``CoprocessorHost`` and turns each applied data entry's ``WriteOp``s into
row and lock deltas, logged per region in apply order;
``RegionColumnarCache`` replays the log to patch a cached line forward
across a ``data_index`` gap instead of rebuilding it.

The delta protocol (one record per committed CF_WRITE version):

- ``RowDelta(kind="put")``: a committed row version at ``commit_ts``; its
  payload is ``short_value`` when inlined, else it lives in CF_DEFAULT at
  ``(enc_key, start_ts)`` (the patcher reads it from the snapshot it
  bridges toward);
- ``RowDelta(kind="delete")``: a delete tombstone at ``commit_ts``;
- ``RowDelta(kind="advance")``: a ROLLBACK or LOCK record: no visible
  change, but the region's ``safe_ts`` watermark moves as a rebuild would
  see it;
- ``LockDelta``: a CF_LOCK put or delete; ``lock`` is the new blocking lock,
  or None (released, or replaced by a lock that blocks nothing).

Coverage: a line at data version I may be bridged to J iff
``deltas_between(region, I, J)`` is not None — the log then holds every
data write in (I, J].  Whatever breaks that (an overflowing log, an op
outside the envelope: a range delete, an SST ingest, a CF_WRITE delete; a
snapshot apply replacing the region's data) poisons coverage, and the cache
rebuilds.

The port has no metrics registry: what the reference exports as gauges
(the log depth of each region) is kept here and reported by ``stats()``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Optional, Sequence

from ..engine.traits import CF_DEFAULT, CF_LOCK, CF_WRITE
from ..raftstore.observer import Observer
from ..storage.txn_types import (Lock, LockType, Write, WriteType,
                                 decode_key, split_ts)


@dataclass(frozen=True)
class RowDelta:
    """One committed CF_WRITE version, in apply order."""

    enc_key: bytes              # txn-encoded user key (no ts suffix)
    user_key: bytes
    commit_ts: int
    start_ts: int
    kind: str                   # put | delete | advance
    short_value: Optional[bytes] = None


@dataclass(frozen=True)
class LockDelta:
    """One CF_LOCK transition; ``lock`` None: no blocking lock left."""

    user_key: bytes
    lock: Optional[Lock] = None


def decode_entry_ops(ops: Sequence):
    """The applied ``WriteOp``s of one entry → (row deltas, lock deltas),
    or None when an op lies outside the delta envelope (a range delete, an
    ingest, a CF_WRITE delete) or does not decode: the caller poisons
    coverage, and the consumer rebuilds."""
    rows: list = []
    locks: list = []
    try:
        for op in ops:
            if op.op == "put":
                if op.cf == CF_WRITE:
                    enc, commit_ts = split_ts(op.key)
                    w = Write.from_bytes(op.value)
                    if w.write_type is WriteType.PUT:
                        kind = "put"
                    elif w.write_type is WriteType.DELETE:
                        kind = "delete"
                    else:       # ROLLBACK / LOCK: the watermark only
                        kind = "advance"
                    rows.append(RowDelta(enc, decode_key(enc), commit_ts,
                                         w.start_ts, kind, w.short_value))
                elif op.cf == CF_LOCK:
                    lock = Lock.from_bytes(op.value)
                    blocking = lock.lock_type in (LockType.PUT,
                                                  LockType.DELETE)
                    locks.append(LockDelta(decode_key(op.key),
                                           lock if blocking else None))
                elif op.cf == CF_DEFAULT:
                    pass        # a big value: read from the snapshot
                else:
                    return None
            elif op.op == "delete":
                if op.cf == CF_LOCK:
                    locks.append(LockDelta(decode_key(op.key), None))
                elif op.cf == CF_DEFAULT:
                    pass        # value GC rides behind a CF_WRITE delete
                else:
                    # a CF_WRITE delete (GC, rollback collapse) may drop
                    # the newest version: outside the envelope
                    return None
            else:               # delete_range / ingest
                return None
    except Exception:           # noqa: BLE001 — an undecodable op poisons
        return None
    return rows, locks


class _RegionLog:
    __slots__ = ("log", "covered_from", "rows", "epoch_version")

    def __init__(self):
        # (index, tuple[RowDelta], tuple[LockDelta]) in apply order
        self.log: deque = deque()
        # a bridge from version I is sound iff I >= covered_from; None:
        # coverage unknown (poisoned) until the next applied data write
        self.covered_from: Optional[int] = None
        self.rows = 0           # RowDelta records retained
        # the epoch VERSION of the last on_region_changed (None before the
        # first): a conf change moves conf_ver only, the key range stays,
        # and so does coverage
        self.epoch_version: Optional[int] = None


class DeltaSink(Observer):
    """Per-region committed-write delta log fed by the apply path.

    Thread-safe: the apply path appends through the observer events,
    request threads read through ``deltas_between``.  Bounded by
    ``max_entries`` applied entries and ``max_rows`` row deltas a region
    (overflow drops the oldest entries and advances ``covered_from``, so a
    stale line rebuilds instead of skipping writes), and by ``max_regions``
    regions, least recently written first out (a destroyed or merged-away
    region gets no teardown event)."""

    def __init__(self, max_entries: int = 1024, max_rows: int = 1 << 16,
                 max_regions: int = 512):
        self.max_entries = max_entries
        self.max_rows = max_rows
        self.max_regions = max_regions
        self._regions: "OrderedDict[int, _RegionLog]" = OrderedDict()
        self._mu = threading.Lock()
        # what the reference exports as gauges: each region's log depth,
        # and how many regions' gauges were dropped
        self._depths: dict = {}
        self.gauges_dropped = 0

    # -- observer events ------------------------------------------------

    def on_apply_write(self, region_id: int, index: int,
                       ops: Sequence) -> None:
        dec = decode_entry_ops(ops)
        with self._mu:
            st = self._regions.setdefault(region_id, _RegionLog())
            if dec is None:
                # out of the envelope: nothing at or before this entry can
                # be bridged; later writes cover from here
                st.log.clear()
                st.rows = 0
                st.covered_from = index
                self._export_depth(region_id, st)
                return
            rows, locks = dec
            if st.covered_from is None:
                # the first write after start or after a wholesale data
                # replacement: a snapshot stamped below this entry reflects
                # exactly the state at index - 1
                st.covered_from = index - 1
            st.log.append((index, tuple(rows), tuple(locks)))
            st.rows += len(rows)
            while len(st.log) > self.max_entries or \
                    st.rows > self.max_rows:
                old_index, old_rows, _ = st.log.popleft()
                st.rows -= len(old_rows)
                st.covered_from = old_index
            self._regions.move_to_end(region_id)
            self._evict_locked()
            self._export_depth(region_id, st)

    def on_data_replaced(self, region_id: int, index: int) -> None:
        """The region's data was replaced wholesale (a snapshot apply):
        nothing logged before covers the new state."""
        with self._mu:
            st = self._regions.setdefault(region_id, _RegionLog())
            st.log.clear()
            st.rows = 0
            st.covered_from = index
            self._export_depth(region_id, st)

    def on_region_changed(self, region) -> None:
        """A split, merge or epoch change moved the region's key range:
        deltas logged against the old shape must not bridge lines of the
        new one, so coverage is poisoned until the next applied write.  An
        event at the epoch version already seen (a conf change) keeps it;
        the first event poisons (the epoch is unknown until then)."""
        with self._mu:
            st = self._regions.get(region.id)
            if st is None:
                return
            ver = region.epoch.version
            if st.epoch_version == ver:
                return
            st.epoch_version = ver
            st.log.clear()
            st.rows = 0
            st.covered_from = None
            self._export_depth(region.id, st)

    def on_region_split(self, left, right, left_index: Optional[int],
                        right_index: Optional[int]) -> None:
        """A split, seen before its ``on_region_changed(left)``: the left
        log records the new epoch version, so that event keeps its entries
        (all at or below ``left_index``, which the sliced child lines start
        at: no bridge replays them); the right region starts a log covered
        from its creation stamp, so its first write bridges."""
        with self._mu:
            st = self._regions.get(left.id)
            if st is not None:
                st.epoch_version = left.epoch.version
            if right_index is not None:
                st = self._regions.setdefault(right.id, _RegionLog())
                st.log.clear()
                st.rows = 0
                st.covered_from = right_index
                st.epoch_version = right.epoch.version
                self._regions.move_to_end(right.id)
                self._evict_locked()
                self._export_depth(right.id, st)

    def on_peer_destroyed(self, region_id: int) -> None:
        self.drop_region(region_id)

    def drop_region(self, region_id: int) -> None:
        """The peer is gone (merged away, removed): its log goes now."""
        with self._mu:
            if self._regions.pop(region_id, None) is not None:
                self._drop_gauges(region_id)

    # -- consumer -------------------------------------------------------

    def deltas_between(self, region_id: int, from_index: int,
                       to_index: int):
        """Row and lock deltas of every data write in (from_index,
        to_index], in apply order, or None when coverage cannot be
        proven."""
        with self._mu:
            st = self._regions.get(region_id)
            if st is None or st.covered_from is None or \
                    from_index < st.covered_from:
                return None
            rows: list = []
            locks: list = []
            top = None
            for index, r, lk in st.log:
                if from_index < index <= to_index:
                    rows.extend(r)
                    locks.extend(lk)
                    top = index
            if to_index > from_index and top != to_index:
                # the target version's own entry is missing (a stamp from a
                # path the sink never saw)
                return None
            return rows, locks

    def depth(self, region_id: int) -> int:
        with self._mu:
            st = self._regions.get(region_id)
            return len(st.log) if st is not None else 0

    def stats(self) -> dict:
        with self._mu:
            return {
                "regions": len(self._regions),
                "entries": sum(len(st.log)
                               for st in self._regions.values()),
                "rows": sum(st.rows for st in self._regions.values()),
                "depths": dict(self._depths),
                "gauges_dropped": self.gauges_dropped,
            }

    # -- under _mu ------------------------------------------------------

    def _evict_locked(self) -> None:
        while len(self._regions) > self.max_regions:
            dead_id, _st = self._regions.popitem(last=False)
            self._drop_gauges(dead_id)

    def _export_depth(self, region_id: int, st: _RegionLog) -> None:
        self._depths[region_id] = len(st.log)

    def _drop_gauges(self, region_id: int) -> None:
        self._depths.pop(region_id, None)
        self.gauges_dropped += 1
