"""In-memory sorted KV engine.

A copy of the JAX package's ``engine/memory.py`` (reference: tikv_kv's
BTreeEngine, components/engine_test factories), without its write
counter metric.  Snapshots are O(1) copy-on-write: the
engine keeps per-CF immutable generations; a snapshot pins the current
generation, and the first write after a snapshot clones the CF arrays
(writes are control-plane here — the read path must be zero-copy).
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional

from .traits import ALL_CFS, CF_DEFAULT


class _CfData:
    """One CF: parallel sorted key/value lists, copy-on-write."""

    __slots__ = ("keys", "vals", "pinned")

    def __init__(self):
        self.keys: list[bytes] = []
        self.vals: list[bytes] = []
        self.pinned = False     # a snapshot references this generation

    def clone(self) -> "_CfData":
        c = _CfData()
        c.keys = list(self.keys)
        c.vals = list(self.vals)
        return c


class _MemIterator:
    """Bounded iterator over a pinned CF generation."""

    def __init__(self, data: _CfData, lower: Optional[bytes],
                 upper: Optional[bytes]):
        self._keys = data.keys
        self._vals = data.vals
        self._lo = 0 if lower is None else \
            bisect.bisect_left(self._keys, lower)
        self._hi = len(self._keys) if upper is None else \
            bisect.bisect_left(self._keys, upper)
        self._pos = self._lo - 1    # invalid until positioned

    def valid(self) -> bool:
        return self._lo <= self._pos < self._hi

    def seek(self, key: bytes) -> bool:
        self._pos = max(self._lo, bisect.bisect_left(self._keys, key))
        return self.valid()

    def seek_for_prev(self, key: bytes) -> bool:
        self._pos = min(self._hi, bisect.bisect_right(self._keys, key)) - 1
        return self.valid()

    def seek_to_first(self) -> bool:
        self._pos = self._lo
        return self.valid()

    def seek_to_last(self) -> bool:
        self._pos = self._hi - 1
        return self.valid()

    def next(self) -> bool:
        assert self.valid()
        self._pos += 1
        return self.valid()

    def prev(self) -> bool:
        assert self.valid()
        self._pos -= 1
        return self.valid()

    def key(self) -> bytes:
        assert self.valid()
        return self._keys[self._pos]

    def value(self) -> bytes:
        assert self.valid()
        return self._vals[self._pos]


class MemorySnapshot:
    def __init__(self, cfs: dict):
        self._cfs = cfs     # cf name -> pinned _CfData generation

    def get_value_cf(self, cf: str, key: bytes) -> Optional[bytes]:
        data = self._cfs[cf]
        i = bisect.bisect_left(data.keys, key)
        if i < len(data.keys) and data.keys[i] == key:
            return data.vals[i]
        return None

    def get_value(self, key: bytes) -> Optional[bytes]:
        return self.get_value_cf(CF_DEFAULT, key)

    def iterator_cf(self, cf: str, lower: Optional[bytes] = None,
                    upper: Optional[bytes] = None) -> _MemIterator:
        return _MemIterator(self._cfs[cf], lower, upper)

    def range_cf(self, cf: str, lower: bytes,
                 upper: bytes) -> tuple[list, list, int]:
        """Bulk range read → (keys, values, prefix_skip) for the native
        columnar builder — list slices of the pinned generation, no
        per-key iterator hops."""
        data = self._cfs[cf]
        i = bisect.bisect_left(data.keys, lower)
        j = bisect.bisect_left(data.keys, upper)
        return data.keys[i:j], data.vals[i:j], 0


class MemoryWriteBatch:
    def __init__(self):
        self._ops: list[tuple] = []     # ("put"|"del"|"delr", cf, ...)

    def put_cf(self, cf: str, key: bytes, value: bytes) -> None:
        self._ops.append(("put", cf, key, value))

    def delete_cf(self, cf: str, key: bytes) -> None:
        self._ops.append(("del", cf, key))

    def delete_range_cf(self, cf: str, start: bytes, end: bytes) -> None:
        self._ops.append(("delr", cf, start, end))

    def ingest_cf(self, cf: str, keys: list, vals: list) -> None:
        """Bulk sorted-run ingest (sst_importer; see _ingest_locked)."""
        self._ops.append(("ingest", cf, keys, vals))

    def put(self, key: bytes, value: bytes) -> None:
        self.put_cf(CF_DEFAULT, key, value)

    def delete(self, key: bytes) -> None:
        self.delete_cf(CF_DEFAULT, key)

    def count(self) -> int:
        return len(self._ops)

    def is_empty(self) -> bool:
        return not self._ops

    def clear(self) -> None:
        self._ops.clear()


class MemoryEngine:
    """Sorted in-memory engine implementing the KvEngine traits."""

    def __init__(self, cfs=ALL_CFS):
        self._cfs: dict[str, _CfData] = {cf: _CfData() for cf in cfs}
        # one mutex serializes mutation vs snapshot-pinning so snapshots
        # never observe a half-applied batch (the reference gets this from
        # RocksDB; scheduler threads rely on it)
        self._mu = threading.RLock()

    # -- copy-on-write plumbing --

    def _writable(self, cf: str) -> _CfData:
        data = self._cfs[cf]
        if data.pinned:
            data = data.clone()
            self._cfs[cf] = data
        return data

    # -- KvEngine --

    def snapshot(self) -> MemorySnapshot:
        with self._mu:
            for data in self._cfs.values():
                data.pinned = True
            return MemorySnapshot(dict(self._cfs))

    def write_batch(self) -> MemoryWriteBatch:
        return MemoryWriteBatch()

    def write(self, batch: MemoryWriteBatch) -> None:
        with self._mu:
            self._write_locked(batch)

    # from this many point ops on one CF, a batch merges them into the
    # CF's sorted lists in one pass: ``list.insert`` moves the whole tail,
    # and thousands of inserts into a CF of 10^7 keys move gigabytes (a
    # 4,096-key commit into 6c's region: 69 s, NVIDIA H100 host,
    # chip_smoke.run_srv).  64 is a guess: the crossover against the
    # per-op inserts is not measured
    MERGE_MIN_OPS = 64

    def _write_locked(self, batch: MemoryWriteBatch) -> None:
        # a CF's point ops are gathered in batch order (the last op on a
        # key wins) and merged before any range op or ingest on that CF
        points: dict = {}
        for op in batch._ops:
            kind, cf = op[0], op[1]
            if kind == "put":
                points.setdefault(cf, {})[op[2]] = op[3]
            elif kind == "del":
                points.setdefault(cf, {})[op[2]] = None
            else:
                pending = points.pop(cf, None)
                if pending:
                    self._merge_points_locked(cf, pending)
                if kind == "ingest":
                    self._ingest_locked(cf, op[2], op[3])
                else:
                    self._delete_range(cf, op[2], op[3])
        for cf, pending in points.items():
            self._merge_points_locked(cf, pending)

    def _merge_points_locked(self, cf: str, points: dict) -> None:
        """Apply {key: value, or None to delete} to one CF: each key's
        place by bisection, the lists rebuilt from slices in one pass."""
        if len(points) < self.MERGE_MIN_OPS:
            for key, value in points.items():
                if value is None:
                    self._delete_locked(cf, key)
                else:
                    self._put_locked(cf, key, value)
            return
        data = self._cfs[cf]
        ok, ov = data.keys, data.vals
        n = len(ok)
        nk: list = []
        nv: list = []
        prev = 0
        for key in sorted(points):
            i = bisect.bisect_left(ok, key, prev)
            if i > prev:
                nk += ok[prev:i]
                nv += ov[prev:i]
            value = points[key]
            if value is not None:
                nk.append(key)
                nv.append(value)
            prev = i + 1 if i < n and ok[i] == key else i
        nk += ok[prev:]
        nv += ov[prev:]
        if data.pinned:         # a snapshot keeps the old generation
            data = _CfData()
            self._cfs[cf] = data
        data.keys, data.vals = nk, nv

    def _ingest_locked(self, cf: str, keys: list, vals: list) -> None:
        """Bulk-merge one pre-sorted run (the file-ingest analog of
        RocksDB's IngestExternalFile: land a whole sorted artifact
        without replaying per-key ops; sst_importer ingest).

        Ascending bulk loads append in O(1)/key via list.extend; an
        overlapping run falls back to a two-run sorted merge where the
        ingested value wins ties (newest file wins, as in the LSM)."""
        if not keys:
            return
        data = self._writable(cf)
        if not data.keys or keys[0] > data.keys[-1]:
            data.keys.extend(keys)
            data.vals.extend(vals)
            return
        # a run that fits between two keys (a region's range just cleared,
        # a snapshot's data landing in it) splices in one list operation
        i = bisect.bisect_left(data.keys, keys[0])
        if data.keys[i] > keys[-1]:
            data.keys[i:i] = keys
            data.vals[i:i] = vals
            return
        ok, ov = data.keys, data.vals
        nk, nv = keys, vals
        mk: list = []
        mv: list = []
        i = j = 0
        ln, lm = len(ok), len(nk)
        while i < ln and j < lm:
            a, b = ok[i], nk[j]
            if a < b:
                mk.append(a)
                mv.append(ov[i])
                i += 1
            elif a > b:
                mk.append(b)
                mv.append(nv[j])
                j += 1
            else:           # same key: ingested run wins
                mk.append(b)
                mv.append(nv[j])
                i += 1
                j += 1
        mk.extend(ok[i:])
        mv.extend(ov[i:])
        mk.extend(nk[j:])
        mv.extend(nv[j:])
        data.keys = mk
        data.vals = mv

    def get_value_cf(self, cf: str, key: bytes) -> Optional[bytes]:
        data = self._cfs[cf]
        i = bisect.bisect_left(data.keys, key)
        if i < len(data.keys) and data.keys[i] == key:
            return data.vals[i]
        return None

    def get_value(self, key: bytes) -> Optional[bytes]:
        return self.get_value_cf(CF_DEFAULT, key)

    def iterator_cf(self, cf: str, lower: Optional[bytes] = None,
                    upper: Optional[bytes] = None) -> _MemIterator:
        with self._mu:
            data = self._cfs[cf]
            data.pinned = True      # iterator sees a stable generation
            return _MemIterator(data, lower, upper)

    def range_cf(self, cf: str, lower: bytes,
                 upper: bytes) -> tuple[list, list, int]:
        """Bulk range read → (keys, values, prefix_skip); see
        MemorySnapshot.range_cf.  The returned slices are independent
        copies, so no generation pin is needed — pinning here would
        force a full copy-on-write of the CF on the next mutation."""
        with self._mu:
            data = self._cfs[cf]
            i = bisect.bisect_left(data.keys, lower)
            j = bisect.bisect_left(data.keys, upper)
            return data.keys[i:j], data.vals[i:j], 0

    def put_cf(self, cf: str, key: bytes, value: bytes) -> None:
        with self._mu:
            self._put_locked(cf, key, value)

    def _put_locked(self, cf: str, key: bytes, value: bytes) -> None:
        data = self._writable(cf)
        i = bisect.bisect_left(data.keys, key)
        if i < len(data.keys) and data.keys[i] == key:
            data.vals[i] = value
        else:
            data.keys.insert(i, key)
            data.vals.insert(i, value)

    def delete_cf(self, cf: str, key: bytes) -> None:
        with self._mu:
            self._delete_locked(cf, key)

    def _delete_locked(self, cf: str, key: bytes) -> None:
        data = self._writable(cf)
        i = bisect.bisect_left(data.keys, key)
        if i < len(data.keys) and data.keys[i] == key:
            del data.keys[i]
            del data.vals[i]

    def _delete_range(self, cf: str, start: bytes, end: bytes) -> None:
        data = self._writable(cf)
        i = bisect.bisect_left(data.keys, start)
        j = bisect.bisect_left(data.keys, end)
        del data.keys[i:j]
        del data.vals[i:j]

    def flush(self) -> None:
        pass
