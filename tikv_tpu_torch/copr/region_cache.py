"""Per-region MVCC columnar cache — the scan→device feed for real data.

Counterpart of the JAX package's ``copr/region_cache.py``.  A region's
table slice is resolved from its MVCC versions once per data version and
kept as columnar arrays (a cache line), which both the host pipeline and
the device runner read:

- the build ladder, device → native → interpreted:
  ``build_region_columnar_ex`` tries the device rung (``_build_device``:
  the CF_WRITE range in one bulk read, its version planes taken from the
  streaming ingest, ``copr/stream_build.py``, or parsed now by the native
  module, the winners' CF_DEFAULT rows fetched, then
  ``build_region_columnar_device``), then ``build_region_columnar``: the
  native one-pass build (``_build_native``), then the interpreted loop
  over ``MvccReader``; the rung that served labels ``cold_build``.
  ``build_region_columnar_device`` is the device rung from the version
  planes on — the host mirror of the resolution and the
  ``ColdFeedBundle`` from which the runner's first feed miss mints the
  feed on the device;
- ``MvccColumnarSnapshot``: the columnar view at one read timestamp, with
  its blocking locks (``check_locks``) and the ``FeedLineage`` that
  anchors the runner's device feeds;
- ``FeedLineage``: the line's identity for the device — a patch journal
  (``record``/``since``), the digests the runner recorded per feed, the
  one-shot cold bundle, and the split stash: the child feeds a device
  split sliced from the parent, for the child's first request;
- ``RegionColumnarCache``: lines keyed (region, epoch version, table,
  columns) and stamped with ``data_index``; ``get`` hits, bridges or
  builds.  With a ``delta_source`` (``copr.delta.DeltaSink``) a line whose
  data version moved is patched forward (``_bridge`` → ``_apply_deltas``:
  updates in place by copy-on-write, appends into the slack, tombstones,
  a repack for a mid-insert or past the compaction ratio), its patch
  journalled on the lineage for the device feed, and the superseded
  generation kept in the line's ``history`` for reads below the first
  commit that superseded it.  Lifecycle: ``invalidate_region`` drops a
  region's superseded lines (an epoch floor and a sweep generation fence
  builds in flight), every retired line goes to ``on_line_retired`` (the
  device supervisor drops its feeds), and ``split_lines`` serves a region
  split by slicing each parent line — bridged forward first when it lags
  the split point — into two child lines with fresh lineages, no
  ``columnar_build``, for the runner to slice the resident parent feeds the
  same way (``DeviceRunner.split_resident_feeds``).

A cold build first takes a permit from ``remint_gate`` when one is wired
(``device.supervisor.RemintGovernor``, phase ``remint_wait``), ordered by
``region_heat``: the decayed request rate of the region (half-life 30 s).

A read below a line's safe_ts parks its exact-ts build on the line (four
at most); the same read again takes it, and a newer line carries them.

The compiled request fast path (``server/fastpath.py``) reads through
``get_fast`` (a warm hit of a key derived once, at learn time; it never
builds) after ``is_current`` has vouched that its learned snapshot is the
line's newest generation.

Trimmed (ROADMAP.md queue 1 item 6): the gauges and metrics.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Optional, Sequence

import numpy as np

from ..codec.keys import decode_record_handle, table_record_range
from ..codec.row import decode_row
from ..datatype import Column, EvalType
from ..engine.traits import CF_DEFAULT, CF_LOCK, CF_WRITE
from ..executors.columnar import ColumnarTable
from ..storage.mvcc.reader import (_PAST_VERSIONS, MvccReader,
                                   check_lock_conflict)
from ..storage.txn_types import Lock, LockType, append_ts, decode_key, \
    encode_key, split_ts


class _TableShim:
    """Minimal ``table`` carrier for ColumnarTable (table_id only)."""

    __slots__ = ("table_id",)

    def __init__(self, table_id: int):
        self.table_id = table_id


def _scan_blocking_locks(snap, lower: bytes, upper: bytes) -> list:
    """(user key, Lock) of every PUT/DELETE lock in [lower, upper)."""
    blocking_locks: list = []
    lit = snap.iterator_cf(CF_LOCK, lower, upper)
    ok = lit.seek_to_first()
    while ok:
        lock = Lock.from_bytes(lit.value())
        if lock.lock_type in (LockType.PUT, LockType.DELETE):
            blocking_locks.append((decode_key(lit.key()), lock))
        ok = lit.next()
    return blocking_locks


# native builder kind codes (fastbuild.cpp Col.kind)
_NATIVE_KINDS = {
    EvalType.INT: 0, EvalType.DURATION: 0,
    EvalType.REAL: 1,
    EvalType.BYTES: 2,
    EvalType.DATETIME: 3, EvalType.ENUM: 3, EvalType.SET: 3,
}


def _record_range(snap, cf: str, table_id: int):
    """(keys, values, prefix_skip) of ``cf`` over the table's record range
    in one bulk read, or None when the snapshot has no range read."""
    rng = getattr(snap, "range_cf", None)
    if rng is None:
        return None
    lo, hi = table_record_range(table_id)
    return rng(cf, encode_key(lo), encode_key(hi))


def _build_native(snap, table_id: int, col_infos: Sequence, read_ts: int):
    """The native one-pass build (``native.mvcc_build_columnar``) →
    (ColumnarTable, safe_ts), or None when the snapshot or schema is
    outside its envelope (DECIMAL/JSON payloads, non-NULL defaults,
    datums it cannot decode, a spilled row whose value is gone)."""
    from ..native import mvcc_build_columnar
    ids, kinds = [], []
    for info in col_infos:
        if info.is_pk_handle:
            continue
        ft = info.field_type
        kind = _NATIVE_KINDS.get(ft.eval_type)
        if kind is None or info.default_value is not None:
            return None
        if kind == 0 and ft.is_unsigned:
            kind = 3        # unsigned BIGINT: values live above 2^63
        ids.append(info.col_id)
        kinds.append(kind)
    got = _record_range(snap, CF_WRITE, table_id)
    if got is None:
        return None
    keys, vals, skip = got
    try:
        out = mvcc_build_columnar(keys, vals, read_ts, skip, tuple(ids),
                                  tuple(kinds))
    except ValueError:
        # a stored payload may hold a datum outside the native envelope
        # (a DECIMAL of an unrequested column): the interpreted rung serves
        return None
    n = out["n"]
    handles = np.frombuffer(out["handles"], dtype=np.int64)
    np_dtypes = {0: np.int64, 1: np.float64, 3: np.uint64}
    ets = {info.col_id: info.field_type.eval_type for info in col_infos
           if not info.is_pk_handle}
    need = out["need_default"]
    columns: dict = {}
    for col_id, kind, payload, validity in out["cols"]:
        valid = np.frombuffer(validity, dtype=np.bool_)
        if need:
            valid = valid.copy()    # the spilled rows are written below
        if kind == 2:
            # the builder sets a bytes payload exactly where validity is set
            values = np.empty(n, dtype=object)
            values[:] = payload
            if not valid.all():
                values[~valid] = b""
        else:
            values = np.frombuffer(payload, dtype=np_dtypes[kind])
            if need:
                values = values.copy()
        columns[col_id] = Column(ets[col_id], values, valid)
    if need:
        fetched, missing = _fetch_default_values(snap, table_id, need)
        if missing:
            return None     # a visible version's row is gone
        per_col: dict = {cid: ([], []) for cid in columns}
        for (row, _start_ts, _user_key), raw in zip(need, fetched):
            for col_id, pv in decode_row(raw).items():
                slot = per_col.get(col_id)
                if slot is not None and pv is not None:
                    slot[0].append(row)
                    slot[1].append(pv)
        for col_id, (rows_idx, vals_list) in per_col.items():
            if not rows_idx:
                continue
            col = columns[col_id]
            idx = np.asarray(rows_idx, dtype=np.int64)
            if col.values.dtype == object:
                for i, v in zip(rows_idx, vals_list):
                    col.values[i] = v
            else:
                col.values[idx] = np.asarray(vals_list,
                                             dtype=col.values.dtype)
            col.validity[idx] = True
    return ColumnarTable(_TableShim(table_id), handles, columns), \
        out["safe_ts"]


def _fetch_default_values(snap, table_id: int, need):
    """The CF_DEFAULT rows of a build's spilled versions.

    ``need``: [(row, start_ts, user key)].  Up to 31 rows take point gets;
    more take one bulk range read of the table's CF_DEFAULT slice, with a
    point get for a row the bulk map misses.  → (values aligned with
    ``need``, None where no row was found; the indices of those)."""
    out: list = []
    missing: list = []
    got = _record_range(snap, CF_DEFAULT, table_id) if len(need) >= 32 \
        else None
    by_key = None
    if got is not None:
        keys, vals, skip = got
        by_key = {bytes(k[skip:]) if skip else bytes(k): v
                  for k, v in zip(keys, vals)}
    for i, (_row, start_ts, user_key) in enumerate(need):
        enc = append_ts(encode_key(user_key), start_ts)
        v = by_key.get(enc) if by_key is not None else None
        if v is None:
            v = snap.get_value_cf(CF_DEFAULT, enc)
            if v is None:
                missing.append(i)
        out.append(v)
    return out, missing


def _build_device(snap, table_id: int, col_infos: Sequence, read_ts: int,
                  resolver, stream=None):
    """The device rung: the CF_WRITE range as version planes — taken from
    the streaming ingest (``stream.take``, planes parsed and on the card
    already) or parsed now (``device.mvcc.parse_write_planes``) — the
    winners' CF_DEFAULT rows fetched and decoded, then
    ``build_region_columnar_device``: the host mirror and the cold bundle
    the runner mints the feed from.

    → (ColumnarTable, safe_ts, ColdFeedBundle), or None when the rung
    declines (no single-device resolver, the ``device::mvcc_resolve``
    failpoint, a schema or range outside the planes' envelope, a spilled
    row whose value is gone)."""
    from ..device.mvcc import align_planes, parse_write_planes, plane_schema
    from ..utils import tracker
    from ..utils.failpoint import fail_point
    available = getattr(resolver, "available", None)
    if available is None or not available() or \
            fail_point("device::mvcc_resolve") is not None or \
            not 0 <= read_ts < 1 << 63 or plane_schema(col_infos) is None:
        return None
    with tracker.phase("range_read"):
        got = _record_range(snap, CF_WRITE, table_id)
    if got is None or not got[0]:
        return None     # an empty range: the host rungs are free
    keys, vals, skip = got
    planes = dev = None
    region = getattr(snap, "region", None)
    data_index = getattr(snap, "data_index", None)
    if stream is not None and region is not None and data_index is not None:
        with tracker.phase("stream_take"):
            st = stream.take(region.id, table_id, data_index,
                             n_ver=len(keys),
                             first_key=bytes(keys[0][skip:]),
                             last_key=bytes(keys[-1][skip:]))
        if st is not None:
            planes = align_planes(st[0], col_infos)
            dev = st[1] if planes is not None else None
    if planes is None:
        with tracker.phase("mvcc_parse"):
            planes = parse_write_planes(keys, vals, skip, col_infos)
        if planes is None:
            return None

    def defaults(rows):
        # the CF_DEFAULT rows of the winning spilled versions only (a
        # superseded version's row is never fetched)
        by_ver = {row: (sts, uk) for row, sts, uk in planes.need_default}
        need = [(r, *by_ver[r]) for r in rows if r in by_ver]
        if len(need) != len(rows):
            return None     # an inconsistent parse
        with tracker.phase("default_fetch"):
            fetched, missing = _fetch_default_values(snap, table_id, need)
        if missing:
            return None
        return {r: decode_row(raw) for (r, _s, _u), raw in
                zip(need, fetched)}

    return build_region_columnar_device(planes, _TableShim(table_id),
                                        col_infos, read_ts, resolver,
                                        defaults=defaults,
                                        device_planes=dev)


def build_region_columnar(snap, table_id: int, col_infos: Sequence,
                          read_ts: int):
    """One MVCC pass over the region ∩ table record range: the native
    rung (``_build_native``), else the interpreted one over
    ``MvccReader``, each labelled ``cold_build``.

    → (ColumnarTable, safe_ts, blocking_locks).  Pending locks are
    recorded, not raised: the committed version set is independent of
    them; each request checks the locks in its own ranges at serve time."""
    from ..utils import tracker
    lo, hi = table_record_range(table_id)
    lower, upper = encode_key(lo), encode_key(hi)
    blocking_locks = _scan_blocking_locks(snap, lower, upper)
    native = _build_native(snap, table_id, col_infos, read_ts)
    if native is not None:
        tracker.label("cold_build", "native")
        return native[0], native[1], blocking_locks
    reader = MvccReader(snap)
    handles: list = []
    rows: list = []
    safe_ts = 0
    it = snap.iterator_cf(CF_WRITE, lower, upper)
    ok = it.seek_to_first()
    while ok:
        cur, commit_ts = split_ts(it.key())
        # versions sort newest first, so this is the key's max commit_ts
        if commit_ts > safe_ts:
            safe_ts = commit_ts
        # version visibility lives in one place: the MVCC reader
        value = reader._resolve(cur, read_ts)
        if value is not None:
            handles.append(decode_record_handle(decode_key(cur)))
            rows.append(decode_row(value) if value else {})
        ok = it.seek(cur + _PAST_VERSIONS)
    columns: dict = {}
    for info in col_infos:
        if info.is_pk_handle:
            continue
        vals = [row.get(info.col_id, info.default_value) for row in rows]
        columns[info.col_id] = Column.from_list(
            info.field_type.eval_type, vals,
            unsigned=info.field_type.is_unsigned)
    tbl = ColumnarTable(_TableShim(table_id),
                        np.asarray(handles, dtype=np.int64), columns)
    tracker.label("cold_build", "interpreted")
    return tbl, safe_ts, blocking_locks


def build_region_columnar_ex(snap, table_id: int, col_infos: Sequence,
                             read_ts: int, device_resolver=None,
                             stream_source=None):
    """The ladder entry with the device rung → (ColumnarTable, safe_ts,
    blocking_locks, ColdFeedBundle or None).  The device rung
    (``_build_device``, label ``cold_build=device``) serves when a
    resolver is wired and the schema fits; otherwise the module's
    ``build_region_columnar`` does — looked up at call time, so a caller
    substituting a builder keeps its seam."""
    from ..utils import tracker
    if device_resolver is not None:
        dev = _build_device(snap, table_id, col_infos, read_ts,
                            device_resolver, stream=stream_source)
        if dev is not None:
            lo, hi = table_record_range(table_id)
            locks = _scan_blocking_locks(snap, encode_key(lo),
                                         encode_key(hi))
            tracker.label("cold_build", "device")
            return dev[0], dev[1], locks, dev[2]
    tbl, safe_ts, locks = build_region_columnar(snap, table_id, col_infos,
                                                read_ts)
    return tbl, safe_ts, locks, None


def build_region_columnar_device(planes, table, col_infos: Sequence,
                                 read_ts: int, resolver,
                                 defaults: Optional[dict] = None,
                                 device_planes=None):
    """Resolve ``planes`` (``device.mvcc.WritePlanes`` of ``table``'s
    record range) at ``read_ts`` on the host and stage the device resolve.

    ``defaults``: {version row: {col_id: value}}, the cells of the PUTs
    whose row lives in CF_DEFAULT (the caller fetched and decoded them),
    or a function of the winning spilled version rows that fetches them
    (→ that dict, or None when a row is gone); ``device_planes``: the same
    planes already on the card (``DeviceVersionPlanes``), or None to
    upload them at the mint.

    → (ColumnarTable, safe_ts, ColdFeedBundle), or None when the planes
    cannot serve the schema (a column outside the device envelope, a
    read_ts the device cannot compare, a spilled row without its cells).
    Raises ValueError when two visible versions of one key share a
    commit_ts (no CF_WRITE range holds that: it is its key)."""
    from ..device.mvcc import (ColdFeedBundle, align_planes, host_mirror,
                               resolve_host)
    from ..utils import tracker
    if resolver is None or not 0 <= read_ts < 1 << 63:
        return None
    planes = align_planes(planes, col_infos)
    if planes is None:
        return None
    with tracker.phase("host_mirror"):
        winners = resolve_host(planes, read_ts)
        n = len(winners)
        handles, columns = host_mirror(planes, winners, col_infos)
    if n > 1 and not bool(np.all(handles[1:] > handles[:-1])):
        raise ValueError("two visible versions of one key share a "
                         "commit_ts")
    # CF_DEFAULT spills among the WINNERS only: a superseded version's
    # row is never fetched
    spill_patches: dict = {}
    if planes.need_default:
        spill_rows = np.nonzero(planes.has_payload[winners] == 0)[0]
        if callable(defaults):
            defaults = defaults([int(winners[fr]) for fr in
                                 spill_rows.tolist()]) if len(spill_rows) \
                else {}
            if defaults is None:
                return None     # a spilled row is gone
        for fr in spill_rows.tolist():
            payload = (defaults or {}).get(int(winners[fr]))
            if payload is None:
                return None     # the row's cells are not known
            for info in col_infos:
                if info.is_pk_handle:
                    continue
                pv = payload.get(info.col_id)
                if pv is not None:
                    col = columns[info.col_id]
                    col.values[fr] = pv
                    col.validity[fr] = True
            spill_patches[fr] = True
    tbl = ColumnarTable(table, handles, columns)
    bundle = ColdFeedBundle(resolver, planes, device_planes, n, read_ts,
                            handles, columns, spill_patches=spill_patches)
    return tbl, int(planes.safe_ts), bundle


class MvccColumnarSnapshot:
    """Columnar view of one region's table slice at a pinned data version:
    the scan feed of the runner (``scan_columns``, ``count_rows``,
    ``gather_rows``) over the host arrays.

    ``feed_lineage``: the runner's feed anchor — the line's lineage for a
    snapshot the cache published, else one of the snapshot's own, which
    carries ``bundle`` (a cold build's resolve artifacts) to the runner's
    first feed miss.  ``feed_version``: the lineage version this
    snapshot's data reflects (a snapshot served from the line's history is
    older than the lineage).  ``superseded_at``: the least commit_ts of any
    later data delta (None: still the newest view); a read below it sees
    the same visible set here as in every newer generation."""

    def __init__(self, tbl: ColumnarTable, build_ts: int, safe_ts: int,
                 bundle=None, blocking_locks: Sequence = ()):
        self._tbl = tbl
        self.build_ts = build_ts
        self.safe_ts = safe_ts
        self.blocking_locks = tuple(blocking_locks)
        self.feed_lineage = FeedLineage()
        self.feed_version: Optional[int] = self.feed_lineage.version
        self.superseded_at: Optional[int] = None
        if bundle is not None:
            self.feed_lineage.stash_cold(bundle)

    def valid_for(self, read_ts: int) -> bool:
        """Both this build and a read at ``read_ts`` see the newest
        committed version of every key (or the read is the build's own
        timestamp)."""
        if read_ts == self.build_ts:
            return True
        return read_ts >= self.safe_ts and self.build_ts >= self.safe_ts

    def check_locks(self, ranges, read_ts: int, bypass_locks=()) -> None:
        """Range-scoped conflict check, as ``MvccReader.scan``'s: only
        locks inside the request's ranges can block it (raises
        ``KeyIsLocked``)."""
        for key, lock in self.blocking_locks:
            for r in ranges:
                if r.start <= key < r.end:
                    check_lock_conflict(lock, key, read_ts, bypass_locks)
                    break

    def scan_columns(self, desc, ranges):
        return self._tbl.scan_columns(desc, ranges)

    def count_rows(self, ranges) -> int:
        return self._tbl.count_rows(ranges)

    def gather_rows(self, desc, ranges, rows):
        return self._tbl.gather_rows(desc, ranges, rows)

    def to_kv_pairs(self, ranges=None):
        """Logical row pairs for the CHECKSUM request."""
        return self._tbl.to_kv_pairs(ranges)

    def estimated_rows(self) -> int:
        """The live rows (a tombstoned row is not one)."""
        alive = self._tbl.alive
        return len(self._tbl) if alive is None else \
            int(np.count_nonzero(alive))


class FeedLineage:
    """Bounded patch journal with a stable identity across the data
    generations of one cache line: the device runner anchors its feeds on
    it.  ``since`` gives the patches between two versions, or None when
    the journal no longer covers them (the feed then re-uploads).

    ``feed_digests``: {feed key: (version, per-plane digests)} the runner
    records at each feed build; ``region_hint``: the line's region;
    ``cold_bundle``: a cold device build's one-shot resolve artifacts;
    ``split_stash``: on a split child's lineage, the digest-verified child
    feeds the device split sliced from the parent's resident planes, each
    consumed by the first request of its shape."""

    __slots__ = ("version", "_base", "_patches", "_max", "_mu",
                 "feed_digests", "region_hint", "cold_bundle",
                 "split_stash", "__weakref__")

    def __init__(self, max_patches: int = 64):
        self.version = 0
        self._base = 0          # version the oldest retained patch starts at
        self._patches: list = []
        self._max = max_patches
        self._mu = threading.Lock()
        self.feed_digests: dict = {}
        self.region_hint = None
        self.cold_bundle = None
        self.split_stash = None

    def stash_cold(self, bundle) -> None:
        bundle.lineage_v = self.version
        with self._mu:
            old, self.cold_bundle = self.cold_bundle, bundle
        if old is not None:
            old.release()

    def take_cold(self, version):
        """Pop the cold bundle iff it still reflects ``version`` (one-shot;
        a stale bundle is released, never served)."""
        with self._mu:
            b, self.cold_bundle = self.cold_bundle, None
        if b is None:
            return None
        if getattr(b, "lineage_v", -1) != version:
            b.release()
            return None
        return b

    def drop_cold(self) -> None:
        with self._mu:
            b, self.cold_bundle = self.cold_bundle, None
        if b is not None:
            b.release()

    def record(self, patch: dict) -> None:
        with self._mu:
            self._patches.append(patch)
            self.version += 1
            while len(self._patches) > self._max:
                self._patches.pop(0)
                self._base += 1
            stale, self.cold_bundle = self.cold_bundle, None
        if stale is not None:
            stale.release()     # the line moved on before the mint

    def since(self, version: int, until: Optional[int] = None):
        """Patches bridging ``version`` → ``until`` (default: current),
        oldest first, or None when the journal no longer covers that
        span."""
        with self._mu:
            top = self.version if until is None else until
            if top > self.version or version > top or \
                    version < self._base:
                return None
            return list(self._patches[version - self._base:
                                      top - self._base])


class _LineState:
    """The arrays behind one cache line, with slack capacity past the live
    rows ``n``.

    Rows [0, n) of a current buffer are never written in place: updates and
    tombstones swap in copied buffers (copy-on-write), appends write only
    into the slack [n, cap).  A published snapshot holds views of the
    buffers current when it was published, so a scan never sees a torn
    patch."""

    __slots__ = ("table_id", "col_meta", "cap", "n", "n_dead", "handles",
                 "cols", "alive", "locks", "safe_ts", "build_ts",
                 "lineage")

    SLACK_MIN = 256

    def __init__(self, table_id: int, col_infos: Sequence, tbl,
                 safe_ts: int, build_ts: int, blocking_locks):
        self.table_id = table_id
        # col_id -> (eval_type, default_value) for non-pk columns
        self.col_meta = {info.col_id: (info.field_type.eval_type,
                                       info.default_value)
                         for info in col_infos if not info.is_pk_handle}
        n = len(tbl.handles)
        self.n = n
        self.n_dead = 0
        self.cap = n + max(self.SLACK_MIN, n >> 3)
        self.handles = np.empty(self.cap, np.int64)
        self.handles[:n] = tbl.handles
        self.cols: dict = {}
        for col_id, col in tbl.columns.items():
            vals = np.empty(self.cap, dtype=col.values.dtype)
            vals[:n] = col.values
            valid = np.zeros(self.cap, np.bool_)
            valid[:n] = col.validity
            self.cols[col_id] = [vals, valid]
        self.alive = None
        self.locks = {key: lock for key, lock in blocking_locks}
        self.safe_ts = safe_ts
        self.build_ts = max(build_ts, safe_ts)
        self.lineage = FeedLineage()

    def publish(self) -> MvccColumnarSnapshot:
        """The snapshot of the live rows, anchored on the line's
        lineage."""
        n = self.n
        columns = {cid: Column(self.col_meta[cid][0], bufs[0][:n],
                               bufs[1][:n])
                   for cid, bufs in self.cols.items()}
        alive = self.alive[:n] if self.alive is not None else None
        # the state keeps the handles strictly increasing by construction:
        # no O(n) check of the constructor's on every patch
        tbl = ColumnarTable.__new__(ColumnarTable)
        tbl.table = _TableShim(self.table_id)
        tbl.handles = self.handles[:n]
        tbl.columns = columns
        tbl.alive = alive
        tbl._feed_pos_cache = {}
        tbl._index_order_cache = {}
        tbl._ones_validity = np.ones(0, np.bool_)
        snap = MvccColumnarSnapshot(tbl, self.build_ts, self.safe_ts,
                                    blocking_locks=sorted(
                                        self.locks.items()))
        snap.feed_lineage = self.lineage
        snap.feed_version = self.lineage.version
        return snap

    # -- patch primitives ---------------------------------------------

    def _pos_of(self, handle: int):
        view = self.handles[:self.n]
        pos = int(np.searchsorted(view, handle))
        return pos, pos < self.n and int(view[pos]) == handle

    def _payload_cols(self, payload: dict):
        """A row's payload → {col_id: (value, valid)} over the whole schema
        (an MVCC PUT replaces the whole row: an absent column takes its
        default, or NULL)."""
        out = {}
        for cid, (_et, default) in self.col_meta.items():
            v = payload.get(cid, default)
            out[cid] = (v, v is not None)
        return out

    def _cow_columns(self) -> None:
        for cid, bufs in self.cols.items():
            self.cols[cid] = [bufs[0].copy(), bufs[1].copy()]

    def _cow_alive(self) -> None:
        if self.alive is None:
            self.alive = np.ones(self.cap, np.bool_)
        else:
            self.alive = self.alive.copy()

    def _set_row(self, pos: int, payload: dict) -> None:
        for cid, (v, ok) in self._payload_cols(payload).items():
            vals, valid = self.cols[cid]
            vals[pos] = v if ok else \
                (b"" if vals.dtype == object else 0)
            valid[pos] = ok

    def _repack(self, inserts) -> None:
        """One vectorized pass: drop the tombstones, merge ``inserts``
        ([(handle, payload)]) at their sorted positions, restore the slack.
        Every buffer is fresh: published snapshots are untouched."""
        n = self.n
        keep = self.alive[:n] if self.alive is not None else None
        base_h = self.handles[:n][keep] if keep is not None else \
            self.handles[:n].copy()
        ins = sorted(inserts, key=lambda kv: kv[0])
        ins_h = np.asarray([h for h, _ in ins], dtype=np.int64)
        pos = np.searchsorted(base_h, ins_h)
        new_h = np.insert(base_h, pos, ins_h) if len(ins) else base_h
        new_n = len(new_h)
        cap = new_n + max(self.SLACK_MIN, new_n >> 3)
        handles = np.empty(cap, np.int64)
        handles[:new_n] = new_h
        new_cols: dict = {}
        for cid, (vals, valid) in self.cols.items():
            _et, default = self.col_meta[cid]
            bv = vals[:n][keep] if keep is not None else vals[:n]
            bm = valid[:n][keep] if keep is not None else valid[:n]
            if len(ins):
                iv, im = [], []
                for _h, payload in ins:
                    v = payload.get(cid, default)
                    im.append(v is not None)
                    iv.append(v if v is not None else
                              (b"" if vals.dtype == object else 0))
                bv = np.insert(bv, pos, np.asarray(iv, dtype=vals.dtype)
                               if vals.dtype != object else
                               np.fromiter(iv, dtype=object,
                                           count=len(iv)))
                bm = np.insert(bm, pos, np.asarray(im, dtype=np.bool_))
            nv = np.empty(cap, dtype=vals.dtype)
            nv[:new_n] = bv
            nm = np.zeros(cap, np.bool_)
            nm[:new_n] = bm
            new_cols[cid] = [nv, nm]
        self.handles = handles
        self.cols = new_cols
        self.cap = cap
        self.n = new_n
        self.n_dead = 0
        self.alive = None

    def tombstone_ratio(self) -> float:
        return self.n_dead / self.n if self.n else 0.0


def _merge_spans(positions, gap: int = 32):
    """Sorted unique row positions → merged half-open (lo, hi) spans (two
    positions less than ``gap`` apart share a span)."""
    spans = []
    for p in positions:
        if spans and p < spans[-1][1] + gap:
            spans[-1][1] = p + 1
        else:
            spans.append([p, p + 1])
    return [(lo, hi) for lo, hi in spans]


class _Line:
    __slots__ = ("key", "data_index", "snap", "state", "parked", "history",
                 "mu")

    def __init__(self, key, data_index, snap, state):
        self.key = key
        self.data_index = data_index
        self.snap = snap
        self.state = state
        self.parked: OrderedDict = OrderedDict()
        # recently superseded generations, newest first: each serves the
        # reads below its superseded_at without a build
        self.history: deque = deque(maxlen=4)
        self.mu = threading.Lock()


class RegionColumnarCache:
    """LRU of columnar lines keyed by (region, epoch version, table,
    columns), each stamped with the ``data_index`` it reflects.

    Thread-safe: a build or bridge for one (line, data version) runs outside
    the global lock, and concurrent requests for it wait on its event; two
    bridges of one line serialize on the line's mutex.

    ``delta_source`` (a ``copr.delta.DeltaSink``) supplies the committed
    writes a line is bridged across; without one every data-version change
    rebuilds.  A tombstone share above ``compact_ratio`` repacks the line; a
    gap of more than ``max_delta_rows`` row deltas rebuilds it."""

    def __init__(self, capacity: int = 8, delta_source=None,
                 compact_ratio: float = 0.25,
                 max_delta_rows: int = 1 << 16):
        self._lines: OrderedDict = OrderedDict()
        self._capacity = capacity
        self._lock = threading.Lock()
        self._delta_source = delta_source
        self._compact_ratio = compact_ratio
        self._max_delta_rows = max_delta_rows
        # (base_key, data_index) -> threading.Event of an in-flight build
        self._building: dict = {}
        self.hits = 0
        self.misses = 0         # builds
        self.deltas = 0         # data-version gaps bridged by a patch
        self.rebuilds = 0       # gaps that fell back to a build
        self.compactions = 0    # repacks (a mid-insert, the ratio crossed)
        self.invalidations = 0  # lines dropped by lifecycle events
        self.device_builds = 0  # builds that came with a cold bundle
        self.splits = 0         # parent lines sliced into child lines
        # the device rung of the build ladder (a DeviceMvccResolver) and
        # the planes the streaming ingest parsed (a ColdStreamBuilder)
        self.device_resolver = None
        self.stream_source = None
        # a RemintGovernor: every cold build first takes a permit from it
        # (None: unthrottled)
        self.remint_gate = None
        # decayed request rate per region, the governor's priority:
        # region id -> [rate, stamp]
        self._heat: dict = {}
        # epoch fence: region id -> lowest epoch version still allowed to
        # cache (a build racing a split must not re-insert a superseded
        # epoch's line after invalidate_region swept it)
        self._epoch_floor: dict = {}
        # sweep-generation fence for same-epoch invalidations: a build
        # that started before the sweep serves, but does not cache
        self._sweep_gen: dict = {}
        # retirement hook, called with each dropped line's FeedLineage
        # (the device supervisor drops the line's device feeds)
        self.on_line_retired = None

    # -- observability ------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            lines = [{
                "region": key[0], "epoch": key[1], "table": key[2],
                "data_index": line.data_index,
                "rows": line.state.n if line.state else 0,
                "feed_version": line.state.lineage.version
                if line.state else 0,
                "digest_feeds": len(line.state.lineage.feed_digests)
                if line.state else 0,
                "tombstone_ratio": line.state.tombstone_ratio()
                if line.state else 0.0,
            } for key, line in self._lines.items()]
        return {"hits": self.hits, "misses": self.misses,
                "deltas": self.deltas, "rebuilds": self.rebuilds,
                "compactions": self.compactions,
                "invalidations": self.invalidations,
                "device_builds": self.device_builds, "splits": self.splits,
                "resident_lines": len(lines), "lines": lines}

    # -- region heat (the re-mint governor's priority) ----------------

    _HEAT_HALFLIFE_S = 30.0

    def _note_heat(self, region_id: int) -> None:
        now = time.monotonic()
        with self._lock:
            st = self._heat.get(region_id)
            if st is None:
                self._heat[region_id] = [1.0, now]
                while len(self._heat) > 4096:
                    self._heat.pop(next(iter(self._heat)))
            else:
                st[0] = st[0] * 0.5 ** ((now - st[1]) /
                                        self._HEAT_HALFLIFE_S) + 1.0
                st[1] = now

    def region_heat(self, region_id: int) -> float:
        """The region's decayed request rate: after a mass invalidation the
        regions users hit rebuild first."""
        with self._lock:
            st = self._heat.get(region_id)
            if st is None:
                return 0.0
            return st[0] * 0.5 ** ((time.monotonic() - st[1]) /
                                   self._HEAT_HALFLIFE_S)

    # -- lifecycle teardown -------------------------------------------

    def _retire(self, line) -> None:
        """Hand the dropped line's lineage to the retirement hook.  Never
        raises: teardown runs on apply paths."""
        lineage = line.state.lineage if line is not None and \
            line.state is not None else None
        if lineage is not None:
            lineage.drop_cold()
        cb = self.on_line_retired
        if cb is not None and lineage is not None:
            try:
                cb(lineage)
            except Exception:   # noqa: BLE001 — teardown is best-effort
                import logging
                logging.getLogger(__name__).warning(
                    "cache line retirement hook failed", exc_info=True)

    def region_resident(self, region_id: int) -> int:
        """Live lines keyed to ``region_id`` (any epoch): a leader gain is
        a warm promotion only when this store already holds delta-patched
        lines of the region (``device/supervisor.py`` ``on_role_change``)."""
        with self._lock:
            return sum(1 for key in self._lines if key[0] == region_id)

    def invalidate_region(self, region_id: int,
                          keep_epoch: Optional[int] = None) -> int:
        """Drop ``region_id``'s lines now → how many.  A split, merge or
        epoch change passes ``keep_epoch``, the surviving epoch version
        (its lines, split children among them, stay; older epochs are
        fenced by the epoch floor); a snapshot apply or peer destroy drops
        every line and bumps the sweep generation."""
        dropped = []
        with self._lock:
            if keep_epoch is not None:
                floor = max(self._epoch_floor.pop(region_id, 0),
                            keep_epoch)
                self._epoch_floor[region_id] = floor
                while len(self._epoch_floor) > 4096:
                    self._epoch_floor.pop(next(iter(self._epoch_floor)))
            else:
                gen = self._sweep_gen.pop(region_id, 0) + 1
                self._sweep_gen[region_id] = gen
                while len(self._sweep_gen) > 4096:
                    self._sweep_gen.pop(next(iter(self._sweep_gen)))
            for key in list(self._lines):
                if key[0] != region_id:
                    continue
                if keep_epoch is not None and key[1] == keep_epoch:
                    continue
                dropped.append(self._lines.pop(key))
            self.invalidations += len(dropped)
        for line in dropped:
            self._retire(line)
        return len(dropped)

    # -- device-side region split -------------------------------------

    def split_lines(self, left, right, left_index: Optional[int],
                    right_index: Optional[int]) -> list:
        """Serve a region split by slicing the parent's lines (epoch
        ``left.epoch.version − 1``) into child lines at the children's
        epochs: no ``columnar_build``, exact ``data_index`` stamps, fresh
        lineages.  The parent lines are not retired here; the
        ``invalidate_region(left.id, keep_epoch=...)`` sweep that follows
        does that, after the runner sliced the resident parent feeds.

        → one spec per sliced parent line for
        ``DeviceRunner.split_resident_feeds``: {parent_lineage,
        parent_version, pos, n_parent, left: {lineage, n, state} or None,
        right: ...}."""
        if left_index is None:
            return []
        old_epoch = left.epoch.version - 1
        with self._lock:
            parents = [(k, self._lines[k]) for k in list(self._lines)
                       if k[0] == left.id and k[1] == old_epoch]
        specs = []
        for key, line in parents:
            spec = self._split_one(key, line, left, right, left_index,
                                   right_index)
            if spec is not None:
                specs.append(spec)
                self.splits += 1
        return specs

    def _split_one(self, key, line, left, right, left_index: int,
                   right_index: Optional[int]):
        # a line lagging the split point bridges forward first (a split
        # does not bump data_index: left_index is the last write before
        # it).  There is no snapshot here: a delta whose payload spilled
        # to CF_DEFAULT fails the bridge, and the children rebuild
        if line.state is None or line.data_index is None or \
                line.data_index > left_index:
            return None
        if line.data_index < left_index:
            if self._delta_source is None:
                return None
            try:
                if self._bridge(line, None, left.id, left_index) is None:
                    return None
            except Exception:   # noqa: BLE001 — any surprise: rebuild
                return None
        with line.mu:
            st = line.state
            if st is None or line.data_index != left_index:
                return None
            n = st.n
            lo_key, hi_key = table_record_range(st.table_id)
            sk = right.start_key
            if sk:
                # region boundaries hold engine keys; the handle
                # comparison below needs the user key
                try:
                    sk = decode_key(sk)
                except Exception:   # noqa: BLE001 — not an engine key
                    return None
            if not sk or sk <= lo_key:
                pos = 0
            elif sk >= hi_key:
                pos = n
            else:
                try:
                    pos = int(np.searchsorted(
                        st.handles[:n], decode_record_handle(sk)))
                except Exception:   # noqa: BLE001 — not a record key
                    return None
            parent_lineage = st.lineage
            parent_version = st.lineage.version
            children = []
            for side, region, data_index in (
                    ("left", left, left_index),
                    ("right", right, right_index)):
                if data_index is None:
                    continue    # no right peer on this store
                lo, hi = (0, pos) if side == "left" else (pos, n)
                child = self._child_state(st, lo, hi, region.id)
                children.append({
                    "side": side, "lineage": child.lineage,
                    "n": child.n, "state": child,
                    "key": (region.id, region.epoch.version) + key[2:],
                    "data_index": data_index})
        # the capacity is not enforced here: evicting the parent now would
        # tear down the feed the device split is about to slice; the
        # keep_epoch sweep right behind retires the parents
        minted = []
        with self._lock:
            for ch in children:
                ckey = ch["key"]
                if ckey[1] < self._epoch_floor.get(ckey[0], 0) or \
                        ckey in self._lines:
                    continue    # a racing build won: keep its line
                snap = ch["state"].publish()
                self._lines[ckey] = _Line(ckey, ch["data_index"], snap,
                                          ch["state"])
                self._lines.move_to_end(ckey)
                minted.append(ch)
        if not minted:
            return None
        spec = {"parent_lineage": parent_lineage,
                "parent_version": parent_version,
                "pos": pos, "n_parent": n, "left": None, "right": None}
        for ch in minted:
            # the child's state rides along: the device split re-anchors
            # the child digests to this host truth
            spec[ch["side"]] = {"lineage": ch["lineage"], "n": ch["n"],
                                "state": ch["state"]}
        return spec

    @staticmethod
    def _child_state(st: _LineState, lo: int, hi: int,
                     region_id: int) -> _LineState:
        """A child line's state: the parent's rows [lo, hi) in fresh slack
        buffers, with a fresh FeedLineage (version 0, the version of the
        child feed the device split mints)."""
        child = _LineState.__new__(_LineState)
        child.table_id = st.table_id
        child.col_meta = dict(st.col_meta)
        n = hi - lo
        child.n = n
        cap = n + max(_LineState.SLACK_MIN, n >> 3)
        child.cap = cap
        handles = np.empty(cap, np.int64)
        handles[:n] = st.handles[lo:hi]
        child.handles = handles
        child.cols = {}
        for cid, (vals, valid) in st.cols.items():
            nv = np.empty(cap, dtype=vals.dtype)
            nv[:n] = vals[lo:hi]
            nm = np.zeros(cap, np.bool_)
            nm[:n] = valid[lo:hi]
            child.cols[cid] = [nv, nm]
        if st.alive is not None:
            alive = np.ones(cap, np.bool_)
            alive[:n] = st.alive[lo:hi]
            child.n_dead = int(n - np.count_nonzero(alive[:n]))
            child.alive = alive if child.n_dead else None
        else:
            child.alive = None
            child.n_dead = 0
        # every parent lock travels to both children: an extra lock only
        # over-blocks a read, never under-blocks it
        child.locks = dict(st.locks)
        child.safe_ts = st.safe_ts
        child.build_ts = st.build_ts
        child.lineage = FeedLineage()
        child.lineage.region_hint = region_id
        return child

    # -- lookup -------------------------------------------------------

    def get(self, snap, dag) -> Optional[MvccColumnarSnapshot]:
        """The columnar snapshot for a TableScan dag over a region
        snapshot, or None when the snapshot carries no data-version stamp.
        Raises ``KeyIsLocked`` when a pending lock inside the request's
        ranges conflicts at ``dag.start_ts``."""
        scan = dag.executors[0]
        region = getattr(snap, "region", None)
        data_index = getattr(snap, "data_index", None)
        if region is None or data_index is None:
            return None
        base_key = (region.id, region.epoch.version, scan.table_id,
                    tuple((c.col_id, c.is_pk_handle, c.field_type.tp)
                          for c in scan.columns))
        start_ts = dag.start_ts
        self._note_heat(region.id)
        while True:
            with self._lock:
                line = self._lines.get(base_key)
                got = self._lookup_locked(line, data_index, start_ts)
                if got is not None:
                    ent, lock_src = got
                    self._lines.move_to_end(base_key)
                    self.hits += 1
                    break
                bkey = (base_key, data_index)
                wait_ev = self._building.get(bkey)
                if wait_ev is None:
                    self._building[bkey] = threading.Event()
                    # the generation at build start: a sweep landing
                    # while this builds fences the insert
                    gen0 = self._sweep_gen.get(base_key[0], 0)
            if wait_ev is not None:
                wait_ev.wait()
                continue        # the builder's line may serve this
            try:
                ent, lock_src = self._materialize(
                    snap, dag, base_key, line, data_index, start_ts, gen0)
                break
            finally:
                with self._lock:
                    ev = self._building.pop((base_key, data_index), None)
                if ev is not None:
                    ev.set()
        lock_src.check_locks(dag.ranges, start_ts)
        return ent

    def get_fast(self, snap, base_key: tuple, ranges,
                 start_ts: int) -> Optional[MvccColumnarSnapshot]:
        """Warm-hit-only lookup for the compiled request fast path
        (``server/fastpath.py``): ``base_key`` was derived once, when the
        class was learned, so a repeat request pays one dict probe.  None
        whenever the snapshot's region or epoch no longer matches the
        learned key or the line cannot serve warm: the caller then takes
        the full ceremony (build, bridge, park); this never builds.
        Raises ``KeyIsLocked`` exactly as ``get`` does."""
        region = getattr(snap, "region", None)
        data_index = getattr(snap, "data_index", None)
        if region is None or data_index is None or \
                (region.id, region.epoch.version) != base_key[:2]:
            return None
        self._note_heat(region.id)
        with self._lock:
            line = self._lines.get(base_key)
            got = self._lookup_locked(line, data_index, start_ts)
            if got is None:
                return None
            ent, lock_src = got
            self._lines.move_to_end(base_key)
            self.hits += 1
        lock_src.check_locks(ranges, start_ts)
        return ent

    def is_current(self, base_key: tuple, snap) -> bool:
        """Non-building peek: is ``snap`` still the line's newest
        generation?  The fast path checks its learned snapshot with this
        before it serves a hit; a delta patch, a rebuild, an epoch sweep
        or an eviction answers False, and the class re-learns."""
        with self._lock:
            line = self._lines.get(base_key)
            return line is not None and line.snap is snap

    @staticmethod
    def _lookup_locked(line, data_index: int, start_ts: int):
        """→ (snapshot, lock source) or None.  A generation from the line's
        history checks its locks against the line's newest set (its own
        are stale; the newest set over-blocks at worst: a lock released
        since was resolved above the read's ts or by a data delta that
        superseded the old generation)."""
        if line is None:
            return None
        if line.data_index == data_index and line.snap is not None and \
                line.snap.valid_for(start_ts):
            return line.snap, line.snap
        # under write churn a read whose ts precedes every commit since an
        # older generation sees the same visible set there: serve it, no
        # build.  Sound only once the line has applied at least up to the
        # requested version (superseded_at bounds applied batches only)
        if line.data_index is not None and line.data_index >= data_index:
            for old in line.history:
                if old.valid_for(start_ts) and (
                        old.superseded_at is None or
                        start_ts < old.superseded_at):
                    return old, (line.snap if line.snap is not None
                                 else old)
        parked = line.parked.get((data_index, start_ts))
        if parked is not None:
            line.parked.move_to_end((data_index, start_ts))
            return parked, parked
        return None

    def _materialize(self, snap, dag, base_key, line, data_index: int,
                     start_ts: int, gen0: int = 0):
        from ..utils import tracker
        scan = dag.executors[0]
        # classified before the bridge: a failed bridge retires the state,
        # and its fallback still counts as a rebuild
        had_state = line is not None and line.state is not None
        if had_state and line.data_index is not None and \
                line.data_index < data_index and \
                self._delta_source is not None:
            with tracker.phase("delta_apply"):
                bridged = self._bridge(line, snap, base_key[0], data_index)
            if bridged is not None:
                with self._lock:
                    if base_key in self._lines:     # may be evicted
                        self._lines.move_to_end(base_key)
                    self.deltas += 1
                tracker.label("copr_cache", "delta")
                if bridged.valid_for(start_ts):
                    return bridged, bridged
                # the request reads below the new safe_ts: the generation
                # it raced past may serve it from the history
                with self._lock:
                    got = self._lookup_locked(line, data_index, start_ts)
                if got is not None:
                    return got
        self.misses += 1
        tracker.label("copr_cache", "build")
        # a re-mint permit before the build: the governor queues it hot
        # regions first and may shed it (ServerIsBusy with a retry hint)
        gate = self.remint_gate
        ticket = None
        if gate is not None:
            with tracker.phase("remint_wait"):
                ticket = gate.acquire(base_key[0],
                                      heat=self.region_heat(base_key[0]))
        try:
            with tracker.phase("columnar_build"):
                tbl, safe_ts, locks, bundle = build_region_columnar_ex(
                    snap, scan.table_id, scan.columns, start_ts,
                    device_resolver=self.device_resolver,
                    stream_source=self.stream_source)
        finally:
            if ticket is not None:
                gate.release(ticket)
        if bundle is not None:
            self.device_builds += 1
        ent = MvccColumnarSnapshot(tbl, start_ts, safe_ts,
                                   blocking_locks=locks)
        retired: list = []
        with self._lock:
            if base_key[1] < self._epoch_floor.get(base_key[0], 0) or \
                    self._sweep_gen.get(base_key[0], 0) != gen0:
                # a lifecycle sweep covered this region mid-build: the
                # answer serves this request, but is not cached
                if bundle is not None:
                    bundle.release()
                return ent, ent
            prev = self._lines.get(base_key)
            fresh_wins = prev is None or prev.data_index is None or \
                prev.data_index <= data_index
            if start_ts < safe_ts or not fresh_wins:
                # a below-safe_ts build sees an old version set, and a
                # build raced past by a newer line serves once: both park
                # under their exact (version, ts)
                if prev is None:
                    prev = _Line(base_key, None, None, None)
                    self._lines[base_key] = prev
                prev.parked[(data_index, start_ts)] = ent
                while len(prev.parked) > 4:
                    prev.parked.popitem(last=False)
            else:
                if had_state:
                    self.rebuilds += 1
                state = _LineState(scan.table_id, scan.columns, tbl,
                                   safe_ts, start_ts, locks)
                state.lineage.region_hint = base_key[0]
                if bundle is not None:
                    state.lineage.stash_cold(bundle)
                    bundle = None
                ent = state.publish()
                new_line = _Line(base_key, data_index, ent, state)
                if prev is not None:
                    new_line.parked = prev.parked
                    retired.append(prev)    # its lineage and feeds die
                self._lines[base_key] = new_line
            self._lines.move_to_end(base_key)
            while len(self._lines) > self._capacity:
                _k, evicted = self._lines.popitem(last=False)
                retired.append(evicted)
        if bundle is not None:      # parked or uncached build
            bundle.release()
        for old in retired:
            self._retire(old)
        return ent, ent

    # -- the delta bridge ---------------------------------------------

    def _bridge(self, line, snap, region_id: int, data_index: int):
        """Patch ``line`` forward to ``data_index`` → its new published
        snapshot, or None (the caller rebuilds).  The deltas are read under
        the line's mutex: two bridges toward different versions each replay
        exactly the gap from the line's version then, never a batch
        twice."""
        with line.mu:
            cur = line.data_index
            if cur is None or cur > data_index or line.state is None:
                return None
            if cur == data_index:
                return line.snap
            deltas = self._delta_source.deltas_between(region_id, cur,
                                                       data_index)
            if deltas is None or len(deltas[0]) > self._max_delta_rows:
                return None
            try:
                published = self._apply_deltas(line.state, snap, *deltas)
            except Exception:   # noqa: BLE001 — any surprise: rebuild
                import logging
                logging.getLogger(__name__).warning(
                    "columnar delta apply failed; falling back to rebuild",
                    exc_info=True)
                published = None
            if published is None:
                # the state may be part-patched: retire it (and its device
                # feeds) so no later bridge replays onto it
                self._retire(line)
                line.state = None
                return None
            published, min_data_ts = published
            prev = line.snap
            with self._lock:
                if prev is not None:
                    # the outgoing generation serves reads below the first
                    # commit that superseded it; commit_ts order is not
                    # apply order across keys, so every older generation's
                    # bound tightens too
                    if min_data_ts is not None:
                        for h in (prev,) + tuple(line.history):
                            h.superseded_at = min_data_ts \
                                if h.superseded_at is None else \
                                min(h.superseded_at, min_data_ts)
                    line.history.appendleft(prev)
                line.data_index = data_index
                line.snap = published
                line.parked.clear()
            return published

    def _apply_deltas(self, state: _LineState, snap, rows, locks):
        """Replay ``rows`` and ``locks`` onto ``state`` → (its published
        snapshot, the least data commit_ts of the batch), or None when a
        payload is not available (the caller rebuilds).  The patch is
        journalled on the lineage: ``{"structural": True, "n"}`` when rows
        moved or a tombstone mask exists, else ``{"structural": False, "n",
        "spans": [{lo, hi, handles, cols}]}`` with each written span's
        rows."""
        lo_key, hi_key = table_record_range(state.table_id)
        # 1. fold the row deltas: the safe_ts watermark, the last visible
        #    op of each key
        pending: OrderedDict = OrderedDict()
        min_data_ts = None
        for d in rows:
            if not lo_key <= d.user_key < hi_key:
                continue        # index keys, other tables of the region
            if d.commit_ts > state.safe_ts:
                state.safe_ts = d.commit_ts
            if d.kind == "advance":
                continue
            if min_data_ts is None or d.commit_ts < min_data_ts:
                min_data_ts = d.commit_ts
            pending[d.user_key] = d
        state.build_ts = max(state.build_ts, state.safe_ts)

        # 2. payloads, classified against the current rows
        updates: list = []      # (pos, payload)
        deletes: list = []      # pos
        inserts: list = []      # (handle, payload)
        revives: list = []      # (pos, payload): a tombstoned row reused
        for user_key, d in pending.items():
            handle = decode_record_handle(user_key)
            pos, present = state._pos_of(handle)
            dead = present and state.alive is not None and \
                not state.alive[pos]
            if d.kind == "delete":
                if present and not dead:
                    deletes.append(pos)
                continue
            payload = self._resolve_payload(snap, d)
            if payload is None:
                return None     # a spilled value not available: rebuild
            if present:
                (revives if dead else updates).append((pos, payload))
            else:
                inserts.append((handle, payload))

        n0 = state.n
        patch_spans: list = []
        structural = False

        # 3. inserts: into the slack when all lie past the greatest handle,
        #    else one repack (a mid-insert)
        append_only = all(h > int(state.handles[n0 - 1])
                          for h, _ in inserts) if n0 else True
        if inserts and (not append_only or n0 + len(inserts) > state.cap):
            # the repack folds deletes and tombstones too; positional
            # updates land first so it copies the patched values
            if updates or revives:
                state._cow_columns()
                for pos, payload in updates + revives:
                    state._set_row(pos, payload)
                if revives:
                    state._cow_alive()
                    for pos, _ in revives:
                        state.alive[pos] = True
                        state.n_dead -= 1
            if deletes:
                state._cow_alive()
                for pos in deletes:
                    state.alive[pos] = False
                state.n_dead += len(deletes)
            state._repack(inserts)
            self.compactions += 1
            structural = True
        else:
            if updates or revives:
                state._cow_columns()
                for pos, payload in updates + revives:
                    state._set_row(pos, payload)
                patch_spans.extend(_merge_spans(sorted(
                    {p for p, _ in updates})))
            if revives:
                state._cow_alive()
                for pos, _ in revives:
                    state.alive[pos] = True
                state.n_dead -= len(revives)
                structural = True
            if deletes:
                state._cow_alive()
                for pos in deletes:
                    state.alive[pos] = False
                state.n_dead += len(deletes)
                structural = True
            if inserts:
                ins = sorted(inserts, key=lambda kv: kv[0])
                k = len(ins)
                state.handles[n0:n0 + k] = [h for h, _ in ins]
                if state.alive is not None:
                    state.alive[n0:n0 + k] = True
                for i, (_h, payload) in enumerate(ins):
                    state._set_row(n0 + i, payload)
                state.n += k
                patch_spans.append((n0, state.n))
            # 4. compaction: the tombstone share crossed the ratio
            if state.alive is not None and \
                    state.tombstone_ratio() > self._compact_ratio:
                state._repack([])
                self.compactions += 1
                structural = True

        if state.alive is not None and state.n_dead == 0:
            # every tombstone was revived: scans are zero-copy again (the
            # published copy-on-write mask stays with the older snapshots)
            state.alive = None

        # 5. the blocking locks (range-scoped, as the build's scan)
        for ld in locks:
            if not lo_key <= ld.user_key < hi_key:
                continue
            if ld.lock is None:
                state.locks.pop(ld.user_key, None)
            else:
                state.locks[ld.user_key] = ld.lock

        # 6. the patch, journalled for the device feed
        if structural or state.alive is not None:
            state.lineage.record({"structural": True, "n": state.n})
        else:
            spans = [{"lo": lo, "hi": hi,
                      "handles": state.handles[lo:hi].copy(),
                      "cols": {cid: (bufs[0][lo:hi].copy(),
                                     bufs[1][lo:hi].copy())
                               for cid, bufs in state.cols.items()}}
                     for lo, hi in patch_spans]
            state.lineage.record({"structural": False, "n": state.n,
                                  "spans": spans})
        return state.publish(), min_data_ts

    @staticmethod
    def _resolve_payload(snap, d) -> Optional[dict]:
        """A PUT's row: its inlined short value, else its CF_DEFAULT record
        in ``snap`` (None when there is none)."""
        if d.short_value is not None:
            return decode_row(d.short_value) if d.short_value else {}
        v = snap.get_value_cf(CF_DEFAULT, append_ts(d.enc_key, d.start_ts))
        if v is None:
            return None
        return decode_row(v)
