"""Columnar table snapshots — the scan feed of the device runner.

A snapshot is a sorted handle array plus dense value/validity arrays per
column (the reference's Chunk encode_type applied at rest,
tidb_query_executors/src/runner.rs:71-76), so a scan produces columnar
blocks without a per-row decode loop.  Table scans and covering scans of
a single-column index (``IndexScanDesc``) are both served, and a device
selection vector maps back to rows through ``gather_rows`` without
materializing the whole scan.  ``BatchColumnarTableScanExecutor`` is the
host pipeline's scan over a snapshot.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

from ..codec.keys import _RECORD_SEP, _TABLE_PREFIX, index_key_prefix
from ..codec.mc_datum import decode_mc_datum
from ..codec.number import decode_i64, encode_i64
from ..copr.dag import IndexScanDesc
from ..datatype import Column, ColumnBatch, EvalType, FieldType
from .interface import BatchExecuteResult, TimedExecutor
from .ranges import KeyRange

_I64_MIN = -(2**63)
_I64_MAX = 2**63 - 1


def _record_prefix(table_id: int) -> bytes:
    return _TABLE_PREFIX + encode_i64(table_id) + _RECORD_SEP


def handle_bounds(r: KeyRange, table_id: int) -> tuple[int, int]:
    """Map a record-key range to an inclusive-exclusive handle interval.

    Record keys are exactly prefix+8 bytes; longer keys sort between handle
    and handle+1, so a long start key starts *after* its handle and a long
    end key ends *after* its handle (inclusive of it).
    """
    prefix = _record_prefix(table_id)
    plen = len(prefix)

    def bound(k: bytes, past_table: int) -> int:
        if k <= prefix:
            return _I64_MIN
        if not k.startswith(prefix):
            return past_table
        if len(k) < plen + 8:
            # short key: pad with 0x00 and decode what is there
            return decode_i64(k[plen:].ljust(8, b"\x00"), 0)
        h = decode_i64(k, plen)
        # python ints are unbounded: h+1 may exceed i64 (the caller treats
        # bounds > i64::MAX as "all")
        return h if len(k) == plen + 8 else h + 1

    return bound(r.start, _I64_MAX), bound(r.end, _I64_MAX + 1)


class ColumnarTable:
    """Immutable columnar snapshot of one table's committed rows.

    ``handles`` must be sorted ascending (the physical key order of record
    keys).  ``columns`` maps col_id → Column aligned with ``handles``.
    ``alive``: None, or a bool mask of the rows that exist (the delete
    tombstones an incrementally maintained snapshot carries); dead rows
    never appear in a scan.
    """

    def __init__(self, table, handles: np.ndarray, columns: dict,
                 alive=None):
        self.table = table
        self.handles = np.asarray(handles, dtype=np.int64)
        assert np.all(self.handles[1:] > self.handles[:-1]), \
            "handles must be strictly increasing"
        self.columns = columns
        self.alive = None if alive is None else np.asarray(alive, np.bool_)
        self._feed_pos_cache: dict = {}
        self._index_order_cache: dict = {}
        self._ones_validity = np.ones(0, np.bool_)

    @staticmethod
    def from_arrays(table, handles, named_columns: dict,
                    alive=None) -> "ColumnarTable":
        """named_columns: {column name: np.ndarray | Column}; ``alive`` in
        the order of ``handles``."""
        handles = np.asarray(handles, dtype=np.int64)
        order = np.argsort(handles, kind="stable")
        handles = handles[order]
        cols: dict = {}
        for name, data in named_columns.items():
            tc = table[name]
            if isinstance(data, Column):
                col = Column(data.eval_type, data.values[order],
                             data.validity[order])
            else:
                arr = np.asarray(data)[order]
                col = Column.from_values(tc.field_type.eval_type, arr)
            cols[tc.col_id] = col
        return ColumnarTable(table, handles, cols,
                             None if alive is None
                             else np.asarray(alive, np.bool_)[order])

    def __len__(self) -> int:
        return len(self.handles)

    def estimated_rows(self) -> int:
        return len(self.handles)

    def _range_slices(self, ranges: Sequence[KeyRange]) -> list[tuple[int, int]]:
        out = []
        n = len(self.handles)
        if not ranges:
            return [(0, n)] if n else []
        for r in ranges:
            lo, hi = handle_bounds(r, self.table.table_id)
            i = n if lo > _I64_MAX else \
                int(np.searchsorted(self.handles, max(lo, _I64_MIN),
                                    side="left"))
            j = n if hi > _I64_MAX else \
                int(np.searchsorted(self.handles, hi, side="left"))
            if i < j:
                out.append((i, j))
        return out

    def count_rows(self, ranges: Sequence[KeyRange]) -> int:
        if self.alive is None:
            return sum(j - i for i, j in self._range_slices(ranges))
        return sum(int(self.alive[i:j].sum())
                   for i, j in self._range_slices(ranges))

    def row_slices(self, ranges: Sequence[KeyRange]) -> list:
        """The physical row spans of a table scan over ``ranges``; refused
        under tombstones, where the spans would hold dead rows."""
        if self.alive is not None:
            raise ValueError("row spans unavailable under tombstones")
        return self._range_slices(ranges)

    def _ones(self, n: int) -> np.ndarray:
        """An all-true validity of n rows: a slice of one cached, read-only
        buffer (the handle column's; a fresh one per scan of 100·2^20 rows
        costs tens of ms)."""
        if len(self._ones_validity) < n:
            ones = np.ones(max(n, len(self.handles)), dtype=np.bool_)
            ones.flags.writeable = False
            self._ones_validity = ones
        return self._ones_validity[:n]

    def scan_columns(self, desc, ranges: Sequence[KeyRange]) -> ColumnBatch:
        """Vectorized range scan of a TableScan or an IndexScan →
        ColumnBatch in ``desc.columns`` order."""
        if isinstance(desc, IndexScanDesc):
            return self._scan_index_columns(desc, ranges)
        slices = self._range_slices(ranges)
        if desc.desc:
            slices = [(i, j) for i, j in reversed(slices)]
        alive = self.alive

        def gather(values: np.ndarray, validity: np.ndarray):
            if alive is None and len(slices) == 1 and not desc.desc:
                i, j = slices[0]
                return values[i:j], validity[i:j]
            vparts, mparts = [], []
            for i, j in slices:
                v, m = values[i:j], validity[i:j]
                if alive is not None:
                    keep = alive[i:j]
                    v, m = v[keep], m[keep]
                if desc.desc:
                    v, m = v[::-1], m[::-1]
                vparts.append(v)
                mparts.append(m)
            if not vparts:
                return values[:0], validity[:0]
            return np.concatenate(vparts), np.concatenate(mparts)

        out_cols = []
        for info in desc.columns:
            if info.is_pk_handle:
                v, m = gather(self.handles, self._ones(len(self.handles)))
                out_cols.append(Column(EvalType.INT, v, m))
                continue
            col = self.columns.get(info.col_id)
            if col is None:
                # absent column → all default_value/NULL
                n = sum(j - i if alive is None else int(alive[i:j].sum())
                        for i, j in slices)
                out_cols.append(Column.from_list(
                    info.field_type.eval_type, [info.default_value] * n))
                continue
            v, m = gather(col.values, col.validity)
            out_cols.append(Column(col.eval_type, v, m))
        return ColumnBatch([c.field_type for c in desc.columns], out_cols)

    # -- late-materialized gather (device selection vector → rows) ----------

    def _feed_positions(self, slices: tuple, desc: bool) -> np.ndarray:
        """Memoized map from scan-output position → physical row index, in
        ``scan_columns``' order (alive rows only, slice order, descending
        reversal)."""
        key = (slices, desc)
        pos = self._feed_pos_cache.get(key)
        if pos is None:
            parts = []
            for i, j in (reversed(slices) if desc else slices):
                ids = np.arange(i, j, dtype=np.int64)
                if self.alive is not None:
                    ids = ids[self.alive[i:j]]
                parts.append(ids[::-1] if desc else ids)
            pos = parts[0] if len(parts) == 1 else (
                np.concatenate(parts) if parts else np.empty(0, np.int64))
            self._feed_pos_cache[key] = pos
        return pos

    def gather_rows(self, desc, ranges: Sequence[KeyRange],
                    rows) -> ColumnBatch:
        """The rows ``rows`` of a table scan's output without materializing
        the scan: ``rows`` is a bool mask over the scan output, or an int
        array of scan-output positions (their order is kept)."""
        if isinstance(desc, IndexScanDesc):
            raise ValueError("gather_rows serves table scans; index "
                             "scans take rows of their sorted view")
        slices = tuple(self._range_slices(ranges))
        rows = np.asarray(rows)
        if self.alive is None and not desc.desc and len(slices) <= 1:
            lo = slices[0][0] if slices else 0
            phys = (np.flatnonzero(rows) + lo) if rows.dtype == np.bool_ \
                else rows + lo
        else:
            phys = self._feed_positions(slices, desc.desc)[rows]
        out_cols = []
        for info in desc.columns:
            if info.is_pk_handle:
                out_cols.append(Column(EvalType.INT, self.handles[phys],
                                       self._ones(len(phys))))
                continue
            col = self.columns.get(info.col_id)
            if col is None:
                out_cols.append(Column.from_list(
                    info.field_type.eval_type,
                    [info.default_value] * len(phys)))
                continue
            out_cols.append(Column(col.eval_type, col.values[phys],
                                   col.validity[phys]))
        return ColumnBatch([c.field_type for c in desc.columns], out_cols)

    # -- row-codec materialization (the CHECKSUM request) -------------------

    def to_kv_pairs(self, ranges=None) -> list[tuple[bytes, bytes]]:
        """The logical rows within ``ranges`` (None: all) as (record key,
        row payload) pairs, the live rows only: the bytes the reference's
        ``to_kv_pairs`` gives for the same table."""
        from ..codec.keys import table_record_key
        from ..codec.row import encode_row
        if ranges is None:
            indices = range(len(self.handles))
        else:
            indices = [i for lo, hi in self._range_slices(ranges)
                       for i in range(lo, hi)]
        if self.alive is not None:
            indices = [i for i in indices if self.alive[i]]
        pairs = []
        for i in indices:
            payload = {}
            for col_id, col in self.columns.items():
                v = col.get(i)
                if v is not None:
                    payload[col_id] = v
            pairs.append((table_record_key(self.table.table_id,
                                           int(self.handles[i])),
                          encode_row(payload)))
        return pairs

    # -- covering index scans ------------------------------------------------

    def _index_sorted(self, col_id: int):
        """Memoized (value, handle)-sorted view of one indexed column of
        the alive rows → (values, validity, handles, NULL count); NULLs
        sort first (MySQL)."""
        got = self._index_order_cache.get(col_id)
        if got is None:
            col = self.columns[col_id]
            values, validity, handles = col.values, col.validity, \
                self.handles
            if self.alive is not None:
                keep = self.alive
                values, validity, handles = \
                    values[keep], validity[keep], handles[keep]
            nulls = ~validity
            order = np.lexsort((handles, values, nulls * -1))
            got = (values[order], validity[order], handles[order],
                   int(nulls.sum()))
            for a in got[:3]:       # handed out as views: keep them intact
                a.flags.writeable = False
            self._index_order_cache[col_id] = got
        return got

    @staticmethod
    def _index_bound(key: bytes, prefix: bytes, svals, shandles,
                     n_nulls: int) -> int:
        """Encoded index key → offset into the sorted index view.

        Index keys are ``prefix + mc_datum(value) [+ mc_datum(handle)]``;
        rows at or after the returned offset have encoded keys >= ``key``.
        """
        n = len(svals)
        if key <= prefix:
            return 0
        if not key.startswith(prefix):
            return 0 if key < prefix else n
        try:
            v, off = decode_mc_datum(key, len(prefix))
        except (ValueError, IndexError, struct.error):
            return n        # e.g. the 0xff… full-range sentinel: past all
        if v is None:       # NULL datum: the NULLs-first block
            i0, i1 = 0, n_nulls
        else:
            i0 = n_nulls + int(np.searchsorted(svals[n_nulls:], v, "left"))
            i1 = n_nulls + int(np.searchsorted(svals[n_nulls:], v, "right"))
        if off < len(key):  # handle datum: tie-break within the value run
            try:
                h, _ = decode_mc_datum(key, off)
            except (ValueError, IndexError, struct.error):
                return i1   # junk after the value datum: past the run
            return i0 + int(np.searchsorted(shandles[i0:i1], h, "left"))
        return i0

    def _scan_index_columns(self, desc: IndexScanDesc,
                            ranges: Sequence[KeyRange]) -> ColumnBatch:
        """Covering scan of a single-column index: the indexed column and
        the handle in index order, range- and direction-aware (reference:
        index_scan_executor.rs)."""
        infos = desc.columns
        want_handle = bool(infos) and infos[-1].is_pk_handle
        idx_infos = infos[:-1] if want_handle else infos
        if len(idx_infos) != 1:
            raise ValueError("columnar index scans serve single-column "
                             "indexes")
        info = idx_infos[0]
        col = self.columns[info.col_id]
        svals, svalid, shandles, n_nulls = self._index_sorted(info.col_id)
        prefix = index_key_prefix(self.table.table_id, desc.index_id)
        slices = []
        for r in ranges:
            i = self._index_bound(r.start, prefix, svals, shandles, n_nulls)
            j = self._index_bound(r.end, prefix, svals, shandles, n_nulls)
            if i < j:
                slices.append((i, j))
        if desc.desc:
            slices = [(i, j) for i, j in reversed(slices)]

        def gather(a: np.ndarray) -> np.ndarray:
            parts = [a[i:j][::-1] if desc.desc else a[i:j]
                     for i, j in slices]
            if not parts:
                return a[:0]
            return parts[0] if len(parts) == 1 else np.concatenate(parts)

        out_cols = [Column(col.eval_type, gather(svals), gather(svalid))]
        if want_handle:
            gh = gather(shandles)
            out_cols.append(Column(EvalType.INT, gh, self._ones(len(gh))))
        return ColumnBatch([c.field_type for c in infos], out_cols)


class BatchColumnarTableScanExecutor(TimedExecutor):
    """The host pipeline's scan of a columnar snapshot: no row decode.
    The vectorized scan result is handed out in slices, so the pull-model
    pipeline above it is unchanged (interface.rs:21)."""

    def __init__(self, snapshot, desc, ranges: Sequence[KeyRange]):
        super().__init__()
        self._batch = snapshot.scan_columns(desc, ranges)
        self._pos = 0
        self._schema = list(desc.schema)
        self._src = (snapshot, desc, ranges)
        self._hcache = None

    @property
    def schema(self) -> list[FieldType]:
        return self._schema

    # -- paging (endpoint.rs's paged requests) --
    #
    # A page resumes after the LAST RETURNED HANDLE, not at a row offset:
    # each page may read a newer snapshot (writes land between pages), and
    # a handle stays exact where an offset would skip or repeat rows.

    def _scan_handles(self):
        """The handles of the scan's rows in scan order, or None when the
        scan cannot resume (an index scan, a descending scan, a storage
        without handles)."""
        if self._hcache is None:
            snap, desc, ranges = self._src
            tbl = snap if hasattr(snap, "_range_slices") else \
                getattr(snap, "_tbl", None)     # MvccColumnarSnapshot
            if tbl is None or isinstance(desc, IndexScanDesc) or desc.desc:
                self._hcache = False
            else:
                alive = getattr(tbl, "alive", None)
                parts = [tbl.handles[i:j] if alive is None
                         else tbl.handles[i:j][alive[i:j]]
                         for i, j in tbl._range_slices(ranges)]
                self._hcache = parts[0] if len(parts) == 1 else (
                    np.concatenate(parts) if parts else tbl.handles[:0])
        return None if self._hcache is False else self._hcache

    def resume_handle(self):
        """The next page's token: the last consumed row's handle, or None
        when nothing was consumed or the scan cannot resume."""
        h = self._scan_handles()
        if h is None or self._pos == 0:
            return None
        return int(h[self._pos - 1])

    def skip_after_handle(self, token: int) -> None:
        h = self._scan_handles()
        if h is None:
            raise ValueError("scan does not support handle resume")
        self._pos = int(np.searchsorted(h, token, side="right"))

    def supports_resume(self) -> bool:
        return self._scan_handles() is not None

    def _next_batch(self, scan_rows: int) -> BatchExecuteResult:
        start = self._pos
        stop = min(start + scan_rows, self._batch.num_rows)
        self._pos = stop
        return BatchExecuteResult(self._batch.slice(start, stop),
                                  stop >= self._batch.num_rows)
