"""Columnar table snapshots — the scan feed of the device runner.

A snapshot is a sorted handle array plus dense value/validity arrays per
column (the reference's Chunk encode_type applied at rest,
tidb_query_executors/src/runner.rs:71-76), so a scan produces columnar
blocks without a per-row decode loop.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..codec.keys import _RECORD_SEP, _TABLE_PREFIX
from ..codec.number import decode_i64, encode_i64
from ..datatype import Column, ColumnBatch, EvalType
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
    """

    def __init__(self, table, handles: np.ndarray, columns: dict):
        self.table = table
        self.handles = np.asarray(handles, dtype=np.int64)
        assert np.all(self.handles[1:] > self.handles[:-1]), \
            "handles must be strictly increasing"
        self.columns = columns

    @staticmethod
    def from_arrays(table, handles, named_columns: dict) -> "ColumnarTable":
        """named_columns: {column name: np.ndarray | Column}."""
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
        return ColumnarTable(table, handles, cols)

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
        return sum(j - i for i, j in self._range_slices(ranges))

    def scan_columns(self, desc, ranges: Sequence[KeyRange]) -> ColumnBatch:
        """Vectorized range scan of a TableScan → ColumnBatch in
        ``desc.columns`` order."""
        slices = self._range_slices(ranges)
        if desc.desc:
            slices = [(i, j) for i, j in reversed(slices)]

        def gather(values: np.ndarray, validity: np.ndarray):
            if len(slices) == 1 and not desc.desc:
                i, j = slices[0]
                return values[i:j], validity[i:j]
            vparts, mparts = [], []
            for i, j in slices:
                v, m = values[i:j], validity[i:j]
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
                ones = np.ones(len(self.handles), dtype=np.bool_)
                v, m = gather(self.handles, ones)
                out_cols.append(Column(EvalType.INT, v, m))
                continue
            col = self.columns.get(info.col_id)
            if col is None:
                # absent column → all default_value/NULL
                n = sum(j - i for i, j in slices)
                out_cols.append(Column.from_list(
                    info.field_type.eval_type, [info.default_value] * n))
                continue
            v, m = gather(col.values, col.validity)
            out_cols.append(Column(col.eval_type, v, m))
        return ColumnBatch([c.field_type for c in desc.columns], out_cols)
