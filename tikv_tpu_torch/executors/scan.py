"""Table / index scan executors over a KV feed.

Reference: tidb_query_executors/src/table_scan_executor.rs and
index_scan_executor.rs: pull raw KV pairs from the storage feed, decode
the row payloads into columns, take the PK handle from the key.  Decode
is eager and batched: one pass per batch into dense columns.
"""

from __future__ import annotations

from typing import Sequence

from ..codec import decode_record_handle
from ..codec.mc_datum import decode_mc_datum
from ..codec.number import decode_i64
from ..codec.row import decode_row
from ..datatype import Column, ColumnBatch, FieldType
from .interface import BatchExecuteResult, TimedExecutor
from .ranges import KeyRange
from .storage import ScanStorage


class BatchTableScanExecutor(TimedExecutor):
    """Reference: table_scan_executor.rs (BatchTableScanExecutor)."""

    def __init__(self, storage: ScanStorage, desc,
                 ranges: Sequence[KeyRange]):
        super().__init__()
        self._storage = storage
        self._desc = desc
        self._storage.begin_scan(ranges, desc.desc)
        self._drained = False
        self._schema = desc.schema

    @property
    def schema(self) -> list[FieldType]:
        return self._schema

    def _next_batch(self, scan_rows: int) -> BatchExecuteResult:
        pairs = self._storage.scan_batch(scan_rows)
        if len(pairs) < scan_rows:
            self._drained = True
        cols_info = self._desc.columns
        n = len(pairs)
        out: list[list] = [[None] * n for _ in cols_info]   # None = NULL
        for r, (key, value) in enumerate(pairs):
            row = decode_row(value) if value else {}
            for c, info in enumerate(cols_info):
                if info.is_pk_handle:
                    out[c][r] = decode_record_handle(key)
                else:
                    out[c][r] = row.get(info.col_id, info.default_value)
        columns = [Column.from_list(info.field_type.eval_type, vals,
                                    unsigned=info.field_type.is_unsigned)
                   for info, vals in zip(cols_info, out)]
        return BatchExecuteResult(ColumnBatch(list(self._schema), columns),
                                  is_drained=self._drained)


class BatchIndexScanExecutor(TimedExecutor):
    """Reference: index_scan_executor.rs.  Index key: ``t{tid}_i{iid}`` +
    the mc-datums of the indexed columns + the mc-int handle (non-unique);
    a unique index keeps the handle in the value (8-byte big-endian)."""

    def __init__(self, storage: ScanStorage, desc,
                 ranges: Sequence[KeyRange]):
        super().__init__()
        self._storage = storage
        self._desc = desc
        self._storage.begin_scan(ranges, desc.desc)
        self._drained = False
        self._schema = desc.schema
        self._prefix_len = 1 + 8 + 2 + 8  # t + tid + _i + iid

    @property
    def schema(self) -> list[FieldType]:
        return self._schema

    def _next_batch(self, scan_rows: int) -> BatchExecuteResult:
        pairs = self._storage.scan_batch(scan_rows)
        if len(pairs) < scan_rows:
            self._drained = True
        cols_info = self._desc.columns
        want_handle = bool(cols_info) and cols_info[-1].is_pk_handle
        n_idx_cols = len(cols_info) - (1 if want_handle else 0)
        n = len(pairs)
        out: list[list] = [[None] * n for _ in cols_info]
        for r, (key, value) in enumerate(pairs):
            off = self._prefix_len
            for c in range(n_idx_cols):
                out[c][r], off = decode_mc_datum(key, off)
            if want_handle:
                if self._desc.unique:
                    out[-1][r] = decode_i64(value, 0)
                else:
                    out[-1][r], _ = decode_mc_datum(key, off)
        columns = [Column.from_list(info.field_type.eval_type, vals,
                                    unsigned=info.field_type.is_unsigned)
                   for info, vals in zip(cols_info, out)]
        return BatchExecuteResult(ColumnBatch(list(self._schema), columns),
                                  is_drained=self._drained)
