"""Table fixtures: schemas, and ``init_with_data``, which writes encoded
rows (and their index entries) into a ``FixtureStorage`` KV feed.

Reference: components/test_coprocessor/src/{table.rs, column.rs,
fixture.rs}.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..codec.keys import index_key_prefix, table_record_key
from ..codec.mc_datum import encode_mc_datum
from ..codec.row import encode_row
from ..copr.dag import ColumnInfo
from ..datatype import FieldType
from ..executors.storage import FixtureStorage


@dataclass(frozen=True)
class TableColumn:
    name: str
    col_id: int
    field_type: FieldType
    is_pk_handle: bool = False
    index_id: Optional[int] = None  # secondary index over this column


@dataclass(frozen=True)
class Table:
    table_id: int
    columns: tuple

    def __getitem__(self, name: str) -> TableColumn:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def column_info(self, name: str) -> ColumnInfo:
        c = self[name]
        return ColumnInfo(c.col_id, c.field_type, c.is_pk_handle)


def encode_table_row(table: Table, handle: int, row: dict) -> tuple:
    """``row``: {column name: value} → (key, value) of the record."""
    payload = {c.col_id: row[c.name] for c in table.columns
               if not c.is_pk_handle and c.name in row}
    return table_record_key(table.table_id, handle), encode_row(payload)


def index_entries(table: Table, handle: int, row: dict):
    """The (key, value) entries of one row's non-unique indexes."""
    for c in table.columns:
        if c.index_id is None or c.is_pk_handle:
            continue
        key = (index_key_prefix(table.table_id, c.index_id)
               + encode_mc_datum(row.get(c.name)) + encode_mc_datum(handle))
        yield key, b""


def init_with_data(table: Table, rows: Sequence[tuple],
                   with_indexes: bool = True) -> FixtureStorage:
    """``rows``: [(handle, {column name: value})] → a ``FixtureStorage`` of
    the committed values (fixture.rs init_with_data, without MVCC)."""
    pairs = []
    for handle, row in rows:
        pairs.append(encode_table_row(table, handle, row))
        if with_indexes:
            pairs.extend(index_entries(table, handle, row))
    return FixtureStorage(pairs)
