"""Table fixtures (schema only).

Reference: components/test_coprocessor/src/{table.rs, column.rs}.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..copr.dag import ColumnInfo
from ..datatype import FieldType


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
