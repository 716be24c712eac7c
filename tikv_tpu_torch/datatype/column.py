"""Host-side columnar containers.

Reference: components/tidb_query_datatype/src/codec/data_type/vector.rs:14
(``VectorValue`` — a value vec + null bitmap per eval type).  A column is
a dense numpy value array plus a boolean validity mask — the layout the
device feed is built from.  The port's device path serves INT and REAL
columns; other eval types only pass through scans as NULL placeholders.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np

from .eval_type import EvalType, FieldType


class Column:
    """A dense column: value array + validity mask.

    Entries where ``validity`` is False are NULL; their value slot holds
    a harmless 0 so device kernels never see garbage.
    """

    __slots__ = ("eval_type", "values", "validity")

    def __init__(self, eval_type: EvalType, values: np.ndarray,
                 validity: np.ndarray):
        assert values.shape == validity.shape, (values.shape, validity.shape)
        self.eval_type = eval_type
        self.values = values
        self.validity = validity

    @staticmethod
    def empty(eval_type: EvalType) -> "Column":
        return Column(eval_type, np.empty(0, dtype=eval_type.np_dtype),
                      np.empty(0, dtype=np.bool_))

    @staticmethod
    def from_list(eval_type: EvalType, items: Sequence,
                  unsigned: bool = False) -> "Column":
        """Build from a Python list where ``None`` means NULL.

        ``unsigned``: the column is declared UNSIGNED — the container is
        uint64 regardless of which values appear.
        """
        n = len(items)
        validity = np.fromiter((x is not None for x in items),
                               dtype=np.bool_, count=n)
        dtype = eval_type.np_dtype
        if dtype == np.dtype(object):
            fill = b"" if eval_type is EvalType.BYTES else None
            values = np.empty(n, dtype=object)
            for i, x in enumerate(items):
                values[i] = x if x is not None else fill
            return Column(eval_type, values, validity)
        if dtype == np.int64 and (unsigned or any(
                x is not None and x >= 1 << 63 for x in items)):
            dtype = np.dtype(np.uint64)
        values = np.zeros(n, dtype=dtype)
        for i, x in enumerate(items):
            if x is not None:
                values[i] = x
        return Column(eval_type, values, validity)

    @staticmethod
    def from_values(eval_type: EvalType, values: np.ndarray,
                    validity: Optional[np.ndarray] = None) -> "Column":
        if validity is None:
            validity = np.ones(values.shape, dtype=np.bool_)
        return Column(eval_type, values, validity)

    def __len__(self) -> int:
        return len(self.values)

    def get(self, i: int):
        """Scalar accessor: value or None."""
        if not self.validity[i]:
            return None
        v = self.values[i]
        if isinstance(v, np.generic):
            return v.item()
        return v

    def take(self, indices: np.ndarray) -> "Column":
        return Column(self.eval_type, self.values[indices],
                      self.validity[indices])

    def filter(self, mask: np.ndarray) -> "Column":
        return Column(self.eval_type, self.values[mask], self.validity[mask])

    def slice(self, start: int, stop: int) -> "Column":
        return Column(self.eval_type, self.values[start:stop],
                      self.validity[start:stop])

    @staticmethod
    def concat(cols: Sequence["Column"]) -> "Column":
        return Column(cols[0].eval_type,
                      np.concatenate([c.values for c in cols]),
                      np.concatenate([c.validity for c in cols]))

    def __repr__(self) -> str:
        return f"Column<{self.eval_type.value}>[{len(self)}]"


@dataclass
class ColumnBatch:
    """A batch of rows in columnar form (``schema`` FieldType per column).

    Reference: codec/batch/lazy_column_vec.rs:15 (``LazyBatchColumnVec``).
    """

    schema: list[FieldType]
    columns: list[Column]

    def __post_init__(self):
        assert len(self.schema) == len(self.columns)
        if self.columns:
            n = len(self.columns[0])
            assert all(len(c) == n for c in self.columns), \
                [len(c) for c in self.columns]

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @staticmethod
    def empty(schema: Iterable[FieldType]) -> "ColumnBatch":
        schema = list(schema)
        return ColumnBatch(schema, [Column.empty(ft.eval_type)
                                    for ft in schema])

    def filter(self, mask: np.ndarray) -> "ColumnBatch":
        return ColumnBatch(self.schema, [c.filter(mask) for c in self.columns])

    def take(self, indices: np.ndarray) -> "ColumnBatch":
        return ColumnBatch(self.schema, [c.take(indices) for c in self.columns])

    def slice(self, start: int, stop: int) -> "ColumnBatch":
        return ColumnBatch(self.schema, [c.slice(start, stop)
                                         for c in self.columns])

    @staticmethod
    def concat(batches: Sequence["ColumnBatch"]) -> "ColumnBatch":
        return ColumnBatch(batches[0].schema, [
            Column.concat([b.columns[i] for b in batches])
            for i in range(len(batches[0].columns))])

    def rows(self) -> list[tuple]:
        """Materialize as Python rows (tests / response encoding)."""
        return [tuple(c.get(i) for c in self.columns)
                for i in range(self.num_rows)]
