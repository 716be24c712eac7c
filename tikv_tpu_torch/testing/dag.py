"""DAG request builder for tests and the chip smoke.

Reference: components/test_coprocessor/src/dag.rs:18 — ``DagSelect``.
Builders mutate: use a fresh ``DagSelect.from_table`` per plan.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..codec.keys import index_key_prefix, table_record_range
from ..copr.dag import (AggExprDesc, AggregationDesc, DAGRequest,
                        IndexScanDesc, LimitDesc, SelectionDesc,
                        TableScanDesc, TopNDesc)
from ..executors.ranges import KeyRange
from ..expr import Expr
from .fixture import Table, TableColumn


class DagSelect:
    """Fluent DAGRequest builder over a fixture Table."""

    def __init__(self, table: Table):
        self._table = table
        self._scan = None
        self._execs: list = []
        self._ranges: Optional[list[KeyRange]] = None
        self._scan_cols: list[TableColumn] = []

    @staticmethod
    def from_table(table: Table,
                   columns: Optional[Sequence[str]] = None) -> "DagSelect":
        s = DagSelect(table)
        cols = [table[c] for c in columns] if columns else list(table.columns)
        s._scan_cols = cols
        infos = tuple(table.column_info(c.name) for c in cols)
        s._scan = TableScanDesc(table.table_id, infos)
        start, end = table_record_range(table.table_id)
        s._ranges = [KeyRange(start, end)]
        return s

    @staticmethod
    def from_index(table: Table, column: str,
                   with_handle: bool = True) -> "DagSelect":
        """A covering scan of ``column``'s index (and the handle) over the
        whole index."""
        s = DagSelect(table)
        col = table[column]
        assert col.index_id is not None, f"{column} has no index"
        cols = [col]
        if with_handle:
            cols.append(next(c for c in table.columns if c.is_pk_handle))
        s._scan_cols = cols
        s._scan = IndexScanDesc(table.table_id, col.index_id, tuple(
            table.column_info(c.name) for c in cols))
        prefix = index_key_prefix(table.table_id, col.index_id)
        s._ranges = [KeyRange(prefix, prefix + b"\xff" * 10)]
        return s

    def col(self, name: str) -> Expr:
        """Column reference by name → offset in the scan output."""
        for i, c in enumerate(self._scan_cols):
            if c.name == name:
                ft = c.field_type
                return Expr.column(i, ft.eval_type, collation=ft.collation,
                                   elems=ft.elems)
        raise KeyError(name)

    def where(self, *conditions: Expr) -> "DagSelect":
        self._execs.append(SelectionDesc(tuple(conditions)))
        return self

    def aggregate(self, group_by: Sequence[Expr],
                  aggs: Sequence[tuple], streamed: bool = False) -> "DagSelect":
        """aggs: [(kind, arg_expr_or_None)]"""
        specs = tuple(AggExprDesc(kind, arg) for kind, arg in aggs)
        self._execs.append(AggregationDesc(tuple(group_by), specs, streamed))
        return self

    def order_by(self, expr: Expr, desc: bool = False,
                 limit: int = 10) -> "DagSelect":
        self._execs.append(TopNDesc(((expr, desc),), limit))
        return self

    def limit(self, n: int) -> "DagSelect":
        self._execs.append(LimitDesc(n))
        return self

    def build(self, start_ts: int = 0) -> DAGRequest:
        assert self._scan is not None
        return DAGRequest(executors=(self._scan,) + tuple(self._execs),
                          ranges=tuple(self._ranges), start_ts=start_ts)
