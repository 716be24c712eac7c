"""Selection / Projection / Limit executors of the host pipeline.

Reference: tidb_query_executors/src/selection_executor.rs,
projection_executor.rs, limit_executor.rs.
"""

from __future__ import annotations

import numpy as np

from ..datatype import Column, ColumnBatch, EvalType, FieldType
from ..expr import build_rpn, eval_rpn
from .interface import BatchExecuteResult, TimedExecutor


class BatchSelectionExecutor(TimedExecutor):
    def __init__(self, child, desc):
        super().__init__()
        self._child = child
        self._rpns = [build_rpn(c) for c in desc.conditions]

    @property
    def schema(self) -> list[FieldType]:
        return self._child.schema

    def _next_batch(self, scan_rows: int) -> BatchExecuteResult:
        r = self._child.next_batch(scan_rows)
        batch = r.batch
        n = batch.num_rows
        if n:
            cols = [(c.values, c.validity) for c in batch.columns]
            mask = np.ones(n, dtype=np.bool_)
            for rpn in self._rpns:
                v, ok = eval_rpn(rpn, cols, n, np)
                # WHERE keeps the rows whose predicate is TRUE (not NULL)
                mask &= ok & (v != 0)
            batch = batch.filter(mask)
        return BatchExecuteResult(batch, r.is_drained, r.warnings)


class BatchProjectionExecutor(TimedExecutor):
    def __init__(self, child, desc):
        super().__init__()
        self._child = child
        self._rpns = [build_rpn(e) for e in desc.exprs]
        self._schema = [_ft_of(rpn) for rpn in self._rpns]

    @property
    def schema(self) -> list[FieldType]:
        return self._schema

    def _next_batch(self, scan_rows: int) -> BatchExecuteResult:
        r = self._child.next_batch(scan_rows)
        batch = r.batch
        n = batch.num_rows
        cols = [(c.values, c.validity) for c in batch.columns]
        out = []
        for rpn, ft in zip(self._rpns, self._schema):
            v, ok = eval_rpn(rpn, cols, n, np)
            v = np.broadcast_to(v, (n,)).astype(ft.eval_type.np_dtype,
                                                 copy=False)
            ok = np.broadcast_to(ok, (n,)).astype(np.bool_, copy=False)
            out.append(Column(ft.eval_type, np.ascontiguousarray(v),
                              np.ascontiguousarray(ok)))
        return BatchExecuteResult(ColumnBatch(self._schema, out),
                                  r.is_drained, r.warnings)


class BatchLimitExecutor(TimedExecutor):
    def __init__(self, child, desc):
        super().__init__()
        self._child = child
        self._remaining = desc.limit

    @property
    def schema(self) -> list[FieldType]:
        return self._child.schema

    def _next_batch(self, scan_rows: int) -> BatchExecuteResult:
        if self._remaining <= 0:
            return BatchExecuteResult(ColumnBatch.empty(self.schema), True)
        r = self._child.next_batch(scan_rows)
        batch = r.batch
        if batch.num_rows >= self._remaining:
            batch = batch.slice(0, self._remaining)
            self._remaining = 0
            return BatchExecuteResult(batch, True, r.warnings)
        self._remaining -= batch.num_rows
        return BatchExecuteResult(batch, r.is_drained, r.warnings)


def _ft_of(rpn) -> FieldType:
    et = rpn.ret_type
    if et is EvalType.REAL:
        return FieldType.double()
    if et is EvalType.BYTES:
        return FieldType.var_char()
    if et is EvalType.DECIMAL:
        return FieldType.new_decimal()
    if et is EvalType.JSON:
        return FieldType.json()
    return FieldType.long()
