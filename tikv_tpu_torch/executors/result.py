"""Response containers and aggregate output field types.

Reference: tidb_query_executors (SelectResult is the decoded response;
aggregate result columns come first, then group-by columns —
util/aggr_executor.rs schema layout).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..datatype import ColumnBatch, EvalType, FieldType


@dataclass
class SelectResult:
    """Decoded response: the final columns."""

    batch: ColumnBatch

    def rows(self):
        return self.batch.rows()


def _agg_ret_ft(kind: str, arg_et: Optional[EvalType]) -> FieldType:
    """Output field type of COUNT/SUM/AVG (the slice's aggregates)."""
    if kind in ("count", "count_star"):
        return FieldType.long(not_null=True)
    if kind == "avg" or arg_et is EvalType.REAL:
        return FieldType.double()
    return FieldType.long()
