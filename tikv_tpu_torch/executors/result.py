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
    """Output field type of a device aggregate over an INT or REAL
    argument: COUNT is a NOT NULL BIGINT; AVG and the variance kinds are
    DOUBLE; SUM, MIN, MAX and FIRST keep the argument's type."""
    if kind in ("count", "count_star"):
        return FieldType.long(not_null=True)
    if kind in ("avg", "var_pop", "var_samp", "stddev_pop", "stddev_samp") \
            or arg_et is EvalType.REAL:
        return FieldType.double()
    return FieldType.long()
