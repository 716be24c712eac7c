"""Coprocessor request surface: DAG descriptors, plan-IR requests
(``plan_ir``), their wire form, and the ``endpoint`` that serves them."""

from .dag import (
    AggExprDesc,
    AggregationDesc,
    ColumnInfo,
    DAGRequest,
    SelectionDesc,
    TableScanDesc,
)
from .wire import dec_dag, dec_plan, enc_dag, enc_plan

__all__ = ["AggExprDesc", "AggregationDesc", "ColumnInfo", "DAGRequest",
           "SelectionDesc", "TableScanDesc", "dec_dag", "dec_plan", "enc_dag",
           "enc_plan"]
