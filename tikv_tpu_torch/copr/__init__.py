"""Coprocessor request surface: DAG descriptors, plan-IR requests
(``plan_ir``), ANALYZE and CHECKSUM requests (``analyze``), their wire
form, and the ``endpoint`` that serves them."""

from .analyze import AnalyzeReq, ChecksumReq, ColumnStats
from .dag import (
    AggExprDesc,
    AggregationDesc,
    ColumnInfo,
    DAGRequest,
    SelectionDesc,
    TableScanDesc,
)
from .wire import dec_dag, dec_plan, enc_dag, enc_plan

__all__ = ["AggExprDesc", "AggregationDesc", "AnalyzeReq", "ChecksumReq",
           "ColumnInfo", "ColumnStats", "DAGRequest", "SelectionDesc",
           "TableScanDesc", "dec_dag", "dec_plan", "enc_dag", "enc_plan"]
