"""Coprocessor request surface: DAG descriptors and their wire form."""

from .dag import (
    AggExprDesc,
    AggregationDesc,
    ColumnInfo,
    DAGRequest,
    SelectionDesc,
    TableScanDesc,
)
from .wire import dec_dag, enc_dag

__all__ = ["AggExprDesc", "AggregationDesc", "ColumnInfo", "DAGRequest",
           "SelectionDesc", "TableScanDesc", "dec_dag", "enc_dag"]
