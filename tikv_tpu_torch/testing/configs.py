"""The benchmark configurations of the aggregation slice, as plain builders.

BASELINE configs 3, 4 and 4s: one table ``(id pk, k INT, v INT)`` with
``k`` uniform over ``groups`` values and ``v`` uniform over [-1000, 1000),
made from a numpy seed (the JAX package's ``bench.build_table`` /
``build_sparse_table`` draw the same arrays from the same seed):

- config 3: SUM(v), COUNT(*), AVG(v) over 50·2^20 rows;
- config 4: GROUP BY k with COUNT(*) and SUM(v) over 100·2^20 rows,
  1024 groups;
- config 4s: config 4 with the 1024 keys drawn from [0, 2^62).
"""

from __future__ import annotations

import numpy as np

from ..datatype import Column, EvalType, FieldType
from ..executors.columnar import ColumnarTable
from .dag import DagSelect
from .fixture import Table, TableColumn

CONFIG_ROWS = {"3": 50 << 20, "4": 100 << 20, "4s": 100 << 20}
GROUPS = 1024


def bench_table() -> Table:
    return Table(99, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("v", 3, FieldType.long(), index_id=2),
    ))


def build_table(n: int, groups: int = GROUPS, seed: int = 7):
    """→ (table, snapshot) with dense keys in [0, groups)."""
    rng = np.random.default_rng(seed)
    table = bench_table()
    k = rng.integers(0, groups, n).astype(np.int64)
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    ones = np.ones(n, dtype=np.bool_)
    snap = ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64),
        {"k": Column(EvalType.INT, k, ones),
         "v": Column(EvalType.INT, v, ones)})
    return table, snap


def build_sparse_table(n: int, groups: int = GROUPS, seed: int = 7):
    """Config-4 shape, but the ``groups`` distinct keys are drawn from
    [0, 2^62) — the arbitrary-int64 GROUP BY domain."""
    table, snap = build_table(n, groups, seed=seed)
    rng = np.random.default_rng(seed + 1)
    doms = np.sort(rng.integers(0, 1 << 62, groups))
    k = snap.columns[2]
    snap.columns[2] = Column(k.eval_type, doms[k.values % groups], k.validity)
    return table, snap


def dag_simple_agg(table: Table):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    return s.aggregate([], [("sum", s.col("v")), ("count_star", None),
                            ("avg", s.col("v"))]).build()


def dag_hash_agg(table: Table):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    return s.aggregate([s.col("k")],
                       [("count_star", None), ("sum", s.col("v"))]).build()
