"""The port's host pipeline (``tikv_tpu_torch/executors``) against the JAX
package's ``BatchExecutorsRunner`` on the same DAGs and the same rows.

Each DAG is built with the reference's ``DagSelect`` (or its descriptors),
wire-encoded and decoded by the port, and served over the same seeded
table, both as a columnar snapshot and as a KV feed of msgpack rows (the
row decode of ``executors/scan.py``; index scans read index keys).  The
shapes are the ones the port's device runner refuses: bare scans,
projections, limits, bit aggregates, FIRST with GROUP BY, multi-key GROUP
BY, multi-key and partition TopN, stream aggregation, REAL group keys,
the variances, output offsets.  Rows must be equal exactly (tolerance
0): both pipelines run the same numpy operations over the same batches.
"""

import numpy as np
import pytest

from tikv_tpu.copr.dag import DAGRequest, TopNDesc
from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.executors.runner import BatchExecutorsRunner as RefPipeline
from tikv_tpu.expr import Expr
from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn, init_with_data

from tikv_tpu_torch import convert
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.executors.runner import BatchExecutorsRunner
from tikv_tpu_torch.executors.storage import FixtureStorage

N = 700


def table() -> Table:
    return Table(9700, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("g", 3, FieldType.long()),
        TableColumn("v", 4, FieldType.long(), index_id=5),
        TableColumn("r", 5, FieldType.double()),
    ))


def data():
    rng = np.random.default_rng(97)
    cols = {"k": (rng.integers(0, 12, N), rng.random(N) > 0.1),
            "g": (rng.integers(0, 3, N), np.ones(N, np.bool_)),
            "v": (rng.integers(-500, 500, N), rng.random(N) > 0.15),
            "r": (rng.normal(0, 10, N).round(3), rng.random(N) > 0.15)}
    return np.arange(0, 3 * N, 3, dtype=np.int64), cols


@pytest.fixture(scope="module")
def feeds():
    """(reference columnar, port columnar, reference KV, port KV)."""
    t = table()
    handles, cols = data()
    ets = {"k": EvalType.INT, "g": EvalType.INT, "v": EvalType.INT,
           "r": EvalType.REAL}
    rsnap = ColumnarTable.from_arrays(t, handles, {
        name: Column(ets[name],
                     np.where(ok, v, 0).astype(ets[name].np_dtype), ok)
        for name, (v, ok) in cols.items()})
    ptable = convert.table_from_wire(t.table_id, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in t.columns])
    psnap = convert.snapshot_from_arrays(ptable, handles, {
        name: (ets[name].value, rsnap.columns[t[name].col_id].values,
               rsnap.columns[t[name].col_id].validity)
        for name in cols})
    rows = [(int(h), {name: (v[i].item() if ok[i] else None)
                      for name, (v, ok) in cols.items()})
            for i, h in enumerate(handles)]
    rkv = init_with_data(t, rows)
    pkv = FixtureStorage(zip(rkv._keys, rkv._vals))
    return {"columnar": (rsnap, psnap), "kv": (rkv, pkv)}


def q(cols=("id", "k", "g", "v", "r")):
    return DagSelect.from_table(table(), list(cols))


def _topn2(s, limit):
    dag = s.build()
    return DAGRequest(dag.executors + (TopNDesc(
        ((s.col("k"), True), (s.col("v"), False)), limit),), dag.ranges)


def _dags() -> dict:
    out = {}
    out["bare_scan"] = q().build()
    out["scan_columns"] = q(("v", "id")).build()
    s = q()
    out["projection"] = s.project(s.col("v") + Expr.const(1, EvalType.INT),
                                  s.col("r") * Expr.const(2.0, EvalType.REAL),
                                  s.col("k")).build()
    out["limit"] = q().limit(37).build()
    s = q()
    out["selection_limit"] = s.where(s.col("v") > Expr.const(
        0, EvalType.INT)).limit(25).build()
    s = q()
    out["bit_aggs"] = s.aggregate([], [("bit_and", s.col("v")),
                                       ("bit_or", s.col("v")),
                                       ("bit_xor", s.col("k")),
                                       ("bit_or", s.col("r"))]).build()
    s = q()
    out["bit_aggs_grouped"] = s.aggregate(
        [s.col("k")], [("bit_xor", s.col("v")), ("count", s.col("v"))]
    ).build()
    s = q()
    out["first_grouped"] = s.aggregate(
        [s.col("k")], [("first", s.col("v")), ("first", s.col("r"))]
    ).build()
    s = q()
    out["multi_key_group"] = s.aggregate(
        [s.col("k"), s.col("g")], [("count_star", None),
                                   ("sum", s.col("v")),
                                   ("max", s.col("r"))]).build()
    s = q()
    out["real_key_group"] = s.aggregate(
        [s.col("r")], [("count_star", None), ("min", s.col("v"))]).build()
    s = q()
    out["variances"] = s.aggregate(
        [s.col("g")], [("var_pop", s.col("v")), ("stddev_samp", s.col("r")),
                       ("avg", s.col("r"))]).build()
    s = q()
    out["multi_key_topn"] = _topn2(s, 50)
    s = q()
    out["real_topn"] = s.order_by(s.col("r"), desc=False, limit=40).build()
    s = q()
    out["partition_topn"] = s.partition_top_n(
        (s.col("g"),), ((s.col("v"), True), (s.col("id"), False)), 3).build()
    s = q()
    out["stream_agg"] = s.aggregate(
        [s.col("id")], [("count_star", None), ("sum", s.col("v"))],
        streamed=True).build()
    s = q()
    out["empty_simple_agg"] = s.where(s.col("v") > Expr.const(
        10 ** 6, EvalType.INT)).aggregate(
            [], [("count_star", None), ("sum", s.col("v")),
                 ("max", s.col("r"))]).build()
    s = q()
    out["projection_agg"] = s.project(
        s.col("k"), s.col("v") * Expr.const(3, EvalType.INT)).aggregate(
            [Expr.column(0, EvalType.INT)],
            [("sum", Expr.column(1, EvalType.INT))]).build()
    s = q()
    out["output_offsets"] = s.where(s.col("k") < Expr.const(
        4, EvalType.INT)).output_offsets((3, 0)).build()
    s = DagSelect.from_index(table(), "v")
    out["index_scan"] = s.build()
    s = DagSelect.from_index(table(), "v")
    out["index_scan_limit"] = s.limit(20).build()
    return out


DAGS = _dags()


@pytest.mark.parametrize("feed", ["columnar", "kv"])
@pytest.mark.parametrize("name", sorted(DAGS))
def test_host_pipeline_matches_reference(feeds, name, feed):
    rstore, pstore = feeds[feed]
    dag = DAGS[name]
    want = RefPipeline(dag, rstore).handle_request()
    got = BatchExecutorsRunner(convert.dag_from_wire(wire.enc_dag(dag)),
                               pstore).handle_request()
    assert got.rows() == want.rows()
    assert [f.tp for f in got.batch.schema] == \
        [f.tp for f in want.batch.schema]
    assert [s.num_produced_rows for s in got.exec_summaries] == \
        [s.num_produced_rows for s in want.exec_summaries]


@pytest.mark.parametrize("name", ["bare_scan", "projection", "limit",
                                  "bit_aggs", "first_grouped",
                                  "multi_key_group", "multi_key_topn"])
def test_device_runner_refuses_these_plans(name):
    """The shapes the host pipeline is there for: the device runner says
    it does not support them (the endpoint sends them to the host)."""
    dag = convert.dag_from_wire(wire.enc_dag(DAGS[name]))
    assert not DeviceRunner(device="cpu").supports(dag)
