"""The aggregation slice end to end: the port's DeviceRunner against the
JAX package's DeviceRunner and a numpy truth.

The same seeded ``ColumnarTable`` (exported as arrays) and the same
wire-encoded DAG go to the reference runner on one CPU device and, through
``tikv_tpu_torch.convert``, to the port's ``DeviceRunner(device="cpu")``.
Groups come out in ascending key order on both sides, so ``rows()`` must
be equal as lists — exactly: every state is an integer and AVG is the same
``float(sum) / count`` on both sides.
"""

import numpy as np
import pytest

import jax

import bench
from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.executors.runner import BatchExecutorsRunner
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch import convert
from tikv_tpu_torch.device import hash_agg as ha
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.testing import configs

N = 100_003


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def port():
    return DeviceRunner(device="cpu")


def port_snapshot(table, snap):
    """The reference snapshot carried into the port as plain arrays."""
    ptable = convert.table_from_wire(table.table_id, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in table.columns])
    arrays = {}
    for c in table.columns:
        col = snap.columns.get(c.col_id)
        if col is not None:
            arrays[c.name] = (col.eval_type.value, col.values, col.validity)
    return convert.snapshot_from_arrays(ptable, snap.handles, arrays)


def run_both(ref, port, dag, snap):
    want = ref.handle_request(dag, snap).rows()
    pdag = convert.dag_from_wire(wire.enc_dag(dag))
    got = port.handle_request(pdag, port_snapshot(dag_table(dag), snap))
    return want, got.rows()


_TABLES: dict = {}


def dag_table(dag):
    return _TABLES[dag.executors[0].table_id]


def table_kv(n, seed=7, key_dom=None, nullable_v=False, groups=1024):
    """(table, snapshot, k, v, v_valid) with k uniform over ``groups``
    (or over ``key_dom`` values) and v over [-1000, 1000)."""
    rng = np.random.default_rng(seed)
    tid = 5100 + seed
    table = Table(tid, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("v", 3, FieldType.long()),
    ))
    _TABLES[tid] = table
    k = rng.integers(0, groups, n).astype(np.int64)
    if key_dom is not None:
        k = key_dom[k % len(key_dom)]
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    v_valid = (np.arange(n) % 13 != 4) if nullable_v \
        else np.ones(n, np.bool_)
    v = np.where(v_valid, v, 0)
    ones = np.ones(n, np.bool_)
    snap = ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64),
        {"k": Column(EvalType.INT, k, ones),
         "v": Column(EvalType.INT, v, v_valid)})
    return table, snap, k, v, v_valid


def group_rows(k, v, mask, aggs):
    """numpy truth: rows (aggs..., key) in ascending key order."""
    keys = np.unique(k[mask])
    out = []
    for key in keys:
        sel = mask & (k == key)
        vals = v[sel]
        row = []
        for a in aggs:
            if a == "count_star" or a == "count":
                row.append(int(sel.sum()))
            elif a == "sum":
                row.append(int(vals.sum()))
            elif a == "avg":
                row.append(float(int(vals.sum())) / len(vals))
        out.append(tuple(row) + (int(key),))
    return out


def case_config3():
    table, snap, k, v, _ = table_kv(N, seed=3)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([], [("sum", s.col("v")), ("count_star", None),
                           ("avg", s.col("v"))]).build()
    total = int(v.sum())
    return dag, snap, [(total, N, float(total) / N)]


def case_config4():
    table, snap, k, v, _ = table_kv(N, seed=4)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [("count_star", None),
                                     ("sum", s.col("v"))]).build()
    return dag, snap, group_rows(k, v, np.ones(N, bool), ["count_star",
                                                          "sum"])


def case_config4s():
    dom = np.sort(np.random.default_rng(8).integers(0, 1 << 62, 1024))
    table, snap, k, v, _ = table_kv(N, seed=5, key_dom=dom)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [("count_star", None),
                                     ("sum", s.col("v"))]).build()
    return dag, snap, group_rows(k, v, np.ones(N, bool), ["count_star",
                                                          "sum"])


def case_const_beyond_int32():
    """``v < 2**40`` over an int32 column: true for every row (the port
    widens the int32 operand, as the reference's array namespace does)."""
    table, snap, k, v, _ = table_kv(N, seed=6)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.where(s.col("v") < 2**40,
                  (s.col("k") + 2**40) > 2**40 + 500) \
        .aggregate([s.col("k")], [("count_star", None),
                                  ("sum", s.col("v"))]).build()
    mask = k > 500
    return dag, snap, group_rows(k, v, mask, ["count_star", "sum"])


def case_wide_span_few_keys():
    """100 keys spread over a span of ~10^5: too wide for direct indexing
    into the kernel's slots, so the port dictionary-encodes them."""
    dom = np.arange(100, dtype=np.int64) * 1013 - 50_000
    table, snap, k, v, _ = table_kv(N, seed=16, key_dom=dom, groups=100)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [("count_star", None),
                                     ("sum", s.col("v"))]).build()
    return dag, snap, group_rows(k, v, np.ones(N, bool), ["count_star",
                                                          "sum"])


def case_expr_key_span_beyond_slots():
    """``k * 2`` over 1500 keys: a span of 2999 rounds to 4096 slots plus
    the NULL slot an expression key keeps, one more than the kernel holds."""
    table, snap, k, v, _ = table_kv(N, seed=17, groups=1500)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k") * 2], [("count_star", None),
                                         ("sum", s.col("v"))]).build()
    return dag, snap, group_rows(k * 2, v, np.ones(N, bool), ["count_star",
                                                              "sum"])


def case_expr_key_selection():
    table, snap, k, v, _ = table_kv(N, seed=9)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.where(s.col("v") > 0) \
        .aggregate([s.col("k") + 1], [("count", s.col("v")),
                                      ("avg", s.col("v")),
                                      ("count_star", None)]).build()
    rows = group_rows(k + 1, v, v > 0, ["count", "avg", "count_star"])
    return dag, snap, rows


def case_simple_selection_output_offsets():
    table, snap, k, v, _ = table_kv(N, seed=10)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.where(s.col("k") < 100).aggregate(
        [], [("count_star", None), ("sum", s.col("v") * 3)]) \
        .output_offsets([1, 0]).build()
    mask = k < 100
    return dag, snap, [(int(3 * v[mask].sum()), int(mask.sum()))]


def case_empty_simple():
    table, snap, k, v, _ = table_kv(0, seed=11)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([], [("sum", s.col("v")), ("count_star", None),
                           ("avg", s.col("v"))]).build()
    return dag, snap, [(None, 0, None)]


def case_empty_hash():
    table, snap, k, v, _ = table_kv(0, seed=12)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [("count_star", None),
                                     ("sum", s.col("v"))]).build()
    return dag, snap, []


CASES = {f.__name__[5:]: f for f in (
    case_config3, case_config4, case_config4s, case_const_beyond_int32,
    case_expr_key_selection, case_simple_selection_output_offsets,
    case_empty_simple, case_empty_hash, case_wide_span_few_keys,
    case_expr_key_span_beyond_slots)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_reference_and_truth(case, ref, port):
    dag, snap, truth = CASES[case]()
    want, got = run_both(ref, port, dag, snap)
    assert want == truth
    assert got == want


def test_port_launches_plain_version_on_cpu(port):
    """On the CPU the wrapper runs the plain version: no kernel launch."""
    dag, snap, truth = case_config4()
    before = ha.launches
    pdag = convert.dag_from_wire(wire.enc_dag(dag))
    assert port.handle_request(pdag, port_snapshot(dag_table(dag),
                                                   snap)).rows() == truth
    assert ha.launches == before


def test_warm_request_reuses_the_feed(port):
    dag, snap, truth = case_config4s()
    pdag = convert.dag_from_wire(wire.enc_dag(dag))
    psnap = port_snapshot(dag_table(dag), snap)
    assert port.handle_request(pdag, psnap).rows() == truth
    feeds = dict(port._snaps[psnap]["feeds"])
    meta = port._snaps[psnap]["meta"][(pdag.plan_key(), pdag.ranges)]
    assert "sparse_slots" in meta and len(feeds) == 1
    assert port.handle_request(pdag, psnap).rows() == truth
    (key, feed), = port._snaps[psnap]["feeds"].items()
    assert feed is feeds[key]


def test_sum_over_nulls_is_refused(ref, port):
    """NULLs in a kernel input are outside the kernel's gate
    (pallas_hash.py:193-195); the reference serves them on its XLA path,
    the port raises until that path is ported."""
    table, snap, k, v, v_valid = table_kv(N, seed=13, nullable_v=True)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [("sum", s.col("v"))]).build()
    want = ref.handle_request(dag, snap).rows()
    rows = []
    for key in np.unique(k):
        sel = (k == key) & v_valid
        rows.append((int(v[sel].sum()), int(key)))
    assert want == rows
    pdag = convert.dag_from_wire(wire.enc_dag(dag))
    assert port.supports(pdag)
    with pytest.raises(NotImplementedError, match="NULLs.*ROADMAP"):
        port.handle_request(pdag, port_snapshot(table, snap))


@pytest.mark.parametrize("kind", ["min", "max"])
def test_min_max_plans_are_refused(kind, ref, port):
    table, snap, k, v, _ = table_kv(1000, seed=14)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [(kind, s.col("v"))]).build()
    assert ref.supports(dag)
    pdag = convert.dag_from_wire(wire.enc_dag(dag))
    assert not port.supports(pdag)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.handle_request(pdag, port_snapshot(table, snap))


def test_too_many_slots_and_int64_sums_are_refused(port):
    """5000 distinct keys need more than 4096 slots even dictionary-encoded,
    and an argument that evaluates to int64 is outside the int32 kernel."""
    table, snap, k, v, _ = table_kv(20_000, seed=15, groups=5000)
    psnap = port_snapshot(table, snap)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = convert.dag_from_wire(wire.enc_dag(s.aggregate(
        [s.col("k")], [("count_star", None)]).build()))
    with pytest.raises(NotImplementedError, match="slots"):
        port.handle_request(dag, psnap)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = convert.dag_from_wire(wire.enc_dag(s.aggregate(
        [], [("sum", s.col("v") + 2**40)]).build()))
    with pytest.raises(NotImplementedError, match="int64"):
        port.handle_request(dag, psnap)


def test_reference_device_truncates_int64_group_sums(ref, port):
    """ROADMAP.md queue 3, fault 3: the reference's device GROUP BY sums an
    int64 argument as its int32 wraparound, while its host pipeline returns
    the true sums.  The port refuses the plan rather than truncate."""
    table, snap, k, v, _ = table_kv(1000, seed=18, groups=10)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [("sum", s.col("k") + 2**40)]).build()
    keys, counts = np.unique(k, return_counts=True)
    truth = [(int(c) * (int(key) + 2**40), int(key))
             for key, c in zip(keys, counts)]
    host = BatchExecutorsRunner(dag, snap).handle_request().rows()
    assert sorted(host, key=lambda r: r[-1]) == truth
    # (key + 2**40) wraps to key in int32
    assert ref.handle_request(dag, snap).rows() == [
        (int(c) * int(key), int(key)) for key, c in zip(keys, counts)]
    with pytest.raises(NotImplementedError, match="int64"):
        port.handle_request(convert.dag_from_wire(wire.enc_dag(dag)),
                            port_snapshot(table, snap))


def test_port_builders_draw_the_benchmark_arrays():
    """The port's config builders reproduce bench.py's tables exactly."""
    for port_build, ref_build in (
            (configs.build_table, bench.build_table),
            (configs.build_sparse_table, bench.build_sparse_table)):
        _pt, psnap = port_build(5000, 1024)
        _rt, rsnap = ref_build(5000, 1024)
        np.testing.assert_array_equal(psnap.handles, rsnap.handles)
        for cid in (2, 3):
            np.testing.assert_array_equal(psnap.columns[cid].values,
                                          rsnap.columns[cid].values)
    assert configs.dag_hash_agg(configs.bench_table()).plan_key() == \
        bench._dag_hash_agg(bench.build_table(10, 4)[0]).plan_key()
    assert configs.dag_simple_agg(configs.bench_table()).plan_key() == \
        bench._dag_simple_agg(bench.build_table(10, 4)[0]).plan_key()


def test_host_answer_agrees_for_slice_plans(ref):
    """The reference's host pipeline is a second witness for config 4."""
    dag, snap, truth = case_config4()
    host = BatchExecutorsRunner(dag, snap).handle_request().rows()
    assert sorted(host, key=lambda r: r[-1]) == truth
