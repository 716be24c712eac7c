"""The aggregation slice end to end: the port's DeviceRunner against the
JAX package's DeviceRunner and a numpy truth.

The same seeded ``ColumnarTable`` (exported as arrays) and the same
wire-encoded DAG go to the reference runner on one CPU device and, through
``tikv_tpu_torch.convert``, to the port's ``DeviceRunner(device="cpu")``.
Groups come out in ascending key order on both sides, so ``rows()`` must
be equal as lists — exactly where every state is an integer (AVG and the
variance kinds are then the same float64 formula of the same states on
both sides).  REAL sums are compared within a stated tolerance: the
reference sums each tile in float32, the port in float64.
"""

import functools
import inspect

import numpy as np
import pytest

import jax
import torch

import bench
from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.executors.runner import BatchExecutorsRunner
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu.expr import Expr

from tikv_tpu_torch import convert
from tikv_tpu_torch.copr import wire as port_wire
from tikv_tpu_torch.device import hash_agg as ha
from tikv_tpu_torch.device import twolevel as tl
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
    """NULLs in a kernel input are outside the fused kernel's gate
    (pallas_hash.py:193-195).  The reference serves them on its two-level
    route, and so does the port now: the answers agree with the truth."""
    table, snap, k, v, v_valid = table_kv(N, seed=13, nullable_v=True)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [("sum", s.col("v"))]).build()
    rows = []
    for key in np.unique(k):
        sel = (k == key) & v_valid
        rows.append((int(v[sel].sum()), int(key)))
    pdag = convert.dag_from_wire(wire.enc_dag(dag))
    assert port.supports(pdag)
    before = tl.launches
    want, got = run_both(ref, port, dag, snap)
    assert want == rows
    assert got == want
    assert tl.launches == before        # the plain version, on the CPU


@pytest.mark.parametrize("kind", ["min", "max"])
def test_min_max_plans_are_refused(kind, ref, port):
    """MIN and MAX, once refused, are served on the scatter route and
    agree with the reference's scatter body and the truth exactly."""
    table, snap, k, v, _ = table_kv(1000, seed=14)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [(kind, s.col("v"))]).build()
    assert ref.supports(dag)
    assert port.supports(convert.dag_from_wire(wire.enc_dag(dag)))
    pick = np.min if kind == "min" else np.max
    truth = [(int(pick(v[k == key])), int(key)) for key in np.unique(k)]
    want, got = run_both(ref, port, dag, snap)
    assert want == truth
    assert got == want


def test_too_many_slots_and_int64_sums_are_refused(ref, port):
    """5000 distinct keys need more than the fused kernel's 4096 slots,
    and ``v + 2**40`` evaluates to int64: both, once refused, are served
    (the two-level route, 8-byte planes) and agree with the truth."""
    table, snap, k, v, _ = table_kv(20_000, seed=15, groups=5000)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [("count_star", None)]).build()
    keys, counts = np.unique(k, return_counts=True)
    want, got = run_both(ref, port, dag, snap)
    assert want == [(int(c), int(key)) for key, c in zip(keys, counts)]
    assert got == want
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([], [("sum", s.col("v") + 2**40)]).build()
    want, got = run_both(ref, port, dag, snap)
    assert want == [(int(v.sum()) + len(v) * 2**40,)]
    assert got == want


def test_reference_device_truncates_int64_group_sums(ref, port):
    """ROADMAP.md queue 3, fault 3: the reference's device GROUP BY sums an
    int64 argument as its int32 wraparound, while its host pipeline returns
    the true sums.  The port sizes the byte planes from the evaluated
    dtype and returns the host pipeline's true sums."""
    table, snap, k, v, _ = table_kv(1000, seed=18, groups=10)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [("sum", s.col("k") + 2**40)]).build()
    keys, counts = np.unique(k, return_counts=True)
    truth = [(int(c) * (int(key) + 2**40), int(key))
             for key, c in zip(keys, counts)]
    host = BatchExecutorsRunner(dag, snap).handle_request().rows()
    assert sorted(host, key=lambda r: r[-1]) == truth
    # (key + 2**40) wraps to key in int32
    want, got = run_both(ref, port, dag, snap)
    assert want == [(int(c) * int(key), int(key))
                    for key, c in zip(keys, counts)]
    assert got == truth


def test_reference_device_cannot_split_eight_byte_values(ref, port):
    """ROADMAP.md queue 3, fault 4: an int64 column whose values pass
    ±2^31 needs 8 byte planes; the reference's ``make_planes`` adds
    ``1 << 63`` in int64 and raises OverflowError.  The port flips the
    sign bit instead and returns the exact sums."""
    table, snap, k, v, _ = table_kv(3000, seed=19, groups=10)
    big = np.random.default_rng(19).integers(-(1 << 50), 1 << 50, 3000)
    snap.columns[3] = Column(EvalType.INT, big, np.ones(3000, np.bool_))
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [("sum", s.col("v")),
                                     ("avg", s.col("v"))]).build()
    sums = [(int(big[k == key].sum()), int(key)) for key in np.unique(k)]
    host = BatchExecutorsRunner(dag, snap).handle_request().rows()
    assert sorted(((r[0], r[2]) for r in host), key=lambda r: r[1]) == sums
    truth = [(s, float(s) / int((k == key).sum()), key) for s, key in sums]
    with pytest.raises(OverflowError):
        ref.handle_request(dag, snap)
    got = port.handle_request(convert.dag_from_wire(wire.enc_dag(dag)),
                              port_snapshot(table, snap)).rows()
    assert got == truth


@pytest.mark.parametrize("plan", ["bit_and", "first_group_by",
                                  "two_keys"])
def test_host_pipeline_plans_are_refused(plan, ref, port):
    """What the reference sends to its host pipeline, the port refuses
    with the ROADMAP item that will serve it."""
    table, snap, k, v, _ = table_kv(1000, seed=22)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    if plan == "bit_and":
        dag = s.aggregate([s.col("k")], [("bit_and", s.col("v"))]).build()
    elif plan == "first_group_by":
        dag = s.aggregate([s.col("k")], [("first", s.col("v"))]).build()
    else:
        dag = s.aggregate([s.col("k"), s.col("v")],
                          [("count_star", None)]).build()
    assert not ref.supports(dag)
    pdag = convert.dag_from_wire(wire.enc_dag(dag))
    assert not port.supports(pdag)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 3"):
        port.handle_request(pdag, port_snapshot(table, snap))


def test_more_distinct_keys_than_the_device_holds_are_refused(port):
    """A key span beyond 2^20 with more than 2^20 distinct keys: the
    reference falls back to its host pipeline, the port refuses."""
    n = (1 << 20) + 7
    table, snap, k, v, _ = table_kv(n, seed=23)
    snap.columns[2] = Column(EvalType.INT, np.arange(n, dtype=np.int64) * 3,
                             np.ones(n, np.bool_))
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = convert.dag_from_wire(wire.enc_dag(s.aggregate(
        [s.col("k")], [("count_star", None)]).build()))
    with pytest.raises(NotImplementedError, match="distinct GROUP BY keys"):
        port.handle_request(dag, port_snapshot(table, snap))


# ---------------------------------------------------------------------------
# the configurations of the slices, at small size
# ---------------------------------------------------------------------------

CONFIG_ROWS = 40_000


def ref_config(name, n=CONFIG_ROWS):
    """The reference's (table, snapshot, DAG) of a port configuration:
    ``bench.py``'s arrays, with the port builders' NULL mask for 4n/3n,
    and the port's plan decoded by the reference's wire codec."""
    groups = configs.WIDE_GROUPS if name == "4w" else configs.GROUPS
    if name == "4s":
        table, snap = bench.build_sparse_table(n, groups)
    else:
        table, snap = bench.build_table(n, groups, real_v=name == "4r")
    if name in ("4n", "3n"):
        valid = np.random.default_rng(7 + 2).random(n) >= configs.NULL_SHARE
        v = snap.columns[3]
        snap.columns[3] = Column(v.eval_type, np.where(valid, v.values, 0),
                                 valid)
    pdag = configs.CONFIGS[name][1](configs.bench_table(name == "4r"))
    dag = wire.dec_dag(port_wire.enc_dag(pdag))
    return table, snap, dag


@pytest.mark.parametrize("name", sorted(configs.CONFIGS))
def test_config_matches_reference_and_truth(name, ref, port):
    """Each configuration at small size: the port equals the numpy truth
    (exactly for integer and MIN/MAX results, within 1e-9 of each cell's
    error scale for REAL sums and variances) and the reference runner
    (within 1e-6: the reference sums REAL tiles in float32)."""
    table, snap, dag = ref_config(name)
    psnap = port_snapshot(table, snap)
    want = ref.handle_request(dag, snap).rows()
    got = port.handle_request(convert.dag_from_wire(wire.enc_dag(dag)),
                              psnap).rows()
    truth, scales = configs.truth(name, psnap)
    assert configs.rows_agree(got, truth, scales, 1e-9)
    assert configs.rows_agree(want, truth, scales, 1e-6)
    assert configs.rows_agree(got, want, scales, 1e-6)


def real_table(n, seed):
    """(table, snapshot, k, r, r_valid): REAL ``r`` with NULLs, INT ``k``
    with NULLs (a NULL group)."""
    rng = np.random.default_rng(seed)
    tid = 5300 + seed
    table = Table(tid, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("r", 3, FieldType.double()),
    ))
    _TABLES[tid] = table
    k = rng.integers(-20, 20, n).astype(np.int64)
    k_valid = rng.random(n) > 0.05
    r = rng.normal(0.0, 100.0, n).astype(np.float32).astype(np.float64)
    r_valid = rng.random(n) > 0.1
    snap = ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64),
        {"k": Column(EvalType.INT, np.where(k_valid, k, 0), k_valid),
         "r": Column(EvalType.REAL, np.where(r_valid, r, 0.0), r_valid)})
    return table, snap, k, r, r_valid


def rows_close(got, want, scale):
    """Equal rows; float cells within 1e-6·``scale`` (REAL sums: the
    reference sums tiles in float32)."""
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            if isinstance(w, float) and g is not None:
                assert abs(g - w) <= 1e-6 * scale, (g, w)
            else:
                assert g == w


def real_plan(table, which):
    s = DagSelect.from_table(table, ["id", "k", "r"])
    r, k = s.col("r"), s.col("k")
    zero, minus1 = Expr.const(0.0, EvalType.REAL), Expr.const(-1.0,
                                                              EvalType.REAL)
    plans = [
        # REAL selection, scatter route
        lambda: s.where(r > 10.5).aggregate(
            [k], [("min", r), ("max", r), ("var_samp", r), ("count", r)]),
        # REAL selection over a computed value, two-level route (f32 planes)
        lambda: s.where((r * 2.0) < 50.0).aggregate(
            [k], [("sum", r), ("avg", r), ("count_star", None)]),
        # no GROUP BY: the simple body
        lambda: s.where(r >= 0.0).aggregate(
            [], [("sum", r), ("avg", r), ("min", r), ("first", r),
                 ("stddev_pop", r)]),
        # control and math signatures as REAL arguments
        lambda: s.aggregate(
            [k], [("sum", Expr.call("IfReal", r > 0.0, r, zero)),
                  ("avg", Expr.call("Sqrt", Expr.call("AbsReal", r))),
                  ("max", Expr.call("IfNullReal", r, minus1))]),
        # control, cast and math signatures as INT arguments
        lambda: s.aggregate(
            [k], [("sum", Expr.call("IfInt", k > 0, k,
                                    Expr.const(0, EvalType.INT))),
                  ("avg", Expr.call("CastIntAsInt", k)),
                  ("sum", Expr.call("CoalesceInt", k,
                                    Expr.const(7, EvalType.INT))),
                  ("min", Expr.call("TruncateInt", k * 123,
                                    Expr.const(-1, EvalType.INT)))]),
    ]
    return plans[which]().build()


@pytest.mark.parametrize("which", range(5))
def test_real_and_expression_plans_match_reference(which, ref, port):
    """REAL selections and aggregates, a NULL group key, and the control,
    cast and math signatures as aggregate arguments."""
    table, snap, k, r, r_valid = real_table(20_000, seed=which)
    dag = real_plan(table, which)
    assert ref.supports(dag)
    want, got = run_both(ref, port, dag, snap)
    rows_close(got, want, np.abs(np.where(r_valid, r, 0.0)).sum())


def test_sparse_keys_beyond_the_fused_slots(ref, port):
    """Keys spread past 2^20 are dictionary-encoded; 6000 distinct keys
    need more slots than the fused kernel holds, so the two-level route
    (COUNT/SUM) and the scatter route (MIN/VAR) run on the slot ids."""
    dom = np.sort(np.random.default_rng(21).choice(1 << 40, 6000,
                                                   replace=False))
    table, snap, k, v, v_valid = table_kv(30_000, seed=20, key_dom=dom,
                                          groups=6000, nullable_v=True)
    for aggs in ([("count_star", None), ("sum", "v")],
                 [("min", "v"), ("var_pop", "v")]):
        s = DagSelect.from_table(table, ["id", "k", "v"])
        dag = s.aggregate([s.col("k")], [
            (kd, None if c is None else s.col(c)) for kd, c in aggs]).build()
        want, got = run_both(ref, port, dag, snap)
        assert got == want
        assert len(got) == len(np.unique(k))


@pytest.mark.parametrize("name", ["4n", "4w", "4r"])
def test_twolevel_route_makes_one_fused_call(name, port, monkeypatch):
    """A two-level request calls the fused entry once, with the raw columns
    (no plane building in the runner), and answers as the reference."""
    import tikv_tpu_torch.device.runner as rmod
    calls = []
    real = rmod.twolevel_fused

    def record(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(rmod, "twolevel_fused", record)
    table, snap, dag = ref_config(name, 5000)
    psnap = port_snapshot(table, snap)
    got = port.handle_request(convert.dag_from_wire(wire.enc_dag(dag)),
                              psnap).rows()
    truth, scales = configs.truth(name, psnap)
    assert configs.rows_agree(got, truth, scales, 1e-9)
    assert len(calls) == 1
    assert calls[0]["key"].dtype == torch.int32 and \
        calls[0]["key_ok"] is None and calls[0]["mask"] is None
    src = inspect.getsource(rmod)
    assert "make_planes" not in src and "slot_index(" not in src


def test_port_builders_draw_the_benchmark_arrays():
    """The port's config builders reproduce bench.py's tables exactly."""
    real = functools.partial(bench.build_table, real_v=True)
    for port_build, ref_build in (
            (configs.build_table, bench.build_table),
            (configs.build_sparse_table, bench.build_sparse_table),
            (configs.CONFIGS["4w"][0], lambda n, g: bench.build_table(
                n, configs.WIDE_GROUPS)),
            (configs.CONFIGS["4r"][0], lambda n, g: real(n, g))):
        _pt, psnap = port_build(5000) if port_build in (
            configs.CONFIGS["4w"][0], configs.CONFIGS["4r"][0]) \
            else port_build(5000, 1024)
        _rt, rsnap = ref_build(5000, 1024)
        np.testing.assert_array_equal(psnap.handles, rsnap.handles)
        for cid in (2, 3):
            np.testing.assert_array_equal(psnap.columns[cid].values,
                                          rsnap.columns[cid].values)
            assert psnap.columns[cid].eval_type.value == \
                rsnap.columns[cid].eval_type.value
    # the NULL-bearing configs: config 4's arrays under the seeded mask
    _pt, psnap = configs.build_null_table(5000)
    _rt, rsnap, _dag = ref_config("4n", 5000)
    for cid in (2, 3):
        np.testing.assert_array_equal(psnap.columns[cid].values,
                                      rsnap.columns[cid].values)
        np.testing.assert_array_equal(psnap.columns[cid].validity,
                                      rsnap.columns[cid].validity)
    assert configs.dag_hash_agg(configs.bench_table()).plan_key() == \
        bench._dag_hash_agg(bench.build_table(10, 4)[0]).plan_key()
    assert configs.dag_simple_agg(configs.bench_table()).plan_key() == \
        bench._dag_simple_agg(bench.build_table(10, 4)[0]).plan_key()


def test_host_answer_agrees_for_slice_plans(ref):
    """The reference's host pipeline is a second witness for config 4."""
    dag, snap, truth = case_config4()
    host = BatchExecutorsRunner(dag, snap).handle_request().rows()
    assert sorted(host, key=lambda r: r[-1]) == truth


@pytest.mark.parametrize("plan", ["sum_k_times_3", "count_where_k_plus_100",
                                  "max_v_group_by_k_plus_1"])
def test_reference_device_wraps_int_arithmetic(plan, ref, port):
    """ROADMAP.md queue 3, fault 5: INT arithmetic over an int32 column
    wraps at int32 on the reference's device path.  Over k = 2^31 - 10 (and
    2^31 - 1 for the GROUP BY), the reference gives SUM(k*3) =
    2147483618000 and COUNT(*) WHERE k+100 > 0 = 0, and raises on MAX(v)
    GROUP BY k+1; the port evaluates the arithmetic in int64 and returns
    the host pipeline's answers."""
    n = 100 if plan.startswith("max") else 1000
    big = 2**31 - 1 if plan.startswith("max") else 2**31 - 10
    table, snap, k, v, _ = table_kv(n, seed=24)
    snap.columns[2] = Column(EvalType.INT, np.full(n, big, np.int64),
                             np.ones(n, np.bool_))
    snap.columns[3] = Column(EvalType.INT, np.arange(n, dtype=np.int64) % 7,
                             np.ones(n, np.bool_))
    s = DagSelect.from_table(table, ["id", "k", "v"])
    if plan == "sum_k_times_3":
        dag = s.aggregate([], [("sum", s.col("k") * 3)]).build()
        wrapped, right = [(2147483618000,)], [(6442450914000,)]
    elif plan == "count_where_k_plus_100":
        dag = s.where((s.col("k") + 100) > 0).aggregate(
            [], [("count_star", None)]).build()
        wrapped, right = [(0,)], [(1000,)]
    else:
        dag = s.aggregate([s.col("k") + 1], [("max", s.col("v"))]).build()
        wrapped, right = None, [(6, 2**31)]
    host = BatchExecutorsRunner(dag, snap).handle_request().rows()
    assert host == right
    if wrapped is None:
        with pytest.raises(AssertionError, match="key range overflow"):
            ref.handle_request(dag, snap)
    else:
        assert ref.handle_request(dag, snap).rows() == wrapped
    got = port.handle_request(convert.dag_from_wire(wire.enc_dag(dag)),
                              port_snapshot(table, snap)).rows()
    assert got == right


@pytest.mark.parametrize("arg", ["v_times_3", "v_plus_2_31_minus_500"])
def test_int_arithmetic_route_follows_the_bounds_proof(arg, ref, port,
                                                       monkeypatch):
    """SUM(v*3) with v in [-1000, 1000): the column bounds prove the
    product exact in int32, so it stays on the fused ``hash_agg`` route;
    SUM(v + 2^31 - 500) leaves int32 for v ≥ 500, so it evaluates in int64
    and takes the two-level route (8-byte planes).  Both equal the truth and
    the reference (whose int32 wraparound does not reach these values)."""
    import tikv_tpu_torch.device.runner as rmod
    calls = []
    for name in ("hash_agg", "twolevel_fused"):
        real = getattr(rmod.ha if name == "hash_agg" else rmod, name)

        def record(*a, _n=name, _f=real, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(rmod.ha if name == "hash_agg" else rmod, name,
                            record)
    table, snap, k, v, _ = table_kv(5000, seed=25)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    expr = s.col("v") * 3 if arg == "v_times_3" else \
        s.col("v") + (2**31 - 500)
    dag = s.aggregate([s.col("k")], [("sum", expr)]).build()
    add = 3 * v if arg == "v_times_3" else v + (2**31 - 500)
    truth = [(int(add[k == key].sum()), int(key)) for key in np.unique(k)]
    got = port.handle_request(convert.dag_from_wire(wire.enc_dag(dag)),
                              port_snapshot(table, snap)).rows()
    assert got == truth
    assert calls == (["hash_agg"] if arg == "v_times_3"
                     else ["twolevel_fused"])
    if arg == "v_times_3":
        assert ref.handle_request(dag, snap).rows() == truth
