"""DATETIME and DURATION on the port's device routes, against the JAX
package's DeviceRunner and both host pipelines.

The table of the chip smoke's ``run_time_types`` phase at 2^14 rows (seed
7): ``k`` INT of 1024 groups, ``d`` DATETIME at day resolution over TPC-H's
``l_shipdate`` range (1992-01-02 .. 1998-12-01, 10% NULL), ``u`` DURATION
of 0 .. 86,400 s in ns.  Its four cells go through the port's
``DeviceRunner(device="cpu")`` (the plain versions of ``sel_pred``,
``agg_fold`` and ``topn_select``), the reference's DeviceRunner (JAX on the
CPU) and the port's host pipeline, and are held to a numpy truth:

- ``t2``: COUNT(*), MIN(d), MAX(d) WHERE d in 1994 (Q6's predicate),
  its selection in ``sel_pred``;
- ``t4m``: GROUP BY k: COUNT(*), MIN(d), MAX(u) WHERE d <= 1998-09-02
  (Q1's), also on a 2×2 mesh;
- ``t5``: WHERE d >= 1994-01-01 ORDER BY u DESC LIMIT 1000;
- ``th``: COUNT(*) WHERE Year(d) = 1995 — ``Year`` is host-only, so the
  plan never enters a device plan and the endpoint answers on the host.

Then the gate: a column holding a core at or above 2^63 (year 9999) is
answered on the host, or raises when the device is forced; SUM of a
DATETIME and the host-only casts stay on the host; the shifts run in int64
on int32 and int64 planes, where the reference's device shifts an int32
plane in 32 bits (ROADMAP.md §3, fault 10, pinned here).
"""

import numpy as np
import pytest

import jax

from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.datatype.eval_type import FieldTypeTp
from tikv_tpu.datatype.time import (civil_from_days, days_from_civil,
                                    pack_datetime)
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.executors.runner import BatchExecutorsRunner
from tikv_tpu.expr import Expr
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch import convert
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.device import selection as sm
from tikv_tpu_torch.device.runner import (PRED_KERNEL, PRED_TORCH,
                                          DeviceRunner, FeedBeyondInt64)
from tikv_tpu_torch.executors.runner import \
    BatchExecutorsRunner as PortHostRunner

N = 1 << 14
I = EvalType.INT


def time_table(n=N, seed=7, table_id=9401, year_9999=False, k_hi=1024):
    rng = np.random.default_rng(seed)
    lo, hi = days_from_civil(1992, 1, 2), days_from_civil(1998, 12, 1)
    y, m, d = civil_from_days(rng.integers(lo, hi + 1, n))
    dok = rng.random(n) >= 0.1
    dv = np.where(dok, pack_datetime(y, m, d), 0).astype(np.uint64)
    if year_9999:
        dv[7], dok[7] = int(pack_datetime(9999, 12, 31)), True
    u = rng.integers(0, 86_400 * 10**9 + 1, n).astype(np.int64)
    k = rng.integers(0, k_hi, n).astype(np.int64)
    table = Table(table_id, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("d", 3, FieldType(tp=FieldTypeTp.DATETIME)),
        TableColumn("u", 4, FieldType(tp=FieldTypeTp.DURATION))))
    snap = ColumnarTable.from_arrays(table, np.arange(n, dtype=np.int64), {
        "k": Column(EvalType.INT, k, np.ones(n, bool)),
        "d": Column(EvalType.DATETIME, dv, dok),
        "u": Column(EvalType.DURATION, u, np.ones(n, bool))})
    return table, snap, (k, dv, dok, u)


def port_snapshot(table, snap):
    ptable = convert.table_from_wire(table.table_id, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in table.columns])
    arrays = {c.name: (snap.columns[c.col_id].eval_type.value,
                       snap.columns[c.col_id].values,
                       snap.columns[c.col_id].validity)
              for c in table.columns if c.col_id in snap.columns}
    return convert.snapshot_from_arrays(ptable, snap.handles, arrays)


def port_dag(dag):
    return convert.dag_from_wire(wire.enc_dag(dag))


def T(*ymd):
    return Expr.const(int(pack_datetime(*ymd)), EvalType.DATETIME)


def cell(table, name):
    s = DagSelect.from_table(table, ["id", "k", "d", "u"])
    if name == "t2":
        return s.where(Expr.call("GeTime", s.col("d"), T(1994, 1, 1)),
                       Expr.call("LtTime", s.col("d"), T(1995, 1, 1))) \
            .aggregate([], [("count_star", None), ("min", s.col("d")),
                            ("max", s.col("d"))]).build()
    if name == "t4m":
        return s.where(Expr.call("LeTime", s.col("d"), T(1998, 9, 2))) \
            .aggregate([s.col("k")], [("count_star", None),
                                      ("min", s.col("d")),
                                      ("max", s.col("u"))]).build()
    if name == "t5":
        return s.where(Expr.call("GeTime", s.col("d"), T(1994, 1, 1))) \
            .order_by(s.col("u"), desc=True, limit=1000).build()
    if name == "th":
        return s.where(Expr.call("EqInt", Expr.call("Year", s.col("d")),
                                 Expr.const(1995, I))) \
            .aggregate([], [("count_star", None)]).build()
    raise AssertionError(name)


def truth(name, cols):
    """The cell's answer from numpy alone."""
    k, dv, dok, u = cols
    d = dv.astype(np.int64)
    if name == "t2":
        m = dok & (d >= int(pack_datetime(1994, 1, 1))) & \
            (d < int(pack_datetime(1995, 1, 1)))
        return [(int(m.sum()), int(d[m].min()), int(d[m].max()))]
    if name == "t4m":
        m = dok & (d <= int(pack_datetime(1998, 9, 2)))
        return sorted((int((m & (k == g)).sum()), int(d[m & (k == g)].min()),
                       int(u[m & (k == g)].max()), int(g))
                      for g in np.unique(k[m]))
    if name == "t5":
        m = dok & (d >= int(pack_datetime(1994, 1, 1)))
        idx = np.flatnonzero(m)
        top = idx[np.lexsort((idx, -u[idx]))][:1000]
        return [(int(i), int(k[i]), int(dv[i]), int(u[i])) for i in top]
    if name == "th":
        return [(int((dok & ((dv >> np.uint64(50)) == 1995)).sum()),)]
    raise AssertionError(name)


def canon(rows):
    """Rows as int tuples in one order (NULL first)."""
    rows = [tuple(None if v is None else int(v) for v in r) for r in rows]
    return sorted(rows, key=lambda r: [(v is not None, v or 0) for v in r])


@pytest.fixture(scope="module")
def data():
    return time_table()


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def port():
    return DeviceRunner(device="cpu")


@pytest.mark.parametrize("name", ["t2", "t4m", "t5"])
def test_cell_on_device_matches_reference_and_truth(name, data, ref, port):
    table, snap, cols = data
    dag = cell(table, name)
    want = truth(name, cols)
    pdag = port_dag(dag)
    psnap = port_snapshot(table, snap)
    assert port.supports(pdag) and ref.supports(dag)
    plan = port._analyze(pdag)[0]
    assert plan.sel_route == PRED_KERNEL    # the time compare in sel_pred
    got = port.handle_request(pdag, psnap).rows()
    host = PortHostRunner(pdag, psnap).handle_request().rows()
    ref_got = ref.handle_request(dag, snap).rows()
    if name == "t5":
        # ordered rows: ties of u are broken by row position everywhere
        assert [tuple(map(int, r)) for r in got] == want
        assert [tuple(map(int, r)) for r in host] == want
        assert [tuple(map(int, r)) for r in ref_got] == want
    else:
        assert canon(got) == canon(want) == canon(host) == canon(ref_got)


def test_host_only_cell_is_served_on_the_host(data, port):
    """``th``: a host-only sig never enters a device plan; the endpoint
    answers on the host though the table is over its row threshold."""
    table, snap, cols = data
    dag = cell(table, "th")
    pdag = port_dag(dag)
    psnap = port_snapshot(table, snap)
    assert not port.supports(pdag)
    ep = Endpoint(lambda req: psnap, device_runner=port,
                  device_row_threshold=1)
    resp = ep.handle(CopRequest(REQ_TYPE_DAG, pdag))
    assert resp.backend == "host"
    assert resp.rows() == truth("th", cols) == \
        BatchExecutorsRunner(dag, snap).handle_request().rows()
    with pytest.raises(RuntimeError, match="not supported"):
        ep.handle(CopRequest(REQ_TYPE_DAG, pdag, "device"))


def test_t4m_on_a_mesh(data):
    table, snap, cols = data
    runner = DeviceRunner(mesh=convert.mesh_from_shape((2, 2), ["cpu"] * 4),
                          chunk_rows=8 * 64)
    got = runner.handle_request(port_dag(cell(table, "t4m")),
                                port_snapshot(table, snap)).rows()
    assert canon(got) == canon(truth("t4m", cols))


class _Counting:
    """A snapshot that counts its column scans."""

    def __init__(self, snap):
        self._snap = snap
        self.scans = 0

    def scan_columns(self, *a, **kw):
        self.scans += 1
        return self._snap.scan_columns(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._snap, name)


def test_core_beyond_int64_goes_to_the_host(ref):
    """A year-9999 core packs above 2^63: the feed guard refuses the
    device and keeps the verdict (no second column scan); the endpoint then
    answers on the host, or raises when the device is forced.  The
    reference's runner falls back inside its forced request."""
    table, snap, cols = time_table(n=4096, seed=34, table_id=9402,
                                   year_9999=True)
    s = DagSelect.from_table(table, ["id", "k", "d", "u"])
    dag = s.aggregate([s.col("k")], [("max", s.col("d"))]).build()
    want = BatchExecutorsRunner(dag, snap).handle_request().rows()
    assert canon(ref.handle_request(dag, snap).rows()) == canon(want)
    pdag = port_dag(dag)
    psnap = _Counting(port_snapshot(table, snap))
    runner = DeviceRunner(device="cpu")
    assert runner.supports(pdag)
    with pytest.raises(FeedBeyondInt64):
        runner.handle_request(pdag, psnap)
    scans = psnap.scans
    with pytest.raises(FeedBeyondInt64):
        runner.handle_request(pdag, psnap)
    assert psnap.scans == scans
    ep = Endpoint(lambda req: psnap, device_runner=runner,
                  device_row_threshold=1)
    resp = ep.handle(CopRequest(REQ_TYPE_DAG, pdag))
    assert resp.backend == "host" and canon(resp.rows()) == canon(want)
    assert ep.degrades.get("beyond_int64") == 1
    with pytest.raises(FeedBeyondInt64):
        ep.handle(CopRequest(REQ_TYPE_DAG, pdag, "device"))


@pytest.mark.parametrize("plan", ["sum_datetime", "avg_duration", "year",
                                  "cast_real_int", "decimal_cast"])
def test_host_only_terms_stay_off_the_device(plan, data, ref, port):
    table, snap, _cols = data
    s = DagSelect.from_table(table, ["id", "k", "d", "u"])
    if plan == "sum_datetime":
        dag = s.aggregate([], [("sum", s.col("d"))]).build()
    elif plan == "avg_duration":
        dag = s.aggregate([s.col("k")], [("avg", s.col("u"))]).build()
    elif plan == "year":
        dag = s.aggregate([], [("max", Expr.call("Year", s.col("d")))]) \
            .build()
    elif plan == "cast_real_int":
        dag = s.where(Expr.call("GtInt", Expr.call(
            "CastRealAsInt", Expr.const(2.5, EvalType.REAL)), s.col("k"))) \
            .aggregate([], [("count_star", None)]).build()
    else:
        dag = s.where(Expr.call("GtDecimal", Expr.call(
            "CastIntAsDecimal", s.col("k")), Expr.call(
            "CastIntAsDecimal", Expr.const(500, I)))) \
            .aggregate([], [("count_star", None)]).build()
    assert not ref.supports(dag)
    pdag = port_dag(dag)
    assert not port.supports(pdag)
    psnap = port_snapshot(table, snap)
    ep = Endpoint(lambda req: psnap, device_runner=port,
                  device_row_threshold=1)
    resp = ep.handle(CopRequest(REQ_TYPE_DAG, pdag))
    assert resp.backend == "host"
    assert canon(resp.rows()) == canon(
        BatchExecutorsRunner(dag, snap).handle_request().rows())


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
def test_shifts_run_in_int64(wide, ref, port):
    """``(k << 40) >> 38 > 1000`` on the torch route (sel_pred has no
    shift ops) over an int32 plane and an int64 one: the port's device
    equals both host pipelines.  The reference's device shifts an int32
    plane in 32 bits, and so finds no row (fault 10)."""
    table, snap, (k, *_rest) = time_table(n=4096, seed=41, table_id=9403,
                                          k_hi=1024)
    if wide:
        k = k.copy()
        k[0] = 1 << 40
        snap.columns[2] = Column(EvalType.INT, k, np.ones(len(k), bool))
    s = DagSelect.from_table(table, ["id", "k", "d", "u"])
    e = Expr.call("RightShift", Expr.call(
        "LeftShift", s.col("k"), Expr.const(40, I)), Expr.const(38, I))
    dag = s.where(Expr.call("GtInt", e, Expr.const(1000, I))) \
        .aggregate([], [("count_star", None)]).build()
    with np.errstate(over="ignore"):
        want = int((((k << 40) >> 38) > 1000).sum())
    assert BatchExecutorsRunner(dag, snap).handle_request().rows() == \
        [(want,)]
    pdag = port_dag(dag)
    psnap = port_snapshot(table, snap)
    assert port._analyze(pdag)[0].sel_route == PRED_TORCH
    assert port.handle_request(pdag, psnap).rows() == [(want,)]
    assert PortHostRunner(pdag, psnap).handle_request().rows() == [(want,)]
    ref_dev = ref.handle_request(dag, snap).rows()
    if wide:
        assert ref_dev == [(want,)]
    else:
        assert want > 0 and ref_dev == [(0,)]      # fault 10


def test_duration_probe_on_host_and_device(port):
    """COUNT(*), MAX(d) WHERE d > 500 s over 1000 DURATION rows."""
    n = 1000
    table = Table(9404, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("d", 2, FieldType(tp=FieldTypeTp.DURATION))))
    snap = ColumnarTable.from_arrays(table, np.arange(n, dtype=np.int64), {
        "d": Column(EvalType.DURATION,
                    np.arange(n, dtype=np.int64) * 10**9, np.ones(n, bool))})
    s = DagSelect.from_table(table, ["id", "d"])
    dag = s.where(Expr.call("GtDuration", s.col("d"),
                            Expr.const(500 * 10**9, EvalType.DURATION))) \
        .aggregate([], [("count_star", None), ("max", s.col("d"))]).build()
    psnap = port_snapshot(table, snap)
    ep = Endpoint(lambda req: psnap, device_runner=port,
                  device_row_threshold=1)
    for force in ("host", "device"):
        resp = ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(dag), force))
        assert resp.backend == force
        assert resp.rows() == [(499, 999_000_000_000)]


def test_time_compares_encode_as_integer_ops():
    """GtTime and GeDuration take sel_pred's integer comparison opcodes
    over int64 planes, constants riding in the op."""
    pdag = port_dag(cell(time_table(n=64)[0], "t2"))
    plan = DeviceRunner(device="cpu")._analyze(pdag)[0]
    prog = sm.encode_predicate(plan.sel_rpns, ("int64",) * len(
        plan.used_cols))
    assert [op for op, _a, _x in prog.ops] == [
        sm.OP_COL, sm._CMP_OPS["Ge"], sm.OP_KEEP["I"],
        sm.OP_COL, sm._CMP_OPS["Lt"], sm.OP_KEEP["I"]]
    assert prog.wide
