"""Whole plan-IR requests through the port's endpoint
(``Endpoint.handle_plan``, ``copr/plan_ir.py``, ``device/join.py``)
against the JAX package's endpoint on the same snapshots.

Plans are built with the reference's plan IR, wire-encoded with its
``server/wire.py`` ``enc_plan`` and decoded by the port
(``convert.plan_from_wire``).  The reference runs with its one-device
``DeviceRunner``, the port with ``DeviceRunner(device="cpu")`` (the plain
versions of the kernels); each plan runs forced to the host and to the
device in both, and all four answers must be equal exactly (tolerance
0): join rows in probe order then build order, sort and window rows in
their order.  The shapes are ``tests/test_plan_ir.py``'s: randomized join
parity (NULL-heavy, wide, tombstoned, skewed, fused predicates, a host
finalize on top, keys at int64.max), empty sides, the pair-capacity
overflow, mixed fragments in one plan, the ``device::join_dispatch``
degrade of one fragment, ``copr::plan_route``, sort and window parity,
keyless sorts and windows, a REAL running sum left to the host; and
config 7 and its cells 7s and 7w at a small size against numpy.
"""

import numpy as np
import pytest

import jax

from tikv_tpu.codec.keys import table_record_range
from tikv_tpu.copr import plan_ir as rpir
from tikv_tpu.copr.dag import AggExprDesc, AggregationDesc, TableScanDesc
from tikv_tpu.copr.endpoint import Endpoint as RefEndpoint
from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.executors.ranges import KeyRange
from tikv_tpu.expr import Expr
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch import convert
from tikv_tpu_torch.copr.endpoint import Endpoint
from tikv_tpu_torch.copr.wire import enc_plan
from tikv_tpu_torch.device.join import JoinDeviceUnavailable
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.testing import configs
from tikv_tpu_torch.utils import failpoint

I64 = np.iinfo(np.int64)


@pytest.fixture(autouse=True)
def _fp_teardown():
    yield
    failpoint.teardown()


@pytest.fixture(scope="module")
def ref_runner():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]), chunk_rows=1 << 12)


# ------------------------------------------------------------- fixtures


def _int_table(table_id, names):
    return Table(table_id, tuple(
        [TableColumn("id", 1, FieldType.long(not_null=True),
                     is_pk_handle=True)] +
        [TableColumn(nm, 2 + i, FieldType.long())
         for i, nm in enumerate(names)]))


def _snap(table, n, cols, alive=None):
    s = ColumnarTable.from_arrays(table, np.arange(n, dtype=np.int64), cols)
    if alive is not None:
        s = ColumnarTable(table, s.handles, s.columns, alive=alive)
    return s


def _port_snap(snap):
    t = snap.table
    ptable = convert.table_from_wire(t.table_id, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in t.columns])
    return convert.snapshot_from_arrays(ptable, snap.handles, {
        c.name: (snap.columns[c.col_id].eval_type.value,
                 snap.columns[c.col_id].values,
                 snap.columns[c.col_id].validity)
        for c in t.columns if c.col_id in snap.columns}, snap.alive)


def _scan_node(table):
    start, end = table_record_range(table.table_id)
    return rpir.ScanNode(
        TableScanDesc(table.table_id, tuple(table.column_info(c.name)
                                            for c in table.columns)),
        (KeyRange(start, end),))


class Pair:
    """The reference endpoint and the port's over the same snapshots."""

    def __init__(self, ref_runner, snaps, threshold=1):
        self.snaps = list(snaps)
        self.psnaps = [_port_snap(s) for s in self.snaps]
        rby = {s.table.table_id: s for s in self.snaps}
        pby = {s.table.table_id: s for s in self.psnaps}
        self.ref = RefEndpoint(
            lambda req: rby[req.dag.executors[0].table_id],
            device_runner=ref_runner, device_row_threshold=threshold)
        self.runner = DeviceRunner(device="cpu")
        self.port = Endpoint(lambda req: pby[req.dag.executors[0].table_id],
                             device_runner=self.runner,
                             device_row_threshold=threshold)

    def run(self, preq, force=None):
        return self.port.handle_plan(convert.plan_from_wire(
            wire.unpack(wire.pack(wire.enc_plan(preq)))), force)

    def check(self, preq, ordered=True):
        """All four answers equal (as sorted row lists when not
        ``ordered``: a device aggregation emits its groups in key order,
        the host in first-seen order); → the reference's host rows."""
        def rows(resp):
            return resp.rows() if ordered else sorted(
                resp.rows(), key=lambda r: [(x is None, x) for x in r])
        want = rows(self.ref.handle_plan(preq, force_backend="host"))
        assert rows(self.ref.handle_plan(preq, force_backend="device")) \
            == want
        for force in ("host", "device"):
            got = rows(self.run(preq, force))
            assert got == want, (force, len(got), len(want))
        return want


def _join_tables(seed, n_probe, n_build, key_lo=0, key_hi=200,
                 null_p=0.1, build_alive_p=None, wide=False):
    """test_plan_ir.py's generator: (probe snapshot, build snapshot)."""
    rng = np.random.default_rng(seed)
    pnames = [f"c{i}" for i in range(18)] if wide else ["k", "v"]
    pt = _int_table(9200 + seed * 2, pnames)
    cols = {}
    for i, nm in enumerate(pnames):
        if nm in ("k", "c0"):
            cols[nm] = Column(
                EvalType.INT,
                rng.integers(key_lo, max(key_lo + 1, key_hi),
                             n_probe).astype(np.int64),
                rng.random(n_probe) > null_p)
        else:
            cols[nm] = Column(
                EvalType.INT,
                rng.integers(-100, 100, n_probe).astype(np.int64),
                rng.random(n_probe) > (null_p if i % 3 else 0.0))
    psnap = _snap(pt, n_probe, cols)
    bt = _int_table(9201 + seed * 2, ["bk", "w"])
    bsnap = _snap(bt, n_build, {
        "bk": Column(EvalType.INT,
                     rng.integers(key_lo, max(key_lo + 1, key_hi),
                                  n_build).astype(np.int64),
                     rng.random(n_build) > null_p),
        "w": Column(EvalType.INT,
                    rng.integers(0, 50, n_build).astype(np.int64),
                    np.ones(n_build, np.bool_))},
        alive=None if build_alive_p is None
        else rng.random(n_build) < build_alive_p)
    return psnap, bsnap


def _join_plan(pt, bt, where_thr=None, key_col=1, agg=False):
    ps, bs = _scan_node(pt), _scan_node(bt)
    left = ps
    if where_thr is not None:
        vcol = 2 if len(pt.columns) <= 3 else 5
        left = rpir.SelectNode(ps, (
            Expr.column(vcol, EvalType.INT) >
            Expr.const(where_thr, EvalType.INT),))
    root = rpir.JoinNode(left, bs, key_col, 1)
    if agg:
        n_left = len(pt.columns)
        root = rpir.AggNode(root, AggregationDesc(
            (Expr.column(n_left + 1, EvalType.INT),),
            (AggExprDesc("count_star", None),
             AggExprDesc("sum", Expr.column(n_left + 2, EvalType.INT))),
            False))
    return rpir.PlanRequest(root)


# ------------------------------------------------------------ join parity

JOIN_SHAPES = {
    "baseline": dict(seed=2, n_probe=2000, n_build=300),
    "null_heavy": dict(seed=3, n_probe=1500, n_build=200, null_p=0.5),
    "wide": dict(seed=4, n_probe=1200, n_build=150, wide=True),
    "tombstones": dict(seed=5, n_probe=1500, n_build=300,
                       build_alive_p=0.6),
    "skewed": dict(seed=6, n_probe=1000, n_build=100, key_hi=4),
}


@pytest.mark.parametrize("thr,agg", [(None, False), (-20, False),
                                     (0, True)])
@pytest.mark.parametrize("shape", sorted(JOIN_SHAPES))
def test_randomized_join_parity(ref_runner, shape, thr, agg):
    psnap, bsnap = _join_tables(**JOIN_SHAPES[shape])
    pair = Pair(ref_runner, (psnap, bsnap))
    pair.check(_join_plan(psnap.table, bsnap.table, where_thr=thr, agg=agg))
    assert pair.port.plan_executor.join_backends.get("device") == 1
    assert not pair.port.degrades


def test_join_keys_at_the_sentinel(ref_runner):
    psnap, bsnap = _join_tables(7, 64, 64, key_lo=0, key_hi=2)
    psnap.columns[2].values[:8] = I64.max
    bsnap.columns[2].values[:4] = I64.max
    pair = Pair(ref_runner, (psnap, bsnap))
    assert pair.check(_join_plan(psnap.table, bsnap.table))


@pytest.mark.parametrize("n_probe,n_build", [(0, 100), (500, 0), (0, 0)])
def test_join_empty_sides(ref_runner, n_probe, n_build):
    psnap, bsnap = _join_tables(8, n_probe, n_build)
    pair = Pair(ref_runner, (psnap, bsnap))
    assert pair.check(_join_plan(psnap.table, bsnap.table)) == []


def test_join_overflow_redispatch(ref_runner):
    rng = np.random.default_rng(9)
    pt, bt = _int_table(9301, ["k", "v"]), _int_table(9302, ["bk", "w"])
    ones = np.ones(1000, np.bool_)
    psnap = _snap(pt, 1000, {
        "k": Column(EvalType.INT, np.full(1000, 7, np.int64), ones),
        "v": Column(EvalType.INT, rng.integers(-5, 5, 1000), ones)})
    bsnap = _snap(bt, 120, {
        "bk": Column(EvalType.INT, np.full(120, 7, np.int64), ones[:120]),
        "w": Column(EvalType.INT, rng.integers(0, 3, 120), ones[:120])})
    pair = Pair(ref_runner, (psnap, bsnap))
    pair.check(_join_plan(pt, bt, agg=True))
    assert pair.runner.joiner().overflow_redispatches == 1


def test_non_inner_join_rejected(ref_runner):
    psnap, bsnap = _join_tables(22, 50, 20)
    pair = Pair(ref_runner, (psnap, bsnap))
    preq = rpir.PlanRequest(rpir.JoinNode(_scan_node(psnap.table),
                                          _scan_node(bsnap.table), 1, 1,
                                          "left"))
    with pytest.raises(ValueError, match="join_type"):
        pair.run(preq)


# ------------------------------------------ mixed routing and degrades


def test_mixed_host_device_fragments_one_plan(ref_runner):
    psnap, bsnap = _join_tables(11, 3000, 250)
    pair = Pair(ref_runner, (psnap, bsnap))
    pair.check(_join_plan(psnap.table, bsnap.table, where_thr=0, agg=True))
    dec = pair.port.plan_executor.router.stats()["decisions"]
    assert dec.get("join:device", 0) >= 1
    assert dec.get("host_ops:host", 0) >= 1
    assert pair.port.plan_executor.join_backends.get("device") == 1
    assert pair.runner.joiner().stats()["device_joins"] == 1


def test_join_dispatch_failpoint_degrades_fragment_only(ref_runner):
    """``device::join_dispatch`` faults the probe dispatch: unforced, the
    join fragment degrades to the host join, the answer stays exact and
    the degrade is counted; forced to the device, it raises."""
    psnap, bsnap = _join_tables(12, 1500, 200)
    pair = Pair(ref_runner, (psnap, bsnap))
    preq = _join_plan(psnap.table, bsnap.table, where_thr=-50, agg=True)
    want = pair.ref.handle_plan(preq, force_backend="host").rows()
    failpoint.cfg("device::join_dispatch", "return")
    got = pair.run(preq)
    assert sorted(got.rows()) == sorted(want)
    assert pair.port.plan_executor.join_backends == {"degrade": 1}
    assert pair.port.degrades == {"join": 1}
    with pytest.raises(JoinDeviceUnavailable, match="join_dispatch"):
        pair.run(preq, "device")
    failpoint.teardown()
    assert pair.run(preq).rows() == want


def test_join_kernel_failure_is_not_degraded(ref_runner, monkeypatch):
    """A join kernel that fails to launch is no device fault: the plan
    raises, unforced too, and nothing is answered on the host."""
    from tikv_tpu_torch.device import join_probe as jp
    psnap, bsnap = _join_tables(12, 1500, 200)
    pair = Pair(ref_runner, (psnap, bsnap))
    preq = _join_plan(psnap.table, bsnap.table, where_thr=-50, agg=True)

    def broken(*args, **kwargs):
        raise RuntimeError("join_probe: launch failed")

    monkeypatch.setattr(jp, "join_probe", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        pair.run(preq)
    assert not pair.port.degrades
    assert "degrade" not in pair.port.plan_executor.join_backends


def test_plan_route_failpoint_forces_host(ref_runner):
    psnap, bsnap = _join_tables(13, 1200, 150)
    pair = Pair(ref_runner, (psnap, bsnap))
    preq = _join_plan(psnap.table, bsnap.table)
    want = pair.ref.handle_plan(preq, force_backend="host").rows()
    failpoint.cfg("copr::plan_route", "return")
    assert pair.run(preq).rows() == want
    dec = pair.port.plan_executor.router.stats()["decisions"]
    assert dec.get("join:device", 0) == 0 and dec.get("join:host") == 1


def test_router_follows_measured_walls(ref_runner):
    """Once both routes of a kind have walls, the faster serves; the cold
    model sends a large join to the device."""
    psnap, bsnap = _join_tables(14, 2000, 100)
    pair = Pair(ref_runner, (psnap, bsnap))
    preq = _join_plan(psnap.table, bsnap.table)
    pair.run(preq)
    router = pair.port.plan_executor.router
    assert router.decisions[("join", "device")] == 1
    router.note_wall("join", "host", 1e-6)
    pair.run(preq)
    assert router.decisions.get(("join", "host")) == 1


# ------------------------------------------------------- sort / window


@pytest.mark.parametrize("keys", [((1, False),), ((1, True), (2, False)),
                                  ((2, True), (0, True))])
def test_sort_parity(ref_runner, keys):
    psnap, _b = _join_tables(14, 1500, 10, null_p=0.4)
    pair = Pair(ref_runner, (psnap,))
    pair.check(rpir.PlanRequest(rpir.SortNode(_scan_node(psnap.table), tuple(
        (Expr.column(i, EvalType.INT), d) for i, d in keys))))
    assert pair.runner.joiner().sorts == 1


def test_sort_real_keys(ref_runner):
    rng = np.random.default_rng(14)
    rt = Table(9401, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("r", 2, FieldType.double())))
    r = rng.normal(0, 100, 900)
    r[:20] = -0.0
    rsnap = _snap(rt, 900, {"r": Column(EvalType.REAL, r,
                                        rng.random(900) > 0.3)})
    pair = Pair(ref_runner, (rsnap,))
    pair.check(rpir.PlanRequest(rpir.SortNode(
        _scan_node(rt), ((Expr.column(1, EvalType.REAL), True),))))


def test_keyless_sort_and_window_are_identity_not_empty(ref_runner):
    psnap, _b = _join_tables(20, 300, 10)
    pair = Pair(ref_runner, (psnap,))
    ps = _scan_node(psnap.table)
    for force in ("host", "device"):
        assert pair.run(rpir.PlanRequest(rpir.SortNode(ps, ())), force) \
            .result.batch.num_rows == 300
    rows = pair.check(rpir.PlanRequest(rpir.WindowNode(
        ps, (), (), (rpir.WindowFuncDesc("row_number"),))))
    assert len(rows) == 300 and [r[-1] for r in rows] == list(range(1, 301))


WINDOW_FUNCS = (rpir.WindowFuncDesc("row_number"),
                rpir.WindowFuncDesc("count", Expr.column(2, EvalType.INT)),
                rpir.WindowFuncDesc("sum", Expr.column(2, EvalType.INT)),
                rpir.WindowFuncDesc("avg", Expr.column(2, EvalType.INT)),
                rpir.WindowFuncDesc("lag", Expr.column(2, EvalType.INT), 2),
                rpir.WindowFuncDesc("lead", Expr.column(2, EvalType.INT), 1))


@pytest.mark.parametrize("partitioned", [True, False])
def test_window_parity(ref_runner, partitioned):
    psnap, _b = _join_tables(15, 1200, 10, null_p=0.3)
    pair = Pair(ref_runner, (psnap,))
    pair.check(rpir.PlanRequest(rpir.WindowNode(
        _scan_node(psnap.table),
        (Expr.column(1, EvalType.INT),) if partitioned else (),
        ((Expr.column(0, EvalType.INT), False),), WINDOW_FUNCS)))
    assert pair.runner.joiner().windows == 1


def test_window_real_running_sum_stays_host(ref_runner):
    rng = np.random.default_rng(16)
    rt = Table(9402, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("g", 2, FieldType.long()),
        TableColumn("r", 3, FieldType.double())))
    ones = np.ones(400, np.bool_)
    rsnap = _snap(rt, 400, {
        "g": Column(EvalType.INT, rng.integers(0, 6, 400), ones),
        "r": Column(EvalType.REAL, rng.normal(0, 10, 400), ones)})
    pair = Pair(ref_runner, (rsnap,))
    pair.check(rpir.PlanRequest(rpir.WindowNode(
        _scan_node(rt), (Expr.column(1, EvalType.INT),),
        ((Expr.column(0, EvalType.INT), False),),
        (rpir.WindowFuncDesc("sum", Expr.column(2, EvalType.REAL)),))))
    assert pair.runner.joiner().windows == 0
    assert not pair.port.degrades


# ---------------------------------------------------- IR, wire, configs


def test_reference_plan_decodes_in_the_port():
    psnap, bsnap = _join_tables(0, 10, 10)
    preq = _join_plan(psnap.table, bsnap.table, where_thr=3, agg=True)
    sort = rpir.SortNode(preq.root, ((Expr.column(0, EvalType.INT), True),))
    win = rpir.WindowNode(
        sort, (Expr.column(0, EvalType.INT),),
        ((Expr.column(1, EvalType.INT), False),),
        (rpir.WindowFuncDesc("row_number"),
         rpir.WindowFuncDesc("lag", Expr.column(1, EvalType.INT), 2)))
    full = rpir.PlanRequest(rpir.LimitNode(win, 5), start_ts=42,
                            output_offsets=(0, 1))
    d = wire.enc_plan(full)
    got = convert.plan_from_wire(wire.unpack(wire.pack(d)))
    assert got.start_ts == 42 and got.output_offsets == (0, 1)
    assert len(got.scan_leaves()) == 2 and got.has_join()
    assert enc_plan(got) == d           # the port encodes it back the same
    assert wire.dec_plan(enc_plan(got)).plan_key() == full.plan_key()


def test_from_dag_embeds_linear_plans(ref_runner):
    psnap, _b = _join_tables(1, 800, 10)
    pair = Pair(ref_runner, (psnap,))
    s = DagSelect.from_table(psnap.table, ["id", "k", "v"])
    dag = s.where(s.col("v") > Expr.const(10, EvalType.INT)).aggregate(
        [s.col("k")], [("count_star", None), ("sum", s.col("v"))]).build()
    pair.check(rpir.from_dag(dag), ordered=False)
    s2 = DagSelect.from_table(psnap.table, ["id", "k", "v"])
    dag2 = s2.partition_top_n((s2.col("k"),), ((s2.col("v"), True),),
                              3).build()
    pair.check(rpir.from_dag(dag2))


@pytest.mark.parametrize("cell", sorted(configs.PLAN_CELLS))
def test_config_7_cells_small(cell):
    """Config 7 and cells 7s / 7w at 50,000 × 4096 rows through the port's
    endpoint, both routes, against numpy; no degrade."""
    pt, ps, bt, bs = configs.build_join_pair(50_000, 4096)
    by = {pt.table_id: ps, bt.table_id: bs}
    ep = Endpoint(lambda req: by[req.dag.executors[0].table_id],
                  DeviceRunner(device="cpu"))
    want = configs.plan_truth(cell, ps, bs)
    preq = convert.plan_from_wire(enc_plan(configs.PLAN_CELLS[cell](pt, bt)))
    for force in ("host", "device"):
        got = ep.handle_plan(preq, force_backend=force).result.batch
        assert configs.columns_agree(got, want), force
    assert not ep.degrades


def test_wider_than_the_kernels_runs_on_the_host_twin(ref_runner):
    """A sort over more keys than ``sort_perm`` takes, and a window with
    more functions than ``window_scan``'s channels, run on their host
    twins even when forced to the device: capability, not a fault."""
    psnap, _b = _join_tables(23, 600, 10, key_hi=3)
    pair = Pair(ref_runner, (psnap,))
    ps = _scan_node(psnap.table)
    keys = tuple((Expr.column(i % 3, EvalType.INT), i % 2 == 0)
                 for i in range(9))
    pair.check(rpir.PlanRequest(rpir.SortNode(ps, keys)))
    funcs = tuple(rpir.WindowFuncDesc("lag", Expr.column(2, EvalType.INT),
                                      off) for off in range(1, 10))
    pair.check(rpir.PlanRequest(rpir.WindowNode(
        ps, (Expr.column(1, EvalType.INT),),
        ((Expr.column(0, EvalType.INT), False),), funcs)))
    joiner = pair.runner.joiner()
    assert (joiner.sorts, joiner.windows) == (0, 0)
    assert not pair.port.degrades
