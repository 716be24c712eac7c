"""Requests cross between the packages on the wire unchanged: the port's
decoded DAG has the reference's ``plan_key()`` and ``class_key()``, and
re-encodes to the same dict."""

import pytest

from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import int_table

from tikv_tpu_torch.copr import wire as pwire
from tikv_tpu_torch.convert import dag_from_wire


def _dags():
    t = int_table(3, table_id=77)

    def sel():
        return DagSelect.from_table(t, ["id", "c0", "c1", "c2"])

    out = {}
    s = sel()
    out["config3"] = s.aggregate([], [("sum", s.col("c1")),
                                      ("count_star", None),
                                      ("avg", s.col("c1"))]).build()
    s = sel()
    out["config4"] = s.aggregate([s.col("c0")], [
        ("count_star", None), ("sum", s.col("c1"))]).build()
    s = sel()
    out["selection_const_beyond_int32"] = s.where(
        s.col("c1") < 2**40, s.col("c2").is_null().not_()).aggregate(
        [s.col("c0") + 1], [("count", s.col("c1")),
                            ("avg", s.col("c2") * 3)]).build(start_ts=9)
    s = sel()
    out["float_const_output_offsets"] = s.where(
        s.col("c1") > 2.5).aggregate(
        [], [("count_star", None), ("sum", s.col("c0"))]) \
        .output_offsets([1, 0]).build()
    s = sel()
    out["logic_and_min"] = s.where(
        (s.col("c0") > 3).and_(s.col("c1").ne(7))).aggregate(
        [s.col("c2")], [("min", s.col("c1"))]).build()
    s = sel()
    out["topn"] = s.order_by(s.col("c1"), desc=True, limit=5).build()
    return out


DAGS = _dags()


@pytest.mark.parametrize("name", sorted(DAGS))
def test_plan_key_survives_the_wire(name):
    dag = DAGS[name]
    port_dag = dag_from_wire(wire.enc_dag(dag))
    assert port_dag.plan_key() == dag.plan_key()
    assert port_dag.class_key() == dag.class_key()
    assert pwire.enc_dag(port_dag) == wire.enc_dag(dag)
    assert wire.dec_dag(pwire.enc_dag(port_dag)) == dag


# ------------------------------------------- the server's body codec
#
# ``tikv_tpu_torch/server/wire.py`` packs every RPC body: its bytes must
# equal the reference's ``server/wire.py`` for the same request, rows and
# errors.


def _plans():
    from tikv_tpu.copr import plan_ir as rpir
    from tikv_tpu.copr.dag import AggExprDesc, AggregationDesc
    from tikv_tpu.datatype import EvalType
    from tikv_tpu.executors.ranges import KeyRange
    from tikv_tpu.expr import Expr
    t = int_table(3, table_id=78)
    b = int_table(2, table_id=79)

    def scan(tbl):
        s = DagSelect.from_table(tbl, [c.name for c in tbl.columns]).build()
        return rpir.ScanNode(s.executors[0], (KeyRange(b"t", b"u"),))

    join = rpir.JoinNode(rpir.SelectNode(scan(t), (
        Expr.column(2, EvalType.INT) > Expr.const(-3, EvalType.INT),)),
        scan(b), 1, 1)
    agg = rpir.AggNode(join, AggregationDesc(
        (Expr.column(5, EvalType.INT),),
        (AggExprDesc("count_star", None),
         AggExprDesc("sum", Expr.column(6, EvalType.INT))), False))
    sort = rpir.SortNode(scan(t), ((Expr.column(1, EvalType.INT), True),))
    win = rpir.WindowNode(scan(t), (Expr.column(1, EvalType.INT),),
                          ((Expr.column(2, EvalType.INT), False),),
                          (rpir.WindowFuncDesc("row_number", None, 1),))
    return {"join_agg": rpir.PlanRequest(agg, start_ts=17),
            "sort": rpir.PlanRequest(sort),
            "window": rpir.PlanRequest(win, output_offsets=(0, 1))}


PLANS = _plans()


@pytest.mark.parametrize("name", sorted(DAGS))
def test_server_body_of_a_dag_is_byte_equal(name):
    from tikv_tpu_torch.server import wire as swire
    dag = DAGS[name]
    req = {"dag": wire.enc_dag(dag), "tp": 103, "force_backend": None,
           "paging_size": 0, "deadline_ms": 250}
    raw = wire.pack(req)
    port_dag = dag_from_wire(swire.unpack(raw)["dag"])
    assert swire.pack({**req, "dag": swire.enc_dag(port_dag)}) == raw
    assert swire.unpack(raw) == wire.unpack(raw)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_server_body_of_a_plan_is_byte_equal(name):
    from tikv_tpu_torch.server import wire as swire
    req = {"plan": wire.enc_plan(PLANS[name])}
    raw = wire.pack(req)
    port_plan = swire.dec_plan(swire.unpack(raw)["plan"])
    assert swire.pack({"plan": swire.enc_plan(port_plan)}) == raw


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_are_byte_equal(seed):
    import decimal

    import numpy as np

    from tikv_tpu_torch.server import wire as swire
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(40):
        rows.append((int(rng.integers(-2**62, 2**62)),
                     np.float64(rng.normal()),        # a float subclass
                     float(rng.normal()),
                     rng.bytes(int(rng.integers(0, 40))),
                     None if rng.random() < 0.3 else int(rng.integers(9)),
                     decimal.Decimal(f"{rng.integers(-999, 999)}.25"),
                     bool(rng.random() < 0.5), "s%d" % rng.integers(99)))
    body = {"rows": wire.enc_rows(rows), "backend": "device"}
    pbody = {"rows": swire.enc_rows(rows), "backend": "device"}
    assert swire.pack(pbody) == wire.pack(body)
    assert swire.unpack(swire.pack(pbody)) == wire.unpack(wire.pack(body))
    # a numpy integer is no msgpack type in either package
    with pytest.raises(TypeError):
        wire.pack({"rows": [[np.int64(1)]]})
    with pytest.raises(TypeError):
        swire.pack({"rows": [[np.int64(1)]]})
    assert swire.pack_response(b"\x90") == wire.pack_response(b"\x90")


def _errors(pkg: str) -> list:
    import importlib
    m = importlib.import_module
    errs = m(f"{pkg}.storage.mvcc.errors")
    tt = m(f"{pkg}.storage.txn_types")
    meta = m(f"{pkg}.raftstore.metapb")
    rp = m(f"{pkg}.server.read_pool")
    dl = m(f"{pkg}.utils.deadline")
    region = meta.Region(3, b"a", b"z", meta.RegionEpoch(2, 5),
                         (meta.Peer(4, 1), meta.Peer(5, 2, True)))
    lock = tt.Lock(tt.LockType.PUT, b"pk", 41, ttl=300,
                   min_commit_ts=45)
    return [errs.KeyIsLocked(b"k1", lock),
            errs.WriteConflict(b"k2", 10, 8, 9, "pessimistic"),
            errs.TxnLockNotFound(b"k3", 11),
            errs.Committed(b"k4", 12, 13),
            errs.AlreadyExist(b"k5"),
            errs.PessimisticLockRolledBack(b"k6", 14)
            if hasattr(errs, "PessimisticLockRolledBack") else
            ValueError("x"),
            meta.NotLeaderError(3, meta.Peer(4, 1)),
            meta.NotLeaderError(3),
            meta.EpochNotMatch(region),
            meta.KeyNotInRegion(b"zz", region),
            meta.RegionNotFound(9),
            meta.RegionMerging(3),
            meta.DataIsNotReady(3, 100, 200),
            rp.ServerIsBusy("read pool saturated", retry_after_ms=7),
            rp.ServerIsBusy("plain"),
            dl.DeadlineExceeded("read_pool", 1.23456),
            TimeoutError("raft command stalled"),
            ValueError("bad request")]


def test_errors_are_byte_equal():
    from tikv_tpu_torch.server import wire as swire
    ref_errs, port_errs = _errors("tikv_tpu"), _errors("tikv_tpu_torch")
    assert len(ref_errs) == len(port_errs)
    for re_, pe in zip(ref_errs, port_errs):
        assert type(pe).__name__ == type(re_).__name__
        assert swire.enc_error(pe) == wire.enc_error(re_), re_
        assert swire.pack({"error": swire.enc_error(pe)}) == \
            wire.pack({"error": wire.enc_error(re_)})
