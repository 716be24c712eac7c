"""DECIMAL, collated strings, DATETIME, DURATION, ENUM and SET through the
port's host pipeline, against the reference's.

One seeded table of every such type is written twice: as KV rows through
each package's row codec (a DECIMAL is msgpack ExtType 1 in both; the
bytes must be equal) and as a columnar snapshot, which ``convert`` carries
into the port.  The same wire-encoded plans — DECIMAL SUM/AVG/MIN/MAX by
group, a DECIMAL top-N, DECIMAL and case-insensitive string predicates,
enum and set names, time fields — run on the reference's
``BatchExecutorsRunner`` and the port's over both storages, and the rows
must be equal: DECIMALs with their scale.
"""

from decimal import Decimal as D

import numpy as np
import pytest

from tikv_tpu.codec.row import encode_row as ref_encode_row
from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.datatype.eval_type import FieldTypeTp
from tikv_tpu.datatype.time import pack_datetime
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.executors.runner import BatchExecutorsRunner as RefRunner
from tikv_tpu.expr import Expr
from tikv_tpu.server import wire
from tikv_tpu.testing import init_with_data
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch import convert
from tikv_tpu_torch.codec.row import encode_row
from tikv_tpu_torch.executors.runner import BatchExecutorsRunner
from tikv_tpu_torch.executors.storage import FixtureStorage

N = 300
CI = 45
COLORS = (b"red", b"Green", b"blue")
TAGS = (b"a", b"b", b"c", b"d")
I = EvalType.INT


def _table() -> Table:
    return Table(9501, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("price", 3, FieldType.new_decimal(30, 6)),
        TableColumn("name", 4, FieldType.var_char(collation=CI)),
        TableColumn("t", 5, FieldType(tp=FieldTypeTp.DATETIME)),
        TableColumn("dur", 6, FieldType(tp=FieldTypeTp.DURATION)),
        TableColumn("color", 7, FieldType.enum(COLORS)),
        TableColumn("tags", 8, FieldType.set_(TAGS))))


def _rows():
    rng = np.random.default_rng(24)
    names = [b"abc", b"ABC", b"Abc ", b"xyz", "été".encode(), b""]
    out = []
    for h in range(N):
        price = None if rng.random() < 0.1 else \
            D(int(rng.integers(-10**9, 10**9))).scaleb(-int(
                rng.integers(0, 7)))
        if h == 5:
            price = D("9" * 24 + ".999999")     # 30 digits
        out.append((h, {
            "k": int(rng.integers(0, 7)), "price": price,
            "name": names[int(rng.integers(0, len(names)))],
            "t": int(pack_datetime(int(rng.integers(1990, 2030)),
                                   int(rng.integers(1, 13)),
                                   int(rng.integers(1, 29)),
                                   int(rng.integers(0, 24)))),
            "dur": int(rng.integers(-10**13, 10**13)),
            "color": int(rng.integers(0, 4)),
            "tags": int(rng.integers(0, 16))}))
    return out


@pytest.fixture(scope="module")
def stores():
    """(reference KV store, port KV store, reference columnar snapshot,
    port columnar snapshot)."""
    table, rows = _table(), _rows()
    ref_kv = init_with_data(table, rows, with_indexes=False)
    port_kv = FixtureStorage(list(zip(ref_kv._keys, ref_kv._vals)))
    cols = {}
    for c in table.columns[1:]:
        et = c.field_type.eval_type
        cols[c.name] = Column.from_list(et, [r[c.name] for _h, r in rows])
    snap = ColumnarTable.from_arrays(
        table, np.array([h for h, _r in rows], np.int64), cols)
    ptable = convert.table_from_wire(table.table_id, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in table.columns])
    psnap = convert.snapshot_from_arrays(ptable, snap.handles, {
        name: (col.eval_type.value, col.values, col.validity)
        for name, col in cols.items()})
    return table, ref_kv, port_kv, snap, psnap


def _plans(table):
    def s():
        return DagSelect.from_table(table)

    def c(name):
        return s().col(name)

    def dec(v):
        return Expr.const(D(v), EvalType.DECIMAL)

    q = s()
    yield "decimal_aggs", q.aggregate([q.col("k")], [
        ("sum", q.col("price")), ("avg", q.col("price")),
        ("min", q.col("price")), ("max", q.col("price")),
        ("count", q.col("price"))]).build()
    q = s()
    yield "decimal_simple_aggs", q.aggregate([], [
        ("sum", q.col("price")), ("avg", q.col("price"))]).build()
    q = s()
    yield "decimal_topn", q.order_by(q.col("price"), desc=True,
                                     limit=7).build()
    q = s()
    yield "decimal_where", q.where(Expr.call(
        "GtDecimal", Expr.call("MultiplyDecimal", q.col("price"),
                               dec("1.5")), dec("100.25"))).build()
    q = s()
    yield "decimal_projection", q.project(
        Expr.call("DivideDecimal", q.col("price"), dec("3")),
        Expr.call("RoundWithFracDec", q.col("price"), Expr.const(2, I)),
        Expr.call("CastDecimalAsString", q.col("price"))).build()
    q = s()
    yield "ci_where", q.where(Expr.call(
        "EqString", q.col("name"), Expr.const(b"abc", EvalType.BYTES))) \
        .aggregate([q.col("k")], [("count_star", None)]).build()
    q = s()
    yield "ci_group", q.aggregate([Expr.call("WeightString", q.col("name"))],
                                  [("count_star", None),
                                   ("max", q.col("k"))]).build()
    q = s()
    yield "enum_set_names", q.project(
        Expr.call("CastEnumAsString", q.col("color")),
        Expr.call("CastSetAsString", q.col("tags")),
        Expr.call("Upper", q.col("name"))).build()
    q = s()
    yield "enum_minmax", q.aggregate([q.col("k")], [
        ("min", q.col("color")), ("max", q.col("tags"))]).build()
    q = s()
    yield "time_fields", q.where(Expr.call(
        "GtInt", Expr.call("Year", q.col("t")), Expr.const(2005, I))) \
        .project(Expr.call("DateFormatSig", q.col("t"), Expr.const(
            b"%Y-%m-%d %H %W", EvalType.BYTES)),
                 Expr.call("Hour", q.col("dur")),
                 Expr.call("TimeToSec", q.col("dur"))).build()
    q = s()
    yield "time_topn", q.order_by(q.col("dur"), desc=False,
                                  limit=9).build()


_NAMES = [name for name, _dag in _plans(_table())]


def _canon(rows):
    return [tuple(str(v) if isinstance(v, D) else v for v in r)
            for r in rows]


@pytest.mark.parametrize("storage", ["kv", "columnar"])
@pytest.mark.parametrize("plan", _NAMES)
def test_host_pipeline_matches_reference(plan, storage, stores):
    table, ref_kv, port_kv, snap, psnap = stores
    dag = dict(_plans(table))[plan]
    pdag = convert.dag_from_wire(wire.enc_dag(dag))
    if storage == "kv":
        want = RefRunner(dag, ref_kv).handle_request().rows()
        got = BatchExecutorsRunner(pdag, port_kv).handle_request().rows()
    else:
        want = RefRunner(dag, snap).handle_request().rows()
        got = BatchExecutorsRunner(pdag, psnap).handle_request().rows()
    assert want
    assert _canon(got) == _canon(want)


def test_row_codec_writes_the_reference_bytes():
    """Every row of the table, DECIMALs among them, encodes to the
    reference's bytes."""
    table = _table()
    for _h, row in _rows():
        payload = {c.col_id: row[c.name] for c in table.columns[1:]}
        assert encode_row(payload) == ref_encode_row(payload)
