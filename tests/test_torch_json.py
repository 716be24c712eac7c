"""JSON in the port against the JAX package: the value semantics
(``datatype/myjson.py``), the 30 sigs through the host pipeline, JSON
columns in rows and snapshots, the device gate, CHECKSUM and ANALYZE.

- ``myjson``: every vector of ``tests/test_json.py`` goes through both
  packages' functions; the answers must be equal and of the same Python
  types (``repr``), ``NOT_FOUND`` for ``NOT_FOUND``, and an error of the
  same type where the reference raises.
- A seeded JSON table (objects, arrays, scalars, the JSON null and SQL
  NULLs) is written as KV rows through each package's fixture — the bytes
  must be equal — and as a columnar snapshot, carried into the port by
  ``convert``.  DAGs with JSON predicates and projections run on both
  host pipelines over both storages: the rows must be equal (``repr``).
- Through the port's endpoint with a device runner, a plan that calls a
  JSON sig is served on the host; a plan over the same table that reads
  no JSON column runs on the device runner, with the same rows as the
  host.
- CHECKSUM over the table equals the reference's.  ANALYZE of a JSON
  column of numbers or of strings equals the reference's statistics; of
  objects the reference's host half raises (fault 11), the port's orders
  the documents by ``json_sort_key``.
"""

import copy
import json

import numpy as np
import pytest

from tikv_tpu.copr.analyze import ChecksumReq as RefChecksumReq
from tikv_tpu.copr.analyze import analyze_columns as ref_analyze_columns
from tikv_tpu.copr.endpoint import CopRequest as RefRequest
from tikv_tpu.copr.endpoint import Endpoint as RefEndpoint
from tikv_tpu.datatype import Column as RefColumn
from tikv_tpu.datatype import ColumnBatch as RefBatch
from tikv_tpu.datatype import EvalType as RefET
from tikv_tpu.datatype import FieldType as RefFT
from tikv_tpu.datatype import myjson as ref_mj
from tikv_tpu.executors.columnar import ColumnarTable as RefColumnar
from tikv_tpu.executors.runner import BatchExecutorsRunner as RefRunner
from tikv_tpu.expr import Expr as RefExpr
from tikv_tpu.server import wire
from tikv_tpu.testing import init_with_data as ref_init_with_data
from tikv_tpu.testing.dag import DagSelect as RefDagSelect
from tikv_tpu.testing.fixture import Table as RefTable
from tikv_tpu.testing.fixture import TableColumn as RefTableColumn

from tikv_tpu_torch import convert
from tikv_tpu_torch.copr.analyze import (AnalyzeReq, ChecksumReq,
                                         analyze_columns, json_sort_key)
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.datatype import Column, ColumnBatch, EvalType, FieldType
from tikv_tpu_torch.datatype import myjson as mj
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.executors.runner import BatchExecutorsRunner
from tikv_tpu_torch.testing import init_with_data
from tikv_tpu_torch.testing.dag import DagSelect
from tikv_tpu_torch.testing.fixture import Table, TableColumn

TID = 8725
N = 240

# --------------------------------------------------------------- myjson

_DOC = {"a": {"b": [1, 2, {"c": 3}]}, "x": None}
_SEARCH = {"a": "abc", "b": {"c": "abd"}, "l": ["xbc", 5]}
_MOD = {"a": {"b": 1}, "l": [1, 2]}

# (function, arguments): the vectors of tests/test_json.py, and the edges
# its assertions imply
VECTORS = [
    ("parse_path", ("$.a.b",)), ("parse_path", ('$."a b"[2]',)),
    ("parse_path", ("$[*].x",)), ("parse_path", ("$.*",)),
    ("parse_path", ("$**.k",)), ("parse_path", ("a.b",)),
    ("parse_path", ('$."a\\"b"',)), ("parse_path", (b"$.a[ 3 ]",)),
    ("parse_path", ("$.",)), ("parse_path", ('$."open',)),
    ("extract", (_DOC, ["$.a.b[2].c"])), ("extract", (_DOC, ["$.a.b[9]"])),
    ("extract", (_DOC, ["$.x"])), ("extract", (_DOC, ["$.a.b[*]"])),
    ("extract", (_DOC, ["$.a.b[0]", "$.a.b[1]"])),
    ("extract", ({"k": {"c": 1}, "j": {"c": 2}}, ["$**.c"])),
    ("extract", (5, ["$[0]"])), ("extract", ({'a"b': 7}, ['$."a\\"b"'])),
    ("extract", (_DOC, ["$.*"])), ("extract", ([[1], [2, 3]], ["$[*][0]"])),
    ("type_name", (True,)), ("type_name", (1,)), ("type_name", (1.5,)),
    ("type_name", (None,)), ("type_name", ("s",)), ("type_name", ([],)),
    ("type_name", ({},)),
    ("json_eq", (True, 1)), ("json_eq", (1, 1.0)),
    ("json_eq", ({"a": [1, 2]}, {"a": [1, 2]})),
    ("json_eq", (2 ** 60, 2 ** 60 + 1)), ("json_eq", ("1", 1)),
    ("member_of", (2, [1, 2, 3])), ("member_of", (True, [1, 2])),
    ("member_of", ({"a": 1}, {"a": 1})),
    ("merge_preserve", ([{"a": 1}, {"a": 2, "b": 3}],)),
    ("merge_preserve", ([[1], 2],)), ("merge_preserve", ([1, {"a": 1}],)),
    ("json_set", (_MOD, [(b"$.a.c", 9)])),
    ("json_insert", (_MOD, [(b"$.a.b", 9)])),
    ("json_replace", (_MOD, [(b"$.zz", 9)])),
    ("json_set", (_MOD, [(b"$.l[5]", 9)])),
    ("json_set", ({}, [(b"$.a", {"x": 1}), (b"$.a.y", 2)])),
    ("json_set", (3, [(b"$[1]", 4)])), ("json_set", (_MOD, [(b"$.*", 1)])),
    ("json_remove", (_MOD, [b"$.a.b"])), ("json_remove", (_MOD, [b"$"])),
    ("depth", (1,)), ("depth", ({"a": [1, {"b": 2}]},)), ("depth", ([],)),
    ("length", ({"a": 1, "b": 2},)), ("length", (5,)),
    ("length", ({"a": [1, 2, 3]}, b"$.a")), ("length", ({"a": 1}, b"$.b")),
    ("keys", ({"b": 1, "a": 2},)), ("keys", ([1],)),
    ("keys", ({"a": {"z": 1}}, b"$.a")),
    ("unquote", ("hi",)), ("unquote", ([1, "x"],)), ("unquote", (None,)),
    ("quote", (b'a"b',)), ("quote", ("é\n",)),
    ("dumps", ({"a": [1, 2.5, None, True, "é"]},)),
    ("search", (_SEARCH, b"one", b"ab%")),
    ("search", (_SEARCH, b"all", b"ab_")),
    ("search", (_SEARCH, b"all", b"%bc%")),
    ("search", (_SEARCH, b"one", b"zz")),
    ("search", (_SEARCH, b"all", b"abc")),
    ("search", (_SEARCH, b"all", b"ab%", 92, (b"$.b",))),
    ("search", (_SEARCH, b"all", b"ab%", 92, (b"$.*",))),
    ("search", ({"k": "a%c"}, b"all", b"a|%c", ord("|"))),
    ("array_append", ({"a": [1, 2], "b": 3}, [(b"$.a", 9)])),
    ("array_append", ({"a": [1, 2], "b": 3}, [(b"$.b", 9)])),
    ("array_append", ({"a": [1, 2], "b": 3}, [(b"$.zz", 9)])),
    ("array_append", (1, [(b"$", 2)])),
]
_CONTAINS = [
    ({"a": {"a": 1}, "b": 2}, {"b": 2}), ({}, {}), ({"a": 1}, {}),
    ({"a": 1}, 1), ({"a": [1]}, [1]), ({"b": 2, "c": 3}, {"c": 3}), (1, 1),
    ([1], 1), ([1, 2], [1]), ([1, 2], [1, 3]), ([1, 2], ["1"]),
    ([1, 2, [1, 3]], [1, 3])]
VECTORS += [("contains", c) for c in _CONTAINS]


def _call(module, fn: str, args):
    """(answer, args after the call) or the error's type."""
    args = copy.deepcopy(args)
    try:
        got = getattr(module, fn)(*args)
    except Exception as e:      # the reference's error is an answer too
        return type(e)
    if got is module.NOT_FOUND:
        got = "NOT_FOUND"
    return repr(got), repr(args)


@pytest.mark.parametrize("i", range(len(VECTORS)),
                         ids=[f"{f}-{i}" for i, (f, _a) in
                              enumerate(VECTORS)])
def test_myjson_matches_reference(i):
    fn, args = VECTORS[i]
    want = _call(ref_mj, fn, args)
    got = _call(mj, fn, args)
    if isinstance(want, type):
        assert got is want, (fn, args, got)
        return
    assert got == want, (fn, args)


# ---------------------------------------------------------------- table

def _doc(rng, depth: int = 0):
    r = rng.random()
    if depth > 2 or r < 0.35:
        return [None, True, False, int(rng.integers(-50, 50)),
                float(rng.integers(-8, 8)) / 4, "t" + str(rng.integers(8)),
                ""][int(rng.integers(7))]
    if r < 0.55:
        return [_doc(rng, depth + 1) for _ in range(rng.integers(0, 4))]
    return {k: _doc(rng, depth + 1) for k in
            rng.choice(["name", "tags", "n", "a b", "k"],
                       int(rng.integers(0, 4)), replace=False).tolist()}


def _rows():
    """(handle, {"k": INT, "doc": JSON or SQL NULL}) a row."""
    rng = np.random.default_rng(25)
    out = []
    for h in range(N):
        doc = None if rng.random() < 0.1 else (
            {"name": f"n{h % 7}", "tags": rng.integers(0, 5, 3).tolist(),
             "n": int(h)} if rng.random() < 0.6 else _doc(rng))
        out.append((h, {"k": int(h % 9), "doc": doc}))
    return out


def _tables():
    ref = RefTable(TID, (
        RefTableColumn("id", 1, RefFT.long(not_null=True),
                       is_pk_handle=True),
        RefTableColumn("k", 2, RefFT.long()),
        RefTableColumn("doc", 3, RefFT.json())))
    port = Table(TID, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("doc", 3, FieldType.json())))
    return ref, port


def _columnar(ref_table, port_table, rows):
    hs = np.asarray([h for h, _ in rows], np.int64)
    k = [r["k"] for _, r in rows]
    docs = [r["doc"] for _, r in rows]
    ref = RefColumnar.from_arrays(ref_table, hs, {
        "k": RefColumn.from_list(RefET.INT, k),
        "doc": RefColumn.from_list(RefET.JSON, docs)})
    port = convert.snapshot_from_arrays(port_table, hs, {
        "k": ("int", np.asarray(k, np.int64), None),
        "doc": ("json", docs, [d is not None for d in docs])})
    return ref, port


@pytest.fixture(scope="module")
def stores():
    rows = _rows()
    rt, pt = _tables()
    rsnap, psnap = _columnar(rt, pt, rows)
    return {"rows": rows, "ref_table": rt, "port_table": pt,
            "ref_kv": ref_init_with_data(rt, rows),
            "port_kv": init_with_data(pt, rows),
            "ref_snap": rsnap, "port_snap": psnap}


def _c(s):
    return RefExpr.const(s, RefET.BYTES)


def _plans(t):
    """name → reference DAG (carried into the port over the wire)."""
    def sel():
        return RefDagSelect.from_table(t, ["id", "k", "doc"])

    out = {}
    s = sel()
    out["contains"] = s.where(RefExpr.call(
        "JsonContainsSig",
        RefExpr.call("JsonExtractSig", s.col("doc"), _c(b"$.tags")),
        RefExpr.call("CastStringAsJson", _c(b"2")))).build()
    s = sel()
    out["project"] = s.project(
        RefExpr.call("JsonTypeSig", s.col("doc")),
        RefExpr.call("JsonExtractSig", s.col("doc"), _c(b"$.name")),
        RefExpr.call("JsonUnquoteSig",
                     RefExpr.call("JsonExtractSig", s.col("doc"),
                                  _c(b"$.name"))),
        RefExpr.call("JsonSetSig", s.col("doc"), _c(b"$.z"),
                     RefExpr.call("CastIntAsJson", s.col("k"))),
        RefExpr.call("JsonLengthSig", s.col("doc"))).build()
    s = sel()
    out["member"] = s.where(RefExpr.call(
        "JsonMemberOfSig", RefExpr.call("CastIntAsJson", s.col("k")),
        RefExpr.call("JsonExtractSig", s.col("doc"), _c(b"$.tags")))) \
        .aggregate([s.col("k")], [("count_star", None)]).build()
    s = sel()
    out["topn"] = s.where(RefExpr.call(
        "JsonValidJsonSig", s.col("doc"))).order_by(
        s.col("id"), desc=True).limit(17).build()
    s = sel()
    out["search"] = s.project(RefExpr.call(
        "JsonSearchSig", s.col("doc"), _c(b"all"), _c(b"n%"))).build()
    return out


def _run(runner_cls, dag, storage):
    rows = runner_cls(dag, storage).handle_request().rows()
    assert rows
    return repr(rows)


@pytest.mark.parametrize("plan", ["contains", "project", "member", "topn",
                                  "search"])
def test_json_dag_through_both_host_pipelines(stores, plan):
    rdag = _plans(stores["ref_table"])[plan]
    pdag = convert.dag_from_wire(wire.enc_dag(rdag))
    want = _run(RefRunner, rdag, stores["ref_snap"])
    assert want == _run(RefRunner, rdag, stores["ref_kv"])
    assert _run(BatchExecutorsRunner, pdag, stores["port_snap"]) == want
    assert _run(BatchExecutorsRunner, pdag, stores["port_kv"]) == want


def test_json_plan_is_served_on_the_host_and_the_rest_on_the_device(stores):
    rdag = _plans(stores["ref_table"])["contains"]
    pdag = convert.dag_from_wire(wire.enc_dag(rdag))
    runner = DeviceRunner(device="cpu")
    assert not runner.supports(pdag)
    ep = Endpoint(lambda req: stores["port_snap"], runner,
                  device_row_threshold=1)
    resp = ep.handle(CopRequest(REQ_TYPE_DAG, pdag))
    assert resp.backend == "host"
    rep = RefEndpoint(lambda req: stores["ref_snap"])
    assert repr(resp.rows()) == repr(rep.handle(RefRequest(103, rdag))
                                     .rows())
    # a plan over the same table that reads no JSON column: the device
    t = stores["port_table"]
    s = DagSelect.from_table(t, ["id", "k", "doc"])
    dag = s.where(s.col("k") > 3).aggregate(
        [s.col("k")], [("count_star", None), ("sum", s.col("id"))]).build()
    assert runner.supports(dag)
    got = ep.handle(CopRequest(REQ_TYPE_DAG, dag))
    assert got.backend == "device"
    host = ep.handle(CopRequest(REQ_TYPE_DAG, dag, force_backend="host"))
    assert sorted(got.rows()) == sorted(host.rows())
    # the device feed holds no plane of the JSON column
    feeds = runner.resident_feeds(stores["port_snap"])
    assert feeds and all(3 not in key[1] for key in feeds)


def test_unknown_sig_fails_as_in_the_reference(stores):
    from tikv_tpu_torch.expr import Expr
    t = stores["port_table"]
    s = DagSelect.from_table(t, ["id", "k"])
    dag = s.where(Expr.call("NoSuchSig", s.col("k"))).build()
    with pytest.raises(ValueError, match="unknown ScalarFuncSig"):
        DeviceRunner(device="cpu").supports(dag)


def test_json_rows_are_the_reference_bytes(stores):
    """The fixture's KV pairs, and a columnar snapshot's, byte for byte;
    the fixture's rows decode to the documents written."""
    pk, rk = stores["port_kv"], stores["ref_kv"]
    assert (pk._keys, pk._vals) == (rk._keys, rk._vals)
    assert stores["port_snap"].to_kv_pairs() == \
        stores["ref_snap"].to_kv_pairs()
    dag = DagSelect.from_table(stores["port_table"]).build()
    got = BatchExecutorsRunner(dag, pk).handle_request().rows()
    assert repr(got) == repr([(h, r["k"], r["doc"])
                              for h, r in stores["rows"]])


def test_checksum_of_a_json_table(stores):
    rt, pt = stores["ref_table"], stores["port_table"]
    rscan = RefDagSelect.from_table(rt).build().executors[0]
    pscan = DagSelect.from_table(pt).build().executors[0]
    want = RefEndpoint(lambda r: stores["ref_snap"]).handle_checksum(
        RefChecksumReq(rscan), stores["ref_snap"])
    got = Endpoint(lambda r: stores["port_snap"]).handle_checksum(
        ChecksumReq(pscan), stores["port_snap"])
    assert got == want and got["total_kvs"] == N


@pytest.mark.parametrize("kind", ["ints", "reals", "strings", "objects",
                                  "arrays", "mixed"])
def test_analyze_of_a_json_column(kind):
    rng = np.random.default_rng(len(kind))
    pick = {"ints": lambda: int(rng.integers(-30, 30)),
            "reals": lambda: float(rng.integers(-30, 30)) / 8,
            "strings": lambda: "s" + str(rng.integers(0, 40)),
            "objects": lambda: {"a": int(rng.integers(0, 9)),
                                "b": [int(rng.integers(0, 3))]},
            "arrays": lambda: rng.integers(0, 4, 2).tolist(),
            "mixed": lambda: _doc(rng)}[kind]
    docs = [None if rng.random() < 0.1 else pick() for _ in range(200)]
    info = _tables()[1]["doc"]
    port = analyze_columns(ColumnBatch([FieldType.json()], [
        Column.from_list(EvalType.JSON, docs)]), [info], 8)[0]
    try:
        ref = ref_analyze_columns(RefBatch([RefFT.json()], [
            RefColumn.from_list(RefET.JSON, docs)]), [info], 8)[0]
    except (TypeError, ValueError):
        # fault 11: the reference sorts the Python values (objects, mixed
        # types: TypeError), and arrays of one length become a second
        # dimension of its numpy array (ValueError)
        assert kind in ("objects", "arrays", "mixed")
        live = sorted((d for d in docs if d is not None), key=json_sort_key)
        assert port.null_count == docs.count(None)
        assert port.distinct == len({json.dumps(d, sort_keys=True)
                                     for d in live})
        assert port.buckets[-1] == (live[-1], len(live))
        return
    assert kind in ("ints", "reals", "strings")
    assert repr(port) == repr(ref)


def test_analyze_request_sends_the_json_column_to_the_host_half(stores):
    """Through the port's endpoint with a device runner: the INT columns on
    the device route, ``doc`` on the host half; equal to the host half's
    statistics of every column."""
    pt = stores["port_table"]
    scan = DagSelect.from_table(pt).build().executors[0]
    runner = DeviceRunner(device="cpu")
    ep = Endpoint(lambda r: stores["port_snap"], runner,
                  device_row_threshold=1)
    got = ep.handle_analyze(AnalyzeReq(scan, (), 16))["columns"]
    batch = BatchExecutorsRunner(DagSelect.from_table(pt).build(),
                                 stores["port_snap"]).handle_request().batch
    want = analyze_columns(batch, scan.columns, 16)
    assert repr(got) == repr(want)
    assert "scan" in runner.analyze_phases_ms and ep.degrades == {}
