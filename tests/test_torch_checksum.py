"""CHECKSUM (tp 105) in the port against the JAX package.

The port's ``crc64``, ``checksum_kv_pairs``, row codec ``encode_row``,
``ColumnarTable.to_kv_pairs`` and ``Endpoint.handle_checksum`` against the
reference's on the same seeded tables: the bytes of every KV pair and
every checksum exactly (tolerance 0), over full and partial key ranges,
delete tombstones, a cold-minted ``MvccColumnarSnapshot``, and two replicas
of the same rows.
"""

import dataclasses

import numpy as np
import pytest

from tikv_tpu.codec import encode_row as ref_encode_row
from tikv_tpu.codec import table_record_key as ref_record_key
from tikv_tpu.copr.analyze import ChecksumReq as RefChecksumReq
from tikv_tpu.copr.analyze import checksum_kv_pairs as ref_checksum_pairs
from tikv_tpu.copr.analyze import crc64 as ref_crc64
from tikv_tpu.copr.endpoint import Endpoint as RefEndpoint
from tikv_tpu.datatype import Column as RefColumn
from tikv_tpu.datatype import EvalType as RefET
from tikv_tpu.datatype import FieldType as RefFT
from tikv_tpu.datatype.eval_type import FieldTypeTp as RefTp
from tikv_tpu.executors.columnar import ColumnarTable as RefTable
from tikv_tpu.executors.ranges import KeyRange as RefKeyRange
from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch import convert
from tikv_tpu_torch.codec.row import decode_row, encode_row
from tikv_tpu_torch.copr.analyze import (ChecksumReq, checksum_kv_pairs,
                                         crc64)
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_CHECKSUM, Endpoint
from tikv_tpu_torch.copr.region_cache import (MvccColumnarSnapshot,
                                              build_region_columnar_device)
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.executors.columnar import ColumnarTable
from tikv_tpu_torch.testing import configs as cf
from tikv_tpu_torch.testing import mvcc as tm

N = 1500


def test_crc64_check_value_and_fold():
    assert crc64(b"123456789") == 0x995DC9BBDF1939FA
    r1 = checksum_kv_pairs([b"a", b"b"], [b"1", b"2"])
    r2 = checksum_kv_pairs([b"b", b"a"], [b"2", b"1"])
    assert r1["checksum"] == r2["checksum"]         # order-independent
    assert (r1["total_kvs"], r1["total_bytes"]) == (2, 4)
    assert checksum_kv_pairs([b"a", b"b"], [b"1", b"x"])["checksum"] != \
        r1["checksum"]
    assert checksum_kv_pairs([], []) == {"checksum": 0, "total_kvs": 0,
                                         "total_bytes": 0}


def test_crc64_and_fold_match_reference():
    rng = np.random.default_rng(105)
    keys = [bytes(rng.integers(0, 256, rng.integers(0, 40)).astype(np.uint8))
            for _ in range(300)]
    vals = [bytes(rng.integers(0, 256, rng.integers(0, 90)).astype(np.uint8))
            for _ in range(300)]
    for k, v in zip(keys, vals):
        assert crc64(k + v) == ref_crc64(k + v)
    assert checksum_kv_pairs(keys, vals) == ref_checksum_pairs(keys, vals)


def _payloads(rng) -> list:
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
            (1 << 63) - 1, 1 << 63, (1 << 64) - 1, -1, -32, -33, -128, -129,
            -32768, -32769, -(1 << 31), -(1 << 31) - 1, -(1 << 63)]
    scalars = ints + [None, True, False, 0.0, -0.0, 1.5, float("inf"),
                      float("nan"), b"", b"x" * 31, b"y" * 255, b"z" * 256,
                      b"w" * 70_000, "", "a" * 31, "b" * 32, "c" * 300]
    out = [{}, {1: None}]
    for v in scalars:
        out.append({2: v})
    for m in (3, 15, 16, 17, 70_000):
        out.append({i: scalars[i % len(scalars)] for i in range(m)})
    for _ in range(50):
        out.append({int(c): scalars[int(rng.integers(len(scalars)))]
                    for c in rng.integers(1, 1 << 20, rng.integers(1, 9))})
    return out


def test_encode_row_matches_reference_bytes():
    rng = np.random.default_rng(7)
    for payload in _payloads(rng):
        got = encode_row(payload)
        assert got == ref_encode_row(payload)
        back = decode_row(got)
        assert list(back) == list(payload)


def ref_table_def() -> Table:
    return Table(8970, (
        TableColumn("id", 1, RefFT.long(not_null=True), is_pk_handle=True),
        TableColumn("k", 2, RefFT.long()),
        TableColumn("r", 3, RefFT.double()),
        TableColumn("s", 4, RefFT.var_char()),
        TableColumn("d", 5, RefFT(tp=RefTp.DATETIME)),
        TableColumn("u", 6, RefFT.long(unsigned=True)),
    ))


def table_arrays(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    handles = np.sort(rng.choice(1 << 40, N, replace=False)) - (1 << 39)
    u = rng.integers(0, 1 << 63, N, dtype=np.uint64)
    u[::5] |= np.uint64(1 << 63)
    cols = {
        "k": (RefET.INT, rng.integers(-(1 << 62), 1 << 62, N),
              rng.random(N) > 0.1),
        "r": (RefET.REAL, rng.normal(0, 1e3, N), rng.random(N) > 0.1),
        "s": (RefET.BYTES, np.array([b"v%d" % (i * 7919 % 1000)
                                     for i in range(N)], object),
              rng.random(N) > 0.1),
        "d": (RefET.DATETIME, rng.integers(0, 1 << 60, N, dtype=np.uint64),
              rng.random(N) > 0.1),
        "u": (RefET.INT, u, rng.random(N) > 0.1),
    }
    alive = rng.random(N) > 0.15
    return handles, cols, alive


def snapshots(seed: int, tombstones: bool) -> tuple:
    t = ref_table_def()
    handles, cols, alive = table_arrays(seed)
    rcols = {t[name].col_id: RefColumn(et, v, ok)
             for name, (et, v, ok) in cols.items()}
    rsnap = RefTable(t, handles, rcols, alive if tombstones else None)
    ptable = convert.table_from_wire(t.table_id, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in t.columns])
    psnap = convert.snapshot_from_arrays(
        ptable, handles, {name: (et.value, v, ok)
                          for name, (et, v, ok) in cols.items()},
        alive if tombstones else None)
    return t, handles, rsnap, psnap


def _ranges(t, handles, case: str):
    if case == "all":
        return None
    if case == "partial":
        cut = [(handles[10], handles[400]), (handles[700] + 1,
                                             handles[1200])]
    else:                                           # past every row
        cut = [(int(handles[-1]) + 1, int(handles[-1]) + 9)]
    return tuple(RefKeyRange(ref_record_key(t.table_id, int(lo)),
                             ref_record_key(t.table_id, int(hi)))
                 for lo, hi in cut)


@pytest.mark.parametrize("tombstones", (False, True))
@pytest.mark.parametrize("case", ("all", "partial", "none"))
def test_kv_pairs_match_reference_bytes(case, tombstones):
    t, handles, rsnap, psnap = snapshots(11, tombstones)
    ranges = _ranges(t, handles, case)
    want = rsnap.to_kv_pairs(ranges)
    pranges = None if ranges is None else \
        convert.dag_from_wire(wire.enc_dag(dataclasses.replace(
            DagSelect.from_table(t).build(), ranges=ranges))).ranges
    got = psnap.to_kv_pairs(pranges)
    assert got == want
    if case != "none":
        assert got


def requests(t, ranges):
    dag = DagSelect.from_table(t).build()
    if ranges is not None:
        dag = dataclasses.replace(dag, ranges=ranges)
    pdag = convert.dag_from_wire(wire.enc_dag(dag))
    return RefChecksumReq(dag.executors[0], dag.ranges), \
        ChecksumReq(pdag.executors[0], pdag.ranges)


@pytest.mark.parametrize("case", ("all", "partial", "none"))
def test_handle_checksum_matches_reference(case):
    t, handles, rsnap, psnap = snapshots(12, True)
    rreq, preq = requests(t, _ranges(t, handles, case))
    want = RefEndpoint(lambda req: rsnap).handle_checksum(rreq)
    seen = []

    def provider(req):
        seen.append(req.tp)
        return psnap
    got = Endpoint(provider, DeviceRunner(device="cpu"),
                   device_row_threshold=1).handle_checksum(preq)
    assert got == want and seen == [REQ_TYPE_CHECKSUM]
    assert got["total_kvs"] == (0 if case == "none" else
                                len(rsnap.to_kv_pairs(rreq.ranges)))


def test_replicas_agree_and_content_differs():
    t, handles, _r, psnap = snapshots(13, True)
    _t, _h, _r2, replica = snapshots(13, True)
    _t, _h, _r3, other = snapshots(14, True)
    _rreq, preq = requests(t, None)
    one = Endpoint(lambda req: psnap).handle_checksum(preq)
    two = Endpoint(lambda req: replica).handle_checksum(preq)
    assert one == two and one["checksum"] != 0
    three = Endpoint(lambda req: other).handle_checksum(preq)
    assert three["checksum"] != one["checksum"]


def test_checksum_needs_a_table_snapshot():
    t, _h, _r, _p = snapshots(12, False)
    _rreq, preq = requests(t, None)
    with pytest.raises(NotImplementedError):
        Endpoint(lambda req: object()).handle_checksum(preq)


def test_cold_snapshot_checksum_matches_reference():
    """A cold-minted ``MvccColumnarSnapshot`` (config 6c's history at 5,000
    keys) gives the pairs and the checksum of the reference over the
    generator's visible rows."""
    table, planes, th, truth, read_ts = tm.history_6c(5000)
    runner = DeviceRunner(device="cpu")
    areq = cf.analyze_request(table)
    tbl, safe, bundle = build_region_columnar_device(
        planes, table, areq.scan.columns, read_ts, runner.mvcc_resolver())
    snap = MvccColumnarSnapshot(tbl, read_ts, safe, bundle)
    rt = Table(table.table_id, tuple(
        TableColumn(c.name, c.col_id, RefFT.long(not_null=c.is_pk_handle),
                    is_pk_handle=c.is_pk_handle) for c in table.columns))
    rsnap = RefTable(rt, th, {cid: RefColumn(RefET.INT, v, ok)
                              for cid, (v, ok) in truth.items()})
    assert snap.to_kv_pairs() == rsnap.to_kv_pairs()
    rreq, preq = requests(rt, None)
    got = Endpoint(lambda req: snap, runner).handle_checksum(preq)
    assert got == RefEndpoint(lambda req: rsnap).handle_checksum(rreq)
    assert got["total_kvs"] == 5000
    assert snap.estimated_rows() == 5000
    assert isinstance(snap._tbl, ColumnarTable)
