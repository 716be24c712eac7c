"""The port's committed-write delta log (``tikv_tpu_torch/copr/delta.py``)
against the reference's (``tikv_tpu/copr/delta.py``), and the write batch's
``WriteOp``s (``raftstore/cmd.py``).

The same records (encoded by the port's ``txn_types``, byte-equal to the
reference's) go to both: ``decode_entry_ops`` field by field over every
kind of op, then two sinks fed the same event sequences must agree on
``deltas_between`` over every (from, to) pair, on ``depth`` and on
``stats``.
"""

from __future__ import annotations

import numpy as np
import pytest

from tikv_tpu.copr.delta import DeltaSink as RefSink
from tikv_tpu.copr.delta import decode_entry_ops as ref_decode
from tikv_tpu.raftstore.cmd import WriteOp as RefWriteOp
from tikv_tpu.raftstore.metapb import Region as RefRegion
from tikv_tpu.raftstore.metapb import RegionEpoch as RefEpoch

from tikv_tpu_torch.codec.keys import data_key, table_record_key
from tikv_tpu_torch.copr.delta import DeltaSink, decode_entry_ops
from tikv_tpu_torch.engine.memory import MemoryEngine
from tikv_tpu_torch.engine.traits import CF_DEFAULT, CF_LOCK, CF_WRITE
from tikv_tpu_torch.raftstore.cmd import WriteOp, write_ops
from tikv_tpu_torch.raftstore.metapb import Region, RegionEpoch
from tikv_tpu_torch.storage.txn_types import (Lock, LockType, Write,
                                              WriteType, append_ts,
                                              encode_key)
from tikv_tpu_torch.testing import mvcc as tm

TID = 9830


def _enc(h: int) -> bytes:
    return encode_key(table_record_key(TID, h))


def _write_op(h: int, commit_ts: int, wt: WriteType, short=b"\x01"):
    w = Write(wt, commit_ts - 1, short if wt is WriteType.PUT else None)
    return WriteOp("put", CF_WRITE, append_ts(_enc(h), commit_ts),
                   w.to_bytes())


def _lock_op(h: int, lt: LockType, start_ts: int = 90):
    rk = table_record_key(TID, h)
    return WriteOp("put", CF_LOCK, _enc(h),
                   Lock(lt, rk, start_ts, ttl=3000).to_bytes())


OP_CASES = {
    "put": [_write_op(1, 100, WriteType.PUT)],
    "put spilled": [_write_op(2, 101, WriteType.PUT, short=None)],
    "put empty row": [_write_op(3, 102, WriteType.PUT, short=b"")],
    "delete": [_write_op(4, 103, WriteType.DELETE)],
    "rollback": [_write_op(5, 104, WriteType.ROLLBACK)],
    "lock record": [_write_op(6, 105, WriteType.LOCK)],
    "lock put": [_lock_op(7, LockType.PUT)],
    "lock delete type": [_lock_op(8, LockType.DELETE)],
    "lock of a read lock": [_lock_op(9, LockType.LOCK)],
    "pessimistic lock": [_lock_op(10, LockType.PESSIMISTIC)],
    "lock released": [WriteOp("delete", CF_LOCK, _enc(11))],
    "default put and delete": [
        WriteOp("put", CF_DEFAULT, append_ts(_enc(12), 99), b"row"),
        WriteOp("delete", CF_DEFAULT, append_ts(_enc(12), 99))],
    "mixed entry": [_lock_op(13, LockType.PUT),
                    WriteOp("delete", CF_LOCK, _enc(13)),
                    _write_op(13, 110, WriteType.PUT),
                    _write_op(14, 111, WriteType.DELETE)],
    "delete range": [WriteOp("delete_range", CF_WRITE, _enc(0), _enc(9))],
    "ingest": [WriteOp("ingest", CF_DEFAULT, b"")],
    "write cf delete": [WriteOp("delete", CF_WRITE,
                                append_ts(_enc(1), 100))],
    "undecodable write": [WriteOp("put", CF_WRITE,
                                  append_ts(_enc(1), 100), b"\xff\x00")],
    "undecodable lock": [WriteOp("put", CF_LOCK, _enc(1), b"")],
    "other cf": [WriteOp("put", "raft", b"k", b"v")],
    "after an op out of the envelope": [
        _write_op(1, 100, WriteType.PUT),
        WriteOp("delete_range", CF_DEFAULT, _enc(0), _enc(9))],
}


def to_ref(ops) -> list:
    return [RefWriteOp(o.op, o.cf, o.key, o.value) for o in ops]


def same_decoded(got, want) -> None:
    if want is None:
        assert got is None
        return
    assert got is not None
    (pr, pl), (rr, rl) = got, want
    assert [(d.enc_key, d.user_key, d.commit_ts, d.start_ts, d.kind,
             d.short_value) for d in pr] == \
        [(d.enc_key, d.user_key, d.commit_ts, d.start_ts, d.kind,
          d.short_value) for d in rr]
    assert [(d.user_key, None if d.lock is None else d.lock.to_bytes())
            for d in pl] == \
        [(d.user_key, None if d.lock is None else d.lock.to_bytes())
         for d in rl]


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_decode_entry_ops_matches_reference(case):
    ops = OP_CASES[case]
    same_decoded(decode_entry_ops(ops), ref_decode(to_ref(ops)))


def test_write_ops_of_a_batch():
    """A write batch's tuples become the entry's ops: the data prefix
    dropped, a range delete's end key as its value, an ingest as one op;
    the tagged binary form round-trips byte-equal to the reference's."""
    eng = MemoryEngine()
    wb = eng.write_batch()
    k = data_key(append_ts(_enc(1), 100))
    wb.put_cf(CF_WRITE, k, b"v")
    wb.delete_cf(CF_LOCK, data_key(_enc(1)))
    wb.delete_range_cf(CF_DEFAULT, data_key(_enc(0)), data_key(_enc(5)))
    wb.ingest_cf(CF_DEFAULT, [data_key(_enc(2))], [b"x"])
    ops = write_ops(wb)
    assert [(o.op, o.cf) for o in ops] == [
        ("put", CF_WRITE), ("delete", CF_LOCK),
        ("delete_range", CF_DEFAULT), ("ingest", CF_DEFAULT)]
    assert ops[0].key == append_ts(_enc(1), 100) and ops[0].value == b"v"
    assert ops[2].key == _enc(0) and ops[2].value == _enc(5)
    for o, r in zip(ops, to_ref(ops)):
        assert o.to_bytes() == r.to_bytes()
        assert WriteOp.from_bytes(o.to_bytes(), 0) == (o, len(o.to_bytes()))
    assert decode_entry_ops(ops) is None


# ---------------------------------------------------------- the sinks


def _put(h: int, ts: int):
    hs = np.asarray([h], np.int64)
    one = np.ones(1, np.bool_)
    trip = tm.kv_history(TID, hs, [tm.Event(ts, tm.WT_PUT, np.arange(1), {
        2: (hs % 7, one), 3: (hs * 3, one)})])
    return _ops(trip)


def _ops(triples) -> list:
    wb = MemoryEngine().write_batch()
    for cf, k, v in triples:
        wb.put_cf(cf, k, v)
    return write_ops(wb)


def _regions(rid: int, version: int = 1, conf_ver: int = 1):
    return (Region(rid, epoch=RegionEpoch(conf_ver, version)),
            RefRegion(rid, epoch=RefEpoch(conf_ver, version)))


class Pair:
    """A port sink and a reference sink fed the same events."""

    def __init__(self, **kw):
        self.p, self.r = DeltaSink(**kw), RefSink(**kw)

    def write(self, rid: int, index: int, ops) -> None:
        self.p.on_apply_write(rid, index, ops)
        self.r.on_apply_write(rid, index, to_ref(ops))

    def rows(self, rid: int, index: int, k: int, ts0: int = 100) -> None:
        """An entry of ``k`` row puts at ``index``."""
        ops = []
        for j in range(k):
            ops += _put(1000 * rid + 10 * index + j, ts0 + index)
        self.write(rid, index, ops)

    def event(self, name: str, *args) -> None:
        getattr(self.p, name)(*(a[0] if isinstance(a, tuple) else a
                                for a in args))
        getattr(self.r, name)(*(a[1] if isinstance(a, tuple) else a
                                for a in args))

    def agree(self, regions, top: int) -> None:
        for rid in regions:
            assert self.p.depth(rid) == self.r.depth(rid), rid
            for i in range(95, top + 2):
                for j in range(i, top + 2):
                    same_decoded(self.p.deltas_between(rid, i, j),
                                 self.r.deltas_between(rid, i, j))
        ps, rs = self.p.stats(), self.r.stats()
        assert {k: ps[k] for k in rs} == rs
        assert ps["depths"] == {rid: self.p.depth(rid)
                                for rid in ps["depths"]}


def seq_entries(s: Pair) -> list:
    for i in range(101, 107):
        s.rows(1, i, 1)
    return [1]


def seq_rows(s: Pair) -> list:
    for i, k in zip(range(101, 106), (2, 3, 1, 4, 2)):
        s.rows(1, i, k)
    return [1]


def seq_replaced(s: Pair) -> list:
    s.rows(1, 101, 2)
    s.rows(1, 102, 1)
    s.event("on_data_replaced", 1, 103)
    s.rows(1, 104, 2)
    return [1]


def seq_epoch(s: Pair) -> list:
    s.rows(1, 101, 1)
    s.event("on_region_changed", _regions(1, 1))       # the first: poisons
    s.rows(1, 102, 1)
    s.rows(1, 103, 1)
    s.event("on_region_changed", _regions(1, 1, 2))    # conf_ver only
    s.rows(1, 104, 1)
    s.event("on_region_changed", _regions(1, 2, 2))    # version: poisons
    s.rows(1, 105, 2)
    return [1]


def seq_split(s: Pair) -> list:
    s.rows(1, 101, 1)
    s.event("on_region_changed", _regions(1, 1))
    s.rows(1, 102, 2)
    s.event("on_region_split", _regions(1, 2), _regions(2, 2), 102, 102)
    s.event("on_region_changed", _regions(1, 2))
    s.rows(1, 103, 1)
    s.rows(2, 104, 1)
    return [1, 2]


def seq_destroy(s: Pair) -> list:
    s.rows(1, 101, 1)
    s.rows(2, 102, 1)
    s.event("on_peer_destroyed", 1)
    s.rows(2, 103, 1)
    s.event("drop_region", 2)
    s.event("drop_region", 3)
    return [1, 2]


def seq_lru(s: Pair) -> list:
    for i, rid in enumerate((1, 2, 3, 1, 4), start=101):
        s.rows(rid, i, 1)
    return [1, 2, 3, 4]


def seq_envelope(s: Pair) -> list:
    s.rows(1, 101, 1)
    s.write(1, 102, OP_CASES["delete range"])
    s.rows(1, 103, 1)
    s.write(1, 104, OP_CASES["mixed entry"])
    return [1]


SEQUENCES = {
    "overflow by entries": (seq_entries, {"max_entries": 3}),
    "overflow by rows": (seq_rows, {"max_rows": 5}),
    "data replaced": (seq_replaced, {}),
    "epoch version against conf_ver": (seq_epoch, {}),
    "split": (seq_split, {}),
    "peer destroyed": (seq_destroy, {}),
    "lru regions": (seq_lru, {"max_regions": 2}),
    "out of the envelope": (seq_envelope, {}),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sinks_agree(name):
    """The same event sequence through both sinks: every
    ``deltas_between`` over (from, to) in [95, top], each region's depth
    and the stats agree."""
    seq, kw = SEQUENCES[name]
    s = Pair(**kw)
    regions = seq(s)
    s.agree(regions, 107)


def test_gauges_follow_the_regions():
    """What the reference exports as gauges: each region's depth, dropped
    with the region (LRU or teardown)."""
    s = Pair(max_regions=2)
    seq_lru(s)
    st = s.p.stats()
    assert st["depths"] == {1: 1, 4: 1} and st["gauges_dropped"] == 3
    s.event("drop_region", 1)
    assert s.p.stats()["depths"] == {4: 1}
