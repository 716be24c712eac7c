"""The port's bulk-load artifact (``tikv_tpu_torch/sst_importer.py``) and
its apply entry (``raftstore.cmd.exec_write_ops``, ``testing.mvcc.
apply_ingest``) against the JAX package's ``sst_importer.py`` and
``raftstore/peer.py`` ``_exec_write``: the same blobs byte for byte, the
same decodes, the same refusals, and an engine holding the same records
after an ingest.
"""

import numpy as np
import pytest

from tikv_tpu import sst_importer as rsi
from tikv_tpu.engine.memory import MemoryEngine as RefEngine

from tikv_tpu_torch import sst_importer as psi
from tikv_tpu_torch.engine.memory import MemoryEngine
from tikv_tpu_torch.engine.traits import ALL_CFS
from tikv_tpu_torch.raftstore.cmd import WriteOp, exec_write_ops
from tikv_tpu_torch.raftstore.observer import CoprocessorHost, Observer
from tikv_tpu_torch.testing import mvcc as tm
from tikv_tpu_torch.utils import failpoint


def columns(rng, n: int, kind: str):
    if kind == "floats":
        return [(2, rng.normal(size=n), rng.random(n) < 0.9),
                (3, rng.integers(-9, 9, n), None)]
    if kind == "wide":      # past a map16 header: the row-by-row encoder
        return [(2 + i, np.arange(n) * i, None) for i in range(17)]
    return [(2, rng.integers(0, 1024, n), None),
            (3, rng.integers(-(1 << 40), 1 << 40, n), rng.random(n) < 0.7)]


@pytest.mark.parametrize("kind", ("ints", "floats", "wide"))
@pytest.mark.parametrize("n", (1, 257))
def test_fast_mvcc_table_sst_matches_reference(kind, n):
    rng = np.random.default_rng(n)
    hs = np.sort(rng.choice(1 << 30, n, replace=False)).astype(np.int64)
    cols = columns(rng, n, kind)
    blob = psi.fast_mvcc_table_sst(77, hs, cols, 300)
    assert blob == rsi.fast_mvcc_table_sst(77, hs, cols, 300)
    assert psi.is_sst_v2(blob)
    got = psi.read_sst_cf(blob)
    assert got == rsi.read_sst_cf(blob)
    assert psi.read_sst(blob) == rsi.read_sst(blob)
    assert len(got["write"][0]) == n


def test_v1_and_v2_containers_round_trip():
    rows = [(b"t\x80" + bytes([i]), b"v" * (i * 30)) for i in range(12)]
    w, rw = psi.mvcc_sst(rows, 50), rsi.mvcc_sst(rows, 50)
    assert len(w) == len(rw) > len(rows)    # the long values spill
    blob = w.finish()
    assert blob == rw.finish()
    assert psi.read_sst(blob) == rsi.read_sst(blob)
    by_cf: dict = {}
    for cf, k, v in psi.read_sst(blob):
        got = by_cf.setdefault(cf, ([], []))
        got[0].append(k)
        got[1].append(v)
    v2 = psi.build_sst_v2(by_cf)
    assert v2 == rsi.build_sst_v2(by_cf)
    assert psi.read_sst_cf(v2) == {cf: tuple(kv) for cf, kv in
                                   by_cf.items()}
    assert sorted(psi.read_sst(v2)) == sorted(psi.read_sst(blob))


@pytest.mark.parametrize("flaw", ("magic", "crc", "order", "duplicate",
                                  "length"))
def test_a_bad_blob_raises_as_the_reference(flaw):
    keys = [b"a", b"b", b"c"]
    good = psi.build_sst_v2({"write": (keys, [b"1", b"2", b"3"])})
    if flaw == "magic":
        blob = b"XKVSST2\n" + good[8:]
    elif flaw == "crc":
        blob = good[:-1] + bytes([good[-1] ^ 1])
    elif flaw == "order":
        blob = psi.build_sst_v2({"write": ([b"b", b"a"], [b"1", b"2"])})
    elif flaw == "duplicate":
        blob = psi.build_sst_v2({"write": ([b"a", b"a"], [b"1", b"2"])})
    else:
        import msgpack
        body = msgpack.packb([["write", [b"a"], []]], use_bin_type=True)
        import struct
        import zlib
        blob = b"TKVSST2\n" + body + struct.pack(">I", zlib.crc32(body))
    with pytest.raises(ValueError) as want:
        rsi.read_sst_cf(blob)
    with pytest.raises(ValueError) as got:
        psi.read_sst_cf(blob)
    assert str(got.value) == str(want.value)
    if flaw in ("order", "duplicate"):
        # a consumer re-reading an admitted blob skips the check
        assert psi.read_sst_cf(blob, validate=False)["write"][0] == \
            rsi.read_sst_cf(blob, validate=False)["write"][0]


def test_ingest_parse_memo_hands_the_apply_decode_over():
    blob = psi.fast_mvcc_table_sst(5, np.arange(10), [(2, np.arange(10),
                                                       None)], 100)
    # without a consumer nothing is kept
    first = psi.read_sst_cf(blob, memo=True)
    assert psi.pop_ingest_parse(blob) is None
    psi.enable_ingest_parse_memo(True)
    try:
        got = psi.read_sst_cf(blob, memo=True)
        assert got == first
        assert psi.pop_ingest_parse(blob) is got        # the same object
        assert psi.pop_ingest_parse(blob) is None       # one-shot
        # a read without memo keeps nothing; an equal but distinct blob
        # object never hits
        psi.read_sst_cf(blob)
        assert psi.pop_ingest_parse(blob) is None
        psi.read_sst_cf(blob, memo=True)
        assert psi.pop_ingest_parse(bytes(bytearray(blob))) is None
        # bounded: the oldest entries are evicted
        blobs = [psi.fast_mvcc_table_sst(5, np.arange(i + 1), [], 100)
                 for i in range(4)]
        for b in blobs:
            psi.read_sst_cf(b, memo=True)
        assert psi.pop_ingest_parse(blobs[0]) is None
        assert psi.pop_ingest_parse(blobs[-1]) is not None
    finally:
        psi.enable_ingest_parse_memo(False)
    assert not psi._INGEST_MEMO


class _Ops(Observer):
    def __init__(self):
        self.seen = []

    def on_apply_write(self, region_id, index, ops):
        self.seen.append((region_id, index, list(ops)))


def engine_records(eng, ref: bool) -> list:
    snap = eng.snapshot()
    out = []
    for cf in ALL_CFS:
        keys, vals, _ = snap.range_cf(cf, b"", b"\xff" * 64)
        out.append((cf, list(keys), list(vals)))
    return out


def test_ingest_through_the_apply_path_matches_reference():
    """``exec_write_ops`` lands every CF group of the blob under the data
    prefix, as the reference's apply arm does, and ``apply_ingest``
    notifies the entry's one ingest op; puts, deletes and range deletes
    take the same arm."""
    rng = np.random.default_rng(3)
    hs = np.arange(0, 600, 3, dtype=np.int64)
    blob = psi.fast_mvcc_table_sst(8, hs, columns(rng, len(hs), "ints"),
                                   100)
    pe, re = MemoryEngine(), RefEngine()
    host = CoprocessorHost()
    obs = _Ops()
    host.register(obs)
    ops = tm.apply_ingest(pe, host, 1, 7, blob)
    assert ops == [WriteOp("ingest", "", b"", blob)]
    assert obs.seen == [(1, 7, ops)]
    from tikv_tpu.codec.keys import data_key
    wb = re.write_batch()
    for cf, (keys, vals) in rsi.read_sst_cf(blob).items():
        wb.ingest_cf(cf, [data_key(k) for k in keys], vals)
    re.write(wb)
    assert engine_records(pe, False) == engine_records(re, True)
    # the other data ops
    wb = pe.write_batch()
    exec_write_ops(wb, [WriteOp("put", "default", b"k1", b"v1"),
                        WriteOp("put", "default", b"k2", b"v2"),
                        WriteOp("delete", "default", b"k1"),
                        WriteOp("delete_range", "write", b"", b"\xff")])
    pe.write(wb)
    recs = dict((cf, (k, v)) for cf, k, v in engine_records(pe, False))
    assert recs["write"] == ([], [])
    assert recs["default"] == ([b"zk2"], [b"v2"])
    with pytest.raises(ValueError):
        exec_write_ops(pe.write_batch(), [WriteOp("merge", "default", b"k")])


def test_before_ingest_failpoint_refuses_the_entry():
    blob = psi.fast_mvcc_table_sst(8, np.arange(4), [], 100)
    eng = MemoryEngine()
    failpoint.cfg("apply::before_ingest", "1*return")
    try:
        with pytest.raises(OSError):
            tm.apply_ingest(eng, CoprocessorHost(), 1, 2, blob)
    finally:
        failpoint.teardown()
    assert engine_records(eng, False)[2][1] == []
    tm.apply_ingest(eng, CoprocessorHost(), 1, 3, blob)
    assert len(engine_records(eng, False)[2][1]) == 4
