"""The port's streaming cold build (``tikv_tpu_torch/copr/stream_build.py``
``ColdStreamBuilder``) against the JAX package's, in the shape of
``tests/test_device_mvcc.py``'s streaming cases (without the gRPC twin).

SST v2 blobs (``fast_mvcc_table_sst``) are applied to the port's engine
through the apply path (``testing.mvcc.apply_ingest``: the engine write,
then the observers) with a stream registered on the host; the reference's
stream observes the same blobs.  A chunked stream's bundle mints the same
feed, byte for byte and digests included, as a parse at build time and as
the reference's stream; the device-plane leg, forced on the CPU, mints the
same feed from planes already resident; a plain write, a snapshot apply, a
region change, a destroyed peer or a mismatched snapshot drops the stream
or misses; two versions of one key straddling chunks are refused; a
failure of the worker raises at the take; and after an ingest the cache
rebuilds instead of bridging.
"""

import threading
import time

import jax
import numpy as np
import pytest

import tikv_tpu.copr.region_cache as rrc
from tikv_tpu.copr.stream_build import ColdStreamBuilder as RefStream
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.engine.memory import MemoryEngine as RefEngine
from tikv_tpu.parallel import make_mesh
from tikv_tpu.raftstore.metapb import Region as RefRegion
from tikv_tpu.raftstore.peer import RegionSnapshot as RefRegionSnapshot
from tikv_tpu.sst_importer import read_sst_cf as ref_read_sst_cf
from tikv_tpu.testing.fixture import int_table

from tikv_tpu_torch.codec.keys import data_key
from tikv_tpu_torch.copr import region_cache as prc
from tikv_tpu_torch.copr.delta import DeltaSink
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.copr.stream_build import ColdStreamBuilder
from tikv_tpu_torch.device import mvcc as pm
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.engine.memory import MemoryEngine
from tikv_tpu_torch.raftstore.cmd import WriteOp
from tikv_tpu_torch.raftstore.metapb import Region
from tikv_tpu_torch.raftstore.observer import CoprocessorHost
from tikv_tpu_torch.raftstore.peer import RegionSnapshot
from tikv_tpu_torch.sst_importer import fast_mvcc_table_sst
from tikv_tpu_torch.testing import mvcc as tm
from tikv_tpu_torch.utils import tracker

from tests.test_torch_mvcc import _same_feed
from tests.test_torch_native import infos_of

BIG = 10 ** 9
RID = 5


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def port():
    return DeviceRunner(device="cpu")


def chunks(n: int, tid: int, n_chunks: int, commit_ts: int = 100,
           start: int = 0) -> list:
    hs = np.arange(start, start + n, dtype=np.int64)
    sub = -(-n // n_chunks)
    return [fast_mvcc_table_sst(tid, h, [(2, h % 7, None),
                                         (3, h % 13, None)],
                                commit_ts=commit_ts)
            for h in (hs[s:s + sub] for s in range(0, n, sub))]


class Rig:
    """The port's engine, observer host and (optionally) stream, and the
    reference's engine and stream over the same applied blobs."""

    def __init__(self, port, ref=None, stream: bool = True, **stream_kw):
        self.engine, self.host = MemoryEngine(), CoprocessorHost()
        self.stream = ColdStreamBuilder(port.mvcc_resolver(), **stream_kw) \
            if stream else None
        if self.stream is not None:
            self.host.register(self.stream)
        self.rengine = RefEngine()
        self.rstream = RefStream(ref.mvcc_resolver()) \
            if ref is not None and stream else None
        self.index = 9

    def ingest(self, blob) -> None:
        self.index += 1
        tm.apply_ingest(self.engine, self.host, RID, self.index, blob)
        wb = self.rengine.write_batch()
        for cf, (keys, vals) in ref_read_sst_cf(blob).items():
            wb.ingest_cf(cf, [data_key(k) for k in keys], vals)
        self.rengine.write(wb)
        if self.rstream is not None:
            from tikv_tpu.raftstore.cmd import WriteOp as RefWriteOp
            self.rstream.on_apply_write(RID, self.index, [
                RefWriteOp("ingest", "", b"", blob)])

    def drain(self) -> None:
        if self.stream is not None:
            assert self.stream.wait_idle(20.0)
        if self.rstream is not None:
            end = time.monotonic() + 20.0
            while self.rstream._inflight and time.monotonic() < end:
                time.sleep(0.01)
            assert not self.rstream._inflight

    def snap(self, data_index=None):
        rs = RegionSnapshot(self.engine.snapshot(), Region(RID))
        rs.data_index = self.index if data_index is None else data_index
        return rs

    def rsnap(self):
        rs = RefRegionSnapshot(self.rengine.snapshot(), RefRegion(RID))
        rs.data_index = self.index
        return rs

    def stop(self) -> None:
        for s in (self.stream, self.rstream):
            if s is not None:
                s.stop()


def build(port, snap, tid, stream):
    tr, tok = tracker.install()
    try:
        out = prc.build_region_columnar_ex(
            snap, tid, infos_of(int_table(2, table_id=tid), True), BIG,
            device_resolver=port.mvcc_resolver(), stream_source=stream)
    finally:
        tracker.uninstall(tok)
    return out, tr


def mint(runner, bundle, tid, port_side=True):
    infos = list(infos_of(int_table(2, table_id=tid), port_side))
    n = bundle.n
    return bundle.mint(runner, infos, ["int64"] * 3, n, runner._pad_rows(n))


@pytest.mark.parametrize("n_chunks", (1, 3, 5))
def test_chunked_stream_feed_is_byte_identical(ref, port, n_chunks):
    """A stream of 1, 3 or 5 chunks: the same host table and the same
    minted feed, digests included, as a parse at build time and as the
    reference's stream of the same blobs."""
    n, tid = 3000, 8800
    rig = Rig(port, ref)
    try:
        for blob in chunks(n, tid, n_chunks):
            rig.ingest(blob)
        rig.drain()
        assert rig.stream.stats()["chunks_parsed"] == n_chunks
        (tbl, safe, _l, bundle), tr = build(port, rig.snap(), tid,
                                            rig.stream)
        assert "stream_take" in tr.phases and "mvcc_parse" not in tr.phases
        st = rig.stream.stats()
        assert (st["takes"], st["take_misses"]) == (1, 0)
        assert bundle.device is None        # no device leg on the CPU
        (tbl0, safe0, _l, bundle0), tr = build(port, rig.snap(), tid, None)
        assert "mvcc_parse" in tr.phases
        rt, rsafe, _l, rbundle = rrc.build_region_columnar_ex(
            rig.rsnap(), tid, infos_of(int_table(2, table_id=tid), False),
            BIG, device_resolver=ref.mvcc_resolver(),
            stream_source=rig.rstream)
        assert rig.rstream.takes == 1
        assert safe == safe0 == rsafe == 100
        assert np.array_equal(tbl.handles, tbl0.handles) and \
            np.array_equal(tbl.handles, rt.handles)
        got = mint(port, bundle, tid)
        _same_feed(got, mint(port, bundle0, tid))
        _same_feed(got, mint(ref, rbundle, tid, port_side=False))
    finally:
        rig.stop()


def test_device_plane_leg_forced_on_the_cpu(port, monkeypatch):
    """The device leg (``DeviceVersionPlanes`` appends) forced on: the mint
    reads the resident planes (no upload at the mint) and gives the feed
    of the upload at the mint."""
    monkeypatch.setattr(pm.DeviceMvccResolver, "h2d_profitable",
                        lambda self: True)
    n, tid = 2500, 8802
    rig = Rig(port)
    try:
        for blob in chunks(n, tid, 3):
            rig.ingest(blob)
        rig.drain()
        st = rig.stream.stats()
        assert st["regions"][RID]["device"] and st["h2d_bytes"] > 0
        (tbl, _s, _l, bundle), _tr = build(port, rig.snap(), tid,
                                           rig.stream)
        assert bundle.device is not None and bundle.device.n_ver == n
        feed_dev = mint(port, bundle, tid)
        assert port.mvcc_resolver().phases_ms["h2d"] == 0.0
    finally:
        rig.stop()
    (_t, _s, _l, bundle), _tr = build(port, rig.snap(), tid, None)
    assert bundle.device is None
    _same_feed(feed_dev, mint(port, bundle, tid))


def test_a_failed_device_leg_raises_at_the_take(port, monkeypatch):
    """A failure of the worker is not a miss: the cold build raises it."""
    monkeypatch.setattr(pm.DeviceMvccResolver, "h2d_profitable",
                        lambda self: True)

    def broken(self, planes):
        raise RuntimeError("device copy failed")

    monkeypatch.setattr(pm.DeviceVersionPlanes, "append", broken)
    tid = 8804
    rig = Rig(port)
    try:
        rig.ingest(chunks(200, tid, 1)[0])
        rig.drain()
        assert rig.stream.stats()["failures"] == 1
        with pytest.raises(RuntimeError, match="cold stream") as e:
            build(port, rig.snap(), tid, rig.stream)
        assert "device copy failed" in str(e.value.__cause__)
        # raised once: the next build parses
        (_t, _s, _l, bundle), tr = build(port, rig.snap(), tid, rig.stream)
        assert bundle is not None and "mvcc_parse" in tr.phases
    finally:
        rig.stop()


@pytest.mark.parametrize("event", ("write", "data_replaced",
                                   "region_changed", "peer_destroyed"))
def test_stream_drops_on_lifecycle_events(port, event):
    tid = 8801
    rig = Rig(port)
    try:
        rig.ingest(chunks(500, tid, 1)[0])
        rig.drain()
        assert RID in rig.stream.stats()["regions"]
        if event == "write":
            tm.apply_write(rig.engine, rig.host, RID, rig.index + 1, [])
            rig.stream.on_apply_write(RID, rig.index + 1, [
                WriteOp("put", "write", b"k", b"v")])
        elif event == "data_replaced":
            rig.host.notify_data_replaced(RID, rig.index + 1)
        elif event == "region_changed":
            rig.host.notify_region_changed(Region(RID))
        else:
            rig.host.notify_peer_destroyed(RID)
        rig.drain()
        st = rig.stream.stats()
        assert st["regions"] == {} and st["regions_dropped"] == 1
        # not streamed any more: cold, not a miss
        assert rig.stream.take(RID, tid, rig.index, 500, b"a", b"b") is None
        assert rig.stream.take_misses == 0
    finally:
        rig.stop()


def test_a_mismatched_snapshot_misses(port):
    tid = 8805
    rig = Rig(port)
    try:
        for blob in chunks(600, tid, 2):
            rig.ingest(blob)
        rig.drain()
        snap = rig.snap(data_index=999)     # another data version
        (_t, _s, _l, bundle), tr = build(port, snap, tid, rig.stream)
        assert bundle is not None and "mvcc_parse" in tr.phases
        assert rig.stream.take_misses == 1 and rig.stream.takes == 0
        # one-shot: the stream was consumed by the miss
        assert rig.stream.take(RID, tid, rig.index, 600, b"", b"") is None
        assert rig.stream.take_misses == 1
    finally:
        rig.stop()


def test_stream_rejects_key_versions_straddling_chunks(port):
    """Two versions of one user key split across chunks: raw keys still
    ascend (the commit_ts is inverted), but concatenating would make a
    second segment of the key; the stream refuses the chunk."""
    tid = 8803
    blob1 = fast_mvcc_table_sst(tid, np.arange(100, dtype=np.int64),
                                [(2, np.zeros(100, np.int64), None)], 200)
    blob2 = fast_mvcc_table_sst(tid, np.asarray([99], dtype=np.int64),
                                [(2, np.ones(1, np.int64), None)], 100)
    rig = Rig(port)
    try:
        rig.ingest(blob1)
        rig.ingest(blob2)
        rig.drain()
        assert rig.stream.chunks_rejected == 1
        (tbl, _s, _l, bundle), tr = build(port, rig.snap(), tid, rig.stream)
        assert "mvcc_parse" in tr.phases and len(tbl) == 100
        assert int(tbl.columns[2].values[99]) == 0      # the newer version
    finally:
        rig.stop()


def test_capacity_and_lag_bounds(port):
    """At ``max_regions`` streams no new region starts one; a region whose
    worker lags ``max_lag`` entries is dropped."""
    stream = ColdStreamBuilder(port.mvcc_resolver(), max_regions=1,
                               max_lag=2)
    blobs = chunks(400, 8806, 4)
    try:
        stream.on_apply_write(1, 10, [WriteOp("ingest", "", b"",
                                              blobs[0])])
        assert stream.wait_idle(20.0)
        stream.on_apply_write(2, 10, [WriteOp("ingest", "", b"",
                                              blobs[0])])
        assert stream.wait_idle(20.0)
        assert set(stream.stats()["regions"]) == {1}
        # hold the worker while entries queue up
        gate = threading.Event()
        work = stream._ingest
        stream._ingest = lambda *a: (gate.wait(20.0), work(*a))
        for i, b in enumerate(blobs[1:]):
            stream.on_apply_write(1, 11 + i, [WriteOp("ingest", "", b"", b)])
        gate.set()
        assert stream.wait_idle(20.0)
        assert stream.stats()["regions"] == {}
    finally:
        stream.stop()


def test_an_ingest_rebuilds_instead_of_bridging(port):
    """An ingest is outside the delta sink's envelope: the next read after
    it rebuilds (device rung, fresh parse) and never bridges."""
    tid = 8807
    sink = DeltaSink()
    rig = Rig(port)
    rig.host.register(sink)
    cache = prc.RegionColumnarCache(delta_source=sink)
    cache.device_resolver = port.mvcc_resolver()
    cache.stream_source = rig.stream
    ep = Endpoint(lambda r: cache.get(rig.snap(), r.dag), port,
                  device_row_threshold=1)
    table = tm.table_6c()
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing.dag import DagSelect

    def ask(n_rows):
        s = DagSelect.from_table(table, ["id", "c0", "c1"])
        d = s.aggregate([], [("count_star", None), ("sum", s.col("c1"))])
        resp = ep.handle(CopRequest(REQ_TYPE_DAG, dag_from_wire(enc_dag(
            d.build(BIG))), force_backend="device"))
        hs = np.arange(n_rows)
        assert [list(r) for r in resp.rows()] == [
            [n_rows, int((hs % 13).sum())]]
        return resp.tracker

    try:
        first = chunks(1000, table.table_id, 2)
        for blob in first:
            rig.ingest(blob)
        rig.drain()
        tr = ask(1000)
        assert tr.labels["copr_cache"] == "build"
        assert tr.labels["cold_build"] == "device"
        assert "stream_take" in tr.phases
        rig.ingest(chunks(500, table.table_id, 1, start=1000)[0])
        rig.drain()
        tr = ask(1500)
        assert tr.labels["copr_cache"] == "build"
        assert "delta_apply" not in tr.phases or cache.deltas == 0
        assert cache.deltas == 0 and cache.rebuilds == 1
        assert cache.stats()["device_builds"] == 2
    finally:
        rig.stop()
