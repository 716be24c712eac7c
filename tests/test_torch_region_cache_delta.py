"""The port's delta bridge (``tikv_tpu_torch/copr/region_cache.py``
``_bridge`` / ``_apply_deltas`` over ``copr/delta.py``'s ``DeltaSink``)
against the reference's, in the shape of ``tests/test_region_cache_delta.py``.

Both packages apply the same committed records (``testing.mvcc.kv_history``,
encoded by the port's ``txn_types``, byte-equal to the reference's) to
their own ``MemoryEngine`` and hand the entry's ops to their own sink, as
the apply path does.  After each write both caches serve the same request,
and must agree: the published tables (rows, tombstones, values), safe_ts
and locks, the counters (``deltas``, ``rebuilds``, ``compactions``,
``misses``), the lineage's journal (structural or not, ``n``, each span's
bounds and rows), the lock checks and the reads served from history.  The
port's published view also equals a fresh build of the same snapshot.
"""

from __future__ import annotations

import numpy as np
import pytest

from tikv_tpu.copr import region_cache as rrc
from tikv_tpu.copr.delta import DeltaSink as RefSink
from tikv_tpu.engine.memory import MemoryEngine as RefEngine
from tikv_tpu.raftstore.cmd import WriteOp as RefWriteOp
from tikv_tpu.raftstore.metapb import Region as RefRegion
from tikv_tpu.raftstore.metapb import RegionEpoch as RefEpoch
from tikv_tpu.raftstore.observer import CoprocessorHost as RefHost
from tikv_tpu.storage.mvcc.errors import KeyIsLocked as RefKeyIsLocked

from tikv_tpu_torch.codec.keys import data_key, table_record_key
from tikv_tpu_torch.codec.row import encode_row
from tikv_tpu_torch.copr import region_cache as prc
from tikv_tpu_torch.copr.delta import DeltaSink
from tikv_tpu_torch.engine.memory import MemoryEngine
from tikv_tpu_torch.engine.traits import CF_DEFAULT, CF_LOCK, CF_WRITE
from tikv_tpu_torch.raftstore.metapb import Region, RegionEpoch
from tikv_tpu_torch.raftstore.observer import CoprocessorHost
from tikv_tpu_torch.storage.mvcc.errors import KeyIsLocked
from tikv_tpu_torch.storage.txn_types import (Write, WriteType, append_ts,
                                              encode_key)
from tikv_tpu_torch.testing import mvcc as tm

from tests.test_torch_region_cache import TID, dags, same_locks, snaps


def _key(h: int) -> bytes:
    return encode_key(table_record_key(TID, h))


class Rig:
    """Both packages' engine, delta sink, cache and observer host over the
    same bytes; region 1 (whole key space) at epoch (1, 1)."""

    def __init__(self, sink_kw=None, cache_kw=None, capacity: int = 4):
        sink_kw = sink_kw or {}
        cache_kw = cache_kw or {}
        self.pe, self.re = MemoryEngine(), RefEngine()
        self.psink, self.rsink = DeltaSink(**sink_kw), RefSink(**sink_kw)
        self.pc = prc.RegionColumnarCache(capacity=capacity,
                                          delta_source=self.psink,
                                          **cache_kw)
        self.rc = rrc.RegionColumnarCache(capacity=capacity,
                                          delta_source=self.rsink,
                                          **cache_kw)
        self.phost, self.rhost = CoprocessorHost(), RefHost()
        self.phost.register(self.psink)
        self.rhost.register(self.rsink)
        self.regions = (Region(1, epoch=RegionEpoch(1, 1)),
                        RefRegion(1, epoch=RefEpoch(1, 1)))
        self.index = 100
        self.ts = 100

    # -- writes ---------------------------------------------------------

    def apply(self, triples) -> None:
        """One applied entry on both packages."""
        self.index += 1
        ops = tm.apply_write(self.pe, self.phost, 1, self.index, triples)
        wb = self.re.write_batch()
        for cf, k, v in triples:
            if v is None:
                wb.delete_cf(cf, k)
            else:
                wb.put_cf(cf, k, v)
        self.re.write(wb)
        self.rhost.notify_apply_write(
            1, self.index, [RefWriteOp(o.op, o.cf, o.key, o.value)
                            for o in ops])

    def tick(self) -> int:
        self.ts += 10
        return self.ts

    def put(self, rows: dict, null_c1=()) -> None:
        """Commit {handle: (c0, c1)} (c1 NULL for ``null_c1``)."""
        hs = np.asarray(sorted(rows), np.int64)
        c0 = np.asarray([rows[h][0] for h in hs.tolist()], np.int64)
        c1 = np.asarray([rows[h][1] for h in hs.tolist()], np.int64)
        ok1 = np.asarray([h not in null_c1 for h in hs.tolist()], np.bool_)
        self.apply(tm.kv_history(TID, hs, [tm.Event(
            self.tick(), tm.WT_PUT, np.arange(len(hs)),
            {2: (c0, np.ones(len(hs), np.bool_)), 3: (c1, ok1)})]))

    def records(self, hs, wtype) -> None:
        """A DELETE, ROLLBACK or LOCK record of each handle."""
        hs = np.asarray(sorted(hs), np.int64)
        self.apply(tm.kv_history(TID, hs, [tm.Event(
            self.tick(), wtype, np.arange(len(hs)))]))

    def prewrite(self, h: int, kind: str = "put") -> int:
        start = self.tick()
        self.apply(tm.kv_history(TID, np.zeros(0, np.int64), [],
                                 [(h, start, kind)]))
        return start

    def commit(self, h: int, start: int, row) -> None:
        """The lock released, the row committed (CF_WRITE record at a new
        commit_ts, its value inline)."""
        commit = self.tick()
        self.apply([(CF_LOCK, data_key(_key(h)), None),
                    (CF_WRITE, data_key(append_ts(_key(h), commit)),
                     Write(WriteType.PUT, start,
                           encode_row({2: row[0], 3: row[1]})).to_bytes())])

    def rollback(self, h: int, start: int) -> None:
        self.apply([(CF_LOCK, data_key(_key(h)), None),
                    (CF_WRITE, data_key(append_ts(_key(h), start)),
                     Write(WriteType.ROLLBACK, start).to_bytes())])

    def spilled(self, h: int, row) -> None:
        """A committed PUT whose row lies in CF_DEFAULT (no short value)."""
        commit = self.tick()
        start = commit - 1
        self.apply([(CF_DEFAULT, data_key(append_ts(_key(h), start)),
                     encode_row({2: row[0], 3: row[1]})),
                    (CF_WRITE, data_key(append_ts(_key(h), commit)),
                     Write(WriteType.PUT, start).to_bytes())])

    # -- reads ----------------------------------------------------------

    def get(self, ts=None, index=None):
        """Both caches' answer to a full scan at ``ts`` (default: above
        every commit) on the snapshot at ``index`` (default: the last)."""
        ts = self.ts + 5 if ts is None else ts
        ps, rs = snaps(self.pe, self.re, self.regions,
                       self.index if index is None else index)
        pd, rd = dags(ts)
        return self.pc.get(ps, pd), self.rc.get(rs, rd), (ps, pd)


def counters(c) -> tuple:
    return (c.hits, c.misses, c.deltas, c.rebuilds, c.compactions)


def same_view(pent, rent) -> None:
    pt, rt = pent._tbl, rent._tbl
    assert np.array_equal(pt.handles, rt.handles)
    assert (pt.alive is None) == (rt.alive is None)
    live = np.ones(len(pt.handles), np.bool_) if pt.alive is None \
        else pt.alive
    if pt.alive is not None:
        assert np.array_equal(pt.alive, rt.alive)
    for cid, col in pt.columns.items():
        rcol = rt.columns[cid]
        assert np.array_equal(col.validity[live], rcol.validity[live]), cid
        assert np.array_equal(np.where(col.validity, col.values, 0)[live],
                              np.where(rcol.validity, rcol.values, 0)[live])
    assert (pent.safe_ts, pent.build_ts) == (rent.safe_ts, rent.build_ts)
    same_locks(pent.blocking_locks, rent.blocking_locks)
    assert pent.estimated_rows() == rent.estimated_rows()


def same_journal(pl, rl) -> None:
    assert pl.version == rl.version
    assert len(pl._patches) == len(rl._patches)
    for p, r in zip(pl._patches, rl._patches):
        assert (p["structural"], p["n"]) == (r["structural"], r["n"])
        if p["structural"]:
            continue
        assert [(s["lo"], s["hi"]) for s in p["spans"]] == \
            [(s["lo"], s["hi"]) for s in r["spans"]]
        for s, t in zip(p["spans"], r["spans"]):
            assert np.array_equal(s["handles"], t["handles"])
            assert sorted(s["cols"]) == sorted(t["cols"])
            for cid, (v, ok) in s["cols"].items():
                rv, rok = t["cols"][cid]
                assert np.array_equal(ok, rok)
                assert np.array_equal(np.where(ok, v, 0),
                                      np.where(rok, rv, 0))


def check(rig: Rig, ts=None):
    """Both caches serve the same request alike; the port's view equals a
    fresh build of the same snapshot → the port's published snapshot."""
    pent, rent, (ps, pd) = rig.get(ts)
    same_view(pent, rent)
    assert counters(rig.pc) == counters(rig.rc)
    same_journal(pent.feed_lineage, rent.feed_lineage)
    scan = pd.executors[0]
    tbl, safe, locks = prc.build_region_columnar(
        ps, TID, scan.columns, pd.start_ts)
    got = pent.scan_columns(scan, pd.ranges)
    want = tbl.scan_columns(scan, pd.ranges)
    assert got.num_rows == want.num_rows == pent.estimated_rows()
    for g, w in zip(got.columns, want.columns):
        assert np.array_equal(g.validity, w.validity)
        assert np.array_equal(np.where(g.validity, g.values, 0),
                              np.where(w.validity, w.values, 0))
    assert pent.safe_ts == safe
    same_locks(pent.blocking_locks, locks)
    return pent


@pytest.fixture
def rig():
    return Rig(sink_kw={"max_entries": 4096})


def rows_of(hs, f=lambda h: (h % 5, h * 10)) -> dict:
    return {int(h): f(int(h)) for h in hs}


# ------------------------------------------------------------ the bridge


def test_append_patches_without_rebuild(rig):
    rig.put(rows_of(range(40)))
    ent0 = check(rig)
    assert (rig.pc.misses, rig.pc.deltas) == (1, 0)
    rig.put({40: (1, 400)})
    ent1 = check(rig)
    assert (rig.pc.misses, rig.pc.deltas) == (1, 1)
    assert ent1.feed_lineage is ent0.feed_lineage
    assert ent1.feed_lineage.version == 1
    (patch,) = ent1.feed_lineage._patches
    assert not patch["structural"] and patch["n"] == 41
    assert [(s["lo"], s["hi"]) for s in patch["spans"]] == [(40, 41)]
    assert ent0.estimated_rows() == 40 and ent1.estimated_rows() == 41


def test_update_delete_and_revive(rig):
    rig.put(rows_of(range(20), lambda h: (h, h)))
    check(rig)
    rig.put({7: (70, 700)})
    check(rig)
    rig.records([3], tm.WT_DELETE)
    ent = check(rig)
    assert ent.estimated_rows() == 19 and ent._tbl.alive is not None
    assert ent.feed_lineage._patches[-1]["structural"]
    rig.put({3: (33, 333)})
    ent = check(rig)
    assert ent.estimated_rows() == 20 and ent._tbl.alive is None
    assert (rig.pc.misses, rig.pc.deltas) == (1, 3)


def test_update_with_null_and_runs_merge_into_spans(rig):
    """Updates within 32 rows of each other share a span; a NULL cell is
    written with its validity; four runs far apart are four spans."""
    rig.put(rows_of(range(400)))
    check(rig)
    upd = {h: (1, -h) for r in range(4) for h in range(100 * r, 100 * r + 8)}
    upd[10] = (2, 0)
    rig.put(upd, null_c1={5, 10})
    ent = check(rig)
    spans = ent.feed_lineage._patches[-1]["spans"]
    assert [(s["lo"], s["hi"]) for s in spans] == \
        [(0, 11), (100, 108), (200, 208), (300, 308)]


def test_mid_insert_repacks(rig):
    rig.put(rows_of(range(0, 40, 2)))
    check(rig)
    rig.put({7: (7, 7)})
    ent = check(rig)
    assert (rig.pc.deltas, rig.pc.misses, rig.pc.compactions) == (1, 1, 1)
    assert 7 in ent._tbl.handles.tolist()


def test_lock_conflict_parity_under_delta(rig):
    rig.put(rows_of(range(10)))
    check(rig)
    start = rig.prewrite(4)
    with pytest.raises(KeyIsLocked):
        rig.pc.get(*reversed(rig_snap_dag(rig, "p")))
    with pytest.raises(RefKeyIsLocked):
        rig.rc.get(*reversed(rig_snap_dag(rig, "r")))
    assert counters(rig.pc) == counters(rig.rc)
    rig.commit(4, start, (1, 1))
    check(rig)


def rig_snap_dag(rig: Rig, side: str):
    ps, rs = snaps(rig.pe, rig.re, rig.regions, rig.index)
    pd, rd = dags(rig.ts + 5)
    return (pd, ps) if side == "p" else (rd, rs)


def test_rollback_advances_safe_ts_like_a_rebuild(rig):
    rig.put(rows_of(range(8)))
    check(rig)
    start = rig.prewrite(2)
    rig.rollback(2, start)
    ent = check(rig)
    assert ent.safe_ts == start and rig.pc.misses == 1
    patch = ent.feed_lineage._patches[-1]
    assert patch == {"structural": False, "n": 8, "spans": []}


def test_slack_exhaustion_compacts(rig, monkeypatch):
    monkeypatch.setattr(prc._LineState, "SLACK_MIN", 4)
    monkeypatch.setattr(rrc._LineState, "SLACK_MIN", 4)
    rig.put(rows_of(range(10)))
    check(rig)
    for start in range(10, 40, 3):
        rig.put(rows_of(range(start, start + 3)))
        check(rig)
    assert rig.pc.misses == 1 and rig.pc.compactions >= 1


def test_tombstone_ratio_triggers_compaction():
    rig = Rig(sink_kw={"max_entries": 4096},
              cache_kw={"compact_ratio": 0.2})
    rig.put(rows_of(range(20)))
    check(rig)
    for h in range(0, 10, 2):
        rig.records([h], tm.WT_DELETE)
        ent = check(rig)
    assert rig.pc.compactions >= 1 and ent._tbl.alive is None
    assert rig.pc.misses == 1


def test_delta_log_overflow_falls_back_to_rebuild():
    rig = Rig(sink_kw={"max_entries": 2})
    rig.put(rows_of(range(10)))
    check(rig)
    for h in range(10, 16):
        rig.put({h: (h, h)})
    check(rig)
    assert (rig.pc.rebuilds, rig.pc.deltas) == (1, 0)
    rig.put({99: (9, 9)})
    check(rig)
    assert rig.pc.deltas == 1


@pytest.mark.parametrize("op", ["delete_range", "ingest"])
def test_out_of_envelope_entry_rebuilds(rig, op):
    """An entry with a range delete or an ingest poisons coverage: the
    next read rebuilds on both, and later writes bridge again."""
    rig.put(rows_of(range(12)))
    check(rig)
    rig.index += 1
    p = MemoryEngine().write_batch()
    if op == "delete_range":
        p.delete_range_cf(CF_DEFAULT, data_key(_key(100)),
                          data_key(_key(101)))
    else:
        p.ingest_cf(CF_DEFAULT, [data_key(_key(200))], [b"x"])
    from tikv_tpu_torch.raftstore.cmd import write_ops
    ops = write_ops(p)
    rig.phost.notify_apply_write(1, rig.index, ops)
    rig.rhost.notify_apply_write(1, rig.index, [
        RefWriteOp(o.op, o.cf, o.key, o.value) for o in ops])
    check(rig)
    assert (rig.pc.rebuilds, rig.pc.deltas) == (1, 0)
    rig.put({3: (0, 0)})
    check(rig)
    assert rig.pc.deltas == 1


def test_epoch_change_builds_a_fresh_line(rig):
    """A new epoch version is a new line key: its first read builds."""
    rig.put(rows_of(range(30)))
    check(rig)
    rig.regions = (Region(1, epoch=RegionEpoch(1, 2)),
                   RefRegion(1, epoch=RefEpoch(1, 2)))
    rig.phost.notify_region_changed(rig.regions[0])
    rig.rhost.notify_region_changed(rig.regions[1])
    rig.put({5: (0, 0)})
    check(rig)
    assert (rig.pc.misses, rig.pc.deltas) == (2, 0)


def test_spilled_value_delta_reads_the_default_cf(rig):
    """A PUT without a short value arrives with ``short_value`` None: the
    patch reads its row from CF_DEFAULT of the snapshot it bridges to."""
    rig.put(rows_of(range(10)))
    check(rig)
    rig.spilled(10, (4, 44))
    rig.spilled(3, (5, 55))
    ent = check(rig)
    assert rig.pc.deltas == 1 and rig.pc.misses == 1
    assert int(ent._tbl.columns[3].values[3]) == 55


def test_history_serves_reads_below_the_superseding_commit(rig):
    """After a write, a read below its commit_ts is served by the
    superseded generation from the line's history (no build), its locks
    checked against the newest set; a read at or above it by the new one."""
    rig.put(rows_of(range(30)))
    ent0 = check(rig)
    read_old = rig.ts + 5
    rig.put({2: (9, 99)})
    ent1 = check(rig)
    pent, rent, _ = rig.get(ts=read_old)
    assert pent is ent0 and rent._tbl.handles is not None
    assert pent.superseded_at == rig.ts == rent.superseded_at
    same_view(pent, rent)
    assert counters(rig.pc) == counters(rig.rc)
    assert rig.pc.misses == 1
    assert int(pent._tbl.columns[3].values[2]) == 20
    assert int(ent1._tbl.columns[3].values[2]) == 99


def test_lagging_parent_is_bridged_before_a_split(rig):
    """A parent line behind ``left_index`` is bridged forward, then sliced:
    the split gives a spec, and the children equal the reference's."""
    rig.put(rows_of(range(40)))
    check(rig)
    rig.put({41: (1, 1), 5: (2, 2)})        # not read before the split
    mid = _key(20)
    pl = Region(1, b"", mid, RegionEpoch(1, 2))
    pr = Region(2, mid, b"", RegionEpoch(1, 2))
    rl = RefRegion(1, b"", mid, RefEpoch(1, 2))
    rr = RefRegion(2, mid, b"", RefEpoch(1, 2))
    pspecs = rig.pc.split_lines(pl, pr, rig.index, rig.index)
    rspecs = rig.rc.split_lines(rl, rr, rig.index, rig.index)
    assert len(pspecs) == len(rspecs) == 1
    # the split's bridge is not a request's: neither counts it
    assert rig.pc.deltas == rig.rc.deltas == 0
    (p,), (r,) = pspecs, rspecs
    assert (p["pos"], p["n_parent"], p["parent_version"]) == \
        (r["pos"], r["n_parent"], r["parent_version"]) == (20, 41, 1)
    for side in ("left", "right"):
        assert p[side]["n"] == r[side]["n"]
        same_view(p[side]["state"].publish(), r[side]["state"].publish())


# ------------------------------------------------------------ property


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta_vs_rebuild_randomized(monkeypatch, seed):
    """Random interleavings of multi-row inserts (appends and
    mid-inserts), updates (some NULL), deletes and rollbacks, under a small
    slack and an aggressive tombstone ratio: after every round both caches
    agree, and the port's view equals a fresh build."""
    monkeypatch.setattr(prc._LineState, "SLACK_MIN", 8)
    monkeypatch.setattr(rrc._LineState, "SLACK_MIN", 8)
    rig = Rig(sink_kw={"max_entries": 4096},
              cache_kw={"compact_ratio": 0.3})
    rng = np.random.default_rng(seed)
    first = [int(h) for h in rng.choice(200, size=30, replace=False)]
    rig.put({h: (h % 7, h) for h in first})
    live = set(first)
    check(rig)
    for _round in range(60):
        kind = rng.random()
        if kind < 0.45 or not live:
            base = max(live) + 1 if live and rng.random() < 0.5 else 0
            new = {}
            for _ in range(int(rng.integers(1, 4))):
                h = int(base + rng.integers(0, 300))
                if h not in live:
                    new[h] = (h % 7, h)
            if new:
                rig.put(new)
                live.update(new)
        elif kind < 0.7:
            hs = rng.choice(sorted(live), size=min(len(live), int(
                rng.integers(1, 4))), replace=False)
            vals = {int(h): (int(v) % 7, int(v)) for h, v in
                    zip(hs, rng.integers(0, 1000, len(hs)))}
            rig.put(vals, null_c1={h for h in vals if h % 3 == 0})
        elif kind < 0.9:
            hs = [int(h) for h in rng.choice(sorted(live), size=min(
                len(live), int(rng.integers(1, 3))), replace=False)]
            rig.records(hs, tm.WT_DELETE)
            live.difference_update(hs)
        else:
            h = int(rng.choice(sorted(live)))
            rig.rollback(h, rig.prewrite(h))
        ent = check(rig)
        assert ent.estimated_rows() == len(live)
    assert rig.pc.deltas >= 45, counters(rig.pc)
