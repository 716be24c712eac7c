"""The port's columnar cache lines, split lines and feed arena against the
reference's (``tikv_tpu/copr/region_cache.py``, ``device/supervisor.py``
``FeedArena``).

Both caches build from the same engine bytes: the MVCC records of one
seeded history (``testing.mvcc.kv_history``, encoded by the port's
``txn_types``, byte-equal to the reference's) written into each package's
``MemoryEngine`` (the port's through ``convert.engine_from_triples``).
Each test runs the same calls on both and compares what they return.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import pytest
import torch

from tikv_tpu.copr import region_cache as rrc
from tikv_tpu.device.supervisor import FeedArena as RefArena
from tikv_tpu.engine.memory import MemoryEngine as RefEngine
from tikv_tpu.raftstore.metapb import Region as RefRegion
from tikv_tpu.raftstore.metapb import RegionEpoch as RefEpoch
from tikv_tpu.raftstore.peer import RegionSnapshot as RefRegionSnapshot
from tikv_tpu.storage.mvcc.errors import KeyIsLocked as RefKeyIsLocked
from tikv_tpu.testing.dag import DagSelect as RefDagSelect
from tikv_tpu.testing.fixture import int_table as ref_int_table
from tikv_tpu_torch import convert
from tikv_tpu_torch.codec.keys import table_record_key
from tikv_tpu_torch.copr import region_cache as prc
from tikv_tpu_torch.device.supervisor import FeedArena
from tikv_tpu_torch.raftstore.metapb import Region, RegionEpoch
from tikv_tpu_torch.raftstore.peer import RegionSnapshot
from tikv_tpu_torch.storage.mvcc.errors import KeyIsLocked
from tikv_tpu_torch.storage.txn_types import encode_key
from tikv_tpu_torch.testing import mvcc as tm
from tikv_tpu_torch.testing.dag import DagSelect
from tikv_tpu_torch.testing.fixture import Table, TableColumn
from tikv_tpu_torch.datatype import FieldType

TID = 9810
N = 3000
READ_TS = 400           # below the history's last PUT (500)
CACHE_TS = 600          # at or above every commit: a line caches


def port_table(tid: int = TID) -> Table:
    return Table(tid, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("c0", 2, FieldType.long()),
        TableColumn("c1", 3, FieldType.long()),
    ))


def history(seed: int, n: int = N, locks: bool = True, lock_ts: int = 350):
    """A seeded mix over handles 0, 3, 6, ... (gaps between them): base
    PUTs, updates with NULLs, deletes, rollbacks, LOCK records, a PUT
    above READ_TS, and three pending locks at ``lock_ts`` (a PUT, a
    DELETE and a LOCK prewrite) → (handles, events, locks)."""
    rng = np.random.default_rng(seed)
    h = np.arange(n, dtype=np.int64) * 3
    ones = np.ones(n, np.bool_)

    def pick(share):
        return np.nonzero(rng.random(n) < share)[0]

    def cells(keys, null_share=0.0):
        m = len(keys)
        return {2: (rng.integers(0, 1024, m), np.ones(m, np.bool_)),
                3: (rng.integers(-1000, 1000, m),
                    rng.random(m) >= null_share)}

    upd, dele, rb, lk, fut = (pick(0.1), pick(0.03), pick(0.02), pick(0.02),
                              pick(0.02))
    events = [tm.Event(100, tm.WT_PUT, np.arange(n),
                       {2: (h % 1024, ones), 3: (h % 1000, ones)}),
              tm.Event(200, tm.WT_PUT, upd, cells(upd, 0.2)),
              tm.Event(250, tm.WT_ROLLBACK, rb),
              tm.Event(260, tm.WT_LOCK, lk),
              tm.Event(300, tm.WT_DELETE, dele),
              tm.Event(500, tm.WT_PUT, fut, cells(fut))]
    pending = [(int(h[i]), lock_ts, kind) for i, kind in
               zip(rng.choice(n, 3, replace=False), ("put", "delete",
                                                     "lock"))] \
        if locks else []
    return h, events, pending


def engines(seed: int, n: int = N, locks: bool = True, lock_ts: int = 350):
    """(port engine, reference engine) holding the same records."""
    h, events, pending = history(seed, n, locks, lock_ts)
    triples = tm.kv_history(TID, h, events, pending)
    ref = RefEngine()
    wb = ref.write_batch()
    for cf, k, v in triples:
        wb.put_cf(cf, k, v)
    ref.write(wb)
    return convert.engine_from_triples(triples), ref


def region_pair(rid=1, start=b"", end=b"", version=1):
    return (Region(rid, start, end, RegionEpoch(1, version)),
            RefRegion(rid, start, end, RefEpoch(1, version)))


def snaps(pe, re, regions, data_index=100):
    p = RegionSnapshot(pe.snapshot(), regions[0])
    r = RefRegionSnapshot(re.snapshot(), regions[1])
    p.data_index = r.data_index = data_index
    return p, r


def dags(start_ts=CACHE_TS, ranges=None):
    p = DagSelect.from_table(port_table(), ["id", "c0", "c1"])
    r = RefDagSelect.from_table(ref_int_table(2, table_id=TID),
                                ["id", "c0", "c1"])
    pd, rd = p.build(start_ts), r.build(start_ts)
    if ranges is not None:
        from tikv_tpu.executors.ranges import KeyRange as RefKeyRange
        from tikv_tpu_torch.executors.ranges import KeyRange
        pd = dataclasses.replace(pd, ranges=tuple(
            KeyRange(a, b) for a, b in ranges))
        rd = dataclasses.replace(rd, ranges=tuple(
            RefKeyRange(a, b) for a, b in ranges))
    return pd, rd


def same_table(pt, rt) -> None:
    assert np.array_equal(pt.handles, rt.handles)
    assert sorted(pt.columns) == sorted(rt.columns)
    for cid, col in pt.columns.items():
        rcol = rt.columns[cid]
        assert np.array_equal(col.validity, rcol.validity), cid
        assert np.array_equal(np.where(col.validity, col.values, 0),
                              np.where(rcol.validity, rcol.values, 0)), cid


def same_locks(p, r) -> None:
    assert [(k, l.to_bytes()) for k, l in p] == \
        [(k, l.to_bytes()) for k, l in r]


def ref_infos(rd):
    return rd.executors[0].columns


# ------------------------------------------------------ interpreted build


@pytest.mark.parametrize("seed", (1, 2, 3))
@pytest.mark.parametrize("read_ts", (150, READ_TS, 600))
def test_interpreted_build_matches_reference(seed, read_ts):
    pe, re = engines(seed, 800)
    regions = region_pair()
    ps, rs = snaps(pe, re, regions)
    pd, rd = dags(read_ts)
    pt, psafe, plocks = prc.build_region_columnar(
        ps, TID, pd.executors[0].columns, read_ts)
    rt, rsafe, rlocks = rrc.build_region_columnar(
        rs, TID, ref_infos(rd), read_ts)
    same_table(pt, rt)
    assert psafe == rsafe == 500
    same_locks(plocks, rlocks)
    assert len(plocks) == 2      # the LOCK-type lock blocks nothing
    # the device rung declines: the host ladder's answer, no bundle
    tbl, safe, locks, bundle = prc.build_region_columnar_ex(
        ps, TID, pd.executors[0].columns, read_ts, device_resolver=object())
    assert bundle is None and safe == psafe
    same_table(tbl, rt)


def test_region_clamped_build_matches_reference():
    """A region holding the middle third of the table."""
    pe, re = engines(4, 900)
    lo = encode_key(table_record_key(TID, 900))
    hi = encode_key(table_record_key(TID, 1800))
    regions = region_pair(2, lo, hi)
    ps, rs = snaps(pe, re, regions)
    pd, rd = dags(READ_TS)
    pt, _s, _l = prc.build_region_columnar(ps, TID, pd.executors[0].columns,
                                           READ_TS)
    rt, _s, _l = rrc.build_region_columnar(rs, TID, ref_infos(rd), READ_TS)
    same_table(pt, rt)
    assert pt.handles.min() >= 900 and pt.handles.max() < 1800


# ------------------------------------------------------------- the cache


def cache_pair():
    return prc.RegionColumnarCache(), rrc.RegionColumnarCache()


def counters(c) -> tuple:
    st = c.stats()
    return (st["hits"], st["misses"], st["resident_lines"], st["splits"],
            st["invalidations"])


def test_get_hits_misses_and_lifecycle_match_reference():
    pe, re = engines(5, 600, locks=False)
    pc, rc = cache_pair()
    regions = region_pair()
    pd, rd = dags()
    steps = []

    def both(fn_p, fn_r):
        a, b = fn_p(), fn_r()
        steps.append((counters(pc), counters(rc)))
        return a, b

    ps, rs = snaps(pe, re, regions)
    a, b = both(lambda: pc.get(ps, pd), lambda: rc.get(rs, rd))
    same_table(a._tbl, b._tbl)
    # a warm hit returns the line's snapshot itself
    a2, b2 = both(lambda: pc.get(ps, pd), lambda: rc.get(rs, rd))
    assert a2 is a and b2 is b
    # a new data version rebuilds (no delta source on either side)
    ps, rs = snaps(pe, re, regions, 101)
    both(lambda: pc.get(ps, pd), lambda: rc.get(rs, rd))
    # a read below safe_ts parks an exact-ts build
    pd_old, rd_old = dags(150)
    a, b = both(lambda: pc.get(ps, pd_old), lambda: rc.get(rs, rd_old))
    same_table(a._tbl, b._tbl)
    # the same read again is served by the parked build
    a3, b3 = both(lambda: pc.get(ps, pd_old), lambda: rc.get(rs, rd_old))
    assert a3 is a and b3 is b
    # no data-version stamp: no line
    raw_p, raw_r = snaps(pe, re, regions)
    raw_p.data_index = raw_r.data_index = None
    assert pc.get(raw_p, pd) is None and rc.get(raw_r, rd) is None
    # same-epoch sweep, then an epoch change
    assert pc.invalidate_region(1) == rc.invalidate_region(1) == 1
    both(lambda: pc.get(ps, pd), lambda: rc.get(rs, rd))
    regions2 = region_pair(version=2)
    assert pc.invalidate_region(1, keep_epoch=2) == \
        rc.invalidate_region(1, keep_epoch=2)
    # an epoch-1 build after the floor moved serves but is not cached
    a, b = both(lambda: pc.get(ps, pd), lambda: rc.get(rs, rd))
    same_table(a._tbl, b._tbl)
    ps2, rs2 = snaps(pe, re, regions2, 101)
    both(lambda: pc.get(ps2, pd), lambda: rc.get(rs2, rd))
    for p, r in steps:
        assert p == r


def test_sweep_during_build_fences_the_insert(monkeypatch):
    """A same-epoch sweep landing while a line builds: the build serves
    its request and caches nothing, on both."""
    pe, re = engines(6, 300, locks=False)
    pc, rc = cache_pair()
    regions = region_pair()
    ps, rs = snaps(pe, re, regions)
    pd, rd = dags()
    for mod, cache in ((prc, pc), (rrc, rc)):
        orig = mod.build_region_columnar

        def racing(*a, _orig=orig, _cache=cache, **kw):
            out = _orig(*a, **kw)
            _cache.invalidate_region(1)
            return out
        monkeypatch.setattr(mod, "build_region_columnar", racing)
    a, b = pc.get(ps, pd), rc.get(rs, rd)
    same_table(a._tbl, b._tbl)
    assert counters(pc) == counters(rc)
    assert pc.stats()["resident_lines"] == 0


@pytest.mark.parametrize("start_ts", (340, 350, 360))
@pytest.mark.parametrize("in_range", (True, False))
def test_key_is_locked_parity(start_ts, in_range):
    pe, re = engines(7, 500)
    h, _events, pending = history(7, 500)
    locked = sorted(p[0] for p in pending if p[2] != "lock")[0]
    regions = region_pair()
    lo, hi = (locked, locked + 1) if in_range else (locked + 1, locked + 2)
    rng = [(table_record_key(TID, lo), table_record_key(TID, hi))]
    pd, rd = dags(start_ts, rng)
    outcomes = []
    for cache, snap, dag, err in ((prc.RegionColumnarCache(),
                                   snaps(pe, re, regions)[0], pd,
                                   KeyIsLocked),
                                  (rrc.RegionColumnarCache(),
                                   snaps(pe, re, regions)[1], rd,
                                   RefKeyIsLocked)):
        try:
            cache.get(snap, dag)
            outcomes.append(None)
        except err as e:
            outcomes.append((e.key, e.lock.start_ts))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is not None) == (in_range and start_ts >= 350)


# ------------------------------------------------------------ split lines

SPLIT_AT = {"below": -10, "first": 0, "between": 1501, "at": 1500,
            "last": 3 * (N - 1), "above": 10 ** 9}


def split_regions(split_handle, left_index=100, right_index=100):
    sk = encode_key(table_record_key(TID, split_handle))
    lefts = region_pair(1, b"", sk, 2)
    rights = region_pair(2, sk, b"", 2)
    return lefts, rights, left_index, right_index


def child_summary(spec) -> dict:
    out = {"pos": spec["pos"], "n_parent": spec["n_parent"],
           "version": spec["parent_version"]}
    for side in ("left", "right"):
        ch = spec[side]
        if ch is None:
            out[side] = None
            continue
        st = ch["state"]
        n = st.n
        out[side] = {
            "n": ch["n"], "handles": st.handles[:n].tolist(),
            "cols": {cid: (np.where(v[1][:n], v[0][:n], 0).tolist(),
                           v[1][:n].tolist())
                     for cid, v in sorted(st.cols.items())},
            "locks": sorted((k, l.to_bytes()) for k, l in st.locks.items()),
            "safe_ts": st.safe_ts, "build_ts": st.build_ts,
            "n_dead": st.n_dead, "lineage_v": ch["lineage"].version,
            "region": ch["lineage"].region_hint}
    return out


@pytest.mark.parametrize("where", sorted(SPLIT_AT))
@pytest.mark.parametrize("right_peer", (True, False))
def test_split_lines_match_reference(where, right_peer):
    pe, re = engines(8, lock_ts=1000)       # locks no read here meets
    pc, rc = cache_pair()
    regions = region_pair()
    ps, rs = snaps(pe, re, regions)
    pd, rd = dags()
    pc.get(ps, pd)
    rc.get(rs, rd)
    (pl, rl), (pr, rr), li, ri = split_regions(SPLIT_AT[where])
    ri = ri if right_peer else None
    pspecs = pc.split_lines(pl, pr, li, ri)
    rspecs = rc.split_lines(rl, rr, li, ri)
    assert [child_summary(s) for s in pspecs] == \
        [child_summary(s) for s in rspecs]
    assert len(pspecs) == 1
    assert counters(pc) == counters(rc)
    # the children's published snapshots hold the same rows
    for side, (preg, rreg) in (("left", (pl, rl)), ("right", (pr, rr))):
        if pspecs[0][side] is None:
            continue
        cps, crs = snaps(pe, re, (preg, rreg))
        a, b = pc.get(cps, pd), rc.get(crs, rd)
        same_table(a._tbl, b._tbl)
        assert a.feed_lineage is pspecs[0][side]["lineage"]
    assert counters(pc) == counters(rc)
    # the parent retires on the region change
    assert pc.invalidate_region(1, keep_epoch=2) == \
        rc.invalidate_region(1, keep_epoch=2) == 1


@pytest.mark.parametrize("lag", ("behind", "ahead"))
def test_split_of_a_line_off_left_index_gives_no_spec(lag):
    """No delta bridge on either side: a parent line behind the split's
    left_index (or past it) is not sliced; the children rebuild."""
    pe, re = engines(9, 500, locks=False)
    pc, rc = cache_pair()
    ps, rs = snaps(pe, re, region_pair())
    pd, rd = dags()
    pc.get(ps, pd)
    rc.get(rs, rd)
    li = 101 if lag == "behind" else 99
    (pl, rl), (pr, rr), _li, ri = split_regions(600, li, li)
    assert pc.split_lines(pl, pr, li, ri) == []
    assert rc.split_lines(rl, rr, li, ri) == []
    assert counters(pc) == counters(rc)


def test_split_without_left_index_is_not_served():
    pc, rc = cache_pair()
    (pl, rl), (pr, rr), _li, _ri = split_regions(600)
    assert pc.split_lines(pl, pr, None, 100) == \
        rc.split_lines(rl, rr, None, 100) == []


# -------------------------------------------------------------- FeedArena


class _Anchor:
    """A weak-referenceable anchor."""


def _fill(arena, anchor, nbytes, ref: bool) -> None:
    b = arena.bucket(anchor)
    b["feed"] = {"flat": (np.zeros(nbytes, np.uint8),) if ref
                 else (torch.zeros(nbytes, dtype=torch.uint8),)}


STAT_KEYS = ("budget_bytes", "resident_bytes", "resident_lines",
             "pinned_lines", "pinned_bytes", "evictions", "rejections",
             "drops")


def _arena_script(arena, ref: bool) -> list:
    anchors = [_Anchor() for _ in range(6)]
    log = []

    def note(tag):
        st = arena.stats()
        live = sorted(i for i, a in enumerate(anchors)
                      if a is not None and
                      arena.bucket(a, create=False) is not None)
        log.append((tag, tuple(st[k] for k in STAT_KEYS), tuple(live)))

    arena.budget_bytes = 3000
    for i, nb in enumerate((1000, 1000, 500)):
        _fill(arena, anchors[i], nb, ref)
        log.append(("admit", arena.admit(anchors[i])))
    note("filled")
    # frequency: anchor 0 touched twice more, anchor 2 once more
    for i in (0, 0, 2):
        arena.bucket(anchors[i], create=False)
    tok = arena.pin(anchors[1])          # the least used, but pinned
    _fill(arena, anchors[3], 1200, ref)
    log.append(("admit", arena.admit(anchors[3])))
    note("evicted past the pin")
    # an entry larger than the budget alone is refused
    _fill(arena, anchors[4], 5000, ref)
    log.append(("admit", arena.admit(anchors[4])))
    note("refused")
    arena.unpin(tok)
    note("unpinned")
    _fill(arena, anchors[5], 900, ref)
    log.append(("admit", arena.admit(anchors[5])))
    note("lru among equals")
    log.append(("drop", arena.drop(anchors[5])))
    note("dropped")
    # the backstop: an anchor that dies without a lifecycle event
    victim = next(i for i, a in enumerate(anchors)
                  if arena.bucket(a, create=False) is not None)
    anchors[victim] = None
    gc.collect()
    note("collected")
    arena.budget_bytes = 1000
    log.append(("enforce", arena.enforce()))
    note("shrunk")
    log.append(("drop_all", arena.drop_all() >= 0))
    note("empty")
    return log


def test_feed_arena_matches_reference():
    assert _arena_script(FeedArena(), False) == \
        _arena_script(RefArena(), True)


def test_feed_arena_pins_survive_drop_and_rebuild():
    """A pin token of a dropped entry does not strip the pin of the entry
    rebuilt under the same anchor, on both."""
    for arena, ref in ((FeedArena(), False), (RefArena(), True)):
        a = _Anchor()
        _fill(arena, a, 100, ref)
        arena.admit(a)
        tok = arena.pin(a)
        assert arena.drop(a) == 100
        _fill(arena, a, 200, ref)
        arena.admit(a)
        tok2 = arena.pin(a)
        arena.unpin(tok)
        assert arena.stats()["pinned_lines"] == 1
        arena.unpin(tok2)
        assert arena.stats()["pinned_lines"] == 0
        assert arena.pin(_Anchor()) is None


def test_feed_arena_pins_hold_under_concurrent_requests():
    """Many threads admit, pin and unpin under a budget at a short switch
    interval: every pin is given back once, the accounting matches the
    buckets left, and the budget holds once nothing is pinned."""
    import sys
    import threading
    arena = FeedArena(budget_bytes=6000)
    anchors = [_Anchor() for _ in range(8)]
    errors = []

    def worker(k):
        try:
            for i in range(300):
                a = anchors[(k + i) % len(anchors)]
                b = arena.bucket(a)
                if b is not None and "feed" not in b:
                    b["feed"] = {"flat": (torch.zeros(1000 + 100 * k,
                                                      dtype=torch.uint8),)}
                arena.admit(a)
                tok = arena.pin(a)
                arena.bucket(a, create=False)
                arena.unpin(tok)
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    st = arena.stats()
    assert st["pinned_lines"] == 0 and st["pinned_bytes"] == 0
    live = sum(sum(t.nbytes for t in b["feed"]["flat"])
               for _a, b in arena.items() if "feed" in b)
    assert st["resident_bytes"] == live <= 6000
