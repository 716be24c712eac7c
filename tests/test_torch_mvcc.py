"""The cold MVCC path: the port's ``device/mvcc.py``,
``copr/region_cache.py`` and the runner's cold mint against the JAX
package's ``device/mvcc.py`` on the same version planes.

- ``mvcc_resolve_plain`` against the reference's jitted ``resolve``
  (``DeviceMvccResolver(None)._kernel``, JAX on the CPU) over seeded
  histories: deletes, rollbacks, locks, versions above read_ts, NULLs,
  REAL, INT and unsigned columns, every key deleted, an empty result,
  two versions of a key at one commit_ts (both win, as in the reference;
  the cold build refuses such planes), and long segments (one key of
  50,000 versions among short keys; a run of keys of 300 versions each);
- ``resolve_host`` and ``host_mirror`` against the reference's;
- planes of the reference's native parse (``fast_mvcc_table_sst`` blobs,
  and rows committed through ``Storage`` that spill into CF_DEFAULT),
  carried across by ``convert.write_planes_from_arrays``;
- the history generator's planes against the reference's parse of the
  same history committed through ``Storage``;
- the minted feed against the reference's ``ColdFeedBundle.mint`` and
  against ``_build_flat`` of the host mirror, plane for plane, byte for
  byte, digests included; also from ``DeviceVersionPlanes`` filled in
  chunks;
- config 6c- and 4h-shaped requests through ``DeviceRunner(device="cpu")``
  on a minted feed against the reference's ``DeviceRunner`` over the same
  host table and the generator's truth;
- the feed routes of the scans the mint refuses (index, descending,
  partial range);
- a cold request served in a fresh interpreter loads neither JAX nor the
  JAX package (``test_torch_isolation.py`` checks every module's imports).
"""

import dataclasses
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tikv_tpu.copr.region_cache as rrc
from tikv_tpu.codec import decode_row
from tikv_tpu.codec.keys import table_record_range as ref_record_range
from tikv_tpu.datatype import FieldType as RefFieldType
from tikv_tpu.device import mvcc as rm
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.engine.memory import MemoryEngine
from tikv_tpu.engine.traits import CF_WRITE
from tikv_tpu.executors.columnar import ColumnarTable as RefTable
from tikv_tpu.kv.engine import LocalEngine
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire
from tikv_tpu.sst_importer import fast_mvcc_table_sst
from tikv_tpu.storage import Storage
from tikv_tpu.storage.txn import commands as cmds
from tikv_tpu.storage.txn.actions import Mutation
from tikv_tpu.storage.txn_types import encode_key
from tikv_tpu.testing.dag import DagSelect as RefDagSelect
from tikv_tpu.testing.fixture import Table as RefTableSchema
from tikv_tpu.testing.fixture import TableColumn as RefColumn
from tikv_tpu.testing.fixture import encode_table_row

from tikv_tpu_torch import convert
from tikv_tpu_torch.codec.keys import table_record_key
from tikv_tpu_torch.copr.region_cache import (MvccColumnarSnapshot,
                                              build_region_columnar_device)
from tikv_tpu_torch.device import mvcc as pm
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.executors.ranges import KeyRange
from tikv_tpu_torch.testing import configs
from tikv_tpu_torch.testing import mvcc as tm

N_PAD = 1024
KINDS = {2: 0, 3: 1, 4: 3}          # INT, REAL, unsigned INT


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def port():
    return DeviceRunner(device="cpu")


def ref_table(tid: int, kinds: dict) -> RefTableSchema:
    fts = {0: RefFieldType.long(), 1: RefFieldType.double(),
           3: RefFieldType.long(unsigned=True)}
    return RefTableSchema(tid, (
        RefColumn("id", 1, RefFieldType.long(not_null=True),
                  is_pk_handle=True),) + tuple(
        RefColumn(f"c{cid}", cid, fts[k]) for cid, k in kinds.items()))


def port_table(table):
    return convert.table_from_wire(table.table_id, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in table.columns])


def infos_of(table, port_side: bool):
    dag = RefDagSelect.from_table(table, [c.name for c in table.columns]) \
        .build()
    if port_side:
        dag = convert.dag_from_wire(wire.enc_dag(dag))
    return dag.executors[0].columns


def to_ref(planes) -> rm.WritePlanes:
    return rm.WritePlanes(*[getattr(planes, s)
                            for s in rm.WritePlanes.__slots__])


def to_port(planes) -> pm.WritePlanes:
    return convert.write_planes_from_arrays(
        **{s: getattr(planes, s) for s in rm.WritePlanes.__slots__})


# ------------------------------------------------- the resolve, plain vs jax

def _history(case: str):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    shares = {"mixed": None, "deletes": {1: 1.0},
              "rollbacks_locks": {2: 0.5, 3: 0.5}, "puts": {0: 1.0}}
    if case == "every_key_deleted":
        keys = np.arange(500)
        ev = [tm.Event(10, 0, keys, {c: (rng.integers(0, 9, 500),
                                         np.ones(500, np.bool_))
                                     for c in (2,)}),
              tm.Event(20, 1, keys)]
        return tm.version_history(keys * 2, ev, {2: 0}, 100)[0], 100
    if case == "equal_commit_ts":
        return tm.equal_ts_planes(), 60
    if case in LONG_CASES:
        return tm.long_segment_planes(case, KINDS)
    n_keys = 700
    ev = tm.random_history(rng, n_keys, KINDS, n_events=6,
                           shares=shares.get(case.split("@")[0]))
    read_ts = {"empty": 5, "above_read_ts": 45}.get(case, 1000)
    planes = tm.version_history(np.arange(n_keys) * 3 + 7, ev, KINDS,
                                read_ts)[0]
    return planes, read_ts


CASES = ("mixed", "deletes", "rollbacks_locks", "puts", "above_read_ts",
         "every_key_deleted", "empty", "equal_commit_ts")
# one key of 50,000 versions among short keys; a run of keys of 300 each
LONG_CASES = ("hot_key", "long_run")


def _spec(planes, handle_dtype="int64"):
    """A spec over every column: value planes in each feed dtype the kind
    takes, and the validity planes → (ref spec, port spec, ref inputs,
    port sources, kinds)."""
    rspec, pspec, rins, pins, kinds = [("h", handle_dtype)], \
        [("h", getattr(torch, handle_dtype))], [], [], []
    for cid in planes.col_ids:
        kind, vals, valid = planes.cols[cid]
        rins += [vals, valid]
        pins += [pm._to_device(vals, "cpu"), pm._to_device(valid, "cpu")]
        kinds += [kind, pm._SRC_BOOL]
        vi = len(rins) - 2
        for dt in (("float32", "float64") if kind == 1
                   else ("int32", "int64")):
            rspec.append(("v", vi, dt))
            pspec.append(("v", vi, getattr(torch, dt)))
        rspec.append(("m", vi + 1))
        pspec.append(("m", vi + 1))
    return rspec, pspec, rins, pins, kinds


@pytest.mark.parametrize("case", CASES + LONG_CASES)
def test_plain_resolve_matches_reference_kernel(ref, case):
    planes, read_ts = _history(case)
    n = len(pm.resolve_host(planes, read_ts))
    nv, nk = rm._bucket(planes.n_ver), rm._bucket(planes.n_keys)
    n_pad = max(N_PAD, nk)

    def pad(a, cap):
        p = np.zeros(cap, a.dtype)
        p[:len(a)] = a
        return jnp.asarray(p)

    rspec, pspec, rins, pins, kinds = _spec(planes)
    fn = rm.DeviceMvccResolver(None)._kernel(nv, nk, n_pad, tuple(rspec))
    want = fn(jnp.asarray(read_ts, jnp.int64), jnp.asarray(n, jnp.int64),
              pad(planes.commit_ts.view(np.int64), nv), pad(planes.wtype, nv),
              pad(planes.seg_id, nv), pad(planes.handles, nk),
              *[pad(a, nv) for a in rins])
    got, count = pm.mvcc_resolve(
        *(pm._to_device(a, "cpu") for a in (
            planes.commit_ts, planes.wtype, planes.seg_start,
            planes.handles)),
        pins, kinds, pspec, read_ts, planes.n_keys, n_pad)
    assert int(count) == n
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert g.numpy().tobytes() == w.tobytes()
    if case == "equal_commit_ts":
        # key 0's two PUTs both win, key 1's PUT beside its DELETE wins,
        # key 2's PUT wins over its LOCK: the reference's rule
        assert n == 5
        assert got[0][:n].tolist() == [3, 3, 8, 9, 12]
    if case in ("empty", "every_key_deleted"):
        assert n == 0


@pytest.mark.parametrize("case", CASES[:-1] + LONG_CASES)
def test_host_resolution_matches_reference(ref, case):
    planes, read_ts = _history(case)
    infos = infos_of(ref_table(1, {c: planes.cols[c][0]
                                   for c in planes.col_ids}), True)
    rinfos = infos_of(ref_table(1, {c: planes.cols[c][0]
                                    for c in planes.col_ids}), False)
    w = pm.resolve_host(planes, read_ts)
    rw = rm.resolve_host(to_ref(planes), read_ts)
    assert np.array_equal(w, rw)
    h, cols = pm.host_mirror(planes, w, infos)
    rh, rcols = rm.host_mirror(to_ref(planes), rw, rinfos)
    assert np.array_equal(h, rh)
    for cid, col in cols.items():
        assert col.values.tobytes() == rcols[cid].values.tobytes()
        assert np.array_equal(col.validity, rcols[cid].validity)


def test_cold_build_refuses_two_visible_versions_of_one_key(port):
    planes, read_ts = _history("equal_commit_ts")
    infos = infos_of(ref_table(5, KINDS), True)
    with pytest.raises(ValueError, match="share a commit_ts"):
        build_region_columnar_device(planes, None, infos, read_ts,
                                     port.mvcc_resolver())


def test_read_ts_beyond_int64_is_refused(port):
    planes, _ = _history("puts")
    infos = infos_of(ref_table(1, KINDS), True)
    assert build_region_columnar_device(planes, None, infos, 1 << 63,
                                        port.mvcc_resolver()) is None
    with pytest.raises(ValueError, match="read_ts"):
        pm.mvcc_resolve(*(torch.zeros(1, dtype=d) for d in (
            torch.int64, torch.uint8, torch.int64, torch.int64)), [], [],
            [], 1 << 63, 0, 8)


# ------------------------------------------------------------ the mint

def _ref_feed(ref, rplanes, rinfos, dtypes, read_ts, spill=None,
              mirror=None):
    """The reference's born-resident feed of ``rplanes`` (the
    ``_mint_feed`` pattern of its tests) and its n."""
    if mirror is None:
        rw = rm.resolve_host(rplanes, read_ts)
        mirror = rm.host_mirror(rplanes, rw, rinfos)
    h, cols = mirror
    bundle = rm.ColdFeedBundle(ref.mvcc_resolver(), rplanes, None, len(h),
                               read_ts, h, cols, spill_patches=spill)
    return bundle.mint(ref, list(rinfos), list(dtypes), len(h),
                       ref._pad_rows(len(h))), len(h)


def _port_feed(port, snap, infos, dtypes, n):
    """The port's minted feed of ``snap``'s bundle (as the runner's feed
    miss mints it)."""
    bundle = snap.feed_lineage.take_cold()
    return bundle.mint(port, list(infos), list(dtypes), n,
                       port._pad_rows(n))


def _same_feed(a, b):
    assert a["null_flags"] == tuple(b["null_flags"])
    assert len(a["flat"]) == len(b["flat"])
    for x, y in zip(a["flat"], b["flat"]):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    assert [int(d) & (2 ** 64 - 1) for d in a["digests"]] == \
        [int(d) & (2 ** 64 - 1) for d in b["digests"]]


def _host_cols(tbl, infos, dtypes):
    out = []
    for info, ds in zip(infos, dtypes):
        if info.is_pk_handle:
            v, ok = tbl.handles, np.ones(len(tbl), np.bool_)
        else:
            col = tbl.columns[info.col_id]
            v, ok = col.values, col.validity
        out.append((np.ascontiguousarray(v.astype(ds)), ok))
    return out


@pytest.mark.parametrize("case", ("mixed", "above_read_ts", "deletes",
                                  "rollbacks_locks"))
def test_minted_feed_matches_reference_mint_and_upload(ref, port, case):
    planes, read_ts = _history(case)
    rt = ref_table(1, KINDS)
    infos, rinfos = infos_of(rt, True), infos_of(rt, False)
    dtypes = ["int32", "int64", "float32", "int64"]
    tbl, safe, bundle = build_region_columnar_device(
        planes, port_table(rt), infos, read_ts, port.mvcc_resolver())
    assert safe == planes.safe_ts
    n = len(tbl)
    snap = MvccColumnarSnapshot(tbl, read_ts, safe, bundle)
    got = _port_feed(port, snap, infos, dtypes, n)
    want, rn = _ref_feed(ref, to_ref(planes), rinfos, dtypes, read_ts)
    assert rn == n
    _same_feed(got, want)
    _same_feed(got, port._build_flat(_host_cols(tbl, infos, dtypes), n))
    assert snap.feed_lineage.take_cold() is None    # one-shot


@pytest.mark.parametrize("chunks", (1, 4, 9))
def test_resident_planes_mint_the_same_feed(port, chunks):
    """``DeviceVersionPlanes`` filled in chunks (growing through several
    capacity buckets) mint the feed the uploaded planes mint."""
    rng = np.random.default_rng(chunks)
    n_keys = 1500
    ev = tm.random_history(rng, n_keys, KINDS, n_events=4)
    planes = tm.version_history(np.arange(n_keys) * 5, ev, KINDS, 1000)[0]
    parts = tm.split_planes(planes, -(-n_keys // chunks))
    assert len(parts) == chunks
    whole = pm.concat_planes(parts)
    for s in ("commit_ts", "wtype", "seg_id", "seg_start", "handles"):
        assert getattr(whole, s).tobytes() == getattr(planes, s).tobytes()
    dev = pm.DeviceVersionPlanes("cpu")
    for p in parts:
        dev.append(p)
    assert (dev.n_ver, dev.n_keys) == (planes.n_ver, planes.n_keys)
    assert dev.cap_ver >= planes.n_ver and dev.cap_keys >= planes.n_keys
    rt = ref_table(1, KINDS)
    infos = infos_of(rt, True)
    dtypes = ["int64", "int32", "float64", "int32"]
    feeds = []
    for resident in (None, dev):
        tbl, safe, bundle = build_region_columnar_device(
            planes, port_table(rt), infos, 1000, port.mvcc_resolver(),
            device_planes=resident)
        feeds.append(bundle.mint(port, infos, dtypes, len(tbl),
                                 port._pad_rows(len(tbl))))
    assert port.mvcc_resolver().phases_ms["h2d"] == 0.0
    _same_feed(feeds[0], feeds[1])


def test_mint_raises_when_the_device_count_differs(port):
    """A bundle whose read_ts disagrees with its mirror: the kernel's
    count differs from n and the mint raises — it never uploads
    instead."""
    planes, read_ts = _history("mixed")
    rt = ref_table(1, KINDS)
    infos = infos_of(rt, True)
    tbl, safe, bundle = build_region_columnar_device(
        planes, port_table(rt), infos, read_ts, port.mvcc_resolver())
    bundle.read_ts = 5                  # nothing is visible at 5
    with pytest.raises(RuntimeError, match="visible rows"):
        bundle.mint(port, infos, ["int64", "int64", "float32", "int64"],
                    len(tbl),
                    port._pad_rows(len(tbl)))


# --------------------------------------------- the reference's own parse

def _engine(blobs):
    from tikv_tpu.codec.keys import data_key
    from tikv_tpu.sst_importer import read_sst_cf
    eng = MemoryEngine()
    for blob in blobs:
        wb = eng.write_batch()
        for cf, (keys, vals) in read_sst_cf(blob).items():
            wb.ingest_cf(cf, [data_key(k) for k in keys], vals)
        eng.write(wb)
    return eng


def _parse(eng, tid, rinfos, data_keys: bool = False):
    """The reference's native parse of ``tid``'s CF_WRITE range; ingested
    SSTs keep their keys under the data prefix (one byte to skip)."""
    from tikv_tpu.codec.keys import data_key
    lo, hi = (encode_key(k) for k in ref_record_range(tid))
    if data_keys:
        lo, hi = data_key(lo), data_key(hi)
    keys, vals, _skip = eng.snapshot().range_cf(CF_WRITE, lo, hi)
    return rm.parse_write_planes(keys, vals, int(data_keys), rinfos)


def test_native_parse_planes_carry_across(ref, port):
    tid, n = 8800, 3000
    hs = np.arange(n, dtype=np.int64)
    blobs = [fast_mvcc_table_sst(tid, hs[s:s + 1000], [
        (2, hs[s:s + 1000] % 7, None), (3, hs[s:s + 1000] % 13, None)],
        commit_ts=100) for s in range(0, n, 1000)]
    rt = ref_table(tid, {2: 0, 3: 0})
    rinfos, infos = infos_of(rt, False), infos_of(rt, True)
    rplanes = _parse(_engine(blobs), tid, rinfos, data_keys=True)
    planes = to_port(rplanes)
    for s in rm.WritePlanes.__slots__:
        a, b = getattr(planes, s), getattr(rplanes, s)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), s
    dtypes = ["int64", "int32", "int32"]
    tbl, safe, bundle = build_region_columnar_device(
        planes, port_table(rt), infos, 200, port.mvcc_resolver())
    got = bundle.mint(port, infos, dtypes, n, port._pad_rows(n))
    want, _n = _ref_feed(ref, rplanes, rinfos, dtypes, 200)
    _same_feed(got, want)


def _commit(storage, ts, muts):
    storage.sched_txn_command(cmds.Prewrite(muts, muts[0].key, ts - 1))
    storage.sched_txn_command(
        cmds.Commit([m.key for m in muts], ts - 1, ts))


def test_spilled_rows_are_patched_from_defaults(ref, port):
    """Rows past the short-value limit live in CF_DEFAULT: the caller
    supplies their cells, and the mint writes them into the gathered
    planes with ``patch_rows`` — the feed equals the reference's."""
    eng = MemoryEngine()
    storage = Storage(LocalEngine(eng))
    n_cols, tid = 28, 777
    rt = RefTableSchema(tid, (RefColumn("id", 1, RefFieldType.long(
        not_null=True), is_pk_handle=True),) + tuple(
        RefColumn(f"c{i}", 2 + i, RefFieldType.long())
        for i in range(n_cols)))
    muts = []
    for h in range(120):
        if h % 3 == 0:
            row = {f"c{i}": (1 << 40) + h * 100 + i for i in range(n_cols)}
        else:
            row = {f"c{i}": (None if (h + i) % 4 == 0 else h - i)
                   for i in range(n_cols)}
        muts.append(Mutation("put", *encode_table_row(rt, h, row)))
    _commit(storage, 20, muts)
    rinfos, infos = infos_of(rt, False), infos_of(rt, True)
    snap = eng.snapshot()
    tbl_r, _s, _l, rbundle = rrc.build_region_columnar_ex(
        snap, tid, rinfos, 10 ** 9, device_resolver=ref.mvcc_resolver())
    assert rbundle.spill_patches
    rplanes = rbundle.planes
    raw, missing = rrc._fetch_default_values(snap, tid,
                                             rplanes.need_default)
    assert not missing
    defaults = {row: decode_row(v) for (row, _s2, _u), v in
                zip(rplanes.need_default, raw)}
    planes = to_port(rplanes)
    dtypes = ["int64"] * len(infos)
    tbl, safe, bundle = build_region_columnar_device(
        planes, port_table(rt), infos, 10 ** 9, port.mvcc_resolver(),
        defaults=defaults)
    assert sorted(bundle.spill_patches) == sorted(rbundle.spill_patches)
    n = len(tbl)
    got = bundle.mint(port, infos, dtypes, n, port._pad_rows(n))
    want = rbundle.mint(ref, list(rinfos), dtypes, n, ref._pad_rows(n))
    _same_feed(got, want)
    _same_feed(got, port._build_flat(_host_cols(tbl, infos, dtypes), n))
    # without the cells of a spilled row the build cannot serve
    assert build_region_columnar_device(
        planes, port_table(rt), infos, 10 ** 9, port.mvcc_resolver()) is None


def test_generator_spills_mint_as_the_unspilled_planes(ref, port):
    """PUT rows moved into CF_DEFAULT (``testing.mvcc.spill``): the mint
    patches their cells from ``defaults`` and yields the feed of the
    planes that kept them, and the reference's mint of the same bundle."""
    planes, read_ts = _history("mixed")
    winners = pm.resolve_host(planes, read_ts)
    rows = winners[::7]
    spilled, defaults = tm.spill(planes, rows)
    rt = ref_table(1, KINDS)
    infos, rinfos = infos_of(rt, True), infos_of(rt, False)
    dtypes = ["int64", "int32", "float32", "int32"]
    feeds = []
    for p, d in ((planes, None), (spilled, defaults)):
        tbl, safe, bundle = build_region_columnar_device(
            p, port_table(rt), infos, read_ts, port.mvcc_resolver(),
            defaults=d)
        spill_rows = sorted(bundle.spill_patches)
        mirror = (tbl.handles, {c: _ref_col(col)
                                for c, col in tbl.columns.items()})
        feeds.append(bundle.mint(port, infos, dtypes, len(tbl),
                                 port._pad_rows(len(tbl))))
    assert len(spill_rows) == len(rows)
    _same_feed(feeds[1], feeds[0])
    want, _n = _ref_feed(ref, to_ref(spilled), rinfos, dtypes, read_ts,
                         spill=dict.fromkeys(spill_rows, True),
                         mirror=mirror)
    _same_feed(feeds[1], want)


def test_generator_matches_the_reference_parse(ref):
    """The generator's planes of a history equal the reference's parse of
    the same history committed through ``Storage``."""
    rng = np.random.default_rng(21)
    n_keys, tid = 60, 4242
    kinds = {2: 0, 3: 0}
    ev = tm.random_history(rng, n_keys, kinds, n_events=6, null_share=0.3)
    for e in ev:
        if e.cols is not None:
            e.cols = {c: (v % 1000, ok) for c, (v, ok) in e.cols.items()}
    rt = ref_table(tid, kinds)
    planes, th, truth = tm.version_history(np.arange(n_keys), ev, kinds,
                                           10 ** 6, tid)
    eng = MemoryEngine()
    storage = Storage(LocalEngine(eng))
    for e in ev:
        keys = [encode_table_row(rt, int(k), {})[0] for k in e.keys]
        if not keys:
            continue
        if e.wtype == pm.WT_ROLLBACK:
            storage.sched_txn_command(cmds.Rollback(keys, e.commit_ts))
            continue
        muts = []
        for j, k in enumerate(e.keys):
            if e.wtype == pm.WT_PUT:
                row = {f"c{c}": (int(v[j]) if ok[j] else None)
                       for c, (v, ok) in e.cols.items()}
                muts.append(Mutation("put", *encode_table_row(rt, int(k),
                                                              row)))
            else:
                muts.append(Mutation("delete" if e.wtype == pm.WT_DELETE
                                     else "lock", keys[j], None))
        _commit(storage, e.commit_ts, muts)
    rplanes = _parse(eng, tid, infos_of(rt, False))
    for s in rm.WritePlanes.__slots__:
        a, b = getattr(planes, s), getattr(rplanes, s)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), s
        elif s == "cols":
            for c in a:
                assert a[c][0] == b[c][0]
                assert a[c][1].tobytes() == b[c][1].tobytes(), c
                assert np.array_equal(a[c][2], b[c][2]), c
        else:
            assert list(a) == list(b) if s in ("need_default", "col_ids") \
                else a == b, s


# ------------------------------------------------------ the path, served

def _served(ref, port, config: str):
    """Config 6c's or 4h's history at 40,000 keys, both GROUP BY the
    first column: COUNT(*), SUM of the second."""
    make = tm.history_6c if config == "6c" else tm.history_4h
    table, planes, th, truth, read_ts = make(40_000)
    rt = ref_table(table.table_id, {2: 0, 3: 0})
    rdag = RefDagSelect.from_table(rt, ["id", "c2", "c3"])
    rdag = rdag.aggregate([rdag.col("c2")], [
        ("count_star", None), ("sum", rdag.col("c3"))]).build()
    pt = port_table(rt)
    dag = convert.dag_from_wire(wire.enc_dag(rdag))
    infos = dag.executors[0].columns
    tbl, safe, bundle = build_region_columnar_device(
        planes, pt, infos, read_ts, port.mvcc_resolver())
    return pt, tbl, safe, bundle, dag, rdag, rt, th, truth, read_ts


@pytest.mark.parametrize("config", ("6c", "4h"))
def test_cold_requests_match_reference_runner(ref, port, config):
    pt, tbl, safe, bundle, dag, rdag, rt, th, truth, read_ts = \
        _served(ref, port, config)
    snap = MvccColumnarSnapshot(tbl, read_ts, safe, bundle)
    before = dict(port.feed_routes)
    rows = [port.handle_request(dag, snap).rows() for _ in range(3)]
    assert port.feed_routes.get("device_resolve", 0) == \
        before.get("device_resolve", 0) + 1
    assert port.feed_routes.get("upload", 0) == before.get("upload", 0)
    ref_tbl = RefTable(rt, tbl.handles, {
        cid: _ref_col(c) for cid, c in tbl.columns.items()})
    want = ref.handle_request(rdag, ref_tbl).rows()
    assert rows[0] == rows[1] == rows[2] == want
    # the generator's truth, independently of both resolutions
    tt = tm.truth_table(pt, th, truth, tm.ETS_INT)
    want_rows, scales = configs.truth("4", tt)
    assert configs.rows_agree(rows[0], want_rows, scales, 1e-9)
    feed = port._snaps[snap]["feeds"][next(iter(port._snaps[snap]["feeds"]))]
    assert port.scrub_feed(feed) == []
    port.corrupt_resident_plane(feed, len(feed["flat"]) - 1)
    assert port.scrub_feed(feed) == [len(feed["flat"]) - 1]


def _ref_col(col):
    from tikv_tpu.datatype import Column as RefCol
    from tikv_tpu.datatype import EvalType as RefET
    return RefCol(RefET(col.eval_type.value), col.values, col.validity)


def _refused_dags(dag, pt):
    scan = dag.executors[0]
    desc = dataclasses.replace(dag, executors=(
        dataclasses.replace(scan, desc=True),) + dag.executors[1:])
    part = dataclasses.replace(dag, ranges=(KeyRange(
        table_record_key(pt.table_id, 0),
        table_record_key(pt.table_id, 10_000)),))
    return {"desc": desc, "partial": part}


@pytest.mark.parametrize("scan", ("index", "desc", "partial"))
def test_refused_scans_upload_and_drop_the_bundle(ref, port, scan):
    table, planes, th, truth, read_ts = tm.history_4h(20_000)
    infos = configs.dag_hash_agg(table).executors[0].columns
    tbl, safe, bundle = build_region_columnar_device(
        planes, table, infos, read_ts, port.mvcc_resolver())
    snap = MvccColumnarSnapshot(tbl, read_ts, safe, bundle)
    if scan == "index":
        dag = configs.dag_topn_index(table, 10)
    else:
        dag = _refused_dags(configs.dag_hash_agg(table), table)[scan]
    before = dict(port.feed_routes)
    port.handle_request(dag, snap)
    assert port.feed_routes.get("upload", 0) == before.get("upload", 0) + 1
    assert port.feed_routes.get("device_resolve", 0) == \
        before.get("device_resolve", 0)
    assert snap.feed_lineage.take_cold() is None and bundle.consumed
    # the answers equal those of a snapshot that never had a bundle
    plain = MvccColumnarSnapshot(tbl, read_ts, safe)
    assert port.handle_request(dag, snap).rows() == \
        port.handle_request(dag, plain).rows()


_COLD_SERVE = """
import sys
from tikv_tpu_torch.copr.region_cache import (MvccColumnarSnapshot,
                                              build_region_columnar_device)
from tikv_tpu_torch.device import DeviceRunner
from tikv_tpu_torch.testing import configs, mvcc
runner = DeviceRunner(device="cpu")
table, planes, _h, _t, read_ts = mvcc.history_4h(5000)
agg = configs.dag_hash_agg(table)
tbl, safe, bundle = build_region_columnar_device(
    planes, table, agg.executors[0].columns, read_ts, runner.mvcc_resolver())
snap = MvccColumnarSnapshot(tbl, read_ts, safe, bundle)
rows = runner.handle_request(agg, snap).rows()
assert sum(r[0] for r in rows) == len(tbl), rows
assert runner.feed_routes == {"device_resolve": 1}, runner.feed_routes
feed = next(iter(runner._snaps[snap]["feeds"].values()))
assert runner.scrub_feed(feed) == []
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
assert not bad, bad
print("cold", len(tbl))
"""


def test_cold_serving_loads_no_jax():
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _COLD_SERVE], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("cold ")
