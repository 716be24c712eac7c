"""The port's cold build ladder (``tikv_tpu_torch/copr/region_cache.py``:
the device rung ``_build_device`` over the native parse, the native rung
``_build_native``, the interpreted loop) against the JAX package's, in the
shape of ``tests/test_device_mvcc.py``'s ladder cases.

Each engine is committed through the reference's ``Storage`` and copied
byte for byte into the port's ``MemoryEngine``.  On each, the port's three
rungs and the reference's device rung must agree on rows, safe_ts and
blocking locks, each labelled ``cold_build`` by the rung that served; the
feed the port's bundle mints on the CPU equals the reference's mint and
the port's upload of the host mirror, plane for plane.  Cases: seeded
random histories (versions across read_ts, deletes, a rollback, NULLs),
rows spilled to CF_DEFAULT, unsigned and REAL columns, a pending lock, a
BYTES schema (the host rungs serve), the ``device::mvcc_resolve``
failpoint, and a region served end to end through the cache and the
runner against the reference's cache and host pipeline.
"""

import jax
import numpy as np
import pytest

import tikv_tpu.copr.region_cache as rrc
from tikv_tpu.datatype import FieldType as RefFieldType
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.engine.memory import MemoryEngine as RefEngine
from tikv_tpu.executors.runner import BatchExecutorsRunner as RefPipeline
from tikv_tpu.kv.engine import LocalEngine
from tikv_tpu.parallel import make_mesh
from tikv_tpu.raftstore.metapb import Region as RefRegion
from tikv_tpu.raftstore.peer import RegionSnapshot as RefRegionSnapshot
from tikv_tpu.server import wire
from tikv_tpu.storage import Storage
from tikv_tpu.storage.txn import commands as cmds
from tikv_tpu.storage.txn.actions import Mutation
from tikv_tpu.testing.dag import DagSelect as RefDagSelect
from tikv_tpu.testing.fixture import Table as RefTable
from tikv_tpu.testing.fixture import TableColumn as RefColumn
from tikv_tpu.testing.fixture import encode_table_row, int_table

from tikv_tpu_torch import convert
from tikv_tpu_torch import native as pnv
from tikv_tpu_torch.copr import region_cache as prc
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.raftstore.metapb import Region
from tikv_tpu_torch.raftstore.peer import RegionSnapshot
from tikv_tpu_torch.utils import failpoint, tracker

from tests.test_torch_mvcc import _host_cols, _same_feed
from tests.test_torch_native import commit, infos_of, port_engine

BIG = 10 ** 9


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def port():
    return DeviceRunner(device="cpu")


def labelled(fn, *args, **kw):
    """``fn(*args, **kw)`` under a port tracker → (result, labels,
    phases)."""
    tr, tok = tracker.install()
    try:
        out = fn(*args, **kw)
    finally:
        tracker.uninstall(tok)
    return out, dict(tr.labels), dict(tr.phases)


def refuse(*_args):
    raise ValueError("outside the envelope")


def same_rows(a, b, ctx="") -> None:
    assert np.array_equal(a.handles, b.handles), ctx
    assert sorted(a.columns) == sorted(b.columns), ctx
    for cid, cb in b.columns.items():
        ca = a.columns[cid]
        assert np.array_equal(ca.validity, cb.validity), (ctx, cid)
        assert list(ca.values[ca.validity]) == \
            list(cb.values[cb.validity]), (ctx, cid)


def lock_ids(locks) -> list:
    return [(bytes(k), lk.start_ts) for k, lk in locks]


def ladder(ref, port, eng, table, read_ts, monkeypatch, ctx=""):
    """Every rung of both packages on one engine → (the port's device
    table, its bundle, the reference's bundle)."""
    pe = port_engine(eng)
    tid = table.table_id
    pinfos, rinfos = infos_of(table, True), infos_of(table, False)
    (tbl_d, safe_d, locks_d, bundle), labels, _ph = labelled(
        prc.build_region_columnar_ex, pe.snapshot(), tid, pinfos, read_ts,
        device_resolver=port.mvcc_resolver())
    assert labels.get("cold_build") == "device", (ctx, labels)
    assert bundle is not None, ctx
    (tbl_n, safe_n, locks_n), labels, _ph = labelled(
        prc.build_region_columnar, pe.snapshot(), tid, pinfos, read_ts)
    assert labels.get("cold_build") == "native", (ctx, labels)
    monkeypatch.setattr(pnv, "mvcc_build_columnar", refuse)
    (tbl_i, safe_i, locks_i), labels, _ph = labelled(
        prc.build_region_columnar, pe.snapshot(), tid, pinfos, read_ts)
    monkeypatch.undo()
    assert labels.get("cold_build") == "interpreted", (ctx, labels)
    tbl_r, safe_r, locks_r, rbundle = rrc.build_region_columnar_ex(
        eng.snapshot(), tid, rinfos, read_ts,
        device_resolver=ref.mvcc_resolver())
    assert rbundle is not None, ctx
    assert safe_d == safe_n == safe_i == safe_r, ctx
    assert lock_ids(locks_d) == lock_ids(locks_n) == lock_ids(locks_i) \
        == lock_ids(locks_r), ctx
    for other in (tbl_n, tbl_i, tbl_r):
        same_rows(tbl_d, other, ctx)
    return tbl_d, bundle, rbundle


def mint_both(ref, port, table, tbl, bundle, rbundle, dtypes) -> None:
    """The port's mint against the reference's and against the upload of
    the host mirror."""
    pinfos, rinfos = infos_of(table, True), infos_of(table, False)
    n = len(tbl)
    got = bundle.mint(port, list(pinfos), list(dtypes), n,
                      port._pad_rows(n))
    want = rbundle.mint(ref, list(rinfos), list(dtypes), n,
                        ref._pad_rows(n))
    _same_feed(got, want)
    _same_feed(got, port._build_flat(_host_cols(tbl, pinfos, dtypes), n))


@pytest.mark.parametrize("rnd", range(6))
def test_randomized_version_history_parity(ref, port, rnd, monkeypatch):
    """Seeded random histories: versions across read_ts, deletes, NULLs, a
    rollback; every rung of both packages at four read timestamps, and the
    newest read's mint."""
    rng = np.random.default_rng(20260804 + rnd)
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    tid = 7000 + rnd
    n_cols = int(rng.integers(2, 5))
    table = int_table(n_cols, table_id=tid)
    ts, commits, live = 10, [], set()
    for _gen in range(int(rng.integers(2, 5))):
        muts = []
        for h in sorted(int(x) for x in rng.choice(
                200, size=int(rng.integers(20, 80)), replace=False)):
            if rng.random() < 0.15 and h in live:
                muts.append(Mutation("delete", encode_table_row(
                    table, h, {})[0], None))
                live.discard(h)
            else:
                muts.append(Mutation("put", *encode_table_row(table, h, {
                    f"c{i}": (None if rng.random() < 0.3 else
                              int(rng.integers(-50, 50)))
                    for i in range(n_cols)})))
                live.add(h)
        commits.append(ts + 1)
        ts = commit(storage, ts, muts)
    storage.sched_txn_command(cmds.Rollback(
        [encode_table_row(table, 3, {})[0]], ts))
    for read_ts in (5, commits[0], commits[-1] // 2 + 3, BIG):
        tbl, bundle, rbundle = ladder(ref, port, eng, table, read_ts,
                                      monkeypatch, f"ts {read_ts}")
        if read_ts == BIG and len(tbl):
            mint_both(ref, port, table, tbl, bundle, rbundle,
                      ["int64"] * (n_cols + 1))
        else:
            bundle.release()
            rbundle.release()


def test_wide_schema_nulls_and_default_cf_spills(ref, port, monkeypatch):
    """28 columns (a map16 row header), NULLs, and a third of the rows past
    the short-value limit: their cells come from CF_DEFAULT and the mint
    writes them into the gathered planes."""
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    n_cols = 28
    table = RefTable(777, (RefColumn("id", 1, RefFieldType.long(
        not_null=True), is_pk_handle=True),) + tuple(
        RefColumn(f"c{i}", 2 + i, RefFieldType.long())
        for i in range(n_cols)))
    commit(storage, 10, [Mutation("put", *encode_table_row(table, h, {
        f"c{i}": ((1 << 40) + h * 100 + i if h % 3 == 0 else
                  None if (h + i) % 4 == 0 else h - i)
        for i in range(n_cols)})) for h in range(120)])
    tbl, bundle, rbundle = ladder(ref, port, eng, table, BIG, monkeypatch)
    assert bundle.spill_patches and \
        sorted(bundle.spill_patches) == sorted(rbundle.spill_patches)
    mint_both(ref, port, table, tbl, bundle, rbundle,
              ["int64"] * (n_cols + 1))


def test_unsigned_and_real_columns(ref, port, monkeypatch):
    """Unsigned values above 2^63 ride the uint64 plane; REAL float64."""
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    table = RefTable(778, (
        RefColumn("id", 1, RefFieldType.long(not_null=True),
                  is_pk_handle=True),
        RefColumn("u", 2, RefFieldType.long(unsigned=True)),
        RefColumn("r", 3, RefFieldType.double())))
    commit(storage, 10, [Mutation("put", *encode_table_row(
        table, h, {"u": (1 << 63) + h, "r": h * 0.5}))
        for h in range(60)])
    tbl, bundle, rbundle = ladder(ref, port, eng, table, BIG, monkeypatch)
    assert tbl.columns[2].values.dtype == np.uint64
    assert tbl.columns[3].values.dtype == np.float64
    mint_both(ref, port, table, tbl, bundle, rbundle,
              ["int64", "int64", "float64"])


def test_blocking_lock_and_safe_ts_agreement(ref, port, monkeypatch):
    """A pending prewrite in the range surfaces as the same blocking lock
    through every rung, with the same safe_ts."""
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    table = int_table(2, table_id=779)
    ts = commit(storage, 10, [Mutation("put", *encode_table_row(
        table, h, {"c0": h, "c1": h})) for h in range(50)])
    key, value = encode_table_row(table, 7, {"c0": -1, "c1": -1})
    storage.sched_txn_command(
        cmds.Prewrite([Mutation("put", key, value)], key, ts))
    pe = port_engine(eng)
    _t, bundle, rbundle = ladder(ref, port, eng, table, BIG, monkeypatch)
    bundle.release()
    rbundle.release()
    _t, safe, locks = prc.build_region_columnar(
        pe.snapshot(), 779, infos_of(table, True), BIG)
    assert len(locks) == 1 and safe == 11


def test_bytes_schema_stays_on_the_host_ladder(port):
    """A BYTES column leaves the device envelope: the native rung serves,
    with no bundle, as the reference's ladder does."""
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    table = RefTable(780, (
        RefColumn("id", 1, RefFieldType.long(not_null=True),
                  is_pk_handle=True),
        RefColumn("b", 2, RefFieldType.var_char())))
    commit(storage, 10, [Mutation("put", *encode_table_row(
        table, h, {"b": b"x" * h})) for h in range(20)])
    pe = port_engine(eng)
    (tbl, _s, _l, bundle), labels, _ph = labelled(
        prc.build_region_columnar_ex, pe.snapshot(), 780,
        infos_of(table, True), BIG, device_resolver=port.mvcc_resolver())
    assert bundle is None and labels["cold_build"] == "native"
    assert tbl.columns[2].values[5] == b"xxxxx"


def test_mvcc_resolve_failpoint_goes_down_the_ladder(port, monkeypatch):
    """``device::mvcc_resolve`` → the native rung serves; with the native
    entry refusing too → the interpreted rung.  Same rows on each."""
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    table = int_table(2, table_id=781)
    commit(storage, 10, [Mutation("put", *encode_table_row(
        table, h, {"c0": h % 3, "c1": h})) for h in range(80)])
    pe = port_engine(eng)
    infos = infos_of(table, True)

    def build():
        return labelled(prc.build_region_columnar_ex, pe.snapshot(), 781,
                        infos, BIG, device_resolver=port.mvcc_resolver())

    (tbl_dev, _s, _l, bundle), labels, _ph = build()
    assert labels["cold_build"] == "device" and bundle is not None
    bundle.release()
    failpoint.cfg("device::mvcc_resolve", "return")
    try:
        (tbl_nat, _s, _l, bundle), labels, _ph = build()
        assert labels["cold_build"] == "native" and bundle is None
        monkeypatch.setattr(pnv, "mvcc_build_columnar", refuse)
        (tbl_int, _s, _l, bundle), labels, _ph = build()
        assert labels["cold_build"] == "interpreted" and bundle is None
    finally:
        failpoint.teardown()
    same_rows(tbl_dev, tbl_nat)
    same_rows(tbl_dev, tbl_int)


def test_a_mesh_runner_or_no_resolver_keeps_the_host_rungs(port):
    """The device rung needs a single-device runner's resolver."""
    from tikv_tpu_torch.device.mvcc import DeviceMvccResolver
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    table = int_table(2, table_id=783)
    commit(storage, 10, [Mutation("put", *encode_table_row(
        table, h, {"c0": h, "c1": h})) for h in range(10)])
    pe = port_engine(eng)
    infos = infos_of(table, True)
    for res in (None, DeviceMvccResolver(None), object()):
        (_t, _s, _l, bundle), labels, _ph = labelled(
            prc.build_region_columnar_ex, pe.snapshot(), 783, infos, BIG,
            device_resolver=res)
        assert bundle is None and labels["cold_build"] == "native"
    assert port.mvcc_resolver().available()
    assert not port.mvcc_resolver().h2d_profitable()


def test_cache_serves_the_device_rung_end_to_end(ref, port):
    """A region through ``RegionColumnarCache`` with the resolver wired and
    the port's runner (plain versions on the CPU): the feed is minted, no
    upload, and the rows equal the reference's cache served by its host
    pipeline, cold and warm."""
    eng = RefEngine()
    storage = Storage(LocalEngine(eng))
    table = int_table(2, table_id=784)
    ts = commit(storage, 10, [Mutation("put", *encode_table_row(
        table, h, {"c0": h % 7, "c1": h})) for h in range(300)])
    commit(storage, ts, [Mutation("put", *encode_table_row(
        table, h, {"c0": h % 7, "c1": None})) for h in range(0, 300, 5)])
    pe = port_engine(eng, b"z")
    re = RefEngine()
    wb = re.write_batch()
    for cf, keys, vals in ((cf, *pe.snapshot().range_cf(cf, b"", b"\xff")[:2])
                           for cf in ("default", "lock", "write")):
        for k, v in zip(keys, vals):
            wb.put_cf(cf, k, v)
    re.write(wb)
    cache = prc.RegionColumnarCache()
    cache.device_resolver = port.mvcc_resolver()
    region = Region(1)

    def provider(req):
        rs = RegionSnapshot(pe.snapshot(), region)
        rs.data_index = 5
        return cache.get(rs, req.dag)

    ep = Endpoint(provider, port, device_row_threshold=1)
    sel = RefDagSelect.from_table(table, ["id", "c0", "c1"])
    rdag = sel.aggregate([sel.col("c0")], [("count_star", None),
                                           ("sum", sel.col("c1"))]).build(
        start_ts=BIG)
    rcache = rrc.RegionColumnarCache()
    rcache.device_resolver = ref.mvcc_resolver()
    rs = RefRegionSnapshot(re.snapshot(), RefRegion(1))
    rs.data_index = 5
    want = sorted(map(list, RefPipeline(rdag, rcache.get(rs, rdag))
                      .handle_request().rows()), key=lambda r: r[2])
    assert len(want) == 7 and sum(r[0] for r in want) == 300
    mints = port.mvcc_resolver().mints
    for i in range(3):
        resp = ep.handle(CopRequest(REQ_TYPE_DAG, convert.dag_from_wire(
            wire.enc_dag(rdag)), force_backend="device"))
        got = sorted(map(list, resp.rows()), key=lambda r: r[2])
        assert got == want and resp.backend == "device"
        if i == 0:
            assert resp.tracker.labels["cold_build"] == "device"
            assert resp.tracker.labels["device_feed"] == "device_resolve"
            assert "mvcc_parse" in resp.tracker.phases
            assert "feed_upload" not in resp.tracker.phases
    assert port.mvcc_resolver().mints == mints + 1
    assert cache.stats()["device_builds"] == 1
