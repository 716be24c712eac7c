"""Feed migration between mesh slices: the port against the JAX package.

A placement mesh moves a region's resident feeds from one single-device
slice to another (``SlicePlacer.migrate``: the source's ``extract_feeds``,
a copy into the destination's own storage, and ``install_feeds``, whose
arrival check is one ``digest.feed_verify`` over every plane of a feed).
The port (``DeviceRunner(mesh=make_mesh(["cpu"] * 4), placement=True)``,
the plain version of every kernel) and the reference
(``DeviceRunner(mesh=make_mesh(jax.devices()[:4]), placement=True)``) take
the same seeded snapshots, requests and migrations: their answers, verdicts
and counters are equal, answers exactly (and equal to the host
pipeline's).  ``feed_verify_plain`` is held to ``plane_digest_plain`` per
plane and to the reference's ``host_plane_digest`` over planes of 1, 2, 4
and 8 bytes and ragged ranges; the children of a region split on a
placement mesh are pinned to their parent's slice, as the reference's
``adopt`` pins them, and serve their stashed feeds there.
"""

import numpy as np
import pytest
import torch

from tikv_tpu.device.supervisor import host_plane_digest
from tikv_tpu.executors.runner import BatchExecutorsRunner
from tikv_tpu.utils import failpoint as ref_failpoint

from tikv_tpu_torch.device import digest as dg
from tikv_tpu_torch.utils import failpoint

from tests.test_torch_placement import (agg_dag, make_snap, make_table,
                                        port_runner, ref_runner, rows,
                                        sel_dag, slice_of)
from tests.test_torch_selection import port_dag, port_snapshot


@pytest.fixture(autouse=True)
def _teardown_failpoints():
    yield
    failpoint.teardown()
    ref_failpoint.teardown()


def _rig(tid: int, n: int = 2048, seed: int = 1, null_frac: float = 0.0):
    """Both runners warm on one snapshot (an aggregation and a selection):
    (ref, port, dags, port dags, snap, port snap, host answers)."""
    ref, port = ref_runner(), port_runner()
    table = make_table(tid)
    snap = make_snap(table, n, seed, null_frac)
    psnap = port_snapshot(table, snap)
    dags = [agg_dag(table), sel_dag(table, 10_000)]
    pdags = [port_dag(d) for d in dags]
    hosts = [rows(BatchExecutorsRunner(d, snap).handle_request())
             for d in dags]
    for d, pd_, h in zip(dags, pdags, hosts):
        assert rows(ref.handle_request(d, snap)) == h
        assert rows(port.handle_request(pd_, psnap)) == h
    assert slice_of(ref, snap) == slice_of(port, psnap)
    return ref, port, dags, pdags, snap, psnap, hosts


def _serve(ref, port, dags, pdags, snap, psnap, hosts):
    for d, pd_, h in zip(dags, pdags, hosts):
        assert rows(ref.handle_request(d, snap)) == h
        assert rows(port.handle_request(pd_, psnap)) == h


def test_migrate_moves_the_feeds_into_the_destinations_own_storage():
    ref, port, dags, pdags, snap, psnap, hosts = _rig(5101, null_frac=0.1)
    src = slice_of(port, psnap)
    dst = (src + 1) % 4
    anchor, ranchor = port._feed_anchor(psnap), ref._feed_anchor(snap)
    src_r, dst_r = port.placer.slices[src], port.placer.slices[dst]
    old = {k: v for k, v in src_r._arena.bucket(anchor,
                                                 create=False).items()
           if isinstance(v, dict) and "flat" in v}
    old_ptrs = {t.data_ptr() for f in old.values() for t in f["flat"]}
    assert len(old) == 2        # the aggregation's and the selection's
    assert ref.placer.migrate(ranchor, src, dst)
    assert port.placer.migrate(anchor, src, dst)
    assert slice_of(port, psnap) == slice_of(ref, snap) == dst
    assert src_r._arena.bucket(anchor, create=False) is None
    moved = dst_r._arena.bucket(anchor, create=False)
    for key, feed in old.items():
        got = moved[key]
        assert all(t.data_ptr() not in old_ptrs for t in got["flat"]), \
            "the destination shares the source's storage"
        assert [dg.as_u64(d) for d in got["digests"]] == \
            [dg.as_u64(d) for d in feed["digests"]]
        for a, b in zip(got["flat"], feed["flat"]):
            assert torch.equal(a, b)
    assert dst_r._arena.resident_bytes() == sum(
        t.nbytes for f in old.values() for t in f["flat"])
    uploads = port.route_stats()["feed_routes"].get("upload", 0)
    _serve(ref, port, dags, pdags, snap, psnap, hosts)
    assert port.route_stats()["feed_routes"].get("upload", 0) == uploads, \
        "a migrated feed was uploaded again"
    for r in (ref, port):
        st = r.placer.stats()
        assert st["migrations"] == 1 and st["migration_failures"] == 0
        assert st["last_migration_ms"] > 0
    assert set(port.placer.stats()["last_migration_phases"]) == \
        {"copy", "verify", "install"}
    for r in (ref, port):
        r.close()


def test_stale_copy_never_overwrites_a_newer_generation():
    ref, port, dags, pdags, snap, psnap, hosts = _rig(5103)
    for r, s in ((ref, snap), (port, psnap)):
        anchor = r._feed_anchor(s)
        src_r = r.placer.owner(anchor)
        feeds, skipped = src_r.extract_feeds(anchor)
        assert feeds and skipped == 0
        for f in feeds.values():
            f["lineage_v"] = 1          # the generation in flight
        dst_r = r.placer.slices[(r.placer.slices.index(src_r) + 1) % 4]
        assert dst_r.install_feeds(anchor, feeds) == "moved"
        fkey = next(iter(feeds))
        bucket = dst_r._arena.bucket(anchor, create=False)
        newer = dict(bucket[fkey])
        newer["lineage_v"] = 2          # a request minted a newer one
        bucket[fkey] = newer
        assert dst_r.install_feeds(anchor, {fkey: feeds[fkey]}) == "moved"
        assert dst_r._arena.bucket(anchor, create=False)[fkey] is newer
        r.drop_feed(anchor)
        r.close()


def test_bad_indices_and_same_slice_do_nothing():
    ref, port, dags, pdags, snap, psnap, hosts = _rig(5104)
    for r, s in ((ref, snap), (port, psnap)):
        anchor = r._feed_anchor(s)
        src = slice_of(r, s)
        before = r.placer.stats()
        for a, b in ((src, src), (src, 4), (-1, src), (src, -1), (9, 0)):
            assert not r.placer.migrate(anchor, a, b)
        after = r.placer.stats()
        assert slice_of(r, s) == src
        for k in ("migrations", "migration_failures"):
            assert after[k] == before[k], k
    _serve(ref, port, dags, pdags, snap, psnap, hosts)
    for r in (ref, port):
        r.close()


def test_a_flipped_bit_on_arrival_is_caught_and_minted_again():
    """``device::feed_migrate`` flips one bit of an arrived plane: the
    arrival check returns "corrupt", nothing is installed on the
    destination, the source's feeds are dropped, its slice struck as a
    scrub fault and the anchor quarantined: its next request is answered
    on the host (the port's runner raises ``FeedQuarantined``, which the
    endpoint degrades; the reference's answers it itself), and the ones
    after mint the feed again, exactly."""
    ref, port, dags, pdags, snap, psnap, hosts = _rig(5105)
    src = slice_of(port, psnap)
    dst = (src + 2) % 4
    anchor, ranchor = port._feed_anchor(psnap), ref._feed_anchor(snap)
    verdicts = []
    ref_failpoint.cfg("device::feed_migrate", "return")
    failpoint.cfg("device::feed_migrate", "return")
    dst_r = port.placer.slices[dst]
    feeds, _ = port.placer.slices[src].extract_feeds(anchor)
    assert dst_r.install_feeds(anchor, feeds) == "corrupt"
    assert dst_r._arena.bucket(anchor, create=False) is None
    verdicts.append(ref.placer.migrate(ranchor, src, dst))
    verdicts.append(port.placer.migrate(anchor, src, dst))
    failpoint.teardown()
    ref_failpoint.teardown()
    assert verdicts == [False, False]
    for r, a in ((ref, ranchor), (port, anchor)):
        st = r.placer.stats()
        assert st["migration_failures"] == 1 and st["migrations"] == 0
        assert not r.placer.slices[dst]._arena.bucket(a, create=False)
        assert not r.placer.slices[src]._arena.bucket(a, create=False)
        health = r._board.slice(src).stats()
        assert health["strikes"] == {"scrub": 1} and health["score"] == 1.0
    uploads = port.route_stats()["feed_routes"].get("upload", 0)
    from tikv_tpu_torch.device import FeedQuarantined
    with pytest.raises(FeedQuarantined):
        port.handle_request(pdags[0], psnap)
    assert rows(ref.handle_request(dags[0], snap)) == hosts[0]
    assert port.hbm_stats()["quarantined"] == 0
    _serve(ref, port, dags, pdags, snap, psnap, hosts)
    assert port.route_stats()["feed_routes"]["upload"] == uploads + 2
    assert port.route_stats()["degrades"] == {}
    for r in (ref, port):
        r.close()


def test_a_feed_without_digests_is_skipped_and_counted():
    ref, port, dags, pdags, snap, psnap, hosts = _rig(5106)
    for r, s in ((ref, snap), (port, psnap)):
        anchor = r._feed_anchor(s)
        src = slice_of(r, s)
        src_r = r.placer.slices[src]
        bucket = src_r._arena.bucket(anchor, create=False)
        keys = [k for k, v in bucket.items()
                if isinstance(v, dict) and "flat" in v]
        bucket[keys[0]] = dict(bucket[keys[0]], digests=None)
        feeds, skipped = src_r.extract_feeds(anchor)
        assert skipped == 1 and list(feeds) == keys[1:]
        bucket[keys[1]] = dict(bucket[keys[1]], digests=None)
        assert src_r.extract_feeds(anchor) == (None, 2)
        assert not r.placer.migrate(anchor, src, (src + 1) % 4)
        assert r.placer.stats()["migration_failures"] == 1
    _serve(ref, port, dags, pdags, snap, psnap, hosts)
    for r in (ref, port):
        r.close()


def test_a_mesh_feed_does_not_migrate():
    port = port_runner()
    assert port.extract_feeds(object()) == (None, 0)


# ------------------------------------------------------------ the kernel


def _ref_digest(arr: np.ndarray, lo: int, hi: int) -> int:
    return (host_plane_digest(arr, hi) - host_plane_digest(arr, lo)) \
        & ((1 << 64) - 1)


@pytest.mark.parametrize("lo,hi", [(0, 1000), (0, 1), (3, 997), (7, 8),
                                   (500, 500), (0, 0), (1, 1000)])
def test_feed_verify_plain_is_plane_digest_per_plane(lo, hi):
    rng = np.random.default_rng(lo * 1009 + hi)
    n = 1000
    hosts = [rng.random(n) < 0.5,
             rng.integers(-128, 128, n).astype(np.int8),
             rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16),
             rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
             rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64),
             rng.normal(0, 1e6, n).astype(np.float32),
             rng.normal(0, 1e300, n)]
    planes = [torch.from_numpy(h) for h in hosts]
    got = dg.feed_verify_plain(planes, lo, hi)
    assert got.shape == (len(planes),) and got.dtype == torch.int64
    assert torch.equal(dg.feed_verify(planes, lo, hi), got)
    for g, p, h in zip(got.tolist(), planes, hosts):
        assert g == dg.plane_digest_plain(p, lo, hi).item()
        assert dg.as_u64(g) == _ref_digest(h, lo, hi)


def test_feed_verify_checks_its_planes():
    a = torch.zeros(10, dtype=torch.int32)
    assert dg.feed_verify([], 0, 0).shape == (0,)
    with pytest.raises(ValueError):
        dg.feed_verify([a, torch.zeros(5, dtype=torch.int32)], 0, 8)
    with pytest.raises(ValueError):
        dg.feed_verify([a.reshape(2, 5)], 0, 2)
    with pytest.raises(ValueError):
        dg.feed_verify([a], 4, 2)
    with pytest.raises(ValueError):
        dg.feed_verify([a.to("meta")], 0, 10)
    assert dg.VERIFY_PARAM_PLANES * 32 + 16 <= 4096, \
        "the descriptors must fit the 4 KiB of launch parameters"


# ------------------------------------------------------------- adoption


class _Anchor:
    """A weak-referenceable stand-in for a feed lineage."""


def test_adopt_pins_children_to_the_parents_slice():
    ref, port = ref_runner(), port_runner()
    for r in (ref, port):
        parents = [_Anchor() for _ in range(3)]
        for p in parents:
            r.placer.route(p, n_hint=10)
        idx = [r.placer.slices.index(r.placer.owner(p)) for p in parents]
        kids = [_Anchor(), None, _Anchor()]
        r.placer.adopt(parents[1], kids)
        assert [r.placer.slices.index(r.placer.owner(k))
                for k in kids if k is not None] == [idx[1]] * 2
        assert r.placer.stats()["adoptions"] == 2
        r.placer.adopt(_Anchor(), [_Anchor()])      # unplaced parent
        assert r.placer.stats()["adoptions"] == 2
        try:
            for i in range(4):
                r._board.trip(i, "test")
            assert r.placer.owner(parents[2]) is not None
            r.placer.adopt(parents[2], [_Anchor()])     # dead slice: no pin
            assert r.placer.stats()["adoptions"] == 2
        finally:
            r._board.reset()
        r.close()
    # the same slices on both (by creation order and equal scores)
    rr, pp = ref_runner(), port_runner()
    a, b = _Anchor(), _Anchor()
    for x in (a, b):
        rr.placer.route(x, n_hint=10)
        pp.placer.route(x, n_hint=10)
    assert [rr.placer.slices.index(rr.placer.owner(x)) for x in (a, b)] == \
        [pp.placer.slices.index(pp.placer.owner(x)) for x in (a, b)]


def test_split_children_serve_on_the_parents_slice():
    """A region split on a placement mesh: the parent's feed is sliced on
    its slice, the children are adopted there, and each child's first
    request takes its stashed feed (``device_feed=split``) with the exact
    count."""
    from tikv_tpu_torch.codec.keys import table_record_key
    from tikv_tpu_torch.convert import engine_from_triples
    from tikv_tpu_torch.copr.endpoint import (REQ_TYPE_DAG, CopRequest,
                                              Endpoint)
    from tikv_tpu_torch.copr.region_cache import RegionColumnarCache
    from tikv_tpu_torch.device.supervisor import DeviceStateSupervisor
    from tikv_tpu_torch.raftstore.metapb import Region, RegionEpoch
    from tikv_tpu_torch.raftstore.observer import CoprocessorHost
    from tikv_tpu_torch.raftstore.peer import RegionSnapshot
    from tikv_tpu_torch.storage.txn_types import encode_key
    from tikv_tpu_torch.testing import mvcc as tm
    from tikv_tpu_torch.testing.dag import DagSelect
    table = tm.table_6c()
    h = np.arange(2000, dtype=np.int64)
    ones = np.ones(2000, np.bool_)
    ev = tm.Event(100, tm.WT_PUT, h, {2: (h % 7, ones),
                                      3: (h % 1000, ones)})
    engine = engine_from_triples(tm.kv_history(table.table_id, h, [ev]))
    runner = port_runner()
    cache = RegionColumnarCache()
    host = CoprocessorHost()
    sup = DeviceStateSupervisor(runner, cache)
    host.register(sup)
    region = [Region(1)]

    def provider(req):
        rs = RegionSnapshot(engine.snapshot(), region[0])
        rs.data_index = 100
        return cache.get(rs, req.dag)

    ep = Endpoint(provider, runner, device_row_threshold=1)
    s = DagSelect.from_table(table, ["id", "c0", "c1"])
    dag = s.aggregate([s.col("c0")], [("count_star", None)]).build(200)

    def count():
        r = ep.handle(CopRequest(REQ_TYPE_DAG, dag, force_backend="device"))
        return sum(row[0] for row in r.rows()), \
            r.tracker.labels["device_feed"]

    assert count() == (2000, "upload")
    parent = next(a for a, _b in runner.arena_items())
    pidx = runner.placer.slices.index(runner.placer.owner(parent))
    sk = encode_key(table_record_key(table.table_id, 1234))
    left = Region(1, b"", sk, RegionEpoch(1, 2))
    right = Region(2, sk, b"", RegionEpoch(1, 2))
    host.notify_region_split(left, right, 100, 100)
    host.notify_region_changed(left)
    assert sup.splits == 1 and runner.placer.stats()["adoptions"] == 2
    got = []
    for region[0] in (left, right):
        got.append(count())
    assert got == [(1234, "split"), (766, "split")], got
    assert runner.route_stats()["feed_routes"]["split"] == 2
    kids = [a for a, _b in runner.arena_items() if a is not parent]
    assert kids and all(runner.placer.slices.index(runner.placer.owner(k))
                        == pidx for k in kids)
    ep.close()
    runner.close()
