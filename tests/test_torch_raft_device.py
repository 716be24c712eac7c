"""The card's half of the region lifecycle, driven by raft, on the CPU.

Each package's in-process ``Cluster`` of three stores carries, on stores 1
and 2, a ``DeltaSink``, a ``RegionColumnarCache`` and a
``DeviceStateSupervisor`` on the store's coprocessor host, each with a
runner of its own (the port's ``DeviceRunner(device="cpu")``, the
reference's on JAX's CPU); store 3 stays host-only.  Reads go through an
``Endpoint`` over a lease-read snapshot of the store's ``RaftKv``.  The same
scenario runs through both packages, and after each step the answers equal
each other's and the numpy model's, and the supervisors' counters, the
caches' resident lines and the feed labels are the reference's:

- a raft split of a resident feed slices it (``splits`` counted, the
  children's first requests labelled ``split``, no upload), through
  ``Cluster.split_region`` and through the split checker;
- a leader round trip (to store 2 and back) promotes store 1's lines by a
  digest re-verify of every resident plane, no build;
- a corrupted plane makes that promotion rebuild;
- a merge drops both lines, and the merged region's next read builds once;
- a snapshot apply drops a follower's line;
- a destroyed peer leaves no feed in its store's arena.

Last, readers in threads go through a split and a leader round trip while
the driving thread applies them under a node lock, as ``Node`` does, under
a timeout: the order node lock → dispatch lock cannot invert.
"""

from __future__ import annotations

import importlib
import sys
import threading

import numpy as np
import pytest

import jax

from tikv_tpu_torch.device import runner as rmod
from tikv_tpu_torch.device import split as psplit

PKGS = ("tikv_tpu", "tikv_tpu_torch")
TID = 9900
N = 4000
BLOBS = 4
GROUPS = 16


def m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def table(pkg: str):
    if pkg == "tikv_tpu":
        return m(pkg, "testing.fixture").int_table(2, table_id=TID)
    return m(pkg, "testing.mvcc").table_6c()


def new_runner(pkg: str):
    if pkg == "tikv_tpu":
        return m(pkg, "device.runner").DeviceRunner(
            mesh=m(pkg, "parallel").make_mesh(jax.devices()[:1]))
    return m(pkg, "device.runner").DeviceRunner(device="cpu")


class Model:
    """The rows (handle → (c0, c1)) and the answers they give."""

    def __init__(self, n: int = N):
        self.h = np.arange(n, dtype=np.int64)
        self.c0 = self.h % GROUPS
        self.c1 = self.h % 1000

    def truth(self, plan: str, lo: int = 0, hi: int = 1 << 62) -> list:
        m_ = (self.h >= lo) & (self.h < hi)
        if plan == "count":
            return [(int(m_.sum()),)]
        if plan == "sel":
            m_ &= self.c1 > 990
            return [(int(a), int(b), int(c)) for a, b, c in
                    zip(self.h[m_], self.c0[m_], self.c1[m_])]
        out = []
        for g in range(GROUPS):
            s = m_ & (self.c0 == g)
            if s.any():
                out.append((int(s.sum()), int(self.c1[s].sum()), g))
        return out


class Rig:
    """One package's cluster of three stores, stores 1 and 2 on a runner."""

    def __init__(self, pkg: str, device_stores=(1, 2)):
        self.pkg = pkg
        self.table = table(pkg)
        self.c = m(pkg, "testing.cluster").Cluster(n_stores=3, seed=0)
        self.c.bootstrap()
        self.c.start()
        self.ts = 100
        self.dev: dict = {}
        for sid in device_stores:
            sink = m(pkg, "copr.delta").DeltaSink(max_entries=4096,
                                                  max_rows=1 << 16)
            cache = m(pkg, "copr.region_cache").RegionColumnarCache(
                capacity=8, delta_source=sink)
            runner = new_runner(pkg)
            sup = m(pkg, "device.supervisor").DeviceStateSupervisor(
                runner=runner, copr_cache=cache, delta_sink=sink)
            cache.on_line_retired = sup.on_line_retired
            host = self.c.stores[sid].coprocessor_host
            host.register(sink)
            host.register(sup)
            ep = m(pkg, "copr.endpoint").Endpoint(
                lambda req, sid=sid: self._provider(sid, req), runner,
                device_row_threshold=1)
            self.dev[sid] = {"cache": cache, "runner": runner, "sup": sup,
                             "ep": ep, "region": 1}

    # -- writes ---------------------------------------------------------

    def propose(self, region_id: int, cmd_fn):
        peer = self.c.leader_peer(region_id)
        box: dict = {}
        peer.propose(cmd_fn(peer.region),
                     lambda r: box.__setitem__("r", r))
        self.c._drive_until(lambda: "r" in box)
        if isinstance(box["r"], Exception):
            raise box["r"]
        return box["r"]

    def load(self, model: Model) -> None:
        """``BLOBS`` SST v2 blobs, one raft ingest entry each on region 1,
        then region 1's log compacted to its applied index."""
        rs = m(self.pkg, "raftstore")
        sst = m(self.pkg, "sst_importer").fast_mvcc_table_sst
        for lo in range(0, len(model.h), len(model.h) // BLOBS):
            h = model.h[lo:lo + len(model.h) // BLOBS]
            blob = sst(TID, h, [(2, model.c0[h], None),
                                (3, model.c1[h], None)], self.ts)
            self.propose(1, lambda r, b=blob: rs.RaftCmd(
                1, r.epoch, (rs.WriteOp("ingest", "", b"", b),)))
        self.compact(1)

    def compact(self, region_id: int) -> None:
        rs = m(self.pkg, "raftstore")
        self.propose(region_id, lambda r: rs.RaftCmd(
            region_id, r.epoch, admin=rs.AdminCmd(
                "compact_log",
                compact_index=self.c.leader_peer(region_id).node.applied)))

    def update(self, model: Model, hs, c1) -> None:
        """One 2PC transaction of UPDATEs of c1."""
        codec_keys = m(self.pkg, "codec.keys")
        row = m(self.pkg, "codec.row")
        self.ts += 10
        self.c.txn_write([("put", codec_keys.table_record_key(TID, int(h)),
                           row.encode_row({2: int(model.c0[h]),
                                           3: int(v)}))
                          for h, v in zip(hs, c1)],
                         start_ts=self.ts, commit_ts=self.ts + 1)
        self.ts += 2
        model.c1[np.asarray(hs)] = c1

    # -- reads ----------------------------------------------------------

    def _provider(self, sid: int, req):
        kv_engine = m(self.pkg, "kv.engine")
        snap = self.c.kvs[sid].snapshot(
            kv_engine.SnapContext(region_id=self.dev[sid]["region"]))
        return self.dev[sid]["cache"].get(snap, req.dag)

    def dag(self, plan: str):
        s = m(self.pkg, "testing.dag").DagSelect.from_table(
            self.table, ["id", "c0", "c1"])
        if plan == "count":
            d = s.aggregate([], [("count_star", None)])
        elif plan == "sel":
            d = s.where(s.col("c1") > 990)
        else:
            d = s.aggregate([s.col("c0")], [("count_star", None),
                                            ("sum", s.col("c1"))])
        return d.build(self.ts + 5)

    def serve(self, sid: int, region_id: int, plan: str) -> tuple:
        """One request of ``plan`` on ``region_id`` at store ``sid`` →
        (sorted rows, the feed label)."""
        ep_mod = m(self.pkg, "copr.endpoint")
        tracker = m(self.pkg, "utils.tracker")
        self.dev[sid]["region"] = region_id
        tr, tok = tracker.install()
        try:
            resp = self.dev[sid]["ep"].handle(ep_mod.CopRequest(
                ep_mod.REQ_TYPE_DAG, self.dag(plan),
                force_backend="device"))
        finally:
            tracker.uninstall(tok)
        assert resp.backend == "device", resp.backend
        rows = sorted(tuple(r) for r in resp.rows())
        if plan == "agg":
            rows = sorted(rows, key=lambda r: r[2])
        return rows, tr.labels.get("device_feed")

    # -- state ----------------------------------------------------------

    def counters(self, sid: int) -> tuple:
        d = self.dev[sid]
        sup = d["sup"]
        return (sup.splits, sup.split_fallbacks, sup.promotions,
                sup.promotion_rebuilds, sup.demotions,
                sup.lifecycle_invalidations)

    def regions(self) -> list:
        out = []
        for sid in sorted(self.c.stores):
            for rid in sorted(self.c.stores[sid].peers):
                r = self.c.stores[sid].peers[rid].region
                out.append((sid, r.id, r.start_key, r.end_key,
                            r.epoch.conf_ver, r.epoch.version,
                            tuple((p.id, p.store_id, p.is_learner)
                                  for p in r.peers)))
        return out

    def region_by_handle(self, h: int) -> int:
        key = m(self.pkg, "storage.txn_types").encode_key(
            m(self.pkg, "codec.keys").table_record_key(TID, h))
        return self.c.stores[1].peer_by_key(key).region.id

    def handle_bounds(self, region_id: int) -> tuple:
        tt = m(self.pkg, "storage.txn_types")
        keys = m(self.pkg, "codec.keys")
        r = self.c.stores[1].peers[region_id].region
        lo = keys.decode_record_handle(tt.decode_key(r.start_key)) \
            if r.start_key else 0
        hi = keys.decode_record_handle(tt.decode_key(r.end_key)) \
            if r.end_key else 1 << 62
        return lo, hi

    def resident_regions(self, sid: int) -> set:
        return {getattr(a, "region_hint", None)
                for a, bucket in self.dev[sid]["runner"].arena_items()
                if any(isinstance(v, dict) and "flat" in v
                       for v in bucket.values())}


def both(fn):
    """``fn(rig, model)`` through each package → (reference's, port's)."""
    return tuple(fn(Rig(pkg), Model()) for pkg in PKGS)


def ask(rig: Rig, model: Model, sid: int, rid: int, labels: list) -> None:
    lo, hi = rig.handle_bounds(rid)
    for plan in ("agg", "sel"):
        rows, label = rig.serve(sid, rid, plan)
        assert rows == model.truth(plan, lo, hi), (rig.pkg, plan, rid)
        labels.append((sid, rid, plan, label))


@pytest.fixture
def counted(monkeypatch):
    """Launch counts of the port's split and digest wrappers on the CPU."""
    n = {"split_planes": 0, "plane_digest": 0}
    real_split, real_digest = psplit.split_planes, rmod.plane_digest

    def split(*a, **k):
        n["split_planes"] += 1
        return real_split(*a, **k)

    def digest(*a, **k):
        n["plane_digest"] += 1
        return real_digest(*a, **k)

    monkeypatch.setattr(psplit, "split_planes", split)
    monkeypatch.setattr(rmod, "plane_digest", digest)
    return n


def test_raft_split_slices_resident_feeds(counted):
    def drive(rig, model):
        rig.load(model)
        labels = []
        ask(rig, model, 1, 1, labels)
        ask(rig, model, 1, 1, labels)
        before = rig.counters(1)
        # the PD-style split at a record key, then the checker's
        tt, keys = (m(rig.pkg, "storage.txn_types"),
                    m(rig.pkg, "codec.keys"))
        right = rig.c.split_region(1, tt.encode_key(
            keys.table_record_key(TID, N // 2 + 1)))
        after_split = rig.counters(1)
        for rid in (1, right.id):
            ask(rig, model, 1, rid, labels)
            ask(rig, model, 1, rid, labels)
        for store in rig.c.stores.values():
            store.config.region_split_size_mb = 64 / 1024.0
        peer = rig.c.stores[1].peers[right.id]
        size, entries = rig.c.stores[1]._scan_region(peer)
        want_key = rig.c.stores[1].find_split_key(peer, entries)
        buckets = rig.c.stores[1]._bucket_bounds(entries)
        peer.size_diff_hint = 1 << 30
        for rid in rig.c.stores[1].peers:
            if rid != right.id:
                rig.c.stores[1].peers[rid].size_diff_hint = 0
        assert rig.c.split_check_all() == 1
        rids = sorted(rig.c.stores[1].peers)
        for rid in rids:
            ask(rig, model, 1, rid, labels)
        return (labels, before, after_split, rig.counters(1), rig.regions(),
                size, want_key, buckets, rig.resident_regions(1),
                rig.dev[1]["cache"].region_resident(1))
    ref, port = both(drive)
    assert port == ref
    labels, before, after_split, end = port[:4]
    # the warm parent: an upload, then hits
    assert [x[3] for x in labels[:4]] == ["upload", "upload", "hit", "hit"]
    # the children's first requests take the sliced feeds
    assert [x[3] for x in labels[4:12]] == ["split", "split", "hit", "hit"] \
        * 2
    # the checker's split: both of its children sliced too
    assert all(x[3] in ("split", "hit") for x in labels[12:]), labels[12:]
    # one parent line a split (both plans read the same columns)
    assert after_split[0] - before[0] == 1 and after_split[1] == 0
    assert end[0] == 2 and end[1] == 0
    assert counted["split_planes"] == 8      # 2 splits × 2 children × 2
    assert port[6] is not None and port[5] > 0


def test_split_of_a_feed_without_planes(counted):
    """COUNT(*) alone reads no column: its feed has no plane, and the
    split's child feed has none either — no launch, no error out of
    apply — as in the reference."""
    def drive(rig, model):
        rig.load(model)
        out = [rig.serve(1, 1, "count")]
        tt, keys = (m(rig.pkg, "storage.txn_types"),
                    m(rig.pkg, "codec.keys"))
        right = rig.c.split_region(1, tt.encode_key(
            keys.table_record_key(TID, 1500)))
        for rid in (1, right.id, 1, right.id):
            out.append(rig.serve(1, rid, "count"))
        return out, rig.counters(1)
    ref, port = both(drive)
    assert port == ref
    rows = [r for r, _ in port[0]]
    assert rows == [[(N,)], [(1500,)], [(N - 1500,)], [(1500,)],
                    [(N - 1500,)]]
    assert [lab for _, lab in port[0]] == ["upload", "split", "split",
                                           "hit", "hit"]
    assert counted["split_planes"] == 0


def test_leader_round_trip_promotes_without_a_build(counted):
    def drive(rig, model):
        rig.load(model)
        labels = []
        ask(rig, model, 1, 1, labels)
        rig.update(model, np.arange(100, 164), (np.arange(64) * 7) % 1000)
        ask(rig, model, 1, 1, labels)
        planes = sum(len(f["digests"]) for a, b in
                     rig.dev[1]["runner"].arena_items()
                     for f in b.values()
                     if isinstance(f, dict) and "flat" in f)
        c0 = rig.counters(1)
        rig.c.transfer_leader(1, 2)
        assert rig.c.leader_store(1) == 2
        ask(rig, model, 2, 1, labels)
        rig.update(model, [7], [995])
        d0 = counted["plane_digest"]
        rig.c.transfer_leader(1, 1)
        assert rig.c.leader_store(1) == 1
        digests[rig.pkg] = counted["plane_digest"] - d0
        c1 = rig.counters(1)
        ask(rig, model, 1, 1, labels)
        return labels, planes, c0, c1, rig.counters(2)
    digests: dict = {}
    ref, port = both(drive)
    assert port == ref
    labels, planes, c0, c1, _c2 = port
    # one plane_digest a resident plane of store 1, in the promotion
    assert digests["tikv_tpu_torch"] == planes
    # promotions + 1 and no rebuild; a demotion on the way out
    assert (c1[2] - c0[2], c1[3] - c0[3], c1[4] - c0[4]) == (1, 0, 1)
    # store 2 minted its own; store 1's lines came back warm and patched
    assert labels[4][3] == "upload"
    assert labels[-2][3] in ("patch", "hit") and labels[-1][3] in \
        ("patch", "hit")
    assert planes > 0


def test_corrupted_plane_makes_the_promotion_rebuild():
    def drive(rig, model):
        rig.load(model)
        labels = []
        ask(rig, model, 1, 1, labels)
        rig.c.transfer_leader(1, 2)
        feeds = [f for a, b in rig.dev[1]["runner"].arena_items()
                 for f in b.values() if isinstance(f, dict) and "flat" in f]
        rig.dev[1]["runner"].corrupt_resident_plane(feeds[0])
        rig.c.transfer_leader(1, 1)
        c = rig.counters(1)
        ask(rig, model, 1, 1, labels)
        return labels, c
    ref, port = both(drive)
    assert port == ref
    labels, c = port
    assert c[3] == 1
    assert [x[3] for x in labels[2:]] == ["upload", "upload"]


def test_merge_drops_both_lines_and_builds_once():
    def drive(rig, model):
        rig.load(model)
        tt, keys = (m(rig.pkg, "storage.txn_types"),
                    m(rig.pkg, "codec.keys"))
        right = rig.c.split_region(1, tt.encode_key(
            keys.table_record_key(TID, 1234)))
        labels = []
        for rid in (1, right.id):
            ask(rig, model, 1, rid, labels)
        inv = rig.dev[1]["sup"].lifecycle_invalidations
        merged = rig.c.merge_region(right.id, 1)
        dropped = rig.dev[1]["sup"].lifecycle_invalidations - inv
        misses = rig.dev[1]["cache"].misses
        ask(rig, model, 1, merged.id, labels)
        return (labels, dropped, rig.dev[1]["cache"].misses - misses,
                rig.regions(), rig.resident_regions(1), right.id)
    ref, port = both(drive)
    assert port[:5] == ref[:5]
    labels, dropped, builds, regions, resident, right_id = port
    assert dropped >= 2 and builds == 1
    assert all(r[1] != right_id for r in regions)     # destroyed everywhere
    assert right_id not in resident
    assert [x[3] for x in labels[-2:]] == ["upload", "upload"]


def test_snapshot_apply_drops_a_followers_line():
    def drive(rig, model):
        rig.load(model)
        labels = []
        rig.c.transfer_leader(1, 2)
        ask(rig, model, 2, 1, labels)
        rig.c.transfer_leader(1, 1)
        resident = rig.dev[2]["cache"].region_resident(1)
        # store 2 falls behind a compacted log: a snapshot catches it up
        filt = rig.c.isolate_store(2)
        rig.update(model, [11, 12], [991, 992])
        rig.compact(1)
        rig.c.heal(filt)
        rig.c.tick_all(8)
        after = rig.dev[2]["cache"].region_resident(1)
        engine_rows = len(rig.c.engines[2].range_cf(
            "write", b"z", b"{")[0])
        return labels, resident, after, engine_rows, rig.counters(2)
    ref, port = both(drive)
    assert port == ref
    _labels, resident, after, rows, _c = port
    assert resident >= 1 and after == 0 and rows >= N


def test_destroyed_peer_leaves_no_feed():
    def drive(rig, model):
        rig.load(model)
        labels = []
        rig.c.transfer_leader(1, 2)
        ask(rig, model, 2, 1, labels)
        rig.c.transfer_leader(1, 1)
        had = 1 in rig.resident_regions(2)
        victim = rig.c.stores[2].peers[1].meta
        rig.c.change_peer(1, "remove", victim)
        rig.c.pump()
        return (labels, had, 1 in rig.c.stores[2].peers,
                rig.resident_regions(2), rig.dev[2]["cache"].region_resident(1))
    ref, port = both(drive)
    assert port == ref
    _labels, had, still, resident, lines = port
    assert had and not still and 1 not in resident and lines == 0


def test_reads_race_a_split_and_a_leader_round_trip():
    """Readers in threads (a lease read under the node lock, the cache and
    the runner outside it) against a driving thread that applies a split
    and a leader round trip under that lock: the apply enters the runner
    (``split_planes``, ``plane_digest``) under the node lock, the readers
    hold the dispatch lock without it; everything ends within the
    timeout, and every answer is its region's truth."""
    rig, model = Rig("tikv_tpu_torch"), Model()
    rig.load(model)
    node_lock = threading.RLock()
    kv_mod = m(rig.pkg, "raftstore.raftkv")
    kv_engine = m(rig.pkg, "kv.engine")

    def driver(done):
        with node_lock:
            rig.c._drive_until(done)

    kv = kv_mod.RaftKv(rig.c.stores[1], driver=driver, lock=node_lock)
    d = rig.dev[1]
    ep_mod = m(rig.pkg, "copr.endpoint")

    def provider(req, rid):
        snap = kv.snapshot(kv_engine.SnapContext(region_id=rid))
        return d["cache"].get(snap, req.dag)

    # the warm parent first
    ask(rig, model, 1, 1, [])
    errors, answers = [], []
    stop = threading.Event()

    def reader(plan: str):
        try:
            while not stop.is_set():
                with node_lock:
                    rids = sorted(rig.c.stores[1].peers)
                    bounds = {r: rig.handle_bounds(r) for r in rids}
                for rid in rids:
                    ep = ep_mod.Endpoint(lambda req, r=rid: provider(req, r),
                                         d["runner"], device_row_threshold=1)
                    try:
                        resp = ep.handle(ep_mod.CopRequest(
                            ep_mod.REQ_TYPE_DAG, rig.dag(plan),
                            force_backend="device"))
                    except Exception as e:     # noqa: BLE001 — a region
                        # that split or moved under the read: retried
                        if type(e).__name__ in ("EpochNotMatch",
                                                "NotLeaderError",
                                                "RegionNotFound",
                                                "KeyNotInRegion"):
                            continue
                        raise
                    rows = sorted(tuple(r) for r in resp.rows())
                    if plan == "agg":
                        rows = sorted(rows, key=lambda r: r[2])
                    # the region's range when the read was routed, or
                    # after it (a split applied in between)
                    with node_lock:
                        now = rig.handle_bounds(rid)
                    if rows not in (model.truth(plan, *bounds[rid]),
                                    model.truth(plan, *now)):
                        errors.append((plan, rid, len(rows)))
                    answers.append(rid)
        except Exception as e:     # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=reader, args=(p,), daemon=True)
               for p in ("agg", "sel") * 4]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        tt, keys = (m(rig.pkg, "storage.txn_types"),
                    m(rig.pkg, "codec.keys"))
        with node_lock:
            right = rig.c.split_region(1, tt.encode_key(
                keys.table_record_key(TID, 2001)))
        with node_lock:
            rig.c.transfer_leader(right.id, 2)
        with node_lock:
            rig.c.transfer_leader(right.id, 1)
        threading.Event().wait(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "a reader hung: the locks inverted"
    finally:
        stop.set()
        sys.setswitchinterval(switch)
    assert errors == []
    assert answers and right.id in answers
    assert d["sup"].splits == 1 and d["sup"].split_fallbacks == 0
    assert d["sup"].promotions >= 1
