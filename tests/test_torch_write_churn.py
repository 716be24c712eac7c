"""Writes reach the feed as patches: the port's runner over the port's
delta-maintained cache (``DeviceRunner._try_patch_feed`` →
``digest.patch_feed_spans``) against the reference runner over the
reference's cache, and against the host truth.

Both packages apply the same committed records and serve the same
requests through their endpoints (the shape of
``tests/test_write_churn.py``, in process).  After one write the next
request is served by ``delta_apply`` + ``feed_patch``, labelled ``patch``,
with no upload and no build; the patched planes equal a fresh upload's bit
for bit and the reference's patched feed; the recorded R' of each plane
equals a re-hash of it; each refusal of the patch route uploads instead,
with the same answer; a split child's stashed feed is patched; a
row-sharded feed re-uploads.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax

from tikv_tpu.copr.endpoint import CopRequest as RefRequest
from tikv_tpu.copr.endpoint import Endpoint as RefEndpoint
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.device.supervisor import DeviceStateSupervisor as RefSup
from tikv_tpu.device.supervisor import FeedArena as RefArena
from tikv_tpu.device.supervisor import host_plane_digest
from tikv_tpu.parallel import make_mesh as ref_make_mesh
from tikv_tpu.testing.dag import DagSelect as RefDagSelect
from tikv_tpu.testing.fixture import int_table as ref_int_table
from tikv_tpu.utils import tracker as ref_tracker

from tikv_tpu_torch.codec.keys import table_record_key
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.device import digest as dg
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.device.supervisor import DeviceStateSupervisor
from tikv_tpu_torch.parallel import make_mesh
from tikv_tpu_torch.raftstore.metapb import Region, RegionEpoch
from tikv_tpu_torch.storage.txn_types import encode_key
from tikv_tpu_torch.testing import mvcc as tm
from tikv_tpu_torch.testing.dag import DagSelect

from tests.test_torch_region_cache import TID, port_table, snaps
from tests.test_torch_region_cache_delta import Rig

N = 3000


@pytest.fixture(scope="module")
def ref_runner():
    return RefRunner(mesh=ref_make_mesh(jax.devices()[:1]))


def plans(plan: str, ts: int):
    """(port dag, reference dag) of ``plan`` at ``ts``: "agg" GROUP BY c0:
    COUNT(*), SUM(c1); "sel" c1 > 990; "partial" c1 > 990 over the handles
    below 1500 (a ranged feed)."""
    import dataclasses
    out = []
    for table, Sel in ((port_table(), DagSelect),
                       (ref_int_table(2, table_id=TID), RefDagSelect)):
        s = Sel.from_table(table, ["id", "c0", "c1"])
        dag = s.aggregate([s.col("c0")], [("count_star", None),
                                          ("sum", s.col("c1"))]) \
            if plan == "agg" else s.where(s.col("c1") > 990)
        out.append(dag.build(ts))
    pd, rd = out
    if plan == "partial":
        from tikv_tpu.executors.ranges import KeyRange as RefKeyRange
        from tikv_tpu_torch.executors.ranges import KeyRange
        a, b = table_record_key(TID, 0), table_record_key(TID, 1500)
        pd = dataclasses.replace(pd, ranges=(KeyRange(a, b),))
        rd = dataclasses.replace(rd, ranges=(RefKeyRange(a, b),))
    return pd, rd


class Churn(Rig):
    """``Rig``'s writes, with both runners and supervisors on the hosts and
    both endpoints; a numpy model of the rows for the host truth."""

    def __init__(self, ref_runner, port_runner=None, ref=True,
                 sink_kw=None):
        super().__init__(sink_kw={"max_entries": 4096, **(sink_kw or {})})
        self.prunner = port_runner or DeviceRunner(device="cpu")
        self.psup = DeviceStateSupervisor(self.prunner, self.pc, self.psink)
        self.phost.register(self.psup)
        self.pep = Endpoint(self._psnap, self.prunner,
                            device_row_threshold=1)
        self.rrunner = None
        if ref:
            ref_runner._arena = RefArena()
            self.rrunner = ref_runner
            self.rsup = RefSup(runner=ref_runner, copr_cache=self.rc,
                               delta_sink=self.rsink)
            self.rc.on_line_retired = self.rsup.on_line_retired
            self.rhost.register(self.rsup)
            self.rep = RefEndpoint(self._rsnap, ref_runner,
                                   device_row_threshold=1)
        self.model: dict = {}

    def _psnap(self, req):
        return self.pc.get(snaps(self.pe, self.re, self.regions,
                                 self.index)[0], req.dag)

    def _rsnap(self, req):
        return self.rc.get(snaps(self.pe, self.re, self.regions,
                                 self.index)[1], req.dag)

    def put_rows(self, rows: dict, null_c1=()) -> None:
        self.put(rows, null_c1)
        for h, (a, b) in rows.items():
            self.model[h] = (a, None if h in null_c1 else b)

    def delete_rows(self, hs) -> None:
        self.records(hs, tm.WT_DELETE)
        for h in hs:
            self.model.pop(h, None)

    def truth(self, plan: str, hi: int = 1 << 62) -> list:
        if plan in ("sel", "partial"):
            return sorted((h, a, b) for h, (a, b) in self.model.items()
                          if b is not None and b > 990 and h < hi)
        agg: dict = {}
        for a, b in self.model.values():
            cnt, s = agg.get(a, (0, None))
            agg[a] = (cnt + 1, s if b is None else (s or 0) + b)
        return sorted((cnt, s, g) for g, (cnt, s) in agg.items())

    def serve(self, plan: str, ts=None, ref: bool = True) -> dict:
        """One request of ``plan`` through each endpoint → the port's
        labels and phases (ms), and the reference's labels; the rows equal
        each other and the truth (at the newest ts)."""
        pd, rd = plans(plan, self.ts + 5 if ts is None else ts)
        presp = self.pep.handle(CopRequest(REQ_TYPE_DAG, pd))
        prow = sorted(presp.rows(), key=repr)
        out = {"backend": presp.backend,
               "labels": dict(presp.tracker.labels),
               "phases": {k: v / 1e6 for k, v in
                          presp.tracker.phases.items()}, "rows": prow}
        if ref and self.rrunner is not None:
            tr, tok = ref_tracker.install()
            try:
                rresp = self.rep.handle(RefRequest(REQ_TYPE_DAG, rd))
            finally:
                ref_tracker.uninstall(tok)
            assert prow == sorted(rresp.rows(), key=repr), plan
            out["ref_labels"] = dict(tr.labels)
        if ts is None:
            want = self.truth(plan, 1500 if plan == "partial" else 1 << 62)
            assert sorted(map(tuple, prow), key=repr) == \
                sorted(want, key=repr), plan
        return out

    def feed(self, plan: str):
        """The port's resident feed of ``plan`` and the reference's."""
        pent, rent, _ = self.get()
        pf = [f for f in self.prunner.resident_feeds(pent).values()]
        rf = []
        if self.rrunner is not None:
            b = self.rrunner._arena.bucket(rent.feed_lineage, create=False)
            rf = [v for v in (b or {}).values()
                  if isinstance(v, dict) and "flat" in v]
        width = {"agg": 2, "sel": 3}[plan]
        pick = [f for f in pf if len(f["null_flags"]) == width]
        rpick = [f for f in rf if len(f["null_flags"]) == width]
        return pick[0], (rpick[0] if rpick else None), pent


def base(rig: Churn, n: int = N) -> None:
    rig.put_rows({h: (h % 5, h % 1000) for h in range(n)},
                 null_c1=set(range(0, n, 97)))


WRITES = {
    "one update": lambda rig: rig.put_rows({7: (3, 995)}),
    "four runs": lambda rig: rig.put_rows(
        {h: (1, 999) for r in range(4) for h in range(600 * r, 600 * r + 64)}),
    "a NULL update": lambda rig: rig.put_rows({9: (0, 5)}, null_c1={9}),
    "appends": lambda rig: rig.put_rows(
        {h: (h % 5, 991) for h in range(N, N + 40)}),
    "a rollback": lambda rig: rig.records([11], tm.WT_ROLLBACK),
}


def fresh_planes(runner, feed, pent, plan: str) -> list:
    """The planes a fresh upload of ``pent`` makes for ``plan``'s feed."""
    pd, _ = plans(plan, pent.build_ts)
    batch = pent.scan_columns(pd.executors[0], pd.ranges)
    cols = [(batch.columns[ci].values.astype(np.dtype(str(t.dtype).split(
        ".")[1]), copy=False), batch.columns[ci].validity)
        for ci, t in zip(*_used(feed, plan))]
    return runner._build_flat(cols, batch.num_rows)


def _used(feed, plan: str):
    """(scan column index per used column, its value plane)."""
    cis = [1, 2] if plan == "agg" else [0, 1, 2]
    fi, planes = 0, []
    for has_nulls in feed["null_flags"]:
        planes.append(feed["flat"][fi])
        fi += 2 if has_nulls else 1
    return cis, planes


@pytest.mark.parametrize("write", sorted(WRITES))
def test_single_write_is_patched_not_uploaded(ref_runner, write):
    rig = Churn(ref_runner)
    base(rig)
    for plan in ("agg", "sel"):
        cold = rig.serve(plan)
        assert cold["labels"]["device_feed"] == "upload"
    WRITES[write](rig)
    for plan in ("agg", "sel"):
        got = rig.serve(plan)
        assert got["backend"] == "device"
        assert got["labels"]["device_feed"] == "patch", got["labels"]
        assert got["ref_labels"]["device_feed"] == "patch"
        assert "feed_upload" not in got["phases"]
        assert "columnar_build" not in got["phases"]
        assert "feed_patch" in got["phases"]
        if plan == "agg":
            assert got["labels"]["copr_cache"] == "delta"
            assert "delta_apply" in got["phases"]
        feed, rfeed, pent = rig.feed(plan)
        # bit for bit: a fresh upload of the patched snapshot, and the
        # reference's patched feed
        fresh = fresh_planes(rig.prunner, feed, pent, plan)
        assert feed["n_live"] == fresh["n_live"] == len(rig.model)
        for a, b, c in zip(feed["flat"], fresh["flat"], rfeed["flat"]):
            assert a.numpy().tobytes() == b.numpy().tobytes() == \
                np.asarray(c).tobytes()
        # the recorded R' equals a re-hash of the patched plane, and the
        # reference's record
        assert [dg.as_u64(d) for d in feed["digests"]] == \
            [host_plane_digest(a.numpy(), feed["n_live"])
             for a in feed["flat"]] == \
            [int(np.asarray(d)) % (1 << 64) for d in rfeed["digests"]]
        assert rig.prunner.scrub_feed(feed) == []
    assert rig.pc.stats()["rebuilds"] == 0 and rig.pc.misses == 1
    assert rig.prunner.feed_routes == {"upload": 2, "patch": 2}


def test_patches_chain_their_records(ref_runner, monkeypatch):
    """Four writes, each read after it: one ``patch_feed_spans`` call a
    journal patch with spans (the rollback's has none: no call), over every
    plane of the feed; each call reads the R' the last one left."""
    calls = []
    real = dg.patch_feed_spans

    def counted(planes, spans, vals, digests=None):
        calls.append((len(planes), len(spans),
                      all(not isinstance(d, int) for d in digests)))
        return real(planes, spans, vals, digests)

    from tikv_tpu_torch.device import runner as rmod
    monkeypatch.setattr(rmod, "patch_feed_spans", counted)
    rig = Churn(ref_runner)
    base(rig)
    rig.serve("agg")
    for w in ("one update", "four runs", "a rollback", "appends"):
        WRITES[w](rig)
        got = rig.serve("agg")
        assert got["labels"]["device_feed"] == "patch"
    # c0 and c1 (c1 with its validity plane): three planes a call
    assert [c[:2] for c in calls] == [(3, 1), (3, 4), (3, 1)]
    assert [c[2] for c in calls] == [False, True, True]
    feed, rfeed, _pent = rig.feed("agg")
    assert rig.prunner.scrub_feed(feed) == []


REFUSALS = {
    # a structural patch (a tombstone)
    "delete": lambda rig: rig.delete_rows([5]),
    # a value outside the feed's int32 plane
    "wide value": lambda rig: rig.put_rows({8: (1, 1 << 40)}),
    # the first NULL in a column whose feed has no validity plane
    "first NULL of c0": lambda rig: _null_c0(rig, 12),
}


def _null_c0(rig: Churn, h: int) -> None:
    hs = np.asarray([h], np.int64)
    rig.apply(tm.kv_history(TID, hs, [tm.Event(
        rig.tick(), tm.WT_PUT, np.arange(1),
        {2: (np.zeros(1, np.int64), np.zeros(1, np.bool_)),
         3: (np.asarray([7]), np.ones(1, np.bool_))})]))
    rig.model[h] = (None, 7)


@pytest.mark.parametrize("refusal", sorted(REFUSALS))
def test_refusals_upload_with_the_same_answer(ref_runner, refusal):
    rig = Churn(ref_runner)
    base(rig)
    for plan in ("agg", "sel"):
        rig.serve(plan)
    REFUSALS[refusal](rig)
    for plan in ("agg", "sel"):
        got = rig.serve(plan)
        assert got["labels"]["device_feed"] == "upload", \
            (plan, got["labels"])
        assert got["ref_labels"]["device_feed"] == "upload"
        assert "feed_patch" not in got["phases"]
        assert "feed_upload" in got["phases"]
    assert rig.pc.stats()["rebuilds"] == 0


def test_ranged_feed_uploads(ref_runner):
    """A feed over a part of the line: journal positions do not map to its
    rows, so it uploads (on both)."""
    rig = Churn(ref_runner)
    base(rig)
    rig.serve("partial")
    WRITES["one update"](rig)
    got = rig.serve("partial")
    assert got["labels"]["device_feed"] == got["ref_labels"][
        "device_feed"] == "upload"


def test_pad_bucket_crossed_uploads(ref_runner):
    """Appends past the feed's pad bucket upload (a port runner with
    1024-row blocks: 3,000 rows pad to 3,072)."""
    rig = Churn(ref_runner, DeviceRunner(device="cpu", chunk_rows=1024),
                ref=False)
    base(rig)
    rig.serve("sel", ref=False)
    rig.put_rows({h: (0, 999) for h in range(N, N + 72)})     # 3,072
    assert rig.serve("sel", ref=False)["labels"]["device_feed"] == "patch"
    rig.put_rows({h: (0, 999) for h in range(N + 72, N + 80)})
    got = rig.serve("sel", ref=False)
    assert got["labels"]["device_feed"] == "upload"
    rig.put_rows({h: (0, 999) for h in range(N + 80, N + 90)})
    got = rig.serve("sel", ref=False)
    assert got["labels"]["device_feed"] == "patch"


def test_history_read_gets_a_feed_of_its_own(ref_runner):
    """A read below the write's commit is served by the old generation; its
    feed is its own (never cached), and the shared feed stays at the new
    version."""
    rig = Churn(ref_runner)
    base(rig)
    old_ts = rig.ts + 5
    rig.serve("sel")
    old_truth = rig.truth("sel")
    WRITES["one update"](rig)
    rig.serve("sel")
    got = rig.serve("sel", ts=old_ts)
    assert sorted(map(tuple, got["rows"])) == old_truth
    assert got["labels"]["device_feed"] == "upload"
    feed, _rf, pent = rig.feed("sel")
    assert feed["lineage_v"] == pent.feed_lineage.version == 1
    assert rig.serve("sel")["labels"]["device_feed"] == "hit"
    assert rig.pc.misses == 1


def test_split_stash_child_is_patched(ref_runner):
    """A write lands on the left child before its first request: the
    stashed child feed is taken and patched forward (label ``split``, as
    the reference's), with the truth's answer."""
    rig = Churn(ref_runner)
    base(rig)
    for plan in ("agg", "sel"):
        rig.serve(plan)
    sk = encode_key(table_record_key(TID, 1500))
    from tikv_tpu.raftstore.metapb import Region as RefRegion
    from tikv_tpu.raftstore.metapb import RegionEpoch as RefEpoch
    left = (Region(1, b"", sk, RegionEpoch(1, 2)),
            RefRegion(1, b"", sk, RefEpoch(1, 2)))
    right = (Region(2, sk, b"", RegionEpoch(1, 2)),
             RefRegion(2, sk, b"", RefEpoch(1, 2)))
    for host, i in ((rig.phost, 0), (rig.rhost, 1)):
        host.notify_region_split(left[i], right[i], rig.index, rig.index)
        host.notify_region_changed(left[i])
    assert rig.psup.splits == rig.rsup.splits == 1
    rig.regions = left
    rig.put_rows({7: (4, 996)})
    rig.model = {h: v for h, v in rig.model.items() if h < 1500}
    for plan in ("agg", "sel"):
        got = rig.serve(plan)
        assert got["labels"]["device_feed"] == \
            got["ref_labels"]["device_feed"] == "split", got["labels"]
        assert "feed_patch" in got["phases"]
        assert "feed_upload" not in got["phases"]
    assert rig.prunner.feed_routes.get("split") == 2


def test_row_sharded_feed_reuploads():
    """A mesh feed is not patched in place: it uploads, counted, with the
    single runner's answer."""
    mesh = DeviceRunner(mesh=make_mesh(["cpu"] * 4), chunk_rows=512)
    rig = Churn(None, mesh, ref=False)
    base(rig)
    rig.serve("agg", ref=False)
    WRITES["one update"](rig)
    got = rig.serve("agg", ref=False)
    assert got["labels"]["device_feed"] == "upload"
    assert got["labels"]["copr_cache"] == "delta"
    assert mesh.feed_routes == {"upload": 2}


def test_writes_leave_no_dead_memos(ref_runner):
    """Five writes, each read by a sparse GROUP BY (its keys span past
    ``MAX_HASH_CAPACITY``: a slot plane cached on the device in the plan's
    memo): the anchor's bucket keeps one memo a plan and one dtypes entry,
    rolled forward to each write's version, so its entries and its device
    bytes stay flat, and every answer equals the reference's and the
    truth."""
    from tikv_tpu_torch.device.runner import MAX_HASH_CAPACITY
    from tikv_tpu_torch.device.supervisor import _bucket_nbytes
    rig = Churn(ref_runner)
    rig.put_rows({h: (h * 4099, h % 1000) for h in range(N)})
    assert (N - 1) * 4099 > MAX_HASH_CAPACITY
    rig.serve("agg")
    pent, _rent, _ = rig.get()
    runner = rig.prunner
    bucket = runner._arena.bucket(runner._feed_anchor(pent), create=False)
    keys = sorted(map(repr, bucket))
    nbytes = _bucket_nbytes(bucket)
    resident = runner._arena.resident_bytes()
    (meta,) = [v for k, v in bucket.items() if k[0] == "meta"]
    assert "sparse_slots" in meta and nbytes > sum(
        int(t.nbytes) for f in runner.resident_feeds(pent).values()
        for t in f["flat"])
    for i in range(5):
        h = 10 + 37 * i
        rig.put_rows({h: (h * 4099 + 1, 990 + i)})
        got = rig.serve("agg")
        assert got["labels"]["device_feed"] == "patch"
        pent, _rent, _ = rig.get()
        assert runner._arena.bucket(runner._feed_anchor(pent),
                                    create=False) is bucket
        assert sorted(map(repr, bucket)) == keys
        assert _bucket_nbytes(bucket) == nbytes
        assert runner._arena.resident_bytes() == resident
        (meta,) = [v for k, v in bucket.items() if k[0] == "meta"]
        assert meta["lineage_v"] == pent.feed_lineage.version == i + 1
        assert "sparse_slots" in meta
