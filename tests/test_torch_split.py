"""The device split of a resident feed against the reference's.

- ``split.split_planes_plain`` against the reference's
  ``DeviceRunner._split_plane_kernel`` (jitted on the CPU), bit for bit,
  zero tails included, and its digests against ``host_plane_digest`` of
  the child's truth; the wrapper's limits;
- ``_take_split_feed``'s shape matching (as
  ``tests/test_feed_migration.py::test_take_split_feed_matches_shape_exactly``);
- the split end to end on both packages from the same engine bytes: a
  region's cache line and warm device feeds, then ``notify_region_split``
  and ``notify_region_changed`` on each package's ``CoprocessorHost``, then
  the children's requests through each endpoint.  Answers, child feeds
  (planes, zero tails, digests), feed labels, stashes, the dropped parent
  feed and the supervisor's counters must agree, and the answers equal a
  numpy truth of the history;
- the refusals and fallbacks, each against the reference: an armed
  ``device::device_split``, a corrupted parent row, split keys below,
  above and between the handles, no right peer, a parent line behind
  ``left_index``, and feeds that are not positional (a partial range, a
  descending scan, an index scan);
- a parent request deferred before the split and fetched after its feed
  was dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tikv_tpu.copr.endpoint import CopRequest as RefRequest
from tikv_tpu.copr.endpoint import Endpoint as RefEndpoint
from tikv_tpu.copr.region_cache import RegionColumnarCache as RefCache
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.device.supervisor import DeviceStateSupervisor as RefSup
from tikv_tpu.device.supervisor import host_plane_digest as ref_digest
from tikv_tpu.parallel import make_mesh
from tikv_tpu.raftstore.observer import CoprocessorHost as RefHost
from tikv_tpu.testing.dag import DagSelect as RefDagSelect
from tikv_tpu.testing.fixture import int_table as ref_int_table
from tikv_tpu.utils import failpoint as ref_failpoint
from tikv_tpu.utils import tracker as ref_tracker
from tikv_tpu_torch.codec.keys import table_record_key
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.copr.region_cache import FeedLineage, RegionColumnarCache
from tikv_tpu_torch.datatype import FieldType
from tikv_tpu_torch.device import split as sp
from tikv_tpu_torch.device.digest import as_u64
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.device.supervisor import (DeviceStateSupervisor,
                                              host_plane_digest)
from tikv_tpu_torch.raftstore.observer import CoprocessorHost
from tikv_tpu_torch.storage.txn_types import encode_key
from tikv_tpu_torch.testing import mvcc as tm
from tikv_tpu_torch.testing.dag import DagSelect
from tikv_tpu_torch.testing.fixture import Table, TableColumn
from tikv_tpu_torch.utils import failpoint

from tests.test_torch_region_cache import (CACHE_TS, TID, engines, history,
                                           region_pair, snaps)


@pytest.fixture(autouse=True)
def _teardown_failpoints():
    yield
    failpoint.teardown()
    ref_failpoint.teardown()


@pytest.fixture(scope="module")
def ref_runner():
    # its construction turns on x64, which float64 and int64 planes need
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


# ------------------------------------------------------ the kernel itself

DTYPES = {"bool": (torch.bool, np.bool_), "int32": (torch.int32, np.int32),
          "int64": (torch.int64, np.int64),
          "float32": (torch.float32, np.float32),
          "float64": (torch.float64, np.float64)}
N_PARENT = 1000
N_PAD_PARENT = 1024


def parent_plane(dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    _t, nd = DTYPES[dtype]
    if nd is np.bool_:
        x = rng.random(N_PAD_PARENT) < 0.5
    elif np.dtype(nd).kind == "f":
        x = (rng.standard_normal(N_PAD_PARENT) * 1e6).astype(nd)
        x[:3] = (-0.0, np.inf, np.nan)
    else:
        info = np.iinfo(nd)
        x = rng.integers(info.min, info.max, N_PAD_PARENT, dtype=nd,
                         endpoint=True)
    x[N_PARENT:] = 0        # the parent's own zero tail
    return x


def child_cases():
    """(side, pos, n_child, n_pad_child): the edge positions, children of
    one row, child pads below and equal to the parent's."""
    out = []
    for pos in (0, 1, 7, 333, 500, N_PARENT - 1, N_PARENT):
        for right in (False, True):
            n_child = N_PARENT - pos if right else pos
            if n_child <= 0:
                continue
            for n_pad in sorted({max(8, -(-n_child // 8) * 8),
                                 N_PAD_PARENT}):
                out.append((right, pos, n_child, n_pad))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_plain_matches_reference_kernel(ref_runner, dtype):
    x = parent_plane(dtype, len(dtype))
    tx = torch.from_numpy(x.copy())
    for right, pos, n_child, n_pad in child_cases():
        kern = ref_runner._split_plane_kernel(x.dtype, N_PAD_PARENT, n_pad,
                                              right)
        want = np.asarray(kern(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                               jnp.asarray(n_child, jnp.int32)))
        (got,), digests = sp.split_planes_plain([tx], pos, n_child, n_pad,
                                                right)
        assert got.dtype == tx.dtype and got.shape == (n_pad,)
        g = got.numpy()
        assert g.tobytes() == want.tobytes(), (right, pos, n_child, n_pad)
        truth = np.zeros(n_pad, x.dtype)
        lo = pos if right else 0
        truth[:n_child] = x[lo:lo + n_child]
        assert g.tobytes() == truth.tobytes()
        assert as_u64(digests[0]) == host_plane_digest(truth, n_child) == \
            ref_digest(truth, n_child)
        # the wrapper on a CPU tensor is the plain version
        (again,), d2 = sp.split_planes([tx], pos, n_child, n_pad, right)
        assert again.numpy().tobytes() == g.tobytes()
        assert as_u64(d2[0]) == as_u64(digests[0])


def test_split_planes_many_planes_and_limits():
    planes = [torch.from_numpy(parent_plane(d, i))
              for i, d in enumerate(sorted(DTYPES) * 52)][:sp.MAX_PLANES]
    outs, digests = sp.split_planes(planes, 333, N_PARENT - 333, 768, True)
    assert len(outs) == sp.MAX_PLANES and digests.shape == (sp.MAX_PLANES,)
    for x, y, d in zip(planes, outs, digests):
        want = np.zeros(768, x.numpy().dtype)
        want[:N_PARENT - 333] = x.numpy()[333:N_PARENT]
        assert y.numpy().tobytes() == want.tobytes()
        assert as_u64(d) == host_plane_digest(want, N_PARENT - 333)
    with pytest.raises(ValueError, match="at most"):
        sp.split_planes(planes + planes[:1], 0, 10, 16, False)
    for bad in ((0, 10, 2000, False), (1, N_PAD_PARENT, N_PAD_PARENT, True),
                (0, 20, 16, False), (-1, 5, 16, True)):
        with pytest.raises(ValueError):
            sp.split_planes(planes[:2], *bad)
    with pytest.raises(ValueError, match="parent's rows"):
        sp.split_planes([planes[0], planes[1][:10]], 0, 5, 8, False)


def test_take_split_feed_matches_shape_exactly():
    """The stash serves only a request whose feed matches the candidate:
    columns, device dtypes, live rows and this runner's pad bucket."""
    runner = DeviceRunner(device="cpu")
    lineage = FeedLineage()
    n = 100
    pad = runner._pad_rows(n)
    feed = {"n_live": n, "n_pad": pad, "flat": (), "null_flags": ()}
    lineage.split_stash = [
        {"col_ids": (1, 2), "dtypes": ("int64", "int64"), "feed": feed}]
    scan = ("TableScanDesc", None, False)
    key = (scan, (1, 2), ("int64", "int64"), ())
    assert runner._take_split_feed(lineage, key, n + 1) is None
    assert runner._take_split_feed(
        lineage, (scan, (1, 3), ("int64", "int64"), ()), n) is None
    assert runner._take_split_feed(
        lineage, (scan, (1, 2), ("int64", "int32"), ()), n) is None
    lineage.split_stash[0]["feed"] = dict(feed, n_pad=2 * pad)
    assert runner._take_split_feed(lineage, key, n) is None
    lineage.split_stash[0]["feed"] = feed
    got = runner._take_split_feed(lineage, key, n)
    assert got is not None and got["n_live"] == n
    assert not lineage.split_stash, "consumption is one-shot"
    assert runner._take_split_feed(lineage, key, n) is None


# -------------------------------------------------------- end to end rig


def port_table() -> Table:
    return Table(TID, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("c0", 2, FieldType.long(), index_id=1),
        TableColumn("c1", 3, FieldType.long(), index_id=2),
    ))


def plan_pair(name: str):
    """(port dag, reference dag) of a plan at CACHE_TS."""
    out = []
    for table, Sel in ((port_table(), DagSelect),
                       (ref_int_table(2, table_id=TID), RefDagSelect)):
        if name == "index":
            s = Sel.from_index(table, "c0", with_handle=True)
            dag = s.order_by(s.col("c0"), desc=True, limit=10)
        else:
            s = Sel.from_table(table, ["id", "c0", "c1"])
            # the partial range is a selection's: the reference serves a
            # partial-range aggregation from the whole region's feed (its
            # bucket tiles, not ported)
            dag = s.where(s.col("c1") > 990) \
                if name in ("sel", "desc", "partial") else s.aggregate([s.col("c0")], [("count_star", None),
                                                 ("sum", s.col("c1"))])
        out.append(dag.build(CACHE_TS))
    pd, rd = out
    if name == "desc":
        pd = dataclasses.replace(pd, executors=(dataclasses.replace(
            pd.executors[0], desc=True),) + pd.executors[1:])
        rd = dataclasses.replace(rd, executors=(dataclasses.replace(
            rd.executors[0], desc=True),) + rd.executors[1:])
    if name == "partial":
        from tikv_tpu.executors.ranges import KeyRange as RefKeyRange
        from tikv_tpu_torch.executors.ranges import KeyRange
        a, b = table_record_key(TID, 0), table_record_key(TID, 2400)
        pd = dataclasses.replace(pd, ranges=(KeyRange(a, b),))
        rd = dataclasses.replace(rd, ranges=(RefKeyRange(a, b),))
    return pd, rd


class Rig:
    """Both packages' region lifecycle over the same engine bytes: cache,
    runner, supervisor, observer host, endpoint."""

    def __init__(self, ref_runner, seed: int = 11, n: int = 3000):
        self.pe, self.re = engines(seed, n, lock_ts=10 ** 6)
        self.h, self.events, _locks = history(seed, n)
        self.prunner = DeviceRunner(device="cpu")
        # a fresh arena: the module's reference runner serves every test
        from tikv_tpu.device.supervisor import FeedArena as RefArena
        ref_runner._arena = RefArena()
        self.rrunner = ref_runner
        self.pcache, self.rcache = RegionColumnarCache(), RefCache()
        self.psup = DeviceStateSupervisor(self.prunner, self.pcache)
        self.rsup = RefSup(runner=ref_runner, copr_cache=self.rcache)
        self.rcache.on_line_retired = self.rsup.on_line_retired
        self.phost, self.rhost = CoprocessorHost(), RefHost()
        self.phost.register(self.psup)
        self.rhost.register(self.rsup)
        self.region = None
        self.data_index = 100
        self.pep = Endpoint(self._psnap, self.prunner,
                            device_row_threshold=1)
        self.rep = RefEndpoint(self._rsnap, ref_runner,
                               device_row_threshold=1)

    def _snaps(self):
        return snaps(self.pe, self.re, self.region, self.data_index)

    def _psnap(self, req):
        return self.pcache.get(self._snaps()[0], req.dag)

    def _rsnap(self, req):
        return self.rcache.get(self._snaps()[1], req.dag)

    def serve(self, region, plan: str) -> tuple:
        """→ (sorted rows, port feed label, reference feed label); the two
        packages' rows must be equal."""
        self.region = region
        pd, rd = plan_pair(plan)
        presp = self.pep.handle(CopRequest(REQ_TYPE_DAG, pd,
                                           force_backend="device"))
        tr, tok = ref_tracker.install()
        try:
            rresp = self.rep.handle(RefRequest(REQ_TYPE_DAG, rd,
                                               force_backend="device"))
        finally:
            ref_tracker.uninstall(tok)
        prow = presp.rows()
        rrow = rresp.rows()
        if plan != "index":
            prow, rrow = sorted(prow, key=repr), sorted(rrow, key=repr)
        assert prow == rrow, plan
        assert presp.backend == "device"
        return prow, presp.tracker.labels.get("device_feed"), \
            tr.labels.get("device_feed")

    def split(self, split_handle, left_index=100, right_index=100,
              region=(1, 2)):
        """Split the current region at ``split_handle`` in the reference's
        order on both hosts → (left, right) region pairs."""
        sk = encode_key(table_record_key(TID, split_handle))
        parent = self.region
        version = parent[0].epoch.version + 1
        left = region_pair(region[0], parent[0].start_key, sk, version)
        right = region_pair(region[1], sk, parent[0].end_key, version)
        for host, i in ((self.phost, 0), (self.rhost, 1)):
            host.notify_region_split(left[i], right[i], left_index,
                                     right_index)
            host.notify_region_changed(left[i])
        return left, right

    def truth(self, region, plan: str) -> list:
        """The plan's rows over the history's rows visible at CACHE_TS
        inside ``region``."""
        planes, th, cells = tm.version_history(self.h, self.events,
                                               {2: 0, 3: 0}, CACHE_TS)
        lo = -(1 << 63) if not region[0].start_key else \
            _handle_of(region[0].start_key)
        hi = (1 << 63) if not region[0].end_key else \
            _handle_of(region[0].end_key)
        keep = (th >= lo) & (th < hi)
        c0, ok0 = cells[2][0][keep], cells[2][1][keep]
        c1, ok1 = cells[3][0][keep], cells[3][1][keep]
        hs = th[keep]
        if plan == "sel":
            m = ok1 & (c1 > 990)
            return sorted(((int(a), int(b), int(c)) for a, b, c in
                           zip(hs[m], c0[m], c1[m])), key=repr)
        rows = []
        for g in np.unique(c0[ok0]):
            m = ok0 & (c0 == g)
            s = c1[m & ok1]
            rows.append((int(m.sum()), int(s.sum()) if s.size else None,
                         int(g)))
        return sorted(rows, key=repr)

    def parent_gone(self, lineages) -> bool:
        return all(self.prunner._arena.bucket(p, create=False) is None and
                   self.rrunner._arena.bucket(r, create=False) is None
                   for p, r in lineages)

    def lines(self, region_id: int) -> tuple:
        """(port lineage, reference lineage) of the region's table-scan
        line."""
        def find(cache):
            for key, line in cache._lines.items():
                if key[0] == region_id and line.state is not None and \
                        len(key[3]) == 3:
                    return line.state.lineage
            return None
        return find(self.pcache), find(self.rcache)


def _handle_of(engine_key: bytes) -> int:
    from tikv_tpu_torch.codec.keys import decode_record_handle
    from tikv_tpu_torch.storage.txn_types import decode_key
    return decode_record_handle(decode_key(engine_key))


def stash_parity(plin, rlin) -> int:
    """The two stashes hold the same child feeds: planes bit for bit, zero
    tails included, and digests → how many."""
    ps, rs = plin.split_stash or [], rlin.split_stash or []
    assert len(ps) == len(rs)
    for p in ps:
        r = next(x for x in rs if x["col_ids"] == p["col_ids"] and
                 x["dtypes"] == p["dtypes"])
        pf, rf = p["feed"], r["feed"]
        assert pf["n_live"] == rf["n_live"] and pf["n_pad"] == rf["n_pad"]
        assert pf["null_flags"] == rf["null_flags"]
        assert len(pf["flat"]) == len(rf["flat"])
        for a, b in zip(pf["flat"], rf["flat"]):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        assert [as_u64(d) for d in pf["digests"]] == \
            [int(np.asarray(d)) for d in rf["digests"]]
    return len(ps)


def counts(rig) -> tuple:
    return ((rig.psup.splits, rig.psup.split_fallbacks),
            (rig.rsup.splits, rig.rsup.split_fallbacks))


def warm(rig, region, plans=("agg", "sel")) -> None:
    for plan in plans:
        for _ in range(2):
            rows, pl, rl = rig.serve(region, plan)
            assert pl == rl
            if plan in ("agg", "sel"):
                assert rows == rig.truth(region, plan)


def test_split_end_to_end_matches_reference(ref_runner):
    rig = Rig(ref_runner)
    parent = region_pair()
    warm(rig, parent)
    plin = rig.lines(1)
    left, right = rig.split(1501)       # between handles 1500 and 1503
    assert counts(rig) == ((1, 0), (1, 0))
    assert rig.parent_gone([plin])
    children = {"left": (left, rig.lines(1)), "right": (right, rig.lines(2))}
    for side, (_reg, lins) in children.items():
        assert stash_parity(*lins) == 2, side
    for side, (reg, lins) in children.items():
        for plan in ("agg", "sel"):
            got = [rig.serve(reg, plan) for _ in range(2)]
            assert got[0][0] == got[1][0] == rig.truth(reg, plan)
            assert [g[1:] for g in got] == [("split", "split"),
                                           ("hit", "hit")], (side, plan)
        assert lins[0].split_stash == [] and lins[1].split_stash == []
    assert rig.prunner.feed_routes.get("split") == 4
    # the children's feeds are the split's: no upload after the parent's
    assert rig.prunner.feed_routes.get("upload") == 2
    assert rig.pcache.stats()["splits"] == rig.rcache.stats()["splits"] == 1
    assert rig.pep.degrades == {}


def test_skewed_second_split_matches_reference(ref_runner):
    """Split the right child again at 90% of its rows: an odd row, so its
    planes start unaligned."""
    rig = Rig(ref_runner)
    warm(rig, region_pair())
    left, right = rig.split(1500)
    warm(rig, right)
    n_right = int((rig.h >= 1500).sum())
    h2 = int(rig.h[rig.h >= 1500][int(n_right * 0.9) | 1])
    rig.region = right
    rl, rr = rig.split(h2, region=(2, 3))
    assert counts(rig) == ((2, 0), (2, 0))
    for reg, lins in ((rl, rig.lines(2)), (rr, rig.lines(3))):
        assert stash_parity(*lins) == 2
        for plan in ("agg", "sel"):
            rows, pl, rlab = rig.serve(reg, plan)
            assert (pl, rlab) == ("split", "split")
            assert rows == rig.truth(reg, plan)


def test_armed_device_split_falls_back_like_reference(ref_runner):
    rig = Rig(ref_runner)
    warm(rig, region_pair())
    failpoint.cfg("device::device_split", "return")
    ref_failpoint.cfg("device::device_split", "return")
    left, right = rig.split(1501)
    assert counts(rig) == ((0, 1), (0, 1))
    for reg in (left, right):
        for plan in ("agg", "sel"):
            rows, pl, rl = rig.serve(reg, plan)
            assert (pl, rl) == ("upload", "upload")
            assert rows == rig.truth(reg, plan)
    assert rig.pep.degrades == {}


def test_corrupt_parent_row_fails_that_childs_verify(ref_runner):
    """A bit flip in parent row 0 of the selection feed's first plane: the
    left child's selection feed fails its verify and uploads; everything
    else splits — on both."""
    rig = Rig(ref_runner)
    parent = region_pair()
    warm(rig, parent)
    plin, rlin = rig.lines(1)
    for runner, lin, ref in ((rig.prunner, plin, False),
                             (rig.rrunner, rlin, True)):
        bucket = runner._arena.bucket(lin, create=False)
        feed = next(f for f in bucket.values()
                    if isinstance(f, dict) and "flat" in f and
                    len(f["flat"]) == 4)     # id, c0, c1 + c1's validity
        if ref:
            runner.corrupt_resident_plane(feed)
        else:
            runner.corrupt_resident_plane(feed, 0)
    left, right = rig.split(1501)
    assert counts(rig) == ((1, 0), (1, 0))
    assert stash_parity(*rig.lines(1)) == 1
    assert stash_parity(*rig.lines(2)) == 2
    want = {("left", "agg"): "split", ("left", "sel"): "upload",
            ("right", "agg"): "split", ("right", "sel"): "split"}
    for side, reg in (("left", left), ("right", right)):
        for plan in ("agg", "sel"):
            rows, pl, rl = rig.serve(reg, plan)
            assert (pl, rl) == (want[side, plan],) * 2, (side, plan)
            assert rows == rig.truth(reg, plan)


@pytest.mark.parametrize("where", ("below", "above", "at"))
def test_split_keys_at_the_table_edges(ref_runner, where):
    rig = Rig(ref_runner, n=1200)
    warm(rig, region_pair())
    handle = {"below": -5, "above": 10 ** 6, "at": 600}[where]
    left, right = rig.split(handle)
    assert counts(rig)[0] == counts(rig)[1] == (1, 0)
    for reg, rid in ((left, 1), (right, 2)):
        lins = rig.lines(rid)
        n = stash_parity(*lins)
        for plan in ("agg", "sel"):
            rows, pl, rl = rig.serve(reg, plan)
            assert pl == rl
            assert pl == ("split" if n else None)
            assert rows == rig.truth(reg, plan)


def test_no_right_peer_splits_the_left_child_only(ref_runner):
    rig = Rig(ref_runner, n=1200)
    warm(rig, region_pair())
    left, right = rig.split(1800, right_index=None)
    assert counts(rig)[0] == counts(rig)[1] == (1, 0)
    assert rig.lines(2) == (None, None)
    for reg, want in ((left, "split"), (right, "upload")):
        for plan in ("agg", "sel"):
            rows, pl, rl = rig.serve(reg, plan)
            assert (pl, rl) == (want, want)
            assert rows == rig.truth(reg, plan)


def test_parent_line_behind_left_index_rebuilds(ref_runner):
    """No delta bridge: the parent line is not sliced, nothing counts, the
    children rebuild and upload — on both."""
    rig = Rig(ref_runner, n=1200)
    warm(rig, region_pair())
    left, right = rig.split(1800, left_index=101, right_index=101)
    assert counts(rig) == ((0, 0), (0, 0))
    rig.data_index = 101
    for reg in (left, right):
        for plan in ("agg", "sel"):
            rows, pl, rl = rig.serve(reg, plan)
            assert (pl, rl) == ("upload", "upload")
            assert rows == rig.truth(reg, plan)


def test_non_positional_feeds_are_not_sliced(ref_runner):
    """Warm a partial-range, a descending and an index-scan plan beside
    the full aggregation: only the aggregation's feed is sliced; the
    others' children upload — on both."""
    rig = Rig(ref_runner, n=1200)
    parent = region_pair()
    warm(rig, parent, ("agg", "partial", "desc", "index"))
    left, right = rig.split(1800)
    # two parent lines (the table scan's, the index scan's): the index
    # line has no positional feed, so its split falls back
    assert counts(rig)[0] == counts(rig)[1] == (1, 1)
    assert stash_parity(*rig.lines(1)) == 1
    assert stash_parity(*rig.lines(2)) == 1
    for reg in (left, right):
        for plan, want in (("agg", "split"), ("partial", None),
                           ("desc", "upload"), ("index", "upload")):
            _rows, pl, rl = rig.serve(reg, plan)
            assert pl == rl
            if want is not None:
                assert pl == want, plan
            else:
                # a partial range never takes a child feed
                assert pl in ("upload", None), pl


def test_deferred_parent_request_outlives_the_split():
    """A parent request dispatched before the split and fetched after
    ``on_region_changed`` dropped the parent's feed gives the parent's
    answer; the arena pin it held is gone with the entry."""
    pe, _re = engines(12, 2000, lock_ts=10 ** 6)
    runner = DeviceRunner(device="cpu")
    cache = RegionColumnarCache()
    sup = DeviceStateSupervisor(runner, cache)
    host = CoprocessorHost()
    host.register(sup)
    parent = region_pair()[0]
    from tikv_tpu_torch.raftstore.peer import RegionSnapshot
    rs = RegionSnapshot(pe.snapshot(), parent)
    rs.data_index = 100
    pd, _rd = plan_pair("sel")
    snap = cache.get(rs, pd)
    want = runner.handle_request(pd, snap).rows()
    d = runner.handle_request(pd, snap, deferred=True)
    assert runner.hbm_stats()["pinned_lines"] == 1
    sk = encode_key(table_record_key(TID, 3000))
    left = type(parent)(1, b"", sk, dataclasses.replace(parent.epoch,
                                                        version=2))
    right = type(parent)(2, sk, b"", dataclasses.replace(parent.epoch,
                                                         version=2))
    host.notify_region_split(left, right, 100, 100)
    host.notify_region_changed(left)
    assert sup.splits == 1
    assert runner._arena.bucket(snap.feed_lineage, create=False) is None
    assert d.result().rows() == want
    assert runner.hbm_stats()["pinned_lines"] == 0


def test_split_kernel_failure_raises_through_the_hook(monkeypatch):
    """A split kernel that fails to build or launch is no fallback: the
    error leaves ``notify_region_split`` and nothing counts."""
    pe, _re = engines(13, 1200, lock_ts=10 ** 6)
    runner = DeviceRunner(device="cpu")
    cache = RegionColumnarCache()
    sup = DeviceStateSupervisor(runner, cache)
    host = CoprocessorHost()
    host.register(sup)
    parent = region_pair()[0]
    from tikv_tpu_torch.raftstore.peer import RegionSnapshot
    rs = RegionSnapshot(pe.snapshot(), parent)
    rs.data_index = 100
    pd, _rd = plan_pair("agg")
    runner.handle_request(pd, cache.get(rs, pd))

    def broken(*_args, **_kw):
        raise RuntimeError("split_planes launch failed: no kernel image")

    monkeypatch.setattr(sp, "split_planes", broken)
    sk = encode_key(table_record_key(TID, 600))
    left = type(parent)(1, b"", sk, dataclasses.replace(parent.epoch,
                                                        version=2))
    right = type(parent)(2, sk, b"", dataclasses.replace(parent.epoch,
                                                         version=2))
    with pytest.raises(RuntimeError, match="no kernel image"):
        host.notify_region_split(left, right, 100, 100)
    assert (sup.splits, sup.split_fallbacks) == (0, 0)
