"""Scale-out placement of the port against the JAX package's.

The placement policy (``tikv_tpu_torch.pd.scheduler``) is held against
``tikv_tpu.pd.scheduler`` over random score vectors and exclusion sets; the
slice health state machine (``SliceHealth``, ``SliceHealthBoard``) walks
the reference's state sequence under one fault, success, latency and probe
script; and the port's ``SlicePlacer`` (``DeviceRunner(mesh=make_mesh(
["cpu"] * 4), placement=True)``: four single-device slices running the plain
version of every kernel) routes the same Zipf request order over eight
anchors as the reference's (``DeviceRunner(mesh=make_mesh(jax.devices()[:4]),
placement=True)`` on the conftest's virtual CPU devices), with the load's
half-life set to infinity on both, so that the blended scores are exact
counts.  Answers are equal exactly (sorted rows) to the reference's and to
its host pipeline's; slice choices, ``places``, ``whole_mesh_routes`` and
the anchor ``rebalance`` moves are equal, and so are the bytes each slice's
arena counts, which decide them (compared at every step); the slice
``rebalance`` moves to is also ``pick_slice`` over the port's own scores.
"""

import time

import numpy as np
import pytest

import jax

from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.device import placement as ref_pl
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.device.supervisor import SliceHealth as RefHealth
from tikv_tpu.device.supervisor import SliceHealthBoard as RefBoard
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.executors.runner import BatchExecutorsRunner
from tikv_tpu.parallel import make_mesh as ref_make_mesh
from tikv_tpu.pd import scheduler as ref_sched
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch.device import placement as pl
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.device.supervisor import SliceHealth, SliceHealthBoard
from tikv_tpu_torch.parallel import make_mesh
from tikv_tpu_torch.pd import scheduler as sched
from tikv_tpu_torch.utils import failpoint

from tests.test_torch_selection import port_dag, port_snapshot

CHUNK = 8 * 64
# feeds of this many rows or more take the whole mesh
WHOLE_ROWS = 1 << 13


@pytest.fixture(autouse=True)
def _teardown_failpoints():
    yield
    failpoint.teardown()


def make_table(tid: int = 4242) -> Table:
    return Table(tid, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("v", 3, FieldType.long())))


def make_snap(table, n: int, seed: int, null_frac: float = 0.0):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 60, n).astype(np.int64)
    v = rng.integers(-50_000, 50_000, n).astype(np.int64)
    ok = (rng.random(n) > null_frac) if null_frac else np.ones(n, np.bool_)
    return ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64),
        {"k": Column(EvalType.INT, k, ok), "v": Column(EvalType.INT, v, ok)})


def agg_dag(table):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    return s.aggregate([s.col("k")], [
        ("count_star", None), ("sum", s.col("v")), ("min", s.col("v")),
        ("max", s.col("v"))]).build()


def sel_dag(table, thr: int):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    return s.where(s.col("v") > int(thr)).build()


def rows(result) -> list:
    return sorted(result.rows(), key=repr)


def ref_runner(**kw):
    kw.setdefault("slice_probe_cooldown_s", 0.05)
    return RefRunner(mesh=ref_make_mesh(jax.devices()[:4]), chunk_rows=CHUNK,
                     placement=True, placement_rows=WHOLE_ROWS, **kw)


def port_runner(**kw):
    kw.setdefault("slice_probe_cooldown_s", 0.05)
    return DeviceRunner(mesh=make_mesh(["cpu"] * 4), chunk_rows=CHUNK,
                        placement=True, placement_rows=WHOLE_ROWS, **kw)


def slice_of(runner, snap):
    owner = runner.placer.owner(runner._feed_anchor(snap))
    return None if owner is None else runner.placer.slices.index(owner)


# ------------------------------------------------------------- the policy


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        # ties are common: scores on a coarse grid
        scores = (rng.integers(0, 6, n) / 4.0).tolist()
        exclude = set(rng.choice(n, int(rng.integers(0, n + 1)),
                                 replace=False).tolist())
        assert sched.pick_slice(scores, exclude) == \
            ref_sched.pick_slice(scores, exclude)
        assert sched.pick_slice(scores) == ref_sched.pick_slice(scores)
        k = int(rng.integers(0, 12))
        assert sched.drain_receivers(scores, exclude, k) == \
            ref_sched.drain_receivers(scores, exclude, k)
        ratio, gap = float(rng.choice([1.0, 2.0, 3.0])), \
            float(rng.choice([0.0, 0.25, 1.0]))
        assert sched.rebalance_donor(scores, ratio, gap) == \
            ref_sched.rebalance_donor(scores, ratio, gap)
        occ = {i: float(rng.random()) for i in range(n) if rng.random() < .8}
        load = {i: float(rng.random()) for i in range(n) if rng.random() < .8}
        w = float(rng.choice([0.5, 1.0, 2.0]))
        assert sched.slice_scores(occ, load, n, w, 1.0) == \
            ref_sched.slice_scores(occ, load, n, w, 1.0)


# ------------------------------------------------------- the health score

# (step, argument): fault kind, ok latency, trip reason, probe verdict,
# or a wait past the cooldown
HEALTH_SCRIPT = [
    ("fault", "dispatch"), ("ok", None), ("ok", None), ("ok", None),
    ("fault", "dispatch"), ("fault", "fetch"), ("probe", True),
    ("fault", "scrub"), ("probe", True), ("ok", None), ("fault", "fetch"),
    ("wait", None), ("probe", False), ("probe", True), ("wait", None),
    ("probe", True), ("ok", None), ("ok", 0.9), ("ok", 0.9), ("ok", 0.1),
    ("fault", "dispatch"), ("ok", None), ("trip", "slice_dead"),
    ("trip", "slice_dead"), ("ok", None), ("wait", None), ("probe", True),
    ("ok", 0.9), ("ok", 0.9), ("ok", 0.9), ("ok", 0.9), ("ok", 0.9),
    ("wait", None), ("probe", True), ("reset", None), ("ok", None)]
STATE_KEYS = ("score", "state", "strikes", "trips", "readmits",
              "probe_failures", "probe_inflight", "refusals")


def _step(h, step, arg):
    if step == "fault":
        return h.note_fault(arg)
    if step == "ok":
        return h.note_ok(arg)
    if step == "trip":
        return h.trip(arg)
    if step == "probe":
        got = h.try_probe()
        if got:
            h.probe_result(arg)
        return got
    if step == "reset":
        return h.reset()
    return None


def test_slice_health_walks_the_reference_states():
    ref = RefHealth(0, trip_strikes=3.0, cooldown_s=0.05,
                    latency_outlier_s=0.5)
    got = SliceHealth(0, trip_strikes=3.0, cooldown_s=0.05,
                      latency_outlier_s=0.5)
    seen = set()
    for i, (step, arg) in enumerate(HEALTH_SCRIPT):
        if step == "wait":
            time.sleep(0.06)
            continue
        assert _step(got, step, arg) == _step(ref, step, arg), (i, step)
        want = {k: ref.stats()[k] for k in STATE_KEYS}
        assert {k: got.stats()[k] for k in STATE_KEYS} == want, (i, step)
        assert got.penalty() == ref.penalty()
        assert got.quarantined() == ref.quarantined()
        seen.add(want["state"])
    assert seen == {"healthy", "quarantined"}
    assert ref.stats()["readmits"] >= 2 and ref.stats()["probe_failures"]


def test_readmission_decays_instead_of_resetting():
    for cls in (RefHealth, SliceHealth):
        h = cls(0, trip_strikes=3.0, cooldown_s=0.0)
        h.trip("slice_dead")
        assert h.try_probe()
        h.probe_result(True)
        assert h.stats()["score"] == 2.0 and not h.quarantined()
        assert h.note_fault("dispatch"), "one fault re-trips"


@pytest.mark.parametrize("seed", range(3))
def test_board_matches_the_reference(seed):
    """Random faults and trips over four slices, a scripted canary: the
    same trip-listener calls, quarantined sets, penalties and probe
    results."""
    rng = np.random.default_rng(100 + seed)
    boards = [RefBoard(4, trip_strikes=2.0, cooldown_s=0.0),
              SliceHealthBoard(4, trip_strikes=2.0, cooldown_s=0.0)]
    logs = [[], []]
    for b, log in zip(boards, logs):
        b.add_trip_listener(lambda i, r, log=log: log.append((i, r)))
    try:
        for step in range(60):
            i = int(rng.integers(0, 4))
            kind = rng.choice(["fault", "trip", "probe", "ok"],
                              p=[0.5, 0.1, 0.2, 0.2])
            verdicts = [bool(v) for v in rng.random(4) < 0.5]
            out = []
            for b in boards:
                if kind == "fault":
                    b.note_fault(i, "dispatch")
                elif kind == "trip":
                    b.trip(i, "slice_dead")
                elif kind == "ok":
                    b.slice(i).note_ok()
                else:
                    out.append(b.maybe_probe(lambda j: verdicts[j]))
                assert len(b) == 4
            assert logs[0] == logs[1], step
            if out:
                assert out[0] == out[1]
            assert boards[0].quarantined_set() == boards[1].quarantined_set()
            assert [boards[0].penalty(j) for j in range(4)] == \
                [boards[1].penalty(j) for j in range(4)]
            want = [{k: s[k] for k in STATE_KEYS}
                    for s in boards[0].stats()]
            assert [{k: s[k] for k in STATE_KEYS}
                    for s in boards[1].stats()] == want
    finally:
        for b in boards:
            b.reset()


# ------------------------------------------------------------- the placer


@pytest.fixture
def exact_load(monkeypatch):
    """No decay: the blended scores are exact counts on both placers."""
    monkeypatch.setattr(ref_pl, "LOAD_HALFLIFE_S", float("inf"))
    monkeypatch.setattr(pl, "LOAD_HALFLIFE_S", float("inf"))


def _zipf_order(n_anchors: int, total: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_anchors + 1) ** 1.2
    return rng.choice(n_anchors, size=total, p=p / p.sum()).tolist()


def _arena_bytes(runner) -> list:
    return [r._arena.resident_bytes() for r in runner.placer.slices]


def test_placer_routes_as_the_reference(exact_load):
    """Eight anchors of differing sizes (and one whole-mesh region) under a
    scripted Zipf order of 80 requests, alternating an aggregation and a
    selection: each answer equal to the reference's and the host's, each
    anchor on the same slice, ``places`` and ``whole_mesh_routes`` equal;
    the automatic rebalance at route 64 included."""
    ref, port = ref_runner(), port_runner()
    table = make_table()
    sizes = [700, 1500, 900, 2400, 1200, 600, 3000, 1800, WHOLE_ROWS + 500]
    snaps = [make_snap(table, n, 50 + i, null_frac=0.1 if i % 3 == 0
                       else 0.0) for i, n in enumerate(sizes)]
    psnaps = [port_snapshot(table, s) for s in snaps]
    dags = [agg_dag(table), sel_dag(table, 20_000)]
    pdags = [port_dag(d) for d in dags]
    hosts = [[rows(BatchExecutorsRunner(d, s).handle_request()) for d in dags]
             for s in snaps]
    order = _zipf_order(len(snaps), 80, 7)
    differed = 0
    for step, i in enumerate(order):
        j = step % 2
        want = rows(ref.handle_request(dags[j], snaps[i]))
        got = rows(port.handle_request(pdags[j], psnaps[i]))
        assert got == want == hosts[i][j], (step, i)
        if i == len(snaps) - 1:
            assert slice_of(port, psnaps[i]) is None
            continue
        if _arena_bytes(ref) == _arena_bytes(port):
            assert slice_of(port, psnaps[i]) == slice_of(ref, snaps[i]), step
        else:
            differed += 1
    assert differed == 0, "the two arenas counted different bytes"
    rs, ps = ref.placer.stats(), port.placer.stats()
    for k in ("places", "whole_mesh_routes", "moves", "failovers"):
        assert ps[k] == rs[k], k
    assert ps["whole_mesh_routes"] > 0 and ps["places"] == 8
    assert [s["placed_anchors"] for s in ps["slices"]] == \
        [s["placed_anchors"] for s in rs["slices"]]
    assert [s["resident_bytes"] for s in ps["slices"]] == \
        [s["resident_bytes"] for s in rs["slices"]]
    ms, rms = port.mesh_stats(), ref.mesh_stats()
    assert ms["shape"] == dict(rms["shape"]) and \
        ms["n_devices"] == rms["n_devices"] == 4
    assert ms["placement"]["places"] == rms["placement"]["places"]
    for r in (ref, port):
        r.close()
    assert port.hbm_stats()["resident_bytes"] == 0


def test_rebalance_moves_the_reference_anchor(exact_load):
    """A small region, three large ones (one a slice), then a fifth large
    one, which lands beside the small one; heat it: ``rebalance`` moves the
    cold small co-tenant to the coolest slice on both placers, by migration
    on the port (its arrival check passed), and every answer stays
    exact."""
    ref, port = ref_runner(), port_runner()
    table = make_table(4243)
    snaps = [make_snap(table, n, 80 + i)
             for i, n in enumerate((520, 3000, 3000, 3000, 3000))]
    psnaps = [port_snapshot(table, s) for s in snaps]
    dag = agg_dag(table)
    pdag = port_dag(dag)
    hosts = [rows(BatchExecutorsRunner(dag, s).handle_request())
             for s in snaps]
    for i in range(len(snaps)):
        assert rows(ref.handle_request(dag, snaps[i])) == hosts[i]
        assert rows(port.handle_request(pdag, psnaps[i])) == hosts[i]
    before = [slice_of(port, s) for s in psnaps]
    assert before == [slice_of(ref, s) for s in snaps] == [0, 1, 2, 3, 0]
    hot, mates = 4, [0]
    for _ in range(30):
        assert rows(ref.handle_request(dag, snaps[hot])) == hosts[hot]
        assert rows(port.handle_request(pdag, psnaps[hot])) == hosts[hot]
    scores = port.placer.scores()
    assert ref.placer.rebalance() and port.placer.rebalance()
    after = [slice_of(port, s) for s in psnaps]
    assert after == [slice_of(ref, s) for s in snaps]
    moved = [i for i in range(len(snaps)) if after[i] != before[i]]
    assert moved == mates and after[moved[0]] == sched.pick_slice(scores)
    st = port.placer.stats()
    assert st["moves"] == 1 and st["migrations"] == 1, st
    for i in range(len(snaps)):
        assert rows(port.handle_request(pdag, psnaps[i])) == hosts[i]
    for r in (ref, port):
        r.close()


def test_grown_anchor_graduates_to_the_whole_mesh():
    """An anchor routed below ``placement_rows`` and then at or above it:
    the root serves it, its pin and its slice copy are gone, on both."""
    ref, port = ref_runner(), port_runner()
    table = make_table(4244)
    snap = make_snap(table, 1000, 3)
    psnap = port_snapshot(table, snap)
    dag = agg_dag(table)
    host = rows(BatchExecutorsRunner(dag, snap).handle_request())
    assert rows(ref.handle_request(dag, snap)) == host
    assert rows(port.handle_request(port_dag(dag), psnap)) == host
    for r, s in ((ref, snap), (port, psnap)):
        idx = slice_of(r, s)
        anchor = r._feed_anchor(s)
        assert idx is not None and \
            r.placer.slices[idx]._arena.bucket(anchor, create=False)
        assert r.placer.route(s, n_hint=WHOLE_ROWS) is r
        assert slice_of(r, s) is None
        assert not r.placer.slices[idx]._arena.bucket(anchor, create=False)
        assert r.placer.stats()["whole_mesh_routes"] == 1
        assert r.placer.route(s, n_hint=10) is not r     # placed anew
        r.close()


def test_untrackable_anchor_routes_to_the_root():
    port = port_runner()

    class Frozen:
        __slots__ = ()          # no weak references

    assert port.placer.route(Frozen(), n_hint=10) is port
    assert port.placer.stats()["places"] == 0


def test_placement_off_takes_the_mesh_code():
    """Without ``placement`` a mesh runner has no placer, no board and no
    failure domain: ``device::slice_dead`` does not reach it."""
    r = DeviceRunner(mesh=make_mesh(["cpu"] * 4), chunk_rows=CHUNK)
    assert r.placer is None and r._board is None and not r._in_domain()
    table = make_table(4245)
    snap = make_snap(table, 3000, 9)
    dag = agg_dag(table)
    host = rows(BatchExecutorsRunner(dag, snap).handle_request())
    failpoint.cfg("device::slice_dead", "return")
    assert rows(r.handle_request(port_dag(dag),
                                 port_snapshot(table, snap))) == host
    assert r.degrades == {}
    assert DeviceRunner(device="cpu", placement=True).placer is None
