"""Cross-request device batching in the port (``server/coalescer.py`` and
the runner's stacked dispatch), in the shapes of the reference's
``tests/test_coalescer.py``.

The same seeded snapshots and plans go to the JAX package's endpoint with
its ``RequestCoalescer`` (device runner on a one-device CPU mesh) and to
the port's (``DeviceRunner(device="cpu")``: ``sel_pred_batched``'s plain
version).  Every coalesced answer of the port equals the reference's
coalesced answer, the port's solo device answer and the host pipeline's,
rows compared exactly.  Groups form without wall-clock luck: a group
closes on size (``max_group`` members under a window far longer than the
test), on the ``copr::coalesce_window`` failpoint, or on the deadline
pressure under test; every thread join has a timeout.  Pinned besides:
share groups, occupancy and the ``batched`` route, a fault in the shared
fetch (each member degrades to the host), ``copr::coalesce_dispatch``
(each member retries solo), the router's four outcomes, a shed's
``ServerIsBusy`` with ``retry_after_ms``, a forced backend bypassing the
router, deadline pressure and the idle bypass.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import jax

from tikv_tpu.copr.endpoint import CopRequest as RefRequest
from tikv_tpu.copr.endpoint import Endpoint as RefEndpoint
from tikv_tpu.datatype import Column as RefColumn
from tikv_tpu.datatype import EvalType as RefEvalType
from tikv_tpu.datatype import FieldType
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.columnar import ColumnarTable as RefColumnar
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server.coalescer import RequestCoalescer as RefCoalescer
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.executors.runner import BatchExecutorsRunner
from tikv_tpu_torch.server.coalescer import (DEVICE_BATCHED, DEVICE_SOLO,
                                             HOST, SHED, RequestCoalescer)
from tikv_tpu_torch.server.read_pool import ServerIsBusy
from tikv_tpu_torch.utils import deadline as dl_mod
from tikv_tpu_torch.utils import failpoint

from tests.test_torch_selection import port_dag, port_snapshot

JOIN_S = 60.0
# a window no test outlives: only size, a failpoint or deadline pressure
# closes a group
LONG_WINDOW_MS = 60_000.0


@pytest.fixture(scope="module")
def ref_runner():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]), chunk_rows=1 << 12)


@pytest.fixture(scope="module")
def runner():
    return DeviceRunner(device="cpu")


@pytest.fixture(autouse=True)
def _teardown_failpoints():
    yield
    failpoint.teardown()


def make_snapshot(n=16_000, seed=0, tombstoned=False, null_heavy=False):
    """(reference table, reference snapshot, port snapshot)."""
    rng = np.random.default_rng(seed)
    table = Table(8600 + seed, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("v", 3, FieldType.long())))
    v_ok = rng.random(n) > (0.5 if null_heavy else 0.1)
    named = {
        "k": RefColumn(RefEvalType.INT,
                       rng.integers(0, 40, n).astype(np.int64),
                       np.ones(n, np.bool_)),
        "v": RefColumn(RefEvalType.INT, np.where(
            v_ok, rng.integers(-1000, 1000, n), 0).astype(np.int64), v_ok),
    }
    snap = RefColumnar.from_arrays(table, np.arange(n, dtype=np.int64),
                                   named)
    if tombstoned:
        alive = rng.random(n) > 0.3
        snap = RefColumnar(table, snap.handles, snap.columns, alive=alive)
    return table, snap, port_snapshot(table, snap)


def sel_dag(table, thr, extra=None):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    conds = [s.col("v") > int(thr)]
    if extra is not None:
        conds.append(s.col("k") < int(extra))
    return s.where(*conds).build()


def agg_dag(table, bias=0):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    aggs = [("count_star", None), ("sum", s.col("v"))]
    if bias:
        return s.where(s.col("v") > bias).aggregate(
            [s.col("k")], aggs).build()
    return s.aggregate([s.col("k")], aggs).build()


def make_endpoint(runner, psnap, window_ms=LONG_WINDOW_MS, max_group=8,
                  idle_bypass=False, threshold=1):
    coal = RequestCoalescer(runner, window_ms=window_ms,
                            max_group=max_group)
    coal.idle_bypass = idle_bypass
    ep = Endpoint(lambda req: psnap, device_runner=runner,
                  device_row_threshold=threshold, coalescer=coal)
    return ep, coal


def run_concurrent(handle, reqs):
    """Each request on its own thread through ``handle`` → responses."""
    out = [None] * len(reqs)
    errs = []

    def one(i):
        try:
            out[i] = handle(reqs[i])
        except Exception as e:      # noqa: BLE001 — asserted below
            errs.append((i, e))

    ts = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in ts), "a request never ended"
    assert not errs, errs
    return out


def reference_coalesced(ref_runner, snap, dags):
    """The reference endpoint's answers with its coalescer, the group
    closed by size."""
    coal = RefCoalescer(ref_runner, window_ms=LONG_WINDOW_MS,
                        max_group=len(dags))
    coal.idle_bypass = False
    ep = RefEndpoint(lambda req: snap, device_runner=ref_runner,
                     device_row_threshold=1, coalescer=coal)
    try:
        got = run_concurrent(ep.handle,
                             [RefRequest(REQ_TYPE_DAG, d) for d in dags])
        assert coal.stats()["groups_dispatched"] == 1
        return [r.rows() for r in got]
    finally:
        ep.close()


def port_requests(dags, **kw):
    return [CopRequest(REQ_TYPE_DAG, port_dag(d), **kw) for d in dags]


# ----------------------------------------------------- randomized parity


@pytest.mark.parametrize("shape", ["plain", "null_heavy", "tombstoned"])
def test_randomized_batched_vs_solo_vs_host_parity(runner, ref_runner,
                                                   shape):
    """Mixed constants within one batch class over plain, NULL-heavy and
    tombstoned snapshots, single comparisons and conjunctions: every
    coalesced member equals the reference's coalesced answer, the port's
    solo device answer and the host pipeline's."""
    seed = {"plain": 1, "null_heavy": 2, "tombstoned": 3}[shape]
    table, snap, psnap = make_snapshot(seed=seed,
                                       null_heavy=shape == "null_heavy",
                                       tombstoned=shape == "tombstoned")
    rng = np.random.default_rng(77 + seed)
    for cycle in range(2):
        thrs = rng.integers(-1100, 1100, 4).tolist()
        if cycle:           # a conjunction: its own batch class
            dags = [sel_dag(table, t, extra=rng.integers(0, 40))
                    for t in thrs]
        else:
            dags = [sel_dag(table, t) for t in thrs]
        ep, coal = make_endpoint(runner, psnap, max_group=len(dags))
        try:
            got = run_concurrent(ep.handle, port_requests(dags))
            st = coal.stats()
        finally:
            ep.close()
        assert st["requests_coalesced"] == len(dags), st
        assert st["groups_dispatched"] == 1 and st["solo_degrade"] == 0, st
        want = reference_coalesced(ref_runner, snap, dags)
        for dag, resp, ref in zip(dags, got, want):
            assert resp.backend == "device"
            assert resp.rows() == ref
            solo = runner.handle_request(port_dag(dag), psnap).rows()
            host = BatchExecutorsRunner(port_dag(dag),
                                        psnap).handle_request().rows()
            assert resp.rows() == solo == host


def test_aggregation_share_mode_parity(runner, ref_runner):
    """Identical aggregation plans coalesce in share mode: one dispatch and
    one fetch serve every member."""
    table, snap, psnap = make_snapshot(seed=5)
    ep, coal = make_endpoint(runner, psnap, max_group=4)
    try:
        dags = [agg_dag(table)] * 4
        got = run_concurrent(ep.handle, port_requests(dags))
        want = sorted(reference_coalesced(ref_runner, snap, dags)[0])
        for resp in got:
            assert sorted(resp.rows()) == want
            assert resp.backend == "device"
        st = coal.stats()
        assert st["groups_dispatched"] == 1, st
        assert st["mean_occupancy"] == 4.0, st
        # differing aggregation-side constants: distinct share groups
        coal.configure(max_group=1)
        dags2 = [agg_dag(table, bias=b) for b in (10, 500, 10)]
        for resp, dag in zip(run_concurrent(ep.handle, port_requests(dags2)),
                             dags2):
            want = BatchExecutorsRunner(port_dag(dag),
                                        psnap).handle_request()
            assert sorted(resp.rows()) == sorted(want.rows())
    finally:
        ep.close()


def test_stacked_group_occupancy_and_route_label(runner):
    """A full group runs as one stacked dispatch: occupancy equals the
    member count, and the selection route counts one ``batched``."""
    table, _snap, psnap = make_snapshot(seed=6)
    ep, coal = make_endpoint(runner, psnap, max_group=4)
    try:
        before = dict(runner.sel_routes)
        dags = [sel_dag(table, t) for t in (-2000, 0, 250, 2000)]
        got = run_concurrent(ep.handle, port_requests(dags))
        st = coal.stats()
        assert st["groups_dispatched"] == 1 and \
            st["max_occupancy"] == 4, st
        assert runner.sel_routes.get("batched", 0) - \
            before.get("batched", 0) == 1, runner.sel_routes
        assert st["router"]["decisions"] == {DEVICE_BATCHED: 4}, st
        for resp in got:
            assert resp.tracker.labels["router"] == DEVICE_BATCHED
            assert "coalesce_wait" in resp.tracker.phases
    finally:
        ep.close()


# ------------------------------------------------------- fault isolation


def test_group_fetch_fault_degrades_members_to_host(runner):
    """A device fault inside the group's shared fetch degrades every
    member to the host pipeline on its own: exact answers, no group-wide
    failure."""
    table, _snap, psnap = make_snapshot(seed=7)
    ep, coal = make_endpoint(runner, psnap, max_group=3)
    try:
        failpoint.cfg("device::before_fetch", "1*return")
        dags = [sel_dag(table, t) for t in (-500, 0, 500)]
        got = run_concurrent(ep.handle, port_requests(dags))
        for dag, resp in zip(dags, got):
            want = BatchExecutorsRunner(port_dag(dag),
                                        psnap).handle_request()
            assert resp.rows() == want.rows()
            assert resp.backend == "host", resp.backend
        assert coal.stats()["groups_dispatched"] == 1
        assert ep.degrades == {"fetch": 3}
    finally:
        ep.close()


def test_coalesce_dispatch_failpoint_retries_members_solo(runner):
    """copr::coalesce_dispatch: the stacked launch fails, and each member
    retries as a solo device dispatch."""
    table, _snap, psnap = make_snapshot(seed=8)
    ep, coal = make_endpoint(runner, psnap, max_group=3)
    try:
        failpoint.cfg("copr::coalesce_dispatch", "1*return")
        dags = [sel_dag(table, t) for t in (-400, 100, 900)]
        got = run_concurrent(ep.handle, port_requests(dags))
        for dag, resp in zip(dags, got):
            want = BatchExecutorsRunner(port_dag(dag),
                                        psnap).handle_request()
            assert resp.rows() == want.rows()
            assert resp.backend == "device", resp.backend
        assert coal.stats()["solo_degrade"] == 3
        assert not ep.degrades
    finally:
        ep.close()


def test_coalesce_window_failpoint_closes_at_once(runner):
    """copr::coalesce_window closes each group as its member arrives:
    every member dispatches alone, still exactly."""
    table, _snap, psnap = make_snapshot(seed=9)
    ep, coal = make_endpoint(runner, psnap, max_group=8)
    try:
        failpoint.cfg("copr::coalesce_window", "return")
        dags = [sel_dag(table, t) for t in (-100, 400)]
        got = run_concurrent(ep.handle, port_requests(dags))
        for dag, resp in zip(dags, got):
            want = BatchExecutorsRunner(port_dag(dag),
                                        psnap).handle_request()
            assert resp.rows() == want.rows()
        st = coal.stats()
        assert st["closes"].get("failpoint", 0) == 2, st
        assert st["max_occupancy"] == 1, st
    finally:
        ep.close()


# -------------------------------------------------------------- routing


def test_router_all_four_outcomes(runner):
    table, _snap, psnap = make_snapshot(seed=10)
    ep, coal = make_endpoint(runner, psnap)
    try:
        dag = port_dag(sel_dag(table, 5))
        d, key, _ = coal.route(dag, psnap)
        assert d == DEVICE_BATCHED and key is not None and key[0] == "stack"
        d, key, _ = coal.route(port_dag(agg_dag(table)), psnap)
        assert d == DEVICE_BATCHED and key[0] == "share"
        coal.set_enabled(False)
        d, key, _ = coal.route(dag, psnap)
        assert d == DEVICE_SOLO and key is None
        coal.set_enabled(True)
        # the row threshold (the calibrated break-even) puts this
        # snapshot far below the device's crossover
        ep._device_row_threshold = 1 << 22
        d, _k, _ = coal.route(dag, psnap)
        assert d == HOST
        ep._device_row_threshold = 1
        # a remaining budget below every option's modeled cost
        coal.router.launch_ewma = 0.5
        tok = dl_mod.install(dl_mod.Deadline.after_ms(20))
        try:
            d, _k, hint = coal.route(dag, psnap)
        finally:
            dl_mod.uninstall(tok)
        assert d == SHED and hint >= 1, (d, hint)
        decisions = coal.stats()["router"]["decisions"]
        for want in (DEVICE_BATCHED, DEVICE_SOLO, HOST, SHED):
            assert decisions.get(want, 0) >= 1, decisions
    finally:
        ep.close()


def test_shed_raises_server_is_busy(runner):
    table, _snap, psnap = make_snapshot(seed=11)
    ep, coal = make_endpoint(runner, psnap)
    try:
        coal.router.launch_ewma = 0.5
        tok = dl_mod.install(dl_mod.Deadline.after_ms(20))
        try:
            with pytest.raises(ServerIsBusy) as ei:
                ep.handle(port_requests([sel_dag(table, 5)])[0])
        finally:
            dl_mod.uninstall(tok)
        assert ei.value.retry_after_ms >= 1
    finally:
        ep.close()


def test_router_respects_forced_backend(runner):
    """force_backend='device' bypasses the router: a raw solo dispatch."""
    table, _snap, psnap = make_snapshot(seed=12)
    ep, coal = make_endpoint(runner, psnap)
    try:
        before = coal.stats()["router"]["decisions"]
        r = ep.handle(port_requests([sel_dag(table, 5)],
                                    force_backend="device")[0])
        want = BatchExecutorsRunner(port_dag(sel_dag(table, 5)),
                                    psnap).handle_request()
        assert r.rows() == want.rows() and r.backend == "device"
        assert coal.stats()["router"]["decisions"] == before
        assert coal.stats()["groups_dispatched"] == 0
    finally:
        ep.close()


# ----------------------------------------------------- deadline pressure


def test_deadline_pressure_closes_group_early(runner):
    """A member whose budget cannot survive the window closes its group
    before the window: its answer lands before its deadline, though the
    window is far longer than the test."""
    table, _snap, psnap = make_snapshot(seed=13)
    ep, coal = make_endpoint(runner, psnap, window_ms=LONG_WINDOW_MS)
    try:
        runner.handle_request(port_dag(sel_dag(table, 77)), psnap)   # warm
        expired, out = [], []

        def one(thr, budget_ms):
            dl = dl_mod.Deadline.after_ms(budget_ms) if budget_ms else None
            tok = dl_mod.install(dl)
            try:
                r = ep.handle(port_requests([sel_dag(table, thr)])[0])
                out.append((thr, r))
                if dl is not None:
                    expired.append(dl.expired())
            finally:
                dl_mod.uninstall(tok)

        # one patient member and one with a 6 s budget: the group closes
        # on the tight member's pressure (at a quarter of its budget)
        ts = [threading.Thread(target=one, args=(321, None)),
              threading.Thread(target=one, args=(654, 6_000))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=JOIN_S)
        assert not any(t.is_alive() for t in ts), \
            "the group never closed under deadline pressure"
        assert len(out) == 2
        for thr, got in out:
            want = BatchExecutorsRunner(port_dag(sel_dag(table, thr)),
                                        psnap).handle_request()
            assert got.rows() == want.rows()
        assert expired == [False], "served past its deadline"
        assert coal.stats()["closes"].get("deadline", 0) >= 1
    finally:
        ep.close()


def test_idle_bypass_skips_the_window(runner):
    """A lone request on an idle coalescer dispatches at once: a serial
    workload never pays the window."""
    table, _snap, psnap = make_snapshot(seed=14)
    ep, coal = make_endpoint(runner, psnap, window_ms=LONG_WINDOW_MS,
                             idle_bypass=True)
    try:
        ep.handle(port_requests([sel_dag(table, 5)])[0])         # warm
        t0 = time.perf_counter()
        r = ep.handle(port_requests([sel_dag(table, 6)])[0])
        assert time.perf_counter() - t0 < JOIN_S
        assert r.backend == "device"
        assert coal.stats()["closes"].get("idle", 0) == 2
        assert coal.stats()["max_occupancy"] == 1
    finally:
        ep.close()


def test_close_flushes_parked_members(runner):
    """Closing the endpoint dispatches a group still collecting: its
    parked members resolve, never abandoned."""
    table, _snap, psnap = make_snapshot(seed=15)
    ep, coal = make_endpoint(runner, psnap, max_group=8)
    d = ep.handle_async(port_requests([sel_dag(table, 10)])[0])
    assert coal.stats()["open_groups"] == 1
    coal.close()
    want = BatchExecutorsRunner(port_dag(sel_dag(table, 10)),
                                psnap).handle_request()
    assert d.wait().rows() == want.rows()
    assert coal.stats()["closes"] == {"shutdown": 1}
    ep.close()
