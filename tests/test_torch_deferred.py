"""The deferred (dispatch now, fetch later) serving path of the port:
``DeviceRunner.handle_request(..., deferred=True)`` → ``DeferredResult``,
and ``Endpoint.handle_async`` → ``CopDeferred``, in the shapes of the
reference's ``tests/test_device_async.py``.

The same seeded snapshot goes to the JAX package (``ColumnarTable``) and to
the port (``snapshot_from_arrays``); each answer of the port
(``DeviceRunner(device="cpu")``, the kernels' plain versions) equals the
reference endpoint's answer on the same plan (its device runner on a
one-device CPU mesh), rows compared exactly (tolerance 0, AVG to 1e-9).
Pinned:

- deferred equals serial, and ``result()`` memoizes;
- many deferred dispatches before any wait, over every deferred route of
  this slice (the selection's mask, index and compact routes, the fused
  aggregation's simple, dense and sparse modes);
- concurrent ``handle_async`` equals serial; host requests resolve inline;
- the degrade contract at the fetch (``device::before_fetch``) and at the
  dispatch (``device::before_dispatch``, racing another request's fetch):
  counted in ``Endpoint.degrades``, raised when the device was forced;
- a device fault surfacing from the completion pool degrades unless the
  device was forced; any other error there propagates (the port's rule:
  a kernel's failure is never answered on the host);
- the pinned stager's pool, and the phases a request records.
"""

import threading

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
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

import torch

from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.device import DeviceUnavailable
from tikv_tpu_torch.device import deferred as dfr
from tikv_tpu_torch.device.deferred import DeferredResult
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.executors.runner import BatchExecutorsRunner
from tikv_tpu_torch.utils import failpoint

from tests.test_torch_selection import port_dag, port_snapshot

JOIN_S = 30.0


@pytest.fixture(scope="module")
def ref_runner():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def runner():
    return DeviceRunner(device="cpu")


@pytest.fixture(autouse=True)
def _teardown_failpoints():
    yield
    failpoint.teardown()


def make_snapshot(n=20_000, seed=0, groups=50):
    """(reference table, reference snapshot, port snapshot): INT k and v,
    and a REAL r (quarter steps) that only some plans scan."""
    rng = np.random.default_rng(seed)
    table = Table(8100 + seed, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("v", 3, FieldType.long()),
        TableColumn("r", 4, FieldType.double())))
    k = rng.integers(0, groups, n).astype(np.int64)
    v = rng.integers(-100_000, 100_000, n).astype(np.int64)
    r = rng.integers(-400, 400, n) / 4.0
    ones = np.ones(n, np.bool_)
    snap = RefColumnar.from_arrays(
        table, np.arange(n, dtype=np.int64),
        {"k": RefColumn(RefEvalType.INT, k, ones),
         "v": RefColumn(RefEvalType.INT, v, ones),
         "r": RefColumn(RefEvalType.REAL, r, ones)})
    return table, snap, port_snapshot(table, snap)


def hash_dag(table):
    sel = DagSelect.from_table(table, ["id", "k", "v"])
    return sel.aggregate([sel.col("k")],
                         [("count_star", None), ("sum", sel.col("v"))]).build()


def sel_dag(table, thr):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    return s.where(s.col("v") > thr).build()


def canon(rows):
    return sorted(tuple(-10 ** 18 if x is None else x for x in r)
                  for r in rows)


def ref_rows(ref_runner, snap, dag):
    """The reference endpoint's answer on its device runner."""
    ep = RefEndpoint(lambda req: snap, device_runner=ref_runner,
                     device_row_threshold=1)
    try:
        return ep.handle(RefRequest(REQ_TYPE_DAG, dag)).rows()
    finally:
        ep.close()


def port_ep(runner, psnap, threshold=1_000):
    return Endpoint(lambda req: psnap, device_runner=runner,
                    device_row_threshold=threshold)


def join_all(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a request never ended"


# ------------------------------------------------------- runner deferral


def test_deferred_result_matches_serial(runner, ref_runner):
    table, snap, psnap = make_snapshot(seed=1)
    dag = hash_dag(table)
    serial = runner.handle_request(port_dag(dag), psnap)
    d = runner.handle_request(port_dag(dag), psnap, deferred=True)
    assert isinstance(d, DeferredResult)
    got = d.result()
    assert canon(got.rows()) == canon(serial.rows())
    assert canon(got.rows()) == canon(ref_rows(ref_runner, snap, dag))
    assert d.result() is got            # memoized
    assert d.degraded is None


def _route_dags(table, snap):
    """Plans whose deferred answers take each route of this slice once
    their selectivity is warm: selections at 0.1% (compact), at 1% over a
    scan with the REAL column (index: no compact route) and at 30% (mask);
    and the fused aggregation's simple, dense and sparse modes."""
    v = np.sort(snap.columns[3].values)
    out = {}
    for name, frac in (("compact", 0.001), ("index", 0.01), ("mask", 0.3)):
        thr = int(v[int(len(v) * (1 - frac))])
        if name == "index":
            s = DagSelect.from_table(table, ["id", "k", "v", "r"])
            out[name] = s.where(s.col("v") > thr).build()
        else:
            out[name] = sel_dag(table, thr)
    out["hash_dense"] = hash_dag(table)
    s = DagSelect.from_table(table, ["id", "k", "v"])
    out["simple"] = s.aggregate([], [("sum", s.col("v")),
                                     ("count_star", None),
                                     ("avg", s.col("v"))]).build()
    s = DagSelect.from_table(table, ["id", "k", "v"])
    out["hash_sparse"] = s.aggregate(
        [s.col("k") * (1 << 30)], [("count_star", None)]).build()
    return out


def test_many_deferred_dispatches_before_any_wait(runner, ref_runner):
    """Every dispatch enqueues before the first result(); each deferred
    route's answer equals the serial one and the reference's."""
    table, snap, psnap = make_snapshot(n=200_000, seed=2)
    dags = _route_dags(table, snap)
    for dag in dags.values():               # warm the selectivity EWMAs
        for _ in range(3):
            runner.handle_request(port_dag(dag), psnap)
    for lim in (11, 23, 47, 95):
        s = DagSelect.from_table(table, ["id", "k", "v"])
        dags[f"topn_{lim}"] = s.order_by(s.col("v"), desc=True,
                                         limit=lim).build()
    before = dict(runner.sel_routes)
    deferred = {name: runner.handle_request(port_dag(dag), psnap,
                                            deferred=True)
                for name, dag in dags.items()}
    assert all(isinstance(d, DeferredResult) for d in deferred.values())
    for name, d in deferred.items():
        got = d.result().rows()
        want = ref_rows(ref_runner, snap, dags[name])
        if name.startswith("topn"):
            assert [r[2] for r in got] == [r[2] for r in want], name
        elif name == "simple":
            assert got[0][:2] == want[0][:2]
            assert abs(got[0][2] - want[0][2]) < 1e-9
        else:
            assert canon(got) == canon(want), name
    routes = {k: runner.sel_routes.get(k, 0) - before.get(k, 0)
              for k in ("compact", "index", "mask")}
    assert routes == {"compact": 1, "index": 1, "mask": 1}, routes


# ---------------------------------------------------- endpoint async path


def test_async_endpoint_concurrent_matches_serial(runner, ref_runner):
    table, snap, psnap = make_snapshot(seed=3)
    ep = port_ep(runner, psnap)
    try:
        dag = hash_dag(table)
        want = canon(ref_rows(ref_runner, snap, dag))
        # all dispatches in flight before any wait
        deferred = [ep.handle_async(CopRequest(REQ_TYPE_DAG, port_dag(dag)))
                    for _ in range(4)]
        assert not any(d.resolved for d in deferred)
        for d in deferred:
            resp = d.wait()
            assert resp.backend == "device"
            assert canon(resp.rows()) == want
            assert d.wait() is resp         # memoized
        results, errors = [], []
        mu = threading.Lock()

        def one(i):
            try:
                dg = hash_dag(table) if i % 2 else sel_dag(table, 900)
                r = ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(dg)))
                with mu:
                    results.append((i, canon(r.rows())))
            except Exception as e:      # noqa: BLE001 — asserted below
                with mu:
                    errors.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        join_all(threads)
        assert not errors, errors
        want_sel = canon(ref_rows(ref_runner, snap, sel_dag(table, 900)))
        assert sorted(i for i, _ in results) == list(range(6))
        for i, rows in results:
            assert rows == (want if i % 2 else want_sel)
    finally:
        ep.close()


def test_async_endpoint_host_requests_resolve_inline(runner):
    table, snap, psnap = make_snapshot(n=500, seed=4)
    ep = port_ep(runner, psnap, threshold=100_000)
    try:
        d = ep.handle_async(CopRequest(REQ_TYPE_DAG,
                                       port_dag(hash_dag(table))))
        assert d.resolved
        resp = d.wait()
        assert resp.backend == "host"
        assert "host_exec" in resp.tracker.phases
        want = BatchExecutorsRunner(port_dag(hash_dag(table)),
                                    psnap).handle_request()
        assert canon(resp.rows()) == canon(want.rows())
    finally:
        ep.close()


# ------------------------------------------------- degrade-to-host races


def test_deferred_fetch_failpoint_degrades_to_host(runner, ref_runner):
    """device::before_fetch inside the deferred fetch answers the request
    on the host pipeline (the runner's own fallback; the endpoint counts
    it and labels the request host), or raises when the device was
    forced."""
    table, snap, psnap = make_snapshot(seed=5)
    dag = hash_dag(table)
    want = canon(ref_rows(ref_runner, snap, dag))
    d = runner.handle_request(port_dag(dag), psnap, deferred=True)
    failpoint.cfg("device::before_fetch", "1*return->off")
    assert canon(d.result().rows()) == want
    assert d.degraded == "fetch"
    ep = port_ep(runner, psnap)
    try:
        failpoint.cfg("device::before_fetch", "1*return->off")
        resp = ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(dag)))
        assert resp.backend == "host" and canon(resp.rows()) == want
        assert ep.degrades == {"fetch": 1}
        assert resp.tracker.labels["degraded"] == "fetch"
        failpoint.cfg("device::before_fetch", "1*return->off")
        with pytest.raises(DeviceUnavailable):
            ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(dag),
                                 force_backend="device"))
        assert ep.degrades == {"fetch": 1}
    finally:
        ep.close()


def test_dispatch_failpoint_races_deferred_fetch(runner, ref_runner):
    """A device::before_dispatch fault degrades the request whose dispatch
    it fires in; another request's fetch in flight resolves on the device
    untouched."""
    table, snap, psnap = make_snapshot(seed=6)
    dag = hash_dag(table)
    want = canon(ref_rows(ref_runner, snap, dag))
    ep = port_ep(runner, psnap)
    try:
        inflight = ep.handle_async(CopRequest(REQ_TYPE_DAG, port_dag(dag)))
        failpoint.cfg("device::before_dispatch", "1*return->off")
        raced = ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(dag)))
        assert raced.backend == "host" and canon(raced.rows()) == want
        assert ep.degrades == {"dispatch": 1}
        resp = inflight.wait()
        assert resp.backend == "device" and canon(resp.rows()) == want
    finally:
        ep.close()


def test_completion_failure_degrades_unless_forced(runner, ref_runner,
                                                   monkeypatch):
    """A device fault surfacing from the completion pool follows the
    degrade policy: auto-routed requests fall to the host, a forced one
    raises.  Any other error there propagates."""
    table, snap, psnap = make_snapshot(seed=7)
    dag = hash_dag(table)
    want = canon(ref_rows(ref_runner, snap, dag))

    def lost(self):
        raise DeviceUnavailable("transfer lost")

    ep = port_ep(runner, psnap)
    try:
        monkeypatch.setattr(DeferredResult, "result", lost)
        resp = ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(dag)))
        assert resp.backend == "host" and canon(resp.rows()) == want
        assert ep.degrades == {"fetch": 1}
        with pytest.raises(DeviceUnavailable, match="transfer lost"):
            ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(dag),
                                 force_backend="device"))

        def broken(self):
            raise RuntimeError("sel_pred: an illegal memory access")

        monkeypatch.setattr(DeferredResult, "result", broken)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            ep.handle(CopRequest(REQ_TYPE_DAG, port_dag(dag)))
        assert ep.degrades == {"fetch": 1}
    finally:
        ep.close()


def test_simple_agg_deferred_parity(runner, ref_runner):
    """Config 3's shape (SUM, COUNT, AVG, no GROUP BY) through the async
    endpoint."""
    table, snap, psnap = make_snapshot(seed=8)
    sel = DagSelect.from_table(table, ["id", "k", "v"])
    dag = sel.aggregate([], [("sum", sel.col("v")), ("count_star", None),
                             ("avg", sel.col("v"))]).build()
    ep = port_ep(runner, psnap)
    try:
        resp = ep.handle_async(CopRequest(REQ_TYPE_DAG, port_dag(dag))).wait()
    finally:
        ep.close()
    want = ref_rows(ref_runner, snap, dag)[0]
    got = resp.rows()[0]
    assert resp.backend == "device"
    assert got[0] == want[0] and got[1] == want[1]
    assert abs(got[2] - want[2]) < 1e-9


# --------------------------------------------------- staging and phases


def test_pinned_stager_pools_its_buffers():
    """On the CPU the stager copies plainly into unpinned pooled buffers:
    a fetched buffer goes back to its bytes class and serves the next
    readback of that class; the arrays come back with their dtypes and
    shapes."""
    st = dfr.PinnedStager()
    a = torch.arange(10, dtype=torch.int64)
    b = torch.tensor([[True, False], [False, True]])
    got = st.stage([a, b]).fetch()
    np.testing.assert_array_equal(got[0], np.arange(10))
    assert got[1].dtype == np.bool_ and got[1].shape == (2, 2)
    assert got[1].tolist() == [[True, False], [False, True]]
    stats = st.stats()
    assert stats["classes"] == 1 and stats["pooled"] == 2
    assert stats["allocated"] == 2
    # the next readbacks of that class take the pooled buffers
    got = st.stage([a + 1, torch.ones(900, dtype=torch.float32)]).fetch()
    assert got[0][-1] == 10 and got[1].dtype == np.float32
    assert float(got[1].sum()) == 900.0
    stats = st.stats()
    assert stats["allocated"] == 2 and stats["staged"] == 4
    assert stats["staged_bytes"] == 80 + 4 + 80 + 3600
    # another bytes class
    st.stage([torch.zeros(3000, dtype=torch.float32)]).fetch()
    assert st.stats()["classes"] == 2 and st.stats()["allocated"] == 3


def test_request_phases_are_recorded(runner):
    table, snap, psnap = make_snapshot(seed=9)
    ep = port_ep(runner, psnap)
    try:
        resp = ep.handle(CopRequest(REQ_TYPE_DAG,
                                    port_dag(hash_dag(table))))
    finally:
        ep.close()
    assert resp.tracker.labels["backend"] == "device"
    for phase in ("d2h_wait", "host_materialize", "completion_queue_wait"):
        assert phase in resp.tracker.phases, resp.tracker.phases


def test_concurrent_requests_lose_no_count(runner):
    """More request threads than cores, with a short switch interval: the
    runner's route counts (updated at dispatch and on completion workers)
    lose no update, and every answer is exact."""
    import sys
    table, snap, psnap = make_snapshot(n=4000, seed=16)
    ep = port_ep(runner, psnap, threshold=1)
    dags = [port_dag(sel_dag(table, t)) for t in (-50_000, 0, 50_000)]
    wants = [BatchExecutorsRunner(d, psnap).handle_request().rows()
             for d in dags]
    routes0 = sum(runner.sel_routes.values())
    preds0 = runner.pred_routes.get("sel_pred", 0)
    bad, mu = [], threading.Lock()

    def one(i):
        for j in range(3):
            k = (i + j) % 3
            got = ep.handle(CopRequest(REQ_TYPE_DAG, dags[k])).rows()
            if got != wants[k]:
                with mu:
                    bad.append((i, j))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        join_all(threads)
    finally:
        sys.setswitchinterval(old)
        ep.close()
    assert not bad, bad
    assert sum(runner.sel_routes.values()) - routes0 == 72
    assert runner.pred_routes.get("sel_pred", 0) - preds0 == 72
