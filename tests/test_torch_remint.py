"""The port's re-mint governor (``tikv_tpu_torch/device/supervisor.py``
``RemintGovernor``) and region heat (``RegionColumnarCache._note_heat`` /
``region_heat``) against the JAX package's, in the shape of
``tests/test_feed_migration.py``'s four governor tests: free admission
when off, the queue's order (hottest region first, RU debtors last, the
worst waiter shed with the retry hint), a storm's concurrency bound, and
the cache's cold builds taking a permit (phase ``remint_wait``).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from tikv_tpu.chaos import InvariantViolation, check_remint_concurrency_bounded
from tikv_tpu.device.supervisor import RemintGovernor as RefGovernor
from tikv_tpu.server.read_pool import ServerIsBusy as RefBusy

from tikv_tpu_torch.copr import region_cache as prc
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.device.supervisor import RemintGovernor
from tikv_tpu_torch.raftstore.metapb import Region
from tikv_tpu_torch.raftstore.observer import CoprocessorHost
from tikv_tpu_torch.raftstore.peer import RegionSnapshot
from tikv_tpu_torch.server.read_pool import ServerIsBusy
from tikv_tpu_torch.sst_importer import fast_mvcc_table_sst
from tikv_tpu_torch.engine.memory import MemoryEngine
from tikv_tpu_torch.testing import mvcc as tm

PAIRS = ((RemintGovernor, ServerIsBusy), (RefGovernor, RefBusy))


@pytest.mark.parametrize("cls", (RemintGovernor, RefGovernor))
def test_governor_disabled_is_free_admission(cls):
    gov = cls(max_concurrent=0)
    assert gov.acquire(1, heat=9.0) is None
    gov.release(None)
    assert gov.stats()["admitted"] == 0


def queue_order(cls, busy):
    """The single slot held; four waiters enqueue in a fixed order → (the
    shed (region, retry hint)s, the admission order, the final stats)."""
    debtor = threading.local()

    class G(cls):
        def _ru_debt(self):
            return getattr(debtor, "flag", False)

    gov = G(max_concurrent=1, max_queue=3, retry_after_ms=77)
    hold = gov.acquire(0, heat=0.0)
    admitted, shed = [], []
    started = threading.Barrier(5)

    def build(region, heat, debt, delay):
        debtor.flag = debt
        started.wait()
        time.sleep(delay)           # a fixed enqueue order
        try:
            t = gov.acquire(region, heat=heat)
        except busy as e:
            shed.append((region, e.retry_after_ms))
            return
        admitted.append(region)
        gov.release(t)

    specs = [(1, 0.5, False, 0.00), (2, 9.0, False, 0.03),
             (3, 30.0, True, 0.06), (4, 0.1, False, 0.09)]
    threads = [threading.Thread(target=build, args=s, daemon=True)
               for s in specs]
    for t in threads:
        t.start()
    started.wait()
    deadline = time.monotonic() + 5.0
    while gov.stats()["depth"] + len(shed) < 4 and \
            time.monotonic() < deadline:
        time.sleep(0.005)
    gov.release(hold)
    for t in threads:
        t.join(5.0)
    return shed, admitted, gov.stats()


def test_governor_priority_hot_first_debtors_last_shed_worst():
    """With the one build slot held, waiters are admitted hottest region
    first and RU debtors last; past the queue's bound the worst waiter is
    shed with the retry hint — the same outcome on both packages."""
    got = queue_order(RemintGovernor, ServerIsBusy)
    want = queue_order(RefGovernor, RefBusy)
    assert got == want
    shed, admitted, st = got
    assert shed == [(3, 77)] and admitted == [2, 1, 4]
    assert st["observed_max"] == 1 and st["active"] == 0
    assert (st["admitted"], st["queued"], st["shed"]) == (4, 4, 1)
    check_remint_concurrency_bounded(st, 1)


def test_the_port_has_no_ru_debtor():
    """No resource controller in the port yet: no tenant is in debt."""
    assert RemintGovernor._ru_debt() is False


@pytest.mark.parametrize("cls", (RemintGovernor, RefGovernor))
def test_governor_bounds_storm_concurrency(cls):
    gov = cls(max_concurrent=2, max_queue=64)
    peak, active = [0], [0]
    mu = threading.Lock()

    def build(region):
        t = gov.acquire(region, heat=float(region))
        with mu:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.005)
        with mu:
            active[0] -= 1
        gov.release(t)

    threads = [threading.Thread(target=build, args=(i,), daemon=True)
               for i in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    st = gov.stats()
    assert peak[0] <= 2 and st["observed_max"] <= 2, (peak, st)
    assert st["admitted"] == 10 and st["depth"] == 0
    check_remint_concurrency_bounded(st, 2)
    with pytest.raises(InvariantViolation, match="exceeded its bound"):
        check_remint_concurrency_bounded(st, st["observed_max"] - 1)


def test_region_heat_decays_as_the_reference():
    from tikv_tpu.copr.region_cache import RegionColumnarCache as RefCache
    port, ref = prc.RegionColumnarCache(), RefCache()
    for _ in range(50):
        port._note_heat(7)
        ref._note_heat(7)
    assert port._HEAT_HALFLIFE_S == ref._HEAT_HALFLIFE_S == 30.0
    assert port.region_heat(8) == ref.region_heat(8) == 0.0
    assert 49.0 < port.region_heat(7) <= 50.0
    assert abs(port.region_heat(7) - ref.region_heat(7)) < 0.01
    # half-life: a stamp 30 s older halves the rate
    port._heat[7][1] -= 30.0
    assert 24.5 < port.region_heat(7) <= 25.0


def test_governor_gates_cache_cold_builds():
    """Wired as ``RegionColumnarCache.remint_gate``, the governor brackets
    every cold build (phase ``remint_wait``; admitted = builds), a request
    counts toward its region's heat, and a shed surfaces as
    ``ServerIsBusy`` to the request that would have built."""
    runner = DeviceRunner(device="cpu")
    engine, host = MemoryEngine(), CoprocessorHost()
    table = tm.table_6c()
    h = np.arange(400, dtype=np.int64)
    tm.apply_ingest(engine, host, 1, 10, fast_mvcc_table_sst(
        table.table_id, h, [(2, h % 4, None), (3, h, None)], 100))
    cache = prc.RegionColumnarCache()
    cache.device_resolver = runner.mvcc_resolver()
    gov = RemintGovernor(max_concurrent=1, max_queue=1)
    cache.remint_gate = gov
    index = [10]

    def provider(req):
        rs = RegionSnapshot(engine.snapshot(), Region(1))
        rs.data_index = index[0]
        return cache.get(rs, req.dag)

    ep = Endpoint(provider, runner, device_row_threshold=1)
    from tikv_tpu_torch.convert import dag_from_wire
    from tikv_tpu_torch.copr.wire import enc_dag
    from tikv_tpu_torch.testing.dag import DagSelect
    s = DagSelect.from_table(table, ["id", "c0", "c1"])
    dag = dag_from_wire(enc_dag(s.aggregate(
        [], [("count_star", None), ("sum", s.col("c1"))]).build(10 ** 9)))
    for i in range(3):
        resp = ep.handle(CopRequest(REQ_TYPE_DAG, dag,
                                    force_backend="device"))
        assert [list(r) for r in resp.rows()] == [[400, int(h.sum())]]
        assert ("remint_wait" in resp.tracker.phases) == (i == 0)
    assert gov.stats()["admitted"] == cache.misses == 1
    assert cache.region_heat(1) > 2.5
    # the slot held and one waiter queued: the next waiter sheds the
    # worst-priority one (the coldest: this request's build)
    hold = gov.acquire(99, heat=1e9)
    waiter = threading.Thread(target=lambda: gov.release(
        gov.acquire(98, heat=1e9)), daemon=True)
    waiter.start()
    deadline = time.monotonic() + 5.0
    while gov.stats()["depth"] < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    index[0] = 11                   # a new data version: a cold build
    try:
        with pytest.raises(ServerIsBusy) as e:
            provider(CopRequest(REQ_TYPE_DAG, dag))
        assert e.value.retry_after_ms == gov.retry_after_ms
    finally:
        gov.release(hold)
        waiter.join(5.0)
    assert gov.stats()["shed"] == 1 and gov.stats()["active"] == 0
