"""The port's store in process (``tikv_tpu_torch.server``: ``Node`` over
``MockPd`` with a CPU ``DeviceRunner``, and ``KvService``) against the JAX
package's ``Node`` + ``KvService`` on the same requests.

One node of each package runs for the module, both with
``device_row_threshold=128`` and the 10 GiB region of the chip smoke's
``srv`` cell (``region_split_size_mb=10240``, so the split checker leaves
it whole), and both get every request
with the same timestamps (one clock): the body of
``test_analyze_checksum.py::test_analyze_and_checksum_over_network``; the
in-process halves of ``test_server.py``'s txn, lock-resolution,
write-conflict, raw and coprocessor tests, ``backend == "device"``
included; a write between two reads that patches the port's feed; an
``ImportIngest`` of a v2 blob; and ``handle_raw`` with packed bytes.
Responses must carry equal rows, and error dicts equal field for field.
A fresh pair of nodes then takes the region admin RPCs (``SplitRegion``,
``RegionApplied``, ``MergeRegion``, ``RollbackMerge``) with the same
bodies; the port's node alone splits a region with resident feeds through
``SplitRegion`` (the children served from the sliced feeds) and runs the
split checker from its drive loop, suspended in import mode.
"""

import threading

import numpy as np
import pytest

from tikv_tpu.config import TikvConfig as RefConfig
from tikv_tpu.pd import MockPd as RefPd
from tikv_tpu.server import wire as ref_wire
from tikv_tpu.server.node import Node as RefNode
from tikv_tpu.server.service import KvService as RefService
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import encode_table_row, int_table

from tikv_tpu_torch.config import TikvConfig
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.pd.client import MockPd
from tikv_tpu_torch.server import wire as port_wire
from tikv_tpu_torch.server.node import Node
from tikv_tpu_torch.server.service import KvService


def _ref_config():
    cfg = RefConfig()
    cfg.raftstore.region_split_size_mb = 10240
    cfg.raftstore.region_max_size_mb = 15360
    return cfg


def _port_config():
    cfg = TikvConfig()
    cfg.raftstore.region_split_size_mb = 10240
    cfg.raftstore.region_max_size_mb = 15360
    return cfg


@pytest.fixture(scope="module")
def pair():
    import jax

    from tikv_tpu.device.runner import DeviceRunner as RefRunner
    from tikv_tpu.parallel import make_mesh
    rcfg = _ref_config()
    rcfg.coprocessor.fastpath_classes = 0   # the full-decode leg
    ref_pd = RefPd()
    ref = RefNode("ref:0", ref_pd, config=rcfg, device_row_threshold=128,
                  device_runner=RefRunner(mesh=make_mesh(
                      jax.devices()[:1])))
    port = Node("port:0", MockPd(), config=_port_config(),
                device_row_threshold=128,
                device_runner=DeviceRunner(device="cpu"))
    ref.start()
    port.start()
    try:
        yield {"ref": RefService(ref), "port": KvService(port),
               "tso": ref_pd.tso, "ref_node": ref, "port_node": port}
    finally:
        port.stop()
        ref.stop()


def both(pair, method, req, raw=False):
    """The same request to both services → (reference, port)."""
    if raw:
        return (pair["ref"].handle_raw(method, ref_wire.pack(dict(req))),
                pair["port"].handle_raw(method, port_wire.pack(dict(req))))
    return (pair["ref"].handle(method, dict(req)),
            pair["port"].handle(method, dict(req)))


def same(pair, method, req, raw=False):
    """Both answer alike: the error dict field for field, else the
    response fields the packages share (rows, values, pairs, ...)."""
    r, p = both(pair, method, req, raw)
    if r.get("error") or p.get("error"):
        assert p.get("error") == r.get("error"), (method, r, p)
        return r, p
    for k in ("rows", "value", "not_found", "pairs", "kvs", "columns",
              "checksum", "total_kvs", "total_bytes", "commit_ts",
              "min_commit_ts", "one_pc_commit_ts", "staged", "ingested",
              "is_drained", "resume_token", "import_mode"):
        assert p.get(k) == r.get(k), (method, k, r.get(k), p.get(k))
    return r, p


def txn_write(pair, muts):
    start = pair["tso"]()
    wire_muts = [{"op": o, "key": k, "value": v} for o, k, v in muts]
    same(pair, "KvPrewrite", {"mutations": wire_muts,
                              "primary": muts[0][1],
                              "start_version": start})
    commit = pair["tso"]()
    same(pair, "KvCommit", {"keys": [k for _o, k, _v in muts],
                            "start_version": start,
                            "commit_version": commit})
    return commit


def test_analyze_and_checksum_over_network(pair):
    table = int_table(2, table_id=702)
    txn_write(pair, [("put",) + encode_table_row(
        table, h, {"c0": h % 7, "c1": h}) for h in range(300)])
    sel = DagSelect.from_table(table, ["id", "c0", "c1"])
    dag = ref_wire.enc_dag(sel.build(start_ts=pair["tso"]()))
    r, p = same(pair, "Coprocessor", {"tp": 104, "dag": dag, "buckets": 8})
    cols = {c["col_id"]: c for c in p["columns"]}
    assert cols[2]["distinct"] == 7
    assert cols[2]["total"] == 300
    assert cols[3]["buckets"][-1][1] == 300
    r2, p2 = same(pair, "Coprocessor", {"tp": 105, "dag": dag})
    assert p2["total_kvs"] == 300 and p2["checksum"] != 0


def test_txn_put_get_versions_and_scan(pair):
    txn_write(pair, [("put", b"net-k", b"net-v")])
    same(pair, "KvGet", {"key": b"net-k", "version": pair["tso"]()})
    commit = txn_write(pair, [("put", b"2pc-a", b"1"), ("put", b"2pc-b",
                                                        b"2"),
                              ("put", b"2pc-c", b"3")])
    assert commit > 0
    r, p = same(pair, "KvBatchGet", {"keys": [b"2pc-a", b"2pc-b",
                                              b"2pc-c"],
                                     "version": pair["tso"]()})
    assert [x["value"] for x in p["pairs"]] == [b"1", b"2", b"3"]
    # a missing key: the reference's handler fails on its scan-detail
    # count (len(None), service.py:570); the port answers the pair with
    # value None, as Storage.batch_get returns it
    r, p = both(pair, "KvBatchGet", {"keys": [b"2pc-a", b"nope"],
                                     "version": pair["tso"]()})
    assert r["error"]["message"] == "object of type 'NoneType' has no len()"
    assert p["pairs"] == [{"key": b"2pc-a", "value": b"1"},
                          {"key": b"nope", "value": None}]
    txn_write(pair, [("put", b"ver-k", b"v1")])
    ts1 = pair["tso"]()
    txn_write(pair, [("put", b"ver-k", b"v2")])
    _, p = same(pair, "KvGet", {"key": b"ver-k", "version": ts1})
    assert p["value"] == b"v1"
    for i in range(5):
        txn_write(pair, [("put", b"scan-%d" % i, b"%d" % i)])
    _, p = same(pair, "KvScan", {"start_key": b"scan-",
                                 "end_key": b"scan-\xff", "limit": 10,
                                 "version": pair["tso"]()})
    assert [(x["key"], x["value"]) for x in p["pairs"]] == \
        [(b"scan-%d" % i, b"%d" % i) for i in range(5)]


def test_lock_resolution_and_write_conflict(pair):
    txn_write(pair, [("put", b"lock-k", b"old")])
    start = pair["tso"]()
    same(pair, "KvPrewrite", {
        "mutations": [{"op": "put", "key": b"lock-k", "value": b"orphan"}],
        "primary": b"lock-k", "start_version": start, "lock_ttl": 1})
    # a reader meets the lock: key_is_locked, equal field for field
    r, p = same(pair, "KvGet", {"key": b"lock-k",
                                "version": pair["tso"]()})
    assert p["error"]["kind"] == "key_is_locked"
    # the resolver's check rolls the expired orphan back
    now = pair["tso"]() + (10 << 18)
    r, p = same(pair, "KvCheckTxnStatus", {
        "primary_key": b"lock-k", "lock_ts": start,
        "caller_start_ts": now, "current_ts": now})
    assert p == r
    _, p = same(pair, "KvGet", {"key": b"lock-k",
                                "version": pair["tso"]()})
    assert p["value"] == b"old"
    # write conflict: a prewrite far in the past
    txn_write(pair, [("put", b"wc-k", b"v")])
    _, p = same(pair, "KvPrewrite", {
        "mutations": [{"op": "put", "key": b"wc-k", "value": b"x"}],
        "primary": b"wc-k", "start_version": 1})
    assert p["error"]["kind"] == "write_conflict"
    # raw API
    same(pair, "RawPut", {"key": b"raw-k", "value": b"raw-v"})
    _, p = same(pair, "RawGet", {"key": b"raw-k"})
    assert p["value"] == b"raw-v"
    # an unknown method and a pessimistic lock conflict
    same(pair, "NoSuchMethod", {})
    s2 = pair["tso"]()
    same(pair, "KvPessimisticLock", {"keys": [b"wc-k"], "primary": b"wc-k",
                                     "start_version": s2,
                                     "for_update_ts": s2})
    s3 = pair["tso"]()
    _, p = same(pair, "KvPessimisticLock", {
        "keys": [b"wc-k"], "primary": b"wc-k", "start_version": s3,
        "for_update_ts": s3})
    assert p["error"]["kind"] == "key_is_locked"
    same(pair, "KvPessimisticRollback", {"keys": [b"wc-k"],
                                         "start_version": s2,
                                         "for_update_ts": s2})


def _agg_dag(table, ts):
    sel = DagSelect.from_table(table, ["id", "c0", "c1"])
    return ref_wire.enc_dag(sel.aggregate(
        [sel.col("c0")],
        [("count_star", None), ("sum", sel.col("c1"))]).build(start_ts=ts))


def test_coprocessor_host_and_device(pair):
    table = int_table(2, table_id=9001)
    txn_write(pair, [("put",) + encode_table_row(
        table, h, {"c0": h % 5, "c1": h}) for h in range(50)])
    sel = DagSelect.from_table(table, ["id", "c0", "c1"])
    dag = sel.where(sel.col("c0").eq(2)).aggregate(
        [], [("count_star", None), ("sum", sel.col("c1"))]
    ).build(start_ts=pair["tso"]())
    r, p = same(pair, "Coprocessor", {"dag": ref_wire.enc_dag(dag)})
    expect = [h for h in range(50) if h % 5 == 2]
    assert p["rows"] == [[len(expect), sum(expect)]]
    assert p["backend"] == r["backend"] == "host"
    assert len(p["exec_summaries"]) == len(r["exec_summaries"]) >= 2

    table = int_table(2, table_id=9002)
    txn_write(pair, [("put",) + encode_table_row(
        table, h, {"c0": h % 7, "c1": h}) for h in range(300)])
    expect = sorted([sum(1 for h in range(300) if h % 7 == g),
                     sum(h for h in range(300) if h % 7 == g), g]
                    for g in range(7))
    r, p = both(pair, "Coprocessor", {"dag": _agg_dag(table,
                                                      pair["tso"]())})
    assert p["backend"] == r["backend"] == "device"
    assert sorted(p["rows"]) == sorted(r["rows"]) == expect
    r, p = both(pair, "Coprocessor", {"dag": _agg_dag(table,
                                                      pair["tso"]()),
                                      "force_backend": "host"})
    assert p["backend"] == r["backend"] == "host"
    assert sorted(p["rows"]) == sorted(r["rows"]) == expect
    hits = pair["port_node"].copr_cache.hits
    r, p = both(pair, "Coprocessor", {"dag": _agg_dag(table,
                                                      pair["tso"]())})
    assert p["backend"] == "device" and sorted(p["rows"]) == expect
    assert pair["port_node"].copr_cache.hits > hits


def test_write_between_reads_patches_the_feed(pair):
    table = int_table(2, table_id=9003)
    txn_write(pair, [("put",) + encode_table_row(
        table, h, {"c0": h % 7, "c1": h}) for h in range(400)])
    node = pair["port_node"]
    runner = node.device_runner
    r, p = both(pair, "Coprocessor", {"dag": _agg_dag(table,
                                                      pair["tso"]())})
    assert p["backend"] == "device" and sorted(p["rows"]) == \
        sorted(r["rows"])
    routes = dict(runner.feed_routes)
    cache = (node.copr_cache.deltas, node.copr_cache.rebuilds,
             node.copr_cache.misses)
    # one UPDATE and one INSERT through 2PC, then the same plan
    txn_write(pair, [("put",) + encode_table_row(
        table, 5, {"c0": 0, "c1": 1000}), ("put",) + encode_table_row(
        table, 400, {"c0": 1, "c1": 7})])
    r, p = both(pair, "Coprocessor", {"dag": _agg_dag(table,
                                                      pair["tso"]())})
    assert p["backend"] == r["backend"] == "device"
    assert sorted(p["rows"]) == sorted(r["rows"])
    rows = {row[2]: row for row in p["rows"]}
    assert rows[0][1] == sum(h for h in range(400) if h % 7 == 0) + 1000
    after = dict(runner.feed_routes)
    assert after.get("patch", 0) == routes.get("patch", 0) + 1
    assert after.get("upload", 0) == routes.get("upload", 0)
    assert node.copr_cache.deltas == cache[0] + 1
    assert (node.copr_cache.rebuilds, node.copr_cache.misses) == cache[1:]


def test_import_ingest_of_a_v2_blob(pair):
    from tikv_tpu.sst_importer import fast_mvcc_table_sst as ref_sst

    from tikv_tpu_torch.sst_importer import fast_mvcc_table_sst
    h = np.arange(0, 3000, dtype=np.int64)
    cols = [(2, h % 1024, None), (3, h % 1000, None)]
    commit = pair["tso"]()
    blob = fast_mvcc_table_sst(9004, h, cols, commit_ts=commit)
    assert blob == ref_sst(9004, h, cols, commit_ts=commit)
    same(pair, "ImportSwitchMode", {"import": True})
    part = 1 << 14
    n = -(-len(blob) // part)
    for i in range(n):
        _, p = same(pair, "ImportUpload", {
            "uuid": "blob-1", "seq": i, "total": n,
            "data": blob[i * part:(i + 1) * part]})
    assert p["staged"] is True
    _, p = same(pair, "ImportIngest", {"uuid": "blob-1", "region_id": 1})
    assert p["ingested"] == len(h)     # CF_WRITE records, values inline
    _, p = same(pair, "ImportIngest", {"uuid": "blob-1", "region_id": 1})
    assert p["error"]["kind"] == "other"
    same(pair, "ImportSwitchMode", {"import": False})
    table = int_table(2, table_id=9004)
    r, p = both(pair, "Coprocessor", {"dag": _agg_dag(table,
                                                      pair["tso"]())})
    assert p["backend"] == "device"
    assert sorted(p["rows"]) == sorted(r["rows"])
    assert sum(row[0] for row in p["rows"]) == len(h)


def test_handle_raw_with_packed_bytes(pair):
    table = int_table(2, table_id=9005)
    txn_write(pair, [("put",) + encode_table_row(
        table, h, {"c0": h % 3, "c1": h * 2}) for h in range(200)])
    r, p = same(pair, "Coprocessor",
                {"dag": _agg_dag(table, pair["tso"]())}, raw=True)
    assert p["backend"] == "device"
    # a read of a locked range: the same error dict, field for field
    start = pair["tso"]()
    k, v = encode_table_row(table, 7, {"c0": 1, "c1": 1})
    same(pair, "KvPrewrite", {"mutations": [{"op": "put", "key": k,
                                             "value": v}],
                              "primary": k, "start_version": start},
         raw=True)
    r, p = same(pair, "Coprocessor",
                {"dag": _agg_dag(table, pair["tso"]())}, raw=True)
    assert p["error"]["kind"] == "key_is_locked"
    r, p = same(pair, "KvGet", {"key": k, "version": pair["tso"]()},
                raw=True)
    assert p["error"]["kind"] == "key_is_locked"
    same(pair, "KvBatchRollback", {"keys": [k], "start_version": start},
         raw=True)
    # an expired deadline is shed at admission: the same error but for
    # its overrun, which is each request's own clock reading
    r, p = both(pair, "KvGet", {"key": k, "version": pair["tso"](),
                                "deadline_ms": 0}, raw=True)
    assert p["error"]["kind"] == "deadline_exceeded"
    assert p["error"].pop("overrun_ms") >= 0
    r["error"].pop("overrun_ms")
    assert p["error"] == r["error"]


def test_node_threads_are_the_nodes_own():
    """A node started and stopped leaves none of its threads behind."""
    before = {t.ident for t in threading.enumerate()}
    node = Node("solo:0", MockPd(), device_row_threshold=128,
                device_runner=DeviceRunner(device="cpu"))
    node.start()
    try:
        svc = KvService(node)
        assert svc.handle("RawPut", {"key": b"a", "value": b"b"}) == {}
    finally:
        node.stop()
    left = [t for t in threading.enumerate() if t.ident not in before]
    assert left == []


def test_node_defaults_to_the_card(monkeypatch):
    """Without a runner the node builds ``DeviceRunner()`` on ``cuda:0``,
    which raises where CUDA is missing, before any thread of the node
    starts and before the store takes an id from PD."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = {t.ident for t in threading.enumerate()}
    pd = MockPd()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Node("card:0", pd)
    assert pd.alloc_id() == MockPd().alloc_id()     # no store id taken
    assert [t for t in threading.enumerate() if t.ident not in before] == []


def test_config_loads_the_reference_template():
    """The reference's config template loads into the port's trimmed
    tree (the settings the port does not read are ignored), and every
    field the port keeps has the reference's value."""
    import dataclasses
    import pathlib
    path = str(pathlib.Path(__file__).resolve().parents[1]
               / "etc" / "config-template.toml")
    port, ref = TikvConfig.from_file(path), RefConfig.from_file(path)
    n = 0
    for section in dataclasses.fields(port):
        for f in dataclasses.fields(getattr(port, section.name)):
            assert getattr(getattr(port, section.name), f.name) == \
                getattr(getattr(ref, section.name), f.name), \
                (section.name, f.name)
            n += 1
    assert n == 39


# ---------------------------------------------------------- admin RPCs


@pytest.fixture
def admin_pair():
    import jax

    from tikv_tpu.device.runner import DeviceRunner as RefRunner
    from tikv_tpu.parallel import make_mesh
    rcfg = _ref_config()
    rcfg.coprocessor.fastpath_classes = 0
    ref_pd = RefPd()
    ref = RefNode("ref:0", ref_pd, config=rcfg, device_row_threshold=128,
                  device_runner=RefRunner(mesh=make_mesh(
                      jax.devices()[:1])))
    port = Node("port:0", MockPd(), config=_port_config(),
                device_row_threshold=128,
                device_runner=DeviceRunner(device="cpu"))
    ref.start()
    port.start()
    try:
        yield {"ref": RefService(ref), "port": KvService(port),
               "tso": ref_pd.tso, "ref_node": ref, "port_node": port}
    finally:
        port.stop()
        ref.stop()


def test_admin_rpcs_match_the_reference(admin_pair):
    pair = admin_pair
    table = int_table(2, table_id=751)
    txn_write(pair, [("put",) + encode_table_row(
        table, h, {"c0": h % 3, "c1": h}) for h in range(200)])
    mid = encode_table_row(table, 100, {})[0]
    r, p = both(pair, "SplitRegion", {"split_key": mid})
    assert p == r and p["right"]["start"] != b""
    right = p["right"]["id"]
    r, p = both(pair, "RegionApplied", {"region_id": right})
    assert p["applied"] >= 5 and r["applied"] >= 5
    def count():
        sel = DagSelect.from_table(table, ["id", "c0", "c1"])
        dag = ref_wire.enc_dag(sel.aggregate(
            [], [("count_star", None)]).build(start_ts=pair["tso"]()))
        return same(pair, "Coprocessor", {"dag": dag})[1]["rows"]

    assert count() == [[100]]   # the request's first range: the left
    # errors travel alike: an unknown region, a non-adjacent merge
    same(pair, "RegionApplied", {"region_id": 424242})
    same(pair, "MergeRegion", {"source_id": right, "target_id": right})
    r, p = both(pair, "MergeRegion", {"source_id": right, "target_id": 1})
    assert p == r and (p["region"]["start"], p["region"]["end"]) == \
        (b"", b"")
    assert right not in pair["port_node"].raft_store.peers
    r, p = both(pair, "RollbackMerge", {"region_id": 1})
    assert p == r == {}
    for node in ("ref_node", "port_node"):
        region = pair[node].raft_store.region_peer(1).region
        # split, the source's prepare, the commit, the rollback
        assert region.epoch.version == 5
    assert count() == [[200]]
    txn_write(pair, [("put",) + encode_table_row(
        table, 999, {"c0": 1, "c1": 1})])


def _port_node(**raftstore):
    cfg = TikvConfig()
    for k, v in raftstore.items():
        setattr(cfg.raftstore, k, v)
    cfg.validate()
    node = Node("port:0", MockPd(), config=cfg, device_row_threshold=64,
                device_runner=DeviceRunner(device="cpu"))
    node.start()
    return node, KvService(node)


def _load(svc, node, table, n: int) -> None:
    muts = [{"op": "put", "key": k, "value": v} for k, v in (
        encode_table_row(table, h, {"c0": h % 5, "c1": h % 1000})
        for h in range(n))]
    start = node.pd.tso()
    assert "error" not in svc.handle("KvPrewrite", {
        "mutations": muts, "primary": muts[0]["key"],
        "start_version": start})
    assert "error" not in svc.handle("KvCommit", {
        "keys": [m["key"] for m in muts], "start_version": start,
        "commit_version": node.pd.tso()})


def test_split_region_slices_the_nodes_resident_feeds():
    """``SplitRegion`` on a region whose feeds are resident: raft apply
    slices them, the children's first requests take the slices, and each
    child's answer is its rows'."""
    import time
    node, svc = _port_node(region_split_size_mb=10240,
                           region_max_size_mb=15360)
    try:
        table = int_table(2, table_id=752)
        _load(svc, node, table, 600)
        def ask(lo: int, hi: int):
            sel = DagSelect.from_table(table, ["id", "c0", "c1"])
            d = sel.aggregate([sel.col("c0")], [("count_star", None),
                                                ("sum", sel.col("c1"))])
            dag = ref_wire.enc_dag(d.build(start_ts=node.pd.tso()))
            dag["ranges"] = [{"s": encode_table_row(table, lo, {})[0],
                              "e": encode_table_row(table, hi, {})[0]}]
            # forced: the coalescer's cost router sends rows this few to
            # the host
            resp = svc.handle("Coprocessor", {"dag": dag,
                                              "force_backend": "device"})
            assert resp["backend"] == "device", resp
            want = {}
            for h in range(lo, hi):
                cnt, s_ = want.get(h % 5, (0, 0))
                want[h % 5] = (cnt + 1, s_ + h % 1000)
            assert sorted(map(tuple, resp["rows"]), key=lambda r: r[2]) == \
                [(c, s_, g) for g, (c, s_) in sorted(want.items())]

        ask(0, 600)
        routes = dict(node.device_runner.feed_routes)
        resp = svc.handle("SplitRegion", {
            "split_key": encode_table_row(table, 250, {})[0]})
        assert "error" not in resp, resp
        sup = node.device_supervisor
        assert sup.splits == 1 and sup.split_fallbacks == 0
        assert set(sup.split_phases_ms) == {"split_lines", "device_split"}
        ask(0, 250)
        ask(250, 600)
        now = node.device_runner.feed_routes
        assert now.get("split", 0) - routes.get("split", 0) == 2
        assert now.get("upload", 0) == routes.get("upload", 0)
        # merge back: both lines drop, the merged region builds once
        t0 = time.monotonic()
        resp = svc.handle("MergeRegion", {"source_id": resp["right"]["id"],
                                          "target_id": 1})
        assert "error" not in resp and time.monotonic() - t0 < 10
        misses = node.copr_cache.misses
        ask(0, 600)
        assert node.copr_cache.misses == misses + 1
    finally:
        node.stop()


def test_drive_loop_split_check_and_import_mode():
    """The drive loop runs the split checker every
    ``region_split_check_ticks`` ticks and splits a loaded region past a
    tiny region-split-size; in import mode it does not."""
    import time

    def regions(node):
        with node.lock:
            return len(node.raft_store.peers)

    node, svc = _port_node(region_split_size_mb=4 / 1024.0,
                           region_max_size_mb=8 / 1024.0,
                           region_split_check_ticks=2)
    try:
        svc.handle("ImportSwitchMode", {"import": True})
        _load(svc, node, int_table(2, table_id=753), 400)
        time.sleep(0.3)
        assert regions(node) == 1       # suspended while importing
        svc.handle("ImportSwitchMode", {"import": False})
        deadline = time.monotonic() + 10
        while regions(node) == 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert regions(node) >= 2
        with node.lock:
            peers = node.raft_store.peers_snapshot()
            assert all(p.is_leader() or not p.region.peers for p in peers)
    finally:
        node.stop()


def test_config_split_size_must_not_exceed_max():
    with pytest.raises(ValueError, match="region-split-size"):
        TikvConfig.from_dict({"raftstore": {"region-split-size-mb": 200}})
    with pytest.raises(ValueError, match="region-split-size"):
        RefConfig.from_dict({"raftstore": {"region-split-size-mb": 200}})
