"""The port stands alone: no module of ``tikv_tpu_torch`` (every source
under it, the selection, top-k and ANALYZE modules included, and
``chip_smoke.py``) imports JAX or the JAX package, serving an
aggregation, a selection, an index-scan top-k, a join plan, an ANALYZE
and a CHECKSUM request through the endpoint loads neither, nor does
serving selections and aggregations through ``Endpoint.handle_async``
with a bound ``RequestCoalescer``, nor a region split served end to end,
nor aggregations, a selection and a top-k over a row-sharded mesh
(``tikv_tpu_torch.parallel``), nor a placement mesh (``tikv_tpu_torch.pd``,
``device.placement``) serving, migrating a feed and draining a dead slice,
nor a write served through the delta path (``raftstore.cmd``,
``copr.delta``: the sink, the cache's bridge, the feed's patch, the scrub
and its quarantine), nor the cold path (``native``, ``sst_importer``,
``copr.stream_build``: an SST ingest streamed, the device rung, the native
rung, the re-mint governor, the native CHECKSUM fold), nor the store in
process (``raft``, ``raftstore``, ``storage``, ``kv``, ``pd.client``,
``config``, ``server.node``, ``server.service``, ``server.wire``: a 2PC
write and a coprocessor read through ``KvService``), nor a cluster of
three stores (``testing.cluster``, ``storage.mvcc.consistency``: a split
and a leader round trip under the card's feeds, a merge, a consistency
check, a snapshot catch-up and the MVCC scan), and nothing falls back to
the CPU without being asked.  The native module is the port's own
source: its compile names ``tikv_tpu_torch/native/fastbuild.cpp`` and no
file of the JAX package, and a failed compile raises."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tikv_tpu_torch.device import hash_agg as ha
from tikv_tpu_torch.device import resolve_device
from tikv_tpu_torch.device.runner import DeviceRunner

ROOT = Path(__file__).resolve().parent.parent
# the package's sources; ``_build/`` holds build outputs, not sources
SOURCES = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "tikv_tpu_torch").rglob("*.py")
                 if "_build" not in p.relative_to(ROOT).parts) + \
    ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "tikv_tpu")


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_no_jax(source):
    for name in _imported(ROOT / source):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{source} imports {name}"


_SERVE_ONE = """
import sys
from tikv_tpu_torch.convert import dag_from_wire
from tikv_tpu_torch.copr.wire import enc_dag
from tikv_tpu_torch.device import DeviceRunner
from tikv_tpu_torch.testing import configs
table, snap = configs.build_table(5000, 64)
runner = DeviceRunner(device="cpu")
dag = dag_from_wire(enc_dag(configs.dag_hash_agg(table)))
rows = runner.handle_request(dag, snap).rows()
assert sum(r[0] for r in rows) == 5000, rows
sel = dag_from_wire(enc_dag(configs.dag_selection(table)))
assert len(runner.handle_request(sel, snap).rows()) == \
    int((snap.columns[3].values > 800).sum())
t5, s5 = configs.ROW_CONFIGS["5"][0](5000)
top = dag_from_wire(enc_dag(configs.dag_topn_index(t5, 10)))
assert len(runner.handle_request(top, s5).rows()) == 10
from tikv_tpu_torch.copr.endpoint import Endpoint
from tikv_tpu_torch.copr.wire import enc_plan
from tikv_tpu_torch.convert import plan_from_wire
pt, ps, bt, bs = configs.build_join_pair(3000, 256)
by = {pt.table_id: ps, bt.table_id: bs}
ep = Endpoint(lambda req: by[req.dag.executors[0].table_id], runner)
plan = plan_from_wire(enc_plan(configs.plan_join(pt, bt)))
got = ep.handle_plan(plan, force_backend="device").result.batch
assert configs.columns_agree(got, configs.plan_truth("7", ps, bs))
assert ep.plan_executor.join_backends == {"device": 1}
from tikv_tpu_torch.copr.analyze import ChecksumReq
areq = configs.analyze_request(table, 16)
aep = Endpoint(lambda req: snap, runner, device_row_threshold=1)
stats = aep.handle_analyze(areq)["columns"]
assert [s.total for s in stats] == [5000] * 3 and not aep.degrades
assert runner.analyze_phases_ms["pad_h2d"] >= 0
cs = aep.handle_checksum(ChecksumReq(areq.scan, areq.ranges))
assert cs["total_kvs"] == 5000 and cs["checksum"] != 0
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
assert not bad, bad
print("served", len(rows))
"""


def test_serving_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _SERVE_ONE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "served 64"


_SERVE_COALESCED = """
import sys, threading
from tikv_tpu_torch.convert import dag_from_wire
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.copr.wire import enc_dag
from tikv_tpu_torch.device import DeviceRunner
from tikv_tpu_torch.server.coalescer import RequestCoalescer
from tikv_tpu_torch.testing import configs
table, snap = configs.build_table(5000, 64)
runner = DeviceRunner(device="cpu")
coal = RequestCoalescer(runner, window_ms=60_000.0, max_group=4)
coal.idle_bypass = False
ep = Endpoint(lambda req: snap, runner, device_row_threshold=1,
              coalescer=coal)
thrs = [100, 300, 500, 700]
out = [None] * 4
def one(i):
    dag = dag_from_wire(enc_dag(configs.dag_selection(table, thrs[i])))
    out[i] = ep.handle_async(CopRequest(REQ_TYPE_DAG, dag)).wait()
ts = [threading.Thread(target=one, args=(i,)) for i in range(4)]
for t in ts:
    t.start()
for t in ts:
    t.join(timeout=60)
v = snap.columns[3].values
assert [len(r.rows()) for r in out] == [int((v > t).sum()) for t in thrs]
assert runner.sel_routes.get("batched") == 1, runner.sel_routes
coal.idle_bypass = True         # a lone request dispatches at once
agg = dag_from_wire(enc_dag(configs.dag_hash_agg(table)))
rows = ep.handle_async(CopRequest(REQ_TYPE_DAG, agg)).wait().rows()
assert sum(r[0] for r in rows) == 5000
ep.close()
assert coal.stats()["groups_dispatched"] == 2, coal.stats()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
assert not bad, bad
print("coalesced", coal.stats()["requests_coalesced"])
"""


def test_coalesced_serving_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _SERVE_COALESCED], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "coalesced 5"


_SERVE_SPLIT = """
import sys
import numpy as np
from tikv_tpu_torch.codec.keys import table_record_key
from tikv_tpu_torch.convert import engine_from_triples
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.copr.region_cache import RegionColumnarCache
from tikv_tpu_torch.device import DeviceRunner
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
ev = tm.Event(100, tm.WT_PUT, h, {2: (h % 7, ones), 3: (h % 1000, ones)})
engine = engine_from_triples(tm.kv_history(table.table_id, h, [ev]))
runner = DeviceRunner(device="cpu")
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
def counts():
    r = ep.handle(CopRequest(REQ_TYPE_DAG, dag, force_backend="device"))
    return sum(row[0] for row in r.rows()), r.tracker.labels["device_feed"]
assert counts() == (2000, "upload")
sk = encode_key(table_record_key(table.table_id, 1234))
left = Region(1, b"", sk, RegionEpoch(1, 2))
right = Region(2, sk, b"", RegionEpoch(1, 2))
host.notify_region_split(left, right, 100, 100)
host.notify_region_changed(left)
got = []
for region[0] in (left, right):
    got.append(counts())
assert got == [(1234, "split"), (766, "split")], got
assert sup.splits == 1 and runner.feed_routes["split"] == 2
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
assert not bad, bad
print("split", sup.splits)
"""


def test_split_serving_loads_no_jax():
    """A region split served end to end — engine, region snapshot, cache
    line, endpoint, the observer host's split and the children's
    requests — loads neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _SERVE_SPLIT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "split 1"


_SERVE_MESH = """
import sys
from tikv_tpu_torch.convert import dag_from_wire, mesh_from_shape
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.copr.wire import enc_dag
from tikv_tpu_torch.device import DeviceRunner
from tikv_tpu_torch.parallel import make_mesh, parse_mesh_shape
from tikv_tpu_torch.server.coalescer import RequestCoalescer
from tikv_tpu_torch.testing import configs
table, snap = configs.build_multichip_table(20000)
runner = DeviceRunner(mesh=make_mesh(["cpu"] * 4,
                                     shape=parse_mesh_shape("2x2")),
                      chunk_rows=512)
coal = RequestCoalescer(runner, window_ms=5.0, max_group=4)
ep = Endpoint(lambda req: snap, runner, device_row_threshold=1,
              coalescer=coal)
want, scales = configs.truth("4x", snap)
for make in (configs.dag_4x, configs.dag_hash_agg, configs.dag_simple_agg):
    dag = dag_from_wire(enc_dag(make(table)))
    got = ep.handle_async(CopRequest(REQ_TYPE_DAG, dag)).wait()
    assert got.backend == "device", got.backend
assert configs.rows_agree(ep.handle(CopRequest(
    REQ_TYPE_DAG, dag_from_wire(enc_dag(configs.dag_4x(table))))).rows(),
    want, scales, 1e-9)
sel = dag_from_wire(enc_dag(configs.dag_selection(table, 40)))
assert len(ep.handle(CopRequest(REQ_TYPE_DAG, sel)).rows()) == \
    int((snap.columns[3].values > 40).sum())
seven = DeviceRunner(mesh=mesh_from_shape((1, 7), ["cpu"] * 7),
                     chunk_rows=512)
t5, s5 = configs.ROW_CONFIGS["5t"][0](20000)
top = dag_from_wire(enc_dag(configs.dag_topn_table(t5, 10)))
assert len(seven.handle_request(top, s5).rows()) == 10
ep.close()
assert not ep.degrades and not runner.degrades
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
assert not bad, bad
print("mesh", runner._nshards())
"""


_SERVE_WRITE = """
import sys
import numpy as np
from tikv_tpu_torch.convert import engine_from_triples
from tikv_tpu_torch.copr.delta import DeltaSink
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.copr.region_cache import RegionColumnarCache
from tikv_tpu_torch.device import DeviceRunner
from tikv_tpu_torch.device.supervisor import DeviceStateSupervisor
from tikv_tpu_torch.raftstore.metapb import Region
from tikv_tpu_torch.raftstore.observer import CoprocessorHost
from tikv_tpu_torch.raftstore.peer import RegionSnapshot
from tikv_tpu_torch.testing import mvcc as tm
from tikv_tpu_torch.testing.dag import DagSelect
from tikv_tpu_torch.utils import failpoint
table = tm.table_6c()
h = np.arange(2000, dtype=np.int64)
ones = np.ones(2000, np.bool_)
ev = tm.Event(100, tm.WT_PUT, h, {2: (h % 7, ones), 3: (h % 1000, ones)})
engine = engine_from_triples(tm.kv_history(table.table_id, h, [ev]))
runner = DeviceRunner(device="cpu")
sink = DeltaSink()
cache = RegionColumnarCache(delta_source=sink)
host = CoprocessorHost()
sup = DeviceStateSupervisor(runner, cache, sink)
host.register(sink)
host.register(sup)
index = [100]
def provider(req):
    rs = RegionSnapshot(engine.snapshot(), Region(1))
    rs.data_index = index[0]
    return cache.get(rs, req.dag)
ep = Endpoint(provider, runner, device_row_threshold=1)
def total(ts):
    s = DagSelect.from_table(table, ["id", "c0", "c1"])
    dag = s.aggregate([s.col("c0")], [("sum", s.col("c1"))]).build(ts)
    r = ep.handle(CopRequest(REQ_TYPE_DAG, dag))
    return sum(row[0] for row in r.rows()), r.tracker.labels["device_feed"]
want = int((h % 1000).sum())
assert total(200) == (want, "upload")
one = np.ones(1, np.bool_)
tm.apply_write(engine, host, 1, 101, tm.kv_history(
    table.table_id, h[:1], [tm.Event(300, tm.WT_PUT, np.arange(1),
                                     {2: (h[:1], one), 3: (h[:1] + 5, one)})]))
index[0] = 101
assert total(310) == (want + 5, "patch")
assert sup.scrub()["divergences"] == 0
failpoint.cfg("device::feed_corrupt", "1*return")
assert sup.scrub()["divergences"] == 1
failpoint.teardown()
assert total(310) == (want + 5, "quarantined") and ep.degrades
assert total(310) == (want + 5, "upload")
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
assert not bad, bad
print("write", cache.deltas)
"""


def test_write_serving_loads_no_jax():
    """A write served through the delta path — the engine write, the
    observer host's ``DeltaSink``, the cache's bridge, the feed's patch,
    then a scrub, its quarantine and the re-upload — loads neither JAX nor
    the JAX package."""
    out = subprocess.run([sys.executable, "-c", _SERVE_WRITE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "write 1"


def test_mesh_serving_loads_no_jax():
    """Serving over a row-sharded mesh — the mesh helpers, the sharded
    feed, the per-shard routes and the cross-shard merges, through the
    endpoint with a coalescer bound — loads neither JAX nor the JAX
    package."""
    out = subprocess.run([sys.executable, "-c", _SERVE_MESH], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "mesh 4"


_SERVE_PLACEMENT = """
import sys
from tikv_tpu_torch.convert import dag_from_wire
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.copr.wire import enc_dag
from tikv_tpu_torch.device import DeviceRunner
from tikv_tpu_torch.parallel import make_mesh
from tikv_tpu_torch.pd.scheduler import pick_slice
from tikv_tpu_torch.testing import configs
from tikv_tpu_torch.utils import failpoint
runner = DeviceRunner(mesh=make_mesh(["cpu"] * 4), chunk_rows=512,
                      placement=True, placement_rows=1 << 14,
                      slice_probe_cooldown_s=0.0)
tables = [configs.serving_table(3000, 9920 + i) for i in range(5)]
by_id = {t.table_id: snap for t, snap in tables}
ep = Endpoint(lambda req: by_id[req.dag.executors[0].table_id], runner,
              device_row_threshold=1)
def serve():
    for t, snap in tables:
        for thr in (990, None):
            dag = dag_from_wire(enc_dag(configs.dag_serving(t, thr)))
            got = ep.handle(CopRequest(REQ_TYPE_DAG, dag))
            want = configs.serving_truth(3000, thr)
            if thr is None:
                assert sorted(got.rows()) == want
            else:
                assert configs.columns_agree(got.result.batch, want)
serve()
placer = runner.placer
anchor = runner._feed_anchor(tables[0][1])
src = placer.slices.index(placer.owner(anchor))
assert placer.migrate(anchor, src, pick_slice(placer.scores(), {src}))
failpoint.cfg("device::slice_dead", "return(%d)" % src)
for _ in range(3):
    serve()
assert src in runner._board.quarantined_set()
failpoint.teardown()
runner.probe_quarantined()
assert not runner._board.quarantined_set()
serve()
ep.close()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
assert not bad, bad
print("placement", placer.stats()["migrations"] >= 2)
"""


def test_placement_serving_loads_no_jax():
    """A placement mesh serving through the endpoint, migrating a feed,
    tripping and draining a slice and re-admitting it loads neither JAX
    nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _SERVE_PLACEMENT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "placement True"


def test_runner_refuses_to_start_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceRunner()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert DeviceRunner(device="cpu").device == torch.device("cpu")
    from tikv_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceRunner(mesh=make_mesh(["cuda:0"] * 2))


def test_kernel_wrapper_never_picks_another_device():
    with pytest.raises(ValueError):
        ha.hash_agg("simple", 4, 1, 1, device="meta")
    key = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        ha._check(key, "key", torch.int32, 4, torch.device("cpu"))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_the_card(where, tmp_path):
    """Without CUDA (here) or outside a checkout it exits non-zero and
    prints no result line."""
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = ROOT
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_SERVE_COLD = """
import sys
import numpy as np
from tikv_tpu_torch.convert import dag_from_wire
from tikv_tpu_torch.copr import region_cache as rc
from tikv_tpu_torch.copr.analyze import checksum_kv_pairs
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.copr.stream_build import ColdStreamBuilder
from tikv_tpu_torch.copr.wire import enc_dag
from tikv_tpu_torch.device import DeviceRunner
from tikv_tpu_torch.device.supervisor import RemintGovernor
from tikv_tpu_torch.engine.memory import MemoryEngine
from tikv_tpu_torch.raftstore.metapb import Region
from tikv_tpu_torch.raftstore.observer import CoprocessorHost
from tikv_tpu_torch.raftstore.peer import RegionSnapshot
from tikv_tpu_torch.sst_importer import fast_mvcc_table_sst
from tikv_tpu_torch.testing import mvcc as tm
from tikv_tpu_torch.testing.dag import DagSelect
runner = DeviceRunner(device="cpu")
engine, host = MemoryEngine(), CoprocessorHost()
stream = ColdStreamBuilder(runner.mvcc_resolver())
host.register(stream)
table = tm.table_6c()
for i in range(3):
    h = np.arange(i * 1000, (i + 1) * 1000, dtype=np.int64)
    tm.apply_ingest(engine, host, 1, 10 + i, fast_mvcc_table_sst(
        table.table_id, h, [(2, h % 8, None), (3, h % 100, None)], 100))
assert stream.wait_idle(30.0)
s = DagSelect.from_table(table, ["id", "c0", "c1"])
dag = dag_from_wire(enc_dag(s.aggregate(
    [s.col("c0")], [("count_star", None), ("sum", s.col("c1"))]).build(500)))
labels = []
for resolver, src in ((runner.mvcc_resolver(), stream), (None, None)):
    cache = rc.RegionColumnarCache()
    cache.device_resolver, cache.stream_source = resolver, src
    cache.remint_gate = RemintGovernor(max_concurrent=1)
    def provider(req, cache=cache):
        rs = RegionSnapshot(engine.snapshot(), Region(1))
        rs.data_index = 12
        return cache.get(rs, req.dag)
    resp = Endpoint(provider, runner).handle(
        CopRequest(REQ_TYPE_DAG, dag, force_backend="device"))
    assert sum(r[0] for r in resp.rows()) == 3000
    labels.append(resp.tracker.labels["cold_build"])
assert labels == ["device", "native"], labels
assert stream.takes == 1
keys, vals, _ = engine.snapshot().range_cf("write", b"", b"\\xff")
assert checksum_kv_pairs(keys, vals)["total_kvs"] == 3000
stream.stop()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
assert not bad, bad
print("cold", stream.chunks_parsed)
"""


def test_cold_path_serving_loads_no_jax():
    """SST blobs ingested through the apply path and streamed, the device
    rung served from the stream's take, the native rung, a re-mint permit
    and the native CHECKSUM fold load neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _SERVE_COLD], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "cold 3"


_BUILD_NATIVE = """
import subprocess, sys
from pathlib import Path
import tikv_tpu_torch.native as nv
nv.BUILD_DIR = Path(sys.argv[1])
seen = []
run = subprocess.run
def spy(cmd, *a, **kw):
    seen.append(list(cmd))
    return run(cmd, *a, **kw)
subprocess.run = spy
assert nv.checksum_pairs([b"123456789"], [b""])[0] == 0x995DC9BBDF1939FA
assert len(seen) == 1, seen
print("\\n".join(seen[0]))
"""


def test_native_build_compiles_only_the_port_source(tmp_path):
    """A build from nothing runs one ``g++``, whose sources are the port's
    ``native/fastbuild.cpp`` alone; the source includes no file of the
    repository."""
    out = subprocess.run([sys.executable, "-c", _BUILD_NATIVE,
                          str(tmp_path)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    cmd = out.stdout.strip().splitlines()
    assert cmd[0] == "g++"
    sources = [a for a in cmd if a.endswith((".cpp", ".cc", ".c", ".h"))]
    assert [str(Path(a).relative_to(ROOT)) for a in sources] == \
        ["tikv_tpu_torch/native/fastbuild.cpp"]
    assert not any("tikv_tpu/" in a for a in cmd)
    assert list(tmp_path.glob("_fastbuild-*.so"))
    text = (ROOT / "tikv_tpu_torch/native/fastbuild.cpp").read_text()
    includes = [ln.split()[1] for ln in text.splitlines()
                if ln.startswith("#include")]
    assert includes and all(i.startswith("<") for i in includes), includes


def test_a_failed_native_compile_raises(tmp_path, monkeypatch):
    """No quiet fallback: a source g++ refuses raises with its output."""
    import tikv_tpu_torch.native as nv
    bad = tmp_path / "fastbuild.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nv, "SRC", bad)
    monkeypatch.setattr(nv, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nv, "_MOD", None)
    with pytest.raises(RuntimeError, match="native module build failed"):
        nv.module()
    with pytest.raises(RuntimeError, match="error"):
        nv.checksum_pairs([b"a"], [b"b"])
    assert not list((tmp_path / "_build").glob("*"))


# the store in process: every module of the slice is in the scan above
STORE_MODULES = [
    "tikv_tpu_torch/raft/raw_node.py", "tikv_tpu_torch/raft/network.py",
    "tikv_tpu_torch/raft/storage.py", "tikv_tpu_torch/raft/messages.py",
    "tikv_tpu_torch/raftstore/peer_storage.py",
    "tikv_tpu_torch/raftstore/peer.py", "tikv_tpu_torch/raftstore/store.py",
    "tikv_tpu_torch/raftstore/raftkv.py", "tikv_tpu_torch/kv/engine.py",
    "tikv_tpu_torch/storage/__init__.py",
    "tikv_tpu_torch/storage/mvcc/txn.py",
    "tikv_tpu_torch/storage/concurrency_manager.py",
    "tikv_tpu_torch/storage/txn/latch.py",
    "tikv_tpu_torch/storage/txn/actions.py",
    "tikv_tpu_torch/storage/txn/commands.py",
    "tikv_tpu_torch/storage/txn/scheduler.py",
    "tikv_tpu_torch/pd/client.py", "tikv_tpu_torch/config.py",
    "tikv_tpu_torch/copr/storage_impl.py",
    "tikv_tpu_torch/server/read_pool.py", "tikv_tpu_torch/server/wire.py",
    "tikv_tpu_torch/server/service.py", "tikv_tpu_torch/server/node.py",
    "tikv_tpu_torch/utils/error_code.py",
    "tikv_tpu_torch/testing/cluster.py",
    "tikv_tpu_torch/storage/mvcc/consistency.py"]


def test_store_modules_are_scanned():
    assert set(STORE_MODULES) <= set(SOURCES)


_SERVE_NODE = """
import sys
from tikv_tpu_torch.codec.keys import table_record_key
from tikv_tpu_torch.codec.row import encode_row
from tikv_tpu_torch.copr.wire import enc_dag
from tikv_tpu_torch.device import DeviceRunner
from tikv_tpu_torch.pd.client import MockPd
from tikv_tpu_torch.server import wire
from tikv_tpu_torch.server.node import Node
from tikv_tpu_torch.server.service import KvService
from tikv_tpu_torch.testing import configs
from tikv_tpu_torch.testing.dag import DagSelect
pd = MockPd()
node = Node("iso:0", pd, device_row_threshold=64,
            device_runner=DeviceRunner(device="cpu"))
node.start()
try:
    svc = KvService(node)
    table = configs.bench_table()
    rows = [(h, {2: h % 4, 3: h}) for h in range(300)]
    muts = [{"op": "put", "key": table_record_key(table.table_id, h),
             "value": encode_row(r)} for h, r in rows]
    start = pd.tso()
    r = svc.handle("KvPrewrite", {"mutations": muts,
                                  "primary": muts[0]["key"],
                                  "start_version": start})
    assert not r.get("error"), r
    r = svc.handle("KvCommit", {"keys": [m["key"] for m in muts],
                                "start_version": start,
                                "commit_version": pd.tso()})
    assert not r.get("error"), r
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [("count_star", None),
                                     ("sum", s.col("v"))]).build(pd.tso())
    raw = wire.pack({"dag": enc_dag(dag)})
    resp = svc.handle_raw("Coprocessor", raw)
    assert not resp.get("error"), resp
    assert resp["backend"] == "device", resp["backend"]
    assert sum(row[0] for row in resp["rows"]) == 300, resp["rows"]
finally:
    node.stop()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
assert not bad, bad
print("node served", len(resp["rows"]))
"""


def test_node_serving_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _SERVE_NODE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "node served 4"


_SERVE_CLUSTER = """
import sys
from tikv_tpu_torch.copr.delta import DeltaSink
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.copr.region_cache import RegionColumnarCache
from tikv_tpu_torch.device import DeviceRunner
from tikv_tpu_torch.device.supervisor import DeviceStateSupervisor
from tikv_tpu_torch.kv.engine import SnapContext
from tikv_tpu_torch.raftstore import Peer
from tikv_tpu_torch.storage.mvcc.consistency import check_mvcc_consistency
from tikv_tpu_torch.testing.cluster import Cluster
from tikv_tpu_torch.testing.dag import DagSelect
from tikv_tpu_torch.testing.fixture import encode_table_row
from tikv_tpu_torch.testing import mvcc as tm
table = tm.table_6c()
c = Cluster(3)
c.bootstrap()
c.start()
runner = DeviceRunner(device="cpu")
sink = DeltaSink()
cache = RegionColumnarCache(delta_source=sink)
sup = DeviceStateSupervisor(runner=runner, copr_cache=cache, delta_sink=sink)
c.stores[1].coprocessor_host.register(sink)
c.stores[1].coprocessor_host.register(sup)
rid = [1]
ep = Endpoint(lambda req: cache.get(c.kvs[1].snapshot(
    SnapContext(region_id=rid[0])), req.dag), runner, device_row_threshold=1)
c.txn_write([("put",) + encode_table_row(table, h, {"c0": h % 3, "c1": h})
             for h in range(400)], start_ts=10, commit_ts=11)
def count(region_id):
    rid[0] = region_id
    s = DagSelect.from_table(table, ["id", "c0", "c1"])
    dag = s.aggregate([s.col("c0")], [("count_star", None)]).build(20)
    r = ep.handle(CopRequest(REQ_TYPE_DAG, dag, force_backend="device"))
    return sum(row[0] for row in r.rows())
assert count(1) == 400
from tikv_tpu_torch.storage.txn_types import encode_key
right = c.split_region(1, encode_key(encode_table_row(table, 150, {})[0]))
assert (count(1), count(right.id)) == (150, 250) and sup.splits == 1
c.transfer_leader(right.id, 2)
c.transfer_leader(right.id, 1)
assert sup.promotions >= 1 and sup.promotion_rebuilds == 0
c.check_consistency(1)
c.change_peer(1, "remove", c.stores[3].peers[1].meta)
c.change_peer(1, "add", Peer(c.pd.alloc_id(), 3))
c.tick_all(8)
merged = c.merge_region(right.id, 1)
assert count(merged.id) == 400
assert check_mvcc_consistency(c.kvs[1].snapshot(SnapContext(region_id=1))) \\
    == []
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
assert not bad, bad
print("cluster served", count(merged.id))
"""


def test_cluster_serving_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _SERVE_CLUSTER], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "cluster served 400"


# the networked server's modules (the gRPC bind, the raft transport, PD
# over gRPC, the client, TLS, the status server and the CLI)
NET_MODULES = [
    "tikv_tpu_torch/server/__init__.py", "tikv_tpu_torch/server/__main__.py",
    "tikv_tpu_torch/server/cli.py", "tikv_tpu_torch/server/client.py",
    "tikv_tpu_torch/server/pd_server.py",
    "tikv_tpu_torch/server/security.py", "tikv_tpu_torch/server/server.py",
    "tikv_tpu_torch/server/status_server.py",
    "tikv_tpu_torch/service_event.py", "tikv_tpu_torch/utils/backoff.py",
    "tikv_tpu_torch/utils/health.py",
    "tikv_tpu_torch/storage/lock_manager.py"]


def test_net_modules_are_scanned():
    assert set(NET_MODULES) <= set(SOURCES)


_SERVE_CLI = """
import signal, socket, subprocess, sys, time
from tikv_tpu_torch.server import TxnClient
from tikv_tpu_torch.testing import configs
from tikv_tpu_torch.testing.dag import DagSelect
from tikv_tpu_torch.testing.fixture import encode_table_row
def free():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"
pd_addr, kv_addr = free(), free()
import tempfile
log = tempfile.TemporaryFile("w+")
def start(*args, importtime=False):
    # the import report goes to a file: a full stderr pipe would stall it
    x = ["-X", "importtime"] if importtime else []
    return subprocess.Popen([sys.executable, *x, "-m",
                             "tikv_tpu_torch.server", *args],
                            stdout=subprocess.PIPE,
                            stderr=log if importtime else subprocess.DEVNULL,
                            text=True)
def wait(p, prefix):
    while True:
        line = p.stdout.readline()
        assert line, p.poll()
        if line.startswith(prefix):
            return
pd = start("pd", "--addr", pd_addr)
kv = None
try:
    wait(pd, "pd listening")
    kv = start("tikv", "--addr", kv_addr, "--pd", pd_addr, "--device",
               "cpu", importtime=True)
    wait(kv, "tikv store ")
    c = TxnClient(pd_addr)
    table = configs.bench_table()
    c.txn_write([("put",) + encode_table_row(table, h, {"k": h % 4, "v": h})
                 for h in range(300)])
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.aggregate([s.col("k")], [("count_star", None)]).build(c.tso())
    resp = c.coprocessor(dag, force_backend="device")
    assert resp["backend"] == "device", resp["backend"]
    assert sum(r[0] for r in resp["rows"]) == 300, resp["rows"]
    c.close()
    kv.send_signal(signal.SIGTERM)
    kv.communicate(timeout=60)
    log.seek(0)
    err = log.read()
    assert kv.returncode == 0, err[-2000:]
finally:
    for p in (kv, pd):
        if p is None:
            continue
        if p.poll() is None:
            p.kill()
        p.wait()
loaded = [line.rsplit("|", 1)[1].strip() for line in err.splitlines()
          if line.startswith("import time:") and "|" in line]
assert "tikv_tpu_torch.server.node" in loaded, loaded[-20:]
bad = [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
bad += [m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
assert not bad, bad
print("cli served", len(resp["rows"]))
"""


def test_cli_serving_loads_no_jax():
    """``python -m tikv_tpu_torch.server tikv --device cpu`` serving a
    write and a coprocessor read over gRPC imports no module of JAX or of
    the JAX package (its ``-X importtime`` report lists every import), nor
    does the client process."""
    out = subprocess.run([sys.executable, "-c", _SERVE_CLI], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "cli served 4"


# the store's read legs: the compiled fast path and resolved-ts
READ_LEG_MODULES = ["tikv_tpu_torch/server/fastpath.py",
                    "tikv_tpu_torch/cdc/__init__.py",
                    "tikv_tpu_torch/cdc/resolved_ts.py"]


def test_read_leg_modules_are_scanned():
    assert set(READ_LEG_MODULES) <= set(SOURCES)


_SERVE_READ_LEGS = """
import sys
import tikv_tpu_torch.cdc
import tikv_tpu_torch.server.fastpath
from tikv_tpu_torch.codec.keys import table_record_key
from tikv_tpu_torch.codec.row import encode_row
from tikv_tpu_torch.copr.wire import enc_dag
from tikv_tpu_torch.device import DeviceRunner
from tikv_tpu_torch.pd.client import MockPd
from tikv_tpu_torch.server import wire
from tikv_tpu_torch.server.node import Node
from tikv_tpu_torch.server.service import KvService
from tikv_tpu_torch.testing import configs
from tikv_tpu_torch.testing.dag import DagSelect
pd = MockPd()
node = Node("iso:0", pd, device_row_threshold=64,
            device_runner=DeviceRunner(device="cpu"))
node.start()
try:
    svc = KvService(node)
    table = configs.bench_table()
    muts = [{"op": "put", "key": table_record_key(table.table_id, h),
             "value": encode_row({2: h % 4, 3: h})} for h in range(300)]
    start = pd.tso()
    r = svc.handle("KvPrewrite", {"mutations": muts,
                                  "primary": muts[0]["key"],
                                  "start_version": start})
    assert not r.get("error"), r
    r = svc.handle("KvCommit", {"keys": [m["key"] for m in muts],
                                "start_version": start,
                                "commit_version": pd.tso()})
    assert not r.get("error"), r
    rows = []
    for thr in (10, 20):
        s = DagSelect.from_table(table, ["id", "k", "v"])
        dag = s.where(s.col("v") > thr).build(pd.tso())
        out = svc.handle_raw("Coprocessor", wire.pack({"dag": enc_dag(dag)}))
        rows.append(len(wire.unpack(out)["rows"]) if isinstance(out, bytes)
                    else len(out["rows"]))
    assert node.fastpath.stats()["hit"] == 1, node.fastpath.stats()
    import time
    t0 = time.monotonic()
    while node.status()["regions"][0]["resolved_ts"] == 0:
        assert time.monotonic() - t0 < 30, "no resolved-ts advance"
        time.sleep(0.01)
finally:
    node.stop()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tikv_tpu")]
assert not bad, bad
print("read legs served", rows)
"""


def test_read_legs_load_no_jax():
    """A fast-path hit, and the resolved-ts a node advances, import no
    module of JAX or of the JAX package."""
    out = subprocess.run([sys.executable, "-c", _SERVE_READ_LEGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "read legs served [289, 279]"
