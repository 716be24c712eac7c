"""The port stands alone: no module of ``tikv_tpu_torch`` (every source
under it, the selection, top-k and ANALYZE modules included, and
``chip_smoke.py``) imports JAX or the JAX package, serving an
aggregation, a selection, an index-scan top-k, a join plan, an ANALYZE
and a CHECKSUM request through the endpoint loads neither, nor does
serving selections and aggregations through ``Endpoint.handle_async``
with a bound ``RequestCoalescer``, and nothing falls back to the CPU
without being asked."""

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


def test_runner_refuses_to_start_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceRunner()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert DeviceRunner(device="cpu").device == torch.device("cpu")


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
