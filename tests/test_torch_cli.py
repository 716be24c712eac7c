"""The port's command line (``python -m tikv_tpu_torch.server pd|tikv|
ctl``), its HTTP status server and its ``ConfigController`` against the
JAX package's.

Each package runs as processes, as an operator starts it: ``pd`` and one
``tikv`` (the port's with ``--device cpu``: without it the store serves
from the card) with ``--status-addr``; ``ctl`` then runs the same
commands against each (``put``, ``get``, ``scan``, ``region``, ``split``,
``stores``, ``store-status``, ``tso``, ``merge`` and
``rollback-merge``; ``add-peer`` runs in ``test_torch_grpc.py``'s
clusters of three), and the outputs must agree but for the listening
addresses and ``region``'s routing (fault 15).  The status servers answer
``/status``, ``/region/<id>``, ``/config`` and ``/fail_point`` alike; a
``POST /config`` of an online field is applied and read back, one that
names a field that is not online is refused with nothing applied.
``--data-dir`` is refused by the port's store; ``ctl gc`` is refused by
name; SIGTERM stops each ``tikv`` with exit code 0.
"""

from __future__ import annotations

import json
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = {"ref": "tikv_tpu.server", "port": "tikv_tpu_torch.server"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Proc:
    """One long-running ``python -m <pkg> ...`` with its output read on a
    thread."""

    def __init__(self, module: str, *args):
        self.p = subprocess.Popen([sys.executable, "-m", module, *args],
                                  cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        self.lines: list = []
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self):
        for line in self.p.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, prefix: str, timeout: float = 120.0) -> str:
        t0 = time.monotonic()
        while True:
            for line in list(self.lines):
                if line.startswith(prefix):
                    return line
            assert self.p.poll() is None, self.lines[-30:]
            assert time.monotonic() - t0 < timeout, self.lines[-30:]
            time.sleep(0.05)

    def kill(self):
        if self.p.poll() is None:
            self.p.kill()
        self.p.wait(timeout=30)
        self._t.join(timeout=5)


def _start(pkg: str) -> dict:
    pd_addr = f"127.0.0.1:{free_port()}"
    kv_addr = f"127.0.0.1:{free_port()}"
    st_addr = f"127.0.0.1:{free_port()}"
    pd = Proc(PKG[pkg], "pd", "--addr", pd_addr)
    pd.wait_for("pd listening")
    args = ["tikv", "--addr", kv_addr, "--pd", pd_addr,
            "--status-addr", st_addr]
    if pkg == "port":
        args += ["--device", "cpu"]
    kv = Proc(PKG[pkg], *args)
    line = kv.wait_for("tikv store ")
    return {"pkg": pkg, "pd": pd, "kv": kv, "pd_addr": pd_addr,
            "kv_addr": kv_addr, "st_addr": st_addr,
            "store_id": int(line.split()[2])}


@pytest.fixture(scope="module")
def pair():
    with ThreadPoolExecutor(2) as ex:
        sides = dict(zip(("ref", "port"), ex.map(_start, ("ref", "port"))))
    try:
        yield sides
    finally:
        for side in sides.values():
            for p in (side["kv"], side["pd"]):
                p.kill()


def ctl(side, *args) -> tuple:
    r = subprocess.run([sys.executable, "-m", PKG[side["pkg"]], "ctl",
                        "--pd", side["pd_addr"], *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    return r.returncode, r.stdout.strip()


def route(side, key: bytes) -> int:
    """The id of the region ``side``'s PD routes ``key`` to (0 in a
    split's routing gap)."""
    from tikv_tpu_torch.server.pd_server import RemotePdClient
    from tikv_tpu_torch.storage.txn_types import encode_key
    pd = RemotePdClient(side["pd_addr"])
    try:
        return pd.get_region(encode_key(key)).id
    except Exception:   # noqa: BLE001 — the gap
        return 0
    finally:
        pd.close()


def wait_routed(pair, key: bytes, not_to: int) -> None:
    """Wait until both PDs route ``key`` past region ``not_to``: a split's
    new region reaches PD at its leader's first heartbeat."""
    t0 = time.monotonic()
    while any(route(s, key) in (0, not_to) for s in pair.values()):
        assert time.monotonic() - t0 < 30, key
        time.sleep(0.05)


def both_ctl(pair, *args) -> tuple:
    """The same ``ctl`` command against both packages, at once."""
    with ThreadPoolExecutor(2) as ex:
        ref, port = ex.map(lambda s: ctl(s, *args),
                           (pair["ref"], pair["port"]))
    return ref, port


def http(side, path: str, body=None) -> tuple:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://{side['st_addr']}{path}",
                                 data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_ctl_put_get_scan(pair):
    assert both_ctl(pair, "put", "cli-a", "va") == ((0, "OK"),) * 2
    assert both_ctl(pair, "put", "cli-b", "vb") == ((0, "OK"),) * 2
    ref, port = both_ctl(pair, "get", "cli-a")
    assert port == ref == (0, "va")
    ref, port = both_ctl(pair, "get", "cli-missing")
    assert port == ref == (0, "(nil)")
    ref, port = both_ctl(pair, "scan", "cli-", "--limit", "4")
    assert port == ref == (0, "b'cli-a' b'va'\nb'cli-b' b'vb'")


def test_ctl_region_split_stores_status_tso(pair):
    ref, port = both_ctl(pair, "region", "--key", "cli-a")
    rr, pr = json.loads(ref[1]), json.loads(port[1])
    same = ("id", "epoch", "peers", "leader")
    assert [pr[k] for k in same] == [rr[k] for k in same]
    assert pr["id"] == 1 and pr["leader"] is not None and \
        (pr["start"], pr["end"]) == ("", "")
    ref, port = both_ctl(pair, "split", "cli-m")
    assert port == ref and ref[1].startswith("new region ")
    right = int(ref[1].split()[2])
    wait_routed(pair, b"cli-z", 1)
    ref, port = both_ctl(pair, "region", "--key", "cli-z")
    # the port routes the key encoded and prints the bounds decoded; the
    # reference routes the raw key against encoded bounds, and every key
    # below "x" lands in the first region (fault 15, pinned)
    assert json.loads(ref[1])["id"] == 1
    pr = json.loads(port[1])
    assert (pr["id"], pr["start"], pr["end"]) == (right, "cli-m", "")
    for side in pair.values():
        assert ctl(side, "stores") == \
            (0, f"{side['store_id']} {side['kv_addr']}")
    ref, port = both_ctl(pair, "store-status", str(pair["ref"]["store_id"]))
    assert ref[0] == port[0] == 0
    rst, pst = json.loads(ref[1]), json.loads(port[1])
    assert pst["store_id"] == rst["store_id"]

    def regions(st):
        return sorted((r["region"]["id"], r["region"]["start"],
                       r["region"]["end"], r["leader"])
                      for r in st["regions"])
    assert regions(pst) == regions(rst)
    ts = [int(ctl(s, "tso")[1]) for s in pair.values() for _ in range(2)]
    assert ts[1] > ts[0] and ts[3] > ts[2]


def test_ctl_merge_rollback_and_refusals(pair):
    ref, port = both_ctl(pair, "split", "cli-t")
    assert port == ref
    right = int(ref[1].split()[2])
    target = route(pair["ref"], b"cli-n")
    assert route(pair["port"], b"cli-n") == target
    wait_routed(pair, b"cli-u", target)
    ref, port = both_ctl(pair, "merge", str(right), str(target))
    assert port == ref == (0, f"merged region {right} into {target}")
    ref, port = both_ctl(pair, "get", "cli-a")
    assert port == ref == (0, "va")
    # no merge in flight: the rollback is a no-op both packages accept
    ref, port = both_ctl(pair, "rollback-merge", str(target))
    assert port == ref
    # the port refuses the subcommands whose modules it lacks, by name
    r = subprocess.run([sys.executable, "-m", PKG["port"], "ctl", "--pd",
                        pair["port"]["pd_addr"], "gc", "--safe-point", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert r.returncode == 2 and "waits for GC" in r.stderr


def test_status_server_routes(pair):
    got = {}
    for pkg, side in pair.items():
        code, st = http(side, "/status")
        assert code == 200 and st["store_id"] == side["store_id"]
        rid = st["regions"][0]["region"]["id"]
        code, r = http(side, f"/region/{rid}")
        assert code == 200 and r["region"]["id"] == rid
        code, missing = http(side, "/region/987654")
        got[pkg] = (code, sorted(r), missing)
        assert http(side, "/fail_point") == (200, {})
        assert http(side, "/fail_point/cli::probe",
                    {"actions": "return"}) == (200, {"ok": True})
        assert http(side, "/fail_point") == (200, {"cli::probe":
                                                    ["return"]})
        assert http(side, "/fail_point/cli::probe", {}) == \
            (200, {"ok": True})
        assert http(side, "/fail_point") == (200, {})
    assert got["port"][0] == got["ref"][0] == 404
    assert got["port"][2] == got["ref"][2]
    # the port's region entry has the reference's fields, resolved_ts
    # among them
    assert got["port"][1] == got["ref"][1]
    code, health = http(pair["port"], "/health")
    assert code == 200 and {"read_pool", "peer_breakers", "copr_cache",
                            "device_state"} <= set(health)


def test_status_server_config_and_controller(pair):
    for side in pair.values():
        code, cfg = http(side, "/config")
        assert code == 200
        cap = cfg["coprocessor"]["region_cache_capacity"]
        code, r = http(side, "/config",
                       {"coprocessor.region-cache-capacity": cap + 3})
        assert (code, r) == (200, {"applied": {
            "coprocessor.region_cache_capacity": cap + 3}})
        # one field that is not online: refused, and nothing applied
        code, r = http(side, "/config", {
            "coprocessor.region-cache-capacity": cap + 7,
            "storage.data-dir": "/x"})
        assert code == 400 and "not an online-config field" in r["error"]
        assert http(side, "/config")[1]["coprocessor"][
            "region_cache_capacity"] == cap + 3
        code, r = http(side, "/config", {"readpool.concurrency": "four"})
        assert code == 400 and "want int" in r["error"]


@pytest.mark.parametrize("changes", [
    {"raftstore.region-split-size-mb": 64},
    {"coprocessor.device-row-threshold": 4096,
     "coprocessor.coalesce-window-ms": 0.0},
    {"readpool.concurrency": 4},
    {"raftstore.region-split-size-mb": 999},        # over the max size
    {"storage.data-dir": "/x"},
    {"coprocessor.region-cache-capacity": 2, "server.addr": "x"},
    {"nosuch.field": 1},
    {"coprocessor": 1},
])
def test_config_controller_against_reference(changes):
    """The same changes through both packages' controllers: applied, or
    refused with ValueError leaving the tree and the managers
    untouched."""
    from tikv_tpu.config import ConfigController as RefController
    from tikv_tpu.config import TikvConfig as RefConfig

    from tikv_tpu_torch.config import ConfigController, TikvConfig
    out = []
    for ctrl_cls, cfg_cls in ((RefController, RefConfig),
                              (ConfigController, TikvConfig)):
        cfg = cfg_cls()
        before = cfg.to_dict()
        ctrl = ctrl_cls(cfg)
        seen: list = []
        for section in ("raftstore", "coprocessor", "readpool"):
            ctrl.register(section, lambda d, s=section: seen.append((s, d)))
        try:
            applied = ctrl.update(dict(changes))
            out.append(("applied", applied, seen))
        except ValueError:
            assert cfg.to_dict() == before and not seen
            out.append(("refused", None, seen))
    assert out[1] == out[0]


def test_tikv_data_dir_refused(tmp_path):
    """The port's store runs on the in-memory engine: ``--data-dir`` stops
    the process before it serves."""
    r = subprocess.run([sys.executable, "-m", PKG["port"], "tikv",
                        "--addr", f"127.0.0.1:{free_port()}",
                        "--pd", f"127.0.0.1:{free_port()}",
                        "--device", "cpu", "--data-dir", str(tmp_path)],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "in-memory engine only" in r.stderr


def test_sigterm_exits_zero(pair):
    """SIGTERM through the service-event channel: the server stops its
    pools and the process exits 0 (both packages)."""
    rcs = {}
    for pkg, side in pair.items():
        side["kv"].p.send_signal(signal.SIGTERM)
    for pkg, side in pair.items():
        rcs[pkg] = side["kv"].p.wait(timeout=60)
        assert any(line.startswith("received signal")
                   for line in side["kv"].lines), side["kv"].lines[-10:]
    assert rcs == {"ref": 0, "port": 0}
