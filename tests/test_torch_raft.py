"""The port's raft (``tikv_tpu_torch/raft``) against the JAX package's.

``tests/test_raft.py``'s cases run against both packages: its source is
compiled a second time with the package name swapped, and every case runs
once per package.  A seeded replay then drives the same proposals, ticks,
partitions and leader transfers through a ``RaftNetwork`` of each package
and requires identical applied logs, hard states and raft logs on every
node.
"""

import inspect
import pathlib
import random
import types

import pytest

PKGS = ("tikv_tpu", "tikv_tpu_torch")
_SRC = pathlib.Path(__file__).with_name("test_raft.py").read_text()


def _load(pkg: str) -> types.ModuleType:
    src = _SRC.replace("from tikv_tpu.", f"from {pkg}.").replace(
        "import tikv_tpu.", f"import {pkg}.")
    mod = types.ModuleType(f"raft_cases_{pkg}")
    exec(compile(src, f"test_raft.py[{pkg}]", "exec"), mod.__dict__)
    return mod


CASES = {pkg: _load(pkg) for pkg in PKGS}
NAMES = sorted(n for n in vars(CASES["tikv_tpu"]) if n.startswith("test_"))


def test_port_case_module_imports_no_reference():
    mod = CASES["tikv_tpu_torch"]
    assert mod.RawNode.__module__ == "tikv_tpu_torch.raft.raw_node"
    assert mod.RaftNetwork.__module__ == "tikv_tpu_torch.raft.network"


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name", NAMES)
def test_raft_case(pkg, name, monkeypatch):
    fn = getattr(CASES[pkg], name)
    kw = {}
    for p in inspect.signature(fn).parameters:
        assert p == "monkeypatch", (name, p)
        kw[p] = monkeypatch
    fn(**kw)


# ------------------------------------------------------------- replay


def _replay(pkg: str, seed: int, steps: int):
    net_mod = __import__(f"{pkg}.raft.network", fromlist=["RaftNetwork"])
    net = net_mod.RaftNetwork([1, 2, 3, 4, 5], pre_vote=True, seed=seed)
    rng = random.Random(seed)
    trace = []
    filt = None
    for step in range(steps):
        op = rng.random()
        if op < 0.45:
            net.tick_all(rng.randint(1, 4))
        elif op < 0.75:
            lead = net.leader()
            if lead is not None:
                try:
                    net.nodes[lead].propose(f"{seed}:{step}".encode())
                except Exception as e:      # noqa: BLE001 — compared
                    trace.append(("propose_err", type(e).__name__))
                net.deliver_all()
        elif op < 0.85:
            if filt is None:
                a = rng.sample([1, 2, 3, 4, 5], rng.randint(1, 2))
                b = [n for n in (1, 2, 3, 4, 5) if n not in a]
                filt = net.partition(a, b)
            else:
                net.heal(filt)
                filt = None
        elif op < 0.92:
            lead = net.leader()
            if lead is not None:
                to = rng.choice([n for n in net.nodes if n != lead])
                net.nodes[lead].transfer_leader(to)
                net.deliver_all()
        else:
            net.isolate(rng.randint(1, 5))
            net.tick_all(3)
            net.heal()
            filt = None
        trace.append((net.leader(), tuple(
            (n.term, n.vote, n.commit, n.state, n.last_index())
            for n in net.nodes.values())))
    net.heal()
    net.tick_all(60)
    out = {}
    for nid, node in net.nodes.items():
        st = node.storage
        log = [(e.term, e.index, e.data)
               for e in st.entries]
        out[nid] = (net.applied[nid], (node.term, node.vote, node.commit),
                    log)
    return trace, out, net.leader()


@pytest.mark.parametrize("seed", [1, 7, 23, 101])
def test_seeded_replay_identical(seed):
    ref_trace, ref_out, ref_lead = _replay("tikv_tpu", seed, 160)
    port_trace, port_out, port_lead = _replay("tikv_tpu_torch", seed, 160)
    assert port_trace == ref_trace
    assert port_out == ref_out
    assert port_lead == ref_lead is not None
    # the replay did commit work on every node
    assert all(len(v[0]) > 10 for v in port_out.values())
