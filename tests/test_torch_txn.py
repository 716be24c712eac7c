"""The port's transaction layer (``tikv_tpu_torch/storage``: Percolator
actions, commands, the latch scheduler and the ``Storage`` facade)
against the JAX package's.

``tests/test_mvcc_txn.py``'s cases run against both packages (its source
compiled a second time with the package name swapped).  A seeded stream
of 300 commands — prewrite (optimistic and pessimistic), commit,
rollback, cleanup, check_txn_status, resolve_lock, pessimistic lock and
rollback, heartbeat, get, batch_get, scan and the raw API — then goes
through one ``Storage`` of each package: every result and every error
(its kind and its wire dict) must be identical, and the engines equal in
every data CF, byte for byte.
"""

import inspect
import pathlib
import random
import types

import pytest

from tikv_tpu.server import wire as ref_wire
from tikv_tpu.storage import Storage as RefStorage
from tikv_tpu.storage.txn import commands as ref_cmds
from tikv_tpu.storage.txn.actions import Mutation as RefMutation
from tikv_tpu.storage.txn_types import compose_ts

from tikv_tpu_torch.server import wire as port_wire
from tikv_tpu_torch.storage import Storage as PortStorage
from tikv_tpu_torch.storage.txn import commands as port_cmds
from tikv_tpu_torch.storage.txn.actions import Mutation as PortMutation

PKGS = ("tikv_tpu", "tikv_tpu_torch")
_SRC = pathlib.Path(__file__).with_name("test_mvcc_txn.py").read_text()


def _load(pkg: str) -> types.ModuleType:
    src = _SRC.replace("from tikv_tpu.", f"from {pkg}.")
    mod = types.ModuleType(f"mvcc_txn_cases_{pkg}")
    exec(compile(src, f"test_mvcc_txn.py[{pkg}]", "exec"), mod.__dict__)
    return mod


CASES = {pkg: _load(pkg) for pkg in PKGS}
NAMES = sorted(n for n in vars(CASES["tikv_tpu"]) if n.startswith("test_"))


def test_port_case_module_uses_the_port():
    assert CASES["tikv_tpu_torch"].Storage is PortStorage


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name", NAMES)
def test_mvcc_txn_case(pkg, name):
    mod = CASES[pkg]
    fn = getattr(mod, name)
    kw = {}
    for p in inspect.signature(fn).parameters:
        assert p == "store", (name, p)
        kw[p] = mod.Storage()       # the module's ``store`` fixture
    fn(**kw)


# ------------------------------------------------------------- stream

KEYS = [b"k%02d" % i for i in range(12)]


def _stream(seed: int, n: int) -> list:
    """The command stream as plain tuples, so each package builds its own
    command objects from the same description."""
    rng = random.Random(seed)
    phys = [100]

    def ts():
        phys[0] += rng.choice((1, 1, 2, 5))
        return compose_ts(phys[0], rng.randint(0, 3))

    active: list = []           # (start_ts, primary, keys, pessimistic)
    committed_ts: list = []
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.16 or not active:
            keys = rng.sample(KEYS, rng.randint(1, 3))
            muts = [(rng.choice(("put", "put", "put", "delete", "insert",
                                 "lock")), k,
                     rng.randbytes(rng.choice((4, 300))))
                    for k in keys]
            start = ts()
            pess = rng.random() < 0.25
            if pess:
                out.append(("pess_lock", keys, keys[0], start, start,
                            rng.choice((1, 3000))))
            out.append(("prewrite", muts, keys[0], start,
                        rng.choice((1, 3000)), pess,
                        rng.random() < 0.15))
            active.append((start, keys[0], keys, pess))
        elif r < 0.32:
            t = active.pop(rng.randrange(len(active)))
            c = ts()
            committed_ts.append(c)
            out.append(("commit", t[2], t[0], c))
        elif r < 0.38:
            t = active.pop(rng.randrange(len(active)))
            out.append(("rollback", t[2], t[0]))
        elif r < 0.43:
            t = rng.choice(active)
            out.append(("cleanup", rng.choice(t[2]), t[0], ts()))
        elif r < 0.50:
            t = rng.choice(active)
            out.append(("check_txn_status", t[1], t[0], ts(), ts()))
        elif r < 0.55:
            t = active.pop(rng.randrange(len(active)))
            commit = ts() if rng.random() < 0.5 else 0
            if rng.random() < 0.5:
                out.append(("resolve_lite", t[0], commit, t[2]))
            else:
                out.append(("resolve", t[0], commit))
        elif r < 0.58:
            t = rng.choice(active)
            out.append(("heartbeat", t[1], t[0], rng.randint(10, 5000)))
        elif r < 0.61:
            t = rng.choice(active)
            if t[3]:
                out.append(("pess_rollback", t[2], t[0], t[0]))
            else:
                out.append(("get", rng.choice(KEYS), ts()))
        elif r < 0.72:
            out.append(("get", rng.choice(KEYS), ts()))
        elif r < 0.77:
            out.append(("batch_get", rng.sample(KEYS, 4), ts()))
        elif r < 0.83:
            a, b = sorted(rng.sample(KEYS, 2))
            out.append(("scan", a, b, rng.randint(1, 8), ts(),
                        rng.random() < 0.3))
        elif r < 0.88:
            out.append(("raw_put", rng.choice(KEYS), rng.randbytes(6)))
        elif r < 0.91:
            out.append(("raw_get", rng.choice(KEYS)))
        elif r < 0.93:
            out.append(("raw_delete", rng.choice(KEYS)))
        elif r < 0.95:
            a, b = sorted(rng.sample(KEYS, 2))
            out.append(("raw_scan", a, b, rng.randint(1, 6),
                        rng.random() < 0.5))
        elif r < 0.97:
            out.append(("raw_batch_get", rng.sample(KEYS, 3)))
        else:
            out.append(("raw_cas", rng.choice(KEYS),
                        rng.choice((None, b"x")), rng.randbytes(3)))
    return out


def _run(storage, cmds, Mutation, op):
    kind = op[0]
    if kind == "prewrite":
        _k, muts, primary, start, ttl, pess, async_commit = op
        return storage.sched_txn_command(cmds.Prewrite(
            [Mutation(o, k, v if o in ("put", "insert") else None)
             for o, k, v in muts], primary, start, lock_ttl=ttl,
            is_pessimistic_lock=[pess] * len(muts),
            use_async_commit=async_commit,
            secondaries=[k for _o, k, _v in muts[1:]]
            if async_commit else ()))
    if kind == "pess_lock":
        _k, keys, primary, start, for_update, ttl = op
        return storage.sched_txn_command(cmds.AcquirePessimisticLock(
            keys, primary, start, for_update, ttl, True))
    if kind == "commit":
        return storage.sched_txn_command(cmds.Commit(op[1], op[2], op[3]))
    if kind == "rollback":
        return storage.sched_txn_command(cmds.Rollback(op[1], op[2]))
    if kind == "cleanup":
        return storage.sched_txn_command(cmds.Cleanup(op[1], op[2], op[3]))
    if kind == "check_txn_status":
        return storage.sched_txn_command(cmds.CheckTxnStatus(
            op[1], op[2], op[3], op[4]))
    if kind == "resolve_lite":
        return storage.sched_txn_command(cmds.ResolveLockLite(
            op[1], op[2], op[3]))
    if kind == "resolve":
        return storage.sched_txn_command(cmds.ResolveLock(op[1], op[2]))
    if kind == "heartbeat":
        return storage.sched_txn_command(cmds.TxnHeartBeat(
            op[1], op[2], op[3]))
    if kind == "pess_rollback":
        return storage.sched_txn_command(cmds.PessimisticRollback(
            op[1], op[2], op[3]))
    if kind == "get":
        return storage.get(op[1], op[2])
    if kind == "batch_get":
        return storage.batch_get(op[1], op[2])
    if kind == "scan":
        return storage.scan(op[1], op[2], op[3], op[4], op[5])
    if kind == "raw_put":
        return storage.raw_put(op[1], op[2])
    if kind == "raw_get":
        return storage.raw_get(op[1])
    if kind == "raw_delete":
        return storage.raw_delete(op[1])
    if kind == "raw_scan":
        return storage.raw_scan(op[1], op[2], op[3], op[4])
    if kind == "raw_batch_get":
        return storage.raw_batch_get(op[1])
    if kind == "raw_cas":
        return storage.raw_compare_and_swap(op[1], op[2], op[3])
    raise AssertionError(kind)


def _outcome(storage, cmds, Mutation, wire, op):
    try:
        return ("ok", repr(_run(storage, cmds, Mutation, op)))
    except Exception as e:      # noqa: BLE001 — compared across packages
        return ("err", type(e).__name__, wire.enc_error(e))


def _cfs(storage) -> dict:
    kv = storage.engine.kv_engine()
    out = {}
    for cf in ("default", "lock", "write"):
        it = kv.iterator_cf(cf, None, None)
        ok = it.seek_to_first()
        rows = []
        while ok:
            rows.append((it.key(), it.value()))
            ok = it.next()
        out[cf] = rows
    return out


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_seeded_command_stream_identical(seed):
    ops = _stream(seed, 300)
    ref, port = RefStorage(), PortStorage()
    kinds = {}
    for i, op in enumerate(ops):
        a = _outcome(ref, ref_cmds, RefMutation, ref_wire, op)
        b = _outcome(port, port_cmds, PortMutation, port_wire, op)
        assert b == a, (i, op)
        kinds[a[1] if a[0] == "err" else op[0]] = True
    ref_cfs, port_cfs = _cfs(ref), _cfs(port)
    assert port_cfs == ref_cfs
    # the stream reached the error paths and left data in every CF
    assert {"KeyIsLocked", "WriteConflict"} & set(kinds)
    assert all(ref_cfs[cf] for cf in ("default", "write"))
