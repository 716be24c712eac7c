"""The port's raftstore on one store (``RaftStore`` + ``RaftKv`` over one
region, ``tikv_tpu_torch/raftstore``) against the JAX package's.

Both stores are driven with the same commands: writes through RaftKv and
a transactional ``Storage`` on top, an SST v2 ``ingest`` op, lease reads
and read barriers, ticks, and a restart through ``load_peers``.  The
data CFs of the two engines must be equal byte for byte, and the raft
state (applied index, term, data version) the same.  The multi-store
cases are in ``test_torch_cluster.py``.
"""

import numpy as np
import pytest

from tikv_tpu.engine.memory import MemoryEngine as RefEngine
from tikv_tpu.kv.engine import SnapContext as RefSnapContext
from tikv_tpu.kv.engine import WriteData as RefWriteData
from tikv_tpu.raftstore import RaftKv as RefRaftKv
from tikv_tpu.raftstore import RaftStore as RefRaftStore
from tikv_tpu.raftstore import Transport as RefTransport
from tikv_tpu.raftstore.cmd import RaftCmd as RefRaftCmd
from tikv_tpu.raftstore.cmd import WriteOp as RefWriteOp
from tikv_tpu.raftstore.metapb import Peer as RefPeer
from tikv_tpu.raftstore.metapb import Region as RefRegion
from tikv_tpu.raftstore.metapb import RegionEpoch as RefEpoch
from tikv_tpu.sst_importer import fast_mvcc_table_sst as ref_sst
from tikv_tpu.storage import Storage as RefStorage
from tikv_tpu.storage.txn import commands as ref_cmds
from tikv_tpu.storage.txn.actions import Mutation as RefMutation

from tikv_tpu_torch.engine.memory import MemoryEngine
from tikv_tpu_torch.kv.engine import SnapContext, WriteData
from tikv_tpu_torch.raftstore import (
    Peer,
    RaftCmd,
    RaftKv,
    RaftStore,
    Region,
    RegionEpoch,
    Transport,
    WriteOp,
)
from tikv_tpu_torch.sst_importer import fast_mvcc_table_sst
from tikv_tpu_torch.storage import Storage
from tikv_tpu_torch.storage.txn import commands as port_cmds
from tikv_tpu_torch.storage.txn.actions import Mutation
from tikv_tpu_torch.utils import failpoint

PORT = dict(Engine=MemoryEngine, Store=RaftStore, Kv=RaftKv,
            Transport=Transport, Region=Region, Peer=Peer,
            Epoch=RegionEpoch, Cmd=RaftCmd, Op=WriteOp, Ctx=SnapContext,
            Data=WriteData, Storage=Storage, cmds=port_cmds,
            Mutation=Mutation, sst=fast_mvcc_table_sst)
REF = dict(Engine=RefEngine, Store=RefRaftStore, Kv=RefRaftKv,
           Transport=RefTransport, Region=RefRegion, Peer=RefPeer,
           Epoch=RefEpoch, Cmd=RefRaftCmd, Op=RefWriteOp,
           Ctx=RefSnapContext, Data=RefWriteData, Storage=RefStorage,
           cmds=ref_cmds, Mutation=RefMutation, sst=ref_sst)


class Rig:
    """One store, one region, one peer, driven synchronously."""

    def __init__(self, m, engine=None, bootstrap=True):
        self.m = m
        self.engine = engine if engine is not None else m["Engine"]()
        self.store = m["Store"](1, self.engine, m["Transport"]())
        if bootstrap:
            region = m["Region"](1, b"", b"", m["Epoch"](1, 1),
                                 (m["Peer"](2, 1),))
            self.store.bootstrap_region(region)
        else:
            self.store.load_peers()
        self.peer = self.store.region_peer(1)
        self.peer.node.campaign(force=True)
        self.kv = m["Kv"](self.store)
        self.kv._local_drive(lambda: self.peer.is_leader() and
                             self.peer.applied_engine ==
                             self.peer.node.last_index())
        self.storage = m["Storage"](engine=self.kv)

    def write(self, mods):
        self.kv.write(self.m["Ctx"](), self.m["Data"](mods))

    def propose(self, ops):
        box = {}
        cmd = self.m["Cmd"](1, self.peer.region.epoch, tuple(ops))
        self.peer.propose(cmd, lambda r: box.__setitem__("result", r))
        self.kv._wait(box)
        return box["result"]

    def txn(self, start, commit, muts):
        M, c = self.m["Mutation"], self.m["cmds"]
        self.storage.sched_txn_command(c.Prewrite(
            [M(o, k, v) for o, k, v in muts], muts[0][1], start))
        self.storage.sched_txn_command(c.Commit(
            [k for _o, k, _v in muts], start, commit))

    def state(self):
        p = self.peer
        return (p.node.term, p.node.commit, p.applied_engine,
                p.data_index_engine, p.node.last_index())


def _cfs(engine, cfs=("default", "lock", "write")) -> dict:
    out = {}
    for cf in cfs:
        it = engine.iterator_cf(cf, None, None)
        ok = it.seek_to_first()
        rows = []
        while ok:
            rows.append((it.key(), it.value()))
            ok = it.next()
        out[cf] = rows
    return out


def _both(fn):
    return fn(Rig(REF)), fn(Rig(PORT))


def test_writes_snapshots_and_equal_cfs():
    def drive(rig):
        rig.write([("put", "default", b"a", b"1"),
                   ("put", "write", b"b", b"2")])
        rig.write([("del", "default", b"a", None)])
        snap = rig.kv.snapshot(rig.m["Ctx"]())
        got = (snap.get_value_cf("default", b"a"),
               snap.get_value_cf("write", b"b"), snap.data_index)
        return got, rig.state(), _cfs(rig.engine, ("default", "lock",
                                                   "write", "raft"))
    ref, port = _both(drive)
    assert port == ref
    assert port[0] == (None, b"2", port[1][3])


def test_command_stream_through_storage_equal_cfs():
    import random

    def drive(rig):
        rng = random.Random(5)
        ts = 10
        results = []
        for i in range(60):
            keys = rng.sample([b"key%d" % j for j in range(20)], 2)
            muts = [(rng.choice(("put", "put", "delete")), k,
                     rng.randbytes(rng.choice((8, 400)))) for k in keys]
            muts = [(o, k, v if o == "put" else None) for o, k, v in muts]
            rig.txn(ts, ts + 1, muts)
            ts += 2
            if i % 7 == 0:
                rig.storage.raw_put(b"raw%d" % i, b"v%d" % i)
            results.append(rig.storage.scan(None, None, 100, ts))
        return results, rig.state(), _cfs(rig.engine)
    ref, port = _both(drive)
    assert port == ref


def test_lease_read_takes_no_raft_round_trip():
    rig = Rig(PORT)
    rig.write([("put", "default", b"k", b"v")])
    before = rig.state()
    for _ in range(5):
        snap = rig.kv.snapshot(SnapContext())
        assert snap.get_value(b"k") == b"v"
    assert rig.kv.lease_reads == 5 and rig.kv.barrier_reads == 0
    assert rig.state() == before        # nothing proposed, nothing applied


def test_read_barrier_and_ticks_leave_the_data_version():
    def drive(rig):
        rig.write([("put", "default", b"k", b"v1")])
        v0 = rig.kv.snapshot(rig.m["Ctx"]()).data_index
        failpoint_mod = __import__(
            rig.m["Store"].__module__.split(".")[0] + ".utils.failpoint",
            fromlist=["cfg"])
        failpoint_mod.cfg("read::before_local_read", "return")
        try:
            barrier = [rig.kv.snapshot(rig.m["Ctx"]()) for _ in range(3)]
        finally:
            failpoint_mod.teardown()
        for _ in range(40):
            rig.store.tick()
            rig.store.drive()
        after = rig.kv.snapshot(rig.m["Ctx"]())
        rig.write([("put", "default", b"k", b"v2")])
        moved = rig.kv.snapshot(rig.m["Ctx"]())
        return (v0, [s.data_index for s in barrier],
                [s.apply_index for s in barrier], after.data_index,
                moved.data_index, rig.kv.barrier_reads)
    ref, port = _both(drive)
    assert port == ref
    v0, barrier, barrier_apply, after, moved, n_barrier = port
    assert barrier == [v0] * 3 and after == v0
    assert n_barrier == 3 and barrier_apply[-1] > v0
    assert moved > v0


def test_sst_v2_ingest_op():
    h = np.arange(0, 4000, 3, dtype=np.int64)
    cols = [(2, h % 1024, None), (3, h % 1000, None)]

    def drive(rig):
        blob = rig.m["sst"](9, h, cols, commit_ts=50)
        res = rig.propose([rig.m["Op"]("ingest", "", b"", blob)])
        snap = rig.kv.snapshot(rig.m["Ctx"]())
        return res, rig.state(), snap.data_index, _cfs(rig.engine), blob
    ref, port = _both(drive)
    assert port[4] == ref[4]                    # the same blob
    assert port[:4] == ref[:4]
    assert len(port[3]["write"]) == len(h)
    assert port[2] == port[1][3]                # the ingest moved it


def test_restart_through_load_peers():
    def drive(rig):
        for i in range(12):
            rig.write([("put", "default", b"k%03d" % i, b"v%d" % i)])
        engine = rig.engine
        again = Rig(rig.m, engine=engine, bootstrap=False)
        snap = again.kv.snapshot(rig.m["Ctx"]())
        vals = [snap.get_value(b"k%03d" % i) for i in range(12)]
        again.write([("put", "default", b"after", b"x")])
        return vals, again.state(), _cfs(engine)
    ref, port = _both(drive)
    assert port == ref
    assert port[0] == [b"v%d" % i for i in range(12)]


def test_failpoints_are_torn_down():
    assert failpoint.fail_point("read::before_local_read") is None


@pytest.mark.parametrize("sizes", [(70, 300), (1, 40)],
                         ids=["merged", "per-op"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_batched_writes_match_reference(seed, sizes):
    """Write batches of point ops (a CF's ops merged in one pass from
    ``MemoryEngine.MERGE_MIN_OPS`` on, applied op by op below it), with
    range deletes and ingests between them and a snapshot pinning the old
    generation: the same CFs as the reference engine's op-by-op apply,
    and the snapshot unchanged."""
    import random
    rng = random.Random(seed)
    port, ref = MemoryEngine(), RefEngine()
    for eng in (port, ref):
        wb = eng.write_batch()
        wb.ingest_cf("write", [b"k%05d" % i for i in range(0, 4000, 2)],
                     [b"v%d" % i for i in range(2000)])
        eng.write(wb)
    before = _cfs(port)
    snap = port.snapshot()
    for _ in range(4):
        ops = []
        for _ in range(rng.randint(*sizes)):
            r, k = rng.random(), b"k%05d" % rng.randrange(4200)
            cf = rng.choice(("write", "write", "lock", "default"))
            if r < 0.55:
                ops.append(("put", cf, k, rng.randbytes(3)))
            elif r < 0.9:
                ops.append(("del", cf, k))
            elif r < 0.95:
                hi = b"k%05d" % (int(k[1:]) + rng.randrange(1, 40))
                ops.append(("delr", cf, k, hi))
            else:
                base = rng.randrange(4300, 9000)
                ops.append(("ingest", cf, [b"k%05d" % (base + j)
                                           for j in range(5)],
                            [b"i"] * 5))
        for eng in (port, ref):
            wb = eng.write_batch()
            for op in ops:
                if op[0] == "put":
                    wb.put_cf(op[1], op[2], op[3])
                elif op[0] == "del":
                    wb.delete_cf(op[1], op[2])
                elif op[0] == "delr":
                    wb.delete_range_cf(op[1], op[2], op[3])
                else:
                    wb.ingest_cf(op[1], op[2], op[3])
            eng.write(wb)
        assert _cfs(port) == _cfs(ref)
    assert (len(ops) >= MemoryEngine.MERGE_MIN_OPS) == \
        (sizes[0] >= MemoryEngine.MERGE_MIN_OPS)
    for cf, rows in before.items():
        it = snap.iterator_cf(cf, None, None)
        ok, got = it.seek_to_first(), []
        while ok:
            got.append((it.key(), it.value()))
            ok = it.next()
        assert got == rows


@pytest.mark.parametrize("runs", [
    [[b"b", b"c"]],                     # between two keys: spliced
    [[b"0", b"1"], [b"x", b"y"]],       # before the first, after the last
    [[b"b", b"m"]],                     # across a key: merged
    [[b"a"]], [[b"e", b"f"]],           # on a key: the ingest wins
    [[b"b"], [b"c", b"d"], [b"bb"]],    # into gaps the last ingest left
])
def test_engine_ingest_into_gaps_matches_reference(runs):
    port, ref = MemoryEngine(), RefEngine()
    for eng in (port, ref):
        wb = eng.write_batch()
        for k in (b"a", b"e", b"k"):
            wb.put_cf("write", k, b"old")
        eng.write(wb)
        for run in runs:
            wb = eng.write_batch()
            wb.ingest_cf("write", list(run), [b"new-" + k for k in run])
            eng.write(wb)
    assert _cfs(port) == _cfs(ref)
