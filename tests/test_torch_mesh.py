"""The sharded mesh path of the port against the JAX package's mesh.

The mesh helpers of ``tikv_tpu_torch.parallel`` are held case for case
against the reference's ``tikv_tpu.parallel.mesh``.  The port's mesh runner
(``DeviceRunner(mesh=convert.mesh_from_shape(shape, ["cpu"] * 8),
chunk_rows=8 * 64)``: a row-sharded feed, each shard running the plain
version of its kernels, the cross-shard merges ``shard.shard_psum`` /
``shard_merge`` in their plain versions) is held, for mesh shapes (1, 1),
(1, 2), (2, 2), (2, 4), (4, 2) and (1, 7), against one reference runner
over the conftest's eight virtual CPU devices
(``DeviceRunner(mesh=make_mesh(jax.devices()), chunk_rows=8 * 64)``) and
the reference's host pipeline,
on the shapes of ``tests/test_mesh_parity.py`` and the edge cases of a
sharded feed: trailing shards with no live row, a feed that is not a whole
number of units, a slot count that is not a multiple of the shard count
(the reference's bucket pad), every row filtered out (FIRST included,
with every merge's output poisoned beforehand: fault 9), a key held by one
shard only.
Integer and MIN/MAX answers are equal exactly (groups in ascending key
order on both runners); REAL sums lie within 1e-9 of the numpy truth's
error scale (the shards sum in another order) and within 1e-6 of the
reference's (which sums REAL tiles in float32).  FIRST is held against
the host pipeline only (ROADMAP.md queue 3, fault 8).
"""

import threading

import numpy as np
import pytest
import torch

import jax

from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.executors.runner import BatchExecutorsRunner
from tikv_tpu.parallel import mesh as ref_mesh
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch import convert
from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.device import agg_fold as af
from tikv_tpu_torch.device import hash_agg as ha
from tikv_tpu_torch.device import shard as sh
from tikv_tpu_torch.device import twolevel as tl
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.parallel import mesh as pm
from tikv_tpu_torch.testing import configs
from tikv_tpu_torch.utils import failpoint, tracker

from tests.test_torch_selection import port_dag, port_snapshot

SHAPES = [(1, 1), (1, 2), (2, 2), (2, 4), (4, 2), (1, 7)]
CHUNK = 8 * 64


# ------------------------------------------------------------- the helpers


def test_factor2_matches_the_reference():
    for n in range(1, 65):
        assert pm._factor2(n) == ref_mesh._factor2(n), n


@pytest.mark.parametrize("shape", [None, "", "2x4", "2X4", " 4,2 ", "8*1",
                                   (8, 1), [2, 2], "2x", "x4", "2x4x1",
                                   "axb", "0x8", [8], "8", (0, 3), "1.5x2"])
def test_parse_mesh_shape_matches_the_reference(shape):
    try:
        want = ref_mesh.parse_mesh_shape(shape)
    except ValueError:
        with pytest.raises(ValueError):
            pm.parse_mesh_shape(shape)
        return
    assert pm.parse_mesh_shape(shape) == want


def test_make_mesh_matches_the_reference():
    devs = jax.devices()
    for n in range(1, 9):
        for shape in (None, (1, n), (n, 1), pm._factor2(n)):
            want = ref_mesh.make_mesh(devs[:n], shape)
            got = pm.make_mesh(["cpu"] * n, shape)
            assert got.devices.shape == want.devices.shape
            assert got.shape == dict(want.shape)
            assert got.axis_names == tuple(want.axis_names)
            assert pm.num_shards(got) == ref_mesh.num_shards(want)
            assert len(pm.mesh_slices(got)) == \
                len(ref_mesh.mesh_slices(want))
    for bad in ((3, 2), (1, 9), (8, 2)):
        with pytest.raises(ValueError):
            ref_mesh.make_mesh(devs, bad)
        with pytest.raises(ValueError):
            pm.make_mesh(["cpu"] * 8, bad)
    with pytest.raises(ValueError):
        pm.make_mesh([])
    assert [str(d) for d in pm.make_mesh(["cpu", "cpu:0"]).devices.flat] == \
        ["cpu", "cpu:0"]


def test_slices_and_healthy_submesh_match_the_reference():
    """Positions of the survivors, by slice index, for dead sets over
    meshes of 1-8 devices (labels stand for the devices)."""
    devs = jax.devices()
    rng = np.random.default_rng(3)
    for n in range(1, 9):
        want_mesh = ref_mesh.make_mesh(devs[:n])
        labels = np.empty(n, dtype=object)
        labels[:] = list(range(n))
        got_mesh = pm.Mesh(labels.reshape(want_mesh.devices.shape))
        assert [s[0] for s in pm.mesh_slices(got_mesh)] == \
            [devs.index(s[0]) for s in ref_mesh.mesh_slices(want_mesh)]
        for _ in range(6):
            dead = set(rng.choice(n, rng.integers(0, n + 1), replace=False)
                       .tolist())
            want = ref_mesh.healthy_submesh(want_mesh, dead)
            got = pm.healthy_submesh(got_mesh, dead)
            assert (got is None) == (want is None)
            if got is not None:
                assert got == [devs.index(d) for d in want]


def test_pad_rows_for_matches_the_reference():
    for n in (1, 4, 7, 8):
        want_mesh = ref_mesh.make_mesh(jax.devices()[:n])
        got_mesh = pm.make_mesh(["cpu"] * n)
        for rows in (0, 1, 7, 8, 63, 64, 65, 1000, 1 << 20):
            for multiple in (1, 8, 64):
                assert pm.pad_rows_for(got_mesh, rows, multiple) == \
                    ref_mesh.pad_rows_for(want_mesh, rows, multiple)


def test_mesh_from_shape_builds_both_meshes_from_one_shape():
    for shape in SHAPES:
        ref = ref_mesh.make_mesh(jax.devices()[:shape[0] * shape[1]], shape)
        got = convert.mesh_from_shape(ref.devices.shape, ["cpu"] * 8)
        assert got.devices.shape == ref.devices.shape
        assert got.shape == dict(ref.shape)
        assert all(d.type == "cpu" for d in got.devices.flat)


def test_runner_takes_a_device_or_a_mesh():
    with pytest.raises(ValueError):
        DeviceRunner(device="cpu", mesh=pm.make_mesh(["cpu"]))
    r = DeviceRunner(mesh=pm.make_mesh(["cpu"] * 4), chunk_rows=CHUNK)
    assert r._nshards() == 4 and r._feed_unit() == CHUNK
    assert r._pad_rows(1) == CHUNK and r._pad_rows(CHUNK + 1) == 2 * CHUNK
    assert r.mvcc_resolver() is None
    assert DeviceRunner(mesh=pm.make_mesh(["cpu"] * 7),
                        chunk_rows=CHUNK)._block_local == 72


# ------------------------------------------------------------- parity


def _table():
    return Table(42, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("v", 3, FieldType.long()),
    ))


def _snap(table, n, seed, key_hi=500, null_frac=0.0, sparse=False, k=None):
    rng = np.random.default_rng(seed)
    if k is None and sparse:
        domain = rng.integers(0, 1 << 62, 37).astype(np.int64)
        k = rng.choice(domain, n)
    elif k is None:
        k = rng.integers(0, key_hi, n).astype(np.int64)
    v = rng.integers(-50_000, 50_000, n).astype(np.int64)
    kok = rng.random(n) > null_frac if null_frac else np.ones(n, np.bool_)
    vok = rng.random(n) > null_frac if null_frac else np.ones(n, np.bool_)
    return ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64),
        {"k": Column(EvalType.INT, k, kok),
         "v": Column(EvalType.INT, v, vok)})


@pytest.fixture(scope="module")
def r8():
    return RefRunner(mesh=ref_mesh.make_mesh(jax.devices()),
                     chunk_rows=CHUNK)


@pytest.fixture(scope="module")
def meshes():
    """The port's mesh runner of each shape (built once a module)."""
    return {s: DeviceRunner(mesh=convert.mesh_from_shape(s, ["cpu"] * 8),
                            chunk_rows=CHUNK) for s in SHAPES}


_REF_ROWS: dict = {}


def _rows(result):
    return sorted(result.rows())


def _ref_rows(r8, key, dag, snap):
    """The reference's answer to a case (computed once a module)."""
    if key not in _REF_ROWS:
        _REF_ROWS[key] = (_rows(r8.handle_request(dag, snap)),
                          _rows(BatchExecutorsRunner(dag, snap)
                                .handle_request()))
    return _REF_ROWS[key]


def _parity(key, dag, snap, r8, port):
    want, host = _ref_rows(r8, key, dag, snap)
    got = _rows(port.handle_request(port_dag(dag),
                                    port_snapshot(snap.table, snap)))
    assert got == want == host
    return got


def _agg(table, keys, aggs, where=None):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    if where is not None:
        s = s.where(where(s))
    return s.aggregate([s.col(k) for k in keys],
                       [(a, None if a == "count_star" else s.col("v"))
                        for a in aggs]).build()


@pytest.mark.parametrize("shape", SHAPES)
def test_hash_agg_min_max_parity_randomized(shape, r8, meshes):
    """GROUP BY with MIN/MAX under a selection (the scatter route per
    shard, then the psum and the bucket merge), NULL-heavy on odd seeds,
    feeds of 9000 + 512·seed rows (not whole units)."""
    table = _table()
    for seed in range(4):
        snap = _snap(table, 9000 + 512 * seed, seed, key_hi=700,
                     null_frac=0.07 if seed % 2 else 0.0)
        dag = _agg(table, ["k"], ["count_star", "sum", "min", "max"],
                   lambda s: s.col("v") > 0)
        _parity(("hash", seed), dag, snap, r8, meshes[shape])


@pytest.mark.parametrize("shape", SHAPES)
def test_sparse_keys_parity(shape, r8, meshes):
    """Keys over [0, 2^62): one global dictionary, its slot plane sharded
    as the feed."""
    table = _table()
    snap = _snap(table, 8192, 11, sparse=True)
    dag = _agg(table, ["k"], ["count_star", "sum", "max"])
    _parity("sparse", dag, snap, r8, meshes[shape])


@pytest.mark.parametrize("shape", SHAPES)
def test_simple_agg_and_topn_parity(shape, r8, meshes):
    table = _table()
    snap = _snap(table, 7000, 23, null_frac=0.1)
    dag = _agg(table, [], ["count_star", "sum", "min", "max", "avg"])
    _parity("simple", dag, snap, r8, meshes[shape])
    s2 = DagSelect.from_table(table, ["id", "k", "v"])
    topn = s2.order_by(s2.col("v"), desc=True, limit=37).build()
    want = r8.handle_request(topn, snap).rows()
    got = meshes[shape].handle_request(port_dag(topn),
                                       port_snapshot(table, snap)).rows()
    host = BatchExecutorsRunner(topn, snap).handle_request().rows()
    assert [r[-1] for r in got] == [r[-1] for r in want] == \
        [r[-1] for r in host]
    assert got == host


@pytest.mark.parametrize("shape", SHAPES)
def test_first_matches_the_host_pipeline(shape, meshes):
    """FIRST's position is global (a shard's own plus its first row): the
    first selected row, NULL included, as the host pipeline answers."""
    table = _table()
    for seed, null_frac in ((5, 0.3), (6, 0.0)):
        snap = _snap(table, 6000, seed, null_frac=null_frac)
        for where in (None, lambda s: s.col("v") > 20_000):
            dag = _agg(table, [], ["first", "count", "min"], where)
            host = BatchExecutorsRunner(dag, snap).handle_request().rows()
            got = meshes[shape].handle_request(
                port_dag(dag), port_snapshot(table, snap)).rows()
            assert got == host


# a word the merge's output starts with where a merge leaves it unwritten
POISON = 93855383176096


@pytest.fixture
def poisoned_merges(monkeypatch):
    """``shard_psum`` and ``shard_merge`` write into an output pre-filled
    with ``POISON`` where the caller passes none, so a word no merge and
    no host reduce writes shows as garbage on the CPU too."""
    for name in ("shard_psum", "shard_merge"):
        real = getattr(sh, name)

        def poisoned(parts, segments=None, out=None, _real=real):
            if out is None:
                out = torch.full_like(parts[0], POISON) \
                    if parts[0].dtype == torch.int64 else \
                    torch.full_like(parts[0], float(POISON))
            return _real(parts, segments, out=out)
        monkeypatch.setattr(sh, name, poisoned)


def _int_real_table():
    return Table(43, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("v", 2, FieldType.long()),
        TableColumn("r", 3, FieldType.double()),
    ))


@pytest.mark.parametrize("shape", SHAPES)
def test_first_over_an_empty_selection(shape, r8, meshes, poisoned_merges):
    """``SELECT COUNT(*), FIRST(v), FIRST(r) WHERE v > 1000`` over 9000 rows
    with ``v < 100``: no shard selects a row, so FIRST is NULL on the host
    and on the reference's mesh; the port's merge takes shard 0's empty
    state and never a word the psum left unwritten (fault 9).  Half the
    rows NULL or none."""
    table = _int_real_table()
    n = 9000
    rng = np.random.default_rng(90)
    for null_frac in (0.0, 0.5):
        ok = rng.random(n) >= null_frac
        snap = ColumnarTable.from_arrays(
            table, np.arange(n, dtype=np.int64),
            {"v": Column(EvalType.INT, rng.integers(-100, 100, n)
                         .astype(np.int64), ok),
             "r": Column(EvalType.REAL, rng.normal(0.0, 50.0, n), ok)})
        s = DagSelect.from_table(table, ["id", "v", "r"])
        dag = s.where(s.col("v") > 1000).aggregate(
            [], [("count_star", None), ("first", s.col("v")),
                 ("first", s.col("r"))]).build()
        want = r8.handle_request(dag, snap).rows()
        host = BatchExecutorsRunner(dag, snap).handle_request().rows()
        assert [list(r) for r in host] == [[0, None, None]]
        for _ in range(2):
            got = meshes[shape].handle_request(
                port_dag(dag), port_snapshot(table, snap)).rows()
            assert got == want == host


@pytest.mark.parametrize("shape", SHAPES)
def test_first_over_a_selection_in_one_shard(shape, r8, meshes,
                                             poisoned_merges):
    """The same FIRSTs where only rows of the last shard are selected (the
    earlier shards' FIRST states are empty) and where only one row is:
    equal to the reference's mesh, and to the host but for the REAL value,
    which both packages' devices hold in float32 (fault 6)."""
    table = _int_real_table()
    n = 9000
    rng = np.random.default_rng(91)
    v = rng.integers(-100, 100, n).astype(np.int64)
    r = rng.normal(0.0, 50.0, n)
    for rows in ([n - 3, n - 1], [4321]):
        v2 = v.copy()
        v2[rows] = 5000
        snap = ColumnarTable.from_arrays(
            table, np.arange(n, dtype=np.int64),
            {"v": Column(EvalType.INT, v2, np.ones(n, np.bool_)),
             "r": Column(EvalType.REAL, r, np.ones(n, np.bool_))})
        s = DagSelect.from_table(table, ["id", "v", "r"])
        dag = s.where(s.col("v") > 1000).aggregate(
            [], [("count_star", None), ("first", s.col("v")),
                 ("first", s.col("r"))]).build()
        want = r8.handle_request(dag, snap).rows()
        host = BatchExecutorsRunner(dag, snap).handle_request().rows()
        assert [list(x) for x in host] == [[len(rows), 5000, r[rows[0]]]]
        got = meshes[shape].handle_request(
            port_dag(dag), port_snapshot(table, snap)).rows()
        assert got == want
        assert got[0][:2] == host[0][:2]
        assert got[0][2] == float(np.float32(r[rows[0]]))


@pytest.mark.parametrize("shape", SHAPES)
def test_selection_mask_then_index_route(shape, r8, meshes):
    """The mask route cold, the index route (per-shard indices offset by
    the shard's first row) once the EWMA is warm; every answer exact."""
    n = 1 << 17
    table = _table()
    rng = np.random.default_rng(5)
    ones = np.ones(n, np.bool_)
    snap = ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64),
        {"k": Column(EvalType.INT, rng.integers(0, 100, n)
                     .astype(np.int64), ones),
         "v": Column(EvalType.INT, rng.integers(0, 1_000_000, n)
                     .astype(np.int64), ones)})
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.where(s.col("v") < 100).build()
    want, host = _ref_rows(r8, "sel", dag, snap)
    assert want == host
    port = meshes[shape]
    before = dict(port.sel_routes)
    pdag, psnap = port_dag(dag), port_snapshot(table, snap)
    for _ in range(5):
        assert _rows(port.handle_request(pdag, psnap)) == want
    took = {k: v - before.get(k, 0) for k, v in port.sel_routes.items()}
    # one device compacts the rows themselves; a mesh ships row indices
    warm = "compact" if shape == (1, 1) else "index"
    assert took.get("mask", 0) >= 1 and took.get(warm, 0) >= 1, took
    assert set(took) == {"mask", warm}, took


@pytest.mark.parametrize("shape", SHAPES)
def test_real_sums_within_the_error_scale(shape, r8, meshes):
    """REAL SUM/AVG per group on the two-level route per shard, its float
    planes psummed in shard order."""
    table, snap = configs.build_table(20_000, real_v=True)
    dag = configs.dag_4r(table)
    want, scales = configs.truth("4r", snap)
    got = meshes[shape].handle_request(dag, snap).rows()
    assert configs.rows_agree(got, want, scales, 1e-9)


def _warm_phases(port, dag, snap) -> dict:
    port.handle_request(dag, snap)
    tr, tok = tracker.install()
    try:
        port.handle_request(dag, snap)
    finally:
        tracker.uninstall(tok)
    return tr.phases


def test_shard_merge_phase(meshes):
    """A warm simple aggregation with MIN reports the host's part of the
    merge (the S stacked MIN rows reduced on the host)."""
    table = _table()
    snap = port_snapshot(table, _snap(table, 6000, 31, key_hi=900))
    dag = port_dag(_agg(table, [], ["count_star", "min"]))
    phases = _warm_phases(meshes[(2, 4)], dag, snap)
    assert "shard_merge" in phases, phases


def test_group_by_min_merges_on_the_card(meshes):
    """A GROUP BY with MIN merges its summed and stacked rows in one
    ``shard.shard_merge`` launch: the host does no merge work, so no
    ``shard_merge`` phase opens."""
    table = _table()
    snap = port_snapshot(table, _snap(table, 6000, 31, key_hi=900))
    dag = port_dag(_agg(table, ["k"], ["count_star", "min"]))
    phases = _warm_phases(meshes[(2, 4)], dag, snap)
    assert "shard_merge" not in phases, phases


# ------------------------------------------------------------ edge cases


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (1, 7)])
@pytest.mark.parametrize("n", [1, 63, 100, CHUNK - 1, CHUNK, CHUNK + 1,
                               3 * CHUNK + 17])
def test_trailing_shards_and_ragged_feeds(shape, n, meshes, poisoned_merges):
    """Feeds below one shard's unit (the trailing shards hold no live row)
    and feeds that are not a whole number of units, on every route, FIRST
    over an empty selection among them; every merge's output starts
    poisoned."""
    table = _table()
    snap = _snap(table, n, 40 + n, key_hi=50, null_frac=0.1)
    psnap = port_snapshot(table, snap)
    port = meshes[shape]
    groups = [_agg(table, ["k"], ["count_star", "sum", "min", "max"]),
              _agg(table, ["k"], ["count_star", "sum"]),
              _agg(table, [], ["count", "sum", "min", "max", "first"]),
              _agg(table, [], ["count_star", "first", "min"],
                   lambda s: s.col("v") > 10 ** 9),
              _agg(table, ["k"], ["count", "avg"],
                   lambda s: s.col("v") > 0)]
    s = DagSelect.from_table(table, ["id", "k", "v"])
    rows = [s.where(s.col("v") > 0).build()]
    s = DagSelect.from_table(table, ["id", "k", "v"])
    rows.append(s.order_by(s.col("v"), desc=False, limit=9).build())

    def in_order(r):      # the host's groups come in first-seen order
        return sorted(r, key=lambda row: [(x is not None, x or 0)
                                          for x in row])

    for dag in groups + rows:
        host = BatchExecutorsRunner(dag, snap).handle_request().rows()
        got = port.handle_request(port_dag(dag), psnap).rows()
        if dag in groups:
            got, host = in_order(got), in_order(host)
        assert got == host


@pytest.mark.parametrize("shape", SHAPES)
def test_every_row_filtered_out(shape, r8, meshes):
    table = _table()
    snap = _snap(table, 5000, 9, null_frac=0.2)
    never = lambda s: s.col("v") > 10 ** 9     # noqa: E731
    for key, dag in (
            ("none-hash", _agg(table, ["k"], ["count_star", "sum", "min",
                                              "max"], never)),
            ("none-simple", _agg(table, [], ["count_star", "sum", "min",
                                             "max"], never))):
        _parity(key, dag, snap, r8, meshes[shape])
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.where(never(s)).build()
    assert meshes[shape].handle_request(
        port_dag(dag), port_snapshot(table, snap)).rows() == []


@pytest.mark.parametrize("shape", SHAPES)
def test_key_held_by_one_shard(shape, r8, meshes):
    """Key 699 lives only in rows [2600, 2700): one shard's partial holds
    it, every other shard's MIN/MAX cells keep the identity."""
    table = _table()
    n = 4000
    k = np.random.default_rng(8).integers(0, 600, n).astype(np.int64)
    k[2600:2700] = 699
    snap = _snap(table, n, 8, k=k)
    dag = _agg(table, ["k"], ["count_star", "min", "max", "sum"])
    got = _parity("one-shard-key", dag, snap, r8, meshes[shape])
    assert any(r[-1] == 699 for r in got)


def test_bucket_merge_across_devices(monkeypatch):
    """Where the mesh spans several devices (``cpu`` and ``cpu:0`` stand
    for two cards), the GROUP BY counts, sums and MIN/MAX rows are still
    merged by one ``shard_merge`` on the first device, over every shard's
    whole buffer; 1026 slots over 3 and 4 shards (not a multiple of
    either)."""
    table, snap = configs.build_multichip_table(30_000)
    want, scales = configs.truth("4x", snap)
    for devs in (["cpu", "cpu:0"] * 2, ["cpu", "cpu:0", "cpu"]):
        r = DeviceRunner(mesh=pm.make_mesh(devs), chunk_rows=CHUNK)
        seen = []
        real = sh.shard_merge

        def spy(parts, segments, out=None):
            seen.append((len(parts), {p.device for p in parts},
                         sorted({op for _o, _n, op in segments})))
            return real(parts, segments, out)

        monkeypatch.setattr(sh, "shard_merge", spy)
        got = r.handle_request(configs.dag_4x(table), snap).rows()
        monkeypatch.undo()
        assert seen == [(len(devs), {torch.device("cpu")},
                         ["max_i64", "min_i64", "sum_i64"])]
        assert configs.rows_agree(got, want, scales, 1e-9)


# ------------------------------------------------- routes and contract


def _count_calls(monkeypatch, mod, name, log):
    real = getattr(mod, name)

    def spy(*a, **k):
        log.append(name)
        return real(*a, **k)
    monkeypatch.setattr(mod, name, spy)


def test_one_shard_mesh_takes_the_single_device_code(monkeypatch):
    """A mesh of one device pads, routes and answers as
    ``DeviceRunner(device="cpu")``, and never merges."""
    import tikv_tpu_torch.device.runner as rmod
    one = DeviceRunner(mesh=pm.make_mesh(["cpu"]))
    single = DeviceRunner(device="cpu")
    assert one._single and one._block_local == single._block_local
    logs = {}
    for name, runner in (("one", one), ("single", single)):
        log = logs[name] = []
        for mod, fn in ((ha, "hash_agg"), (rmod, "twolevel_fused"),
                        (rmod, "agg_fold"), (sh, "shard_psum"),
                        (sh, "shard_bucket_merge"), (sh, "shard_merge")):
            _count_calls(monkeypatch, mod, fn, log)
        for cfg in ("3", "4", "4n", "4m", "3n"):
            table, snap = configs.CONFIGS[cfg][0](20_000)
            dag = configs.CONFIGS[cfg][1](table)
            want, scales = configs.truth(cfg, snap)
            assert configs.rows_agree(runner.handle_request(dag, snap)
                                      .rows(), want, scales, 1e-9)
        table, snap = configs.build_table(20_000)
        for _ in range(5):
            runner.handle_request(configs.dag_selection(table, 995), snap)
        monkeypatch.undo()
    assert logs["one"] == logs["single"]
    assert "shard_psum" not in logs["one"]
    assert "shard_merge" not in logs["one"]
    assert one.sel_routes == single.sel_routes
    assert one.pred_routes == single.pred_routes


def test_mesh_merges_launch_where_the_route_needs_them(monkeypatch):
    """Per request on a 4-shard mesh: every per-shard wrapper once a live
    shard, and one merge launch: the psum on the fused and two-level
    routes, one ``shard_merge`` of the fold's summed and MIN/MAX rows
    together with GROUP BY (4x); selections and top-n merge on the host."""
    r = DeviceRunner(mesh=pm.make_mesh(["cpu"] * 4), chunk_rows=4 * ha.BLOCK)
    import tikv_tpu_torch.device.runner as rmod
    n = 3 * ha.BLOCK + 5                # the last shard holds 5 rows
    table, snap = configs.build_multichip_table(n)
    ntable, nsnap = configs.build_null_table(n)
    cases = {
        "4": (configs.dag_hash_agg(table), snap,
              ["hash_agg"] * 4 + ["shard_psum"]),
        "3": (configs.dag_simple_agg(table), snap,
              ["hash_agg"] * 4 + ["shard_psum"]),
        "4x": (configs.dag_4x(table), snap, ["agg_fold"] * 4 +
               ["shard_merge"]),
        "4n": (configs.dag_4n(ntable), nsnap, ["twolevel_fused"] * 4 +
               ["shard_psum"]),
        "2": (configs.dag_selection(table, 40), snap, []),
    }
    for name, (dag, snap, want) in cases.items():
        log = []
        for mod, fn in ((ha, "hash_agg"), (rmod, "twolevel_fused"),
                        (rmod, "agg_fold"), (sh, "shard_psum"),
                        (sh, "shard_bucket_merge"), (sh, "shard_merge")):
            _count_calls(monkeypatch, mod, fn, log)
        r.handle_request(dag, snap)
        monkeypatch.undo()
        assert log == want, (name, log)


def test_shard_launch_degrades_the_whole_plan():
    """``device::shard_launch`` at shard 2 (after shards 0 and 1 launched):
    the host pipeline answers, ``degrades`` counts it, the dispatch lock is
    free, and the next request runs on the shards again."""
    table = _table()
    snap = _snap(table, 5000, 77, key_hi=300)
    dag = _agg(table, ["k"], ["count_star", "sum"])
    host = _rows(BatchExecutorsRunner(dag, snap).handle_request())
    port = DeviceRunner(mesh=pm.make_mesh(["cpu"] * 8), chunk_rows=CHUNK)
    pdag, psnap = port_dag(dag), port_snapshot(table, snap)
    calls = []
    real = tl.twolevel_fused

    for arm in ("return(2)", "return"):
        failpoint.cfg("device::shard_launch", arm)
        try:
            tr, tok = tracker.install()
            try:
                got = _rows(port.handle_request(pdag, psnap))
            finally:
                tracker.uninstall(tok)
        finally:
            failpoint.teardown()
        assert got == host
        assert tr.labels.get("degraded") == "shard_launch"
        assert "d2h_wait" not in tr.phases
        assert port._dispatch_mu.acquire(timeout=1)
        port._dispatch_mu.release()
    assert port.degrades == {"shard_launch": 2}
    import tikv_tpu_torch.device.runner as rmod
    rmod.twolevel_fused = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        assert _rows(port.handle_request(pdag, psnap)) == host
    finally:
        rmod.twolevel_fused = real
    assert len(calls) == 8 and port.degrades == {"shard_launch": 2}


def test_shard_launch_with_a_concurrent_request():
    """A one-shot fault racing a healthy request: both answers exact, one
    degrade, and later requests unaffected."""
    table = _table()
    snap = _snap(table, 5000, 78, key_hi=300)
    dag = _agg(table, ["k"], ["count_star", "sum", "max"])
    host = _rows(BatchExecutorsRunner(dag, snap).handle_request())
    port = DeviceRunner(mesh=pm.make_mesh(["cpu"] * 4), chunk_rows=CHUNK)
    pdag, psnap = port_dag(dag), port_snapshot(table, snap)
    assert _rows(port.handle_request(pdag, psnap)) == host
    failpoint.cfg("device::shard_launch", "1*return->off")
    out = [None, None]

    def run(i):
        out[i] = _rows(port.handle_request(pdag, psnap))

    try:
        ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        failpoint.teardown()
    assert out == [host, host]
    assert port.degrades == {"shard_launch": 1}
    assert _rows(port.handle_request(pdag, psnap)) == host


def test_endpoint_serves_over_a_mesh():
    """The endpoint over a mesh runner, forced to the device and routed
    by size, with a coalescer bound: a mesh request is never stacked."""
    from tikv_tpu_torch.server.coalescer import RequestCoalescer
    table, snap = configs.build_multichip_table(40_000)
    runner = DeviceRunner(mesh=pm.make_mesh(["cpu"] * 4), chunk_rows=CHUNK)
    coal = RequestCoalescer(runner, window_ms=5.0, max_group=4)
    ep = Endpoint(lambda req: snap, runner, device_row_threshold=1,
                  coalescer=coal)
    try:
        agg = configs.dag_4x(table)
        want, scales = configs.truth("4x", snap)
        resp = ep.handle(CopRequest(REQ_TYPE_DAG, agg, force_backend="device"))
        assert resp.backend == "device"
        assert configs.rows_agree(resp.rows(), want, scales, 1e-9)
        sel = configs.dag_selection(table, 45)
        assert runner.batch_class(sel, snap) is None
        got = ep.handle_async(CopRequest(REQ_TYPE_DAG, sel)).wait()
        v = snap.columns[3].values
        assert len(got.rows()) == int((v > 45).sum())
        assert not ep.degrades
    finally:
        ep.close()


def test_single_device_paths_on_a_mesh():
    """ANALYZE is answered by the host half, the split re-mints, and the
    scrub re-hashes a sharded feed's planes whole."""
    from tikv_tpu_torch.copr.analyze import analyze_columns
    table, snap = configs.build_table(3000)
    runner = DeviceRunner(mesh=pm.make_mesh(["cpu"] * 4), chunk_rows=CHUNK)
    areq = configs.analyze_request(table, 16)
    ep = Endpoint(lambda req: snap, runner, device_row_threshold=1)
    got = ep.handle_analyze(areq)["columns"]
    batch = snap.scan_columns(areq.scan, areq.ranges)
    want = analyze_columns(batch, areq.scan.columns, 16)
    assert [(s.total, s.null_count, s.distinct, s.buckets) for s in got] == \
        [(s.total, s.null_count, s.distinct, s.buckets) for s in want]
    assert runner.split_resident_feeds({"parent_lineage": object()}) == \
        "none"
    runner.handle_request(configs.dag_hash_agg(table), snap)
    (feed,) = runner.resident_feeds(snap).values()
    assert len(feed["shards"]) == 4 and runner.scrub_feed(feed) == []
    runner.corrupt_resident_plane(feed, 1)
    assert runner.scrub_feed(feed) == [1]
    runner.corrupt_resident_plane(feed, 1)
    assert runner.scrub_feed(feed) == []
    with pytest.raises(NotImplementedError):
        runner._patch_plane(feed, [(0, 1)], [feed["flat"][0][:1]], [0])


def test_fold_merge_rows_cover_the_buffer():
    """The psum segments, MIN/MAX rows and FIRST rows of a fold buffer
    partition its words."""
    import torch
    v = torch.arange(10, dtype=torch.int32)
    f = torch.arange(10, dtype=torch.float32)
    ok = torch.ones(10, dtype=torch.bool)
    from tikv_tpu_torch.ops.agg import AggSpec
    from tikv_tpu_torch.device.runner import _fold_merge_rows
    specs = [AggSpec("count_star", 0), AggSpec("sum", 1, EvalType.INT),
             AggSpec("min", 2, EvalType.INT), AggSpec("var_pop", 3,
                                                      EvalType.REAL),
             AggSpec("max", 4, EvalType.REAL), AggSpec("first", 5,
                                                        EvalType.INT)]
    cols = [None, (v, ok), (v, None), (f, ok), (f, ok), (v, ok)]
    plan = af.plan_fold(specs, cols, af.MODE_SIMPLE)
    for n_slots in (1, 7):
        sums, stacked, first = _fold_merge_rows(plan, n_slots)
        covered = np.zeros(1 + len(plan.rows) * n_slots, np.int64)
        for off, n, op in sums:
            covered[off:off + n] += 1
            rows = {plan.rows[(w - 1) // n_slots][0]
                    for w in range(max(off, 1), off + n)}
            assert (op == "sum_f64") == (rows <= {"fsum", "sumsq"}), rows
        for r, op in stacked:
            covered[1 + r * n_slots:1 + (r + 1) * n_slots] += 1
            assert op == plan.rows[r][0] + "_i64"
        for rows in first.values():
            assert set(rows) == {"first", "firstval", "firstok"}
            for r in rows.values():
                covered[1 + r * n_slots:1 + (r + 1) * n_slots] += 1
        assert (covered == 1).all()
