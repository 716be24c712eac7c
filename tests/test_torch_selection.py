"""The selection route (scan → Selection, no terminal) of the port against
the JAX package's DeviceRunner and its host pipeline.

The same seeded snapshot and the same wire-encoded DAG go to the reference
``DeviceRunner`` on one CPU device, to the port's
``DeviceRunner(device="cpu")`` (the plain PyTorch versions of
``sel_mask``/``sel_compact``) and to the reference's host pipeline
(``BatchExecutorsRunner``).  Results are row lists and must be equal
exactly: they are the same rows and values.  Covered: each route with its
choice asserted, the index route's overflow falling back to the packed
mask, the shapes of ``tests/test_device_selection.py`` (NULL-heavy, wide,
tombstoned; randomized thresholds with selectivity 0 and 1), the gather of
selected rows, the packed bit order against ``np.unpackbits``, index-scan
heads, configs 1, 2 and 2s at reduced size, and the refusals that name the
host pipeline's ROADMAP item.
"""

import numpy as np
import pytest

import jax
import torch

import bench
from tikv_tpu.codec.keys import table_record_key
from tikv_tpu.copr.dag import IndexScanDesc
from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.executors.ranges import KeyRange
from tikv_tpu.executors.runner import BatchExecutorsRunner
from tikv_tpu.expr import Expr
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch import convert
from tikv_tpu_torch.copr import wire as port_wire
from tikv_tpu_torch.device import selection as sm
from tikv_tpu_torch.executors.ranges import KeyRange as PortKeyRange
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.testing import configs


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def port():
    return DeviceRunner(device="cpu")


def port_snapshot(table, snap):
    """The reference snapshot carried into the port as plain arrays."""
    ptable = convert.table_from_wire(table.table_id, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in table.columns])
    arrays = {}
    for c in table.columns:
        col = snap.columns.get(c.col_id)
        if col is not None:
            arrays[c.name] = (col.eval_type.value, col.values, col.validity)
    return convert.snapshot_from_arrays(ptable, snap.handles, arrays,
                                        getattr(snap, "alive", None))


def port_dag(dag):
    return convert.dag_from_wire(wire.enc_dag(dag))


def run_three(ref, port, dag, snap, psnap=None, reps: int = 1):
    """(reference device rows, port rows, host rows); the port serves the
    request ``reps`` times (the last answer is returned, all must agree)."""
    want = ref.handle_request(dag, snap).rows()
    host = BatchExecutorsRunner(dag, snap).handle_request().rows()
    pdag = port_dag(dag)
    psnap = psnap or port_snapshot(table_of(snap), snap)
    got = [port.handle_request(pdag, psnap).rows() for _ in range(reps)]
    assert all(g == got[-1] for g in got)
    return want, got[-1], host


def table_of(snap):
    return snap.table


def _int_cols(names, start_id=2):
    return [TableColumn(nm, start_id + i, FieldType.long())
            for i, nm in enumerate(names)]


def make_null_heavy(n=3_000, seed=0):
    rng = np.random.default_rng(seed)
    table = Table(8900 + seed, tuple(
        [TableColumn("id", 1, FieldType.long(not_null=True),
                     is_pk_handle=True)] + _int_cols(["a", "b"])))
    named = {
        "a": Column(EvalType.INT, rng.integers(-500, 500, n).astype(np.int64),
                    rng.random(n) > 0.5),
        "b": Column(EvalType.INT, rng.integers(0, 50, n).astype(np.int64),
                    rng.random(n) > 0.2),
    }
    return table, ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64), named)


def make_wide(n=2_000, seed=1, n_cols=18):
    rng = np.random.default_rng(seed)
    names = [f"c{i}" for i in range(n_cols)]
    table = Table(8950 + seed, tuple(
        [TableColumn("id", 1, FieldType.long(not_null=True),
                     is_pk_handle=True)] + _int_cols(names)))
    named = {nm: Column(EvalType.INT,
                        rng.integers(-1000, 1000, n).astype(np.int64),
                        (np.arange(n) % 13) != (i % 13))
             for i, nm in enumerate(names)}
    return table, ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64), named)


def make_tombstoned(n=2_500, seed=2):
    """Delete tombstones (``alive``): the gather must skip dead rows."""
    rng = np.random.default_rng(seed)
    table = Table(8990 + seed, tuple(
        [TableColumn("id", 1, FieldType.long(not_null=True),
                     is_pk_handle=True)] + _int_cols(["a", "b"])))
    named = {
        "a": Column(EvalType.INT, rng.integers(-500, 500, n).astype(np.int64),
                    np.ones(n, np.bool_)),
        "b": Column(EvalType.INT, rng.integers(0, 9, n).astype(np.int64),
                    (np.arange(n) % 7) != 2),
    }
    tbl = ColumnarTable.from_arrays(table, np.arange(n, dtype=np.int64),
                                    named)
    alive = rng.random(n) > 0.3
    return table, ColumnarTable(table, tbl.handles, tbl.columns, alive=alive)


def make_mixed(n=200_000, seed=3):
    """INT ``a`` and a REAL column ``r`` (quarter steps, exact in float32):
    the scan is not lossless on the device, so no compact route."""
    rng = np.random.default_rng(seed)
    table = Table(9000 + seed, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("a", 2, FieldType.long(), index_id=4),
        TableColumn("r", 3, FieldType.double())))
    r_ok = rng.random(n) > 0.1
    named = {
        "a": Column(EvalType.INT, rng.integers(0, 100_000, n).astype(np.int64),
                    np.ones(n, np.bool_)),
        "r": Column(EvalType.REAL, np.where(
            r_ok, rng.integers(-400, 400, n) / 4.0, 0.0), r_ok),
    }
    return table, ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64), named)


def sel_dag(table, cond_col: str, thr, extra=None):
    s = DagSelect.from_table(table, [c.name for c in table.columns])
    conds = [s.col(cond_col) > thr]
    if extra is not None:
        conds.append(s.col(extra[0]) < extra[1])
    return s.where(*conds).build()


def routes_of(port, fn):
    before = dict(port.sel_routes)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in port.sel_routes.items()
                 if v != before.get(k, 0)}


# ------------------------------------------------------- randomized parity


@pytest.mark.parametrize("shape", ["null_heavy", "wide", "tombstoned"])
def test_randomized_selection_parity(shape, ref, port):
    """Random predicates and thresholds over the reference test's table
    shapes (selectivity 1 and 0 pinned), each served twice by the port
    (cold: mask route; warm: the EWMA's route)."""
    table, snap = {"null_heavy": make_null_heavy, "wide": make_wide,
                   "tombstoned": make_tombstoned}[shape]()
    psnap = port_snapshot(table, snap)
    rng = np.random.default_rng(99)
    value_cols = [c.name for c in table.columns if not c.is_pk_handle]
    lo = min(int(snap.columns[c.col_id].values.min())
             for c in table.columns if not c.is_pk_handle)
    hi = max(int(snap.columns[c.col_id].values.max())
             for c in table.columns if not c.is_pk_handle)
    for i, thr in enumerate([lo - 1, hi + 1] +
                            rng.integers(lo, hi + 1, 8).tolist()):
        col = value_cols[int(rng.integers(len(value_cols)))]
        extra = None
        if i % 3 == 2:
            extra = (value_cols[int(rng.integers(len(value_cols)))],
                     int(rng.integers(lo, hi + 1)))
        want, got, host = run_three(ref, port, sel_dag(table, col, int(thr),
                                                       extra), snap, psnap,
                                    reps=4)
        assert host == want
        assert got == want


def test_selection_routes_cover_all_paths(ref, port):
    """compact (every scan column INT, small k), index (a REAL scan
    column, small k) and mask (a REAL scan column, large k), each chosen
    once the EWMA is warm, each answering as the reference and the
    host."""
    table, snap = make_null_heavy(n=40_000, seed=7)
    mtable, msnap = make_mixed()
    a = snap.columns[2]
    live = a.values[a.validity]
    for tb, sn, thr, route in (
            (table, snap, int(np.quantile(live, 0.999)), "compact"),
            (mtable, msnap, 99_900, "index"),
            (mtable, msnap, 50_000, "mask")):
        dag = sel_dag(tb, "a", thr)
        psnap = port_snapshot(tb, sn)
        pdag = port_dag(dag)
        for _ in range(3):      # cold requests take the mask route
            port.handle_request(pdag, psnap)
        got, taken = routes_of(port, lambda: port.handle_request(
            pdag, psnap).rows())
        assert taken == {route: 1}, (route, taken)
        want = ref.handle_request(dag, sn).rows()
        assert got == want
        assert BatchExecutorsRunner(dag, sn).handle_request().rows() == want


def test_capacity_overflow_falls_back_to_mask(ref):
    """An undersized index capacity falls back to the packed mask, still
    on the device: exact rows, never a truncated answer."""
    table, snap = make_mixed(seed=13)
    port = DeviceRunner(device="cpu")
    port._sel_predict = lambda keys: 1e-5       # predict ~0 rows
    dag = sel_dag(table, "a", 50_000)           # ~50% selected
    got, taken = routes_of(port, lambda: port.handle_request(
        port_dag(dag), port_snapshot(table, snap)).rows())
    assert taken == {"mask_fallback": 1}
    want = ref.handle_request(dag, snap).rows()
    assert got == want and len(want) > 90_000
    assert BatchExecutorsRunner(dag, snap).handle_request().rows() == want


def test_ewma_keys_and_prediction(port):
    """Predictions start after 3 observations, per exact plan key first,
    then per const-blind shape key; the statistics are an LRU of 256."""
    table, snap = make_null_heavy(n=5_000, seed=31)
    psnap = port_snapshot(table, snap)
    r = DeviceRunner(device="cpu")
    dags = [port_dag(sel_dag(table, "a", t)) for t in (0, 100, 200)]
    plan = r._analyze(dags[0])[0]
    keys = r._sel_keys(dags[0], plan)
    for i in range(3):
        assert r._sel_predict(keys) is None
        r.handle_request(dags[0], psnap)
    assert r._sel_predict(keys) is not None
    # another threshold: its exact key is cold, the shape key is warm
    other = r._sel_keys(dags[1], r._analyze(dags[1])[0])
    assert other[1] == keys[1] and other[0] != keys[0]
    assert r._sel_predict(other) == r._sel_stats[keys[1]]["ewma"]
    for i in range(300):
        r._sel_observe([("k", i)], 0.5)
    assert len(r._sel_stats) == 256


# ------------------------------------------------------------ the kernels


@pytest.mark.parametrize("n", [1, 7, 8, 9, 4095, 32767, 32768, 32769,
                               100_003])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_packbits_bit_order(n, p):
    """sel_mask's packed bytes are np.packbits' (row 8j is bit 7 of byte
    j), rows past n read as zero bits, one popcount per block."""
    m = np.random.default_rng(n).random(n) < p
    out = sm.sel_mask(torch.from_numpy(m), n)
    count, packed = out.host()
    assert count == int(m.sum())
    np.testing.assert_array_equal(packed, np.packbits(m))
    np.testing.assert_array_equal(np.unpackbits(packed)[:n].astype(bool), m)
    counts = out.block_counts.numpy()
    assert len(counts) == sm.n_blocks(n)
    np.testing.assert_array_equal(counts, [
        m[i:i + sm.ROWS_PER_BLOCK].sum()
        for i in range(0, sm.n_blocks(n) * sm.ROWS_PER_BLOCK,
                       sm.ROWS_PER_BLOCK)])


@pytest.mark.parametrize("k_cap", [64, 1 << 12, 1 << 16])
def test_compact_indices_and_planes(k_cap):
    """sel_compact: the first k_cap selected rows ascending with -1 fill,
    the overflow flag, and each plane gathered there (0 fill)."""
    rng = np.random.default_rng(k_cap)
    n = 50_001
    m = rng.random(n) < 0.05
    planes = [rng.integers(-9, 9, n).astype(np.int32),
              rng.integers(-2**40, 2**40, n), rng.random(n) < 0.5,
              rng.random(n)]
    out = sm.sel_compact(sm.sel_mask(torch.from_numpy(m), n), k_cap,
                         [torch.from_numpy(p) for p in planes])
    count, overflow, idx, outs = out.host()
    sel = np.flatnonzero(m)
    take = sel[:k_cap]
    assert count == len(sel) and overflow == int(len(sel) > k_cap)
    np.testing.assert_array_equal(idx[:len(take)], take)
    assert (idx[len(take):] == -1).all()
    for p, o in zip(planes, outs):
        np.testing.assert_array_equal(o[:len(take)], p[take])
        assert not o[len(take):].any()


def test_kernel_wrappers_take_the_plain_version_on_the_cpu_only():
    before = (sm.mask_launches, sm.compact_launches)
    m = torch.rand(1000) < 0.5
    sm.sel_compact(sm.sel_mask(m, 1000), 64)
    assert (sm.mask_launches, sm.compact_launches) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        sm.sel_mask(torch.zeros(10, dtype=torch.bool, device="meta"), 10)
    with pytest.raises(ValueError, match="bool"):
        sm.sel_mask(torch.zeros(10, dtype=torch.int32), 10)
    with pytest.raises(ValueError, match="rows"):
        sm.sel_mask(m, 1001)


def test_route_policy_matches_the_reference():
    from tikv_tpu.device import selection as ref_sm
    n = 10_000_000
    for k in (0, 100, 10_000, 16_384, 16_385, 300_000, 5_000_000, n):
        for compact_ok in (False, True):
            assert sm.choose_route(n, k, compact_ok) == \
                ref_sm.choose_route(n, k, compact_ok)
        assert sm.index_bytes(k) == ref_sm.index_bytes(k)
        for n_local in (100, 1 << 20, n):
            assert sm.index_capacity(k, n_local) == \
                ref_sm.index_capacity(k, n_local)
    assert sm.COMPACT_MAX_ROWS == ref_sm.COMPACT_MAX_ROWS


# ------------------------------------------------------------- the gather


def test_gather_rows_matches_scan_filter():
    """The port's gather of selected rows equals scan + filter/take, and
    the reference's gather, over multi-range, descending and tombstoned
    scans."""
    table, snap = make_tombstoned(n=2_000, seed=21)
    psnap = port_snapshot(table, snap)
    rk = lambda h: table_record_key(table.table_id, h)   # noqa: E731
    for ranges in ((), (KeyRange(rk(100), rk(700)),
                        KeyRange(rk(900), rk(1500)))):
        for desc in (False, True):
            s = DagSelect.from_table(table, [c.name for c in table.columns])
            scan = s.build().executors[0]
            scan = type(scan)(scan.table_id, scan.columns, desc)
            pscan = port_dag(DagSelect.from_table(
                table, [c.name for c in table.columns]).build()).executors[0]
            pscan = type(pscan)(pscan.table_id, pscan.columns, desc)
            pranges = tuple(PortKeyRange(r.start, r.end) for r in ranges)
            batch = snap.scan_columns(scan, ranges)
            mask = np.random.default_rng(3).random(batch.num_rows) > 0.6
            want = batch.filter(mask).rows()
            assert psnap.scan_columns(pscan, pranges).filter(mask).rows() \
                == want
            assert psnap.gather_rows(pscan, pranges, mask).rows() == want
            assert psnap.gather_rows(pscan, pranges,
                                     np.flatnonzero(mask)).rows() == want
            assert snap.gather_rows(scan, ranges, mask).rows() == want
    with pytest.raises(ValueError, match="tombstones"):
        psnap.row_slices(())
    table, snap = make_null_heavy(n=2_000, seed=22)
    rk = lambda h: table_record_key(table.table_id, h)   # noqa: E731
    ranges = (KeyRange(rk(100), rk(700)), KeyRange(rk(900), rk(1500)))
    assert port_snapshot(table, snap).row_slices(tuple(
        PortKeyRange(r.start, r.end) for r in ranges)) == \
        snap.row_slices(ranges)


def test_index_key_datums_match_the_reference():
    """The index-range codec: the port's memcomparable datums and index
    prefix are the reference's bytes, and decode back."""
    from tikv_tpu.codec.keys import index_key_prefix as ref_prefix
    from tikv_tpu.codec.mc_datum import encode_mc_datum as ref_encode
    from tikv_tpu_torch.codec import (decode_mc_datum, encode_mc_datum,
                                      index_key_prefix)
    assert index_key_prefix(99, 2) == ref_prefix(99, 2)
    for v in (None, 0, -1, 2**63 - 1, -2**63, 7, 0.0, -0.0, 1.5, -2.25,
              float("inf"), 1e-300):
        b = encode_mc_datum(v)
        assert b == ref_encode(v)
        got, end = decode_mc_datum(b + b"tail")
        assert end == len(b) and (got == v or (got is None and v is None))
    with pytest.raises(ValueError):
        decode_mc_datum(b"\xff" * 9)


# ---------------------------------------------------------- plan shapes


def _index_sel_dag(table, desc: bool):
    s = DagSelect.from_index(table, "a", with_handle=True)
    dag = s.where(s.col("a") > 99_000).build()
    sc = dag.executors[0]
    return type(dag)((IndexScanDesc(sc.table_id, sc.index_id, sc.columns,
                                    desc),) + dag.executors[1:], dag.ranges)


def test_index_scan_selection_and_aggregation(port):
    """IndexScan heads: a selection over the index's column (ascending and
    descending, each on a fresh reference runner: see the next test), and
    an aggregation over it."""
    table, snap = make_mixed(n=30_000, seed=5)
    for desc in (False, True):
        ref = RefRunner(mesh=make_mesh(jax.devices()[:1]))
        want, got, host = run_three(ref, port, _index_sel_dag(table, desc),
                                    snap, reps=4)
        assert want == host and got == want and len(want) > 100
    s = DagSelect.from_index(table, "a", with_handle=True)
    dag = s.where(s.col("a") < 5_000).aggregate(
        [], [("count_star", None), ("sum", s.col("a")),
             ("max", s.col("id"))]).build()
    want, got, host = run_three(ref, port, dag, snap)
    assert want == host and got == want


def test_reference_device_reuses_the_ascending_feed_for_a_descending_scan():
    """ROADMAP.md queue 3, fault 7: the reference keys a snapshot's device
    feed on (columns, dtypes, ranges), not on the scan's direction, so a
    descending index scan served after the ascending one over the same
    snapshot evaluates its predicate over the ascending feed and gathers
    the wrong rows.  The port keys feeds on the scan too and returns the
    host pipeline's rows."""
    table, snap = make_mixed(n=30_000, seed=5)
    ref = RefRunner(mesh=make_mesh(jax.devices()[:1]))
    port = DeviceRunner(device="cpu")
    psnap = port_snapshot(table, snap)
    for desc in (False, True):
        want, got, host = run_three(ref, port, _index_sel_dag(table, desc),
                                    snap, psnap)
        assert got == host
        assert (want == host) is (not desc)


def test_computed_and_real_predicates(ref, port):
    """A computed INT predicate over NULLs, a REAL predicate (values exact
    in float32), and their conjunction."""
    table, snap = make_mixed(n=20_000, seed=9)
    def mod7(s):
        return Expr.call("EqInt", Expr.call(
            "ModInt", s.col("a") + s.col("id"), Expr.const(7, EvalType.INT)),
            Expr.const(0, EvalType.INT))

    for build in (lambda s: s.where(mod7(s)),
                  lambda s: s.where(s.col("r") > 12.25),
                  lambda s: s.where(s.col("r") <= -3.5, s.col("a") < 40_000)):
        s = DagSelect.from_table(table, ["id", "a", "r"])
        want, got, host = run_three(ref, port, build(s).build(), snap,
                                    reps=4)
        assert want == host and got == want


def test_empty_scan_returns_no_rows(ref, port):
    table, snap = make_null_heavy(n=0, seed=11)
    want, got, host = run_three(ref, port, sel_dag(table, "a", 0), snap)
    assert want == host == got == []


def test_reference_device_wraps_int_selection():
    """ROADMAP.md queue 3, fault 5, on the selection route: ``k + 100 >
    0`` over 1000 rows of k = 2^31 - 10.  The reference's device wraps at
    int32 and keeps no row; the port keeps the host's 1000."""
    n = 1000
    table = Table(9101, (TableColumn("id", 1, FieldType.long(not_null=True),
                                     is_pk_handle=True),
                         TableColumn("k", 2, FieldType.long()),
                         TableColumn("v", 3, FieldType.long())))
    snap = ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64),
        {"k": np.full(n, 2**31 - 10, np.int64),
         "v": np.arange(n, dtype=np.int64) % 7})
    s = DagSelect.from_table(table, ["id", "k", "v"])
    dag = s.where((s.col("k") + 100) > 0).build()
    ref = RefRunner(mesh=make_mesh(jax.devices()[:1]))
    want, got, host = run_three(ref, DeviceRunner(device="cpu"), dag, snap)
    assert want == [] and len(host) == n
    assert got == host


@pytest.mark.parametrize("plan", ["bare_scan", "projection", "limit",
                                  "two_column_index"])
def test_host_pipeline_plans_name_item_6(plan, ref, port):
    """What the reference serves on its host pipeline, the port refuses
    with ROADMAP queue 1 item 6 (the host pipeline)."""
    table, snap = make_mixed(n=1_000, seed=17)
    s = DagSelect.from_table(table, ["id", "a", "r"])
    if plan == "bare_scan":
        dag = s.build()
    elif plan == "projection":
        dag = s.where(s.col("a") > 5).project(s.col("a")).build()
    elif plan == "limit":
        dag = s.where(s.col("a") > 5).limit(10).build()
    else:
        si = DagSelect.from_index(table, "a")
        dag = si.where(si.col("a") > 5).build()
        sc = dag.executors[0]
        cols = (sc.columns[0], table.column_info("r"), sc.columns[1])
        dag = type(dag)((IndexScanDesc(sc.table_id, sc.index_id, cols),)
                        + dag.executors[1:], dag.ranges)
    assert not ref.supports(dag)
    pdag = port_dag(dag)
    assert not port.supports(pdag)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 1 item 6"):
        port.handle_request(pdag, port_snapshot(table, snap))


# ------------------------------------------------------ the configurations

CONFIG_ROWS = 200_000


def ref_config(n, groups=configs.GROUPS):
    table, snap = bench.build_table(n, groups)
    return table, snap


@pytest.mark.parametrize("name", ["1", "2"])
def test_selection_config_matches_reference_and_truth(name, ref, port):
    """Configs 1 (its probe) and 2 at reduced size: the port, the
    reference and the numpy truth agree exactly."""
    table, snap = ref_config(CONFIG_ROWS)
    pdag = configs.ROW_CONFIGS[name][1](configs.bench_table())
    dag = wire.dec_dag(port_wire.enc_dag(pdag))
    psnap = port_snapshot(table, snap)
    truth = configs.row_truth(name, psnap)
    want = ref.handle_request(dag, snap).rows()
    got = port.handle_request(port_dag(dag), psnap).rows()
    assert want == truth
    assert got == truth
    assert configs.columns_agree(
        port.handle_request(port_dag(dag), psnap).batch,
        configs.row_truth_columns(name, psnap))


def test_sweep_takes_compact_index_and_mask(ref):
    """Config 2s at config 2's 10·2^20 rows is the CPU's too slow case;
    at 2^21 rows its 0.1%, 1%, 10% and 50% points take compact, index,
    mask and mask once warm, and every answer equals the truth and the
    reference."""
    n = 1 << 21
    table, snap = ref_config(n)
    psnap = port_snapshot(table, snap)
    port = DeviceRunner(device="cpu")
    want_route = {"0.1%": "compact", "1%": "index", "10%": "mask",
                  "50%": "mask"}
    # at 2^21 rows 1% is 21k rows: past the compact route's 16,384
    for point, frac in configs.SWEEP.items():
        thr = configs.sweep_threshold(psnap, frac)
        pdag = configs.dag_selection(configs.bench_table(), thr)
        truth = configs.row_truth("2s", psnap, thr)
        for _ in range(4):
            assert port.handle_request(pdag, psnap).rows() == truth
        got, taken = routes_of(port, lambda: port.handle_request(
            pdag, psnap).rows())
        assert taken == {want_route[point]: 1}, (point, taken)
        assert got == truth
        if point == "1%":
            assert ref.handle_request(
                wire.dec_dag(port_wire.enc_dag(pdag)), snap).rows() == truth


def test_port_builders_draw_the_benchmark_arrays():
    """Configs 1, 2 and 2s use bench.py's table; their plans are bench's
    (config 1's is its probe, bench.py:2415)."""
    _pt, psnap = configs.build_table(5000)
    _rt, rsnap = bench.build_table(5000, configs.GROUPS)
    for cid in (2, 3):
        np.testing.assert_array_equal(psnap.columns[cid].values,
                                      rsnap.columns[cid].values)
    t = bench.build_table(10, 4)[0]
    assert configs.dag_selection(configs.bench_table()).plan_key() == \
        bench._dag_selection(t, 800).plan_key()
    assert configs.dag_scan_probe(configs.bench_table()).plan_key() == \
        bench._dag_selection(t, -(10 ** 9)).plan_key()
