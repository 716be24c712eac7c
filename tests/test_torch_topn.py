"""The top-k route (scan → Selection* → TopN) of the port against the JAX
package's DeviceRunner and its host pipeline.

The same seeded snapshot and the same wire-encoded DAG go to the reference
``DeviceRunner`` on one CPU device, to the port's
``DeviceRunner(device="cpu")`` (the plain PyTorch version of
``topn_select``) and to the reference's host pipeline
(``BatchExecutorsRunner``); the row lists must be equal exactly.  REAL
order keys hold values that float32 represents exactly wherever the
reference is a witness: its device ranks float32 keys (ROADMAP.md queue 3,
fault 6), which ``test_reference_device_ties_close_real_keys`` pins.
Covered: ASC and DESC with NULLs, many ties, a limit beyond the live rows,
a selection inside, INT, REAL and computed keys, IndexScan heads in both
directions, configs 5 and 5t at reduced size, and the key contract of the
kernel's plain version.
"""

import numpy as np
import pytest

import jax
import torch

import bench
from tikv_tpu.copr.dag import IndexScanDesc, TopNDesc
from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.executors.runner import BatchExecutorsRunner
from tikv_tpu.expr import Expr
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch.copr import wire as port_wire
from tikv_tpu_torch.device import topn as tn
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.testing import configs

from tests.test_torch_selection import port_dag, port_snapshot, run_three


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def port():
    return DeviceRunner(device="cpu")


def make_table(n=20_000, seed=0, dom=50, null_share=0.2):
    """(id, k INT with NULLs, r REAL with NULLs, indexed): few distinct
    values (many ties), quarter steps exact in float32."""
    rng = np.random.default_rng(seed)
    table = Table(9200 + seed, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long(), index_id=5),
        TableColumn("r", 3, FieldType.double(), index_id=6)))
    k_ok = rng.random(n) > null_share
    r_ok = rng.random(n) > null_share
    named = {
        "k": Column(EvalType.INT, np.where(
            k_ok, rng.integers(-dom, dom, n), 0).astype(np.int64), k_ok),
        "r": Column(EvalType.REAL, np.where(
            r_ok, rng.integers(-4 * dom, 4 * dom, n) / 4.0, 0.0), r_ok),
    }
    return table, ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64), named)


def topn_dag(table, key, desc, limit, where=None):
    s = DagSelect.from_table(table, ["id", "k", "r"])
    if where is not None:
        s = s.where(where(s))
    return s.order_by(key(s), desc=desc, limit=limit).build()


KEYS = {
    "k": lambda s: s.col("k"),
    "r": lambda s: s.col("r"),
    "k_times_3_plus_id": lambda s: s.col("k") * 3 + s.col("id"),
    "r_times_2": lambda s: s.col("r") * Expr.const(2.0, EvalType.REAL),
}


@pytest.mark.parametrize("key", sorted(KEYS))
@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("limit", [1, 37, 1000])
def test_topn_matches_reference_and_host(key, desc, limit, ref, port):
    """INT, REAL and computed keys over NULLs and many ties, both
    directions: MySQL NULL order, ties by row position."""
    table, snap = make_table(seed=limit)
    dag = topn_dag(table, KEYS[key], desc, limit)
    want, got, host = run_three(ref, port, dag, snap, reps=2)
    assert want == host
    assert got == want


@pytest.mark.parametrize("desc", [True, False])
def test_topn_with_selection_and_limit_past_live_rows(desc, ref, port):
    """A selection inside the top-k keeps 60 rows; LIMIT 1000 returns
    those 60, ordered."""
    table, snap = make_table(n=30_000, seed=3)
    dag = topn_dag(table, KEYS["r"], desc, 1000,
                   where=lambda s: s.col("id") > 29_940)
    want, got, host = run_three(ref, port, dag, snap)
    assert len(want) == 59
    assert want == host and got == want


def test_topn_all_null_and_all_tied_keys(ref, port):
    """Every key NULL, or every key equal: the first rows by position."""
    n = 5_000
    for r_ok in (np.zeros(n, np.bool_), np.ones(n, np.bool_)):
        table = Table(9300 + int(r_ok[0]), (
            TableColumn("id", 1, FieldType.long(not_null=True),
                        is_pk_handle=True),
            TableColumn("k", 2, FieldType.long()),
            TableColumn("r", 3, FieldType.double())))
        snap = ColumnarTable.from_arrays(
            table, np.arange(n, dtype=np.int64),
            {"k": Column(EvalType.INT, np.full(n, 4, np.int64),
                         np.ones(n, np.bool_)),
             "r": Column(EvalType.REAL, np.where(r_ok, 2.5, 0.0), r_ok)})
        for desc in (True, False):
            for key in ("k", "r"):
                want, got, host = run_three(
                    ref, port, topn_dag(table, KEYS[key], desc, 100), snap)
                assert want == host and got == want
                assert [row[0] for row in got] == list(range(100))


@pytest.mark.parametrize("desc", [True, False])
def test_index_scan_topn(desc, port):
    """An IndexScan head in either direction feeding ORDER BY its column
    (config 5's shape): on a fresh reference runner per direction (fault
    7, test_torch_selection)."""
    table, snap = make_table(n=20_000, seed=11)
    for col in ("k", "r"):
        s = DagSelect.from_index(table, col, with_handle=True)
        dag = s.order_by(s.col(col), desc=True, limit=300).build()
        sc = dag.executors[0]
        dag = type(dag)((IndexScanDesc(sc.table_id, sc.index_id, sc.columns,
                                       desc),) + dag.executors[1:],
                        dag.ranges)
        ref = RefRunner(mesh=make_mesh(jax.devices()[:1]))
        want, got, host = run_three(ref, port, dag, snap, reps=2)
        assert want == host and got == want


def test_reference_device_ties_close_real_keys(ref, port):
    """ROADMAP.md queue 3, fault 6, on the top-k route: 100 REAL rows
    v = 0.1 + i·10^-12, ORDER BY v DESC LIMIT 5.  In float32 every value
    is 0.1: the reference's device returns ids 0-4; the port ranks float64
    keys and returns the host's 99, 98, 97, 96, 95."""
    n = 100
    table = Table(9400, (TableColumn("id", 1, FieldType.long(not_null=True),
                                     is_pk_handle=True),
                         TableColumn("v", 2, FieldType.double())))
    snap = ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64),
        {"v": 0.1 + np.arange(n) * 1e-12})
    s = DagSelect.from_table(table, ["id", "v"])
    dag = s.order_by(s.col("v"), desc=True, limit=5).build()
    want, got, host = run_three(ref, port, dag, snap)
    assert [r[0] for r in want] == [0, 1, 2, 3, 4]
    assert [r[0] for r in host] == [99, 98, 97, 96, 95]
    assert got == host


def test_limit_zero_and_empty_scan(port):
    table, snap = make_table(n=1_000, seed=13)
    psnap = port_snapshot(table, snap)
    dag = topn_dag(table, KEYS["k"], True, 0)
    assert BatchExecutorsRunner(dag, snap).handle_request().rows() == []
    assert port.handle_request(port_dag(dag), psnap).rows() == []
    table, snap = make_table(n=0, seed=14)
    dag = topn_dag(table, KEYS["r"], False, 10)
    assert port.handle_request(port_dag(dag),
                               port_snapshot(table, snap)).rows() == []


@pytest.mark.parametrize("plan", ["two_keys", "limit_past_2_14"])
def test_host_pipeline_topn_names_item_6(plan, ref, port):
    table, snap = make_table(n=1_000, seed=15)
    s = DagSelect.from_table(table, ["id", "k", "r"])
    if plan == "two_keys":
        dag = s.build()
        dag = type(dag)(dag.executors + (TopNDesc(
            ((s.col("k"), True), (s.col("r"), False)), 5),), dag.ranges)
    else:
        dag = s.order_by(s.col("k"), limit=(1 << 14) + 1).build()
    assert not ref.supports(dag)
    pdag = port_dag(dag)
    assert not port.supports(pdag)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 1 item 6"):
        port.handle_request(pdag, port_snapshot(table, snap))


# ------------------------------------------------ the plain version's keys


def test_order_keys_rank_values_nulls_and_exclusions():
    """The key order equals the value order (float64 including ±0.0 and
    ±inf; int32; int64 up to 2 of its extremes); NULLs sit below every
    value for DESC and above for ASC; dropped rows below all."""
    vals = np.array([-np.inf, -1e300, -2.5, -0.0, 0.0, 1e-300, 3.25,
                     np.inf])
    for desc in (True, False):
        key = tn.order_keys(torch.from_numpy(vals), None, None, desc, 8,
                            8).numpy()
        order = vals if desc else -vals
        assert (np.diff(key) > 0).sum() == (np.diff(order) > 0).sum()
        assert all((np.sign(np.diff(key)) == np.sign(np.diff(order))))
        ok = torch.tensor([True] * 7 + [False])
        mask = torch.tensor([False] + [True] * 7)
        key = tn.order_keys(torch.from_numpy(vals), ok, mask, desc, 8,
                            10).numpy()
        assert key[0] == tn.EXCLUDED and (key[8:] == tn.EXCLUDED).all()
        if desc:
            assert key[7] == tn.NULL_DESC and (key[1:7] > key[7]).all()
        else:
            assert key[7] == tn.NULL_ASC and (key[1:7] < key[7]).all()
    big = np.array([-2**63, -2**63 + 1, -2**63 + 2, -5, 7, 2**63 - 2,
                    2**63 - 1], np.int64)
    key = tn.order_keys(torch.from_numpy(big), None, None, True, 7, 7)
    assert (key[2:] > tn.NULL_DESC).all() and (torch.diff(key[2:]) > 0).all()
    key = tn.order_keys(torch.from_numpy(big), None, None, False, 7, 7)
    assert (key > tn.EXCLUDED).all() and (key < tn.NULL_ASC).all()
    assert (torch.diff(key[1:-1]) < 0).all()


@pytest.mark.parametrize("seed", range(4))
def test_plain_topn_is_the_stable_top_k(seed):
    """topn_plain: the min(k, n_used) best rows by (key desc, position
    asc), in row order, against a numpy lexsort."""
    rng = np.random.default_rng(seed)
    n = 3_001
    n_used, seglen = tn.segments(n, 1 << 18)
    v = torch.from_numpy(rng.integers(-20, 20, n).astype(np.int32))
    ok = torch.from_numpy(rng.random(n) > 0.3)
    mask = torch.from_numpy(rng.random(n) > 0.4)
    for desc in (True, False):
        for k in (1, 50, 5000):
            out = tn.topn_select(v, ok, mask, desc, n, n_used, seglen,
                                 k).numpy()
            key = tn.order_keys(v, ok, mask, desc, n, n_used).tolist()
            order = sorted(range(n_used), key=lambda i: (-key[i], i))
            want = np.sort(np.asarray(order[:min(k, n_used)]))
            np.testing.assert_array_equal(out[0], want)
            null = tn.NULL_DESC if desc else tn.NULL_ASC
            np.testing.assert_array_equal(
                out[1], [int(key[i] != tn.EXCLUDED) |
                         2 * int(key[i] not in (tn.EXCLUDED, null))
                         for i in want])


def test_segments_match_the_reference():
    """(n_used, seglen) as runner.py:4393-4396 and :2847 compute them."""
    import math
    for n, n_pad in ((1, 1 << 18), (5000, 1 << 18), ((1 << 17) + 1, 1 << 18),
                     (100 << 20, 9 * 12 << 20)):
        seg = math.gcd(n_pad, 1 << 17)
        n_used = min(n_pad, -(-n // seg) * seg)
        assert tn.segments(n, n_pad) == (n_used, math.gcd(n_used, 1 << 17))


def test_topn_wrapper_takes_the_plain_version_on_the_cpu_only():
    before = tn.launches
    v = torch.arange(100, dtype=torch.float64)
    out = tn.topn_select(v, None, None, True, 100, 1 << 17, 1 << 17, 3)
    assert out[0].tolist() == [97, 98, 99] and tn.launches == before
    with pytest.raises(ValueError, match="float32"):
        tn.topn_select(v.float(), None, None, True, 100, 1 << 17, 1 << 17,
                       3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tn.topn_select(v.to("meta"), None, None, True, 100, 1 << 17,
                       1 << 17, 3)
    with pytest.raises(ValueError, match="k="):
        tn.topn_select(v, None, None, True, 100, 1 << 17, 1 << 17,
                       tn.MAX_LIMIT + 1)


# ------------------------------------------------------ the configurations


@pytest.mark.parametrize("name", ["5", "5t"])
def test_topn_config_matches_reference_and_truth(name, ref, port):
    """Configs 5 (IndexScan, ORDER BY v DESC LIMIT 1000) and 5t (its table
    with NULLs, a TableScan, WHERE k < 512) at 2^18 rows: the port equals
    the numpy truth (float64 ranks).  The reference's float32 ranks agree
    here (these normal(0, 1000) values are far apart in float32 at the
    top), so it is a witness too."""
    n = 1 << 18
    table, snap = bench.build_table(n, configs.GROUPS, real_v=True)
    if name == "5t":
        valid = np.random.default_rng(7 + 2).random(n) >= configs.NULL_SHARE
        v = snap.columns[3]
        snap.columns[3] = Column(v.eval_type, np.where(valid, v.values, 0.0),
                                 valid)
    pdag = configs.ROW_CONFIGS[name][1](configs.bench_table(real_v=True))
    dag = wire.dec_dag(port_wire.enc_dag(pdag))
    psnap = port_snapshot(table, snap)
    truth = configs.row_truth(name, psnap)
    got = port.handle_request(port_dag(dag), psnap).rows()
    assert got == truth
    assert ref.handle_request(dag, snap).rows() == truth
    if name == "5":
        assert pdag.plan_key() == bench._dag_topn_index(table).plan_key()


def test_config_5t_builder_draws_the_benchmark_arrays():
    _pt, psnap = configs.build_real_null_table(5000)
    _rt, rsnap = bench.build_table(5000, configs.GROUPS, real_v=True)
    valid = np.random.default_rng(7 + 2).random(5000) >= configs.NULL_SHARE
    np.testing.assert_array_equal(psnap.columns[3].validity, valid)
    np.testing.assert_array_equal(psnap.columns[3].values,
                                  np.where(valid, rsnap.columns[3].values, 0))
    np.testing.assert_array_equal(psnap.columns[2].values,
                                  rsnap.columns[2].values)


# ------------------------------------- the kernel's digit and its routes


def unsigned_keys(values, ok, mask, desc, n, n_used):
    key = tn.order_keys(values, ok, mask, desc, n, n_used).numpy()
    return key.view(np.uint64) ^ np.uint64(1 << 63)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
@pytest.mark.parametrize("desc", [True, False])
def test_key_image_is_the_order_key(dtype, desc):
    """``key_image`` is the kernel's unsigned key: ``order_keys`` + 2^63."""
    vals = {torch.int32: [-(1 << 31), -5, 0, 7, (1 << 31) - 1],
            torch.int64: [-(1 << 63), -(1 << 63) + 1, -3, 0, (1 << 63) - 1],
            torch.float64: [-np.inf, -1e300, -0.0, 0.0, 2.5, np.inf]}[dtype]
    t = torch.tensor(vals, dtype=dtype)
    want = unsigned_keys(t, None, None, desc, len(vals), len(vals))
    assert [tn.key_image(v, dtype, desc) for v in vals] == \
        [int(x) for x in want]


@pytest.mark.parametrize("dtype,bounds", [
    (torch.int32, None), (torch.int32, (0, 1000)), (torch.int32, (-100, 99)),
    (torch.int32, (7, 7)), (torch.int64, None),
    (torch.int64, (-(1 << 62), 1 << 62)), (torch.int64, (-3, 3)),
    (torch.float64, None), (torch.float64, (-5500.25, 5499.5)),
    (torch.float64, (-0.0, 0.0)), (torch.float64, (1.5, 1.5))])
@pytest.mark.parametrize("desc", [True, False])
def test_digit_placement_covers_the_bounds_with_the_narrowest_bins(
        dtype, bounds, desc):
    """Every value within the bounds lands in the window (bins 1 to BINS -
    2), the window starts on a multiple of 2^shift, and one shift less
    would not cover it; narrow int ranges get one value per bin; ±0.0 is
    one key; NULL and excluded keys fall to the edge bins (or into the
    window only where the full key range is the window)."""
    lo, shift = tn.digit_placement(dtype, desc, bounds)
    assert lo % (1 << shift) == 0
    if bounds is None:
        bounds = {torch.int32: (-(1 << 31), (1 << 31) - 1),
                  torch.int64: (-(1 << 63), (1 << 63) - 1),
                  torch.float64: (-np.inf, np.inf)}[dtype]
    imgs = sorted(tn.key_image(b, dtype, desc) for b in bounds)
    bins = tn.bin_of(np.array(imgs, np.uint64), lo, shift)
    assert ((bins >= 1) & (bins <= tn.BINS - 2)).all()
    if shift:
        base = imgs[0] >> (shift - 1) << (shift - 1)
        assert (imgs[1] - base) >> (shift - 1) > tn.BINS - 3
    if dtype != torch.float64 and bounds[1] - bounds[0] < tn.BINS - 2:
        assert shift == 0                      # one value per bin
    if dtype == torch.float64:
        assert tn.key_image(-0.0, dtype, desc) == \
            tn.key_image(0.0, dtype, desc)
    null = tn.bin_of(np.array([0, 1 if desc else (1 << 64) - 1], np.uint64),
                     lo, shift)
    if lo > 1:
        assert null[0] == 0 and (not desc or null[1] == 0)
    if not desc and imgs[1] < (1 << 64) - (1 << shift):
        assert null[1] > bins.max() or null[1] == tn.BINS - 1


def test_bins_are_monotone_in_the_key():
    rng = np.random.default_rng(11)
    keys = np.sort(rng.integers(0, 1 << 63, 5000, dtype=np.uint64) * 2)
    for lo, shift in ((0, 53), (1 << 62, 40), (12345 << 20, 20), (77, 0)):
        bins = tn.bin_of(keys, lo - lo % (1 << shift), shift)
        assert (np.diff(bins) >= 0).all()
        assert bins.min() >= 0 and bins.max() <= tn.BINS - 1


@pytest.mark.parametrize("case", ["spread", "at_capacity", "past_capacity",
                                  "ties", "nulls_first", "few_live_rows",
                                  "default_placement"])
def test_route_and_buffer_choice(case):
    """``plan_route`` against a brute-force reading of the same bins: the
    crossing bin holds the k-th key, the candidates are every row in bins
    at or above it, and the common route is taken exactly when they fit
    ``cand_capacity(k)`` (max(4k, 2^16) rows)."""
    rng = np.random.default_rng(12)
    k, n, desc = 1000, 200_000, True
    ok = mask = None
    bounds = "data"
    if case in ("at_capacity", "past_capacity"):
        v = np.zeros(n, np.int32)
        top = tn.cand_capacity(k) + (case == "past_capacity")
        v[rng.permutation(n)[:top]] = 1000
    elif case == "ties":
        v = np.full(n, 3, np.int32)
    else:
        v = rng.integers(-100_000, 100_000, n).astype(np.int32)
    if case == "nulls_first":
        desc, ok = False, rng.random(n) < 0.5
    if case == "few_live_rows":
        mask = rng.random(n) < 0.002
    if case == "default_placement":
        v = rng.integers(-100, 100, n).astype(np.int32)
        bounds = None
    vt = torch.from_numpy(v)
    okt = None if ok is None else torch.from_numpy(ok)
    mt = None if mask is None else torch.from_numpy(mask)
    if bounds == "data":
        live = v if ok is None else v[ok]
        bounds = (int(live.min()), int(live.max()))
    n_used, _seglen = tn.segments(n, 1 << 18)
    placement = tn.digit_placement(torch.int32, desc, bounds)
    route, c, cands = tn.plan_route(vt, okt, mt, desc, n, n_used, k,
                                    placement)
    bins = tn.bin_of(unsigned_keys(vt, okt, mt, desc, n, n_used), *placement)
    kth = np.sort(bins)[::-1][min(k, n_used) - 1]
    assert c == kth and cands == int((bins >= c).sum())
    assert route == ("common" if cands <= tn.cand_capacity(k)
                     else "overflow")
    want = {"spread": "common", "at_capacity": "common",
            "past_capacity": "overflow", "ties": "overflow",
            "nulls_first": "overflow", "few_live_rows": "overflow",
            "default_placement": "overflow"}[case]
    assert route == want


def test_topn_wrapper_checks_placement_and_passes():
    v = torch.arange(100, dtype=torch.float64)
    out = tn.topn_select(v, None, None, True, 100, 1 << 17, 1 << 17, 3,
                         placement=tn.digit_placement(torch.float64, True,
                                                      (0.0, 99.0)))
    assert out[0].tolist() == [97, 98, 99]
    assert tn.cand_capacity(1000) == 1 << 16
    assert tn.cand_capacity(1 << 14) == 1 << 16
    assert tn.cand_capacity(20_000) == 80_000


@pytest.mark.parametrize("key", ["k", "r", "k_times_3_plus_id"])
@pytest.mark.parametrize("desc", [True, False])
def test_runner_places_the_digit_by_the_column_bounds(key, desc, ref,
                                                      monkeypatch):
    """A bare order column's digit sits where its valid values' least and
    greatest keys differ (memoized per snapshot); a computed order
    expression takes the dtype's default; the answer equals the
    reference's and the host pipeline's either way."""
    seen = []
    real = tn.topn_select

    def record(*args, **kw):
        seen.append((args[0].dtype, kw["placement"]))
        return real(*args, **kw)

    monkeypatch.setattr(tn, "topn_select", record)
    table, snap = make_table(seed=21)
    port = DeviceRunner(device="cpu")
    dag = topn_dag(table, KEYS[key], desc, 100)
    want, got, host = run_three(ref, port, dag, snap, reps=2)
    assert got == want == host
    dtype, placement = seen[-1]
    assert len({p for _d, p in seen}) == 1
    if key == "k_times_3_plus_id":
        assert placement == tn.digit_placement(dtype, desc)
        return
    col = snap.columns[2 if key == "k" else 3]
    live = col.values[col.validity]
    assert placement == tn.digit_placement(
        dtype, desc, (live.min().item(), live.max().item()))
