"""The port's device join (``device/join_probe.py``, the plain version of
``csrc/join.cu``, and ``device/join.py`` ``DeviceJoiner.join``) against
the JAX package's ``_probe_kernel`` and ``DeviceJoiner.join`` on one CPU
device.

The same seeded snapshots go to both: duplicate build keys, NULL keys on
both sides, keys at int64.max (the sentinel), empty sides, probe
predicates that ``sel_pred`` covers and ones it does not (the torch
route: INT DIV, a REAL column), and a multiplicity that overflows the
first pair capacity and takes the re-dispatch.  Pairs and totals are
integers: equal exactly (tolerance 0).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tikv_tpu.codec.keys import table_record_range
from tikv_tpu.copr.dag import TableScanDesc
from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.executors.ranges import KeyRange
from tikv_tpu.expr import Expr
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire
from tikv_tpu.testing.fixture import Table, TableColumn

from tikv_tpu_torch import convert
from tikv_tpu_torch.copr import dag as pdag
from tikv_tpu_torch.datatype import FieldType as PortFieldType
from tikv_tpu_torch.device import join_probe as jp
from tikv_tpu_torch.device import sort as srt
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.executors.ranges import KeyRange as PortKeyRange

I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.fixture
def port():
    return DeviceRunner(device="cpu")


# ------------------------------------------------------- the probe kernel

PROBE_CASES = [
    # (probe rows, build rows, key domain, NULL share, k_cap)
    (2000, 300, 200, 0.1, 4096), (2000, 300, 200, 0.1, 64),
    (1000, 120, 1, 0.0, 1 << 17), (1000, 120, 1, 0.0, 1000),
    (1, 1, 1, 0.0, 64), (500, 64, 4, 0.5, 64), (3000, 1, 2, 0.2, 8192),
    (777, 500, 10 ** 9, 0.0, 1024),
]


@pytest.mark.parametrize("npr,nb,dom,null_p,k_cap", PROBE_CASES)
def test_join_probe_matches_reference_kernel(ref, npr, nb, dom, null_p,
                                             k_cap):
    """join_probe's pairs and total equal the reference _probe_kernel on
    the same dictionary (the reference's own build kernel), a k_cap below
    the total included: the pairs that fit, -1 past them, the exact
    total.  The mask folds into the reference's key validity."""
    from tikv_tpu.device.join import DeviceJoiner as RefJoiner
    rj = RefJoiner(ref)
    rng = np.random.default_rng(npr + nb + k_cap)
    bk = rng.integers(0, dom, nb).astype(np.int64)
    bk[rng.random(nb) < 0.05] = I64.max
    bvalid = rng.random(nb) >= null_p
    pk = rng.integers(0, dom, npr).astype(np.int64)
    pk[rng.random(npr) < 0.05] = I64.max
    pvalid = rng.random(npr) >= null_p
    mask = rng.random(npr) < 0.7
    sk, perm, prefix = rj._build_kernel(nb)(
        jnp.asarray(nb, jnp.int64), jnp.asarray(bk), jnp.asarray(bvalid))
    fn = rj._probe_kernel(npr, nb, k_cap, [], ((), ()), 0)
    pi, bi, tot = fn(jnp.asarray(npr, jnp.int64), sk, perm, prefix,
                     jnp.asarray(pk), jnp.asarray(pvalid & mask))
    built = srt.join_build(torch.from_numpy(bk), torch.from_numpy(bvalid),
                           nb)
    pairs, total = jp.join_probe(*built[:3], torch.from_numpy(pk),
                                 torch.from_numpy(pvalid),
                                 torch.from_numpy(mask), k_cap)
    assert int(total) == int(tot)
    np.testing.assert_array_equal(pairs[:, 0].numpy(), np.asarray(pi))
    np.testing.assert_array_equal(pairs[:, 1].numpy(), np.asarray(bi))


def test_join_probe_empty_sides():
    sk, perm, prefix, keys = srt.join_build(
        torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool),
        0)
    assert prefix.tolist() == [0] and keys.n_valid == 0
    pairs, total = jp.join_probe(sk, perm, prefix,
                                 torch.arange(5, dtype=torch.int64), None,
                                 None, 64)
    assert int(total) == 0 and (pairs == -1).all()
    built = srt.join_build(torch.arange(3, dtype=torch.int64),
                           torch.ones(3, dtype=torch.bool), 3)
    pairs, total = jp.join_probe(*built[:3],
                                 torch.zeros(0, dtype=torch.int64), None,
                                 None, 64)
    assert int(total) == 0 and pairs.shape == (64, 2)


def test_join_probe_checks_its_inputs():
    built = srt.join_build(torch.arange(3, dtype=torch.int64),
                           torch.ones(3, dtype=torch.bool), 3)
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="k_cap"):
        jp.join_probe(*built[:3], k, None, None, 0)
    with pytest.raises(ValueError, match="bool"):
        jp.join_probe(*built[:3], k, None, k, 64)
    with pytest.raises(ValueError, match="int64"):
        jp.join_probe(*built[:3], k.to(torch.int32), None, None, 64)


# --------------------------------------------------- DeviceJoiner.join


def _tables(seed, n_probe, n_build, key_hi=200, null_p=0.1, real=False):
    """(reference probe table + snapshot, build table + snapshot)."""
    rng = np.random.default_rng(seed)
    pt = Table(9500 + seed, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("v", 3, FieldType.double() if real
                    else FieldType.long())))
    v = rng.normal(0, 50, n_probe) if real else \
        rng.integers(-100, 100, n_probe).astype(np.int64)
    psnap = ColumnarTable.from_arrays(pt, np.arange(n_probe), {
        "k": Column(EvalType.INT,
                    rng.integers(0, key_hi, n_probe).astype(np.int64),
                    rng.random(n_probe) > null_p),
        "v": Column(EvalType.REAL if real else EvalType.INT, v,
                    rng.random(n_probe) > null_p)})
    bt = Table(9600 + seed, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("bk", 2, FieldType.long()),
        TableColumn("w", 3, FieldType.long())))
    bsnap = ColumnarTable.from_arrays(bt, np.arange(n_build), {
        "bk": Column(EvalType.INT,
                     rng.integers(0, key_hi, n_build).astype(np.int64),
                     rng.random(n_build) > null_p),
        "w": Column(EvalType.INT,
                    rng.integers(0, 50, n_build).astype(np.int64),
                    np.ones(n_build, np.bool_))})
    return (pt, psnap), (bt, bsnap)


def _port_snap(table, snap):
    ptable = convert.table_from_wire(table.table_id, [
        (c.name, c.col_id, wire.enc_field_type(c.field_type),
         c.is_pk_handle) for c in table.columns])
    return convert.snapshot_from_arrays(ptable, snap.handles, {
        c.name: (snap.columns[c.col_id].eval_type.value,
                 snap.columns[c.col_id].values,
                 snap.columns[c.col_id].validity)
        for c in table.columns if c.col_id in snap.columns})


def _scan(table):
    return TableScanDesc(table.table_id, tuple(table.column_info(c.name)
                                               for c in table.columns))


def _port_scan(scan):
    return convert.dag_from_wire(wire.enc_dag(_dag_of(scan))).executors[0]


def _dag_of(scan):
    from tikv_tpu.copr.dag import DAGRequest
    return DAGRequest((scan,), ())


def _ranges(table):
    s, e = table_record_range(table.table_id)
    return (KeyRange(s, e),), (PortKeyRange(s, e),)


def _conds(kind):
    v = Expr.column(2, EvalType.INT)
    if kind == "none":
        return ()
    if kind == "covered":           # sel_pred evaluates it
        return (v > Expr.const(0, EvalType.INT),)
    if kind == "uncovered":         # INT DIV: the torch route
        return (Expr.call("IntDivideInt", v, Expr.const(3, EvalType.INT))
                > Expr.const(5, EvalType.INT),)
    if kind == "real":              # a float64 plane: the torch route
        return (Expr.column(2, EvalType.REAL) >
                Expr.const(0.5, EvalType.REAL),)
    raise ValueError(kind)


def _port_conds(conds):
    from tikv_tpu_torch.copr.wire import dec_expr
    return tuple(dec_expr(wire.enc_expr(c)) for c in conds)


def _both(ref, port, probe, build, conds):
    (pt, psnap), (bt, bsnap) = probe, build
    pscan, bscan = _scan(pt), _scan(bt)
    (rpr, ppr), (rbr, pbr) = _ranges(pt), _ranges(bt)
    from tikv_tpu.device.join import DeviceJoiner as RefJoiner
    want = RefJoiner(ref).join(pscan, rpr, psnap, conds, 1, bscan, rbr,
                               bsnap, 1)
    got = port.joiner().join(_port_scan(pscan), ppr, _port_snap(pt, psnap),
                             _port_conds(conds), 1, _port_scan(bscan), pbr,
                             _port_snap(bt, bsnap), 1)
    return want, got


JOIN_CASES = [
    # (seed, probe rows, build rows, key domain, NULL share, predicate)
    (1, 2000, 300, 200, 0.1, "none"), (2, 2000, 300, 200, 0.1, "covered"),
    (3, 1500, 200, 200, 0.5, "covered"), (4, 1500, 200, 4, 0.0, "none"),
    (5, 1200, 150, 50, 0.1, "uncovered"), (6, 0, 100, 50, 0.1, "none"),
    (7, 500, 0, 50, 0.1, "covered"), (8, 0, 0, 50, 0.1, "none"),
]


@pytest.mark.parametrize("seed,npr,nb,dom,null_p,cond", JOIN_CASES)
def test_device_join_matches_reference(ref, port, seed, npr, nb, dom,
                                       null_p, cond):
    probe, build = _tables(seed, npr, nb, dom, null_p)
    want, got = _both(ref, port, probe, build, _conds(cond))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int64


def test_device_join_real_predicate_takes_torch_route(ref, port):
    probe, build = _tables(9, 1500, 200, real=True)
    want, got = _both(ref, port, probe, build, _conds("real"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert port.joiner().device_joins == 1


def test_device_join_sentinel_keys(ref, port):
    """Keys at int64.max on both sides join exactly (the build side's
    NULL rows share that sentinel but never match)."""
    (pt, psnap), (bt, bsnap) = _tables(10, 64, 64, key_hi=2)
    psnap.columns[2].values[:8] = I64.max
    bsnap.columns[2].values[:4] = I64.max
    want, got = _both(ref, port, (pt, psnap), (bt, bsnap), ())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 0


@pytest.mark.parametrize("route", ["dense", "sparse"])
def test_device_join_routes_match_reference(ref, port, route):
    """DeviceJoiner.join on the CPU, the build keys dense (0..199) or
    spread by 10^9 (sparse), NULLs on both sides: the same pairs as the
    reference's join, and the route counted."""
    (pt, psnap), (bt, bsnap) = _tables(21, 2000, 300, key_hi=200)
    if route == "sparse":
        psnap.columns[2].values[:] *= 10 ** 9
        bsnap.columns[2].values[:] *= 10 ** 9
    want, got = _both(ref, port, (pt, psnap), (bt, bsnap), ())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 0
    assert port.joiner().stats()["probe_routes"] == {route: 1}


def test_device_join_overflow_redispatch(ref, port):
    """One key on both sides: 120k pairs overflow the first capacity
    (next_pow2(1000·1.5 + 64)); the exact total re-dispatches once and
    the pairs equal the reference's."""
    (pt, psnap), (bt, bsnap) = _tables(11, 1000, 120, key_hi=1,
                                       null_p=0.0)
    joiner = port.joiner()
    want, got = _both(ref, port, (pt, psnap), (bt, bsnap), ())
    assert len(got[0]) == 120_000
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert joiner.overflow_redispatches == 1


def test_device_join_predicates_in_turn_on_one_snapshot(ref, port):
    """Different predicates over the same column, in turn on one port
    snapshot (so on one cached probe entry), each equal to the reference's
    join: the cached planes never carry an earlier request's predicate."""
    from tikv_tpu.device.join import DeviceJoiner as RefJoiner
    (pt, psnap), (bt, bsnap) = _tables(14, 1500, 200)
    p, b = _port_snap(pt, psnap), _port_snap(bt, bsnap)
    pscan, bscan = _scan(pt), _scan(bt)
    (rpr, ppr), (rbr, pbr) = _ranges(pt), _ranges(bt)
    v = Expr.column(2, EvalType.INT)
    j = port.joiner()
    sizes = set()
    for conds in ((v > Expr.const(0, EvalType.INT),),
                  (v > Expr.const(50, EvalType.INT),),
                  (v < Expr.const(0, EvalType.INT),),
                  _conds("uncovered"), (v > Expr.const(0, EvalType.INT),)):
        want = RefJoiner(ref).join(pscan, rpr, psnap, conds, 1, bscan, rbr,
                                   bsnap, 1)
        got = j.join(_port_scan(pscan), ppr, p, _port_conds(conds), 1,
                     _port_scan(bscan), pbr, b, 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        sizes.add(len(got[0]))
    assert len(sizes) >= 4
    assert (j.build_cache_builds, j.build_cache_hits) == (1, 4)


def test_build_cache_per_snapshot_version(port):
    """The dictionary is built once per (snapshot, version): a rerun hits
    the cache, a version bump re-sorts from the new host truth, and the
    entries die with their snapshot."""
    import gc
    (pt, psnap), (bt, bsnap) = _tables(12, 600, 200)
    p, b = _port_snap(pt, psnap), _port_snap(bt, bsnap)
    pscan, bscan = _port_scan(_scan(pt)), _port_scan(_scan(bt))
    (_, ppr), (_, pbr) = _ranges(pt), _ranges(bt)
    j = port.joiner()

    def run():
        return j.join(pscan, ppr, p, (), 1, bscan, pbr, b, 1)

    first = run()
    second = run()
    assert (j.build_cache_builds, j.build_cache_hits) == (1, 1)
    for x, y in zip(first, second):
        np.testing.assert_array_equal(x, y)
    b.columns[2].values[:50] = 999
    b.feed_version = 2
    third = run()
    assert j.build_cache_builds == 2
    keys = b.columns[2].values
    bvalid = b.columns[2].validity
    assert np.all(keys[third[1]] == p.columns[2].values[third[0]])
    assert bvalid[third[1]].all()
    assert len(j._cache) == 2
    del b, p
    gc.collect()
    assert len(j._cache) == 0


def test_join_supported_envelope():
    from tikv_tpu_torch.device.join import join_supported
    (pt, _), (bt, _) = _tables(13, 1, 1)
    pscan, bscan = _port_scan(_scan(pt)), _port_scan(_scan(bt))
    assert join_supported(pscan, (), 1, bscan, 1)
    assert join_supported(pscan, (), 0, bscan, 0)      # the handles
    desc = pdag.TableScanDesc(pscan.table_id, pscan.columns, desc=True)
    assert not join_supported(desc, (), 1, bscan, 1)
    assert not join_supported(pscan, (), 5, bscan, 1)
    real = pdag.TableScanDesc(pscan.table_id, tuple(
        pdag.ColumnInfo(c.col_id, PortFieldType.double() if i == 1
                        else c.field_type, c.is_pk_handle)
        for i, c in enumerate(pscan.columns)))
    assert not join_supported(real, (), 1, bscan, 1)
