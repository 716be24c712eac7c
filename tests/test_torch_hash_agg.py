"""The port's aggregation kernel module against the TPU kernel it replaces.

The same seeded snapshot and plan go through

- the JAX package's fused Pallas kernel ``pallas_hash.build`` run in
  interpret mode on one 2^18-row block, decoded by
  ``DeviceRunner._pallas_states`` into (present, states);
- the port's ``DeviceRunner._aggregate`` on the CPU, which evaluates the
  selection and computed inputs with torch and runs ``hash_agg``'s plain
  version (the CUDA kernel's twin; the card runs ``chip_smoke.py``).

Every state is an exact integer, so every comparison is exact.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tikv_tpu.datatype import Column, EvalType, FieldType
from tikv_tpu.datatype.tile import _device_dtype
from tikv_tpu.device import pallas_hash
from tikv_tpu.device.kernels import build_layouts
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.columnar import ColumnarTable
from tikv_tpu.ops.agg import hash_agg_tile
from tikv_tpu.parallel import make_mesh
from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import Table, TableColumn

import torch

from tikv_tpu_torch.convert import dag_from_wire
from tikv_tpu_torch.device import hash_agg as ha
from tikv_tpu_torch.device.runner import DeviceRunner

B = pallas_hash.BLOCK


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def port():
    return DeviceRunner(device="cpu")


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernel in interpret mode (restored afterwards)."""
    monkeypatch.setattr(pallas_hash.pl, "pallas_call", functools.partial(
        pallas_hash.pl.pallas_call, interpret=True))


def _table():
    return Table(4242, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("v", 3, FieldType.long()),
    ))


def _snapshot(n, seed, keys=None, values=None):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1000, n) if keys is None else keys(rng, n)
    v = rng.integers(-1000, 1000, n) if values is None else values(rng, n)
    table = _table()
    ones = np.ones(n, np.bool_)
    return table, ColumnarTable.from_arrays(
        table, np.arange(n), {"k": Column(EvalType.INT, k, ones),
                              "v": Column(EvalType.INT, v, ones)})


def _dag(table, agg, where=None):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    if where is not None:
        s.where(where(s))
    group_by, aggs = agg(s)
    return s.aggregate(group_by, aggs).build()


# name → (snapshot kwargs, plan builder: (group_by, aggs), selection)
CASES = {
    "dense_bare_key": (
        dict(n=B), lambda s: ([s.col("k")], [("count_star", None),
                                             ("sum", s.col("v"))]), None),
    "dense_expr_key_null_slot": (
        dict(n=B), lambda s: ([s.col("k") + 1], [("count_star", None),
                                                 ("sum", s.col("v"))]),
        None),
    "sparse_keys": (
        dict(n=B, keys=lambda rng, n: np.sort(rng.integers(
            0, 1 << 62, 1000))[rng.integers(0, 1000, n)]),
        lambda s: ([s.col("k")], [("count_star", None),
                                  ("sum", s.col("v"))]), None),
    "simple": (
        dict(n=B), lambda s: ([], [("sum", s.col("v")), ("count_star", None),
                                   ("avg", s.col("v"))]), None),
    "selection_keeps_nothing": (
        dict(n=B), lambda s: ([s.col("k")], [("count_star", None),
                                             ("sum", s.col("v"))]),
        lambda s: s.col("v") > 5000),
    "ragged_n": (
        dict(n=B - 12345), lambda s: ([s.col("k")], [("count_star", None),
                                                     ("sum", s.col("v"))]),
        lambda s: s.col("v") > -900),
    "count_sum_avg": (
        dict(n=B), lambda s: ([s.col("k")], [
            ("count", s.col("v") * 2), ("sum", s.col("v")),
            ("avg", s.col("v")), ("count_star", None)]),
        lambda s: s.col("k") < 500),
    "4096_slots": (
        dict(n=B, keys=lambda rng, n: rng.integers(0, 4096, n)),
        lambda s: ([s.col("k")], [("count_star", None),
                                  ("sum", s.col("v"))]), None),
}

# Plans whose SUM/AVG argument needs 4 value bytes: values at ±(2^31-1),
# and every computed argument (its byte width is the int32 dtype's).
XLA_CASES = {
    "int32_extremes": (
        dict(n=B, values=lambda rng, n: np.where(
            rng.integers(0, 2, n) == 1, 2**31 - 1, -(2**31 - 1))),
        lambda s: ([s.col("k")], [("count_star", None), ("sum", s.col("v")),
                                  ("avg", s.col("v"))]), None),
    "computed_sum_args": (
        dict(n=B), lambda s: ([s.col("k")], [
            ("count", s.col("v") * 2), ("sum", s.col("v") * 2),
            ("avg", s.col("v") - 3), ("count_star", None)]),
        lambda s: s.col("k") < 500),
}


def _host_cols(snap, plan, dag):
    batch = snap.scan_columns(plan.scan, dag.ranges)
    out = []
    for ci in plan.used_cols:
        col = batch.columns[ci]
        dt = _device_dtype(col.eval_type, col.values)
        out.append((col.values.astype(dt), col.validity))
    return out


def _layout(ref, dag, snap):
    """Reference plan, host columns, kernel mode and key layout, as
    ``_run_hash``/``_run_simple`` derive them."""
    plan = ref._analyze(dag)
    host = _host_cols(snap, plan, dag)
    n = len(snap.handles)
    if plan.kind == "simple_agg":
        return plan, host, n, "simple", 0, 1, 1, None
    kv, km = pallas_hash.eval_rpn(plan.key_rpn, host, n, np)
    kv = np.broadcast_to(kv, (n,))[np.broadcast_to(km, (n,))]
    base, span = int(kv.min()), int(kv.max()) - int(kv.min()) + 1
    if span > ref._max_hash_capacity:
        got = ref._sparse_slots(plan, lambda: host, n, {"n_pad": B}, {})
        uniq, _nd, capacity, slot_dev = got
        return plan, host, n, "sparse", base, capacity, capacity + 2, \
            (uniq, np.asarray(slot_dev))
    capacity = max(1024, 1 << (span - 1).bit_length())
    return plan, host, n, "dense", base, capacity, capacity + 2, None


def _reference_states(ref, dag, snap):
    plan, host, n, mode, base, capacity, slots, sparse = _layout(
        ref, dag, snap)
    feed = {"null_flags": tuple(not ok.all() for _, ok in host),
            "n_pad": B}
    arg_nbytes = ref._arg_nbytes(plan, host, n)
    ok_is_mask = ref._arg_ok_is_mask(plan, feed)
    layouts, p8, pf = build_layouts(plan.specs, [False] * len(plan.specs),
                                    arg_nbytes, ok_is_mask)
    assert pallas_hash.supported(plan, feed, [str(v.dtype) for v, _ in host],
                                 pf, capacity, 1, mode)
    kset = set(pallas_hash.kernel_col_ids(plan, mode))
    col_map, cols = [], []
    for i, (v, _ok) in enumerate(host):
        if i in kset:
            col_map.append(len(cols))
            padded = np.zeros(B, np.int32)
            padded[:n] = v
            cols.append(jnp.asarray(padded))
        else:
            col_map.append(-1)
    if sparse is not None:
        cols.append(jnp.asarray(sparse[1]))
    run, LO, _HI = pallas_hash.build(plan, layouts, p8, capacity, 1,
                                     tuple(col_map), mode=mode)
    # the sparse body never reads ``base``, but ``run`` packs it into an
    # int32 scalar, which a key minimum beyond int32 overflows
    # (pallas_hash.py:381; the reference runner then disables the kernel)
    packed = np.asarray(run(0, n, 0 if mode == "sparse" else base, 0,
                            tuple(cols)))
    return RefRunner._pallas_states(packed, LO, p8, layouts, plan.specs,
                                    slots)


def _port_states(ref, port, dag, snap):
    plan, host, n, mode, base, capacity, slots, sparse = _layout(
        ref, dag, snap)
    pplan, why = port._analyze(dag_from_wire(wire.enc_dag(dag)))
    assert pplan is not None, why
    feed = port._build_flat(host, n)
    slot_ids = None
    if sparse is not None:
        slot_ids = torch.from_numpy(np.array(sparse[1]))
    n_sl = ha.n_slots(pplan, capacity, mode)
    assert ha.supported(pplan, feed, [str(v.dtype) for v, _ in host],
                        capacity, mode)
    return port._aggregate(pplan, feed, n, mode, base, capacity, slots,
                           n_sl, slot_ids)


def _assert_same(got, want):
    (p1, s1), (p2, s2) = got, want
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    assert len(s1) == len(s2)
    for a, b in zip(s1, s2):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key], np.int64),
                                          np.asarray(b[key], np.int64),
                                          err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel(case, ref, port, interpret):
    snap_kw, agg, where = CASES[case]
    table, snap = _snapshot(seed=hash(case) % 1000, **snap_kw)
    dag = _dag(table, agg, where)
    want = _reference_states(ref, dag, snap)
    got = _port_states(ref, port, dag, snap)
    _assert_same(got, want)
    if case != "selection_keeps_nothing":
        assert np.asarray(got[0]).any()


@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_plain_matches_reference_xla_tile(case, ref, port, interpret):
    """A SUM/AVG argument that needs 4 value bytes cannot go through the
    Pallas kernel (``_i32(1 << 31)`` overflows, pallas_hash.py:336): the
    reference runner disables the kernel for such a plan and serves it on
    its XLA path (runner.py:4084-4111), whose tile kernel
    ``hash_agg_tile`` is the oracle here."""
    snap_kw, agg, where = XLA_CASES[case]
    table, snap = _snapshot(seed=5, **snap_kw)
    dag = _dag(table, agg, where)
    with pytest.raises(OverflowError):
        _reference_states(ref, dag, snap)
    plan, host, n, mode, base, capacity, slots, _ = _layout(ref, dag, snap)
    jax_pairs = [(jnp.asarray(v), jnp.asarray(ok)) for v, ok in host]
    key = pallas_hash.eval_rpn(plan.key_rpn, jax_pairs, n, jnp)
    cols = [None if r is None else
            pallas_hash.eval_rpn(r, jax_pairs, n, jnp) for r in plan.agg_rpns]
    from tikv_tpu.ops.agg import AggSpec
    specs = [AggSpec(s.kind, i, s.eval_type)
             for i, s in enumerate(plan.specs)]
    mask = None
    for r in plan.sel_rpns:
        v, ok = pallas_hash.eval_rpn(r, jax_pairs, n, jnp)
        m = ok & (v != 0)
        mask = m if mask is None else mask & m
    tile = hash_agg_tile(jnp, specs, key, cols, capacity, base,
                         row_mask=mask)
    want = (np.asarray(tile["present"]),
            [{k: np.asarray(v) for k, v in s.items()}
             for s in tile["states"]])
    got = _port_states(ref, port, dag, snap)
    _assert_same(got, want)
    if case == "int32_extremes":
        assert int(np.asarray(got[1][1]["sum"]).max()) > 2**31


@pytest.mark.parametrize("case", ["ok", "nulls", "int64", "4097_slots"])
def test_gate_matches_pallas_gate(case, ref, port):
    """``hash_agg.supported`` refuses exactly what ``pallas_hash.supported``
    refuses, for integer-sum plans."""
    n = 4096
    keys, values = None, None
    if case == "int64":
        values = lambda rng, n: rng.integers(-(2**40), 2**40, n)  # noqa: E731
    table, snap = _snapshot(n, 3, keys=keys, values=values)
    if case == "nulls":
        snap.columns[3].validity[::7] = False
    agg = (lambda s: ([s.col("k") * 5], [("count_star", None),
                                         ("sum", s.col("v"))])) \
        if case == "4097_slots" else \
        (lambda s: ([s.col("k")], [("count_star", None),
                                   ("sum", s.col("v"))]))
    dag = _dag(table, agg)
    plan = ref._analyze(dag)
    pplan, _ = port._analyze(dag_from_wire(wire.enc_dag(dag)))
    host = _host_cols(snap, plan, dag)
    dtypes = [str(v.dtype) for v, _ in host]
    feed = {"null_flags": tuple(not ok.all() for _, ok in host), "n_pad": B}
    capacity = 4096
    want = pallas_hash.supported(plan, feed, dtypes, 0, capacity, 1, "dense")
    assert ha.supported(pplan, feed, dtypes, capacity, "dense") == want
    assert want == (case == "ok")


def test_lane_split_over_launch_groups():
    """Shared memory bounds the lanes per launch; the split is exact."""
    assert ha.lanes_per_launch(4096, 232448) == 4
    assert ha.lanes_per_launch(1024, 232448) == ha.MAX_LANES
    assert ha.lanes_per_launch(1, 232448) == ha.MAX_LANES
    with pytest.raises(ValueError):
        ha.lanes_per_launch(1 << 16, 232448)
