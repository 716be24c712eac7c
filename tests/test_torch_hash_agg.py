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
    """Shared memory bounds the lanes per launch: 8-byte packed cells, one
    per slot kept for the row count (232,448 B is the H100's opt-in)."""
    assert ha.lanes_per_launch(4096, 232448) == 6
    assert ha.lanes_per_launch(1024, 232448) == ha.MAX_LANES
    assert ha.lanes_per_launch(1, 232448) == ha.MAX_LANES
    with pytest.raises(ValueError):
        ha.lanes_per_launch(1 << 16, 232448)


# ---------------------------------------------------------------------------
# the CUDA launcher's plan, reached without a card
# ---------------------------------------------------------------------------

H100_SMEM = 232448          # opt-in shared memory per block (H100)


def _planes(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32))
    a = torch.from_numpy(rng.random(n) < 0.5)
    b = torch.from_numpy(rng.random(n) < 0.3)
    return v, a, b


# layout name → (the lanes as a function of (v, a, b), distinct lanes, of,
# vsrc, osrc)
LANE_PLANS = {
    "config_3_sum_avg_one_plane": (
        lambda v, a, b: [ha.Lane(values=v), ha.Lane(values=v)],
        1, [0, 0], [0], [0]),
    "one_plane_two_validities": (
        lambda v, a, b: [ha.Lane(values=v, ok=a), ha.Lane(values=v, ok=b),
                         ha.Lane(values=v, ok=a), ha.Lane(ok=b)],
        3, [0, 1, 0, 2], [0, 0, 2], [0, 1, 1]),
    "empty_lane_and_count": (
        lambda v, a, b: [ha.Lane(), ha.Lane(ok=a), ha.Lane(values=v.clone())],
        2, [-1, 0, 1], [0, 1], [0, 1]),
}


@pytest.mark.parametrize("layout", sorted(LANE_PLANS))
def test_lane_plan_reads_each_plane_once(layout):
    """Lanes over one tensor are one distinct lane; distinct lanes that
    share a values (validity) plane load it once (``plane_sources``)."""
    build, distinct, of, vsrc, osrc = LANE_PLANS[layout]
    plan = ha.plan_lanes(build(*_planes()))
    assert len(plan.lanes) == distinct and plan.of == of
    assert ha.plane_sources(plan.lanes) == (vsrc, osrc)


@pytest.mark.parametrize("mode", ["dense", "sparse", "simple"])
def test_repeated_lanes_equal_distinct_copies(mode):
    """``hash_agg`` on the CPU with repeated lanes equals the same call
    with every lane a copy of its own."""
    n = 4096
    v, a, b = _planes(n, 1)
    k = torch.from_numpy(np.random.default_rng(2).integers(
        0, 1026, n).astype(np.int32))
    kw = dict(mode=mode, n=n, slots=1026, n_slots=1025, key=k,
              capacity=1024, device="cpu")
    lanes = [ha.Lane(values=v, ok=a), ha.Lane(values=v),
             ha.Lane(values=v, ok=a), ha.Lane(ok=b), ha.Lane(values=v)]
    copies = [ha.Lane(None if ln.values is None else ln.values.clone(),
                      None if ln.ok is None else ln.ok.clone())
              for ln in lanes]
    assert len(ha.plan_lanes(copies).lanes) == len(lanes)
    c1, o1 = ha.hash_agg(lanes=lanes, **kw)
    c2, o2 = ha.hash_agg(lanes=copies, **kw)
    assert torch.equal(c1, c2)
    for x, y in zip(o1, o2):
        for s, t in zip(x, y):
            assert (s is None) == (t is None)
            assert s is None or torch.equal(s, t)


def test_config_3_launch_reads_its_plane_once(port):
    """Config 3 (SUM(v), COUNT(*), AVG(v)): the runner passes two lanes over
    one plane; the launch gets one lane and one values pointer, on the
    split-free simple kernel, with the runner's 2-byte value width."""
    from tikv_tpu_torch.device import runner as rmod
    from tikv_tpu_torch.testing import configs
    table, snap = configs.build_table(4096)
    seen = []
    real = rmod.ha.hash_agg

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    rmod.ha.hash_agg = record
    try:
        port.handle_request(configs.dag_simple_agg(table), snap)
    finally:
        rmod.ha.hash_agg = real
    (args, kw), = seen
    lanes = kw["lanes"]
    assert args[0] == "simple" and kw["value_bytes"] == 2
    assert len(lanes) == 2 and lanes[0].values is lanes[1].values
    plan = ha.plan_lanes(lanes)
    launch, = ha.plan_launches("simple", 1, plan.lanes, H100_SMEM, 2)
    assert len(launch.lanes) == 1 and launch.count
    count = torch.zeros(1, dtype=torch.int64)
    outs = [(torch.zeros(1, dtype=torch.int64), None)]
    geo = ha.geometry("simple", 4096, 1, 2, 1056)
    p = ha._params("simple", 4096, None, None, None, 0, 0, 1, launch, outs,
                   count, geo)
    assert [x for x in p.values if x] == [lanes[0].values.data_ptr()]
    assert p.n_lanes == 1 and p.vec == 1 and p.head == 0


def test_config_3_lane_layout_matches_pallas_kernel(ref, port, interpret):
    """Config 3's plan and data (SUM(v), COUNT(*), AVG(v); seed 7) over one
    2^18-row block: the Pallas kernel in interpret mode, the port's runner
    and the plain version on the runner's lanes (two over one plane) agree
    exactly."""
    from tikv_tpu_torch.testing import configs
    _t, psnap = configs.build_table(B)
    k, v = psnap.columns[2].values, psnap.columns[3].values
    table, snap = _snapshot(B, 0, keys=lambda _r, _n: k,
                            values=lambda _r, _n: v)
    dag = _dag(table, lambda s: ([], [("sum", s.col("v")),
                                      ("count_star", None),
                                      ("avg", s.col("v"))]))
    want = _reference_states(ref, dag, snap)
    _assert_same(_port_states(ref, port, dag, snap), want)
    vt = torch.from_numpy(v.astype(np.int32))
    count, outs = ha.hash_agg_plain(
        "simple", B, 1, 1, lanes=[ha.Lane(values=vt), ha.Lane(values=vt)])
    total, star, avg = want[1]            # SUM(v), COUNT(*), AVG(v)
    assert int(np.asarray(star["count"])[0]) == int(count[0]) == B
    assert int(np.asarray(total["sum"])[0]) == int(outs[0][0][0]) == \
        int(np.asarray(avg["sum"])[0]) == int(outs[1][0][0]) == int(v.sum())


@pytest.mark.parametrize("value_bytes", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("fmt", ["packed", "split"])
def test_rows_per_fold_keep_every_field_exact(fmt, value_bytes):
    """Rows a block may add between folds, by value width: ``packed``
    2^15 rows for int32 values (47 bits of sum, 17 of count), more for
    narrower ones; ``split`` 2^16 rows for 2-byte values (an int32 sum
    cell); the count and sum fields hold what those rows can add."""
    if fmt == "split" and value_bytes > 2:
        with pytest.raises(ValueError):
            ha.geometry("dense", 1 << 20, 1, value_bytes, 1056, fmt)
        return
    k = ha.fold_bits(value_bytes, fmt)
    rows = 1 << k
    if fmt == "packed":
        assert k == {0: 31, 1: 27, 2: 23, 3: 19, 4: 15}[value_bytes]
        shift = ha.cell_shift(value_bytes)
        assert rows * ((1 << 8 * value_bytes) - 1) < 1 << shift
        assert rows < 1 << (64 - shift)
    else:
        assert k == {0: 32, 1: 24, 2: 16}[value_bytes]
        half = 1 << (8 * value_bytes - 1) if value_bytes else 0
        assert rows * half <= 1 << 31 and rows <= 1 << 32
    geo = ha.geometry("dense", (1 << 31) + 1, 1, value_bytes, 1056, fmt)
    # a block adds fold_every tiles and at most 3 head rows between folds
    assert geo.fold_every >= 1
    assert geo.fold_every * ha.tile_rows("dense", 1) + 3 < rows


@pytest.mark.parametrize("n", [1, 2047, 2048, 4097, (1 << 31) + 1])
def test_geometry_grid_caps_at_resident_blocks(n):
    """One block per tile up to the blocks the card holds at once; ``n``
    up to 2^31 + 1 as an integer (nothing is allocated)."""
    for mode, lanes in (("dense", 1), ("dense", 6), ("simple", 1)):
        tile = ha.tile_rows(mode, lanes)
        geo = ha.geometry(mode, n, lanes, 4, 528)
        assert geo.grid == min(-(-n // tile), 528)
        # every block strides over the tiles, so the last block's rows are
        # within one tile of the first's
        tiles = -(-n // tile)
        assert -(-tiles // geo.grid) - tiles // geo.grid <= 1
    with pytest.raises(ValueError):
        ha.geometry("dense", n, 1, 4, 0)


@pytest.mark.parametrize("case", ["aligned", "int_off_by_1", "bool_off_by_3",
                                  "phases_differ", "int_misaligned"])
def test_row_phase(case):
    """Rows read one by one before every plane sits on its vector
    boundary: int32 planes on 16 bytes, bool planes on 4."""
    base = 1 << 20
    ints, bools, want = {
        "aligned": ([base, base + 64], [base + 8], 0),
        "int_off_by_1": ([base + 4, base + 68], [base + 1], 3),
        "bool_off_by_3": ([base + 12], [base + 3, base + 7], 1),
        "phases_differ": ([base + 4], [base + 2], None),
        "int_misaligned": ([base + 2], [], ValueError),
    }[case]
    if want is ValueError:
        with pytest.raises(ValueError):
            ha.row_phase(ints, bools)
    else:
        assert ha.row_phase(ints, bools) == want


def test_cell_format_and_launch_split():
    """32-bit split cells where values fit 2 bytes and every lane fits one
    table; else packed 64-bit cells, split over launches by lanes."""
    v, a, _b = _planes()
    one = [ha.Lane(values=v)]
    assert ha.cell_format(1024, one, 2, H100_SMEM) == "split"
    assert ha.cell_format(1024, one, 4, H100_SMEM) == "packed"
    launch, = ha.plan_launches("dense", 1024, one, H100_SMEM, 2)
    assert launch.cells == [("sum", 0), ("rows", -1)]
    assert launch.smem == 12 * 1024 * 2
    eight = [ha.Lane(values=v.clone(), ok=a.clone()) for _ in range(8)]
    assert ha.cell_format(4096, eight, 2, H100_SMEM) == "packed"
    first, second = ha.plan_launches("dense", 4096, eight, H100_SMEM, 2)
    assert (len(first.lanes), len(second.lanes)) == (6, 2)
    assert first.count and not second.count
    assert first.n_cells == 7 and first.smem <= H100_SMEM
    launch, = ha.plan_launches("dense", 1024, one, H100_SMEM, 4)
    assert launch.fmt == "packed" and launch.row_lane == 0 and \
        launch.n_cells == 1


HOT = 1 << 18


def _hot_values():
    rng = np.random.default_rng(17)
    return np.where(rng.random(HOT) < 0.5, 2**31 - 1,
                    -(2**31 - 1)).astype(np.int32)


@pytest.mark.parametrize("mode", ["dense", "sparse", "simple"])
def test_hot_slot_int32_extremes(mode):
    """Every row in one slot, values at ±(2^31 - 1): the plain version's
    int64 states equal numpy's exactly."""
    v = _hot_values()
    ok = np.random.default_rng(18).random(HOT) < 0.5
    key = torch.full((HOT,), 777, dtype=torch.int32)
    count, outs = ha.hash_agg(
        mode, HOT, 1026, 1025, key=key, capacity=1024, device="cpu",
        lanes=[ha.Lane(values=torch.from_numpy(v)),
               ha.Lane(values=torch.from_numpy(v), ok=torch.from_numpy(ok))])
    slot = 0 if mode == "simple" else 777
    assert int(count[slot]) == HOT and int(count.sum()) == HOT
    assert int(outs[0][0][slot]) == int(v.astype(np.int64).sum())
    assert int(outs[1][0][slot]) == int(v.astype(np.int64)[ok].sum())
    assert int(outs[1][1][slot]) == int(ok.sum())


@pytest.mark.parametrize("fmt", ["packed", "split"])
def test_cell_arithmetic_of_a_hot_slot(fmt):
    """The kernel's cell arithmetic, replayed in numpy on one hot slot with
    the folds ``geometry`` sets (one block, every row in one cell): the
    decoded count and sum equal the plain version's."""
    vb = 4 if fmt == "packed" else 2
    rng = np.random.default_rng(19)
    lo, hi = -(1 << (8 * vb - 1)), (1 << (8 * vb - 1)) - 1
    v = np.where(rng.random(HOT) < 0.5, hi, lo).astype(np.int32)
    geo = ha.geometry("dense", HOT, 1, vb, 1, fmt)
    rows = geo.fold_every * ha.tile_rows("dense", 1)   # rows per fold
    count = total = 0
    for start in range(0, HOT, rows):
        chunk = v[start:start + rows]
        if fmt == "packed":
            u = (chunk.astype(np.int64) + geo.bias).astype(np.uint64)
            cell = np.uint64(len(chunk)) * np.uint64(1 << geo.shift) + \
                u.sum(dtype=np.uint64)
            c = int(cell) >> geo.shift
            s = (int(cell) & ((1 << geo.shift) - 1)) - c * geo.bias
        else:
            cell = chunk.astype(np.uint32).sum(dtype=np.uint32)
            c, s = len(chunk), int(cell.astype(np.int32))
        count, total = count + c, total + s
    want_c, outs = ha.hash_agg_plain(
        "dense", HOT, 1026, 1024, key=torch.zeros(HOT, dtype=torch.int32),
        capacity=1024, lanes=[ha.Lane(values=torch.from_numpy(v))])
    assert count == int(want_c[0]) == HOT
    assert total == int(outs[0][0][0]) == int(v.astype(np.int64).sum())
