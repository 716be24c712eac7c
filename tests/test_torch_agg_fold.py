"""The aggregation fold (``tikv_tpu_torch/device/agg_fold.py``) against the
JAX package's tiles.

``agg_fold`` on CPU tensors runs its plain version: the port's tiles of
``ops/agg.py`` encoded into the fold's one int64 buffer.  Its decoded
states are held against ``tikv_tpu.ops.agg.hash_agg_tile`` and
``simple_agg_tile`` (jax.numpy with x64, the reference's device path) on
the same seeded inputs, with ``tests/test_torch_agg_ops.py``'s
tolerances: counts, integer sums, MIN and MAX exactly, FIRST exactly
against the host's rule (the reference's device skips a leading NULL,
fault 8); REAL
SUM/AVG within 1e-6·Σ|v| (the reference sums each tile in float32,
``ops/agg.py:17-19``, the port in float64); the variance moments within
rtol 1e-12 (float64 on both sides, summed in another order).

Beside it: the buffer layout round trip, the lane plan, the route and the
launch parameters (pure Python, what the CUDA launcher hands the kernel),
the shared route's split-cell arithmetic replayed in numpy, the wrapper's
CPU-only plain version, and the runner's 4m and 3n plans end to end
against the reference runner and the numpy truth.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tikv_tpu.ops import agg as ref_agg
from tikv_tpu.parallel import make_mesh
from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.server import wire

import torch

from tikv_tpu_torch import convert
from tikv_tpu_torch.device import agg_fold as af
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.ops import agg
from tikv_tpu_torch.testing import configs

from tests.test_torch_agg_ops import (assert_simple_states_agree,
                                      assert_states_agree, canon, specs_for)
from tests.test_torch_runner import port_snapshot, ref_config

KINDS = ("count", "count_star", "sum", "avg", "min", "max", "var_pop",
         "var_samp", "stddev_pop", "stddev_samp")
N = 2001


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)


def columns(dtype, seed, n=N):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        v = rng.normal(0.0, 1000.0, n).astype(np.float32)
    elif dtype == "int64":
        v = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    else:
        v = rng.integers(-1000, 1000, n).astype(np.int32)
        v[:2] = [(1 << 31) - 1, -(1 << 31)]          # the int32 extremes
    ok = rng.random(n) > 0.15
    return np.where(ok, v, 0).astype(v.dtype), ok


def selection(kind, seed, n=N):
    if kind == "none":
        return None
    if kind == "all_false":
        return np.zeros(n, np.bool_)
    return np.random.default_rng(seed).random(n) > 0.3


def ref_states(states):
    return [{k: np.asarray(x) for k, x in s.items()} for s in states]


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32"])
@pytest.mark.parametrize("keys", ["dense", "sparse", "overflow"])
@pytest.mark.parametrize("sel", ["none", "partial", "all_false"])
def test_fold_matches_reference_hash_tile(dtype, keys, sel):
    """GROUP BY: every device aggregate kind over NULL-bearing values,
    dense keys (NULL keys among them), sparse slot ids, and live keys past
    the capacity (the overflow flag and the scrap slot)."""
    v, ok = columns(dtype, 1)
    mask = selection(sel, 2)
    rng = np.random.default_rng(3)
    capacity, base = 64, -7
    specs, ref_specs = specs_for(KINDS, dtype)
    cols = [None if k == "count_star" else
            (torch.from_numpy(v), torch.from_numpy(ok)) for k in KINDS]
    ref_cols = [(jnp.asarray(v), jnp.asarray(ok))] * len(KINDS)
    row_mask = np.ones(N, np.bool_) if mask is None else mask
    kw = dict(mask=None if mask is None else torch.from_numpy(mask),
              capacity=capacity)
    if keys == "sparse":
        ids = rng.integers(0, capacity + 1, N).astype(np.int32)
        kw.update(mode="sparse", slot_ids=torch.from_numpy(ids))
        ref_key = (jnp.zeros(N, jnp.int32), jnp.asarray(row_mask))
        ref_base = ("precomp", jnp.asarray(ids))
    else:
        spread = capacity + (5 if keys == "overflow" else 0)
        kv = (base + rng.integers(0, spread, N)).astype(np.int64)
        km = rng.random(N) > 0.1
        kw.update(mode="dense", key=torch.from_numpy(kv),
                  key_ok=torch.from_numpy(km), base=base)
        ref_key = (jnp.asarray(kv), jnp.asarray(km))
        ref_base = base
    present, overflow, got = af.agg_fold(specs, cols, N, **kw).host()
    want = ref_agg.hash_agg_tile(jnp, ref_specs, ref_key, ref_cols, capacity,
                                 ref_base, row_mask=jnp.asarray(row_mask))
    np.testing.assert_array_equal(present, np.asarray(want["present"]))
    assert overflow == bool(want["overflow"])
    assert overflow == (keys == "overflow" and sel != "all_false")
    assert_states_agree(got, ref_states(want["states"]), KINDS, v,
                        ok & row_mask)


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32"])
@pytest.mark.parametrize("sel", ["none", "partial", "all_false"])
def test_fold_matches_reference_simple_tile(dtype, sel):
    """No GROUP BY: every kind, FIRST among them (the first selected
    position, the value there and its validity)."""
    kinds = KINDS + ("first",)
    v, ok = columns(dtype, 4)
    mask = selection(sel, 5)
    row_mask = np.ones(N, np.bool_) if mask is None else mask
    specs, ref_specs = specs_for(kinds, dtype)
    cols = [None if k == "count_star" else
            (torch.from_numpy(v), torch.from_numpy(ok)) for k in kinds]
    okm = ok & row_mask
    ref_cols = [(jnp.asarray(v), jnp.asarray(okm))] * len(kinds)
    present, overflow, got = af.agg_fold(
        specs, cols, N, "simple",
        mask=None if mask is None else torch.from_numpy(mask)).host()
    want = ref_agg.simple_agg_tile(jnp, ref_specs, ref_cols,
                                   n_valid_rows=int(row_mask.sum()))
    assert present.tolist() == [bool(row_mask.any())] and not overflow
    got = [{k: x[0] for k, x in s.items()} for s in got]
    assert_simple_states_agree(specs, ref_specs, got, ref_states(want),
                               kinds, v, ok, row_mask)


def test_fold_without_validity_planes_and_shared_lanes():
    """An argument with no validity plane takes the row count as its
    non-NULL count; aggregates over one (values, validity) pair are one
    lane, over one values plane with two validities two lanes."""
    v, _ok = columns("int32", 6)
    a = np.random.default_rng(7).random(N) > 0.4
    vt, at = torch.from_numpy(v), torch.from_numpy(a)
    specs = [agg.AggSpec("min", 0), agg.AggSpec("sum", 1),
             agg.AggSpec("max", 2), agg.AggSpec("var_pop", 3),
             agg.AggSpec("count_star", 4)]
    cols = [(vt, at), (vt, None), (vt, at), (vt, None), None]
    plan = af.plan_fold(specs, cols, "simple")
    assert len(plan.lanes) == 2
    assert plan.spec_rows[1]["nonnull"] == 0          # the row count
    assert plan.spec_rows[0]["nonnull"] == plan.spec_rows[2]["nonnull"]
    _p, _o, got = af.agg_fold(specs, cols, N, "simple").host()
    assert got[1]["sum"][0] == int(v.astype(np.int64).sum())
    assert got[1]["nonnull"][0] == N == got[4]["count"][0]
    assert got[0]["min"][0] == v[a].min() and got[2]["max"][0] == v[a].max()
    assert got[0]["nonnull"][0] == a.sum()
    np.testing.assert_allclose(got[3]["sumsq"][0],
                               (v.astype(np.float64) ** 2).sum(), rtol=1e-12)


@pytest.mark.parametrize("mode", ["simple", "dense"])
def test_buffer_round_trip(mode):
    """The buffer holds exactly the tiles' states: decoding the plain
    version's buffer gives back ``simple_agg_tile`` / ``hash_agg_tile``
    bit for bit (floats by their bits; MIN/MAX images fold -0.0 to +0.0,
    so a zero compares as a number)."""
    kinds = KINDS + (("first",) if mode == "simple" else ())
    for dtype in ("int32", "int64", "float32"):
        v, ok = columns(dtype, 8)
        v[5:9] = [0, -0.0, 0, 0] if dtype == "float32" else v[5:9]
        specs, _r = specs_for(kinds, dtype)
        vt, okt = torch.from_numpy(v), torch.from_numpy(ok)
        cols = [None if k == "count_star" else (vt, okt) for k in kinds]
        ones = torch.ones(N, dtype=torch.bool)
        if mode == "simple":
            out = af.agg_fold(specs, cols, N, "simple")
            tile_cols = [(vt, ones) if c is None else (vt, okt)
                         for c in cols]
            want = agg.simple_agg_tile(specs, tile_cols, torch.tensor(N))
            want = [{k: t.reshape(1) for k, t in s.items()} for s in want]
        else:
            key = torch.from_numpy(
                np.random.default_rng(9).integers(0, 40, N))
            out = af.agg_fold(specs, cols, N, "dense", key=key, capacity=40)
            tile_cols = [(vt, ones) if c is None else (vt, okt)
                         for c in cols]
            want = agg.hash_agg_tile(specs, (key, ones), tile_cols, 40, 0,
                                     ones)["states"]
        _p, _o, got = out.host()
        assert len(out.buf) == 1 + len(out.plan.rows) * out.n_slots
        for kind, g, w in zip(kinds, got, want):
            assert g.keys() == w.keys(), kind
            for key_name in g:
                gv, wv = g[key_name], w[key_name].numpy()
                if gv.dtype.kind == "f":
                    np.testing.assert_array_equal(gv + 0.0, wv + 0.0)
                else:
                    np.testing.assert_array_equal(canon(gv), canon(wv))


def test_init_values_are_the_identities():
    """MIN/MAX cells start at the image of their dtype's identity, FIRST at
    'no position', everything else at 0."""
    cols = {dt: (torch.zeros(3, dtype=dt), None)
            for dt in (torch.int32, torch.int64, torch.float32,
                       torch.float64)}
    for dt, col in cols.items():
        specs = [agg.AggSpec("min", 0), agg.AggSpec("max", 1),
                 agg.AggSpec("first", 2)]
        plan = af.plan_fold(specs, [col] * 3, "simple")
        init = dict(zip([st for st, _j in plan.rows], af.init_values(plan)))
        lo, hi = agg._minmax_identity(dt, True), agg._minmax_identity(dt,
                                                                      False)
        dec = {st: af._decode(st, np.array([init[st]], np.int64), dt)[0]
               for st in ("min", "max")}
        assert dec["min"] == lo and dec["max"] == hi
        assert init["first"] == agg._BIG and init["rows"] == 0


def test_first_with_group_by_and_unknown_kinds_are_refused():
    v = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="FIRST"):
        af.plan_fold([agg.AggSpec("first", 0)], [(v, None)], "dense")
    with pytest.raises(ValueError, match="bit_and"):
        af.plan_fold([agg.AggSpec("bit_and", 0)], [(v, None)], "simple")


# --------------------------------------------------- the launcher's plan


def _plan(dtype, kinds, mode="dense", ok=True):
    v = torch.zeros(8, dtype=dtype)
    okt = torch.ones(8, dtype=torch.bool) if ok else None
    specs = [agg.AggSpec(k, i) for i, k in enumerate(kinds)]
    return af.plan_fold(specs, [None if k == "count_star" else (v, okt)
                                for k in kinds], mode)


@pytest.mark.parametrize("dtype,slots,route", [
    (torch.int32, 1026, "shared"), (torch.float32, 1026, "shared"),
    (torch.int32, 65538, "global"), (torch.int32, (1 << 20) + 2, "global"),
    (torch.int64, 1026, "global"), (torch.float64, 1026, "global"),
    (torch.int64, 1, "registers"), (torch.int32, 1, "registers")])
def test_route_by_table_size_and_value_width(dtype, slots, route):
    """4m's table (1026 slots) fits shared memory; 65,538 and 2^20 + 2
    slots, and any 8-byte lane, take the global route (an H100's 232,448
    opt-in bytes); no GROUP BY folds in registers."""
    plan = _plan(dtype, ("min", "max", "var_pop", "stddev_samp", "sum"),
                 "simple" if slots == 1 else "dense")
    assert af.choose_route(plan, slots, 232_448) == route


def test_config_4m_shared_cells():
    """4m: MIN, MAX, VAR_POP, STDDEV_SAMP over one NOT NULL int32 lane whose
    values lie in [-1000, 1000] → over a fold interval of 4096 rows, 32-bit
    cells rows, sum (one signed cell), v² (one cell), min and max; the
    first three with 64-bit twins; no float64 cell (the float64 sum comes
    from the exact integer sum, the sum of squares from v²'s cell)."""
    plan = _plan(torch.int32, ("min", "max", "var_pop", "stddev_samp"),
                 ok=False)
    c32, c64, n_wide = af.shared_cells(plan, [0], 1000)
    assert [c for c, _p in c32] == ["rows", "sum", "sq0", "min", "max"]
    assert c64 == [] and n_wide == 3
    assert af.shared_bytes(plan, 1026, 1000) == 1026 * (5 * 4 + 3 * 8)
    p = af.launch_params(plan, 100, 1026, [0], 1, False, None, None, 0,
                         1024, 2, True, 1000, True, 3)
    assert (p.n32, p.n_wide, p.n64, p.o_rows, p.vec) == (5, 3, 0, 0, 1)
    assert (p.c_sum[0], p.n_sum[0], p.c_sq[0], p.n_sq[0]) == (1, 1, 2, 1)
    assert (p.c_min[0], p.c_max[0]) == (3, 4)
    assert p.signed_cells == 0b10 and p.fold_every * af.TILE_SHARED == \
        af.SHORT_FOLD_ROWS == af.fold_rows(1000)
    assert p.d_fsum[0] == -1 and p.d_sumsq[0] == -1
    assert p.o_fsum[0] >= 1 and p.o_nonnull[0] == -1
    assert list(p.init32[:5]) == [0, 0, 0, (1 << 31) - 1, -(1 << 31)]
    assert list(p.init[:len(plan.rows)]) == af.init_values(plan)
    # an unknown bound: the split sum and four limbs
    c32, _c64, n_wide = af.shared_cells(plan, [0])
    assert [c for c, _p in c32] == ["rows", "lo", "hi", "sq0", "sq1", "sq2",
                                    "sq3", "min", "max"] and n_wide == 7
    p = af.launch_params(plan, 100, 1026, [0], 1, False, None, None, 0,
                         1024, 2, True)
    assert (p.c_sum[0], p.n_sum[0], p.c_sq[0], p.n_sq[0]) == (1, 2, 3, 4)
    assert p.signed_cells == 0b100
    assert p.fold_every * af.TILE_SHARED == af.FOLD_ROWS
    # a REAL lane keeps float64 cells for its sum and sum of squares
    plan = _plan(torch.float32, ("sum", "var_pop", "min"))
    c32, c64, n_wide = af.shared_cells(plan, [0], 5)
    assert [c for c, _p in c32] == ["rows", "nonnull", "min"]
    assert [c for c, _p in c64] == ["fsum", "sumsq"] and n_wide == 2


@pytest.mark.parametrize("bound,cells,rows", [
    (0, (1, 1), 1 << 15), (300, (1, 1), 1 << 15), (362, (1, 1), 1 << 15),
    (363, (1, 1), 1 << 12), (1000, (1, 1), 1 << 12),
    (1023, (1, 1), 1 << 12), (1024, (1, 2), 1 << 15),
    ((1 << 16) - 1, (1, 2), 1 << 15), (1 << 16, (2, 4), 1 << 15),
    ((1 << 31) - 1, (2, 4), 1 << 15), (1 << 31, (2, 4), 1 << 15),
    (None, (2, 4), 1 << 15)])
def test_int_cells_by_value_bound(bound, cells, rows):
    """Over FOLD_ROWS rows the sum is one signed cell while rows·bound <
    2^31, v² one cell while rows·bound² < 2^32, two limbs while bound <
    2^16, else four; where the short interval of SHORT_FOLD_ROWS rows keeps
    v² in one cell that the long one would split, the short one is
    taken."""
    assert af.int_cells(bound) == cells
    assert af.fold_rows(bound) == rows


def test_route_by_value_bound():
    """The value bound shrinks the cells, so a wider table fits shared
    memory: 3000 slots of MIN, MAX, VAR_POP and SUM over a NULL-bearing
    int32 lane take 104 bytes a slot for any int32 (global route) and 56
    for |v| <= 100 (shared route)."""
    plan = _plan(torch.int32, ("min", "max", "var_pop", "sum"))
    assert af.shared_bytes(plan, 3000) == 3000 * 104
    assert af.shared_bytes(plan, 3000, 100) == 3000 * 56
    assert af.choose_route(plan, 3000, 232_448) == "global"
    assert af.choose_route(plan, 3000, 232_448, 100) == "shared"


@pytest.mark.parametrize("bound", [300, 1000, 1023, 1024, (1 << 16) - 1,
                                   1 << 31])
def test_limb_cells_cannot_wrap_within_a_fold_interval(bound):
    """The shared route's 32-bit cells over one fold interval
    (``fold_rows(bound)`` rows into one hot slot, values at ±bound, the
    int32 extremes at the last bound), replayed in numpy as the kernel adds
    them — row by row and in warp-reduced steps of 128 rows: every unsigned
    cell stays below 2^32 and every signed one inside int32, and the twins
    recombine to the exact sum and sum of squares."""
    n_sum, n_sq = af.int_cells(bound)
    rows = af.fold_rows(bound)
    rng = np.random.default_rng(bound % 97)
    hi_v = min(bound, (1 << 31) - 1)
    v = np.where(rng.random(rows) < 0.5, hi_v, -bound).astype(np.int64)
    v[: rows // 2] = -bound                      # a long run of one sign
    sq = (v * v).astype(np.uint64)
    if n_sum == 1:
        sums = {"sum": (v, True)}
    else:
        sums = {"lo": (v & 0xFFFF, False), "hi": (v >> 16, True)}
    limbs = {}
    for k in range(n_sq):
        x = sq >> np.uint64(16 * k)
        limbs[f"sq{k}"] = ((x if k == n_sq - 1 else x & np.uint64(0xFFFF))
                           .astype(np.int64), False)
    for step in (1, 128):
        for name, (a, signed) in {**sums, **limbs}.items():
            run = np.cumsum(a.reshape(-1, step).sum(1))
            if signed:
                assert run.min() >= -(1 << 31) and run.max() < 1 << 31, name
            else:
                assert run.min() >= 0 and run.max() < 1 << 32, name
    total = sum(int(a.sum()) << (16 if name == "hi" else 0)
                for name, (a, _s) in sums.items())
    assert total == int(v.sum())
    squares = sum(int(a.sum()) << (16 * int(name[2:]))
                  for name, (a, _s) in limbs.items())
    assert squares == int((v.astype(object) ** 2).sum())


def test_lanes_past_eight_launch_in_groups():
    """Nine distinct arguments: two launches, the row count in the first."""
    vs = [torch.zeros(4, dtype=torch.int32) for _ in range(9)]
    specs = [agg.AggSpec("sum", i) for i in range(9)]
    plan = af.plan_fold(specs, [(v, None) for v in vs], "simple")
    groups = af.lane_groups(plan)
    assert [len(g) for g in groups] == [8, 1]
    firsts = [af.launch_params(plan, 4, 1, g, None, False, None, None, 0, 0,
                               1, gi == 0).o_rows
              for gi, g in enumerate(groups)]
    assert firsts == [0, -1]


def test_registers_route_groups_lanes_by_dtype():
    """Without GROUP BY each launch's lanes share one dtype (the registers
    route's kernel is compiled per dtype), the row count in the first;
    with GROUP BY lanes stay in order, eight a launch."""
    i32, f32 = torch.zeros(4, dtype=torch.int32), torch.zeros(4)
    i64 = torch.zeros(4, dtype=torch.int64)
    cols = [(i32, None), (f32, None), (i64, None), (i32 + 1, None)]
    specs = [agg.AggSpec("max", i) for i in range(4)]
    plan = af.plan_fold(specs, cols, "simple")
    assert af.lane_groups(plan) == [[0, 3], [2], [1]]
    plan = af.plan_fold([agg.AggSpec("max", i) for i in range(4)], cols,
                        "dense")
    assert af.lane_groups(plan) == [[0, 1, 2, 3]]
    assert af.lane_groups(af.plan_fold([agg.AggSpec("count_star", 0)],
                                       [None], "simple")) == [[]]


def test_split_cells_cannot_wrap_within_a_chunk():
    """The shared route folds a chunk of CHUNK rows into an unsigned low
    16-bit cell and a signed high cell: replayed in numpy for a hot slot of
    int32 extremes, in warp-reduced steps and row by row, both cells stay
    in 32 bits and recombine to the exact sum."""
    chunk = 1 << 15
    rng = np.random.default_rng(10)
    v = np.where(rng.random(chunk) < 0.5, (1 << 31) - 1,
                 -(1 << 31)).astype(np.int64)
    lo = v & 0xFFFF
    hi = v >> 16
    for step in (1, 32):
        lo_sums = lo.reshape(-1, step).sum(1)
        hi_sums = hi.reshape(-1, step).sum(1)
        assert np.cumsum(lo_sums).max() < 1 << 32
        assert np.abs(np.cumsum(hi_sums)).max() < 1 << 31
        assert (hi_sums.sum() << 16) + lo_sums.sum() == v.sum()


# ---------------------------------------------------------- the wrapper


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    before = af.launches
    v = torch.arange(10, dtype=torch.int32)
    out = af.agg_fold([agg.AggSpec("max", 0)], [(v, None)], 10, "simple")
    assert out.host()[2][0]["max"][0] == 9 and af.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        af.agg_fold([agg.AggSpec("max", 0)], [(v.to("meta"), None)], 10,
                    "simple")
    with pytest.raises(ValueError, match="capacity"):
        af.agg_fold([agg.AggSpec("max", 0)], [(v, None)], 10, "dense",
                    key=v, capacity=0)


# -------------------------------------------------- the runner's plans


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.mark.parametrize("name", ["4m", "3n"])
def test_runner_folds_4m_and_3n_through_agg_fold(name, ref, monkeypatch):
    """4m (GROUP BY k: MIN, MAX, VAR_POP, STDDEV_SAMP) and 3n (SUM, COUNT,
    AVG, MIN, MAX, FIRST over NULLs) make one ``agg_fold`` call with no
    all-true mask and no ok & mask copies, and answer as the reference
    runner and the numpy truth."""
    import tikv_tpu_torch.device.runner as rmod
    calls = []
    real = rmod.agg_fold

    def record(specs, cols, n, mode, **kw):
        calls.append((mode, cols, kw))
        return real(specs, cols, n, mode, **kw)

    monkeypatch.setattr(rmod, "agg_fold", record)
    table, snap, dag = ref_config(name, 6000)
    psnap = port_snapshot(table, snap)
    port = DeviceRunner(device="cpu")
    got = port.handle_request(convert.dag_from_wire(wire.enc_dag(dag)),
                              psnap).rows()
    truth, scales = configs.truth(name, psnap)
    assert configs.rows_agree(got, truth, scales, 1e-9)
    assert configs.rows_agree(ref.handle_request(dag, snap).rows(), truth,
                              scales, 1e-6)
    (mode, cols, kw), = calls
    assert mode == ("dense" if name == "4m" else "simple")
    assert kw["mask"] is None
    lanes = {(c[0].data_ptr(), None if c[1] is None else c[1].data_ptr())
             for c in cols if c is not None}
    assert len(lanes) == 1                     # one argument, read once
    if name == "4m":
        assert kw["key_ok"] is None and all(c[1] is None for c in cols)
