"""The two-level GROUP BY contraction against the JAX package's.

``twolevel_plain`` (the CUDA kernel's plain version, ``device/twolevel.py``)
runs over seeded numpy inputs; the reference's ``kernels.twolevel_partial``
(jax.numpy on the CPU) runs over the same inputs one chunk at a time, and
its packed int32 / float32 partials are summed in int64 / float64, as the
reference runner's carry sums them.  ``S8`` must be equal exactly.  ``Sf``
must agree within 1e-6·Σ|v| per cell: the reference sums each chunk in
float32, the port adds float32 values in float64.

The rows are a feed's: live rows on random slots, the NULL slot
(``capacity``) and the scrap slot (``capacity + 1``), ids outside the
layout, and padding rows (scrap slot, zero planes).  The layout helpers of
``device/kernels.py`` are held against the reference's one by one.

The fused entry (``twolevel_fused``: raw key, mask and argument columns
in) is held against the reference's own composition, ``slot_index`` →
``make_planes`` → ``twolevel_partial``, over int32 / int64 / sparse keys,
NULL keys, every selection, 1-4 byte planes and REAL lanes (8 byte planes
against numpy's uint64 split: the reference cannot build them), with the
overflow flag; its lane plan (each distinct plane once) is held against
``make_planes``' repeated planes, and the route policy against a model of
the H100's occupancy.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tikv_tpu.device import kernels as ref_kn
from tikv_tpu.ops.agg import AggSpec as RefAggSpec

import torch

from tikv_tpu_torch.device import kernels as kn
from tikv_tpu_torch.device import twolevel as tl
from tikv_tpu_torch.ops.agg import AggSpec

INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)


def feed_inputs(slots, p8, pf, n, seed, pad=0.1):
    """(idx int32, L8 int8 (p8, n), Lf float32 (pf, n) | None) of a padded
    feed over the slot layout of ``slots`` = capacity + 2."""
    rng = np.random.default_rng(seed)
    capacity = slots - 2
    LO, HI = kn.twolevel_dims(slots, p8, pf)
    idx = rng.integers(0, capacity, n)
    kind = rng.random(n)
    idx = np.where(kind < 0.05, capacity, idx)                  # NULL key
    idx = np.where((kind >= 0.05) & (kind < 0.1), capacity + 1, idx)
    idx = np.where((kind >= 0.1) & (kind < 0.11), -1, idx)      # outside
    idx = np.where((kind >= 0.11) & (kind < 0.12), HI * LO + 5, idx)
    L8 = rng.integers(-128, 128, (p8, n))
    Lf = rng.normal(0.0, 1000.0, (pf, n)) if pf else None
    live = n - int(n * pad)
    idx[live:] = capacity + 1                                   # padding
    L8[:, live:] = 0
    if Lf is not None:
        Lf[:, live:] = 0
    return (idx.astype(np.int32), L8.astype(np.int8),
            None if Lf is None else Lf.astype(np.float32)), LO, HI


def reference_sums(idx, L8, Lf, LO, HI, chunk):
    S8 = np.zeros((HI, L8.shape[0] * LO), np.int64)
    Sf = None if Lf is None else np.zeros((HI, Lf.shape[0] * LO), np.float64)
    for at in range(0, idx.shape[0], chunk):
        sl = slice(at, at + chunk)
        p8, pf = ref_kn.twolevel_partial(
            jnp.asarray(idx[sl]), jnp.asarray(L8[:, sl]),
            None if Lf is None else jnp.asarray(Lf[:, sl]), LO, HI)
        S8 += np.asarray(p8).astype(np.int64)
        if Sf is not None:
            Sf += np.asarray(pf).astype(np.float64)
    return S8, Sf


def port_sums(idx, L8, Lf, LO, HI):
    S8, Sf = tl.twolevel(torch.from_numpy(idx), torch.from_numpy(L8),
                         None if Lf is None else torch.from_numpy(Lf), LO, HI)
    return S8.numpy(), None if Sf is None else Sf.numpy()


def cell_magnitude(idx, Lf, LO, HI):
    """Σ|v| per packed float cell."""
    _S8, mag = tl.twolevel_plain(
        torch.from_numpy(idx), torch.zeros((1, idx.shape[0]), dtype=torch.int8),
        torch.from_numpy(np.abs(Lf)), LO, HI)
    return mag.numpy()


CASES = [(1, 0, 1026), (2, 1, 1026), (8, 2, 1026), (17, 0, 1026),
         (32, 2, 1026), (1, 0, 65538), (3, 1, 65538), (8, 0, 65538),
         (1, 0, (1 << 20) + 2), (2, 2, (1 << 20) + 2)]


@pytest.mark.parametrize("p8,pf,slots", CASES)
def test_plain_matches_reference_partial(p8, pf, slots):
    n, chunk = (3000, 1024) if slots < (1 << 20) else (300, 150)
    (idx, L8, Lf), LO, HI = feed_inputs(slots, p8, pf, n, seed=p8 * 7 + pf)
    want8, wantf = reference_sums(idx, L8, Lf, LO, HI, chunk)
    got8, gotf = port_sums(idx, L8, Lf, LO, HI)
    np.testing.assert_array_equal(got8, want8)
    if pf == 0:
        assert gotf is None and wantf is None
        return
    tol = 1e-6 * cell_magnitude(idx, Lf, LO, HI)
    assert np.all(np.abs(gotf - wantf) <= tol)


@pytest.mark.parametrize("proto", ["prof_pallas", "prof_pl"])
def test_prototype_shapes_and_checks(proto):
    """The Pallas prototypes' (HI, LO, planes) and their own checks: the
    count by bincount and the sum rebuilt with their bias formula."""
    HI, LO = (32, 32) if proto == "prof_pallas" else (40, 32)
    rng = np.random.default_rng(0)
    N = 4096
    k = rng.integers(0, 1024, N).astype(np.int32)
    v = rng.integers(-1000, 1000, N).astype(np.int32)
    biased = v + (1 << 15)
    mask = np.ones(N, np.int8)
    b0 = ((biased & 0xFF) - 128).astype(np.int8)
    b1 = (((biased >> 8) & 0xFF) - 128).astype(np.int8)
    planes = [mask, mask, b0, b1] if proto == "prof_pallas" \
        else [mask, b0, b1]
    L8 = np.stack(planes)
    want, _ = reference_sums(k, L8, None, LO, HI, 1024)
    got, _ = port_sums(k, L8, None, LO, HI)
    np.testing.assert_array_equal(got, want)
    P = L8.shape[0]
    S = got.reshape(HI, P, LO).transpose(1, 0, 2).reshape(P, HI * LO)[:, :1024]
    sums = np.bincount(k, weights=v, minlength=1024).astype(np.int64)
    np.testing.assert_array_equal(S[0], np.bincount(k, minlength=1024))
    if proto == "prof_pallas":
        ok = S[1]
        rebuilt = (S[2] + 128 * ok) + 256 * (S[3] + 128 * ok) - (1 << 15) * ok
    else:
        rebuilt = S[1] + (S[2] << 8) + S[0] * (128 + (128 << 8) - (1 << 15))
    np.testing.assert_array_equal(rebuilt, sums)


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    (idx, L8, Lf), LO, HI = feed_inputs(1026, 3, 1, 500, seed=1)
    before = tl.launches
    got = port_sums(idx, L8, Lf, LO, HI)
    assert tl.launches == before
    want = tl.twolevel_plain(torch.from_numpy(idx), torch.from_numpy(L8),
                             torch.from_numpy(Lf), LO, HI)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    with pytest.raises(ValueError, match="int32"):
        tl.twolevel(torch.from_numpy(idx).long(), torch.from_numpy(L8), None,
                    LO, HI)
    with pytest.raises(ValueError, match="LO"):
        tl.twolevel(torch.from_numpy(idx), torch.from_numpy(L8), None, 12, HI)


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

SPEC_SETS = [
    (("count_star", None), ("sum", False), ("avg", False)),
    (("count", False), ("sum", True), ("avg", True), ("count_star", None)),
    (("sum", False), ("sum", False), ("avg", True), ("count", False)),
]


@pytest.mark.parametrize("which", range(len(SPEC_SETS)))
@pytest.mark.parametrize("aliased", [False, True])
def test_build_layouts_match_reference(which, aliased):
    kinds = SPEC_SETS[which]
    specs = [AggSpec(kd, i) for i, (kd, _r) in enumerate(kinds)]
    ref_specs = [RefAggSpec(kd, i) for i, (kd, _r) in enumerate(kinds)]
    real = [bool(r) for _kd, r in kinds]
    nbytes = [0 if r else (i % 4) + 1 for i, (_kd, r) in enumerate(kinds)]
    ok_mask = [aliased and i % 2 == 0 for i in range(len(kinds))]
    got = kn.build_layouts(specs, real, nbytes, ok_mask)
    want = ref_kn.build_layouts(ref_specs, real, nbytes, ok_mask)
    assert got[1:] == want[1:]
    assert [vars(x) for x in got[0]] == [vars(x) for x in want[0]]
    assert kn.matmul_supported(specs) == ref_kn.matmul_supported(ref_specs)
    p8, pf = got[1], got[2]
    assert kn.twolevel_lo(p8, pf) == ref_kn.twolevel_lo(p8, pf)


def test_dims_and_unpack_match_reference():
    rng = np.random.default_rng(3)
    for p8 in (1, 3, 8, 17, 32, 33):
        for pf in (0, 1, 2):
            assert kn.twolevel_lo(p8, pf) == ref_kn.twolevel_lo(p8, pf)
            if kn.twolevel_lo(p8, pf) is None:
                continue
            for slots in (1026, 65538):
                dims = kn.twolevel_dims(slots, p8, pf)
                assert dims == ref_kn.twolevel_dims(slots, p8, pf)
                LO, HI = dims
                S2 = rng.integers(-9, 9, (HI, p8 * LO))
                np.testing.assert_array_equal(
                    kn.twolevel_unpack(S2, p8, LO, slots),
                    ref_kn.twolevel_unpack(S2, p8, LO, slots, xp=np))
    assert kn.int_planes_needed(-(1 << 31), (1 << 31) - 1) == 4
    for lo, hi in ((-128, 127), (-129, 0), (0, 1 << 23), (-(1 << 31), 0),
                   (0, 1 << 31), (INT64_MIN, INT64_MAX)):
        assert kn.int_planes_needed(lo, hi) == ref_kn.int_planes_needed(lo, hi)
    for nb in (1, 2, 3, 4, 8):
        assert kn.bias_offset(nb) == ref_kn.bias_offset(nb)


def _edge_values(nb, n, rng):
    lo, hi = -(1 << (8 * nb - 1)), (1 << (8 * nb - 1)) - 1
    v = rng.integers(lo, hi, n, endpoint=True, dtype=np.int64)
    v[:4] = [lo, hi, 0, -1]
    return v


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
def test_make_planes_bytes_match_reference(nb):
    """Byte planes of an int32 column and of an int64 column (nb = 4 is
    the widest the reference builds; see the nb = 8 test)."""
    rng = np.random.default_rng(nb)
    n = 700
    v = _edge_values(nb, n, rng)
    ok = rng.random(n) > 0.2
    mask = rng.random(n) > 0.1
    kinds = (("count_star", None), ("sum", False), ("avg", False))
    specs = [AggSpec(kd, i) for i, (kd, _r) in enumerate(kinds)]
    ref_specs = [RefAggSpec(kd, i) for i, (kd, _r) in enumerate(kinds)]
    nbytes = [0, nb, nb]
    for dt in (np.int32, np.int64):
        vals = v.astype(dt)
        lays, _p8, _pf = kn.build_layouts(specs, [False] * 3, nbytes)
        ref_lays, _, _ = ref_kn.build_layouts(ref_specs, [False] * 3, nbytes)
        cols = [(vals, ok)] * 3
        got8, gotf = kn.make_planes(
            lays, [(torch.from_numpy(a), torch.from_numpy(b))
                          for a, b in cols], torch.from_numpy(mask))
        want8, wantf = ref_kn.make_planes(
            ref_lays, ref_specs, [(jnp.asarray(a), jnp.asarray(b))
                                  for a, b in cols], jnp.asarray(mask))
        assert gotf is None and wantf is None
        np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))


def test_make_planes_eight_bytes_are_exact():
    """nb = 8 (a computed int64 argument): the port splits the biased value
    in int64 (flipping the sign bit is adding 2^63 modulo 2^64).  The bytes
    equal the uint64 split and the rebuilt group sums are exact up to
    INT64_MIN and INT64_MAX.  The reference cannot build these planes:
    ``v64 + (1 << 63)`` overflows (ROADMAP.md queue 3, fault 4)."""
    rng = np.random.default_rng(8)
    n = 600
    v = _edge_values(8, n, rng)
    v[4:] //= n                       # every group sum fits int64
    ok = rng.random(n) > 0.2
    mask = rng.random(n) > 0.1
    specs = [AggSpec("sum", 0)]
    lays, p8, pf = kn.build_layouts(specs, [False], [8])
    L8, _ = kn.make_planes(lays, [(torch.from_numpy(v),
                                          torch.from_numpy(ok))],
                           torch.from_numpy(mask))
    biased = v.astype(np.uint64) + np.uint64(1 << 63)
    live = mask & ok
    for k in range(8):
        byte = ((biased >> np.uint64(8 * k)) & np.uint64(0xFF)) \
            .astype(np.int64) - 128
        np.testing.assert_array_equal(L8[2 + k].numpy(),
                                      np.where(live, byte, 0))
    idx = rng.integers(0, 4, n).astype(np.int32)
    LO, HI = kn.twolevel_dims(6, p8, pf)
    S8p, _ = tl.twolevel_plain(torch.from_numpy(idx), L8, None, LO, HI)
    S8 = kn.twolevel_unpack(S8p.numpy(), p8, LO, 6)
    _present, states = kn.states_from_matmul(lays, specs, S8, None)
    want = [sum(int(x) for x in v[live & (idx == g)]) for g in range(4)]
    assert [int(x) for x in states[0]["sum"][:4]] == want
    ref_lays, _, _ = ref_kn.build_layouts([RefAggSpec("sum", 0)], [False],
                                          [8])
    with pytest.raises(OverflowError):
        ref_kn.make_planes(ref_lays, [RefAggSpec("sum", 0)],
                           [(jnp.asarray(v), jnp.asarray(ok))],
                           jnp.asarray(mask))


def test_states_from_matmul_match_reference():
    rng = np.random.default_rng(5)
    kinds = (("count_star", None), ("count", False), ("sum", False),
             ("avg", True), ("sum", True), ("avg", False))
    specs = [AggSpec(kd, i) for i, (kd, _r) in enumerate(kinds)]
    ref_specs = [RefAggSpec(kd, i) for i, (kd, _r) in enumerate(kinds)]
    real = [bool(r) for _kd, r in kinds]
    nbytes = [0, 0, 3, 0, 0, 2]
    lays, p8, pf = kn.build_layouts(specs, real, nbytes, [False, True] * 3)
    ref_lays, _, _ = ref_kn.build_layouts(ref_specs, real, nbytes,
                                          [False, True] * 3)
    S8 = rng.integers(-5000, 5000, (p8, 1026))
    Sf = rng.normal(0, 1e4, (pf, 1026))
    got = kn.states_from_matmul(lays, specs, S8, Sf)
    want = ref_kn.states_from_matmul(ref_lays, ref_specs, S8, Sf, xp=np)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
def test_slot_index_matches_reference(key_dtype):
    rng = np.random.default_rng(9)
    n, capacity = 2000, 1024
    base = -300 if key_dtype == np.int32 else (1 << 40) - 300
    kv = (base + rng.integers(-5, capacity + 5, n)).astype(key_dtype)
    km = rng.random(n) > 0.1
    mask = rng.random(n) > 0.2
    for m in (mask, mask & (kv >= base) & (kv < base + capacity)):
        got_idx, got_ovf = kn.slot_index(
            (torch.from_numpy(kv), torch.from_numpy(km)), capacity, base,
            torch.from_numpy(m))
        want_idx, want_ovf = ref_kn.slot_index(
            (jnp.asarray(kv), jnp.asarray(km)), capacity,
            jnp.asarray(base, jnp.int64), jnp.asarray(m))
        assert got_idx.dtype == torch.int32
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
        assert bool(got_ovf) == bool(want_ovf)


# ---------------------------------------------------------------------------
# the fused entry: raw columns in, the reference composition's sums out
# ---------------------------------------------------------------------------

FUSED_N, FUSED_CHUNK, CAPACITY = 3000, 1024, 1024


def value_column(rng, n, dtype, nb, nullable):
    """(values, validity, nb): values spanning nb bytes with their extremes."""
    v = _edge_values(nb, n, rng).astype(dtype)
    ok = rng.random(n) > 0.15 if nullable else np.ones(n, bool)
    return np.where(ok, v, 0).astype(dtype), ok, nb


def fused_inputs(key_kind="int32", mask_kind="partial", aggs=None,
                 columns=None, seed=0, n=FUSED_N, capacity=CAPACITY):
    """Seeded raw columns of one two-level request.

    ``key_kind``: "int32" (base -300), "int32_wrapped" (int32 keys, base
    2^32 - 300: the key shifts against base's int32 wraparound), "int64"
    (base 2^40 - 300, beyond int32) or "sparse" (precomputed slot ids);
    dense keys are NULL on 8% of the rows.  ``mask_kind``: "none",
    "partial" or "all_false".  ``aggs``: (kind, column name | None);
    aggregates over one column share its (values, validity).  Keys stay
    inside [base, base + capacity), so nothing overflows.
    """
    rng = np.random.default_rng(seed)
    base = {"int32": -300, "int32_wrapped": (1 << 32) - 300,
            "int64": (1 << 40) - 300, "sparse": 0}[key_kind]
    inp = {"n": n, "capacity": capacity, "base": base, "kv": None,
           "km": None, "slot_ids": None, "mask": None}
    if key_kind == "sparse":
        inp["slot_ids"] = rng.integers(0, capacity + 2, n).astype(np.int32)
    else:
        dtype = np.int64 if key_kind == "int64" else np.int32
        low = -300 if key_kind == "int32_wrapped" else base
        inp["kv"] = (low + rng.integers(0, capacity, n)).astype(dtype)
        inp["km"] = rng.random(n) > 0.08
    if mask_kind == "partial":
        inp["mask"] = rng.random(n) > 0.3
    elif mask_kind == "all_false":
        inp["mask"] = np.zeros(n, bool)
    if columns is None:
        columns = {"v": value_column(rng, n, np.int32, 2, True)}
    inp["columns"] = columns
    inp["aggs"] = aggs if aggs is not None else \
        [("count_star", None), ("count", "v"), ("sum", "v"), ("avg", "v")]
    return inp


def fused_layout(inp, module, spec_cls):
    """``module.build_layouts`` over the case's aggregates.  A column is
    aliased (its validity is the row mask) when it has no NULL."""
    specs = [spec_cls(kind, i) for i, (kind, _c) in enumerate(inp["aggs"])]
    real, nbytes, aliased = [], [], []
    for kind, name in inp["aggs"]:
        col = inp["columns"].get(name)
        is_real = col is not None and col[0].dtype == np.float32
        real.append(is_real)
        nbytes.append(0 if col is None or is_real or kind == "count"
                      else col[2])
        aliased.append(col is not None and bool(col[1].all()))
    return specs, module.build_layouts(specs, real, nbytes, aliased)


def reference_fused(inp):
    """The JAX package's composition: ``slot_index`` (or the sparse ids
    under the mask) → ``make_planes`` → ``twolevel_partial`` per chunk,
    summed in int64 / float64.  → (S8, Sf, overflow, Lf, idx, LO, HI)."""
    n, capacity = inp["n"], inp["capacity"]
    ref_specs, (lays, p8, pf) = fused_layout(inp, ref_kn, RefAggSpec)
    LO, HI = ref_kn.twolevel_dims(capacity + 2, p8, pf)
    mask = np.ones(n, bool) if inp["mask"] is None else inp["mask"]
    if inp["slot_ids"] is not None:
        idx = np.where(mask, inp["slot_ids"], capacity + 1).astype(np.int32)
        overflow = False
    else:
        ji, jo = ref_kn.slot_index(
            (jnp.asarray(inp["kv"]), jnp.asarray(inp["km"])), capacity,
            jnp.asarray(inp["base"], jnp.int64), jnp.asarray(mask))
        idx, overflow = np.asarray(ji), bool(jo)
    cols = [(jnp.zeros(n, jnp.int32), jnp.asarray(mask)) if name is None
            else (jnp.asarray(inp["columns"][name][0]),
                  jnp.asarray(inp["columns"][name][1]))
            for _kind, name in inp["aggs"]]
    L8, Lf = ref_kn.make_planes(lays, ref_specs, cols, jnp.asarray(mask))
    Lf = None if Lf is None else np.asarray(Lf)
    S8, Sf = reference_sums(idx, np.asarray(L8), Lf, LO, HI, FUSED_CHUNK)
    return S8, Sf, overflow, Lf, idx, LO, HI


def port_fused_args(inp):
    """The port's (layouts, cols, keyword arguments) of a case: torch
    tensors, one (values, validity) tuple per column."""
    _specs, (lays, _p8, _pf) = fused_layout(inp, kn, AggSpec)
    t = {name: (torch.from_numpy(v), torch.from_numpy(ok))
         for name, (v, ok, _nb) in inp["columns"].items()}
    cols = [None if name is None else t[name] for _k, name in inp["aggs"]]

    def opt(a):
        return None if a is None else torch.from_numpy(a)

    kw = dict(capacity=inp["capacity"], base=inp["base"], key=opt(inp["kv"]),
              key_ok=opt(inp["km"]), slot_ids=opt(inp["slot_ids"]),
              mask=opt(inp["mask"]))
    return lays, cols, kw


def check_fused_against_reference(inp):
    want8, wantf, want_ovf, Lf, idx, LO, HI = reference_fused(inp)
    lays, cols, kw = port_fused_args(inp)
    got8, gotf, got_ovf = tl.twolevel_fused(inp["n"], lays, cols, LO, HI,
                                            **kw)
    np.testing.assert_array_equal(got8.numpy(), want8)
    assert (got_ovf is None) == (inp["slot_ids"] is not None)
    assert bool(got_ovf is not None and got_ovf) == want_ovf
    if wantf is None:
        assert gotf is None
    else:
        tol = 1e-6 * cell_magnitude(idx, Lf, LO, HI)
        assert np.all(np.abs(gotf.numpy() - wantf) <= tol)
    return lays, cols, kw, LO, HI


@pytest.mark.parametrize("mask_kind", ["none", "partial", "all_false"])
@pytest.mark.parametrize("key_kind",
                         ["int32", "int32_wrapped", "int64", "sparse"])
def test_fused_plain_matches_reference_composition(key_kind, mask_kind):
    """4n's aggregates (COUNT(*), COUNT(v), SUM(v), AVG(v) over a NULL-able
    int32 column) over every key kind and selection: S8 exactly, and no
    overflow."""
    check_fused_against_reference(fused_inputs(key_kind, mask_kind,
                                               seed=len(key_kind)))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("nb", [1, 2, 3, 4])
def test_fused_plain_bytes_match_reference(nb, dtype):
    """Byte planes of int32 and int64 columns at each width the reference
    builds, with the width's extremes; a NULL-able and a NOT NULL column
    (validity aliased to the row mask), NULL keys and a selection."""
    rng = np.random.default_rng(nb * 10 + (dtype == np.int64))
    columns = {"w": value_column(rng, FUSED_N, dtype, nb, True),
               "a": value_column(rng, FUSED_N, dtype, nb, False)}
    aggs = [("sum", "w"), ("avg", "a"), ("count", "w"), ("sum", "a"),
            ("count_star", None)]
    check_fused_against_reference(fused_inputs(
        "int64" if dtype == np.int64 else "int32", "partial", aggs, columns,
        seed=nb))


@pytest.mark.parametrize("aliased", [False, True])
def test_fused_plain_real_lanes_match_reference(aliased):
    """REAL SUM/AVG lanes (float32 values, float64 sums) beside an integer
    lane: Sf within 1e-6·Σ|v| per cell (the reference sums each chunk in
    float32)."""
    rng = np.random.default_rng(21 + aliased)
    r = rng.normal(0.0, 1000.0, FUSED_N).astype(np.float32)
    ok = np.ones(FUSED_N, bool) if aliased else rng.random(FUSED_N) > 0.2
    columns = {"r": (np.where(ok, r, 0).astype(np.float32), ok, 0),
               "v": value_column(rng, FUSED_N, np.int32, 2, True)}
    aggs = [("sum", "r"), ("count", "r"), ("avg", "r"), ("sum", "v")]
    check_fused_against_reference(fused_inputs("int32", "partial", aggs,
                                               columns, seed=5))


def test_fused_plain_eight_bytes_are_exact():
    """nb = 8 over an int64 column with INT64_MIN and INT64_MAX: the bytes
    are the uint64 split (the reference cannot build these planes, fault
    4), so the group sums rebuilt from S8 are exact."""
    rng = np.random.default_rng(88)
    v = _edge_values(8, FUSED_N, rng)
    v[4:] //= FUSED_N                   # every group sum fits int64
    ok = rng.random(FUSED_N) > 0.2
    inp = fused_inputs("int64", "partial", [("sum", "w")],
                       {"w": (np.where(ok, v, 0), ok, 8)}, seed=8,
                       capacity=8)
    inp["kv"] = (inp["base"] + rng.integers(0, 8, FUSED_N)).astype(np.int64)
    lays, cols, kw = port_fused_args(inp)
    p8, pf = tl.plane_counts(lays)
    LO, HI = kn.twolevel_dims(10, p8, pf)
    S8p, _Sf, ovf = tl.twolevel_fused(FUSED_N, lays, cols, LO, HI, **kw)
    assert not bool(ovf)
    S8 = kn.twolevel_unpack(S8p.numpy(), p8, LO, 10)
    _present, states = kn.states_from_matmul(lays, [AggSpec("sum", 0)], S8,
                                             None)
    live = inp["mask"] & ok
    slot = np.where(inp["km"], inp["kv"] - inp["base"], 8)
    want = [sum(int(x) for x in v[live & (slot == g)]) for g in range(9)]
    assert [int(x) for x in states[0]["sum"][:9]] == want
    biased = v.astype(np.uint64) + np.uint64(1 << 63)
    rows = live & (slot == 3)
    for k in range(8):
        byte = ((biased >> np.uint64(8 * k)) & np.uint64(0xFF)) \
            .astype(np.int64) - 128
        assert int(S8[lays[0].byte_planes[k]][3]) == int(byte[rows].sum())


@pytest.mark.parametrize("key_kind", ["int32", "int64"])
def test_fused_overflow_flag_matches_reference(key_kind):
    """A live key outside [base, base + capacity) raises the overflow flag
    on both; one that the selection drops, or a NULL key, does not."""
    inp = fused_inputs(key_kind, "partial", seed=3)
    for live, want in ((True, True), (False, False)):
        bad = inp["kv"].copy()
        rows = np.flatnonzero(inp["mask"] == live)[:5]
        bad[rows] = inp["base"] + CAPACITY + 7 if key_kind == "int64" \
            else -300 + CAPACITY + 7
        case = dict(inp, kv=bad, km=inp["km"].copy())
        if not live:                    # a NULL key never overflows either
            case["km"][np.flatnonzero(inp["mask"])[:3]] = False
        _S8, _Sf, ovf, *_rest = reference_fused(case)
        assert ovf == want
        check_fused_against_reference(case)


def planes_from_lanes(lanes, src8, srcf, mask, n):
    """The planes the fused kernel's lanes stand for, rebuilt with torch
    ops: each distinct plane once, then repeated per ``src8``/``srcf``."""
    d8, df = max(src8) + 1, max(srcf, default=-1) + 1
    dist8, distf = [None] * d8, [None] * df
    for ln in lanes:
        ok = mask if ln.ok is None else mask & ln.ok
        if ln.ok_plane >= 0:
            dist8[ln.ok_plane] = ok.to(torch.int8)
        if ln.kind == tl.LANE_REAL:
            distf[ln.val_plane] = torch.where(ok, ln.values, 0.0) \
                .to(torch.float32)
        elif ln.kind != tl.LANE_COUNT:
            for k, byte in enumerate(kn.value_bytes(ln.values, ln.nb)):
                dist8[ln.val_plane + k] = torch.where(ok, byte, 0) \
                    .to(torch.int8)
    assert all(p is not None for p in dist8 + distf)
    return (torch.stack([dist8[d] for d in src8]),
            torch.stack([distf[e] for e in srcf]) if srcf else None)


@pytest.mark.parametrize("which", ["4n", "bytes", "real", "aliased_count"])
def test_lane_plan_repeats_every_plane(which):
    """The fused kernel accumulates each distinct plane once and copies the
    repeats: its lanes rebuild ``make_planes``' non-deduplicated planes
    exactly.  4n's 8 output planes come from 4 distinct ones."""
    rng = np.random.default_rng(31)
    n = 500
    columns = {"v": value_column(rng, n, np.int32, 2, True),
               "w": value_column(rng, n, np.int64, 3, True),
               "a": value_column(rng, n, np.int32, 1, False),
               "r": (rng.normal(0, 10, n).astype(np.float32),
                     rng.random(n) > 0.3, 0)}
    aggs = {"4n": [("count_star", None), ("count", "v"), ("sum", "v"),
                   ("avg", "v")],
            "bytes": [("sum", "w"), ("sum", "v"), ("avg", "w"),
                      ("count", "v"), ("count", "w")],
            "real": [("sum", "r"), ("avg", "r"), ("count", "r"),
                     ("sum", "a")],
            "aliased_count": [("count", "a"), ("sum", "a"), ("avg", "a"),
                              ("count_star", None)]}[which]
    inp = fused_inputs("int32", "partial", aggs, columns, n=n)
    lays, cols, _kw = port_fused_args(inp)
    mask = torch.from_numpy(inp["mask"])
    want8, wantf = kn.make_planes(lays, cols, mask)
    lanes, src8, srcf = tl.plan_lanes(lays, cols)
    got8, gotf = planes_from_lanes(lanes, src8, srcf, mask, n)
    assert torch.equal(got8, want8)
    assert (gotf is None) == (wantf is None)
    if gotf is not None:
        assert torch.equal(gotf, wantf)
    distinct = {"4n": 4, "bytes": 8, "real": 3, "aliased_count": 2}[which]
    assert max(src8) + 1 == distinct
    assert len(src8) == want8.shape[0]


def fake_h100_clusters(cs, slice_bytes):
    """Clusters an H100 holds at once: 132 SMs of 228 KB, 1 KB reserved
    per block, at most 8 blocks of 256 threads per SM (GPC limits
    ignored)."""
    per_sm = min(8, (228 * 1024) // (slice_bytes + 1024))
    return 132 * per_sm // cs


@pytest.mark.parametrize("slots,d8,df,want", [
    (1026, 4, 0, ("shared", 1)),                 # 4n: 18 KB
    (1026, 1, 1, ("shared", 1)),                 # 4r
    (65538, 3, 0, ("cluster", 4)),               # 4w: 4 × 197 KB
    (65538, 3, 1, ("cluster", 8)),               # 8 × 164 KB
    ((1 << 20) + 2, 1, 0, ("global", 0)),        # 4.2 MB
])
def test_route_follows_table_size(slots, d8, df, want):
    """Shared while one block's table fits the opt-in limit, a cluster
    while a cluster's does (4w: 4 or 8 blocks keep 33 clusters resident;
    the smaller sends fewer updates to another block), global atomics
    beyond."""
    LO, HI = kn.twolevel_dims(slots, d8, df)
    assert tl.choose_route(4 * d8 + 8 * df, LO, HI, 232448,
                           fake_h100_clusters) == want


def test_fused_wrapper_takes_the_plain_version_on_the_cpu_only():
    inp = fused_inputs("int32", "partial", seed=2)
    lays, cols, kw = port_fused_args(inp)
    p8, pf = tl.plane_counts(lays)
    LO, HI = kn.twolevel_dims(CAPACITY + 2, p8, pf)
    before = tl.launches
    got = tl.twolevel_fused(FUSED_N, lays, cols, LO, HI, **kw)
    assert tl.launches == before
    want = tl.twolevel_fused_plain(FUSED_N, lays, cols, LO, HI, **kw)
    assert torch.equal(got[0], want[0]) and bool(got[2]) == bool(want[2])
    with pytest.raises(ValueError, match="not both"):
        tl.twolevel_fused(FUSED_N, lays, cols, LO, HI,
                          **dict(kw, slot_ids=kw["key"]))
    with pytest.raises(ValueError, match="HI"):
        tl.twolevel_fused(FUSED_N, lays, cols, LO, 8, **kw)
    with pytest.raises(ValueError, match="rows"):
        tl.twolevel_fused(FUSED_N + 1, lays, cols, LO, HI, **kw)
