"""The port's torch aggregation tiles against the JAX package's.

``simple_agg_tile`` and ``hash_agg_tile`` of ``tikv_tpu_torch/ops/agg.py``
(torch on the CPU) and of ``tikv_tpu/ops/agg.py`` (jax.numpy with x64, the
reference's device path) reduce the same seeded NULL-bearing columns under
the same row mask, for every aggregate kind the device serves, over int32,
int64 and float32 values.  States are compared after the reference
runner's carry cast (integers to int64, floats to float64):

- counts, integer sums, MIN and MAX exactly;
- FIRST against the host's rule (the first selected row, its value and
  validity), exactly: the reference's device takes the first valid row
  instead (fault 8, pinned in ``test_torch_first.py``);
- REAL sums within 1e-6·Σ|v| (the reference sums a tile in float32, the
  port in float64);
- the variance moments (float64 on both sides) within 1e-12 relative.

The finalizes then turn the same numpy states into equal rows.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tikv_tpu.ops import agg as ref_agg

import torch

from tikv_tpu_torch.ops import agg

KINDS = ("count", "count_star", "sum", "avg", "min", "max", "first",
         "var_pop", "var_samp", "stddev_pop", "stddev_samp")
DTYPES = ("int32", "int64", "float32")
N = 3001


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)


def columns(dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        v = rng.normal(0.0, 1000.0, N).astype(np.float32)
    elif dtype == "int64":
        v = rng.integers(-(1 << 40), 1 << 40, N).astype(np.int64)
    else:
        v = rng.integers(-1000, 1000, N).astype(np.int32)
    ok = rng.random(N) > 0.15
    v = np.where(ok, v, 0).astype(v.dtype)
    mask = rng.random(N) > 0.2
    return v, ok, mask


def specs_for(kinds, dtype):
    et = "real" if dtype == "float32" else "int"
    return ([agg.AggSpec(k, i, agg.EvalType(et)) for i, k in enumerate(kinds)],
            [ref_agg.AggSpec(k, i, ref_agg.EvalType(et))
             for i, k in enumerate(kinds)])


def canon(x):
    x = np.asarray(x)
    return x.astype(np.float64) if x.dtype.kind == "f" else x.astype(np.int64)


def assert_states_agree(got, want, kinds, v, ok):
    """got/want: per-spec state dicts (numpy-convertible)."""
    is_real = v.dtype.kind == "f"
    for kind, g, w in zip(kinds, got, want):
        assert g.keys() == w.keys(), kind
        for key in g:
            gv, wv = canon(g[key]), canon(w[key])
            assert gv.shape == wv.shape, (kind, key)
            if key in ("sum", "sumsq") and (is_real or kind.startswith(
                    ("var", "stddev"))):
                if kind in ("sum", "avg"):
                    scale = np.abs(np.where(ok, v, 0)).sum()
                    assert np.all(np.abs(gv - wv) <= 1e-6 * scale), \
                        (kind, key)
                else:
                    np.testing.assert_allclose(gv, wv, rtol=1e-12, atol=0)
            else:
                np.testing.assert_array_equal(gv, wv, err_msg=f"{kind} {key}")


def assert_simple_states_agree(specs, ref_specs, got, want, kinds, v, ok,
                               mask):
    """Simple states: every kind but FIRST against the reference's, FIRST
    against the host's rule (the first selected row, its value and
    validity; None when no row is selected), and the finalizes."""
    fi = kinds.index("first")
    sel = np.flatnonzero(mask)
    first = got[fi]
    if sel.size:
        at = int(sel[0])
        assert int(first["pos"]) == at and int(first["ok"]) == ok[at]
        assert canon(first["value"]) == canon(v[at])
        answer = v[at].item() if ok[at] else None
    else:
        assert int(first["pos"]) == agg._BIG and int(first["ok"]) == 0
        answer = None
    rest = [i for i in range(len(kinds)) if i != fi]
    assert_states_agree([got[i] for i in rest], [want[i] for i in rest],
                        [kinds[i] for i in rest], v, ok & mask)
    fin = agg.finalize_simple(specs, got)
    assert fin[fi] == answer
    assert [fin[i] for i in rest] == ref_agg.finalize_simple(
        [ref_specs[i] for i in rest], [got[i] for i in rest])


@pytest.mark.parametrize("dtype", DTYPES)
def test_simple_agg_tile_matches_reference(dtype):
    v, ok, mask = columns(dtype, 1)
    specs, ref_specs = specs_for(KINDS, dtype)
    okm = ok & mask
    cols = [(torch.from_numpy(v), torch.from_numpy(okm))] * len(KINDS)
    ref_cols = [(jnp.asarray(v), jnp.asarray(okm))] * len(KINDS)
    n_valid = int(mask.sum())
    got = agg.simple_agg_tile(specs, cols, torch.tensor(n_valid),
                              torch.from_numpy(mask))
    want = ref_agg.simple_agg_tile(jnp, ref_specs, ref_cols,
                                   n_valid_rows=n_valid)
    got = [{k: t.numpy() for k, t in s.items()} for s in got]
    want = [{k: np.asarray(x) for k, x in s.items()} for s in want]
    assert_simple_states_agree(specs, ref_specs, got, want, KINDS, v, ok,
                               mask)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("keys", ["dense", "sparse"])
def test_hash_agg_tile_matches_reference(dtype, keys):
    v, ok, mask = columns(dtype, 2)
    rng = np.random.default_rng(3)
    capacity, base = 1024, -40
    specs, ref_specs = specs_for(KINDS, dtype)
    cols = [(torch.from_numpy(v), torch.from_numpy(ok))] * len(KINDS)
    ref_cols = [(jnp.asarray(v), jnp.asarray(ok))] * len(KINDS)
    if keys == "dense":
        # keys around base, NULL keys, a few beyond the capacity (overflow)
        kv = (base + rng.integers(-3, capacity + 3, N)).astype(np.int64)
        km = rng.random(N) > 0.1
        key, ref_key = (torch.from_numpy(kv), torch.from_numpy(km)), \
            (jnp.asarray(kv), jnp.asarray(km))
        tile_base, ref_base = base, base
    else:
        slot_ids = rng.integers(0, capacity + 1, N).astype(np.int32)
        # the key pair is unused beside precomputed slot ids (the
        # reference's scatter body passes zeros)
        zeros = np.zeros(N, np.int32)
        key = (torch.from_numpy(zeros), torch.from_numpy(mask))
        ref_key = (jnp.asarray(zeros), jnp.asarray(mask))
        tile_base = ("precomp", torch.from_numpy(slot_ids))
        ref_base = ("precomp", jnp.asarray(slot_ids))
    got = agg.hash_agg_tile(specs, key, cols, capacity, tile_base,
                            torch.from_numpy(mask))
    want = ref_agg.hash_agg_tile(jnp, ref_specs, ref_key, ref_cols, capacity,
                                 ref_base, row_mask=jnp.asarray(mask))
    np.testing.assert_array_equal(got["present"].numpy(),
                                  np.asarray(want["present"]))
    assert bool(got["overflow"]) == bool(want["overflow"])
    g_states = [{k: t.numpy() for k, t in s.items()} for s in got["states"]]
    w_states = [{k: np.asarray(x) for k, x in s.items()}
                for s in want["states"]]
    okm = ok & mask
    assert_states_agree(g_states, w_states, KINDS, v, okm)
    # the device finalize serves every kind but FIRST with GROUP BY
    served = [i for i, k in enumerate(KINDS) if k != "first"]
    fin_specs = [specs[i] for i in served]
    fin_ref = [ref_specs[i] for i in served]
    state = {"present": got["present"].numpy(),
             "states": [g_states[i] for i in served]}
    assert agg.finalize_hash(fin_specs, state, base, capacity) == \
        ref_agg.finalize_hash(fin_ref, state, base, capacity)


def test_minmax_identities_per_dtype():
    """Each device value dtype gets its own MIN/MAX identity (torch
    dtypes carry no numpy ``kind`` to derive one from)."""
    for dt, np_dt in ((torch.int32, np.int32), (torch.int64, np.int64),
                      (torch.float32, np.float32)):
        for is_min in (True, False):
            want = ref_agg._minmax_identity(jnp, np_dt, is_min)
            assert agg._minmax_identity(dt, is_min) == want
    with pytest.raises(ValueError, match="MIN/MAX"):
        agg._minmax_identity(torch.bool, True)


def test_empty_states_finalize_to_null():
    specs = [agg.AggSpec(k, i) for i, k in enumerate(KINDS)]
    empty = {"count": 0, "sum": 0, "nonnull": 0, "min": 0, "max": 0,
             "pos": agg._BIG, "value": 0, "sumsq": 0.0}
    assert agg.finalize_simple(specs, [empty] * len(specs)) == \
        [0, 0] + [None] * (len(KINDS) - 2)
