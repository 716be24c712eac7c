"""The cross-shard merges (``tikv_tpu_torch.device.shard``): the plain
versions of ``shard_psum``, ``shard_bucket_merge`` and ``shard_merge`` (both
kinds of segment in one launch) against numpy and against each other, and
the port's merges of stacked states against the JAX package's static host
merges ``DeviceRunner._merge_stacked`` (a simple aggregation's MIN, MAX and
FIRST over the shards) and ``_merge_bucketed`` (the flatten and trim of the
all-to-all's buckets, which the port's one-launch merge on the first card
replaces).

The kernels (CUDA only) are held bit for bit against these plain versions
by ``chip_smoke.py`` on the card; here the wrappers take the plain version
because the tensors lie on the CPU, and refuse what the kernels do not
take.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tikv_tpu.device.runner import DeviceRunner as RefRunner

from tikv_tpu_torch.device import agg_fold as af
from tikv_tpu_torch.device import shard as sh
from tikv_tpu_torch.device.runner import DeviceRunner, _fold_merge_rows
from tikv_tpu_torch.ops.agg import _BIG, AggSpec

I64 = np.iinfo(np.int64)
SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                     5e-324, 1.7e308, -1.7e308])


def _words(rng, S, W, kind):
    if kind == "f64":
        x = rng.normal(0.0, 1e3, (S, W))
        hit = rng.random((S, W)) < 0.25
        x[hit] = rng.choice(SPECIALS, int(hit.sum()))
        return x
    x = rng.integers(I64.min, I64.max, (S, W), dtype=np.int64,
                     endpoint=True)
    hit = rng.random((S, W)) < 0.25
    x[hit] = rng.choice(np.array([I64.min, I64.max, -1, 0, 1]),
                        int(hit.sum()))
    return x


def _parts(x):
    return [torch.from_numpy(np.ascontiguousarray(row)) for row in x]


def _bits(a):
    return np.asarray(a).view(np.int64)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 7, 8, 32])
@pytest.mark.parametrize("W", [1, 3, 1026, 4097])
def test_psum_plain_against_numpy(S, W):
    """int64 words add with wraparound; float64 words add in shard order,
    bit for bit (NaN, ±0.0 and ±inf included)."""
    rng = np.random.default_rng(S * 1000 + W)
    x = _words(rng, S, W, "i64")
    want = x[0].copy()
    with np.errstate(over="ignore"):
        for row in x[1:]:
            want = want + row
    assert np.array_equal(sh.shard_psum(_parts(x)).numpy(), want)
    f = _words(rng, S, W, "f64")
    want = f[0].copy()
    with np.errstate(over="ignore", invalid="ignore"):
        for row in f[1:]:
            want = want + row
    got = sh.shard_psum(_parts(f))
    assert got.dtype == torch.float64
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("op", ["min", "max"])
def test_bucket_merge_plain_against_numpy(S, op):
    """Min / max per word: the int64 values exactly as np.min / np.max; the
    float64 values NaN wherever a source is NaN (np.min's rule) and else
    np.min's value, the first NaN or the first of equal values in shard
    order kept bit for bit."""
    rng = np.random.default_rng(S + (op == "max") * 100)
    W = 777
    x = _words(rng, S, W, "i64")
    got = sh.shard_bucket_merge(_parts(x), [(0, W, f"{op}_i64")])
    assert np.array_equal(got.numpy(), getattr(np, op)(x, axis=0))
    f = _words(rng, S, W, "f64")
    got = sh.shard_bucket_merge(_parts(f), [(0, W, f"{op}_f64")]).numpy()
    with np.errstate(invalid="ignore"):
        want = getattr(np, op)(f, axis=0)
    assert np.array_equal(got, want, equal_nan=True)
    # the sequential rule, bit for bit
    acc = f[0].copy()
    for row in f[1:]:
        better = row < acc if op == "min" else row > acc
        take = ~np.isnan(acc) & (np.isnan(row) | better)
        acc = np.where(take, row, acc)
    assert np.array_equal(_bits(got), _bits(acc))


def test_segments_mix_and_leave_the_rest():
    """One launch's segments: int64 and float64 words in one buffer, the
    words outside every segment left as they were in ``out``."""
    rng = np.random.default_rng(9)
    x = _words(rng, 4, 64, "i64")
    f = _words(rng, 4, 64, "f64")
    x[:, 20:40] = f[:, 20:40].view(np.int64)
    segs = [(0, 10, "sum_i64"), (20, 20, "sum_f64"), (50, 3, "sum_i64")]
    out = torch.full((64,), 7, dtype=torch.int64)
    got = sh.shard_psum(_parts(x), segs, out=out).numpy()
    with np.errstate(over="ignore", invalid="ignore"):
        assert np.array_equal(got[:10], x.sum(0)[:10])
        fs = x[0, 20:40].view(np.float64).copy()
        for row in x[1:]:
            fs = fs + row[20:40].view(np.float64)
    assert np.array_equal(got[20:40], fs.view(np.int64))
    assert np.array_equal(got[50:53], x[:, 50:53].sum(0))
    keep = np.ones(64, bool)
    keep[:10] = keep[20:40] = keep[50:53] = False
    assert (got[keep] == 7).all()


def _random_table(rng, W, n_segs):
    """``n_segs`` disjoint segments of ``W`` words (some empty, some one
    word, some odd), each with one of the six ops."""
    cuts = np.sort(rng.choice(np.arange(1, W), 2 * n_segs - 1,
                              replace=False))
    edges = np.concatenate([[0], cuts, [W]])
    ops = list(sh._OPS)
    segs = []
    for i in range(n_segs):
        lo, hi = int(edges[2 * i]), int(edges[2 * i + 1])
        if rng.random() < 0.1:
            hi = lo                     # an empty segment
        segs.append((lo, hi - lo, ops[rng.integers(len(ops))]))
    rng.shuffle(segs)
    return segs


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 11])
@pytest.mark.parametrize("seed", range(4))
def test_merge_plain_is_the_psum_and_bucket_merge_composed(S, seed):
    """``shard_merge_plain`` over a seeded table mixing all six ops (int64
    and float64 segments in one int64 buffer, NaN, ±0.0 and ±inf among the
    float words) equals ``shard_psum_plain`` of its sum segments followed
    by ``shard_bucket_merge_plain`` of its min/max segments into the same
    output, bit for bit; the words outside every segment keep ``out``'s."""
    rng = np.random.default_rng(1000 * S + seed)
    W = int(rng.integers(40, 3000))
    segs = _random_table(rng, W, int(rng.integers(1, 12)))
    x = _words(rng, S, W, "i64")
    f = _words(rng, S, W, "f64")
    for off, n, op in segs:
        if op.endswith("_f64"):
            x[:, off:off + n] = f[:, off:off + n].view(np.int64)
    init = rng.integers(-9, 9, W, dtype=np.int64)
    got = sh.shard_merge(_parts(x), segs, out=torch.from_numpy(init.copy()))
    want = torch.from_numpy(init.copy())
    sums = [g for g in segs if g[2] in sh._SUM_OPS]
    stacked = [g for g in segs if g[2] not in sh._SUM_OPS]
    sh.shard_psum_plain(_parts(x), sums, out=want)
    sh.shard_bucket_merge_plain(_parts(x), stacked, out=want)
    assert np.array_equal(got.numpy(), want.numpy())
    keep = np.ones(W, bool)
    for off, n, _op in segs:
        keep[off:off + n] = False
    assert np.array_equal(got.numpy()[keep], init[keep])
    # and each segment against the plain rule it names, in numpy
    for off, n, op in segs:
        seg = x[:, off:off + n]
        ints = op.endswith("_i64")
        vals = seg if ints else seg.view(np.float64)
        acc = vals[0].copy()
        with np.errstate(over="ignore", invalid="ignore"):
            for row in vals[1:]:
                if op.startswith("sum"):
                    acc = acc + row
                    continue
                better = row < acc if op.startswith("min") else row > acc
                if not ints:
                    better = ~np.isnan(acc) & (np.isnan(row) | better)
                acc = np.where(better, row, acc)
        assert np.array_equal(got.numpy()[off:off + n],
                              acc if ints else acc.view(np.int64)), op


def test_merge_takes_one_kind_or_both():
    """``shard_merge`` of only sum segments equals ``shard_psum``, of only
    min/max segments ``shard_bucket_merge``; a float64 buffer merges as
    the int64 one holding its bits."""
    rng = np.random.default_rng(21)
    x = _words(rng, 4, 300, "f64")
    parts = _parts(x)
    for segs, other in (([(0, 100, "sum_f64"), (150, 50, "sum_i64")],
                         sh.shard_psum),
                        ([(0, 100, "min_f64"), (100, 200, "max_f64")],
                         sh.shard_bucket_merge)):
        init = torch.zeros(300, dtype=torch.float64)
        got = sh.shard_merge(parts, segs, out=init.clone())
        assert got.dtype == torch.float64
        assert np.array_equal(_bits(got.numpy()),
                              _bits(other(parts, segs,
                                          out=init.clone()).numpy()))
    bits = [p.view(torch.int64) for p in parts]
    segs = [(0, 150, "max_f64"), (150, 150, "sum_f64")]
    assert np.array_equal(
        sh.shard_merge(bits, segs).numpy(),
        _bits(sh.shard_merge(parts, segs).numpy()))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError):
        sh.shard_psum([])
    with pytest.raises(ValueError):
        sh.shard_psum([a] * (sh.MAX_SRC + 1))
    with pytest.raises(ValueError):
        sh.shard_psum([a, torch.zeros(8, dtype=torch.float64)])
    with pytest.raises(ValueError):
        sh.shard_psum([a, torch.zeros(9, dtype=torch.int64)])
    with pytest.raises(ValueError):
        sh.shard_psum([a, a.to(torch.int32)])
    with pytest.raises(ValueError):
        sh.shard_psum([a.view(2, 4), a.view(2, 4)])
    with pytest.raises(ValueError):
        sh.shard_psum([a, a], [(0, 8, "min_i64")])
    with pytest.raises(ValueError):
        sh.shard_bucket_merge([a, a], [(0, 8, "sum_i64")])
    with pytest.raises(ValueError):
        sh.shard_merge([a, a], [(0, 8, "sum_i32")])
    with pytest.raises(ValueError):
        sh.shard_merge([a, a], [(0, 4, "min_i64"), (4, 5, "sum_i64")])
    with pytest.raises(ValueError):
        sh.shard_merge([a, a.to(torch.float64)], [(0, 8, "max_f64")])
    with pytest.raises(ValueError):
        sh.shard_merge([a, a], [(0, 8, "max_i64")],
                       out=torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        sh.shard_psum([a, a], [(4, 5, "sum_i64")])
    with pytest.raises(ValueError):
        sh.shard_psum([a, a], out=torch.zeros(7, dtype=torch.int64))


# ------------------------------------------------- the reference's merges


@pytest.mark.parametrize("S,slots", [(2, 1026), (3, 1026), (4, 1026),
                                     (7, 1026), (8, 1026), (4, 5), (8, 3)])
def test_bucket_merge_matches_merge_bucketed(S, slots):
    """The runner's GROUP BY MIN/MAX merge — the min/max segments of its
    one ``shard_merge`` over every shard's whole buffer, a segment a
    stacked row — equals the
    reference's all-to-all (the slot axis padded to ⌈slots/S⌉·S with the
    merge identity, shard j reducing bucket j of every shard) followed by
    its host flatten and trim ``_merge_bucketed``, and the plain min / max
    over the shards."""
    rng = np.random.default_rng(S * 31 + slots)
    head = 1
    rows = [(0, "min_i64"), (1, "max_i64")]
    bufs = rng.integers(-1000, 1000, (S, head + 2 * slots), dtype=np.int64)
    segs = [(head + r * slots, slots, op) for r, op in rows]
    merged = sh.shard_bucket_merge(_parts(bufs), segs,
                                   out=torch.zeros(bufs.shape[1],
                                                   dtype=torch.int64))
    got = merged.numpy()[head:].reshape(len(rows), slots)
    # the reference's all-to-all: pad to slots_m, shard j reduces bucket j
    B = -(-slots // S)
    slots_m = B * S
    stacked = {}
    for row, op in rows:
        ident = I64.max if op == "min_i64" else I64.min
        pile = np.full((S, slots_m), ident, np.int64)
        pile[:, :slots] = bufs[:, head + row * slots:head + (row + 1) * slots]
        stacked[op[:3]] = getattr(np, op[:3])(pile.reshape(S, S, B), axis=0)
    spec = [SimpleNamespace(kind="min"), SimpleNamespace(kind="max")]
    want = RefRunner._merge_bucketed(
        spec, [{}, {}], [{"min": stacked["min"]}, {"max": stacked["max"]}],
        slots)
    assert np.array_equal(got[0], want[0]["min"])
    assert np.array_equal(got[1], want[1]["max"])
    assert np.array_equal(got[0], bufs[:, head:head + slots].min(0))
    assert np.array_equal(got[1],
                          bufs[:, head + slots:head + 2 * slots].max(0))


def test_simple_merge_matches_merge_stacked():
    """A simple aggregation's MIN, MAX and FIRST over S shards' fold
    buffers (``DeviceRunner._merge_simple``, FIRST's position made global
    by each shard's first row) against the reference's
    ``_merge_stacked`` of the same per-shard states."""
    rng = np.random.default_rng(4)
    S, n_local = 4, 256
    n = S * n_local
    v = torch.from_numpy(rng.integers(-500, 500, n).astype(np.int32))
    ok = torch.from_numpy(rng.random(n) > 0.3)
    mask = torch.from_numpy(rng.random(n) > 0.5)
    mask[:n_local + 7] = False          # shard 0 and part of 1 select none
    specs = [AggSpec("min", 0, None), AggSpec("max", 1, None),
             AggSpec("first", 2, None), AggSpec("count", 3, None)]
    outs, bases = [], []
    for s in range(S):
        lo = s * n_local
        col = (v[lo:lo + n_local].contiguous(),
               ok[lo:lo + n_local].contiguous())
        outs.append(af.agg_fold_plain(specs, [col] * 4, n_local,
                                      af.MODE_SIMPLE,
                                      mask=mask[lo:lo + n_local].contiguous()))
        bases.append(lo)
    plan = outs[0].plan
    sums, stacked, first = _fold_merge_rows(plan, 1)
    bufs = [o.buf for o in outs]
    summed = sh.shard_psum(bufs, sums).numpy()
    merged = DeviceRunner._merge_simple(summed, torch.stack(bufs).numpy(),
                                        stacked, first, plan, bases)
    _p, _o, states = af.decode(merged, plan, 1)
    per = [af.decode(b.numpy(), plan, 1)[2] for b in bufs]
    ref_specs = [SimpleNamespace(kind=s.kind) for s in specs]
    summed_states, stacked_states = [], []
    for i, spec in enumerate(specs):
        sm, st = {}, {}
        for key in ("min", "max"):
            if spec.kind == key:
                st[key] = np.array([p[i][key][0] for p in per])
        if spec.kind == "first":
            st["pos"] = np.array([p[i]["pos"][0] + b if p[i]["pos"][0] != _BIG
                                  else _BIG for p, b in zip(per, bases)])
            st["value"] = np.array([p[i]["value"][0] for p in per])
        if spec.kind == "count":
            sm["count"] = np.array(sum(p[i]["count"][0] for p in per))
        summed_states.append(sm)
        stacked_states.append(st)
    want = RefRunner._merge_stacked(ref_specs, summed_states, stacked_states)
    assert states[0]["min"][0] == want[0]["min"]
    assert states[1]["max"][0] == want[1]["max"]
    assert states[2]["pos"][0] == want[2]["pos"]
    assert states[2]["value"][0] == want[2]["value"]
    assert states[3]["count"][0] == want[3]["count"]
    # and against the whole rows at once
    sel = mask.numpy()
    vv, oo = v.numpy(), ok.numpy()
    first_row = int(np.flatnonzero(sel)[0])
    assert states[2]["pos"][0] == first_row
    assert states[0]["min"][0] == vv[sel & oo].min()
    assert states[1]["max"][0] == vv[sel & oo].max()
    assert states[3]["count"][0] == int((sel & oo).sum())
