"""The parts of the two launch-bound kernels' contracts that run on the CPU.

``digest.patch_feed_rows`` (every plane of a feed that shares the
positions in one launch, the recorded digest updated in it): its plain
version against the reference's ``_dus`` (runner.py:1816),
``_range_digest_kernel`` (:1981) and ``_patch_plane`` (:1793) plane by
plane over bool, int32, int64 and float64 planes at 1, 2 and 257 rows; the
refusals, made once for all planes; the one-plane call against
``patch_rows``; the runner's ``_patch_plane`` against the reference's
rule; the packed launch (``plan_patch`` / ``pack_patch``: the parameter
block, inline or through a payload on the card, with the scratch of the
several-blocks path) decoded and replayed in numpy against the plain
version; and the mint's spill patch, one call for every plane, against the
reference's mint.

``shard.shard_psum`` / ``shard_bucket_merge`` / ``shard_merge``: the
packed parameter blocks (``plan_layout`` / ``bind``: segments inline up to
``INLINE_SEGS``, a table past it, the layout cache) decoded with a layout
written from ``csrc/shard_merge.cu``'s ``MergeArgs<S>`` and replayed in
numpy against the plain versions and numpy at S = 2, 4, 5 and 8, sum and
min/max segments apart and mixed in one block.

Every comparison is exact: digests are integers mod 2^64, the merges are
bit-equal.  The kernels themselves run only on the card (``chip_smoke.py``
holds them to these plain versions).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.device.supervisor import host_plane_digest as ref_digest
from tikv_tpu.parallel import make_mesh

from tikv_tpu_torch.copr.region_cache import build_region_columnar_device
from tikv_tpu_torch.device import digest as dg
from tikv_tpu_torch.device import mvcc as pm
from tikv_tpu_torch.device import shard as sh
from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.testing import mvcc as tm

from tests.test_torch_mvcc import (KINDS, _history, _ref_col, _ref_feed,
                                   _same_feed, infos_of, port_table,
                                   ref_table, to_ref)

N = 3001
U64 = 2 ** 64
PLANE_DTYPES = ("bool", "int32", "int64", "float64")


@pytest.fixture(scope="module")
def ref():
    return RefRunner(mesh=make_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def port():
    return DeviceRunner(device="cpu")


def plane(dtype: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(n) < 0.5
    if dtype.startswith("float"):
        return rng.normal(0.0, 1e6, n).astype(dtype)
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max, n, dtype=np.int64, endpoint=True) \
        .astype(dtype)
    a[:2] = np.array([info.min, info.max], dtype)[:n]
    return a


def _bits(x: np.ndarray) -> np.ndarray:
    if x.dtype == np.bool_:
        return x.astype(np.uint64)
    return x.view(f"u{x.dtype.itemsize}").astype(np.uint64)


def _h(x: np.ndarray, pos: np.ndarray) -> int:
    """Σ bits·(2q+1) mod 2^64 over the positions q."""
    return sum(int(b) * (2 * int(q) + 1)
               for b, q in zip(_bits(x), pos)) % U64


def _case(m: int, seed: int):
    """Four planes of N rows, m unique positions, each plane's values and
    its recorded (host-truth) digest."""
    rng = np.random.default_rng(seed)
    pos = rng.choice(N, m, replace=False)
    planes = [plane(dt, N, seed + i) for i, dt in enumerate(PLANE_DTYPES)]
    vals = [plane(dt, m, seed + 10 + i)
            for i, dt in enumerate(PLANE_DTYPES)]
    recorded = [ref_digest(a, N) for a in planes]
    return pos, planes, vals, recorded


@pytest.mark.parametrize("m", [1, 2, 257])
def test_multi_plane_patch_matches_reference(ref, m):
    """One ``patch_feed_rows`` over four planes equals, plane by plane,
    the reference's ``_dus`` of each row, the single-row
    ``_range_digest_kernel`` digests of the old and new elements summed,
    and the recorded digest its ``_patch_plane`` keeps row by row."""
    pos, planes, vals, recorded = _case(m, 100 + m)
    got = [torch.from_numpy(a.copy()) for a in planes]
    out = dg.patch_feed_rows(got, pos, [torch.from_numpy(v) for v in vals],
                             recorded)
    assert out.shape == (4, 3) and out.dtype == torch.int64
    for fi, (a, v) in enumerate(zip(planes, vals)):
        rng = ref._range_digest_kernel(a.dtype, N)

        def h(arr):
            return sum(int(np.asarray(rng(arr, jnp.asarray(int(q)),
                                          jnp.asarray(int(q) + 1))))
                       for q in pos) % U64

        flat = [jnp.asarray(a)]
        digests = [recorded[fi]]
        old = flat[0]
        for q, x in zip(pos, v):
            flat[0] = ref._patch_plane(None, digests, flat, 0,
                                       np.asarray([x], a.dtype), int(q))
        want = np.asarray(flat[0])
        assert got[fi].numpy().tobytes() == want.tobytes()
        assert dg.as_u64(out[fi, 0]) == h(old) == _h(a[pos], pos)
        assert dg.as_u64(out[fi, 1]) == h(flat[0]) == _h(v, pos)
        assert dg.as_u64(out[fi, 2]) == int(digests[0]) % U64
        # the rule equals a full re-hash of the patched plane
        assert dg.as_u64(out[fi, 2]) == ref_digest(want, N)


def test_patch_refuses_once_for_all_planes():
    """A duplicate position, one past the shortest plane, or a count of
    values, value arrays or digests that does not match is refused before
    any plane is written."""
    a = torch.zeros(10, dtype=torch.int32)
    b = torch.zeros(8, dtype=torch.bool)
    one = [torch.tensor([1, 2, 3], dtype=torch.int32),
           torch.tensor([True, True, True])]
    with pytest.raises(ValueError, match="duplicate"):
        dg.patch_feed_rows([a, b], [3, 4, 3], one)
    with pytest.raises(ValueError, match="outside"):
        dg.patch_feed_rows([a, b], [1, 2, 8], one)     # past b, not a
    with pytest.raises(ValueError, match="positions"):
        dg.patch_feed_rows([a, b], [1, 2], one)
    with pytest.raises(ValueError, match="value arrays"):
        dg.patch_feed_rows([a, b], [1, 2, 3], one[:1])
    with pytest.raises(ValueError, match="digests"):
        dg.patch_feed_rows([a, b], [1, 2, 3], one, [0])
    with pytest.raises(ValueError, match="no plane"):
        dg.patch_feed_rows([], [1], [])
    assert not a.any() and not b.any()


@pytest.mark.parametrize("dtype", PLANE_DTYPES + ("int8", "float32"))
def test_one_plane_call_equals_patch_rows(dtype):
    a = plane(dtype, N, 7)
    v = plane(dtype, 64, 8)
    pos = np.random.default_rng(9).choice(N, 64, replace=False)
    x, y = torch.from_numpy(a.copy()), torch.from_numpy(a.copy())
    sums = dg.patch_rows(x, pos, torch.from_numpy(v), digest=True)
    out = dg.patch_feed_rows([y], pos, [v], [0])
    assert x.numpy().tobytes() == y.numpy().tobytes()
    assert dg.as_u64(sums[0]) == dg.as_u64(out[0, 0]) == _h(a[pos], pos)
    assert dg.as_u64(sums[1]) == dg.as_u64(out[0, 1]) == _h(v, pos)
    assert dg.as_u64(out[0, 2]) == (_h(v, pos) - _h(a[pos], pos)) % U64
    assert dg.patch_rows(x, pos[:3], v[:3]) is None
    assert dg.patch_feed_rows([y], pos[:3], [v[:3]]) is None


def test_patch_plane_rule_matches_reference(ref, port):
    """The runner's ``_patch_plane`` (one launch: rows and record) keeps
    the recorded digest as the reference's ``_patch_plane`` does span by
    span, over three patches, each reading the last one's record."""
    n = 3000
    cols = [(plane("int64", n, 31), np.ones(n, np.bool_))]
    feed = port._build_flat(cols, n)
    host = cols[0][0].copy()
    flat = [jnp.asarray(host)]
    digests = [ref_digest(host, n)]
    for spans, vals in (([(5, 6), (2999, 3000)], [-1, 7]),
                        ([(0, 1), (6, 7)], [11, 3]),
                        ([(100, 164)], list(range(-32, 32)))):
        port._patch_plane(feed, spans, [torch.tensor(vals)], [0])
        at = 0
        for lo, hi in spans:
            flat[0] = ref._patch_plane(None, digests, flat, 0, np.asarray(
                vals[at:at + hi - lo], np.int64), lo)
            at += hi - lo
        assert dg.as_u64(feed["digests"][0]) == int(digests[0]) % U64
        assert feed["flat"][0][:n].numpy().tobytes() == \
            np.asarray(flat[0]).tobytes()
    assert port.scrub_feed(feed) == []


# ------------------------------------------------ the packed patch launch

_DESC = np.dtype([("plane", "<u8"), ("vals", "<u8"), ("rec", "<u8"),
                  ("rec_value", "<u8"), ("val_off", "<i8"),
                  ("width", "<i4"), ("pad", "<i4")])
_HEAD = np.dtype([("table", "<u8"), ("out", "<u8"), ("m", "<i8"),
                  ("pos_off", "<i8"), ("scratch_off", "<i8"),
                  ("rows_per_block", "<i4"), ("n_spans", "<i4")])


def _replay_patch(args: np.ndarray, payload: np.ndarray, mem: dict, P: int):
    """``patch_kernel`` in numpy: decode the block (``struct PatchArgs``
    and ``PatchPlane`` of csrc/digest.cu), write the planes found in
    ``mem`` (address → tensor) and return the (P, 3) digests or None."""
    head = np.frombuffer(args[:48].tobytes(), _HEAD)[0]
    assert head["n_spans"] == 0         # the positions form
    pay = args[48:] if head["table"] == 0 else payload
    m = int(head["m"])
    pos = pay[head["pos_off"]:head["pos_off"] + 8 * m].view(np.int64)
    out = np.zeros((P, 3), np.uint64)
    for p in range(P):
        d = np.frombuffer(pay[48 * p:48 * (p + 1)].tobytes(), _DESC)[0]
        target = mem[int(d["plane"])].numpy()
        w = int(d["width"])
        raw = target.view(np.uint8).reshape(-1, w) if w > 1 else \
            target.view(np.uint8).reshape(-1, 1)
        if d["vals"]:
            src = mem[int(d["vals"])].numpy().view(np.uint8)
        else:
            src = pay[d["val_off"]:d["val_off"] + w * m]
        new = src.reshape(-1, w)
        old = raw[pos].copy()
        raw[pos] = new
        weights = 2 * pos.astype(np.uint64) + 1

        def h(rows):
            u = rows.copy().view(f"u{w}").reshape(-1).astype(np.uint64)
            with np.errstate(over="ignore"):
                return int((u * weights).sum()) % U64

        rec = int(mem[int(d["rec"])].numpy().view(np.uint64).reshape(-1)[0]) \
            if d["rec"] else int(d["rec_value"])
        out[p] = (h(old), h(new), (rec - h(old) + h(new)) % U64)
    return out if head["out"] else None


@pytest.mark.parametrize("m", [2, 257, 3000])
@pytest.mark.parametrize("digest", [True, False])
@pytest.mark.parametrize("on_card", [False, True])
def test_packed_patch_replays_the_plain_version(m, digest, on_card):
    """``plan_patch`` + ``pack_patch`` as the CUDA wrapper calls them:
    the payload inline where it fits a parameter class, else on the card
    with the several-blocks scratch (zeroed tickets); values in the
    payload or read where they lie (``on_card``), recorded digests by
    value or by address.  The numpy replay of the kernel equals the plain
    version."""
    pos, planes, vals, recorded = _case(m, 300 + m)
    ts = [torch.from_numpy(a.copy()) for a in planes]
    want = [torch.from_numpy(a.copy()) for a in planes]
    vts = [torch.from_numpy(v) for v in vals]
    recs_t = torch.tensor([r - U64 if r >> 63 else r for r in recorded],
                          dtype=torch.int64)
    # plane 3's record by address (a 0-d tensor, as a previous patch's R')
    recs = [(0, r) for r in recorded[:3]] + [(recs_t[3:].data_ptr(), 0)]
    lay = dg.plan_patch([t.element_size() for t in ts], m,
                        [not on_card] * 4, digest)
    assert lay.grid_x == -(-m // dg.PATCH_ROWS)
    assert (lay.scratch_off > 0) == (digest and lay.grid_x > 1)
    assert (lay.inline is None) == (lay.scratch_off > 0 or
                                    lay.size > dg.PATCH_INLINE[-1])
    if m == 2:      # the runner's two-row patch of three planes rides inline
        assert lay.inline is not None
    out = torch.zeros((4, 3), dtype=torch.int64)
    args, pay = dg.pack_patch(
        lay, ts, pos.astype(np.int64),
        [v.data_ptr() for v in vts] if on_card else list(vals), recs,
        out.data_ptr() if digest else 0, 0 if lay.inline else 1 << 40)
    assert args.size == 48 + (lay.inline or 16)
    if lay.scratch_off:
        assert not pay[lay.scratch_off:].any()
    mem = {t.data_ptr(): t for t in ts + vts}
    mem[recs_t[3:].data_ptr()] = recs_t[3:]
    got = _replay_patch(args, pay, mem, 4)
    plain = dg.patch_feed_rows_plain(want, torch.from_numpy(pos), vts,
                                     recorded if digest else None)
    for a, b in zip(ts, want):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    if digest:
        assert [[dg.as_u64(x) for x in row] for row in plain] == \
            got.astype(object).tolist()
    else:
        assert got is None and plain is None


def test_spill_mint_is_one_patch_for_every_plane(ref, port, monkeypatch):
    """The mint writes the CF_DEFAULT spill rows of every value and
    validity plane with one ``patch_feed_rows`` call; the feed equals the
    reference's mint of the same bundle."""
    calls = []
    real = pm.patch_feed_rows

    def counted(planes, rows, cells, *rest):
        calls.append(len(planes))
        return real(planes, rows, cells, *rest)

    monkeypatch.setattr(pm, "patch_feed_rows", counted)
    planes, read_ts = _history("mixed")
    rows = pm.resolve_host(planes, read_ts)[::7]
    spilled, defaults = tm.spill(planes, rows)
    rt = ref_table(1, KINDS)
    infos, rinfos = infos_of(rt, True), infos_of(rt, False)
    dtypes = ["int64", "int32", "float32", "int32"]
    tbl, _safe, bundle = build_region_columnar_device(
        spilled, port_table(rt), infos, read_ts, port.mvcc_resolver(),
        defaults=defaults)
    got = bundle.mint(port, infos, dtypes, len(tbl), port._pad_rows(len(tbl)))
    assert calls == [len(got["flat"]) - 1]      # every plane but the handle
    mirror = (tbl.handles, {c: _ref_col(col)
                            for c, col in tbl.columns.items()})
    want, _n = _ref_feed(ref, to_ref(spilled), rinfos, dtypes, read_ts,
                         spill=dict.fromkeys(sorted(bundle.spill_patches),
                                             True), mirror=mirror)
    _same_feed(got, want)


# ------------------------------------------- the shard merges' packing

_SEG = np.dtype([("off", "<i8"), ("len", "<i8"), ("op", "<i4"),
                 ("pad", "<i4")])
_OPS = ("sum_i64", "sum_f64", "min_i64", "max_i64", "min_f64", "max_f64")


def _merge_args(sc: int) -> np.dtype:
    """``struct MergeArgs<sc>`` as csrc/shard_merge.cu lays it out."""
    return np.dtype([("src", "<u8", (sc or 32,)), ("out", "<u8"),
                     ("table", "<u8"), ("seg", _SEG, (8,)),
                     ("n_segs", "<i4"), ("vec", "<i4"), ("n_src", "<i4"),
                     ("pad", "<i4")])


def _replay_merge(lay, mem: dict) -> None:
    """Both merge kernels in numpy over the bound block of ``lay``."""
    dt = _merge_args(lay.sc)
    assert dt.itemsize == ctypes.sizeof(lay.args)
    rec = np.frombuffer(bytes(lay.args), dt)[0]
    S = int(rec["n_src"])
    src = [mem[int(p)].numpy() for p in rec["src"][:S]]
    out = mem[int(rec["out"])].numpy()
    segs = rec["seg"][:lay.n_y] if rec["table"] == 0 else np.frombuffer(
        mem[int(rec["table"])].numpy().tobytes(), _SEG)[:lay.n_y]
    assert (rec["table"] == 0) == (rec["n_segs"] <= sh.INLINE_SEGS)
    for off, n, op, _pad in segs:
        op = _OPS[op]
        sl = slice(int(off), int(off) + int(n))
        view = (lambda x: x[sl].view(np.float64)) if op.endswith("f64") \
            else (lambda x: x[sl])
        acc = view(src[0]).copy()
        with np.errstate(over="ignore", invalid="ignore"):
            for x in src[1:]:
                v = view(x)
                if op.startswith("sum"):
                    acc = acc + v
                    continue
                better = v < acc if op.startswith("min") else v > acc
                if op.endswith("f64"):
                    better = ~np.isnan(acc) & (np.isnan(v) | better)
                acc = np.where(better, v, acc)
        out[sl] = acc.view(np.int64)


def _words(rng, S: int, W: int) -> np.ndarray:
    x = rng.normal(0.0, 1e3, (S, W)).view(np.int64)
    x[:, ::3] = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                             (S, len(range(0, W, 3))), dtype=np.int64)
    return x


@pytest.mark.parametrize("S", [2, 4, 5, 8])
@pytest.mark.parametrize("n_segs", [1, 3, 8, 9, 40])
@pytest.mark.parametrize("sums", [True, False])
def test_merge_packing_replays_the_plain_version(S, n_segs, sums):
    """Segments inline up to ``INLINE_SEGS`` and in a table past it, the
    block of S = 5 on the general path: the replayed launch equals the
    plain version and numpy, every word outside the segments kept."""
    rng = np.random.default_rng(S * 100 + n_segs)
    W = 16 * n_segs + 5
    x = _words(rng, S, W)
    parts = [torch.from_numpy(np.ascontiguousarray(r)) for r in x]
    ops = ("sum_i64", "sum_f64") if sums else \
        ("min_i64", "max_f64", "max_i64", "min_f64")
    segs = [(16 * i + i % 3, 9 + i % 5, ops[i % len(ops)])
            for i in range(n_segs)]
    out = torch.full((W,), 7, dtype=torch.int64)
    vec = len({t.data_ptr() & 15 for t in (*parts, out)}) == 1
    lay = sh.plan_layout(S, segs, vec, sms=132)
    assert lay.sc == (S if S in (2, 4, 8) else 0) and lay.n_y == n_segs
    assert (lay.table_host is None) == (n_segs <= sh.INLINE_SEGS)
    sh.bind(lay, parts, out, lay.table_host)
    mem = {t.data_ptr(): t for t in (*parts, out)}
    if lay.table_host is not None:
        mem[lay.table_host.data_ptr()] = lay.table_host
    _replay_merge(lay, mem)
    plain = (sh.shard_psum_plain if sums else sh.shard_bucket_merge_plain)(
        parts, segs, out=torch.full((W,), 7, dtype=torch.int64))
    assert torch.equal(out, plain)
    keep = np.ones(W, bool)
    for off, n, _op in segs:
        keep[off:off + n] = False
    assert (out.numpy()[keep] == 7).all()
    if sums and set(op for _o, _n, op in segs) == {"sum_i64"}:
        with np.errstate(over="ignore"):
            assert np.array_equal(out.numpy()[~keep], x.sum(0)[~keep])


@pytest.mark.parametrize("S", [2, 4, 5, 8])
@pytest.mark.parametrize("n_segs", [2, 3, 8, 9, 40])
def test_mixed_merge_packing_replays_the_plain_version(S, n_segs):
    """The block of a ``shard_merge`` whose segments mix sums with min/max
    (inline and in a table) replays as ``shard_merge_plain`` and as the
    psum of its sum segments followed by the bucket merge of the rest."""
    rng = np.random.default_rng(S * 1000 + n_segs)
    W = 16 * n_segs + 5
    x = _words(rng, S, W)
    parts = [torch.from_numpy(np.ascontiguousarray(r)) for r in x]
    segs = [(16 * i + i % 3, 9 + i % 5, _OPS[(i * 5) % len(_OPS)])
            for i in range(n_segs)]
    assert {op in sh._SUM_OPS for _o, _n, op in segs} == {True, False}
    out = torch.full((W,), 7, dtype=torch.int64)
    vec = len({t.data_ptr() & 15 for t in (*parts, out)}) == 1
    lay = sh.plan_layout(S, segs, vec, sms=132)
    assert (lay.table_host is None) == (n_segs <= sh.INLINE_SEGS)
    sh.bind(lay, parts, out, lay.table_host)
    mem = {t.data_ptr(): t for t in (*parts, out)}
    if lay.table_host is not None:
        mem[lay.table_host.data_ptr()] = lay.table_host
    _replay_merge(lay, mem)
    plain = sh.shard_merge_plain(parts, segs,
                                 out=torch.full((W,), 7, dtype=torch.int64))
    assert torch.equal(out, plain)
    two = torch.full((W,), 7, dtype=torch.int64)
    sh.shard_psum_plain(parts, [g for g in segs if g[2] in sh._SUM_OPS],
                        out=two)
    sh.shard_bucket_merge_plain(
        parts, [g for g in segs if g[2] not in sh._SUM_OPS], out=two)
    assert torch.equal(out, two)


def test_merge_layouts_are_cached(monkeypatch):
    """One packed block a layout: a second request of the same segments,
    source count and phase rule (every block on one 16-byte phase, or
    not) reuses it with its own pointers; another segment list or phase
    rule packs anew."""
    monkeypatch.setattr(sh, "_sms", lambda dev: 132)
    monkeypatch.setattr(sh, "_LAYOUTS", {})
    dev = torch.device("cpu")
    rng = np.random.default_rng(3)
    x = _words(rng, 4, 64)
    parts = [torch.from_numpy(np.ascontiguousarray(r)) for r in x]
    out = torch.zeros(64, dtype=torch.int64)
    segs = [(0, 64, "sum_i64")]
    first = sh._layout(dev, parts, segs, out)
    again = sh._layout(dev, [p.clone() for p in parts], segs, out.clone())
    assert again is first
    assert sh._layout(dev, parts, [(0, 32, "sum_i64")], out) is not first
    shifted = [p[1:] for p in parts]
    short = [(0, 63, "sum_i64")]
    one_phase = sh._layout(dev, shifted, short, out[1:])
    assert sh._layout(dev, [p[:-1] for p in parts], short,
                      out[:-1]) is one_phase       # every block on one phase
    assert sh._layout(dev, shifted, short, out[:-1]) \
        is not one_phase                           # mixed phases: no pairs
    many = [(2 * i, 2, "sum_i64") for i in range(20)]
    table = sh._layout(dev, parts, many, out)
    assert table.table_host is not None
    assert sh._layout(dev, parts, many, out) is table
    got = torch.full((64,), 5, dtype=torch.int64)
    sh.bind(table, parts, got, table.table_host)
    mem = {t.data_ptr(): t for t in (*parts, got)}
    mem[table.table_host.data_ptr()] = table.table_host
    _replay_merge(table, mem)
    want = sh.shard_psum_plain(parts, many,
                               out=torch.full((64,), 5, dtype=torch.int64))
    assert torch.equal(got, want)


def test_merge_refuses_more_segments_than_a_grid_holds():
    a = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="segments"):
        sh.shard_psum([a, a], [(0, 1, "sum_i64")] * (sh.MAX_Y + 1))


# ------------------------------------------------ the span form of a patch
#
# ``digest.patch_feed_spans``: the journal's sorted, disjoint row spans of
# every plane in one launch.  Its plain version against the reference's
# ``_dus`` over each span (runner.py:1816) and ``_range_digest_kernel``'s
# R' rule around each (:1793-1814); the refusals; the packed launch
# (``plan_spans`` / ``pack_spans``) decoded and replayed in numpy.

SPAN_CASES = {
    "one row": [(5, 6)],
    "four spans": [(0, 3), (40, 297), (1000, 1001), (2990, 3001)],
    "long spans": [(100, 1125), (1200, 1457)],
}


def _span_case(spans, seed: int):
    """Four planes of N rows, the spans' values end to end per plane, and
    each plane's recorded digest."""
    m = sum(hi - lo for lo, hi in spans)
    planes = [plane(dt, N, seed + i) for i, dt in enumerate(PLANE_DTYPES)]
    vals = [plane(dt, m, seed + 10 + i)
            for i, dt in enumerate(PLANE_DTYPES)]
    return m, planes, vals, [ref_digest(a, N) for a in planes]


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_span_patch_matches_reference(ref, case):
    """One ``patch_feed_spans`` over four planes equals, plane by plane,
    the reference's ``_dus`` of each span and the recorded digest its
    ``_patch_plane`` keeps span by span (H of the old and the new span by
    ``_range_digest_kernel``); H(old) and H(new) are those range digests
    summed."""
    spans = SPAN_CASES[case]
    m, planes, vals, recorded = _span_case(spans, 500 + len(spans))
    got = [torch.from_numpy(a.copy()) for a in planes]
    out = dg.patch_feed_spans(got, spans, [torch.from_numpy(v)
                                           for v in vals], recorded)
    assert out.shape == (4, 3) and out.dtype == torch.int64
    pos = dg.span_positions(spans)
    assert len(pos) == m
    for fi, (a, v) in enumerate(zip(planes, vals)):
        rng = ref._range_digest_kernel(a.dtype, N)
        flat = [jnp.asarray(a)]
        digests = [recorded[fi]]
        h_old = h_new = 0
        i = 0
        for lo, hi in spans:
            span = (jnp.asarray(lo), jnp.asarray(hi))
            h_old += int(np.asarray(rng(flat[0], *span)))
            flat[0] = ref._patch_plane(None, digests, flat, 0,
                                       v[i:i + hi - lo], lo)
            h_new += int(np.asarray(rng(flat[0], *span)))
            i += hi - lo
        want = np.asarray(flat[0])
        assert got[fi].numpy().tobytes() == want.tobytes()
        assert dg.as_u64(out[fi, 0]) == h_old % U64 == _h(a[pos], pos)
        assert dg.as_u64(out[fi, 1]) == h_new % U64 == _h(v, pos)
        assert dg.as_u64(out[fi, 2]) == int(digests[0]) % U64 == \
            ref_digest(want, N)


def test_span_patch_equals_the_positions_form():
    """The span form writes what ``patch_feed_rows`` writes at the
    positions its spans cover, with the same digests."""
    spans = SPAN_CASES["four spans"]
    m, planes, vals, recorded = _span_case(spans, 77)
    a = [torch.from_numpy(x.copy()) for x in planes]
    b = [torch.from_numpy(x.copy()) for x in planes]
    out_s = dg.patch_feed_spans(a, spans, vals, recorded)
    out_r = dg.patch_feed_rows(b, dg.span_positions(spans), vals, recorded)
    assert torch.equal(out_s, out_r)
    for x, y in zip(a, b):
        assert x.numpy().tobytes() == y.numpy().tobytes()
    assert dg.patch_feed_spans(a, spans, vals) is None


@pytest.mark.parametrize("spans, match", [
    ([(5, 7), (1, 2)], "sorted and disjoint"),
    ([(1, 4), (3, 5)], "sorted and disjoint"),
    ([(3, 3)], "empty or reversed"),
    ([(7, 4)], "empty or reversed"),
    ([(-1, 2)], "outside"),
    ([(0, 4), (6, 9)], "outside"),          # past the bool plane's 8 rows
    ([(0, 2)], "positions"),                # three values each
    ([(0, 1, 2)], "pairs"),
])
def test_span_patch_refusals(spans, match):
    """Unsorted, overlapping, empty, reversed and outside spans, and a
    count of values that differs from the spans' rows, are refused in
    O(K) on the host before any plane is written."""
    a = torch.zeros(10, dtype=torch.int32)
    b = torch.zeros(8, dtype=torch.bool)
    vals = [torch.tensor([1, 2, 3], dtype=torch.int32),
            torch.tensor([True, True, True])]
    with pytest.raises(ValueError, match=match):
        dg.patch_feed_spans([a, b], spans, vals)
    assert not a.any() and not b.any()


_SPAN = np.dtype([("lo", "<i8"), ("len", "<i4"), ("prefix", "<i4")])


def _replay_spans(args: np.ndarray, payload: np.ndarray, mem: dict, P: int):
    """``patch_kernel``'s span form in numpy: decode the block (``struct
    PatchArgs`` with ``n_spans`` > 0, ``PatchPlane`` and ``SpanDesc`` of
    csrc/digest.cu), rebuild each
    value's row from its span's (lo, prefix), and hand the positions to
    ``_replay_patch``'s arithmetic through a positions block."""
    head = np.frombuffer(args[:48].tobytes(), _HEAD)[0]
    pay = args[48:] if head["table"] == 0 else payload
    k = int(head["n_spans"])
    descs = np.frombuffer(
        pay[head["pos_off"]:head["pos_off"] + 16 * k].tobytes(), _SPAN)
    m = int(head["m"])
    pos = np.empty(m, np.int64)
    for d in descs:
        pos[d["prefix"]:d["prefix"] + d["len"]] = \
            d["lo"] + np.arange(d["len"])
    # the same block, with the positions where a patch keeps them
    pos_off = len(pay)
    big = np.concatenate([pay, pos.view(np.uint8)])
    hdr = np.frombuffer(args[:48].tobytes(), _HEAD).copy()
    hdr["pos_off"] = pos_off
    hdr["table"] = 1
    hdr["n_spans"] = 0
    return _replay_patch(np.concatenate([hdr.view(np.uint8), args[48:]]),
                         big, mem, P)


@pytest.mark.parametrize("k, span_rows", [(1, 1), (4, 257), (1, 1025),
                                          (1, 65536), (300, 3)])
@pytest.mark.parametrize("digest", [True, False])
@pytest.mark.parametrize("on_card", [False, True])
def test_packed_spans_replay_the_plain_version(k, span_rows, digest,
                                               on_card):
    """``plan_spans`` + ``pack_spans`` as the CUDA wrapper calls them: K
    span descriptors of 16 bytes (never a position), inline where the
    block fits a parameter class, else on the card (K past the parameter
    room, 65,536 rows, or several blocks a plane with digests); values in
    the payload or read where they lie; recorded digests by value or by
    address.  The numpy replay of the kernel equals the plain version."""
    n = max(4 * N, k * (span_rows + 5) + 10)
    spans = [(5 + i * (span_rows + 5), 5 + i * (span_rows + 5) + span_rows)
             for i in range(k)]
    m = k * span_rows
    planes = [plane(dt, n, 900 + i) for i, dt in enumerate(PLANE_DTYPES)]
    vals = [plane(dt, m, 910 + i) for i, dt in enumerate(PLANE_DTYPES)]
    recorded = [ref_digest(a, n) for a in planes]
    ts = [torch.from_numpy(a.copy()) for a in planes]
    want = [torch.from_numpy(a.copy()) for a in planes]
    vts = [torch.from_numpy(v) for v in vals]
    recs_t = torch.tensor([r - U64 if r >> 63 else r for r in recorded],
                          dtype=torch.int64)
    recs = [(0, r) for r in recorded[:3]] + [(recs_t[3:].data_ptr(), 0)]
    lay = dg.plan_spans([t.element_size() for t in ts], k, m,
                        [not on_card] * 4, digest)
    assert lay.pos_off == 48 * 4
    assert (lay.scratch_off > 0) == (digest and lay.grid_x > 1)
    assert (lay.inline is None) == (lay.scratch_off > 0 or
                                    lay.size > dg.PATCH_INLINE[-1])
    if k == 300:        # past the parameter room: the table carries them
        assert lay.inline is None
    out = torch.zeros((4, 3), dtype=torch.int64)
    arr = dg._spans(spans, n)
    args, pay = dg.pack_spans(
        lay, ts, arr, [v.data_ptr() for v in vts] if on_card else vals,
        recs, out.data_ptr() if digest else 0, 0 if lay.inline else 1 << 40)
    assert args.size == 48 + (lay.inline or 16)
    head = np.frombuffer(args[:48].tobytes(), _HEAD)[0]
    assert int(head["m"]) == m and int(head["n_spans"]) == k
    mem = {t.data_ptr(): t for t in ts + vts}
    mem[recs_t[3:].data_ptr()] = recs_t[3:]
    got = _replay_spans(args, pay, mem, 4)
    plain = dg.patch_feed_spans_plain(want, arr, vts,
                                      recorded if digest else None)
    for a, b in zip(ts, want):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    if digest:
        assert [[dg.as_u64(x) for x in row] for row in plain] == \
            got.astype(object).tolist()
    else:
        assert got is None and plain is None


def test_journal_patch_of_three_planes_rides_inline():
    """A write's patch of one row over a feed of three int32 planes fits
    the smallest parameter class: one device operation."""
    lay = dg.plan_spans([4, 4, 4], 1, 1, [True] * 3, True)
    assert lay.inline == dg.PATCH_INLINE[0] and lay.grid_x == 1
