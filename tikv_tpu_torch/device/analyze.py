"""The column statistics of an ANALYZE request: the wrapper and plain
PyTorch version of the CUDA kernel ``csrc/analyze.cu``.

Counterpart of the JAX package's ``device/runner.py``
``_AnalyzeKernels._build`` (:4478): ``analyze_column(values, valid, n,
n_buckets)`` summarises the valid rows among the first ``n`` of one
column (int32, int64, uint32, uint64 or float64 values, a bool validity,
both padded to the same length) into the packed int64 vector of
``2 * n_buckets + 2`` words that the reference's kernel returns, in its
layout:

- ``[0, B)``: the bucket upper bounds, the sorted valid value at rank
  ``max((b * n_valid) // B - 1, 0)`` for b = 1..B (int64, or a float64's
  bits);
- ``[B, 2B)``: those ranks + 1;
- ``2B``: n_valid; ``2B + 1``: the distinct count (adjacent sorted values
  that differ under ``!=``: -0.0 equals +0.0, and every NaN differs).

NaN sorts after +inf.  On the card no column is sorted whole: a range
kernel reads each column's least and greatest order image, and the host
picks a route from them (``plan_route``): keys spanning at most
``COUNT_SPAN`` values are counted, wider ones are cut into buckets from a
sorted sample (``route_model`` repeats the routes' arithmetic in numpy).
The bounds are images turned back into values, so a bound of -0.0 comes
back as +0.0 and a NaN as one canonical NaN, and the words of degenerate
buckets (which no answer reads) differ from the plain version's:
``packed_max_diff`` compares the two as the reference's unpacking reads
them (``unpack``).  The columns of one request read their ranges back in
one copy (``AnalyzeBatch``).  The wrapper takes the plain version only
for tensors on the CPU; on a CUDA tensor it launches the kernels or
raises.  ``analyze_launches`` counts the columns whose route launched.
"""

from __future__ import annotations

import ctypes
import math
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .build import check_vector, load_checked, raise_on

# kernel launches since import (the chip smoke resets them around a run)
analyze_launches = 0

DIGIT_BITS = 8      # bits a radix pass of the sample's sort sorts
RADIX = 1 << DIGIT_BITS
TILE32 = 4096       # keys of a pass tile, keys of at most 32 bits
TILE64 = 2048       # the same, wider keys
_U64 = (1 << 64) - 1
_I64_MIN = -(1 << 63)
_KINDS = {torch.int32: 0, torch.int64: 1, torch.uint32: 2, torch.uint64: 3,
          torch.float64: 4}


def null_key(lo: int, hi: int) -> int:
    """The key of a NULL row when the valid images span [lo, hi]: one past
    the greatest valid key, or all ones when they span all 64 bits."""
    return _U64 if (hi - lo) & _U64 == _U64 else (hi - lo + 1) & _U64


def key_bits(n_valid: int, lo: int, hi: int) -> int:
    """The width of the sort keys (0: no valid row, no sort): the NULL
    key's bits, 32-bit keys up to 32 of them, else 64-bit."""
    return null_key(lo, hi).bit_length() if n_valid else 0


def order_image(values: torch.Tensor) -> torch.Tensor:
    """The kernels' 64-bit order image of each value, held in an int64
    (compare as unsigned): an int with its sign bit flipped, an unsigned
    int as itself, a float64 with -0.0 as +0.0 and every NaN all ones."""
    if values.dtype == torch.float64:
        x = torch.where(values == 0, torch.zeros_like(values), values)
        b = x.view(torch.int64)
        img = torch.where(b < 0, ~b, b | _I64_MIN)
        return torch.where(torch.isnan(values), torch.full_like(img, -1),
                           img)
    if values.dtype == torch.uint64:
        return values.view(torch.int64)
    if values.dtype == torch.uint32:
        return values.to(torch.int64)
    return values.to(torch.int64) ^ _I64_MIN


def key_plan(values: torch.Tensor, valid: torch.Tensor, n: int) -> tuple:
    """What the range kernel reads and the host makes of it, computed on
    the host: (n_valid, least image, greatest image, key bits, the sample
    sort's passes)."""
    img = order_image(values[:n])[valid[:n]]
    if img.numel() == 0:
        return 0, 0, 0, 0, 0
    signed = img ^ _I64_MIN                 # unsigned order as signed
    lo = (int(signed.min()) ^ _I64_MIN) & _U64
    hi = (int(signed.max()) ^ _I64_MIN) & _U64
    bits = key_bits(img.numel(), lo, hi)
    return img.numel(), lo, hi, bits, -(-bits // DIGIT_BITS)


def sort_words(n: int, bits: int) -> int:
    """The zeroed work (u64 words) the onesweep sort of n keys of ``bits``
    bits takes (the partition route's sample): per pass, a status word per
    tile and digit, the digit histogram and a tile counter."""
    if bits == 0:
        return 0
    tiles = -(-n // (TILE32 if bits <= 32 else TILE64))
    return -(-bits // DIGIT_BITS) * (tiles * RADIX + RADIX + 1)


def analyze_column_plain(values: torch.Tensor, valid: torch.Tensor, n: int,
                         n_buckets: int) -> torch.Tensor:
    """The reference's kernel line by line: NULL and padding rows get the
    dtype's greatest value (NaN for float64), one stable sort, the
    adjacent differences inside the valid prefix, the gather at the ranks.
    uint32 sorts widened to int64, uint64 with its sign bit flipped (the
    same order); a float64 NaN sorts as the positive NaN, so every NaN
    comes last on any device (the card's ``torch.sort`` puts a NaN with
    its sign bit set first)."""
    n_pad = values.shape[0]
    dev = values.device
    is_f = values.dtype == torch.float64
    flip = values.dtype == torch.uint64
    if is_f:
        vals = torch.where(torch.isnan(values),
                           torch.full_like(values, math.nan), values)
        sent = math.nan
    elif flip:
        vals = values.view(torch.int64) ^ _I64_MIN
        sent = torch.iinfo(torch.int64).max
    elif values.dtype == torch.uint32:
        vals, sent = values.to(torch.int64), (1 << 32) - 1
    else:
        vals, sent = values, torch.iinfo(values.dtype).max
    iota = torch.arange(n_pad, dtype=torch.int64, device=dev)
    mask = (iota < n) & valid
    key = torch.where(mask, vals, torch.full_like(vals, sent))
    s = torch.sort(key, stable=True).values
    n_valid = mask.sum(dtype=torch.int64)
    in_prefix = iota[1:] < n_valid
    distinct = ((s[1:] != s[:-1]) & in_prefix).sum(dtype=torch.int64) + \
        (n_valid > 0).to(torch.int64)
    b = torch.arange(1, n_buckets + 1, dtype=torch.int64, device=dev)
    ranks = torch.clamp((b * n_valid) // n_buckets - 1, min=0)
    bounds = s[ranks]
    if is_f:
        bits = bounds.view(torch.int64)
    elif flip:
        bits = bounds ^ _I64_MIN
    else:
        bits = bounds.to(torch.int64)
    return torch.cat([bits, ranks + 1, torch.stack([n_valid, distinct])])


def unpack(packed: np.ndarray, n_buckets: int, real: bool) -> tuple:
    """The reference's unpacking of one packed vector (runner.py:4601-4617)
    → (n_valid, distinct, [(bound, cumulative count)]): a bucket whose
    count does not pass the previous one's is degenerate and dropped."""
    packed = np.asarray(packed, dtype=np.int64)
    bounds = packed[:n_buckets].view(np.float64) if real \
        else packed[:n_buckets]
    buckets = [(float(bounds[i]) if real else int(bounds[i]), cnt)
               for i, cnt in _kept(packed, n_buckets)]
    return int(packed[-2]), int(packed[-1]), buckets


def packed_max_diff(got, want, n_buckets: int, real: bool) -> float:
    """The largest difference between two packed vectors as the
    reference's unpacking reads them: every rank word, n_valid and the
    distinct count bit for bit (as integers), and the bound of each bucket
    the unpacking keeps by value (-0.0 equals +0.0, NaN equals NaN; a NaN
    against a number differs by inf).  0: they agree."""
    g, w = (np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor)
                       else x, dtype=np.int64) for x in (got, want))
    if g.shape != w.shape or g.shape != (2 * n_buckets + 2,):
        return math.inf
    worst = max((abs(int(a) - int(b)) for a, b in
                 zip(g[n_buckets:], w[n_buckets:])), default=0)
    keep = {i for i, _ in _kept(w, n_buckets)}
    if keep != {i for i, _ in _kept(g, n_buckets)}:
        return math.inf
    for i in keep:
        if real:
            a, b = (float(x[i:i + 1].view(np.float64)[0]) for x in (g, w))
            if math.isnan(a) or math.isnan(b):
                d = 0.0 if math.isnan(a) and math.isnan(b) else math.inf
            else:
                d = abs(a - b)          # -0.0 against +0.0: 0
        else:
            d = abs(int(g[i]) - int(w[i]))
        worst = max(worst, d)
    return float(worst)


def _kept(packed: np.ndarray, n_buckets: int) -> list:
    """(index, count) of each bucket the reference's unpacking keeps: its
    count capped at n_valid, above the previous kept one's."""
    n_valid = int(packed[-2])
    out, prev = [], 0
    for i, cnt in enumerate(packed[n_buckets:2 * n_buckets].tolist()):
        cnt = min(int(cnt), n_valid)
        if cnt > prev:
            out.append((i, cnt))
            prev = cnt
    return out




# ---------------------------------------------------------------------------
# the routes (csrc/analyze.cu): their choice, sizes and scratch, and a model
# of their arithmetic in numpy
# ---------------------------------------------------------------------------

COUNT_SPAN = 1 << 15    # the counting route's keys at most (its counters)
OVERSAMPLE = 16         # samples a splitter
TAB_BITS = 12           # the splitter table's key prefix
HASH_BYTES = 128 << 10  # a between bucket's shared hash table
GRID_MAX = 512          # blocks of the partition kernels at most
GROUPS = 256            # the staged scatter's groups of buckets
SPLIT_MAX = {4: 16384, 8: 12288}  # splitters that fit shared memory
SPLIT_ROWS = {4: 4096, 8: 2048}   # keys a bucket aimed at
SMEM_MAX = 227 << 10    # a block's shared memory on the card


def hash_keys(key_bytes: int) -> int:
    """The keys of a between bucket its hash table takes (3/4 of the
    slots): a bucket past it is oversized and sorts in device memory."""
    return HASH_BYTES // key_bytes * 3 // 4


def n_split_of(n_valid: int, key_bytes: int) -> int:
    """Splitters asked of the sample: none when one bucket's table takes
    every key, else one per ``SPLIT_ROWS`` keys up to ``SPLIT_MAX``."""
    if n_valid <= hash_keys(key_bytes):
        return 0
    return min(SPLIT_MAX[key_bytes], -(-n_valid // SPLIT_ROWS[key_bytes]))


def part_smem(n_split: int, key_bytes: int) -> int:
    """Shared bytes of the classify and scatter kernels: a 32-bit counter
    a bucket (2 n_split + 1), the splitters and the prefix table."""
    return -(-(2 * n_split + 1) * 4 // 16) * 16 + n_split * key_bytes + \
        ((1 << TAB_BITS) + 1) * 4


@dataclass(frozen=True)
class RoutePlan:
    """One column's route from its range: ``route`` "empty" (no valid
    row), "count" (keys span at most ``COUNT_SPAN`` values: ``span``
    counters) or "partition" (``n_split`` splitters from ``n_sample``
    samples, ``2 n_split + 1`` buckets at most, keys of ``key_bytes``)."""
    route: str
    n_valid: int
    lo: int
    top: int            # the greatest key: hi - lo
    bits: int           # the NULL key's width
    null_key: int
    has_nan: bool
    key_bytes: int = 0
    span: int = 0
    n_split: int = 0
    n_sample: int = 0

    @property
    def n_bucket(self) -> int:
        return 2 * self.n_split + 1


def plan_route(n_valid: int, lo: int, hi: int, real: bool) -> RoutePlan:
    """The route of a column whose valid images span [lo, hi] (the range
    kernel's answer; ``real``: float64 values, where the image all ones is
    a NaN)."""
    if n_valid == 0:
        return RoutePlan("empty", 0, 0, 0, 0, 0, False)
    top = (hi - lo) & _U64
    bits = key_bits(n_valid, lo, hi)
    common = dict(n_valid=n_valid, lo=lo, top=top, bits=bits,
                  null_key=null_key(lo, hi), has_nan=real and hi == _U64)
    if top < COUNT_SPAN:
        return RoutePlan("count", span=top + 1, **common)
    kb = 4 if bits <= 32 else 8
    ps = n_split_of(n_valid, kb)
    return RoutePlan("partition", key_bytes=kb, n_split=ps,
                     n_sample=OVERSAMPLE * ps, **common)


def scratch_layout(plan: RoutePlan) -> tuple:
    """→ ({name: (byte offset, bytes)}, total bytes, zeroed bytes) of the
    column's scratch: first the words the launcher zeroes (state, counters,
    table, the sample sort's work), then the rest, each 16-byte aligned."""
    kb, ps, nbk = plan.key_bytes, plan.n_split, plan.n_bucket
    sizes = [("state", 8 * 8),
             ("counters", 8 * plan.span),
             ("table", 4 * ((1 << TAB_BITS) + 1)),
             ("sample_work", 8 * sort_words(plan.n_sample, plan.bits)
              if ps else 0)]
    rest = [("sample0", kb * plan.n_sample), ("sample1", kb * plan.n_sample),
            ("splitters", kb * ps),
            ("block_counts", 4 * GRID_MAX * nbk),
            ("totals", 8 * nbk), ("rank_start", 8 * nbk),
            ("store_start", 8 * nbk), ("cursors", 8 * (GROUPS + nbk)),
            ("jobs", 4 * nbk),
            ("keys0", kb * plan.n_valid), ("keys1", kb * plan.n_valid)]
    if plan.route != "partition":
        sizes[2] = ("table", 0)
        rest = []
    out, at = {}, 0
    for name, size in sizes:
        out[name] = (at, size)
        at += -(-size // 16) * 16
    zeroed = at
    for name, size in rest:
        out[name] = (at, size)
        at += -(-size // 16) * 16
    return out, max(at, 16), zeroed


def _mix64(z: np.ndarray) -> np.ndarray:
    """csrc/analyze.cu mix64 (the splitmix64 finalizer) over uint64."""
    with np.errstate(over="ignore"):
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def sample_rows(n: int, n_sample: int) -> np.ndarray:
    """The rows the sample kernel reads: sample j a random row of the j-th
    of ``n_sample`` equal strata of [0, n)."""
    j = np.arange(n_sample, dtype=np.int64)
    a = j * n // n_sample
    w = (j + 1) * n // n_sample - a
    off = (_mix64(j.astype(np.uint64)) % np.maximum(w, 1).astype(np.uint64))
    return np.where(w <= 1, np.minimum(a, n - 1), a + off.astype(np.int64))


def rank_of(n_valid: int, n_buckets: int) -> np.ndarray:
    """The B ranks the packed vector reads: max((b + 1) n_valid / B − 1,
    0)."""
    b = np.arange(1, n_buckets + 1, dtype=np.int64)
    return np.maximum(b * n_valid // n_buckets - 1, 0)


def rank_homes(totals: np.ndarray, ranks: np.ndarray) -> tuple:
    """(bucket, position inside it) of each rank over buckets holding
    ``totals`` keys in order."""
    start = np.concatenate([[0], np.cumsum(totals, dtype=np.int64)])
    bucket = np.searchsorted(start, ranks, side="right") - 1
    return bucket, ranks - start[bucket]


def _images(values: np.ndarray) -> np.ndarray:
    return order_image(torch.from_numpy(np.ascontiguousarray(values))) \
        .numpy().view(np.uint64)


def _word(img: np.ndarray, real: bool, signed: bool) -> np.ndarray:
    img = img.astype(np.uint64)
    sign = np.uint64(1 << 63)
    if real:
        return np.where(img & sign, img ^ sign, ~img).view(np.int64)
    return (img ^ sign if signed else img).view(np.int64)


def route_model(values: np.ndarray, valid: np.ndarray, n: int,
                n_buckets: int) -> tuple:
    """The packed vector computed the way csrc/analyze.cu's routes compute
    it (the range, the route's choice, the sample and its splitters, each
    key's bucket, each rank's bucket and position, the distinct count a
    bucket), in numpy → (int64[2B + 2], info): info holds the plan and,
    on the partition route, the distinct splitters ``splitters``, the
    buckets ``sort_kernel`` takes (``jobs``), the oversized ones and
    whether the staged scatter writes the keys (``staged``)."""
    real = values.dtype == np.float64
    signed = values.dtype in (np.int32, np.int64)
    img_all = _images(values[:n])
    ok = np.asarray(valid[:n], bool)
    img = img_all[ok]
    nv = int(img.size)
    lo = int(img.min()) if nv else 0
    hi = int(img.max()) if nv else 0
    plan = plan_route(nv, lo, hi, real)
    ranks = rank_of(nv, n_buckets)
    out = np.zeros(2 * n_buckets + 2, np.int64)
    out[n_buckets:2 * n_buckets] = ranks + 1
    out[2 * n_buckets] = nv
    info = {"plan": plan}
    if plan.route == "empty":
        return out, info
    keys = img - np.uint64(lo)
    nan_key = plan.top if plan.has_nan else None
    if plan.route == "count":
        cnt = np.bincount(keys.astype(np.int64), minlength=plan.span)
        at, _ = rank_homes(cnt, ranks)
        out[:n_buckets] = _word(at.astype(np.uint64) + np.uint64(lo), real,
                                signed)
        distinct = int(np.count_nonzero(cnt))
        if nan_key is not None and cnt[nan_key] > 1:
            distinct += int(cnt[nan_key]) - 1
        out[-1] = distinct
        return out, info
    if plan.n_split:
        rows = sample_rows(n, plan.n_sample)
        sk = np.where(ok[rows], img_all[rows] - np.uint64(lo),
                      np.uint64(plan.null_key))
        ss = np.sort(sk)
        vs = int(ok[rows].sum())
        j = np.arange(plan.n_split, dtype=np.int64)
        cand = ss[(j + 1) * vs // (plan.n_split + 1)] if vs else \
            np.zeros(0, np.uint64)
        spl = cand[np.concatenate([[True], cand[1:] != cand[:-1]])] \
            if cand.size else cand
        # the staged scatter: adjacent valid samples descending past 1%
        both = ok[rows[1:]] & ok[rows[:-1]]
        down = int((sk[:-1][both] > sk[1:][both]).sum())
        staged = down * 100 > int(both.sum())
    else:
        spl = np.zeros(0, np.uint64)
        staged = False
    d = int(spl.size)
    i = np.searchsorted(spl, keys, side="left")
    eq = (i < d) & (spl[np.minimum(i, max(d - 1, 0))] == keys) if d else \
        np.zeros(keys.size, bool)
    q = 2 * i + eq
    totals = np.bincount(q, minlength=2 * d + 1)
    home, pos = rank_homes(totals, ranks)
    order = np.argsort(q, kind="stable")
    start = np.concatenate([[0], np.cumsum(totals)])
    distinct, jobs, oversized = 0, [], 0
    bounds = np.zeros(n_buckets, np.uint64)
    for b in range(2 * d + 1):
        m = int(totals[b])
        if m == 0:
            continue
        inside = home == b
        if b & 1:
            v = spl[b >> 1]
            distinct += m if nan_key is not None and int(v) == nan_key else 1
            bounds[inside] = v
            continue
        mine = np.sort(keys[order[start[b]:start[b + 1]]])
        big = m > hash_keys(plan.key_bytes)
        if big or inside.any():
            jobs.append(b)
            oversized += big
        change = np.ones(m, bool)
        change[1:] = mine[1:] != mine[:-1]
        if nan_key is not None:
            change[1:] |= mine[:-1] == np.uint64(nan_key)
        distinct += int(change.sum())
        bounds[inside] = mine[pos[inside]]
    out[:n_buckets] = _word(bounds + np.uint64(lo), real, signed)
    out[-1] = distinct
    info.update(splitters=d, jobs=len(jobs), oversized=oversized,
                staged=staged)
    return out, info


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_ROUTES = {"empty": 0, "count": 1, "partition": 2}
# each route's launches in order (``ColumnLaunch.run(stages)``): "head"
# zeroes the scratch and writes the rank words; "offsets" is the blocks'
# prefix a bucket and the one-block scan over the buckets; "scatter" writes
# sorted rows' keys, "group" and "fine" unsorted rows' (each returns at
# once on the other kind)
STAGES = {"empty": ("head",), "count": ("head", "count", "count_stats"),
          "partition": ("head", "sample", "sample_sort", "splitters",
                        "classify", "offsets", "scatter", "group", "fine",
                        "bucket", "sort")}


class _AnalyzeParams(ctypes.Structure):
    """``struct AnalyzeParams`` of csrc/analyze.cu."""
    _p = ctypes.c_void_p
    _i = ctypes.c_int
    _ll = ctypes.c_longlong
    _u = ctypes.c_ulonglong
    _fields_ = [("values", _p), ("valid", _p), ("n", _ll), ("kind", _i),
                ("n_buckets", _i), ("range", _p), ("n_valid", _ll),
                ("lo", _u), ("top", _u), ("bits", _i), ("has_nan", _i),
                ("nan_key", _u), ("null_key", _u), ("route", _i),
                ("key_bytes", _i), ("span", _ll), ("n_split", _i),
                ("n_sample", _i), ("zeroed", _p), ("zeroed_bytes", _ll),
                ("state", _p), ("counters", _p), ("table", _p),
                ("sample_work", _p), ("sample_work_words", _ll),
                ("sample", _p * 2), ("splitters", _p), ("block_counts", _p),
                ("totals", _p), ("rank_start", _p), ("store_start", _p),
                ("cursors", _p), ("jobs", _p), ("keys", _p * 2),
                ("out", _p)]


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = load_checked("analyze", {
            "analyze_params_bytes": ctypes.sizeof(_AnalyzeParams),
            "analyze_tile_rows32": TILE32, "analyze_tile_rows64": TILE64,
            "analyze_count_span": COUNT_SPAN,
            "analyze_hash_bytes": HASH_BYTES,
            "analyze_grid_max": GRID_MAX, "analyze_tab_bits": TAB_BITS,
            "analyze_oversample": OVERSAMPLE, "analyze_groups": GROUPS},
            "analyze_error_string")
        ap = ctypes.POINTER(_AnalyzeParams)
        lib.analyze_range_launch.argtypes = [ctypes.c_int, ap,
                                             ctypes.c_void_p]
        lib.analyze_run_launch.argtypes = [ctypes.c_int, ap, ctypes.c_int,
                                           ctypes.c_void_p]
        for fn in (lib.analyze_range_launch, lib.analyze_run_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class ColumnLaunch:
    """One column's launches on the card: ``range()`` (the range kernel),
    ``plan(got)`` (the route from the range's three words, and its
    scratch), ``run()`` (the route's kernels, the packed vector into
    ``out``).  ``read_range()`` is the single column's wait: the range
    back, then ``plan``.  Each launch may be issued again on the same
    buffers (the timing of the chip smoke)."""

    def __init__(self, values: torch.Tensor, valid: torch.Tensor, n: int,
                 n_buckets: int):
        dev = values.device
        self.lib = _kernel_lib()
        self.at = (dev.index if dev.index is not None
                   else torch.cuda.current_device(),
                   torch.cuda.current_stream(dev).cuda_stream)
        self.dev, self.n, self.real = dev, n, values.dtype == torch.float64
        self.rng = torch.empty(3, dtype=torch.int64, device=dev)
        self.out = torch.empty(2 * n_buckets + 2, dtype=torch.int64,
                               device=dev)
        self.keep = (values, valid)
        self.route: Optional[RoutePlan] = None
        self.p = _AnalyzeParams(
            values=values.data_ptr(),
            valid=valid.view(torch.uint8).data_ptr(), n=n,
            kind=_KINDS[values.dtype], n_buckets=n_buckets,
            range=self.rng.data_ptr(), out=self.out.data_ptr())

    def range(self) -> None:
        raise_on(self.lib, "analyze_error_string",
                 self.lib.analyze_range_launch(
                     self.at[0], ctypes.byref(self.p), self.at[1]),
                 "analyze_range_launch")

    def plan(self, got) -> RoutePlan:
        """The route of the range words ``got`` (valid count, least image,
        complement of the greatest); allocates the route's scratch."""
        n_valid = int(got[0])
        lo, hi = int(got[1]) & _U64, ~int(got[2]) & _U64
        r = plan_route(n_valid, lo, hi, self.real)
        layout, total, zeroed = scratch_layout(r)
        self.scratch = torch.empty(total, dtype=torch.uint8, device=self.dev)
        base = self.scratch.data_ptr()
        ptr = {k: (base + at if size else None)
               for k, (at, size) in layout.items()}
        p = self.p
        p.n_valid, p.lo, p.top, p.bits = n_valid, r.lo, r.top, r.bits
        p.has_nan, p.nan_key, p.null_key = int(r.has_nan), r.top, r.null_key
        p.route, p.key_bytes, p.span = _ROUTES[r.route], r.key_bytes, r.span
        p.n_split, p.n_sample = r.n_split, r.n_sample
        p.zeroed, p.zeroed_bytes = base, zeroed
        p.state, p.counters, p.table = (ptr["state"], ptr["counters"],
                                        ptr["table"])
        p.sample_work = ptr["sample_work"]
        p.sample_work_words = layout["sample_work"][1] // 8
        if r.route == "partition":
            p.sample[0], p.sample[1] = ptr["sample0"], ptr["sample1"]
            p.splitters, p.block_counts = ptr["splitters"], \
                ptr["block_counts"]
            p.totals, p.rank_start = ptr["totals"], ptr["rank_start"]
            p.store_start, p.jobs = ptr["store_start"], ptr["jobs"]
            p.cursors = ptr["cursors"]
            p.keys[0], p.keys[1] = ptr["keys0"], ptr["keys1"]
        self.route = r
        return r

    def read_range(self) -> RoutePlan:
        return self.plan(self.rng.tolist())     # waits for the range

    def run(self, stages: int = 0) -> None:
        """The route's kernels; ``stages`` > 0 stops after the first
        ``stages`` of ``STAGES[route]`` (to time each kernel apart)."""
        raise_on(self.lib, "analyze_error_string",
                 self.lib.analyze_run_launch(
                     self.at[0], ctypes.byref(self.p), stages, self.at[1]),
                 "analyze_run_launch")

    def partition_stats(self) -> dict:
        """The partition route's counts of its last run (waits): distinct
        splitters, buckets sort_kernel took, oversized buckets, and
        whether the staged scatter wrote the keys (adjacent samples
        descending past 1%)."""
        st = self.scratch[:56].view(torch.int64).tolist()
        return {"splitters": st[1], "jobs": st[2], "oversized": st[4],
                "staged": bool(self.route.n_split and st[5] * 100 > st[6])}


class AnalyzeBatch:
    """The columns of one request: each ``analyze_column(..., batch=)``
    issues its range kernel and joins; ``run()`` reads every range back in
    one copy (the request's one wait), then launches each column's
    route."""

    def __init__(self):
        self.columns: list = []

    def run(self, phases: Optional[dict] = None) -> None:
        global analyze_launches
        cols, self.columns = self.columns, []
        if not cols:
            return
        t0 = time.perf_counter()
        got = torch.stack([c.rng for c in cols]).tolist()
        t1 = time.perf_counter()
        for c, g in zip(cols, got):
            c.plan(g)
            c.run()
            analyze_launches += 1
        if phases is not None:
            phases["range_sync"] = phases.get("range_sync", 0.0) + \
                (t1 - t0) * 1e3
            phases["range_waits"] = phases.get("range_waits", 0) + 1
            phases["launch"] = phases.get("launch", 0.0) + \
                (time.perf_counter() - t1) * 1e3


def analyze_column(values: torch.Tensor, valid: torch.Tensor, n: int,
                   n_buckets: int, phases: Optional[dict] = None,
                   batch: Optional[AnalyzeBatch] = None) -> torch.Tensor:
    """The packed statistics (int64[2 * n_buckets + 2], on the values'
    device) of the valid rows among the first ``n`` of ``values``.  On the
    card the range kernel launches here; with ``batch`` the route's
    kernels launch at ``batch.run()`` (the returned vector is valid after
    it), without one at once (one wait).  ``phases``, when given, gains the
    host-clock ms of the launches (``launch``) and, at the run, of the
    range read's wait (``range_sync``) and the count of waits
    (``range_waits``)."""
    n_pad = values.shape[0] if values.dim() == 1 else -1
    dev = values.device
    check_vector(values, "values", n_pad, dev, tuple(_KINDS))
    check_vector(valid, "valid", n_pad, dev, (torch.bool,))
    if not 0 <= n <= n_pad or n >= 1 << 31:
        raise ValueError(f"analyze_column serves 0 <= n <= {n_pad} rows "
                         f"(and n < 2^31), got {n}")
    if n_buckets < 1 or n_buckets >= 1 << 30:
        raise ValueError(f"n_buckets must be in [1, 2^30), got {n_buckets}")
    if dev.type == "cpu":
        return analyze_column_plain(values, valid, n, n_buckets)
    if dev.type != "cuda":
        raise ValueError(f"analyze_column runs on cuda or cpu, not {dev}")
    t0 = time.perf_counter()
    col = ColumnLaunch(values, valid, n, n_buckets)
    col.range()
    if phases is not None:
        phases["launch"] = phases.get("launch", 0.0) + \
            (time.perf_counter() - t0) * 1e3
    own = batch is None
    batch = AnalyzeBatch() if own else batch
    batch.columns.append(col)
    if own:
        batch.run(phases)
    return col.out
