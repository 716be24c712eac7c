"""The column statistics of an ANALYZE request: the wrapper and plain
PyTorch version of the CUDA kernel ``csrc/analyze.cu``.

Counterpart of the JAX package's ``device/runner.py``
``_AnalyzeKernels._build`` (:4478): ``analyze_column(values, valid, n,
n_buckets)`` sorts the valid rows among the first ``n`` of one column
(int32, int64, uint32, uint64 or float64 values, a bool validity, both
padded to the same length) and returns the packed int64 vector of
``2 * n_buckets + 2`` words that the reference's kernel returns, in its
layout:

- ``[0, B)``: the bucket upper bounds, the sorted valid value at rank
  ``max((b * n_valid) // B - 1, 0)`` for b = 1..B (int64, or a float64's
  bits);
- ``[B, 2B)``: those ranks + 1;
- ``2B``: n_valid; ``2B + 1``: the distinct count (adjacent sorted values
  that differ under ``!=``: -0.0 equals +0.0, and every NaN differs).

NaN sorts after +inf.  On the card the kernels sort canonical order images
(``csrc/analyze.cu``), so a bound of -0.0 comes back as +0.0 and a NaN as
one canonical NaN, and the words of degenerate buckets (which no answer
reads) differ from the plain version's: ``packed_max_diff`` compares the
two as the reference's unpacking reads them (``unpack``).  The wrapper
takes the plain version only for tensors on the CPU; on a CUDA tensor it
launches the kernels or raises.  ``analyze_launches`` counts wrapper calls
that launched them.
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import Optional

import numpy as np
import torch

from .build import check_vector, load_checked, raise_on

# kernel launches since import (the chip smoke resets them around a run)
analyze_launches = 0

DIGIT_BITS = 8      # bits a radix pass sorts
RADIX = 1 << DIGIT_BITS
TILE32 = 4096       # rows of a pass tile, keys of at most 32 bits
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
    the host: (n_valid, least image, greatest image, key bits, passes)."""
    img = order_image(values[:n])[valid[:n]]
    if img.numel() == 0:
        return 0, 0, 0, 0, 0
    signed = img ^ _I64_MIN                 # unsigned order as signed
    lo = (int(signed.min()) ^ _I64_MIN) & _U64
    hi = (int(signed.max()) ^ _I64_MIN) & _U64
    bits = key_bits(img.numel(), lo, hi)
    return img.numel(), lo, hi, bits, -(-bits // DIGIT_BITS)


def sort_words(n: int, bits: int) -> int:
    """The zeroed work (u64 words) a sort of n keys of ``bits`` bits takes:
    per pass, a status word per tile and digit, the digit histogram and a
    tile counter (csrc/analyze.cu sort_words)."""
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


class _AnalyzeParams(ctypes.Structure):
    """``struct AnalyzeParams`` of csrc/analyze.cu."""
    _p = ctypes.c_void_p
    _fields_ = [("values", _p), ("valid", _p), ("n", ctypes.c_longlong),
                ("kind", ctypes.c_int), ("n_buckets", ctypes.c_int),
                ("range", _p), ("n_valid", ctypes.c_longlong),
                ("lo", ctypes.c_ulonglong), ("null_key", ctypes.c_ulonglong),
                ("bits", ctypes.c_int), ("has_nan", ctypes.c_int),
                ("nan_key", ctypes.c_ulonglong), ("keys", _p * 2),
                ("work", _p), ("work_words", ctypes.c_longlong),
                ("out", _p)]


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = load_checked("analyze", {
            "analyze_params_bytes": ctypes.sizeof(_AnalyzeParams),
            "analyze_tile_rows32": TILE32, "analyze_tile_rows64": TILE64},
            "analyze_error_string")
        ap = ctypes.POINTER(_AnalyzeParams)
        for fn in (lib.analyze_range_launch, lib.analyze_sort_launch):
            fn.argtypes = [ctypes.c_int, ap, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class ColumnLaunch:
    """One column's launches on the card, in the order ``analyze_column``
    issues them: ``range()`` (the range kernel), ``read_range()`` (the one
    wait: the 24 bytes back, then the keys' plan and their scratch),
    ``sort()`` (the keys, their passes and the statistics into ``out``).
    Each launch may be issued again on the same buffers (the timing of
    the chip smoke)."""

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
        self.p = _AnalyzeParams(
            values=values.data_ptr(),
            valid=valid.view(torch.uint8).data_ptr(), n=n,
            kind=_KINDS[values.dtype], n_buckets=n_buckets,
            range=self.rng.data_ptr(), out=self.out.data_ptr())

    def _launch(self, fn: str) -> None:
        raise_on(self.lib, "analyze_error_string",
                 getattr(self.lib, fn)(self.at[0], ctypes.byref(self.p),
                                       self.at[1]), fn)

    def range(self) -> None:
        self._launch("analyze_range_launch")

    def read_range(self) -> tuple:
        """→ (n_valid, least image, greatest image, key bits), as
        ``key_plan`` reads them; allocates the keys and the work."""
        got = self.rng.tolist()             # waits for the range kernel
        n_valid = got[0]
        lo, hi = got[1] & _U64, ~got[2] & _U64
        bits = key_bits(n_valid, lo, hi)
        p, n = self.p, self.n
        self.keys = torch.empty((2, n if bits else 0), device=self.dev,
                                dtype=torch.int32 if bits <= 32
                                else torch.int64)
        words = sort_words(n, bits)
        self.work = torch.empty(max(1, words), dtype=torch.int64,
                                device=self.dev)
        p.n_valid, p.bits, p.work_words = n_valid, bits, words
        if bits:
            p.lo, p.null_key = lo, null_key(lo, hi)
            p.has_nan = int(self.real and hi == _U64)
            p.nan_key = (hi - lo) & _U64
            p.keys[0] = self.keys[0].data_ptr()
            p.keys[1] = self.keys[1].data_ptr()
            p.work = self.work.data_ptr()
        return n_valid, lo, hi, bits

    def sort(self) -> None:
        self._launch("analyze_sort_launch")


def analyze_column(values: torch.Tensor, valid: torch.Tensor, n: int,
                   n_buckets: int,
                   phases: Optional[dict] = None) -> torch.Tensor:
    """The packed statistics (int64[2 * n_buckets + 2], on the values'
    device) of the valid rows among the first ``n`` of ``values``.
    ``phases``, when given, gains the host-clock ms of the range read's
    wait (``range_sync``) and of the launches (``launch``)."""
    global analyze_launches
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
    t1 = time.perf_counter()
    col.read_range()
    t2 = time.perf_counter()
    col.sort()
    analyze_launches += 1
    if phases is not None:
        t3 = time.perf_counter()
        phases["range_sync"] = phases.get("range_sync", 0.0) + \
            (t2 - t1) * 1e3
        phases["launch"] = phases.get("launch", 0.0) + \
            (t1 - t0 + t3 - t2) * 1e3
    return col.out
