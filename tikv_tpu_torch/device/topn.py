"""Top-k (``ORDER BY one key LIMIT k``): the sort-key contract, the plain
PyTorch version, and the launcher of the CUDA kernel ``csrc/topn.cu``.

Counterpart of the JAX package's ``DeviceRunner._build_topn_kernel``
(runner.py:2825) and ``_topn_sort_key`` (:2783), which take the top ``kk
= min(k, seglen)`` rows per segment of ``seglen`` rows, then the top
``min(k, n_used)`` of those candidates: the best ``min(k, n_used)`` rows
of [0, n_used), however computed.  Rows rank by one 64-bit key,
larger first, ties by row position, lower first; the key (``order_keys``,
signed here, its unsigned image in the kernel) encodes MySQL's NULL order
and the selection:

- a row that the selection drops, or at or past ``n``: ``EXCLUDED`` (never
  ranks above a live row);
- a NULL value: below every value for DESC (``NULL_DESC``), above every
  value for ASC (``NULL_ASC``);
- a value: its order-preserving int64 image (int32/int64 as they are,
  float64 by its bits with the sign folded, -0.0 as +0.0), bit-inverted
  for ASC; an int64 within 2 of the int64 extremes is clamped, as the
  reference clamps.

The order plane is int32, int64 or float64 — never float32: a REAL order
expression reaches the kernel in float64, so rows that differ in float64
never tie (the reference ranks float32 values, ROADMAP queue 3 fault 6).
The result is the set of those rows in row order: ``out[0]`` their
positions, ``out[1]`` flags (bit 0: the row passed the selection, bit 1:
and its value is not NULL), one int64 (2, min(k, n_used)) tensor.

``topn_select`` takes the plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.  ``launches`` counts kernel
launches and nothing else.

The kernel's common route reads the order plane twice: a histogram of one
wide digit of the key (``BINS`` bins, ``bin_of``), then a fill of the rows
at or above the bin of the k-th key into a buffer of ``cand_capacity(k)``
rows, selected exactly in one block.  Where the digit sits is the caller's
``placement`` (``digit_placement``: from the bounds of the order values
where the caller knows them, else a default per dtype); it decides only
the route, never the answer.  When the crossing bin holds more rows than
the buffer (ties, NULL or excluded keys at the k-th place, a placement
that does not spread the keys) the kernel takes its overflow route, the
exact per-segment select.  ``plan_route`` is the route and buffer choice
as plain PyTorch.
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import Optional

import numpy as np

import torch

EXCLUDED = -(1 << 63)
NULL_DESC = -(1 << 63) + 1
NULL_ASC = (1 << 63) - 1
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1

# the reference's segment bound (runner.py:2847) and its limit gate
SEGMENT = 1 << 17
MAX_LIMIT = 1 << 14

_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float64: 2}

# the common route (csrc/topn.cu): bins of the digit, the histogram's
# uint64 words and the kernel's bookkeeping words
BINS = 4096
STATE_WORDS = 4
ROUTE_COMMON, ROUTE_OVERFLOW = "common", "overflow"
_MASK64 = (1 << 64) - 1

# kernel launches since import (the chip smoke resets it around a run)
launches = 0


def segments(n: int, n_pad: int) -> tuple:
    """(n_used, seglen): the live seglen-rounded prefix of a feed of
    ``n_pad`` rows holding ``n`` live ones, and its segment length
    (runner.py:4393-4396, :2847)."""
    seg = math.gcd(n_pad, SEGMENT)
    n_used = min(n_pad, -(-n // seg) * seg)
    return n_used, math.gcd(n_used, SEGMENT)


def order_keys(values: torch.Tensor, ok: Optional[torch.Tensor],
               mask: Optional[torch.Tensor], desc: bool, n: int,
               n_used: int) -> torch.Tensor:
    """The signed int64 sort key of rows [0, n_used) (larger ranks
    first)."""
    dev = values.device
    v = values[:n]
    if v.dtype == torch.float64:
        bits = (v + 0.0).view(torch.int64)
        s = torch.where(bits >= 0, bits, bits ^ _I64_MAX)
    elif v.dtype in (torch.int32, torch.int64):
        s = v.to(torch.int64)
    else:
        raise ValueError(f"order values are {v.dtype}: int32, int64 or "
                         f"float64 expected")
    if desc:
        s = s.clamp(min=_I64_MIN + 2)
    else:
        s = ~s.clamp(_I64_MIN + 1, _I64_MAX - 1)
    if ok is not None:
        s = torch.where(ok[:n], s, torch.full_like(
            s, NULL_DESC if desc else NULL_ASC))
    if mask is not None:
        s = torch.where(mask[:n], s, torch.full_like(s, EXCLUDED))
    key = torch.full((n_used,), EXCLUDED, dtype=torch.int64, device=dev)
    key[:n] = s
    return key


def cand_capacity(k: int) -> int:
    """Rows of the common route's candidate buffer."""
    return max(4 * k, 1 << 16)


def key_image(value, dtype: torch.dtype, desc: bool) -> int:
    """The kernel's unsigned 64-bit key of a non-NULL value (``order_keys``
    + 2^63): larger ranks first."""
    if dtype == torch.float64:
        bits = struct.unpack("<q", struct.pack("<d", float(value) + 0.0))[0]
        s = bits if bits >= 0 else bits ^ _I64_MAX
    else:
        s = int(value)
    s = max(s, _I64_MIN + 2) if desc else \
        ~min(max(s, _I64_MIN + 1), _I64_MAX - 1)
    return (s + (1 << 63)) & _MASK64


def digit_placement(dtype: torch.dtype, desc: bool,
                    bounds: Optional[tuple] = None) -> tuple:
    """(lo, shift) of the common route's digit: the window of ``BINS - 2``
    bins of 2^shift keys each, from ``lo`` (a multiple of 2^shift) up,
    covers the keys of every value in ``bounds`` = (least, greatest) with
    the narrowest bins.  Without bounds: the int32 range for int32 values,
    every key for int64 and float64."""
    if dtype not in _DTYPES:
        raise ValueError(f"order values are {dtype}: int32, int64 or "
                         f"float64 expected")
    if bounds is None and dtype == torch.int32:
        bounds = (-(1 << 31), (1 << 31) - 1)
    if bounds is None:
        lo, hi = 0, _MASK64
    else:
        a, b = (key_image(x, dtype, desc) for x in bounds)
        lo, hi = min(a, b), max(a, b)
    for shift in range(64):
        base = lo >> shift << shift
        if (hi - base) >> shift <= BINS - 3:
            return base, shift
    raise AssertionError("unreachable: shift 63 spans two bins")


def bin_of(key_u64: np.ndarray, lo: int, shift: int) -> np.ndarray:
    """The kernel's bin of each unsigned key: 0 below ``lo``, then one bin
    per 2^shift keys, ``BINS - 1`` past the window."""
    key_u64 = np.asarray(key_u64, dtype=np.uint64)
    d = (key_u64 - np.uint64(lo)) >> np.uint64(shift)
    return np.where(key_u64 < np.uint64(lo), 0,
                    np.minimum(d, np.uint64(BINS - 2)).astype(np.int64) + 1)


def plan_route(values, ok, mask, desc: bool, n: int, n_used: int, k: int,
               placement: tuple) -> tuple:
    """(route, crossing bin, candidates) the kernel takes: the bin holding
    the k-th key (the lowest bin when fewer than k rows), the rows in bins
    at or above it, and ``ROUTE_COMMON`` when they fit
    ``cand_capacity(k)``."""
    key = order_keys(values, ok, mask, desc, n, n_used).cpu().numpy()
    bins = bin_of(key.view(np.uint64) ^ np.uint64(1 << 63), *placement)
    hist = np.bincount(bins, minlength=BINS)
    above = np.cumsum(hist[::-1])[::-1]          # rows in bins >= b
    reach = np.nonzero(above >= k)[0]
    c = int(reach[-1]) if reach.size else 0
    cands = int(above[c])
    route = ROUTE_COMMON if cands <= cand_capacity(k) else ROUTE_OVERFLOW
    return route, c, cands


def flags_of(key: torch.Tensor, desc: bool) -> torch.Tensor:
    live = key != EXCLUDED
    valid = live & (key != (NULL_DESC if desc else NULL_ASC))
    return live.to(torch.int64) | (valid.to(torch.int64) << 1)


def topn_plain(values, ok, mask, desc: bool, n: int, n_used: int,
               k: int) -> torch.Tensor:
    """A stable descending sort of every key, its first min(k, n_used)
    rows put back in row order."""
    key = order_keys(values, ok, mask, desc, n, n_used)
    k2 = min(k, n_used)
    order = torch.sort(key, descending=True, stable=True).indices[:k2]
    pos = order.sort().values
    return torch.stack([pos, flags_of(key[pos], desc)])


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("topn")
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.topn_launch.argtypes = [i, p, i, p, p, ll, i, ll, ll, ll,
                                    ctypes.c_ulonglong, i, ll] + [p] * 10 + \
            [ctypes.POINTER(i), p]
        lib.topn_launch.restype = i
        lib.topn_error_string.argtypes = [i]
        lib.topn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(t, name, dtypes, n, device):
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} is {t.dtype}, expected one of {dtypes}")
    if t.dim() != 1 or t.shape[0] < n or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor of "
                         f">= {n} rows, got {tuple(t.shape)}")
    return t.data_ptr()


def _topn_cuda(values, ok, mask, desc, n, n_used, seglen, k, placement,
               passes):
    global launches
    lib = _kernel_lib()
    dev = values.device
    nseg = n_used // seglen
    m = nseg * min(k, seglen)
    cap = cand_capacity(k)
    lo, shift = placement
    # one scratch tensor: histogram, state, the common route's candidates,
    # the overflow route's two candidate levels
    scratch = torch.empty(BINS + STATE_WORDS + 2 * cap + 4 * m,
                          dtype=torch.int64, device=dev)
    at = [0, BINS, BINS + STATE_WORDS]
    at += [at[-1] + cap] + [at[-1] + 2 * cap + j * m for j in range(4)]
    ptr = [scratch.data_ptr() + 8 * x for x in at]
    out = torch.empty((2, min(k, n_used)), dtype=torch.int64, device=dev)
    launched = ctypes.c_int(0)
    err = lib.topn_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        values.data_ptr(), _DTYPES[values.dtype],
        None if ok is None else ok.data_ptr(),
        None if mask is None else mask.data_ptr(), n, int(desc), n_used,
        seglen, k, lo, shift, cap, *ptr, out.data_ptr(),
        None if passes is None else passes.data_ptr(),
        ctypes.byref(launched),
        torch.cuda.current_stream(dev).cuda_stream)
    launches += launched.value
    if err != 0:
        raise RuntimeError("topn launch failed: "
                           + lib.topn_error_string(err).decode())
    return out


def topn_select(values: torch.Tensor, ok: Optional[torch.Tensor],
                mask: Optional[torch.Tensor], desc: bool, n: int,
                n_used: int, seglen: int, k: int,
                passes: Optional[torch.Tensor] = None,
                placement: Optional[tuple] = None) -> torch.Tensor:
    """The best ``min(k, n_used)`` rows of [0, n_used) by (order key,
    then row position) → int64 (2, ·): positions in row order, flags.

    ``values``: the order values (int32, int64 or float64; rows [0, n)
    read), ``ok``: their validity or None, ``mask``: the selection or None
    (both bool, rows [0, n) read); rows at or past ``n`` are excluded.
    ``n_used`` is a multiple of ``seglen`` (the overflow route's
    segments).  ``placement``: the digit's (lo, shift)
    (``digit_placement``; its default without bounds when None).
    ``passes`` (CUDA only): an int64 tensor of two elements; [0] gains the
    rows of the order plane the kernels read, [1] is set to the route (0
    common, 1 overflow)."""
    if not 0 < n <= n_used < 1 << 62 or n_used % seglen or \
            not 0 < k <= MAX_LIMIT:
        raise ValueError(f"topn_select: n={n} n_used={n_used} "
                         f"seglen={seglen} k={k}")
    dev = values.device
    _check(values, "values", tuple(_DTYPES), n, dev)
    _check(ok, "ok", (torch.bool,), n, dev)
    _check(mask, "mask", (torch.bool,), n, dev)
    if dev.type == "cpu":
        return topn_plain(values, ok, mask, desc, n, n_used, k)
    if dev.type != "cuda":
        raise ValueError(f"topn_select runs on cuda or cpu, not {dev}")
    if passes is not None and (passes.dtype != torch.int64 or
                               passes.device != dev or
                               passes.numel() < 2 or
                               not passes.is_contiguous()):
        raise ValueError("passes must be two int64 elements on the device")
    if placement is None:
        placement = digit_placement(values.dtype, desc)
    lo, shift = placement
    if not (0 <= lo <= _MASK64 and 0 <= shift < 64):
        raise ValueError(f"placement {placement} out of range")
    return _topn_cuda(values, ok, mask, desc, n, n_used, seglen, k,
                      placement, passes)
