"""Segmented top-k (``ORDER BY one key LIMIT k``): the sort-key contract,
the plain PyTorch version, and the launcher of the CUDA kernel
``csrc/topn.cu``.

Counterpart of the JAX package's ``DeviceRunner._build_topn_kernel``
(runner.py:2825) and ``_topn_sort_key`` (:2783): per segment of
``seglen`` rows the top ``kk = min(k, seglen)`` rows, then the top
``min(k, n_used)`` of those candidates.  Rows rank by one 64-bit key,
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
launches (one per stage) and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

EXCLUDED = -(1 << 63)
NULL_DESC = -(1 << 63) + 1
NULL_ASC = (1 << 63) - 1
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1

# the reference's segment bound (runner.py:2847) and its limit gate
SEGMENT = 1 << 17
MAX_LIMIT = 1 << 14

_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float64: 2}

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
        lib.topn_launch.argtypes = [i, p, i, p, p, ll, i, ll, ll, ll, p, p,
                                    p, p, p, p, ctypes.POINTER(i), p]
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


def _topn_cuda(values, ok, mask, desc, n, n_used, seglen, k, passes):
    global launches
    lib = _kernel_lib()
    dev = values.device
    nseg = n_used // seglen
    m = nseg * min(k, seglen)
    scratch = torch.empty((4, m), dtype=torch.int64, device=dev)
    out = torch.empty((2, min(k, n_used)), dtype=torch.int64, device=dev)
    launched = ctypes.c_int(0)
    err = lib.topn_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        values.data_ptr(), _DTYPES[values.dtype],
        None if ok is None else ok.data_ptr(),
        None if mask is None else mask.data_ptr(), n, int(desc), n_used,
        seglen, k, *(scratch[j].data_ptr() for j in range(4)),
        out.data_ptr(), None if passes is None else passes.data_ptr(),
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
                passes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The best ``min(k, n_used)`` rows of [0, n_used) by (order key,
    then row position) → int64 (2, ·): positions in row order, flags.

    ``values``: the order values (int32, int64 or float64; rows [0, n)
    read), ``ok``: their validity or None, ``mask``: the selection or None
    (both bool, rows [0, n) read); rows at or past ``n`` are excluded.
    ``n_used`` is a multiple of ``seglen``.  ``passes`` (CUDA only): an
    int64 tensor to which each segment adds how many times the kernel
    read it."""
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
                               passes.device != dev):
        raise ValueError("passes must be an int64 tensor on the device")
    return _topn_cuda(values, ok, mask, desc, n, n_used, seglen, k, passes)
