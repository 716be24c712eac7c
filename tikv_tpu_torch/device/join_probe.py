"""The probe of a device join: the wrappers and plain PyTorch versions of
the CUDA kernels of ``csrc/join.cu``.

Counterpart of the JAX package's ``device/join.py`` ``_probe_kernel``
(:276).  ``join_probe(sk, perm, prefix, pkeys, pvalid, mask, k_cap,
index=None)`` takes the build dictionary of ``sort.join_build`` and n
probe keys (int64[n]) with their validity and the probe predicate's bool
mask (each bool[n] or None) → (``pairs`` int32[k_cap, 2]: (probe row,
build row) in probe order then build order, -1 past the total; ``total``
a 0-d int64 tensor, exact even when it exceeds ``k_cap``: the caller then
runs again with a larger capacity).

``join_index(sk, prefix)`` → a ``JoinIndex`` (the direct index of a
dictionary whose valid keys are dense: ``index_span``) or None.  Given
one, ``join_probe`` reads each key's run from two adjacent table entries
(the dense route); without, it searches ``sk`` once (the sparse route).

The wrappers take the plain versions only for tensors on the CPU; on a
CUDA tensor they launch their kernels or raise.  ``launches`` and
``index_launches`` count wrapper calls that launched a kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .build import check_vector, load_checked, raise_on

# kernel launches since import (the chip smoke resets them around a run)
launches = 0
index_launches = 0

TILE = 1024         # csrc/join.cu TILE
SAMPLES = 2048      # csrc/join.cu SAMPLES: the sparse route's samples of sk
INDEX_SLACK = 1024  # a dense build: span <= 2 * valid keys + INDEX_SLACK
_I64_MAX = (1 << 63) - 1


class JoinIndex(NamedTuple):
    """The direct index of a dense build dictionary: ``off`` int32[span +
    1], ``off[x]`` the first sorted row whose key is ≥ ``lo + x``."""
    off: torch.Tensor
    lo: int
    span: int


def index_span(n_valid: int, lo: int, hi: int) -> Optional[int]:
    """The direct index's span for ``n_valid`` valid build keys from
    ``lo`` to ``hi``, or None when the dictionary takes the sparse route:
    no valid key, a valid int64.max key (the invalid rows' sentinel), or a
    span past 2·n_valid + ``INDEX_SLACK`` or from 2^31 on."""
    if n_valid < 1 or hi == _I64_MAX:
        return None
    span = hi - lo + 1
    if span > 2 * n_valid + INDEX_SLACK or span >= 1 << 31:
        return None
    return span


def join_index_plain(sk, prefix) -> Optional[JoinIndex]:
    """``join_index`` in torch: ``searchsorted`` of every key of the span
    into the valid keys (the first ``prefix[-1]`` sorted rows)."""
    nv = int(prefix[-1])
    if nv < 1:
        return None
    lo, hi = int(sk[0]), int(sk[nv - 1])
    span = index_span(nv, lo, hi)
    if span is None:
        return None
    keys = torch.arange(span + 1, dtype=torch.int64, device=sk.device) + lo
    off = torch.searchsorted(sk[:nv], keys, right=False)
    return JoinIndex(off.to(torch.int32), lo, span)


def join_probe_plain(sk, perm, prefix, pkeys, pvalid, mask, k_cap: int,
                     index: Optional[JoinIndex] = None) -> tuple:
    n = pkeys.shape[0]
    dev = pkeys.device
    pm = torch.ones(n, dtype=torch.bool, device=dev)
    for m in (pvalid, mask):
        if m is not None:
            pm &= m
    if index is None:
        lo = torch.searchsorted(sk, pkeys, right=False)
        hi = torch.searchsorted(sk, pkeys, right=True)
        cntv = prefix[hi] - prefix[lo]
    else:
        # every row of a dense run is valid: the count is hi - lo
        last = index.lo + index.span - 1
        pm &= (pkeys >= index.lo) & (pkeys <= last)
        d = pkeys.clamp(index.lo, last) - index.lo
        lo = index.off[d].to(torch.int64)
        cntv = index.off[d + 1].to(torch.int64) - lo
    cnt = torch.where(pm, cntv, torch.zeros((), dtype=torch.int64,
                                            device=dev))
    total = cnt.sum()
    t = int(total)
    pairs = torch.full((k_cap, 2), -1, dtype=torch.int32, device=dev)
    k = min(t, k_cap)
    if k:
        rows = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
        start = torch.cumsum(cnt, 0) - cnt
        within = torch.arange(t, device=dev) - start[rows]
        pairs[:k, 0] = rows[:k].to(torch.int32)
        pairs[:k, 1] = perm[(lo[rows] + within)[:k]]
    return pairs, total


class _ProbeParams(ctypes.Structure):
    """``struct ProbeParams`` of csrc/join.cu."""
    _p = ctypes.c_void_p
    _ll = ctypes.c_longlong
    _fields_ = [("n_probe", _ll), ("n_build", _ll), ("sk", _p),
                ("perm", _p), ("prefix", _p), ("pkeys", _p),
                ("pvalid", _p), ("mask", _p), ("off", _p), ("key_lo", _ll),
                ("span", _ll), ("k_cap", _ll), ("pairs", _p), ("work", _p),
                ("n_tiles", _ll)]


class _IndexParams(ctypes.Structure):
    """``struct IndexParams`` of csrc/join.cu."""
    _ll = ctypes.c_longlong
    _fields_ = [("sk", ctypes.c_void_p), ("n_valid", _ll), ("key_lo", _ll),
                ("span", _ll), ("off", ctypes.c_void_p)]


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = load_checked("join", {
            "probe_params_bytes": ctypes.sizeof(_ProbeParams),
            "index_params_bytes": ctypes.sizeof(_IndexParams),
            "probe_tile_rows": TILE, "probe_samples": SAMPLES},
            "join_error_string")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.join_probe_launch.argtypes = [i, ctypes.POINTER(_ProbeParams), p]
        lib.join_probe_launch.restype = i
        lib.join_index_launch.argtypes = [i, ctypes.POINTER(_IndexParams), p]
        lib.join_index_launch.restype = i
        _lib = lib
    return _lib


def _where(dev: torch.device) -> tuple:
    return (dev.index if dev.index is not None
            else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)


def _check_dictionary(sk, perm, prefix) -> int:
    nb = sk.shape[0] if sk.dim() == 1 else -1
    if not 0 <= nb < 1 << 31:
        raise ValueError(f"join serves 0 <= n < 2^31 build rows, got {nb}")
    dev = sk.device
    check_vector(sk, "sk", nb, dev, (torch.int64,))
    if perm is not None:
        check_vector(perm, "perm", nb, dev, (torch.int32,))
    check_vector(prefix, "prefix", nb + 1, dev, (torch.int64,))
    return nb


def join_index(sk: torch.Tensor, prefix: torch.Tensor) -> Optional[JoinIndex]:
    """The direct index of the build dictionary (``sk``, ``prefix`` of
    ``sort.join_build``) when its valid keys are dense (``index_span``),
    else None.  Reads three numbers back (the valid count and the least
    and greatest valid key), so it waits for the dictionary."""
    global index_launches
    nb = _check_dictionary(sk, None, prefix)
    dev = sk.device
    if dev.type == "cpu":
        return join_index_plain(sk, prefix)
    if dev.type != "cuda":
        raise ValueError(f"join_index runs on cuda or cpu, not {dev}")
    if nb == 0:
        return None
    nv_t = prefix[-1:]
    nv, lo, hi = torch.cat([nv_t, sk[:1], sk.gather(
        0, (nv_t - 1).clamp(min=0))]).tolist()
    span = index_span(nv, lo, hi)
    if span is None:
        return None
    off = torch.empty(span + 1, dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    p = _IndexParams(sk=sk.data_ptr(), n_valid=nv, key_lo=lo, span=span,
                     off=off.data_ptr())
    at = _where(dev)
    raise_on(lib, "join_error_string",
             lib.join_index_launch(at[0], ctypes.byref(p), at[1]),
             "join_index launch")
    index_launches += 1
    return JoinIndex(off, lo, span)


def join_probe(sk: torch.Tensor, perm: torch.Tensor, prefix: torch.Tensor,
               pkeys: torch.Tensor, pvalid: Optional[torch.Tensor],
               mask: Optional[torch.Tensor], k_cap: int,
               index: Optional[JoinIndex] = None) -> tuple:
    """The pairs of the probe rows ``pkeys`` against the build dictionary
    (``sk``, ``perm``, ``prefix``; its ``join_index`` or None) into
    ``k_cap`` slots → (pairs int32[k_cap, 2], total 0-d int64), not
    synchronized."""
    global launches
    n = pkeys.shape[0] if pkeys.dim() == 1 else -1
    if not 0 <= n < 1 << 31:
        raise ValueError(f"join_probe serves 0 <= n < 2^31 probe rows, "
                         f"got {n}")
    nb = _check_dictionary(sk, perm, prefix)
    if not 1 <= k_cap < 1 << 31:
        raise ValueError(f"join_probe: k_cap {k_cap} outside [1, 2^31)")
    dev = pkeys.device
    check_vector(pkeys, "pkeys", n, dev, (torch.int64,))
    if sk.device != dev:
        raise ValueError(f"sk is on {sk.device}, expected {dev}")
    for m, name in ((pvalid, "pvalid"), (mask, "mask")):
        if m is not None:
            check_vector(m, name, n, dev, (torch.bool,))
    if index is not None:
        if not 1 <= index.span < 1 << 31:
            raise ValueError(f"join_probe: index span {index.span}")
        check_vector(index.off, "index", index.span + 1, dev, (torch.int32,))
    if dev.type == "cpu":
        return join_probe_plain(sk, perm, prefix, pkeys, pvalid, mask, k_cap,
                                index)
    if dev.type != "cuda":
        raise ValueError(f"join_probe runs on cuda or cpu, not {dev}")
    pairs = torch.empty((k_cap, 2), dtype=torch.int32, device=dev)
    if n == 0 or nb == 0:
        pairs.fill_(-1)
        return pairs, torch.zeros((), dtype=torch.int64, device=dev)
    lib = _kernel_lib()
    n_tiles = -(-n // TILE)
    # status words, the tile counter, the total (zeroed by the launcher);
    # the sparse route's samples of sk
    work = torch.empty(n_tiles + 2 + (SAMPLES if index is None else 0),
                       dtype=torch.int64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    p = _ProbeParams(n_probe=n, n_build=nb, sk=sk.data_ptr(),
                     perm=perm.data_ptr(), prefix=prefix.data_ptr(),
                     pkeys=pkeys.data_ptr(), pvalid=ptr(pvalid),
                     mask=ptr(mask), k_cap=k_cap, pairs=pairs.data_ptr(),
                     work=work.data_ptr(), n_tiles=n_tiles)
    if index is not None:
        p.off, p.key_lo, p.span = index.off.data_ptr(), index.lo, index.span
    at = _where(dev)
    raise_on(lib, "join_error_string",
             lib.join_probe_launch(at[0], ctypes.byref(p), at[1]),
             "join_probe launch")
    launches += 1
    return pairs, work[n_tiles + 1]
