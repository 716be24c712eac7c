"""The probe of a device join: the wrapper and plain PyTorch version of the
CUDA kernel ``csrc/join.cu``.

Counterpart of the JAX package's ``device/join.py`` ``_probe_kernel``
(:276).  ``join_probe(sk, perm, prefix, pkeys, pvalid, mask, k_cap)``
takes the build dictionary of ``sort.join_build`` and n probe keys
(int64[n]) with their validity and the probe predicate's bool mask (each
bool[n] or None) → (``pairs`` int32[k_cap, 2]: (probe row, build row) in
probe order then build order, -1 past the total; ``total`` a 0-d int64
tensor, exact even when it exceeds ``k_cap``: the caller then runs again
with a larger capacity).

The wrapper takes the plain version only for tensors on the CPU; on a
CUDA tensor it launches its kernel or raises.  ``launches`` counts wrapper
calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import check_vector, load_checked, raise_on

# kernel launches since import (the chip smoke resets them around a run)
launches = 0

TILE = 4096         # csrc/join.cu TILE


def join_probe_plain(sk, perm, prefix, pkeys, pvalid, mask,
                     k_cap: int) -> tuple:
    n = pkeys.shape[0]
    dev = pkeys.device
    pm = torch.ones(n, dtype=torch.bool, device=dev)
    for m in (pvalid, mask):
        if m is not None:
            pm &= m
    lo = torch.searchsorted(sk, pkeys, right=False)
    hi = torch.searchsorted(sk, pkeys, right=True)
    cnt = torch.where(pm, prefix[hi] - prefix[lo],
                      torch.zeros((), dtype=torch.int64, device=dev))
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
                ("pvalid", _p), ("mask", _p), ("k_cap", _ll),
                ("pairs", _p), ("total", _p), ("lo", _p), ("cnt", _p),
                ("tile_sums", _p)]


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = load_checked("join", {
            "probe_params_bytes": ctypes.sizeof(_ProbeParams),
            "probe_tile_rows": TILE}, "join_error_string")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.join_probe_launch.argtypes = [i, ctypes.POINTER(_ProbeParams), p]
        lib.join_probe_launch.restype = i
        _lib = lib
    return _lib


def join_probe(sk: torch.Tensor, perm: torch.Tensor, prefix: torch.Tensor,
               pkeys: torch.Tensor, pvalid: Optional[torch.Tensor],
               mask: Optional[torch.Tensor], k_cap: int) -> tuple:
    """The pairs of the probe rows ``pkeys`` against the build dictionary
    (``sk``, ``perm``, ``prefix``) into ``k_cap`` slots → (pairs
    int32[k_cap, 2], total 0-d int64), not synchronized."""
    global launches
    n = pkeys.shape[0] if pkeys.dim() == 1 else -1
    nb = sk.shape[0] if sk.dim() == 1 else -1
    if not 0 <= n < 1 << 31 or not 0 <= nb < 1 << 31:
        raise ValueError(f"join_probe serves 0 <= n < 2^31 rows a side, "
                         f"got {n} probe and {nb} build rows")
    if not 1 <= k_cap < 1 << 31:
        raise ValueError(f"join_probe: k_cap {k_cap} outside [1, 2^31)")
    dev = pkeys.device
    check_vector(pkeys, "pkeys", n, dev, (torch.int64,))
    check_vector(sk, "sk", nb, dev, (torch.int64,))
    check_vector(perm, "perm", nb, dev, (torch.int32,))
    check_vector(prefix, "prefix", nb + 1, dev, (torch.int64,))
    for m, name in ((pvalid, "pvalid"), (mask, "mask")):
        if m is not None:
            check_vector(m, name, n, dev, (torch.bool,))
    if dev.type == "cpu":
        return join_probe_plain(sk, perm, prefix, pkeys, pvalid, mask, k_cap)
    if dev.type != "cuda":
        raise ValueError(f"join_probe runs on cuda or cpu, not {dev}")
    pairs = torch.empty((k_cap, 2), dtype=torch.int32, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    if n == 0 or nb == 0:
        pairs.fill_(-1)
        return pairs, total
    lib = _kernel_lib()
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    sums = torch.empty(-(-n // TILE), dtype=torch.int64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    p = _ProbeParams(n_probe=n, n_build=nb, sk=sk.data_ptr(),
                     perm=perm.data_ptr(), prefix=prefix.data_ptr(),
                     pkeys=pkeys.data_ptr(), pvalid=ptr(pvalid),
                     mask=ptr(mask), k_cap=k_cap, pairs=pairs.data_ptr(),
                     total=total.data_ptr(), lo=lo.data_ptr(),
                     cnt=cnt.data_ptr(), tile_sums=sums.data_ptr())
    raise_on(lib, "join_error_string", lib.join_probe_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream),
        "join_probe launch")
    launches += 1
    return pairs, total
