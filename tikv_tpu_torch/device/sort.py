"""Stable multi-key argsort and the join's build dictionary: the wrappers
and plain PyTorch versions of the CUDA kernels ``csrc/sort.cu``.

Counterpart of the JAX package's ``device/join.py`` ``sort_perm`` (:479)
and ``_build_kernel`` (:257):

- ``sort_perm(keys, n)``: the int32 permutation that orders n rows by
  ``keys`` (int64, float64 or bool/uint8 tensors of n rows, the first most
  significant), stable: composed stable argsorts, last key first;
- ``join_build(keys, valid, n_live)``: the build side of a device join —
  rows ordered by (key, not valid, position), a NULL key or a row at or
  past ``n_live`` sentineled to int64.max → (``sk`` int64[n], ``perm``
  int32[n], ``prefix`` int64[n + 1], the running count of valid rows in
  that order).

Keys compare by their order image (``order_image``): an int64 as itself; a
float64 with -0.0 equal to +0.0 and every NaN after +inf, as numpy and jnp
sort them.  On the card a wrapper waits once a key for the key's range of
images (16 bytes), so it launches only the radix passes that range needs.
Each wrapper takes the plain version only for tensors on the CPU; on a
CUDA tensor it launches its kernel or raises.  ``sort_launches``
and ``build_launches`` count wrapper calls that launched the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .build import check_vector, load_checked, raise_on

# kernel launches since import (the chip smoke resets them around a run)
sort_launches = 0
build_launches = 0

MAX_KEYS = 8        # csrc/sort.cu MAX_KEYS
TILE = 4096         # rows of a histogram / scatter tile
_I64_MAX = (1 << 63) - 1
_KINDS = {torch.int64: 0, torch.float64: 1, torch.uint8: 2, torch.bool: 2}


def order_image(x: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the sort order of ``x`` (int64,
    float64, bool or uint8): -0.0 → +0.0, NaN → int64.max, a negative
    float's bits with all but the sign flipped."""
    if x.dtype == torch.float64:
        x = torch.where(x == 0, torch.zeros((), dtype=x.dtype,
                                            device=x.device), x)
        b = x.view(torch.int64)
        s = torch.where(b < 0, b ^ _I64_MAX, b)
        return torch.where(torch.isnan(x), torch.full_like(s, _I64_MAX), s)
    return x.to(torch.int64)


def _argsort(v: torch.Tensor) -> torch.Tensor:
    return torch.argsort(v, stable=True)


def sort_perm_plain(keys: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device
                        if keys else "cpu")
    for k in reversed(list(keys)):
        perm = perm[_argsort(order_image(k)[perm])]
    return perm.to(torch.int32)


def join_build_plain(keys: torch.Tensor, valid: torch.Tensor,
                     n_live: int) -> tuple:
    n = keys.shape[0]
    iota = torch.arange(n, device=keys.device)
    sv = valid & (iota < n_live)
    skey = torch.where(sv, keys, torch.full_like(keys, _I64_MAX))
    perm0 = _argsort((~sv).to(torch.int64))
    perm = perm0[_argsort(skey[perm0])]
    prefix = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    prefix[1:] = torch.cumsum(sv[perm].to(torch.int64), 0)
    return skey[perm], perm.to(torch.int32), prefix


class _SortParams(ctypes.Structure):
    """``struct SortParams`` of csrc/sort.cu."""
    _p = ctypes.c_void_p
    _fields_ = [("n", ctypes.c_longlong), ("n_keys", ctypes.c_int),
                ("keys", _p * MAX_KEYS), ("kinds", ctypes.c_int * MAX_KEYS),
                ("perm", _p), ("img", _p * 2), ("tmp", _p), ("hist", _p),
                ("totals", _p), ("minmax", _p)]


class _BuildParams(ctypes.Structure):
    """``struct BuildParams`` of csrc/sort.cu."""
    _p = ctypes.c_void_p
    _fields_ = [("keys", _p), ("valid", _p), ("n_live", ctypes.c_longlong),
                ("skey", _p), ("nsv", _p), ("sk", _p), ("prefix", _p),
                ("tile_sums", _p)]


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = load_checked("sort", {
            "sort_params_bytes": ctypes.sizeof(_SortParams),
            "build_params_bytes": ctypes.sizeof(_BuildParams),
            "sort_tile_rows": TILE, "sort_max_keys": MAX_KEYS},
            "sort_error_string")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.sort_perm_launch.argtypes = [i, ctypes.POINTER(_SortParams), p]
        lib.sort_perm_launch.restype = i
        lib.join_build_launch.argtypes = [i, ctypes.POINTER(_SortParams),
                                          ctypes.POINTER(_BuildParams), p]
        lib.join_build_launch.restype = i
        _lib = lib
    return _lib


def _dev_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _check_n(n: int, what: str) -> None:
    if not 0 <= n < 1 << 31:
        raise ValueError(f"{what} serves 0 <= n < 2^31 rows (int32 "
                         f"positions), got {n}")


def _sort_params(n: int, perm: torch.Tensor) -> tuple:
    """(parameters, scratch tensors) of one sort of n rows into ``perm``;
    the scratch is allocated on perm's device and must stay referenced
    until the launch is queued."""
    dev = perm.device
    n_tiles = -(-n // TILE)
    img = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(2)]
    scratch = {"img": img,
               "tmp": torch.empty(n, dtype=torch.int32, device=dev),
               "hist": torch.empty(256 * n_tiles, dtype=torch.int32,
                                   device=dev),
               "totals": torch.empty(256, dtype=torch.int32, device=dev),
               "minmax": torch.empty(2, dtype=torch.int64, device=dev)}
    p = _SortParams(n=n, perm=perm.data_ptr(),
                    tmp=scratch["tmp"].data_ptr(),
                    hist=scratch["hist"].data_ptr(),
                    totals=scratch["totals"].data_ptr(),
                    minmax=scratch["minmax"].data_ptr())
    p.img[:] = [t.data_ptr() for t in img]
    return p, scratch


def sort_perm(keys: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """The stable permutation (int32[n], on the keys' device) that orders
    n rows by ``keys``, the first most significant; no keys: the
    identity."""
    global sort_launches
    _check_n(n, "sort_perm")
    keys = list(keys)
    if len(keys) > MAX_KEYS:
        raise ValueError(f"sort_perm takes at most {MAX_KEYS} keys")
    if not keys:
        return torch.arange(n, dtype=torch.int32)
    dev = keys[0].device
    for j, k in enumerate(keys):
        check_vector(k, f"key {j}", n, dev, tuple(_KINDS))
    if dev.type == "cpu":
        return sort_perm_plain(keys, n)
    if dev.type != "cuda":
        raise ValueError(f"sort_perm runs on cuda or cpu, not {dev}")
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return perm
    lib = _kernel_lib()
    p, _scratch = _sort_params(n, perm)
    p.n_keys = len(keys)
    keys = [k.view(torch.uint8) if k.dtype == torch.bool else k
            for k in keys]
    p.keys[:len(keys)] = [k.data_ptr() for k in keys]
    p.kinds[:len(keys)] = [_KINDS[k.dtype] for k in keys]
    raise_on(lib, "sort_error_string", lib.sort_perm_launch(
        _dev_index(dev), ctypes.byref(p),
        torch.cuda.current_stream(dev).cuda_stream), "sort_perm launch")
    sort_launches += 1
    return perm


def join_build(keys: torch.Tensor, valid: torch.Tensor,
               n_live: int) -> tuple:
    """The sorted build dictionary of ``keys`` (int64[n]) and ``valid``
    (bool[n]; rows at or past ``n_live`` count as invalid) → (sk
    int64[n], perm int32[n], prefix int64[n + 1])."""
    global build_launches
    n = keys.shape[0] if keys.dim() == 1 else -1
    _check_n(n, "join_build")
    dev = keys.device
    check_vector(keys, "keys", n, dev, (torch.int64,))
    check_vector(valid, "valid", n, dev, (torch.bool,))
    if dev.type == "cpu":
        return join_build_plain(keys, valid, n_live)
    if dev.type != "cuda":
        raise ValueError(f"join_build runs on cuda or cpu, not {dev}")
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    sk = torch.empty(n, dtype=torch.int64, device=dev)
    prefix = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    if n == 0:
        return sk, perm, prefix
    lib = _kernel_lib()
    p, _scratch = _sort_params(n, perm)
    skey = torch.empty(n, dtype=torch.int64, device=dev)
    nsv = torch.empty(n, dtype=torch.uint8, device=dev)
    sums = torch.empty(-(-n // TILE), dtype=torch.int64, device=dev)
    b = _BuildParams(keys=keys.data_ptr(),
                     valid=valid.view(torch.uint8).data_ptr(),
                     n_live=int(n_live), skey=skey.data_ptr(),
                     nsv=nsv.data_ptr(), sk=sk.data_ptr(),
                     prefix=prefix.data_ptr(), tile_sums=sums.data_ptr())
    raise_on(lib, "sort_error_string", lib.join_build_launch(
        _dev_index(dev), ctypes.byref(p), ctypes.byref(b),
        torch.cuda.current_stream(dev).cuda_stream), "join_build launch")
    build_launches += 1
    return sk, perm, prefix
