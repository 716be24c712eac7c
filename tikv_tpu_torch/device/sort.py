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
sort them.  On the card a sort reads every key's range of images in one
kernel and waits once for it (16 bytes a key); ``pack_groups`` then packs
consecutive keys, from the least significant, into as few unsigned images
of at most 64 bits as their widths allow, and the kernels sort each packed
image by 8-bit digits (``sort_perm_packed_plain`` is the same grouping in
PyTorch: one stable argsort a group).  Each wrapper takes the plain
version only for tensors on the CPU; on a CUDA tensor it launches its
kernels or raises.  ``sort_launches`` and ``build_launches`` count wrapper
calls that launched the kernels.
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
DIGIT_BITS = 8      # bits a radix pass sorts
RADIX = 1 << DIGIT_BITS
TILE32 = 4096       # rows of a pass tile, images of at most 32 bits
TILE64 = 2048       # the same, wider images
BUILD_TILE = 4096   # rows of join_build's gather and prefix tiles
_I64_MAX = (1 << 63) - 1
_U64 = (1 << 64) - 1
_KINDS = {torch.int64: 0, torch.float64: 1, torch.uint8: 2, torch.bool: 2}


def key_width(lo: int, hi: int) -> int:
    """Bits of a key whose images span [lo, hi] (0: a constant key)."""
    return ((hi - lo) & _U64).bit_length()


def pack_groups(widths: Sequence[int]) -> list:
    """The packed images of keys of these widths (the first key most
    significant): consecutive keys from the least significant, each at the
    bit offset the widths below it take, while the widths sum to at most
    64; keys of width 0 drop out.  → [(key indices, offsets, total
    bits)], the least significant group first."""
    groups, keys, offs, total = [], [], [], 0
    for k in reversed(range(len(widths))):
        w = int(widths[k])
        if w == 0:
            continue
        if total + w > 64:
            groups.append((keys, offs, total))
            keys, offs, total = [], [], 0
        keys.append(k)
        offs.append(total)
        total += w
    if keys:
        groups.append((keys, offs, total))
    return groups


def work_words(n: int, groups) -> int:
    """The zeroed work (u64 words) the kernels take for these groups: per
    pass, a status word per tile and digit, the digit histogram and a tile
    counter (csrc/sort.cu group_words)."""
    words = 0
    for _keys, _offs, bits in groups:
        tiles = -(-n // (TILE32 if bits <= 32 else TILE64))
        words += -(-bits // DIGIT_BITS) * (tiles * RADIX + RADIX + 1)
    return words


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


def packed_image(images: Sequence[torch.Tensor], los: Sequence[int],
                 group) -> torch.Tensor:
    """One group's packed image as an int64 that sorts as the unsigned
    image does (its top bit flipped): ``images`` are the keys' order
    images (rows already in the order the group reads them), ``los`` their
    least images."""
    keys, offs, _bits = group
    x = torch.zeros_like(images[keys[0]])
    for k, off in zip(keys, offs):
        x |= torch.bitwise_left_shift(images[k] - los[k], off)
    return x ^ torch.iinfo(torch.int64).min


def sort_perm_packed_plain(keys: Sequence[torch.Tensor],
                           n: int) -> torch.Tensor:
    """``sort_perm`` as the kernels group it: one stable argsort of each
    packed image (``pack_groups``), the least significant group first,
    each later one read through the permutation so far."""
    dev = keys[0].device if keys else "cpu"
    perm = torch.arange(n, dtype=torch.int64, device=dev)
    if n == 0:
        return perm.to(torch.int32)
    images = [order_image(k) for k in keys]
    los = [int(i.min()) for i in images]
    widths = [key_width(lo, int(i.max())) for lo, i in zip(los, images)]
    for group in pack_groups(widths):
        perm = perm[_argsort(packed_image([i[perm] for i in images], los,
                                          group))]
    return perm.to(torch.int32)


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
    _k = ctypes.c_int * MAX_KEYS
    _fields_ = [("n", ctypes.c_longlong), ("n_keys", ctypes.c_int),
                ("keys", _p * MAX_KEYS), ("kinds", _k),
                ("lo", ctypes.c_ulonglong * MAX_KEYS),
                ("n_groups", ctypes.c_int), ("g_count", _k),
                ("g_key", _k * MAX_KEYS), ("g_off", _k * MAX_KEYS),
                ("g_bits", _k), ("perm", _p), ("img", _p * 2), ("tmp", _p),
                ("range", _p), ("work", _p),
                ("work_words", ctypes.c_longlong)]


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
            "sort_tile_rows32": TILE32, "sort_tile_rows64": TILE64,
            "sort_build_tile_rows": BUILD_TILE,
            "sort_max_keys": MAX_KEYS}, "sort_error_string")
        i, p = ctypes.c_int, ctypes.c_void_p
        sp, bp = ctypes.POINTER(_SortParams), ctypes.POINTER(_BuildParams)
        for fn in (lib.sort_range_launch, lib.sort_groups_launch):
            fn.argtypes = [i, sp, p]
            fn.restype = i
        for fn in (lib.join_build_prep_launch, lib.join_build_finish_launch):
            fn.argtypes = [i, sp, bp, p]
            fn.restype = i
        _lib = lib
    return _lib


def _dev_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _check_n(n: int, what: str) -> None:
    if not 0 <= n < 1 << 31:
        raise ValueError(f"{what} serves 0 <= n < 2^31 rows (int32 "
                         f"positions), got {n}")


def _launch(lib, fn: str, at: tuple, *args) -> None:
    """``fn`` of the library on ``at`` = (device index, stream handle)."""
    raise_on(lib, "sort_error_string", getattr(lib, fn)(at[0], *args, at[1]),
             fn)


def _sort_on_card(lib, p: _SortParams, perm: torch.Tensor, keep: list,
                  at: tuple) -> None:
    """The rest of a sort whose ranges ``sort_range_launch`` (or
    ``join_build_prep_launch``) queued into ``p.range``: wait for them
    (the one synchronization), group the keys, launch the passes.  The
    scratch goes into ``keep``, which must stay referenced until the
    launches are queued.  What does not depend on the ranges (the buffers
    of a 32-bit image, the common case) is allocated before the wait, so
    the card idles as little as it can between the two launches."""
    n, dev = p.n, perm.device
    tmp = torch.empty(n, dtype=torch.int32, device=dev)
    img = torch.empty((2, n), dtype=torch.int32, device=dev)
    got = keep[0].tolist()                  # waits for the range kernel
    los = [got[2 * k] & _U64 for k in range(p.n_keys)]
    groups = pack_groups([key_width(lo, ~got[2 * k + 1] & _U64)
                          for k, lo in enumerate(los)])
    p.lo[:p.n_keys] = los
    p.n_groups = len(groups)
    for g, (keys, offs, bits) in enumerate(groups):
        p.g_count[g] = len(keys)
        p.g_key[g][:len(keys)] = keys
        p.g_off[g][:len(keys)] = offs
        p.g_bits[g] = bits
    if any(bits > 32 for _k, _o, bits in groups):
        img = torch.empty((2, n), dtype=torch.int64, device=dev)
    words = work_words(n, groups)
    work = torch.empty(max(1, words), dtype=torch.int64, device=dev)
    keep += [img, tmp, work]
    p.perm, p.tmp, p.work, p.work_words = (perm.data_ptr(), tmp.data_ptr(),
                                           work.data_ptr(), words)
    p.img[0], p.img[1] = img[0].data_ptr(), img[1].data_ptr()
    _launch(lib, "sort_groups_launch", at, ctypes.byref(p))


def _where(dev: torch.device) -> tuple:
    return _dev_index(dev), torch.cuda.current_stream(dev).cuda_stream


def _range_params(n: int, keys: Sequence[torch.Tensor]) -> tuple:
    """(parameters naming ``keys``, [the range buffer])."""
    dev = keys[0].device
    rng = torch.empty(2 * len(keys), dtype=torch.int64, device=dev)
    p = _SortParams(n=n, n_keys=len(keys), range=rng.data_ptr())
    p.keys[:len(keys)] = [k.data_ptr() for k in keys]
    p.kinds[:len(keys)] = [_KINDS[k.dtype] for k in keys]
    return p, [rng]


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
    keys = [k.view(torch.uint8) if k.dtype == torch.bool else k
            for k in keys]
    p, keep = _range_params(n, keys)
    at = _where(dev)
    _launch(lib, "sort_range_launch", at, ctypes.byref(p))
    _sort_on_card(lib, p, perm, keep, at)
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
    skey = torch.empty(n, dtype=torch.int64, device=dev)
    nsv = torch.empty(n, dtype=torch.uint8, device=dev)
    sums = torch.empty(-(-n // BUILD_TILE), dtype=torch.int64, device=dev)
    b = _BuildParams(keys=keys.data_ptr(),
                     valid=valid.view(torch.uint8).data_ptr(),
                     n_live=int(n_live), skey=skey.data_ptr(),
                     nsv=nsv.data_ptr(), sk=sk.data_ptr(),
                     prefix=prefix.data_ptr(), tile_sums=sums.data_ptr())
    # (skey, nsv): the sentineled key, then "not valid"
    p, keep = _range_params(n, [skey, nsv])
    at = _where(dev)
    _launch(lib, "join_build_prep_launch", at, ctypes.byref(p),
            ctypes.byref(b))
    _sort_on_card(lib, p, perm, keep, at)
    _launch(lib, "join_build_finish_launch", at, ctypes.byref(p),
            ctypes.byref(b))
    build_launches += 1
    return sk, perm, prefix
