"""Plane digests and row patches: the wrappers and plain PyTorch versions
of the CUDA kernels ``csrc/digest.cu``.

Counterpart of the JAX package's ``runner._range_digest_kernel``
(runner.py:1981), its ``_dus`` (:1816) and ``mvcc.DeviceMvccResolver.dus``
(mvcc.py:514).  The digest of a plane over [lo, hi) is
Σ bits(x[i])·(2i+1) mod 2^64 at global positions i — a bool as 0/1, any
other dtype as the unsigned view of its own width — the formula of
``supervisor.host_plane_digest``.  It is held as the int64 with the same
64 bits (``as_u64`` reads it as the unsigned value).

- ``plane_digest(arr, lo, hi)``: the digest as a 0-d int64 tensor on the
  plane's device;
- ``patch_rows(plane, pos, vals, digest=False)``: ``plane[pos[i]] =
  vals[i]`` in place for m unique positions in one launch; with
  ``digest`` also the digests of the positions written, before and after
  (what ``_patch_plane``'s two range digests give for a span).

Each wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises.  ``digest_launches`` and
``patch_launches`` count kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import numpy as np
import torch

# kernel launches since import (the chip smoke resets them around a run)
digest_launches = 0
patch_launches = 0

# the signed view of each element width (a bool plane reads as its bytes)
_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}
_MASK_OF_WIDTH = {1: 0xFF, 2: 0xFFFF, 4: 0xFFFFFFFF}
_U64 = (1 << 64) - 1


def as_u64(d: Union[int, torch.Tensor]) -> int:
    """A digest (an int, or a 0-d int64 tensor holding its bits) as the
    unsigned value in [0, 2^64)."""
    return int(d.item() if isinstance(d, torch.Tensor) else d) & _U64


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Each element's unsigned bits, widened into int64 (bit for bit)."""
    if x.dtype == torch.bool:
        return x.to(torch.int64)
    w = x.element_size()
    u = x.view(_INT_OF_WIDTH[w]).to(torch.int64)
    return u & _MASK_OF_WIDTH[w] if w in (2, 4) else u


def _weights(pos: torch.Tensor) -> torch.Tensor:
    return 2 * pos.to(torch.int64) + 1


def plane_digest_plain(arr: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Σ bits(arr[i])·(2i+1) over [lo, hi), as int64 arithmetic (which
    wraps mod 2^64 as the unsigned sum does)."""
    if hi <= lo:
        return torch.zeros((), dtype=torch.int64, device=arr.device)
    idx = torch.arange(lo, hi, dtype=torch.int64, device=arr.device)
    return (_bits(arr[lo:hi]) * _weights(idx)).sum()


def _check_plane(arr: torch.Tensor, name: str) -> None:
    if arr.dim() != 1 or not arr.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor, got "
                         f"{tuple(arr.shape)}")
    if arr.dtype.is_complex or arr.element_size() not in _INT_OF_WIDTH:
        raise ValueError(f"{name}: no digest of {arr.dtype}")


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("digest")
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.plane_digest_launch.argtypes = [i, p, i, ll, ll, ll, p, p]
        lib.plane_digest_launch.restype = i
        lib.patch_rows_launch.argtypes = [i, p, i, p, p, ll, p, p]
        lib.patch_rows_launch.restype = i
        lib.digest_error_string.argtypes = [i]
        lib.digest_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           + lib.digest_error_string(err).decode())


def _dev_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def plane_digest(arr: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The digest of ``arr`` (1-D, contiguous) over [lo, hi) → a 0-d
    int64 tensor on its device, not synchronized."""
    global digest_launches
    _check_plane(arr, "plane")
    lo, hi = int(lo), int(hi)
    if not 0 <= lo <= hi <= arr.shape[0]:
        raise ValueError(f"plane_digest: [{lo}, {hi}) is outside a plane "
                         f"of {arr.shape[0]} rows")
    if arr.device.type == "cpu":
        return plane_digest_plain(arr, lo, hi)
    if arr.device.type != "cuda":
        raise ValueError(f"plane_digest runs on cuda or cpu, not "
                         f"{arr.device}")
    lib = _kernel_lib()
    out = torch.empty((), dtype=torch.int64, device=arr.device)
    sms = torch.cuda.get_device_properties(arr.device).multi_processor_count
    _raise_on(lib, lib.plane_digest_launch(
        _dev_index(arr.device), arr.data_ptr(), arr.element_size(), lo, hi,
        8 * sms, out.data_ptr(),
        torch.cuda.current_stream(arr.device).cuda_stream),
        "plane_digest launch")
    digest_launches += 1
    return out


def patch_rows_plain(plane: torch.Tensor, pos: torch.Tensor,
                     vals: torch.Tensor, digest: bool = False):
    """``plane[pos] = vals`` in place → None, or with ``digest`` the 0-d
    int64 digests (Σ old bits·(2p+1), Σ new bits·(2p+1))."""
    sums = None
    if digest:
        w = _weights(pos)
        sums = ((_bits(plane[pos]) * w).sum(), (_bits(vals) * w).sum())
    plane[pos] = vals
    return sums


def _positions(pos, n: int, device: torch.device) -> torch.Tensor:
    """``pos`` as an int64 tensor on ``device``, after the checks on the
    host: in [0, n) and unique."""
    host = pos.cpu().numpy() if isinstance(pos, torch.Tensor) \
        else np.asarray(pos)
    host = np.ascontiguousarray(host.reshape(-1), dtype=np.int64)
    if host.size and (host.min() < 0 or host.max() >= n):
        raise ValueError(f"patch_rows: a position outside [0, {n})")
    if np.unique(host).size != host.size:
        raise ValueError("patch_rows: duplicate positions (which write "
                         "would win is not defined)")
    return torch.from_numpy(host).to(device)


def patch_rows(plane: torch.Tensor, pos: Union[Sequence[int], np.ndarray,
                                               torch.Tensor],
               vals: torch.Tensor, digest: bool = False
               ) -> Optional[tuple]:
    """Write ``vals[i]`` at ``plane[pos[i]]`` in place for m unique
    positions (checked on the host; raises on a duplicate) in one launch
    → None, or with ``digest`` the 0-d int64 digests of the positions
    written, of their old and of their new elements."""
    _check_plane(plane, "plane")
    pos = _positions(pos, plane.shape[0], plane.device)
    if not isinstance(vals, torch.Tensor):
        vals = torch.as_tensor(np.asarray(vals))
    vals = vals.to(plane.device, plane.dtype).contiguous().reshape(-1)
    if vals.shape[0] != pos.shape[0]:
        raise ValueError(f"patch_rows: {pos.shape[0]} positions, "
                         f"{vals.shape[0]} values")
    if plane.device.type == "cpu":
        return patch_rows_plain(plane, pos, vals, digest)
    if plane.device.type != "cuda":
        raise ValueError(f"patch_rows runs on cuda or cpu, not "
                         f"{plane.device}")
    return _patch_rows_cuda(plane, pos, vals, digest)


def _patch_rows_cuda(plane, pos, vals, digest: bool) -> Optional[tuple]:
    """The launch behind ``patch_rows``, its arguments checked already
    (``pos`` int64 and ``vals`` of the plane's dtype, both on its
    device)."""
    global patch_launches
    lib = _kernel_lib()
    sums = torch.empty(2, dtype=torch.int64, device=plane.device) \
        if digest else None
    _raise_on(lib, lib.patch_rows_launch(
        _dev_index(plane.device), plane.data_ptr(), plane.element_size(),
        pos.data_ptr(), vals.data_ptr(), pos.shape[0],
        None if sums is None else sums.data_ptr(),
        torch.cuda.current_stream(plane.device).cuda_stream),
        "patch_rows launch")
    patch_launches += 1
    return None if sums is None else (sums[0], sums[1])
