"""The device split of a resident feed: the wrapper and plain PyTorch
version of the CUDA kernel ``csrc/split.cu``.

Counterpart of the JAX package's ``runner._split_plane_kernel``
(runner.py:2168), there one jitted call a plane followed by one digest a
plane (``_mint_split_child``, :2254).  ``split_planes(planes, pos, n_child,
n_pad_child, right)`` maps every plane of a parent feed (the same rows
each, any feed dtype, bool included) to its child plane of
``n_pad_child`` rows:

- the left child (``right`` False): ``x[:n_pad_child]``;
- the right child: ``roll(x, −pos)[:n_pad_child]``;
- in both, rows at or past ``n_child`` are zero (the padding invariant of
  ``_build_flat``'s host zeros),

and returns the child planes with their digests over the live prefix,
Σ_{i<n_child} bits(child[i])·(2i+1) mod 2^64 (``supervisor.
host_plane_digest``'s formula), as one (P,) int64 tensor.  On a CUDA
tensor it is one launch of ``split_kernel`` for every plane (at most
``MAX_PLANES``; more raise), which reads only the parent rows the child
keeps; on a CPU tensor the plain version (slice or roll, ``torch.where``,
then ``digest.plane_digest_plain``).  ``launches`` counts kernel launches
and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from . import selection
from .digest import _INT_OF_WIDTH, plane_digest_plain

# the widest feed the runner builds: every column a value and a validity
# plane
MAX_PLANES = 2 * selection.MAX_PLANES
# the kernel's plane table entry (csrc/split.cu SplitPlane)
_ENTRY_BYTES = 32
# rows a block covers in one step (csrc/split.cu THREADS * ITEMS)
_ROWS_PER_BLOCK = 1024

# kernel launches since import (the chip smoke resets them around a run)
launches = 0


def _check(planes: Sequence[torch.Tensor], pos: int, n_child: int,
           n_pad_child: int, right: bool) -> None:
    """Raise unless the split is well formed."""
    if not planes:
        raise ValueError("split_planes: no plane")
    if len(planes) > MAX_PLANES:
        raise ValueError(f"split_planes: {len(planes)} planes, at most "
                         f"{MAX_PLANES} in one launch")
    n_parent = planes[0].shape[0] if planes[0].dim() == 1 else -1
    dev = planes[0].device
    for x in planes:
        if x.dim() != 1 or not x.is_contiguous() or \
                x.shape[0] != n_parent:
            raise ValueError("split_planes: every plane must be a "
                             "contiguous 1-D tensor of the parent's rows")
        if x.device != dev:
            raise ValueError("split_planes: planes on several devices")
        if x.dtype.is_complex or x.element_size() not in _INT_OF_WIDTH:
            raise ValueError(f"split_planes: no split of {x.dtype}")
    lo = pos if right else 0
    if not (0 <= pos <= n_parent and 0 <= n_child and
            lo + n_child <= n_parent and n_child <= n_pad_child <= n_parent
            and n_pad_child >= 1):
        raise ValueError(
            f"split_planes: pos {pos}, {n_child} live rows of {n_pad_child}"
            f" do not fit a parent of {n_parent} rows")


def split_planes_plain(planes: Sequence[torch.Tensor], pos: int,
                       n_child: int, n_pad_child: int,
                       right: bool) -> tuple:
    """The reference's steps in torch → (child planes, (P,) int64
    digests)."""
    _check(planes, pos, n_child, n_pad_child, right)
    out, digests = [], []
    for x in planes:
        y = (torch.roll(x, -pos) if right else x)[:n_pad_child]
        iota = torch.arange(n_pad_child, device=x.device)
        child = torch.where(iota < n_child, y,
                            torch.zeros((), dtype=x.dtype, device=x.device))
        out.append(child.contiguous())
        digests.append(plane_digest_plain(child, 0, n_child))
    return out, torch.stack(digests)


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load_checked
        lib = load_checked("split", {"split_plane_size": _ENTRY_BYTES,
                                     "split_rows_per_block":
                                         _ROWS_PER_BLOCK},
                           "split_error_string")
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.split_planes_launch.argtypes = [i, p, i, ll, ll, ll, ll, p, p]
        lib.split_planes_launch.restype = i
        _lib = lib
    return _lib


def split_planes(planes: Sequence[torch.Tensor], pos: int, n_child: int,
                 n_pad_child: int, right: bool) -> tuple:
    """Every plane of one split child → (its child planes, a (P,) int64
    tensor of their digests over rows [0, n_child)), not synchronized."""
    global launches
    pos, n_child, n_pad_child = int(pos), int(n_child), int(n_pad_child)
    _check(planes, pos, n_child, n_pad_child, right)
    dev = planes[0].device
    if dev.type == "cpu":
        return split_planes_plain(planes, pos, n_child, n_pad_child, right)
    if dev.type != "cuda":
        raise ValueError(f"split_planes runs on cuda or cpu, not {dev}")
    from .build import raise_on
    lib = _kernel_lib()
    out = [torch.empty(n_pad_child, dtype=x.dtype, device=dev)
           for x in planes]
    digests = torch.empty(len(planes), dtype=torch.int64, device=dev)
    # the plane table: one pinned block copied on the launch stream
    host = np.zeros((len(planes), _ENTRY_BYTES // 8), np.int64)
    for k, (x, y) in enumerate(zip(planes, out)):
        host[k, :3] = (x.data_ptr(), y.data_ptr(), x.element_size())
    table = torch.from_numpy(host.reshape(-1)).pin_memory().to(
        dev, non_blocking=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid_x = max(1, min(-(-n_pad_child // _ROWS_PER_BLOCK),
                        max(1, 8 * sms // len(planes))))
    raise_on(lib, "split_error_string", lib.split_planes_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        table.data_ptr(), len(planes), pos if right else 0, n_child,
        n_pad_child, grid_x, digests.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "split_planes launch")
    launches += 1
    return out, digests
