"""Two-level GROUP BY contraction: the plain PyTorch version and the
launcher of the CUDA kernel ``csrc/twolevel.cu``.

Counterpart of ``kernels.twolevel_partial`` in the JAX package (and of the
Pallas prototypes in ``prof/`` that compute the same function): for slot
ids ``idx`` and stacked planes ``L8`` (int8) and ``Lf`` (float32),

    S8[hi, p·LO + lo] = Σ_rows [idx == hi·LO + lo] · L8[p, row]

summed over every row of the call — the reference carry after its last
block: ``S8`` (HI, p8·LO) int64, ``Sf`` (HI, pf·LO) float64 (None when
pf = 0).  Rows whose slot id lies outside [0, HI·LO) add nowhere.

``twolevel`` takes the plain version only for tensors on the CPU; on a
CUDA device it launches the kernel or raises.  ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

# kernel launches since import (the chip smoke resets it around a run)
launches = 0


def _check_args(idx, L8, Lf, LO: int, HI: int):
    if LO < 1 or LO & (LO - 1) or HI < 1:
        raise ValueError(f"bad layout: LO={LO} (a power of two) HI={HI}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be 1-D int32, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    n = idx.shape[0]
    if L8.dim() != 2 or L8.dtype != torch.int8 or L8.shape[1] != n or \
            L8.shape[0] < 1:
        raise ValueError(f"L8 must be (p8 >= 1, {n}) int8, got {L8.dtype} "
                         f"{tuple(L8.shape)}")
    if Lf is not None and (Lf.dim() != 2 or Lf.dtype != torch.float32 or
                           Lf.shape[1] != n):
        raise ValueError(f"Lf must be (pf, {n}) float32, got {Lf.dtype} "
                         f"{tuple(Lf.shape)}")
    devices = {t.device for t in (idx, L8, Lf) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    return devices.pop()


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _packed_sums(idx, planes, LO, HI, dtype):
    """index_add_ of each plane into its slots, packed as (HI, P·LO)."""
    slots = HI * LO
    n_planes = planes.shape[0]
    ids = torch.where((idx >= 0) & (idx < slots), idx.to(torch.int64),
                      torch.full_like(idx, slots, dtype=torch.int64))
    out = torch.zeros((n_planes, slots + 1), dtype=dtype, device=idx.device)
    for p in range(n_planes):           # one plane at a time: bounded memory
        out[p].index_add_(0, ids, planes[p].to(dtype))
    return out[:, :slots].reshape(n_planes, HI, LO).permute(1, 0, 2) \
        .reshape(HI, n_planes * LO).contiguous()


def twolevel_plain(idx, L8, Lf, LO: int, HI: int):
    """Reference semantics of the kernel with ``index_add_`` per plane."""
    _check_args(idx, L8, Lf, LO, HI)
    S8 = _packed_sums(idx, L8, LO, HI, torch.int64)
    Sf = None if Lf is None or Lf.shape[0] == 0 else \
        _packed_sums(idx, Lf, LO, HI, torch.float64)
    return S8, Sf


# ---------------------------------------------------------------------------
# CUDA kernel launcher
# ---------------------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("twolevel")
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.twolevel_launch.argtypes = [i, p, p, p, ctypes.c_longlong, i, i,
                                        i, i, p, p, i, p]
        lib.twolevel_launch.restype = i
        lib.twolevel_smem_limit.argtypes = [i]
        lib.twolevel_smem_limit.restype = i
        lib.twolevel_error_string.argtypes = [i]
        lib.twolevel_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def table_bytes(p8: int, pf: int, LO: int, HI: int) -> int:
    """Shared memory one block's table takes: 4 B per int8 cell, 8 B per
    float cell."""
    return HI * LO * (4 * p8 + 8 * pf)


def shared_route(p8: int, pf: int, LO: int, HI: int, smem_limit: int) -> bool:
    """True when the kernel keeps per-block shared tables (else it adds
    into the outputs with global atomics)."""
    return table_bytes(p8, pf, LO, HI) <= smem_limit


def _twolevel_cuda(idx, L8, Lf, LO, HI, device):
    global launches
    lib = _kernel_lib()
    dev_index = device.index if device.index is not None \
        else torch.cuda.current_device()
    for name, t in (("idx", idx), ("L8", L8), ("Lf", Lf)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p8 = L8.shape[0]
    pf = 0 if Lf is None else Lf.shape[0]
    S8 = torch.zeros((HI, p8 * LO), dtype=torch.int64, device=device)
    Sf = torch.zeros((HI, pf * LO), dtype=torch.float64, device=device) \
        if pf else None
    if idx.shape[0] == 0:
        return S8, Sf                   # nothing to add: no launch
    shared = shared_route(p8, pf, LO, HI, lib.twolevel_smem_limit(dev_index))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.twolevel_launch(
        dev_index, idx.data_ptr(), L8.data_ptr(),
        Lf.data_ptr() if pf else None, idx.shape[0], p8, pf,
        LO.bit_length() - 1, HI, S8.data_ptr(),
        Sf.data_ptr() if pf else None, int(shared), stream)
    if err != 0:
        raise RuntimeError("twolevel kernel launch failed: "
                           + lib.twolevel_error_string(err).decode())
    launches += 1
    return S8, Sf


def twolevel(idx: torch.Tensor, L8: torch.Tensor, Lf: Optional[torch.Tensor],
             LO: int, HI: int):
    """(S8 (HI, p8·LO) int64, Sf (HI, pf·LO) float64 | None) over every
    row of ``idx`` (int32 slot ids) and the planes ``L8`` (p8, n) int8 and
    ``Lf`` (pf, n) float32 | None, on the device the inputs lie on."""
    device = _check_args(idx, L8, Lf, LO, HI)
    if Lf is not None and Lf.shape[0] == 0:
        Lf = None
    if device.type == "cpu":
        return twolevel_plain(idx, L8, Lf, LO, HI)
    if device.type != "cuda":
        raise ValueError(f"twolevel runs on cuda or cpu, not {device}")
    return _twolevel_cuda(idx, L8, Lf, LO, HI, device)
