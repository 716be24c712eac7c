"""Direct-index GROUP BY aggregation: the gate, the plain PyTorch version,
and the launcher of the CUDA kernel ``csrc/hash_agg.cu``.

Counterpart of the TPU kernel ``tikv_tpu/device/pallas_hash.py`` (``build``):
one pass over the feed turns every live row into a slot id and adds the
row into per-slot int64 states — a row count, and per aggregate lane a
non-NULL count and an exact sum.  Three slot modes share the kernel:

- ``dense``  — GROUP BY over a small contiguous key domain: ``key - base``
  in int32 indexes the slot directly (BASELINE config 4);
- ``sparse`` — arbitrary int64 key domains: the host dictionary-encodes
  the keys once per snapshot (``DeviceRunner._sparse_slots``) and the
  dense slot ids ride as one int32 plane (config 4s);
- ``simple`` — no GROUP BY: every masked row lands in slot 0 (config 3).

The gate is the TPU kernel's (pallas_hash.py:128-196): int32 non-NULL
kernel inputs, integer sums only (the reference's ``pf == 0``) and at
most ``MAX_SLOTS`` materialized slots.  One clause is dropped: the TPU
kernel refuses plans whose kernel reads no column (a zero-input
``pallas_call``), while this kernel serves COUNT(*) from the row count.

``hash_agg`` takes the plain version only for a device of type ``cpu``;
on a CUDA device it launches the kernel or raises.  ``launches`` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..datatype import EvalType
from ..expr.rpn import RpnColumnRef

# Feed padding unit (rows): the TPU kernel's grid block, kept so feed
# shapes line up with the reference's.
BLOCK = 1 << 18

MAX_SLOTS = 1 << 12

# lanes per launch the CUDA kernel is instantiated for
MAX_LANES = 8

MODE_DENSE = "dense"
MODE_SPARSE = "sparse"
MODE_SIMPLE = "simple"
_MODE_CODE = {MODE_SIMPLE: 0, MODE_DENSE: 1, MODE_SPARSE: 2}

# kernel launches since import (the chip smoke resets it around a run)
launches = 0


def _rpn_cols(rpn) -> set:
    return {n.col_idx for n in rpn.nodes if isinstance(n, RpnColumnRef)}


def kernel_col_ids(plan, mode: str) -> tuple:
    """used_cols positions whose VALUES the aggregation reads on the
    device (selection, aggregate arguments, and the dense key).  These
    must be int32 and non-NULL; a sparse key is consumed as precomputed
    slot ids, so its raw column never reaches the kernel."""
    ids: set = set()
    for r in plan.sel_rpns:
        ids |= _rpn_cols(r)
    for r in plan.agg_rpns:
        if r is not None:
            ids |= _rpn_cols(r)
    if mode == MODE_DENSE:
        ids |= _rpn_cols(plan.key_rpn)
    return tuple(sorted(ids))


def key_never_null(plan) -> bool:
    """True when the group key provably cannot be NULL: a bare column
    reference (the gate already requires kernel inputs to be non-NULL;
    an expression key keeps a NULL slot)."""
    nodes = plan.key_rpn.nodes
    return len(nodes) == 1 and isinstance(nodes[0], RpnColumnRef)


def n_slots(plan, capacity: int, mode: str = MODE_DENSE) -> int:
    """Slots the kernel materializes: groups, plus the NULL-key slot
    where a key may be NULL (always for sparse slot ids)."""
    if mode == MODE_SIMPLE:
        return 1
    if mode == MODE_SPARSE:
        return capacity + 1
    return capacity + (0 if key_never_null(plan) else 1)


def int_sums_only(plan) -> bool:
    """SUM/AVG arguments are integers (the reference's ``pf == 0``)."""
    return not any(r is not None and spec.kind in ("sum", "avg")
                   and r.ret_type is EvalType.REAL
                   for spec, r in zip(plan.specs, plan.agg_rpns))


def supported(plan, feed, dtypes, capacity: int,
              mode: str = MODE_DENSE) -> bool:
    """Data-level gate for one request (see the module doc)."""
    if not int_sums_only(plan):
        return False
    if n_slots(plan, capacity, mode) > MAX_SLOTS:
        return False
    if feed["n_pad"] % BLOCK != 0:
        return False
    return all(not feed["null_flags"][i] and dtypes[i] == "int32"
               for i in kernel_col_ids(plan, mode))


@dataclass
class Lane:
    """One aggregate input: int32 ``values`` (None for a COUNT) and a bool
    ``ok`` validity plane (None when validity equals the row mask)."""

    values: Optional[torch.Tensor] = None
    ok: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def row_slots(mode: str, n: int, n_slots: int, key=None, key_ok=None,
              base: int = 0, capacity: int = 0, mask=None,
              device="cpu") -> torch.Tensor:
    """int64 slot per live row; rows that land nowhere get ``n_slots``."""
    drop = torch.full((n,), n_slots, dtype=torch.int64, device=device)
    live = torch.ones((n,), dtype=torch.bool, device=device) \
        if mask is None else mask
    if mode == MODE_SIMPLE:
        return torch.where(live, torch.zeros_like(drop), drop)
    k = key.to(torch.int64)
    if mode == MODE_SPARSE:
        return torch.where(live & (k >= 0) & (k < n_slots), k, drop)
    # dense: the int32 wraparound of key - base, as the TPU kernel computes it
    rel = key - torch.tensor(_as_int32(base), dtype=torch.int32,
                             device=device)
    rel = rel.to(torch.int64)
    in_range = (rel >= 0) & (rel < capacity)
    km = torch.ones_like(live) if key_ok is None else key_ok
    slot = torch.where(live & km & in_range, rel, drop)
    if n_slots > capacity:
        slot = torch.where(live & ~km,
                           torch.full_like(drop, capacity), slot)
    return slot


def hash_agg_plain(mode, n, slots, n_slots, key=None, key_ok=None, base=0,
                   capacity=0, mask=None, lanes: Sequence[Lane] = (),
                   device="cpu"):
    """Reference semantics of the kernel with ``index_add_`` per state."""
    def live(t):
        return None if t is None else t[:n]

    idx = row_slots(mode, n, n_slots, live(key), live(key_ok), base,
                    capacity, live(mask), device)

    def scatter(vals):
        out = torch.zeros(n_slots + 1, dtype=torch.int64, device=device)
        out.index_add_(0, idx, vals.to(torch.int64))
        out = out[:n_slots]
        if slots > n_slots:
            out = torch.cat([out, torch.zeros(slots - n_slots,
                                              dtype=torch.int64,
                                              device=device)])
        return out

    count = scatter(torch.ones(n, dtype=torch.int64, device=device))
    outs = []
    for lane in lanes:
        ok = live(lane.ok)
        s = None
        if lane.values is not None:
            v = live(lane.values)
            if ok is not None:
                v = torch.where(ok, v, torch.zeros_like(v))
            s = scatter(v)
        outs.append((s, None if ok is None else scatter(ok)))
    return count, outs


def _as_int32(v: int) -> int:
    """``v`` reduced to the int32 range (two's complement), as the TPU
    kernel's int32 scalar carries ``base``."""
    return ((int(v) + (1 << 31)) % (1 << 32)) - (1 << 31)


# ---------------------------------------------------------------------------
# CUDA kernel launcher
# ---------------------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("hash_agg")
        p = ctypes.c_void_p
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.hash_agg_launch.argtypes = [
            ctypes.c_int, p, p, p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            pp, pp, pp, pp, p, p]
        lib.hash_agg_launch.restype = ctypes.c_int
        lib.hash_agg_smem_limit.argtypes = [ctypes.c_int]
        lib.hash_agg_smem_limit.restype = ctypes.c_int
        lib.hash_agg_error_string.argtypes = [ctypes.c_int]
        lib.hash_agg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(t, name, dtype, n, device):
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if t.dim() != 1 or t.shape[0] < n or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor of "
                         f">= {n} rows, got {tuple(t.shape)}")
    return t.data_ptr()


def lanes_per_launch(n_slots: int, smem_limit: int) -> int:
    """How many lanes fit one block's shared-memory table."""
    fit = (smem_limit - 4 * n_slots) // (12 * n_slots)
    if fit < 1:
        raise ValueError(f"{n_slots} slots do not fit {smem_limit} B of "
                         "shared memory")
    return min(MAX_LANES, fit)


def _hash_agg_cuda(mode, n, slots, n_slots, key, key_ok, base, capacity,
                   mask, lanes, device):
    global launches
    lib = _kernel_lib()
    dev_index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key_p = _check(key, "key", torch.int32, n, device)
    if mode != MODE_SIMPLE and key_p is None:
        raise ValueError(f"{mode} mode needs a key plane")
    key_ok_p = _check(key_ok, "key_ok", torch.bool, n, device)
    mask_p = _check(mask, "mask", torch.bool, n, device)
    count = torch.zeros(slots, dtype=torch.int64, device=device)
    outs = []
    ptrs = []
    for j, lane in enumerate(lanes):
        vp = _check(lane.values, f"lane {j} values", torch.int32, n, device)
        op = _check(lane.ok, f"lane {j} ok", torch.bool, n, device)
        s = torch.zeros(slots, dtype=torch.int64, device=device) \
            if vp is not None else None
        nn = torch.zeros(slots, dtype=torch.int64, device=device) \
            if op is not None else None
        outs.append((s, nn))
        ptrs.append((vp, op, None if s is None else s.data_ptr(),
                     None if nn is None else nn.data_ptr()))
    per = lanes_per_launch(n_slots, lib.hash_agg_smem_limit(dev_index))
    stream = torch.cuda.current_stream(device).cuda_stream
    groups = [ptrs[i:i + per] for i in range(0, len(ptrs), per)] or [[]]
    for g, group in enumerate(groups):
        arr = [(ctypes.c_void_p * MAX_LANES)(*[p[f] for p in group])
               for f in range(4)]
        err = lib.hash_agg_launch(
            dev_index, key_p, key_ok_p, mask_p, n, _MODE_CODE[mode],
            _as_int32(base), capacity, n_slots, len(group), *arr,
            count.data_ptr() if g == 0 else None, stream)
        if err != 0:
            raise RuntimeError("hash_agg kernel launch failed: "
                               + lib.hash_agg_error_string(err).decode())
        launches += 1
    return count, outs


def hash_agg(mode: str, n: int, slots: int, n_slots: int, key=None,
             key_ok=None, base: int = 0, capacity: int = 0, mask=None,
             lanes: Sequence[Lane] = (), device="cuda"):
    """Per-slot aggregation states over rows ``[0, n)``.

    ``slots``: length of every output (the full layout, e.g. capacity+2);
    ``n_slots``: how many of them the kernel materializes (the rest stay
    zero).  ``key``: int32 key values (dense) or slot ids (sparse);
    ``key_ok``/``mask``/lane ``ok``: bool planes or None (all valid).
    Returns ``(count, [(sum | None, nonnull | None) per lane])``, int64.
    """
    device = torch.device(device)
    if mode not in _MODE_CODE or n < 0 or not 0 < n_slots <= slots:
        raise ValueError(f"bad layout: mode={mode!r} n={n} "
                         f"n_slots={n_slots} slots={slots}")
    if device.type == "cpu":
        return hash_agg_plain(mode, n, slots, n_slots, key, key_ok, base,
                              capacity, mask, lanes, device)
    if device.type != "cuda":
        raise ValueError(f"hash_agg runs on cuda or cpu, not {device}")
    return _hash_agg_cuda(mode, n, slots, n_slots, key, key_ok, base,
                          capacity, mask, lanes, device)


def states_from_lanes(specs, lane_of, count, outs):
    """(present, per-spec state dicts) from the kernel outputs, in the
    state layout of ops/agg.py.  ``lane_of[i]``: lane index of spec i, or
    None when its state is the row count (COUNT(*), or COUNT of a column
    whose validity is the row mask)."""
    states = []
    for spec, li in zip(specs, lane_of):
        if spec.kind == "count_star":
            states.append({"count": count})
            continue
        s, nn = (None, None) if li is None else outs[li]
        nonnull = count if nn is None else nn
        if spec.kind == "count":
            states.append({"count": nonnull})
        elif spec.kind == "sum":
            states.append({"sum": s, "nonnull": nonnull})
        else:   # avg
            states.append({"sum": s, "count": nonnull})
    return count > 0, states
