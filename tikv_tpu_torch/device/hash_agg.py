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

The launcher's plan is pure Python, so the CPU tests reach it: lanes that
hold the same tensors are read once (``plan_lanes``, ``plane_sources``),
the table modes take 32-bit or 64-bit shared cells (``cell_format``) and
fold them before they can overflow (``geometry``), and misaligned planes
get a scalar head (``row_phase``).  The card's limits are queried once per
kernel shape and cached.
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
MAX_CELLS = 2 * MAX_LANES + 1

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
# the kernel's lanes and launch geometry (pure Python: the CPU tests reach it)
# ---------------------------------------------------------------------------

THREADS = 256          # threads per block (csrc/hash_agg.cu)
WARPS = THREADS // 32


def _ident(t):
    """Tensors with one identity hold the same rows (they are checked to be
    contiguous and 1-D)."""
    return None if t is None else (t.device, t.dtype, t.data_ptr())


@dataclass
class LanePlan:
    """``lanes``: the distinct lanes the kernel reads, in first-seen order
    (two lanes are one where they hold the same values and validity
    tensors); ``of[i]``: the distinct lane given lane i repeats, or -1 for
    a lane that reads nothing (no values, no validity)."""

    lanes: list
    of: list


def plan_lanes(lanes: Sequence[Lane]) -> LanePlan:
    """The distinct lanes of ``lanes`` (see ``LanePlan``)."""
    distinct, of, index = [], [], {}
    for ln in lanes:
        if ln.values is None and ln.ok is None:
            of.append(-1)
            continue
        key = (_ident(ln.values), _ident(ln.ok))
        if key not in index:
            index[key] = len(distinct)
            distinct.append(ln)
        of.append(index[key])
    return LanePlan(distinct, of)


def plane_sources(lanes: Sequence[Lane]) -> tuple:
    """(vsrc, osrc): per lane of one launch, the first lane of that launch
    with the same values (validity) tensor — the one whose load it
    shares.  A lane without such a plane is its own source."""
    vfirst, ofirst, vsrc, osrc = {}, {}, [], []
    for j, ln in enumerate(lanes):
        vsrc.append(j if ln.values is None
                    else vfirst.setdefault(_ident(ln.values), j))
        osrc.append(j if ln.ok is None
                    else ofirst.setdefault(_ident(ln.ok), j))
    return vsrc, osrc


FMT_PACKED = "packed"
FMT_SPLIT = "split"
_FMT_CODE = {FMT_PACKED: 0, FMT_SPLIT: 1}


@dataclass
class Launch:
    """One kernel launch: its distinct lanes, whether it adds the row count
    (the first launch does), its cell format, its cells per slot and its
    dynamic shared memory in bytes.

    ``packed``: one 64-bit cell per lane (count << shift | biased sum), and
    one for the row count unless ``row_lane`` (a lane with values and no
    validity of its own) carries it.  ``split``: 32-bit cells — ``cells[c]``
    is ("sum" | "count", lane) or ("rows", -1), sums first — each with an
    int64 twin in the table its folds add into."""

    lanes: list
    count: bool
    fmt: str
    row_lane: int
    n_cells: int
    smem: int
    cells: list


def split_cells(lanes: Sequence[Lane]) -> list:
    """The ``split`` format's cells for ``lanes``: each SUM, each lane's own
    non-NULL count, the row count."""
    return [("sum", j) for j, ln in enumerate(lanes)
            if ln.values is not None] \
        + [("count", j) for j, ln in enumerate(lanes) if ln.ok is not None] \
        + [("rows", -1)]


def cell_format(n_slots: int, lanes: Sequence[Lane], value_bytes: int,
                smem_limit: int) -> str:
    """``split`` where a 32-bit sum cell lasts 2^16 rows or more (values
    of at most 2 bytes) and every lane fits one launch's table (4 + 8
    bytes per cell); else ``packed``.  A 64-bit shared atomic add is a
    compare-and-swap loop on Hopper (``ATOMS.CAST.SPIN.64``), a 32-bit one
    a single instruction, so two 32-bit adds beat one 64-bit add."""
    if value_bytes > 2 or len(lanes) > MAX_LANES:
        return FMT_PACKED
    fits = 12 * n_slots * len(split_cells(lanes)) <= smem_limit
    return FMT_SPLIT if fits else FMT_PACKED


def lanes_per_launch(n_slots: int, smem_limit: int) -> int:
    """How many lanes fit one block's table of 8-byte packed cells, one
    cell per slot kept for the row count."""
    fit = smem_limit // (8 * n_slots) - 1
    if fit < 1:
        raise ValueError(f"{n_slots} slots do not fit {smem_limit} B of "
                         "shared memory")
    return min(MAX_LANES, fit)


def plan_launches(mode: str, n_slots: int, lanes: Sequence[Lane],
                  smem_limit: int, value_bytes: int = 4) -> list:
    """The launches that add ``lanes`` (distinct) for ``n_slots`` slots,
    with values of ``value_bytes`` bytes.  Simple mode sums in registers
    (its format is nominal) and needs shared memory only for the final
    per-warp reduction."""
    if mode == MODE_SIMPLE:
        groups = [list(lanes[i:i + MAX_LANES])
                  for i in range(0, len(lanes), MAX_LANES)] or [[]]
        return [Launch(group, g == 0, FMT_PACKED, -1, 0,
                       8 * WARPS * (1 + 2 * len(group)), [])
                for g, group in enumerate(groups)]
    if cell_format(n_slots, lanes, value_bytes, smem_limit) == FMT_SPLIT:
        cells = split_cells(lanes)
        return [Launch(list(lanes), True, FMT_SPLIT, -1, len(cells),
                       12 * n_slots * len(cells), cells)]
    per = lanes_per_launch(n_slots, smem_limit)
    groups = [list(lanes[i:i + per]) for i in range(0, len(lanes), per)] \
        or [[]]
    out = []
    for g, group in enumerate(groups):
        count = g == 0
        row_lane = next((j for j, ln in enumerate(group)
                         if ln.values is not None and ln.ok is None), -1) \
            if count else -1
        cells = len(group) + (1 if count and row_lane < 0 else 0)
        out.append(Launch(group, count, FMT_PACKED, row_lane, cells,
                          8 * n_slots * cells, []))
    return out


def unroll(mode: str, n_lanes: int) -> int:
    """4-row groups each thread loads before adding any (csrc Unroll)."""
    if mode == MODE_SIMPLE:
        return 4 if n_lanes <= 2 else 2 if n_lanes <= 4 else 1
    return 2 if n_lanes <= 4 else 1


def tile_rows(mode: str, n_lanes: int) -> int:
    """Rows a block reads per step."""
    return THREADS * 4 * unroll(mode, n_lanes)


def fold_bits(value_bytes: int, fmt: str = FMT_PACKED) -> int:
    """log2 of the rows a block may add into its cells between two folds,
    for values of ``value_bytes`` bytes (0: no values).  ``packed``: the
    cell holds count << shift | Σ(v + 2^(8nb-1)); with 2^k rows both fields
    fit 64 bits while 8nb + 2k ≤ 63.  ``split``: a 32-bit sum of 2^k values
    of nb bytes stays within int32 while 8nb - 1 + k ≤ 31 (a count cell
    within uint32 while k ≤ 32)."""
    if fmt == FMT_SPLIT:
        return 32 - 8 * value_bytes if value_bytes else 32
    return (63 - 8 * value_bytes) // 2


def cell_shift(value_bytes: int) -> int:
    """Bit where a packed cell's count starts."""
    return 8 * value_bytes + fold_bits(value_bytes)


@dataclass(frozen=True)
class Geometry:
    grid: int           # blocks
    fold_every: int     # steps (tiles) a block takes between two folds
    shift: int          # packed cell = count << shift | biased sum
    bias: int           # 2^(8nb-1), added to every value (packed)


def geometry(mode: str, n: int, n_lanes: int, value_bytes: int,
             resident: int, fmt: str = FMT_PACKED) -> Geometry:
    """Launch geometry for ``n`` rows: at most ``resident`` blocks (as
    many as the card holds at once) striding over tiles, and folds often
    enough that no cell overflows: a block adds at most ``fold_every``
    tiles plus the (< 4) head rows between two folds, fewer than
    2^fold_bits rows."""
    if resident < 1:
        raise ValueError("the kernel does not fit the card")
    if not 0 <= value_bytes <= 4 or (fmt == FMT_SPLIT and value_bytes > 2):
        raise ValueError(f"value_bytes={value_bytes} does not suit {fmt}")
    tile = tile_rows(mode, n_lanes)
    tiles = -(-max(n, 0) // tile)
    k = fold_bits(value_bytes, fmt)
    fold_every = (1 << k) // tile - 1
    assert fold_every >= 1 and fold_every * tile + 3 < 1 << k
    return Geometry(grid=max(1, min(tiles, resident)), fold_every=fold_every,
                    shift=cell_shift(value_bytes),
                    bias=(1 << (8 * value_bytes - 1)) if value_bytes else 0)


def row_phase(int_ptrs: Sequence[int], bool_ptrs: Sequence[int]):
    """Rows to read one by one before every int32 plane (``int_ptrs``)
    sits on a 16-byte boundary and every bool plane on a 4-byte one; None
    where the planes disagree (the kernel then reads every row alone)."""
    if any(p % 4 for p in int_ptrs):
        raise ValueError("an int32 plane is not 4-byte aligned")
    phases = {(-p // 4) % 4 for p in int_ptrs} | {(-p) % 4 for p in bool_ptrs}
    if len(phases) > 1:
        return None
    return phases.pop() if phases else 0


# ---------------------------------------------------------------------------
# CUDA kernel launcher
# ---------------------------------------------------------------------------

_lib = None
_SMEM_LIMIT: dict = {}      # device index → opt-in shared bytes per block
_RESIDENT: dict = {}        # (device, mode, format, lanes, smem) → blocks


class _Params(ctypes.Structure):
    """``struct Params`` of csrc/hash_agg.cu."""
    _p = ctypes.c_void_p
    _fields_ = [
        ("key", _p), ("key_ok", _p), ("mask", _p),
        ("n", ctypes.c_longlong), ("head", ctypes.c_longlong),
        ("vec", ctypes.c_int), ("base", ctypes.c_int),
        ("capacity", ctypes.c_int), ("n_slots", ctypes.c_int),
        ("n_lanes", ctypes.c_int), ("row_lane", ctypes.c_int),
        ("n_cells", ctypes.c_int), ("shift", ctypes.c_int),
        ("bias", ctypes.c_uint), ("fold_every", ctypes.c_int),
        ("values", _p * MAX_LANES), ("ok", _p * MAX_LANES),
        ("vsrc", ctypes.c_int * MAX_LANES), ("osrc", ctypes.c_int * MAX_LANES),
        ("sum_out", _p * MAX_LANES), ("nonnull_out", _p * MAX_LANES),
        ("count_out", _p),
        ("sum_cell", ctypes.c_int * MAX_LANES),
        ("cnt_cell", ctypes.c_int * MAX_LANES),
        ("row_cell", ctypes.c_int), ("n_sum", ctypes.c_int),
        ("cell_out", _p * MAX_CELLS)]


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("hash_agg")
        i = ctypes.c_int
        lib.hash_agg_prepare.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
        lib.hash_agg_prepare.restype = i
        lib.hash_agg_launch.argtypes = [i, ctypes.POINTER(_Params), i, i, i,
                                        i, ctypes.c_void_p]
        lib.hash_agg_launch.restype = i
        lib.hash_agg_smem_limit.argtypes = [i]
        lib.hash_agg_smem_limit.restype = i
        lib.hash_agg_error_string.argtypes = [i]
        lib.hash_agg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"hash_agg {what} failed: "
                           + lib.hash_agg_error_string(err).decode())


def _smem_limit(lib, dev_index: int) -> int:
    limit = _SMEM_LIMIT.get(dev_index)
    if limit is None:
        limit = lib.hash_agg_smem_limit(dev_index)
        if limit < 0:
            raise RuntimeError("hash_agg: cannot read the shared memory limit")
        _SMEM_LIMIT[dev_index] = limit
    return limit


def _resident(lib, dev_index: int, mode: str, fmt: str, n_lanes: int,
              smem: int) -> int:
    key = (dev_index, mode, fmt, n_lanes, smem)
    blocks = _RESIDENT.get(key)
    if blocks is None:
        out = ctypes.c_int(0)
        _raise_on(lib, lib.hash_agg_prepare(
            dev_index, _MODE_CODE[mode], _FMT_CODE[fmt], n_lanes, smem,
            ctypes.byref(out)), "occupancy query")
        blocks = _RESIDENT[key] = out.value
    return blocks


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


def _params(mode, n, key_p, key_ok_p, mask_p, base, capacity, n_slots,
            launch: Launch, outs, count, geo: Geometry) -> _Params:
    """One launch's ``_Params``; ``outs``: the launch's lanes' (sum,
    nonnull) outputs.  Entries past the launch's lanes and cells stay zero
    (the kernel never reads them)."""
    lanes = launch.lanes
    nl = len(lanes)

    def ptr(t):
        return None if t is None else t.data_ptr()

    values = [ptr(ln.values) for ln in lanes]
    oks = [ptr(ln.ok) for ln in lanes]
    # the planes this launch reads (simple mode reads no key)
    ints = [q for q in [key_p if mode != MODE_SIMPLE else None] + values
            if q is not None]
    bools = [q for q in [key_ok_p if mode == MODE_DENSE else None, mask_p]
             + oks if q is not None]
    head = row_phase(ints, bools)
    p = _Params(
        key=key_p, key_ok=key_ok_p, mask=mask_p, n=n,
        head=0 if head is None else min(head, n), vec=head is not None,
        base=_as_int32(base), capacity=capacity, n_slots=n_slots,
        n_lanes=nl, row_lane=launch.row_lane, n_cells=launch.n_cells,
        shift=geo.shift, bias=geo.bias, fold_every=geo.fold_every,
        count_out=count.data_ptr() if launch.count else None, row_cell=-1)
    vsrc, osrc = plane_sources(lanes)
    p.values[:nl], p.ok[:nl], p.vsrc[:nl], p.osrc[:nl] = values, oks, vsrc, \
        osrc
    p.sum_out[:nl] = [ptr(s) for s, _nn in outs]
    p.nonnull_out[:nl] = [ptr(nn) for _s, nn in outs]
    p.sum_cell[:nl] = p.cnt_cell[:nl] = [-1] * nl
    for c, (kind, j) in enumerate(launch.cells):
        if kind == "sum":
            p.sum_cell[j], p.cell_out[c] = c, ptr(outs[j][0])
            p.n_sum += 1
        elif kind == "count":
            p.cnt_cell[j], p.cell_out[c] = c, ptr(outs[j][1])
        else:
            p.row_cell, p.cell_out[c] = c, count.data_ptr()
    return p


def _hash_agg_cuda(mode, n, slots, n_slots, key, key_ok, base, capacity,
                   mask, lanes, value_bytes, device):
    global launches
    lib = _kernel_lib()
    dev_index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key_p = _check(key, "key", torch.int32, n, device)
    if mode != MODE_SIMPLE and key_p is None:
        raise ValueError(f"{mode} mode needs a key plane")
    key_ok_p = _check(key_ok, "key_ok", torch.bool, n, device)
    mask_p = _check(mask, "mask", torch.bool, n, device)
    for j, lane in enumerate(lanes):
        _check(lane.values, f"lane {j} values", torch.int32, n, device)
        _check(lane.ok, f"lane {j} ok", torch.bool, n, device)

    plan = plan_lanes(lanes)
    # every output is a row of one zeroed buffer (one fill on the device)
    rows = iter(torch.zeros((1 + sum((ln.values is not None) + (ln.ok is not
                                                                None)
                                     for ln in plan.lanes), slots),
                            dtype=torch.int64, device=device))
    count = next(rows)
    outs = [(None if ln.values is None else next(rows),
             None if ln.ok is None else next(rows)) for ln in plan.lanes]
    stream = torch.cuda.current_stream(device).cuda_stream
    launch_list = plan_launches(mode, n_slots, plan.lanes,
                                _smem_limit(lib, dev_index),
                                value_bytes) if n > 0 else []
    first = 0
    for launch in launch_list:
        nl = len(launch.lanes)
        mine = outs[first:first + nl]
        first += nl
        nb = value_bytes if any(ln.values is not None
                                for ln in launch.lanes) else 0
        geo = geometry(mode, n, nl, nb, _resident(
            lib, dev_index, mode, launch.fmt, nl, launch.smem), launch.fmt)
        p = _params(mode, n, key_p, key_ok_p, mask_p, base, capacity,
                    n_slots, launch, mine, count, geo)
        _raise_on(lib, lib.hash_agg_launch(
            dev_index, ctypes.byref(p), _MODE_CODE[mode],
            _FMT_CODE[launch.fmt], geo.grid, launch.smem, stream),
            "kernel launch")
        launches += 1
    # a repeated lane's outputs are copies of its first one's (one device
    # copy each: nothing waits on the host)
    seen, result = set(), []
    for j in plan.of:
        if j < 0:
            result.append((None, None))
        elif j in seen:
            result.append(tuple(None if t is None else t.clone()
                                for t in outs[j]))
        else:
            seen.add(j)
            result.append(outs[j])
    return count, result


def hash_agg(mode: str, n: int, slots: int, n_slots: int, key=None,
             key_ok=None, base: int = 0, capacity: int = 0, mask=None,
             lanes: Sequence[Lane] = (), device="cuda",
             value_bytes: int = 4):
    """Per-slot aggregation states over rows ``[0, n)``.

    ``slots``: length of every output (the full layout, e.g. capacity+2);
    ``n_slots``: how many of them the kernel materializes (the rest stay
    zero).  ``key``: int32 key values (dense) or slot ids (sparse);
    ``key_ok``/``mask``/lane ``ok``: bool planes or None (all valid).
    ``value_bytes``: every lane value lies in [-2^(8b-1), 2^(8b-1)) for
    b = value_bytes (1-4; the runner's ``_arg_nbytes``); the kernel biases
    values by 2^(8b-1), and a narrower width folds its packed cells less
    often.  Lanes that hold the same tensors are read once.
    Returns ``(count, [(sum | None, nonnull | None) per lane])``, int64.
    """
    device = torch.device(device)
    if mode not in _MODE_CODE or n < 0 or not 0 < n_slots <= slots:
        raise ValueError(f"bad layout: mode={mode!r} n={n} "
                         f"n_slots={n_slots} slots={slots}")
    if value_bytes not in (1, 2, 3, 4):
        raise ValueError(f"value_bytes={value_bytes} is not 1-4")
    if device.type == "cpu":
        return hash_agg_plain(mode, n, slots, n_slots, key, key_ok, base,
                              capacity, mask, lanes, device)
    if device.type != "cuda":
        raise ValueError(f"hash_agg runs on cuda or cpu, not {device}")
    return _hash_agg_cuda(mode, n, slots, n_slots, key, key_ok, base,
                          capacity, mask, lanes, value_bytes, device)


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
