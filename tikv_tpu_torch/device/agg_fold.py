"""The aggregation fold: COUNT, SUM, AVG, MIN, MAX, FIRST and the variance
moments per slot in one pass — the plan of its one state buffer, the plain
PyTorch version, and the launcher of the CUDA kernel ``csrc/agg_fold.cu``.

Counterpart of the JAX package's scatter body and simple body
(``runner.py:2701`` ``_build_hash_scatter_body``, ``:2668``
``_build_simple_body``), which fold ``hash_agg_tile`` / ``simple_agg_tile``
in one dispatch.  Three slot modes, as ``ops/agg.py``'s layout has them:
``dense`` (``key - base``, slot ``capacity`` for a NULL key, ``capacity +
1`` scrap and the overflow flag for a live key out of range), ``sparse``
(the host's slot ids) and ``simple`` (one slot; FIRST only here).

Every state goes into one int64 buffer (``FoldOut.buf``: the overflow
flag, then one row of ``n_slots`` cells per state), so a request copies
one tensor to the host (``FoldOut.host`` decodes it into ``ops/agg.py``'s
per-aggregate state dicts).  Arguments that hold the same tensors are one
lane, read once (``plan_fold``).  The rows of a lane:

- ``rows`` (every lane: the masked row count per slot; a lane without a
  validity plane takes it as its ``nonnull``), ``nonnull``;
- ``isum``: an integer lane's exact int64 sum (SUM, AVG);
- ``fsum``, ``sumsq``: float64 sums (a REAL SUM/AVG; the variances);
- ``min``, ``max``: the order-preserving int64 image of the value;
- ``first``, ``firstval``, ``firstok``: the first selected position,
  NULL or not, the value there and its validity.

``agg_fold`` takes the plain version (``agg_fold_plain``: the tiles of
``ops/agg.py`` encoded into the same buffer) only for tensors on the CPU;
on a CUDA tensor it launches the kernel or raises.  ``launches`` counts
kernel launches and nothing else.  The kernel's route (``choose_route``)
is ``registers`` without GROUP BY, else ``shared`` — every lane 4 bytes
wide and the table within the card's shared memory — or ``global``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.agg import (_BIG, AggSpec, VAR_KINDS, _minmax_identity,
                       hash_agg_tile, hash_slots, simple_agg_tile)

MODE_SIMPLE, MODE_DENSE, MODE_SPARSE = "simple", "dense", "sparse"
_MODE_CODE = {MODE_SIMPLE: 0, MODE_DENSE: 1, MODE_SPARSE: 2}
ROUTE_SHARED, ROUTE_GLOBAL, ROUTE_REGISTERS = "shared", "global", "registers"
_ROUTE_CODE = {ROUTE_SHARED: 0, ROUTE_GLOBAL: 1, ROUTE_REGISTERS: 2}

MAX_LANES = 8                 # lanes per launch (csrc/agg_fold.cu)
MAX_ROWS = 72
MAX_CELLS = 64
_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
           torch.float64: 3}
_I64_MAX = (1 << 63) - 1
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1

# kernel launches since import (the chip smoke resets it around a run)
launches = 0

# each aggregate's state dict: its key → the lane's state row ("sum" is
# the lane's isum or fsum by its dtype)
SPEC_KEYS = {
    "count_star": {"count": "rows"},
    "count": {"count": "nonnull"},
    "sum": {"sum": "sum", "nonnull": "nonnull"},
    "avg": {"sum": "sum", "count": "nonnull"},
    "min": {"min": "min", "nonnull": "nonnull"},
    "max": {"max": "max", "nonnull": "nonnull"},
    "first": {"value": "firstval", "pos": "first", "ok": "firstok"},
    **{k: {"sum": "fsum", "sumsq": "sumsq", "count": "nonnull"}
       for k in VAR_KINDS},
}


def _ident(t):
    return None if t is None else (t.device, t.dtype, t.data_ptr(),
                                   tuple(t.stride()))


@dataclass
class FoldLane:
    values: torch.Tensor
    ok: Optional[torch.Tensor]
    rows: dict = field(default_factory=dict)    # state → buffer row

    @property
    def is_float(self) -> bool:
        return self.values.dtype.is_floating_point


@dataclass
class FoldPlan:
    """``lanes``: the distinct (values, validity) pairs; ``rows``: each
    buffer row as (state, lane index or -1 for ``rows``); ``spec_rows``:
    per aggregate, its state dict's keys → buffer row."""

    mode: str
    lanes: list
    rows: list
    spec_rows: list
    spec_lane: list


def _image(value: float, dtype: torch.dtype) -> int:
    """The int64 order image of one value (the kernel's MIN/MAX cells)."""
    if not dtype.is_floating_point:
        return int(value)
    bits = int(np.array([float(value) + 0.0]).view(np.int64)[0])
    return bits if bits >= 0 else bits ^ _I64_MAX


def plan_fold(specs: Sequence[AggSpec], cols: Sequence, mode: str
              ) -> FoldPlan:
    """The buffer layout for ``specs`` over ``cols`` (per aggregate its
    (values, validity | None), or None for COUNT(*))."""
    if mode not in _MODE_CODE:
        raise ValueError(f"mode {mode!r}")
    lanes, index = [], {}
    rows = [("rows", -1)]
    spec_rows, spec_lane = [], []
    for spec, col in zip(specs, cols):
        if spec.kind not in SPEC_KEYS:
            raise ValueError(f"{spec.kind} has no device fold")
        if spec.kind == "first" and mode != MODE_SIMPLE:
            raise ValueError("FIRST folds only without GROUP BY")
        if spec.kind == "count_star":
            spec_rows.append({"count": 0})
            spec_lane.append(-1)
            continue
        values, ok = col
        if values.dtype not in _DTYPES:
            raise ValueError(f"{spec.kind} over {values.dtype}")
        key = (_ident(values), _ident(ok))
        if key not in index:
            index[key] = len(lanes)
            lanes.append(FoldLane(values, ok))
        j = index[key]
        lane = lanes[j]
        got = {}
        for name, state in SPEC_KEYS[spec.kind].items():
            if state == "sum":
                state = "fsum" if lane.is_float else "isum"
            if state == "nonnull" and lane.ok is None:
                got[name] = 0                     # the row count
                continue
            if state not in lane.rows:
                lane.rows[state] = len(rows)
                rows.append((state, j))
            got[name] = lane.rows[state]
        spec_rows.append(got)
        spec_lane.append(j)
    if len(rows) > MAX_ROWS:
        raise ValueError(f"{len(rows)} state rows > {MAX_ROWS}")
    return FoldPlan(mode, lanes, rows, spec_rows, spec_lane)


def init_values(plan: FoldPlan) -> list:
    """Each buffer row's first value: 0, MIN/MAX identities (images),
    FIRST's 'none' position."""
    out = []
    for state, j in plan.rows:
        if state in ("min", "max"):
            dt = plan.lanes[j].values.dtype
            out.append(_image(_minmax_identity(dt, state == "min"), dt))
        elif state == "first":
            out.append(_BIG)
        else:
            out.append(0)
    return out


# ---------------------------------------------------------------------------
# the buffer: encode (plain version) and decode (host)
# ---------------------------------------------------------------------------

def _encode(state: str, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if state in ("fsum", "sumsq"):
        return t.to(torch.float64).view(torch.int64)
    if state in ("min", "max"):
        if not dtype.is_floating_point:
            return t.to(torch.int64)
        bits = (t.to(torch.float64) + 0.0).view(torch.int64)
        return torch.where(bits >= 0, bits, bits ^ _I64_MAX)
    if state == "firstval" and dtype.is_floating_point:
        return t.to(torch.float64).view(torch.int64)
    return t.to(torch.int64)


def _decode(state: str, a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    if state in ("fsum", "sumsq"):
        return a.view(np.float64)
    if state in ("min", "max") and dtype.is_floating_point:
        bits = np.where(a >= 0, a, a ^ _I64_MAX).view(np.float64)
        return bits.astype(np.float32) if dtype == torch.float32 else bits
    if state in ("min", "max") and dtype == torch.int32:
        return a.astype(np.int32)
    if state == "firstval" and dtype.is_floating_point:
        v = a.view(np.float64)
        return v.astype(np.float32) if dtype == torch.float32 else v
    return a


@dataclass
class FoldOut:
    """The fold's one int64 buffer on the device and what it holds."""

    buf: torch.Tensor
    plan: FoldPlan
    n_slots: int

    def host(self) -> tuple:
        """One device→host copy → (present bool[n_slots], overflow bool,
        per aggregate its state dict of numpy [n_slots] arrays)."""
        return decode(self.buf.cpu().numpy(), self.plan, self.n_slots)


def decode(buf: np.ndarray, plan: FoldPlan, n_slots: int) -> tuple:
    rows = buf[1:].reshape(len(plan.rows), n_slots)
    states = []
    for got, j in zip(plan.spec_rows, plan.spec_lane):
        dt = None if j < 0 else plan.lanes[j].values.dtype
        states.append({name: _decode(plan.rows[r][0], rows[r], dt)
                       for name, r in got.items()})
    return rows[0] > 0, bool(buf[0]), states


def _all_valid(n: int, device) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=device).expand(n)


def agg_fold_plain(specs, cols, n: int, mode: str, key=None, key_ok=None,
                   base: int = 0, capacity: int = 0, slot_ids=None,
                   mask=None, device="cpu", value_bound=None) -> FoldOut:
    """The tiles of ``ops/agg.py`` over rows [0, n), encoded into the
    fold's buffer (``value_bound`` sizes only the kernel's cells)."""
    plan = plan_fold(specs, cols, mode)
    dev = torch.device(device)
    row_mask = mask[:n] if mask is not None else _all_valid(n, dev)
    tile_cols = [(torch.zeros(n, dtype=torch.int32, device=dev), row_mask)
                 if c is None else
                 (c[0][:n], c[1][:n] if c[1] is not None
                  else _all_valid(n, dev)) for c in cols]
    if mode == MODE_SIMPLE:
        n_slots = 1
        states = simple_agg_tile(
            specs, [(v, ok & row_mask) for v, ok in tile_cols],
            row_mask.sum(dtype=torch.int64), row_mask)
        states = [{k: t.reshape(1) for k, t in s.items()} for s in states]
        rows_t = row_mask.sum(dtype=torch.int64).reshape(1)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        n_slots = capacity + 2
        if mode == MODE_SPARSE:
            kp, tb = None, ("precomp", slot_ids[:n])
        else:
            kp = (key[:n], key_ok[:n] if key_ok is not None
                  else _all_valid(n, dev))
            tb = base
        got = hash_agg_tile(specs, kp, tile_cols, capacity, tb, row_mask)
        states, overflow = got["states"], got["overflow"]
        idx, _ovf = hash_slots(kp, capacity, tb, row_mask)
        rows_t = torch.zeros(n_slots, dtype=torch.int64, device=dev) \
            .index_add_(0, idx, row_mask.to(torch.int64))
    buf = torch.empty(1 + len(plan.rows) * n_slots, dtype=torch.int64,
                      device=dev)
    buf[0] = overflow.to(torch.int64)
    table = buf[1:].view(len(plan.rows), n_slots)
    table[0] = rows_t
    for got, j, st in zip(plan.spec_rows, plan.spec_lane, states):
        dt = None if j < 0 else plan.lanes[j].values.dtype
        for name, r in got.items():
            if r:
                table[r] = _encode(plan.rows[r][0], st[name], dt)
    return FoldOut(buf, plan, n_slots)


# ---------------------------------------------------------------------------
# the route and the launch parameters (pure Python: the CPU tests reach it)
# ---------------------------------------------------------------------------

THREADS = 256                 # threads per block (csrc/agg_fold.cu)
TILE_SHARED = THREADS * 4 * 2  # rows of one shared-route tile
# rows a block adds into its 32-bit shared cells between two folds into
# their 64-bit twins: FOLD_ROWS, or SHORT_FOLD_ROWS where that keeps v² in
# one cell
FOLD_ROWS = 1 << 15
SHORT_FOLD_ROWS = 1 << 12
_INT32_BOUND = 1 << 31        # |v| of any int32


def fold_rows(bound: Optional[int]) -> int:
    """The shared route's fold interval for int32 values |v| <= ``bound``:
    SHORT_FOLD_ROWS when v² fits one cell over it but not over FOLD_ROWS
    (a fold is cheaper than a second atomic a row), else FOLD_ROWS."""
    b = _INT32_BOUND if bound is None else max(int(bound), 0)
    return SHORT_FOLD_ROWS if FOLD_ROWS * b * b >= 1 << 32 > \
        SHORT_FOLD_ROWS * b * b else FOLD_ROWS


def int_cells(bound: Optional[int]) -> tuple:
    """(sum cells, v² limbs) of an int32 lane on the shared route whose
    values satisfy |v| <= ``bound`` (None: unknown, any int32), over
    ``fold_rows(bound)`` rows.  A sum is one signed cell while rows·bound
    stays inside int32, else its low 16 bits and the rest; v² is one cell
    while rows·bound² stays inside uint32, two 16-bit limbs while v² <
    2^32, else four (the last limb takes the bits above 48, < 2^14).  No
    cell can wrap within a fold interval (replayed in numpy by the CPU
    tests)."""
    b = _INT32_BOUND if bound is None else max(int(bound), 0)
    rows = fold_rows(bound)
    n_sum = 1 if rows * b < 1 << 31 else 2
    n_sq = 1 if rows * b * b < 1 << 32 else 2 if b < 1 << 16 else 4
    return n_sum, n_sq


def shared_cells(plan: FoldPlan, lanes: Sequence[int],
                 bound: Optional[int] = None) -> tuple:
    """The shared route's cells of a launch over ``lanes`` (plan lane
    indices) → (32-bit cells as (state, lane position), float64 cells
    likewise, how many of the 32-bit cells have 64-bit twins).  The cells
    with twins come first — the row count, then per lane its non-NULL
    count, an integer lane's sum (``sum`` or ``lo``/``hi``: its float64 sum
    too) and the limbs of its v² (``sq0``…) — then MIN/MAX images, which
    need no twin.  Only a REAL lane has float64 cells (its sum and sum of
    squares)."""
    n_sum, n_sq = int_cells(bound)
    wide, tail, c64 = [("rows", -1)], [], []
    for pos, j in enumerate(lanes):
        lane = plan.lanes[j]
        if "nonnull" in lane.rows:
            wide.append(("nonnull", pos))
        if lane.is_float:
            c64 += [(st, pos) for st in ("fsum", "sumsq") if st in lane.rows]
        else:
            if "isum" in lane.rows or "fsum" in lane.rows:
                wide += [("sum", pos)] if n_sum == 1 else \
                    [("lo", pos), ("hi", pos)]
            if "sumsq" in lane.rows:
                wide += [(f"sq{k}", pos) for k in range(n_sq)]
        tail += [(st, pos) for st in ("min", "max") if st in lane.rows]
    return wide + tail, c64, len(wide)


def lane_groups(plan: FoldPlan) -> list:
    """The lanes of each launch, at most ``MAX_LANES`` each; without GROUP
    BY the lanes of a launch share one dtype (the registers route's kernel
    is compiled per dtype)."""
    idx = list(range(len(plan.lanes)))
    if plan.mode == MODE_SIMPLE:
        idx.sort(key=lambda j: _DTYPES[plan.lanes[j].values.dtype])
    groups, run = [], []
    for j in idx:
        if run and (len(run) == MAX_LANES or (
                plan.mode == MODE_SIMPLE and plan.lanes[j].values.dtype !=
                plan.lanes[run[0]].values.dtype)):
            groups.append(run)
            run = []
        run.append(j)
    return groups + [run] if run else groups or [[]]


def shared_bytes(plan: FoldPlan, n_slots: int,
                 bound: Optional[int] = None) -> int:
    """Dynamic shared memory of the shared route's largest launch: 8 bytes
    per twin and float64 cell, 4 per 32-bit cell, per slot."""
    most = 0
    for g in lane_groups(plan):
        c32, c64, n_wide = shared_cells(plan, g, bound)
        most = max(most, n_slots * (4 * len(c32) + 8 * (n_wide + len(c64))))
    return most


def choose_route(plan: FoldPlan, n_slots: int, smem_limit: int,
                 bound: Optional[int] = None) -> str:
    """``registers`` without GROUP BY; ``shared`` when every lane is 4
    bytes wide and the table fits ``smem_limit`` bytes; else ``global``."""
    if plan.mode == MODE_SIMPLE:
        return ROUTE_REGISTERS
    narrow = all(ln.values.element_size() == 4 for ln in plan.lanes)
    fits = all(len(shared_cells(plan, g, bound)[0]) <= MAX_CELLS
               for g in lane_groups(plan))
    return ROUTE_SHARED if narrow and fits and \
        shared_bytes(plan, n_slots, bound) <= smem_limit else ROUTE_GLOBAL


class _Params(ctypes.Structure):
    """``struct FoldParams`` of csrc/agg_fold.cu."""
    _p = ctypes.c_void_p
    _i = ctypes.c_int
    _L = _i * MAX_LANES
    _fields_ = [
        ("key", _p), ("key_ok", _p), ("mask", _p),
        ("n", ctypes.c_longlong), ("base", ctypes.c_longlong), ("out", _p),
        ("ticket", _p),
        ("mode", _i), ("key64", _i), ("capacity", _i), ("n_slots", _i),
        ("n_lanes", _i), ("n_rows", _i), ("vec", _i), ("n32", _i),
        ("n_wide", _i), ("n64", _i), ("fold_every", _i),
        ("signed_cells", ctypes.c_ulonglong),
        ("values", _p * MAX_LANES), ("ok", _p * MAX_LANES),
        ("dtype", _L), ("o_rows", _i),
        ("o_nonnull", _L), ("o_isum", _L), ("o_fsum", _L), ("o_sumsq", _L),
        ("o_min", _L), ("o_max", _L), ("o_first", _L), ("o_firstval", _L),
        ("o_firstok", _L),
        ("c_nonnull", _L), ("c_sum", _L), ("n_sum", _L), ("c_sq", _L),
        ("n_sq", _L), ("c_min", _L), ("c_max", _L), ("d_fsum", _L),
        ("d_sumsq", _L),
        ("init32", _i * MAX_CELLS), ("init", ctypes.c_longlong * MAX_ROWS)]


_INIT32 = {"min": _I32_MAX, "max": _I32_MIN}


def launch_params(plan: FoldPlan, n: int, n_slots: int, lanes, key_p,
                  key64: bool, key_ok_p, mask_p, base: int, capacity: int,
                  out_p, first_group: bool, bound: Optional[int] = None,
                  vec: bool = False, ticket_p=None) -> _Params:
    """One launch's ``_Params`` over ``lanes`` (plan lane indices)."""
    p = _Params(key=key_p, key_ok=key_ok_p, mask=mask_p, n=n, base=base,
                out=out_p, ticket=ticket_p, mode=_MODE_CODE[plan.mode],
                key64=int(key64), capacity=capacity, n_slots=n_slots,
                n_lanes=len(lanes), n_rows=len(plan.rows), vec=int(vec),
                fold_every=fold_rows(bound) // TILE_SHARED,
                o_rows=0 if first_group else -1)
    arrays = ("o_nonnull", "o_isum", "o_fsum", "o_sumsq", "o_min", "o_max",
              "o_first", "o_firstval", "o_firstok", "c_nonnull", "c_sum",
              "c_sq", "c_min", "c_max", "d_fsum", "d_sumsq")
    for name in arrays:
        getattr(p, name)[:] = [-1] * MAX_LANES
    p.n_sum[:] = [0] * MAX_LANES
    p.n_sq[:] = [0] * MAX_LANES
    for pos, j in enumerate(lanes):
        lane = plan.lanes[j]
        p.values[pos] = lane.values.data_ptr()
        p.ok[pos] = None if lane.ok is None else lane.ok.data_ptr()
        p.dtype[pos] = _DTYPES[lane.values.dtype]
        for state, r in lane.rows.items():
            getattr(p, "o_" + state)[pos] = r
    c32, c64, p.n_wide = shared_cells(plan, lanes, bound)
    p.n32, p.n64 = len(c32), len(c64)
    signed = 0
    for c, (state, pos) in enumerate(c32):
        p.init32[c] = _INIT32.get(state, 0)
        if state in ("sum", "hi"):
            signed |= 1 << c
        if state in ("sum", "lo"):
            p.c_sum[pos], p.n_sum[pos] = c, 1 if state == "sum" else 2
        elif state == "sq0":
            p.c_sq[pos] = c
            p.n_sq[pos] = sum(1 for st, q in c32
                              if q == pos and st.startswith("sq"))
        elif state in ("nonnull", "min", "max"):
            getattr(p, "c_" + state)[pos] = c
    p.signed_cells = signed
    for c, (state, pos) in enumerate(c64):
        getattr(p, "d_" + state)[pos] = c
    p.init[:len(plan.rows)] = init_values(plan)
    return p


def aligned(tensors) -> bool:
    """Every plane on the boundary of the kernel's 4-row loads at row 0:
    16 bytes for 4- and 8-byte planes, 4 for bool planes."""
    return all(t.data_ptr() % (4 if t.element_size() == 1 else 16) == 0
               for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# CUDA kernel launcher
# ---------------------------------------------------------------------------

_lib = None
_SMEM_LIMIT: dict = {}


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("agg_fold")
        i = ctypes.c_int
        lib.agg_fold_launch.argtypes = [i, ctypes.POINTER(_Params), i, i, i,
                                        ctypes.c_void_p, ctypes.POINTER(i)]
        lib.agg_fold_launch.restype = i
        lib.agg_fold_smem_limit.argtypes = [i]
        lib.agg_fold_smem_limit.restype = i
        lib.agg_fold_error_string.argtypes = [i]
        lib.agg_fold_error_string.restype = ctypes.c_char_p
        lib.agg_fold_params_bytes.restype = i
        if lib.agg_fold_params_bytes() != ctypes.sizeof(_Params):
            raise RuntimeError("agg_fold: the kernel's parameter layout "
                               "differs from the wrapper's")
        _lib = lib
    return _lib


def smem_limit(device: torch.device) -> int:
    """The card's opt-in shared memory per block (queried once)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    limit = _SMEM_LIMIT.get(index)
    if limit is None:
        limit = _kernel_lib().agg_fold_smem_limit(index)
        if limit < 0:
            raise RuntimeError("agg_fold: cannot read the shared memory "
                               "limit")
        _SMEM_LIMIT[index] = limit
    return limit


def route(specs, cols, mode: str, n_slots: int, device,
          value_bound: Optional[int] = None) -> str:
    """The route the kernel takes for these arguments on ``device``."""
    return choose_route(plan_fold(specs, cols, mode), n_slots,
                        smem_limit(torch.device(device)), value_bound)


def _flat(t, name, n, device, dtypes):
    """``t`` checked and as a contiguous 1-D tensor of >= n rows on
    ``device`` (a broadcast constant is materialized)."""
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} is {t.dtype}, expected one of {dtypes}")
    if t.dim() != 1 or t.shape[0] < n:
        raise ValueError(f"{name} must be 1-D with >= {n} rows, got "
                         f"{tuple(t.shape)}")
    return t if t.is_contiguous() else t.contiguous()


def _agg_fold_cuda(specs, cols, n, mode, key, key_ok, base, capacity,
                   slot_ids, mask, device, value_bound):
    global launches
    lib = _kernel_lib()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    cols = [None if c is None else
            (_flat(c[0], f"argument {i} values", n, device, tuple(_DTYPES)),
             _flat(c[1], f"argument {i} validity", n, device,
                   (torch.bool,)))
            for i, c in enumerate(cols)]
    mask = _flat(mask, "mask", n, device, (torch.bool,))
    key_ok = _flat(key_ok, "key_ok", n, device, (torch.bool,))
    if mode == MODE_DENSE:
        key = _flat(key, "key", n, device, (torch.int32, torch.int64))
    elif mode == MODE_SPARSE:
        key = _flat(slot_ids, "slot_ids", n, device, (torch.int32,))
    else:
        key = None
    if mode != MODE_SIMPLE and key is None:
        raise ValueError(f"{mode} mode needs a key")
    if mode != MODE_DENSE:
        key_ok = None
    plan = plan_fold(specs, cols, mode)
    n_slots = 1 if mode == MODE_SIMPLE else capacity + 2
    chosen = choose_route(plan, n_slots, smem_limit(device), value_bound)
    words = 1 + len(plan.rows) * n_slots
    # the buffer, then the registers route's ticket (a word past the end)
    full = torch.empty(words + 1, dtype=torch.int64, device=device)
    buf = full[:words]
    vec = aligned([key, key_ok, mask] + [t for ln in plan.lanes
                                         for t in (ln.values, ln.ok)])
    groups = lane_groups(plan)
    params = (_Params * len(groups))(*[
        launch_params(plan, n, n_slots, g,
                      None if key is None else key.data_ptr(),
                      key is not None and key.dtype == torch.int64,
                      None if key_ok is None else key_ok.data_ptr(),
                      None if mask is None else mask.data_ptr(), base,
                      capacity, buf.data_ptr(), gi == 0, value_bound, vec,
                      full.data_ptr() + 8 * words)
        for gi, g in enumerate(groups)])
    launched = ctypes.c_int(0)
    err = lib.agg_fold_launch(
        index, params, len(groups), _ROUTE_CODE[chosen],
        shared_bytes(plan, n_slots, value_bound)
        if chosen == ROUTE_SHARED else 0,
        torch.cuda.current_stream(device).cuda_stream,
        ctypes.byref(launched))
    launches += launched.value
    if err != 0:
        raise RuntimeError("agg_fold launch failed: "
                           + lib.agg_fold_error_string(err).decode())
    # the lanes' tensors stay alive with the plan until the buffer is read
    return FoldOut(buf, plan, n_slots)


def agg_fold(specs: Sequence[AggSpec], cols: Sequence, n: int, mode: str,
             key=None, key_ok=None, base: int = 0, capacity: int = 0,
             slot_ids=None, mask=None, device=None,
             value_bound: Optional[int] = None) -> FoldOut:
    """Fold rows [0, n) into per-slot states.

    ``cols``: per aggregate its (values, validity | None) — int32, int64,
    float32 or float64 values — or None for COUNT(*).  ``mode``:
    ``simple`` (one slot), ``dense`` (``key`` int32/int64, ``key_ok`` or
    None, ``base``, ``capacity``: slots ``capacity + 2``) or ``sparse``
    (``slot_ids`` int32 with the NULL slot filled in).  ``mask``: the
    selection or None.  ``device``: where the tensors are (the first
    tensor's device when None).  ``value_bound``: a bound on |v| of every
    int32 argument over rows [0, n) — the shared route sizes its cells by
    it (``int_cells``) — or None (any int32); a value past it is a
    caller's fault that the kernel does not detect."""
    if mode not in _MODE_CODE or n < 0 or \
            (mode != MODE_SIMPLE and not 0 < capacity < 1 << 30):
        raise ValueError(f"agg_fold: mode={mode!r} n={n} "
                         f"capacity={capacity}")
    if value_bound is not None and value_bound < 0:
        raise ValueError(f"agg_fold: value_bound={value_bound}")
    if device is None:
        anchor = next((t for t in [key, slot_ids, mask] + [
            c[0] for c in cols if c is not None] if t is not None), None)
        device = anchor.device if anchor is not None else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cpu":
        return agg_fold_plain(specs, cols, n, mode, key, key_ok, base,
                              capacity, slot_ids, mask, device)
    if device.type != "cuda":
        raise ValueError(f"agg_fold runs on cuda or cpu, not {device}")
    return _agg_fold_cuda(specs, cols, n, mode, key, key_ok, base,
                          capacity, slot_ids, mask, device, value_bound)
