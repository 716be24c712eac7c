"""Two-level GROUP BY aggregation: the launchers of the CUDA kernel
``csrc/twolevel.cu`` and their plain PyTorch versions.

Counterpart of the JAX package's two-level body (``runner.py:2743``, which
XLA fuses from ``kernels.slot_index``, ``make_planes`` and
``twolevel_partial``) and of the Pallas prototypes in ``prof/`` that
compute its contraction.  For slot ids and stacked int8 / float32 planes,

    S8[hi, p·LO + lo] = Σ_rows [slot == hi·LO + lo] · L8[p, row]

summed over every row of the call — the reference carry after its last
block: ``S8`` (HI, p8·LO) int64, ``Sf`` (HI, pf·LO) float64 (None when
pf = 0).  Rows whose slot lies outside [0, HI·LO) add nowhere.

Two entries share the kernel's accumulate/merge core:

- ``twolevel_fused`` (the runner's): the raw columns — a dense key and its
  validity, or the sparse slot ids; the selection mask; each aggregate's
  (values, validity) — with the plane layouts of ``kernels.build_layouts``.
  The kernel builds every row's slot and planes in registers and never
  writes the planes to device memory.  Its plain version is the
  reference's composition, ``slot_index`` → ``make_planes`` →
  ``twolevel_plain``.  It also returns the overflow flag.
- ``twolevel``: materialized slot ids and planes (the prototypes'
  interface).

Both take the plain version only for tensors on the CPU; on a CUDA device
they launch the kernel or raise.  ``launches`` counts kernel launches and
nothing else.  ``route`` names the kernel's route for a table: "shared",
"cluster" or "global" (``choose_route``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from . import kernels as kn

# kernel launches since import (the chip smoke resets it around a run)
launches = 0

MAX_LANES = 64                  # csrc/twolevel.cu
CLUSTER_SIZES = (2, 4, 8)       # portable thread-block cluster sizes
_SOURCES = {"planes": 0, "dense32": 1, "dense64": 2, "sparse": 3}
_ROUTES = {"shared": 0, "cluster": 1, "global": 2}
LANE_COUNT, LANE_INT32, LANE_INT64, LANE_REAL = range(4)


def _check_layout(LO: int, HI: int) -> None:
    if LO < 1 or LO & (LO - 1) or HI < 1:
        raise ValueError(f"bad layout: LO={LO} (a power of two) HI={HI}")


def _check_args(idx, L8, Lf, LO: int, HI: int):
    _check_layout(LO, HI)
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


def plane_counts(layouts) -> tuple:
    """(p8, pf) of ``kernels.build_layouts``' layouts."""
    p8 = 1 + max([0] + [p for lay in layouts
                        for p in (lay.ok_plane or 0,) + lay.byte_planes])
    return p8, sum(lay.f32_plane is not None for lay in layouts)


def _check_fused(n, layouts, cols, LO, HI, capacity, key, key_ok, slot_ids,
                 mask):
    _check_layout(LO, HI)
    if n < 0 or capacity < 1 or HI * LO < capacity + 2:
        raise ValueError(f"bad layout: n={n} capacity={capacity} needs "
                         f"capacity + 2 <= HI·LO = {HI * LO}")
    if len(cols) != len(layouts):
        raise ValueError(f"{len(cols)} columns for {len(layouts)} layouts")
    if (key is None) == (slot_ids is None):
        raise ValueError("pass a dense key or sparse slot ids, not both")
    if key is not None and key.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"the key must be int32 or int64, got {key.dtype}")
    if slot_ids is not None and slot_ids.dtype != torch.int32:
        raise ValueError(f"slot ids must be int32, got {slot_ids.dtype}")
    tensors = [key, key_ok, slot_ids, mask] + [
        t for lay, col in zip(layouts, cols) if lay.kind != "count_star"
        for t in col]
    for t in tensors:
        if t is not None and (t.dim() != 1 or t.shape[0] < n):
            raise ValueError(f"a column of shape {tuple(t.shape)} for {n} "
                             "rows")
    for name, t in (("key_ok", key_ok), ("mask", mask)):
        if t is not None and t.dtype != torch.bool:
            raise ValueError(f"{name} must be bool, got {t.dtype}")
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    return devices.pop()


# ---------------------------------------------------------------------------
# plain PyTorch versions
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


def twolevel_fused_plain(n: int, layouts, cols, LO: int, HI: int,
                         capacity: int, base: int = 0, key=None, key_ok=None,
                         slot_ids=None, mask=None):
    """The fused entry's semantics as the reference composes them: slot ids
    (``kernels.slot_index``, or the sparse ids under the mask), planes
    (``kernels.make_planes``), then ``twolevel_plain``."""
    device = _check_fused(n, layouts, cols, LO, HI, capacity, key, key_ok,
                          slot_ids, mask)
    mask = torch.ones(n, dtype=torch.bool, device=device) if mask is None \
        else mask[:n]
    if slot_ids is not None:
        scrap = torch.full((), capacity + 1, dtype=torch.int32, device=device)
        idx, overflow = torch.where(mask, slot_ids[:n], scrap), None
    else:
        km = torch.ones((), dtype=torch.bool, device=device) \
            if key_ok is None else key_ok[:n]
        idx, overflow = kn.slot_index((key[:n], km), capacity, base, mask)
    cols = [col if lay.kind == "count_star" else (col[0][:n], col[1][:n])
            for lay, col in zip(layouts, cols)]
    L8, Lf = kn.make_planes(layouts, cols, mask)
    S8, Sf = twolevel_plain(idx.contiguous(), L8, Lf, LO, HI)
    return S8, Sf, overflow


# ---------------------------------------------------------------------------
# the fused kernel's lanes
# ---------------------------------------------------------------------------

@dataclass
class FusedLane:
    """One (values, validity) pair the fused kernel reads.  Where a live row
    is valid (``ok`` None: every live row) it adds 1 to distinct int8 plane
    ``ok_plane``, and its value's ``nb`` biased bytes to distinct planes
    ``val_plane + k`` (LANE_INT32 / LANE_INT64) or its float32 value to
    distinct float plane ``val_plane`` (LANE_REAL).  -1: no such plane."""

    values: Optional[torch.Tensor]
    ok: Optional[torch.Tensor]
    kind: int
    nb: int = 0
    ok_plane: int = -1
    val_plane: int = -1


def _ident(t):
    """Live tensors with one identity hold the same elements."""
    return None if t is None else (t.data_ptr(), t.dtype, t.stride(),
                                   tuple(t.shape))


def plan_lanes(layouts, cols) -> tuple:
    """→ (lanes, src8, srcf): the fused kernel's lanes for ``layouts`` over
    ``cols`` (per layout its (values, validity); ignored for COUNT(*)),
    and for each output int8 / float plane the distinct plane it repeats.

    Output planes that hold the same elements are one distinct plane: the
    validity planes of one validity tensor (and those of an argument whose
    validity aliases the row mask: distinct plane 0), and the byte or float
    planes of one (values, validity) pair — 4n's COUNT(v), SUM(v) and
    AVG(v) make 8 output planes from 4 distinct ones.
    """
    p8, pf = plane_counts(layouts)
    src8, srcf = [0] * p8, [0] * pf
    lanes, by_values = [], {}
    n8, nf = 1, 0
    for lay, col in zip(layouts, cols):
        if lay.kind == "count_star" or not (lay.byte_planes or
                                            lay.f32_plane is not None):
            continue
        values, validity = col
        ok = None if lay.ok_plane == 0 else validity
        real = lay.f32_plane is not None
        lane = by_values.get((_ident(values), _ident(ok), real, lay.nb))
        if lane is None:
            if real:
                lane = FusedLane(values, ok, LANE_REAL, val_plane=nf)
                nf += 1
            else:
                kind = LANE_INT64 if values.element_size() > 4 \
                    else LANE_INT32
                lane = FusedLane(values, ok, kind, lay.nb, val_plane=n8)
                n8 += lay.nb
            by_values[(_ident(values), _ident(ok), real, lay.nb)] = lane
            lanes.append(lane)
        if real:
            srcf[lay.f32_plane] = lane.val_plane
        for k, p in enumerate(lay.byte_planes):
            src8[p] = lane.val_plane + k
    # validity planes, the row mask (distinct plane 0) first; each rides a
    # lane with the same validity, or a COUNT lane of its own
    oks = [(0, None)] + [(lay.ok_plane, None if lay.ok_plane == 0 else col[1])
                         for lay, col in zip(layouts, cols)
                         if lay.ok_plane is not None]
    ok_of: dict = {}
    for p, ok in oks:
        key = _ident(ok)
        if key not in ok_of:
            if ok is None:
                ok_of[key] = 0
            else:
                ok_of[key], n8 = n8, n8 + 1
            lane = next((ln for ln in lanes
                         if _ident(ln.ok) == key and ln.ok_plane < 0), None)
            if lane is None:
                lane = FusedLane(None, ok, LANE_COUNT)
                lanes.append(lane)
            lane.ok_plane = ok_of[key]
        src8[p] = ok_of[key]
    return lanes, src8, srcf


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("twolevel")
        p = ctypes.c_void_p
        pp = ctypes.POINTER(ctypes.c_void_p)
        ip = ctypes.POINTER(ctypes.c_int)
        i = ctypes.c_int
        ll = ctypes.c_longlong
        lib.twolevel_launch.argtypes = [i, p, p, p, ll, i, i, i, i, i, i,
                                        p, p, p]
        lib.twolevel_launch.restype = i
        lib.twolevel_fused_launch.argtypes = [
            i, i, p, p, p, ll, i, ll, i, pp, pp, ip, i, i, i, i, i, i, ip,
            ip, i, i, p, p, p, p]
        lib.twolevel_fused_launch.restype = i
        lib.twolevel_smem_limit.argtypes = [i]
        lib.twolevel_smem_limit.restype = i
        lib.twolevel_active_clusters.argtypes = [i, i, i, ll, ip]
        lib.twolevel_active_clusters.restype = i
        lib.twolevel_error_string.argtypes = [i]
        lib.twolevel_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"twolevel {what} failed: "
                           + lib.twolevel_error_string(err).decode())


def _dev_index(device) -> int:
    device = torch.device("cuda") if device is None else torch.device(device)
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def choose_route(cell_bytes: int, LO: int, HI: int, smem_limit: int,
                 active_clusters) -> tuple:
    """(route, cluster size) for a table of HI·LO slots of ``cell_bytes``:
    "shared" (1) when it fits the ``smem_limit`` bytes one block may opt
    into; else "cluster", split by HI rows over the size among
    ``CLUSTER_SIZES`` whose slices fit and that keeps the most clusters
    resident (``active_clusters(cs, slice_bytes)``, the card's occupancy),
    the smaller on a tie (fewer of its updates go to another block); else
    "global" (0)."""
    if HI * LO * cell_bytes <= smem_limit:
        return "shared", 1
    best, best_clusters = ("global", 0), 0
    for cs in CLUSTER_SIZES:
        slice_bytes = -(-HI // cs) * LO * cell_bytes
        if slice_bytes > smem_limit:
            continue
        clusters = active_clusters(cs, slice_bytes)
        if clusters > best_clusters:
            best, best_clusters = ("cluster", cs), clusters
    return best


def route(d8: int, df: int, LO: int, HI: int, source: str = "planes",
          device=None) -> tuple:
    """(route, cluster size) the kernel takes on ``device`` for a table of
    ``d8`` distinct int8 planes (4 B cells) and ``df`` float planes (8 B)
    over HI·LO slots, read from ``source``: "planes" (``twolevel``), or the
    fused entry's "dense32", "dense64" or "sparse" key."""
    lib = _kernel_lib()
    index = _dev_index(device)
    limit = lib.twolevel_smem_limit(index)
    if limit < 0:
        raise RuntimeError("twolevel: cannot read the shared memory limit")

    def active(cs, smem):
        out = ctypes.c_int(0)
        _raise_on(lib, lib.twolevel_active_clusters(
            index, _SOURCES[source], cs, smem, ctypes.byref(out)),
            "occupancy query")
        return out.value

    return choose_route(4 * d8 + 8 * df, LO, HI, limit, active)


def _twolevel_cuda(idx, L8, Lf, LO, HI, device):
    global launches
    lib = _kernel_lib()
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
    name, cs = route(p8, pf, LO, HI, "planes", device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(lib, lib.twolevel_launch(
        _dev_index(device), idx.data_ptr(), L8.data_ptr(),
        Lf.data_ptr() if pf else None, idx.shape[0], p8, pf,
        LO.bit_length() - 1, HI, _ROUTES[name], cs, S8.data_ptr(),
        Sf.data_ptr() if pf else None, stream), "kernel launch")
    launches += 1
    return S8, Sf


def _operand(t, n: int, dtype):
    """``t``'s first ``n`` rows as a contiguous ``dtype`` tensor on a
    16-byte boundary (the kernel reads 4 rows with one 16-byte load)."""
    t = t[:n].to(dtype).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _fused_cuda(n, layouts, cols, LO, HI, capacity, base, key, key_ok,
                slot_ids, mask, device):
    global launches
    lib = _kernel_lib()
    lanes, src8, srcf = plan_lanes(layouts, cols)
    if len(lanes) > MAX_LANES:
        raise ValueError(f"{len(lanes)} lanes > {MAX_LANES}")
    p8, pf = len(src8), len(srcf)
    d8, df = max(src8) + 1, max(srcf, default=-1) + 1
    out8 = [src8.index(d) for d in range(d8)]
    outf = [srcf.index(e) for e in range(df)]
    S8 = torch.zeros((HI, p8 * LO), dtype=torch.int64, device=device)
    Sf = torch.zeros((HI, pf * LO), dtype=torch.float64, device=device) \
        if pf else None
    overflow = None if slot_ids is not None else \
        torch.zeros(1, dtype=torch.int32, device=device)
    if n > 0:
        keep = []                       # operands alive through the launch

        def ptr(t, dtype):
            if t is None:
                return None
            keep.append(_operand(t, n, dtype))
            return keep[-1].data_ptr()

        if slot_ids is not None:
            source, key_p = "sparse", ptr(slot_ids, torch.int32)
        else:
            source = "dense32" if key.dtype == torch.int32 else "dense64"
            key_p = ptr(key, key.dtype)
        values, oks, meta = [], [], []
        for ln in lanes:
            vdtype = torch.float32 if ln.kind == LANE_REAL else \
                torch.int64 if ln.kind == LANE_INT64 else torch.int32
            values.append(ptr(ln.values, vdtype))
            oks.append(ptr(ln.ok, torch.bool))
            # a lane's byte planes first appear as consecutive output
            # planes (build_layouts numbers planes in order)
            outs = outf if ln.kind == LANE_REAL else out8
            val_out = outs[ln.val_plane] if ln.val_plane >= 0 else -1
            meta += [ln.kind, ln.nb, ln.ok_plane,
                     out8[ln.ok_plane] if ln.ok_plane >= 0 else -1,
                     ln.val_plane, val_out]
        name, cs = route(d8, df, LO, HI, source, device)
        arr = ctypes.c_void_p * len(lanes)
        ints = ctypes.c_int * len(meta)
        _raise_on(lib, lib.twolevel_fused_launch(
            _dev_index(device), _SOURCES[source], key_p,
            ptr(key_ok, torch.bool), ptr(mask, torch.bool), int(base),
            capacity, n, len(lanes), arr(*values), arr(*oks), ints(*meta),
            LO.bit_length() - 1, HI, p8, pf, d8, df,
            (ctypes.c_int * d8)(*out8), (ctypes.c_int * max(df, 1))(*outf),
            _ROUTES[name], cs, S8.data_ptr(),
            Sf.data_ptr() if pf else None,
            None if overflow is None else overflow.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream), "kernel launch")
        launches += 1
    # the output planes that repeat a distinct plane are copies of it
    # (one device copy each: an index tensor would wait on an upload)
    for S, src, first, P in ((S8, src8, out8, p8), (Sf, srcf, outf, pf)):
        for p in range(P):
            if first[src[p]] != p:
                view = S.view(HI, P, LO)
                view[:, p].copy_(view[:, first[src[p]]])
    return S8, Sf, None if overflow is None else overflow[0] != 0


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------

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


def twolevel_fused(n: int, layouts, cols, LO: int, HI: int, capacity: int,
                   base: int = 0, key=None, key_ok=None, slot_ids=None,
                   mask=None):
    """(S8, Sf | None, overflow) over rows [0, n) of the raw columns, on the
    device they lie on.

    ``layouts``: ``kernels.build_layouts``' plane layouts; ``cols[i]``:
    layout i's (values, validity), 1-D tensors of at least ``n`` rows
    (ignored for COUNT(*)).  Slots follow
    ``kernels.slot_index``: ``key`` (int32 or int64) shifted by ``base``
    into [0, ``capacity``), NULL keys (``key_ok`` false) in slot
    ``capacity``; or ``slot_ids`` (int32, sparse).  Rows outside ``mask``
    (None: every row) go to scrap, ``capacity + 1``, and add nothing.
    ``overflow``: a 0-d bool tensor, true where a live key left
    [0, capacity) (None for slot ids).
    """
    device = _check_fused(n, layouts, cols, LO, HI, capacity, key, key_ok,
                          slot_ids, mask)
    if device.type == "cpu":
        return twolevel_fused_plain(n, layouts, cols, LO, HI, capacity,
                                    base, key, key_ok, slot_ids, mask)
    if device.type != "cuda":
        raise ValueError(f"twolevel runs on cuda or cpu, not {device}")
    return _fused_cuda(n, layouts, cols, LO, HI, capacity, base, key,
                       key_ok, slot_ids, mask, device)
