"""Window functions over a sorted view: the wrapper and plain PyTorch
version of the CUDA kernel ``csrc/window.cu``.

Counterpart of the scan half of the JAX package's ``device/join.py``
``window`` (:508); its sort is ``sort.sort_perm``.  ``window_scan(perm,
part_keys, rn, channels, shifts)`` reads n source rows in the order
``perm`` (int32[n]):

- ``part_keys``: the partition keys (int64 or float64[n], source order);
  a view row is a partition head when it is row 0 or a key differs from
  the row before;
- ``rn``: whether to return row_number (int64[n]);
- ``channels``: (kind, values, ok) with kind ``"count"`` (the running
  count of ok rows; values None) or ``"sum"`` (the running int64 sum of
  ok ? values : 0) → int64[n] each, from the segment's head;
- ``shifts``: (offset, values, ok): LAG for a negative offset, LEAD for a
  positive one, over int64 or float64 values → (values[n] of the values'
  dtype, bool[n]): the argument of view row i + offset when it lies in the
  same segment and is not NULL, else 0 and False.

Returns (rn or None, [channel outputs], [(values, valid)]), in view
order.  On the card each distinct argument (``plan_args``: a values column
and its validity, a COUNT over the same validity riding with it) is
gathered through ``perm`` once a row; a shift within ``CAP`` rows reads a
tile's halo, a longer one takes a second pass.  The wrapper takes the
plain version only for tensors on the CPU; on a CUDA tensor it launches
its kernel or raises.  ``launches`` counts wrapper calls that launched
the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .build import check_vector, load_checked, raise_on

# kernel launches since import (the chip smoke resets them around a run)
launches = 0

TILE = 1280         # csrc/window.cu TILE: rows of a tile
CAP = 64            # the largest |offset| a tile's halo serves
MAX_PART, MAX_CH, MAX_SH = 8, 16, 16
MAX_ARG = MAX_CH + MAX_SH
_PART_DTYPES = (torch.int64, torch.float64)


def _ident(t):
    return None if t is None else (t.data_ptr(), t.dtype)


def plan_args(channels, shifts) -> dict:
    """What the kernel gathers: ``args``, the distinct (values | None,
    ok) pairs (a sum's or a shift's; a COUNT joins a pair with its
    validity, else takes its own); ``ch_arg`` / ``sh_arg``, each channel's
    and shift's pair; ``lag_halo`` / ``lead_halo``, the largest LAG / LEAD
    offset within ``CAP`` (0: none); ``far``, the pairs a shift past
    ``CAP`` reads."""
    args, index = [], {}

    def arg_of(v, ok) -> int:
        key = (_ident(v), _ident(ok))
        if key not in index:
            index[key] = len(args)
            args.append((v, ok))
        return index[key]

    sh_arg = [arg_of(v, ok) for _off, v, ok in shifts]
    ch_arg = [arg_of(v, ok) if kind == "sum" else None
              for kind, v, ok in channels]
    for j, (kind, _v, ok) in enumerate(channels):
        if kind == "count":
            ch_arg[j] = next((i for i, (_av, aok) in enumerate(args)
                              if _ident(aok) == _ident(ok)), None)
            if ch_arg[j] is None:
                ch_arg[j] = arg_of(None, ok)
    near = [off for off, _v, _ok in shifts if abs(off) <= CAP]
    return {"args": args, "ch_arg": ch_arg, "sh_arg": sh_arg,
            "lag_halo": max([-o for o in near if o < 0], default=0),
            "lead_halo": max([o for o in near if o > 0], default=0),
            "far": sorted({a for (off, _v, _ok), a in zip(shifts, sh_arg)
                           if abs(off) > CAP})}


def _heads(perm: torch.Tensor, part_keys, n: int) -> torch.Tensor:
    head = torch.zeros(n, dtype=torch.bool, device=perm.device)
    if n:
        head[0] = True
    p = perm.to(torch.int64)
    for k in part_keys:
        s = k[p]
        head[1:] |= s[1:] != s[:-1]
    return head


def _seg_running(vals: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    cs = torch.cumsum(vals, 0)
    return cs - (cs[seg_start] - vals[seg_start])


def window_scan_plain(perm, part_keys, rn: bool, channels, shifts) -> tuple:
    n = perm.shape[0]
    dev = perm.device
    p = perm.to(torch.int64)
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    head = _heads(perm, part_keys, n)
    seg_start = torch.cummax(torch.where(head, iota, torch.zeros_like(iota)),
                             0).values if n else iota
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    outs = []
    for kind, v, ok in channels:
        okp = ok[p]
        x = okp.to(torch.int64) if kind == "count" else \
            torch.where(okp, v[p], zero)
        outs.append(_seg_running(x, seg_start) if n else x)
    shifted = []
    for off, v, ok in shifts:
        src = iota + off
        inb = (src >= 0) & (src < n)
        safe = src.clamp(0, max(0, n - 1))
        same = (src >= seg_start) if off < 0 else (seg_start[safe] <= iota)
        valid = inb & same
        if n:
            valid &= ok[p[safe]]
        vals = torch.where(valid, v[p[safe]] if n else v,
                           torch.zeros((), dtype=v.dtype, device=dev))
        shifted.append((vals, valid))
    return (iota - seg_start + 1 if rn else None), outs, shifted


class _WindowParams(ctypes.Structure):
    """``struct WindowParams`` of csrc/window.cu."""
    _p = ctypes.c_void_p
    _i = ctypes.c_int
    _fields_ = [("n", ctypes.c_longlong), ("perm", _p), ("n_part", _i),
                ("part", _p * MAX_PART), ("part_f64", _i * MAX_PART),
                ("rn", _p), ("n_arg", _i), ("arg_v", _p * MAX_ARG),
                ("arg_ok", _p * MAX_ARG), ("arg_vcopy", _p * MAX_ARG),
                ("arg_okcopy", _p * MAX_ARG), ("n_ch", _i),
                ("ch_kind", _i * MAX_CH), ("ch_arg", _i * MAX_CH),
                ("ch_out", _p * MAX_CH), ("n_sh", _i),
                ("sh_off", _i * MAX_SH), ("sh_arg", _i * MAX_SH),
                ("sh_out", _p * MAX_SH), ("sh_valid", _p * MAX_SH),
                ("lag_halo", _i), ("lead_halo", _i), ("seg_start", _p),
                ("flags", _p), ("agg", _p), ("incl", _p), ("n_tiles", _i)]


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = load_checked("window", {
            "window_params_bytes": ctypes.sizeof(_WindowParams),
            "window_tile_rows": TILE, "window_halo_cap": CAP},
            "window_error_string")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.window_scan_launch.argtypes = [i, ctypes.POINTER(_WindowParams),
                                           p]
        lib.window_scan_launch.restype = i
        _lib = lib
    return _lib


def window_scan(perm: torch.Tensor, part_keys: Sequence[torch.Tensor],
                rn: bool, channels: Sequence[tuple],
                shifts: Sequence[tuple]) -> tuple:
    """The window outputs of the view ``perm`` (see the module)."""
    global launches
    n = perm.shape[0] if perm.dim() == 1 else -1
    if not 0 <= n < 1 << 31:
        raise ValueError(f"window_scan serves 0 <= n < 2^31 rows, got {n}")
    if len(part_keys) > MAX_PART or len(channels) > MAX_CH or \
            len(shifts) > MAX_SH:
        raise ValueError(f"window_scan takes at most {MAX_PART} partition "
                         f"keys, {MAX_CH} channels and {MAX_SH} shifts")
    dev = perm.device
    check_vector(perm, "perm", n, dev, (torch.int32,))
    for j, k in enumerate(part_keys):
        check_vector(k, f"partition key {j}", n, dev, _PART_DTYPES)
    for j, (kind, v, ok) in enumerate(channels):
        if kind not in ("count", "sum"):
            raise ValueError(f"channel {j}: unknown kind {kind!r}")
        if kind == "sum":
            check_vector(v, f"channel {j} values", n, dev, (torch.int64,))
        check_vector(ok, f"channel {j} ok", n, dev, (torch.bool,))
    for j, (off, v, ok) in enumerate(shifts):
        if off == 0 or abs(off) >= 1 << 31:
            raise ValueError(f"shift {j}: offset {off}")
        check_vector(v, f"shift {j} values", n, dev, _PART_DTYPES)
        check_vector(ok, f"shift {j} ok", n, dev, (torch.bool,))
    if dev.type == "cpu":
        return window_scan_plain(perm, part_keys, rn, channels, shifts)
    if dev.type != "cuda":
        raise ValueError(f"window_scan runs on cuda or cpu, not {dev}")
    rn_out = torch.empty(n, dtype=torch.int64, device=dev) if rn else None
    ch_out = [torch.empty(n, dtype=torch.int64, device=dev)
              for _ in channels]
    sh_out = [(torch.empty(n, dtype=v.dtype, device=dev),
               torch.empty(n, dtype=torch.bool, device=dev))
              for _off, v, _ok in shifts]
    if n == 0:
        return rn_out, ch_out, sh_out
    lib = _kernel_lib()
    n_tiles = -(-n // TILE)
    plan = plan_args(channels, shifts)
    words = n_tiles * (1 + len(channels))
    flags = torch.empty(n_tiles + 1, dtype=torch.int32, device=dev)
    carry = torch.empty(2 * max(1, words), dtype=torch.int64, device=dev)
    far = plan["far"]
    seg_start = torch.empty(n, dtype=torch.int32, device=dev) \
        if far else None
    copies = {a: (torch.empty(n, dtype=torch.int64, device=dev),
                  torch.empty(n, dtype=torch.uint8, device=dev))
              for a in far}
    p = _WindowParams(n=n, perm=perm.data_ptr(), n_part=len(part_keys),
                      rn=None if rn_out is None else rn_out.data_ptr(),
                      n_arg=len(plan["args"]), n_ch=len(channels),
                      n_sh=len(shifts), lag_halo=plan["lag_halo"],
                      lead_halo=plan["lead_halo"],
                      seg_start=None if seg_start is None
                      else seg_start.data_ptr(),
                      flags=flags.data_ptr(), agg=carry.data_ptr(),
                      incl=carry[words:].data_ptr(), n_tiles=n_tiles)
    for j, k in enumerate(part_keys):
        p.part[j] = k.data_ptr()
        p.part_f64[j] = int(k.dtype == torch.float64)
    for j, (v, ok) in enumerate(plan["args"]):
        p.arg_v[j] = None if v is None else v.data_ptr()
        p.arg_ok[j] = ok.data_ptr()
        if j in copies:
            p.arg_vcopy[j] = copies[j][0].data_ptr()
            p.arg_okcopy[j] = copies[j][1].data_ptr()
    for j, ((kind, _v, _ok), out) in enumerate(zip(channels, ch_out)):
        p.ch_kind[j] = 0 if kind == "count" else 1
        p.ch_arg[j] = plan["ch_arg"][j]
        p.ch_out[j] = out.data_ptr()
    for j, ((off, _v, _ok), (vals, valid)) in enumerate(zip(shifts, sh_out)):
        p.sh_off[j] = int(off)
        p.sh_arg[j] = plan["sh_arg"][j]
        p.sh_out[j] = vals.data_ptr()
        p.sh_valid[j] = valid.data_ptr()
    raise_on(lib, "window_error_string", lib.window_scan_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream),
        "window_scan launch")
    launches += 1
    return rn_out, ch_out, sh_out
