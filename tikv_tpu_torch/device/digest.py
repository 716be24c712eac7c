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
- ``feed_verify(planes, lo, hi)``: the digests of P planes of one feed
  over the same [lo, hi), as an int64 (P,) tensor, in one launch — the
  arrival check of a feed migrated between mesh slices (``install_feeds``,
  runner.py:2108-2166, which re-hashes plane by plane);
- ``patch_feed_rows(planes, pos, vals, digests=None)``: ``planes[p][pos[i]]
  = vals[p][i]`` in place for m unique positions of every plane of a feed
  in one launch; with ``digests`` (each plane's recorded digest) also the
  digests of the positions written, before and after (what
  ``_patch_plane``'s two range digests give for a span), and the recorded
  digest updated by R' = R − H(old) + H(new) in the same launch;
- ``patch_rows(plane, pos, vals, digest=False)``: its one-plane case;
- ``patch_feed_spans(planes, spans, vals, digests=None)``: the same write
  over K sorted, disjoint row spans [lo, hi) (the delta journal's form:
  ``copr.region_cache._merge_spans``) in one launch, each span carried as a
  16-byte descriptor (lo, len, prefix), never as positions; ``vals[p]`` is
  the concatenation of the spans' rows, and the digests are those of the
  global positions q = lo + i.

Each wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises.  ``digest_launches``,
``verify_launches``, ``patch_launches`` and ``span_launches`` count kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

# kernel launches since import (the chip smoke resets them around a run)
digest_launches = 0
verify_launches = 0
patch_launches = 0
span_launches = 0

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


# feed_verify's plane descriptor (address, 16-byte interior, width) and
# how many of them ride in the launch parameters; past that, a device table
_VERIFY_DESC_BYTES = 32
VERIFY_PARAM_PLANES = 96

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("digest")
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.plane_digest_launch.argtypes = [i, p, i, ll, ll, ll, p, p]
        lib.plane_digest_launch.restype = i
        lib.patch_feed_launch.argtypes = [i, p, i, i, i, i, p]
        lib.patch_feed_launch.restype = i
        lib.patch_args_size.argtypes = [i]
        lib.patch_args_size.restype = i
        for n in (0, *PATCH_INLINE):
            got = lib.patch_args_size(n)
            if got != 48 + (n or 16):
                raise RuntimeError(f"digest: the kernel's patch_args_size"
                                   f"({n}) is {got} bytes, the wrapper's "
                                   f"{48 + (n or 16)}")
        lib.feed_verify_describe.argtypes = [i, p, p, ll, ll, p]
        lib.feed_verify_describe.restype = i
        lib.feed_verify_launch.argtypes = [i, i, p, p, ll, ll, ll, p, p]
        lib.feed_verify_launch.restype = i
        for fn, want in (("feed_verify_desc_bytes", _VERIFY_DESC_BYTES),
                         ("feed_verify_param_planes", VERIFY_PARAM_PLANES),
                         ("patch_desc_bytes", _PATCH_DESC.size),
                         ("span_desc_bytes", _SPAN_DESC.size),
                         ("patch_rows_per_block", PATCH_ROWS)):
            getattr(lib, fn).restype = i
            if getattr(lib, fn)() != want:
                raise RuntimeError(f"digest: the kernel's {fn} is "
                                   f"{getattr(lib, fn)()}, the wrapper's "
                                   f"layout is {want}")
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


def feed_verify_plain(planes: Sequence[torch.Tensor], lo: int,
                      hi: int) -> torch.Tensor:
    """``plane_digest_plain`` of each plane over [lo, hi), stacked."""
    if not planes:
        return torch.zeros(0, dtype=torch.int64)
    return torch.stack([plane_digest_plain(a, lo, hi) for a in planes])


def feed_verify(planes: Sequence[torch.Tensor], lo: int,
                hi: int) -> torch.Tensor:
    """The digest of every plane of one feed (1-D, contiguous, one device,
    widths 1, 2, 4 or 8 bytes) over the same [lo, hi) → an int64 (P,)
    tensor on their device, not synchronized: one launch, each digest
    bit-equal to ``plane_digest``'s."""
    global verify_launches
    planes = list(planes)
    lo, hi = int(lo), int(hi)
    for a in planes:
        _check_plane(a, "plane")
        if not 0 <= lo <= hi <= a.shape[0]:
            raise ValueError(f"feed_verify: [{lo}, {hi}) is outside a plane "
                             f"of {a.shape[0]} rows")
    if not planes:
        return torch.zeros(0, dtype=torch.int64)
    dev = planes[0].device
    if any(a.device != dev for a in planes):
        raise ValueError("feed_verify: the planes lie on different devices")
    if dev.type == "cpu":
        return feed_verify_plain(planes, lo, hi)
    if dev.type != "cuda":
        raise ValueError(f"feed_verify runs on cuda or cpu, not {dev}")
    lib = _kernel_lib()
    P = len(planes)
    ptrs = (ctypes.c_void_p * P)(*[a.data_ptr() for a in planes])
    widths = (ctypes.c_int * P)(*[a.element_size() for a in planes])
    big = P > VERIFY_PARAM_PLANES
    descs = torch.empty(P * _VERIFY_DESC_BYTES, dtype=torch.uint8,
                        pin_memory=big)
    _raise_on(lib, lib.feed_verify_describe(P, ptrs, widths, lo, hi,
                                            descs.data_ptr()),
              "feed_verify describe")
    table = None
    if big:     # a stream-ordered copy from pinned memory: no host wait
        table = torch.empty_like(descs, device=dev)
        table.copy_(descs, non_blocking=True)
    out = torch.empty(P, dtype=torch.int64, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _raise_on(lib, lib.feed_verify_launch(
        _dev_index(dev), P, descs.data_ptr(),
        None if table is None else table.data_ptr(), lo, hi, 8 * sms,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "feed_verify launch")
    verify_launches += 1
    return out


# patch_feed_rows's layout (csrc/digest.cu): a plane descriptor, the
# parameter block's header, its inline payload classes (bytes), the rows a
# block takes and the most threads a block has
_PATCH_DESC = struct.Struct("<QQQQqii")
_PATCH_HEAD = struct.Struct("<QQqqqii")
PATCH_INLINE = (208, 976, 4048)
PATCH_ROWS = 1024
_PATCH_THREADS = 256


def _rec_tensor(r, device: torch.device) -> torch.Tensor:
    """A recorded digest (an int, or a 0-d int64 tensor of its bits) as a
    0-d int64 tensor on ``device``."""
    if isinstance(r, torch.Tensor):
        return r.reshape(()).to(device, torch.int64)
    u = int(r) & _U64
    return torch.tensor(u - (1 << 64) if u >> 63 else u, dtype=torch.int64,
                        device=device)


def patch_feed_rows_plain(planes: Sequence[torch.Tensor], pos: torch.Tensor,
                          vals: Sequence[torch.Tensor], digests=None):
    """``planes[p][pos] = vals[p]`` in place for each plane → None, or with
    ``digests`` (a recorded digest a plane) an int64 (P, 3) tensor: for
    each plane Σ old bits·(2q+1), Σ new bits·(2q+1) over the positions q
    written, and the recorded digest by the rule R − H(old) + H(new)."""
    rows = []
    w = _weights(pos)
    for p, (plane, v) in enumerate(zip(planes, vals)):
        if digests is not None:
            old = (_bits(plane[pos]) * w).sum()
            new = (_bits(v) * w).sum()
            rows.append(torch.stack([old, new, _rec_tensor(
                digests[p], plane.device) - old + new]))
        plane[pos] = v
    return None if digests is None else torch.stack(rows)


def patch_rows_plain(plane: torch.Tensor, pos: torch.Tensor,
                     vals: torch.Tensor, digest: bool = False):
    """``plane[pos] = vals`` in place → None, or with ``digest`` the 0-d
    int64 digests (Σ old bits·(2p+1), Σ new bits·(2p+1))."""
    out = patch_feed_rows_plain([plane], pos, [vals],
                                [0] if digest else None)
    return None if out is None else (out[0, 0], out[0, 1])


def _positions(pos, n: int) -> np.ndarray:
    """``pos`` as a host int64 array, after the checks: in [0, n) and
    unique."""
    host = pos.cpu().numpy() if isinstance(pos, torch.Tensor) \
        else np.asarray(pos)
    host = np.ascontiguousarray(host.reshape(-1), dtype=np.int64)
    if host.size and (host.min() < 0 or host.max() >= n):
        raise ValueError(f"patch: a position outside [0, {n})")
    if np.unique(host).size != host.size:
        raise ValueError("patch: duplicate positions (which write would "
                         "win is not defined)")
    return host


def _values(v, plane: torch.Tensor, m: int) -> torch.Tensor:
    """One plane's values in its dtype, flat: on the plane's card when
    they lie there already, else on the host."""
    if isinstance(v, torch.Tensor) and v.device == plane.device:
        t = v.to(plane.dtype)
    else:
        t = (v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))).detach().cpu().to(plane.dtype)
    t = t.contiguous().reshape(-1)
    if t.shape[0] != m:
        raise ValueError(f"patch: {m} positions, {t.shape[0]} values")
    return t


class PatchLayout(NamedTuple):
    """Where a patch launch keeps what it reads (``plan_patch``)."""

    size: int                   # the payload's bytes
    pos_off: int                # the positions' (or span descriptors') offset
    val_offs: list              # each plane's values offset (None: on card)
    scratch_off: int            # the several-blocks scratch (0: none)
    inline: Optional[int]       # the parameter class (None: on the card)
    grid_x: int                 # blocks a plane
    threads: int                # threads a block


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def plan_patch(widths: Sequence[int], m: int, host_vals: Sequence[bool],
               digest: bool, index_bytes: Optional[int] = None
               ) -> PatchLayout:
    """The layout of a patch of ``m`` rows of planes of ``widths`` bytes
    (``host_vals[p]``: plane p's values come in the payload), its rows
    named by ``index_bytes`` after the plane descriptors: m int64
    positions by default, a span patch's descriptors otherwise."""
    P = len(widths)
    pos_off = _PATCH_DESC.size * P
    end = pos_off + (8 * m if index_bytes is None else index_bytes)
    val_offs = []
    for w, host in zip(widths, host_vals):
        if host:
            end = _align16(end)
            val_offs.append(end)
            end += w * m
        else:
            val_offs.append(None)
    grid_x = max(1, -(-m // PATCH_ROWS))
    scratch_off = 0
    if digest and grid_x > 1:       # partial pairs, then the tickets
        scratch_off = _align16(end)
        end = scratch_off + 16 * P * grid_x + 4 * P
    size = _align16(end)
    inline = None if scratch_off else next(
        (n for n in PATCH_INLINE if size <= n), None)
    threads = min(_PATCH_THREADS, max(32, -(-min(m, PATCH_ROWS) // 32) * 32))
    return PatchLayout(size=size, pos_off=pos_off, val_offs=val_offs,
                       scratch_off=scratch_off, inline=inline,
                       grid_x=grid_x, threads=threads)


def _pack(lay: PatchLayout, planes, index: np.ndarray, m: int, n_spans: int,
          vals, recs, out_ptr: int, table_ptr: int) -> tuple:
    """The parameter block and payload of either form: the plane
    descriptors, ``index`` (the positions' or the span descriptors' bytes)
    at ``lay.pos_off``, the host values, and the header (``n_spans``: 0
    for the positions form)."""
    pay = np.zeros(lay.size, np.uint8)
    for p, (plane, v, (rec_ptr, rec), off) in enumerate(zip(
            planes, vals, recs, lay.val_offs)):
        _PATCH_DESC.pack_into(
            pay, _PATCH_DESC.size * p, plane.data_ptr(),
            v if off is None else 0, rec_ptr, rec & _U64,
            0 if off is None else off, plane.element_size(), 0)
        if off is not None:
            pay[off:off + v.nbytes] = v.view(np.uint8)
    pay[lay.pos_off:lay.pos_off + index.size] = index
    args = np.zeros(48 + (lay.inline or 16), np.uint8)
    _PATCH_HEAD.pack_into(args, 0, table_ptr, out_ptr, m, lay.pos_off,
                          lay.scratch_off, PATCH_ROWS, n_spans)
    if lay.inline is not None:
        args[48:48 + lay.size] = pay
    return args, pay


def pack_patch(lay: PatchLayout, planes, pos: np.ndarray, vals, recs,
               out_ptr: int, table_ptr: int = 0) -> tuple:
    """The launch's parameter block (the header, then the payload when it
    rides inline) and its payload, both uint8 arrays.  ``vals[p]``: a
    host array of plane p's values, or the address of its values on the
    card; ``recs[p]``: (the address of the recorded digest on the card or
    0, its value when the address is 0); ``table_ptr``: where the payload
    lies on the card when it does not ride inline."""
    return _pack(lay, planes, pos.view(np.uint8), pos.size, 0, vals, recs,
                 out_ptr, table_ptr)


def _launch(planes, m: int, vals, digests, plan, pack):
    """One ``patch_feed_launch`` of either form (its arguments checked): the
    recorded digests by value or by address, the payload inline or, past
    the parameter room, in one copy from pinned memory ordered on the
    launch stream → the (P, 3) digests or None.  ``plan(host_vals)`` gives
    the layout, ``pack(lay, vals, recs, out_ptr, table_ptr)`` the block."""
    dev = planes[0].device
    P = len(planes)
    on_card = [v.device == dev for v in vals]
    lay = plan([not c for c in on_card])
    out = torch.empty((P, 3), dtype=torch.int64, device=dev) \
        if digests is not None else None
    recs, keep = [], []
    for r in digests if digests is not None else [0] * P:
        if isinstance(r, torch.Tensor) and r.device == dev:
            keep.append(r.reshape(()).to(torch.int64))
            recs.append((keep[-1].data_ptr(), 0))
        else:
            recs.append((0, as_u64(r)))
    table = None if lay.inline is not None else \
        torch.empty(lay.size, dtype=torch.uint8, device=dev)
    args, pay = pack(lay, [v.data_ptr() if c else v.numpy()
                           for v, c in zip(vals, on_card)], recs,
                     0 if out is None else out.data_ptr(),
                     0 if table is None else table.data_ptr())
    if table is not None:
        table.copy_(torch.from_numpy(pay).pin_memory(), non_blocking=True)
    lib = _kernel_lib()
    _raise_on(lib, lib.patch_feed_launch(
        _dev_index(dev), args.ctypes.data, args.size, lay.grid_x, P,
        lay.threads, torch.cuda.current_stream(dev).cuda_stream),
        "patch launch")
    return out


def patch_feed_rows(planes: Sequence[torch.Tensor], pos, vals: Sequence,
                    digests: Optional[Sequence] = None
                    ) -> Optional[torch.Tensor]:
    """Write ``vals[p][i]`` at ``planes[p][pos[i]]`` in place for every
    plane of a feed that shares the positions (m unique positions, checked
    on the host once for all planes; raises on a duplicate or a position
    past the shortest plane) in one launch → None, or with ``digests``
    (each plane's recorded digest: an int, or a 0-d int64 tensor on the
    planes' card, such as the last patch's R') an int64 (P, 3) tensor on
    the planes' device: the digests of the positions written, of their
    old and of their new elements, and the recorded digest updated by
    R' = R − H(old) + H(new), never a re-hash of the plane.  Values lying
    on the planes' card are read there; others ride in the launch."""
    planes = list(planes)
    if not planes:
        raise ValueError("patch: no plane")
    for a in planes:
        _check_plane(a, "plane")
    dev = planes[0].device
    if any(a.device != dev for a in planes):
        raise ValueError("patch: the planes lie on different devices")
    pos = _positions(pos, min(a.shape[0] for a in planes))
    vals = list(vals)
    if len(vals) != len(planes) or (digests is not None and
                                    len(digests) != len(planes)):
        raise ValueError(f"patch: {len(planes)} planes, {len(vals)} value "
                         f"arrays" + ("" if digests is None else
                                      f", {len(digests)} digests"))
    vals = [_values(v, a, pos.size) for v, a in zip(vals, planes)]
    if dev.type == "cpu":
        return patch_feed_rows_plain(planes, torch.from_numpy(pos), vals,
                                     digests)
    if dev.type != "cuda":
        raise ValueError(f"patch runs on cuda or cpu, not {dev}")
    return _patch_cuda(planes, pos, vals, digests)


def _patch_cuda(planes, pos: np.ndarray, vals, digests):
    """The launch behind ``patch_feed_rows``, its arguments checked (``pos``
    on the host, each of ``vals`` on the planes' card or the host)."""
    global patch_launches
    m = int(pos.size)
    if m == 0 and digests is None:
        return None
    widths = [a.element_size() for a in planes]
    out = _launch(
        planes, m, vals, digests,
        lambda host_vals: plan_patch(widths, m, host_vals,
                                     digests is not None),
        lambda lay, v, recs, out_ptr, table_ptr: pack_patch(
            lay, planes, pos, v, recs, out_ptr, table_ptr))
    patch_launches += 1
    return out


def patch_rows(plane: torch.Tensor, pos: Union[Sequence[int], np.ndarray,
                                               torch.Tensor],
               vals, digest: bool = False) -> Optional[tuple]:
    """Write ``vals[i]`` at ``plane[pos[i]]`` in place for m unique
    positions (checked on the host; raises on a duplicate) in one launch
    → None, or with ``digest`` the 0-d int64 digests of the positions
    written, of their old and of their new elements: the one-plane case
    of ``patch_feed_rows``."""
    out = patch_feed_rows([plane], pos, [vals], [0] if digest else None)
    return None if out is None else (out[0, 0], out[0, 1])


# a span descriptor of patch_feed_spans (csrc/digest.cu SpanDesc): its first
# row, its rows, the rows of the spans before it
_SPAN_DESC = struct.Struct("<qii")


def _spans(spans, n: int) -> np.ndarray:
    """``spans`` as a host (K, 2) int64 array of [lo, hi), after the O(K)
    checks: each non-empty, sorted, disjoint and inside [0, n)."""
    arr = np.asarray(spans, dtype=np.int64)
    if arr.size == 0:
        return np.zeros((0, 2), np.int64)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"patch spans: want (lo, hi) pairs, got shape "
                         f"{arr.shape}")
    lo, hi = arr[:, 0], arr[:, 1]
    if bool(np.any(hi <= lo)):
        raise ValueError("patch spans: an empty or reversed span")
    if int(lo[0]) < 0 or int(hi[-1]) > n:
        raise ValueError(f"patch spans: a span outside [0, {n})")
    if bool(np.any(lo[1:] < hi[:-1])):
        raise ValueError("patch spans: spans must be sorted and disjoint")
    return np.ascontiguousarray(arr)


def span_positions(spans) -> np.ndarray:
    """The rows the spans cover, in order (the plain version's
    positions)."""
    spans = np.asarray(spans, dtype=np.int64).reshape(-1, 2)
    if not len(spans):
        return np.zeros(0, np.int64)
    return np.concatenate([np.arange(lo, hi, dtype=np.int64)
                           for lo, hi in spans.tolist()])


def patch_feed_spans_plain(planes: Sequence[torch.Tensor], spans,
                           vals: Sequence[torch.Tensor], digests=None):
    """``planes[p][lo:hi] = `` the span's rows of ``vals[p]`` for each span,
    in place → None, or with ``digests`` the int64 (P, 3) tensor of
    ``patch_feed_rows_plain`` over the positions the spans cover."""
    pos = torch.from_numpy(span_positions(spans))
    if planes:
        pos = pos.to(planes[0].device)
    return patch_feed_rows_plain(planes, pos, vals, digests)


def plan_spans(widths: Sequence[int], k: int, m: int,
               host_vals: Sequence[bool], digest: bool) -> PatchLayout:
    """The layout of a patch of ``k`` spans of ``m`` rows in all
    (``plan_patch``'s, the 16-byte span descriptors at ``pos_off``)."""
    return plan_patch(widths, m, host_vals, digest,
                      index_bytes=_SPAN_DESC.size * k)


def pack_spans(lay: PatchLayout, planes, spans: np.ndarray, vals, recs,
               out_ptr: int, table_ptr: int = 0) -> tuple:
    """The span launch's parameter block and payload (``pack_patch``'s
    contract, with ``spans`` a (K, 2) array of [lo, hi) in place of the
    positions): a descriptor (lo, len, prefix) a span."""
    desc = np.zeros(_SPAN_DESC.size * len(spans), np.uint8)
    m = 0
    for k, (lo, hi) in enumerate(spans.tolist()):
        _SPAN_DESC.pack_into(desc, _SPAN_DESC.size * k, lo, hi - lo, m)
        m += hi - lo
    return _pack(lay, planes, desc, m, len(spans), vals, recs, out_ptr,
                 table_ptr)


def patch_feed_spans(planes: Sequence[torch.Tensor], spans, vals: Sequence,
                     digests: Optional[Sequence] = None
                     ) -> Optional[torch.Tensor]:
    """Write each span's rows of ``vals[p]`` over ``planes[p][lo:hi]`` in
    place, for K sorted, disjoint, non-empty spans [lo, hi) inside the
    shortest plane (checked on the host in O(K)), every plane in one
    launch → None, or with ``digests`` (each plane's recorded digest: an
    int, or a 0-d int64 tensor on the planes' card) the int64 (P, 3)
    tensor of ``patch_feed_rows``: H(old) and H(new) over the rows written,
    at their global positions, and R' = R − H(old) + H(new).  ``vals[p]``
    is the spans' rows end to end; values lying on the planes' card are
    read there, others ride in the launch (or its one pinned copy).  A
    launch error raises."""
    planes = list(planes)
    if not planes:
        raise ValueError("patch: no plane")
    for a in planes:
        _check_plane(a, "plane")
    dev = planes[0].device
    if any(a.device != dev for a in planes):
        raise ValueError("patch: the planes lie on different devices")
    spans = _spans(spans, min(a.shape[0] for a in planes))
    m = int((spans[:, 1] - spans[:, 0]).sum())
    if m >= 1 << 31:
        raise ValueError(f"patch spans: {m} rows, past a span patch's 2^31")
    vals = list(vals)
    if len(vals) != len(planes) or (digests is not None and
                                    len(digests) != len(planes)):
        raise ValueError(f"patch: {len(planes)} planes, {len(vals)} value "
                         f"arrays" + ("" if digests is None else
                                      f", {len(digests)} digests"))
    vals = [_values(v, a, m) for v, a in zip(vals, planes)]
    if dev.type == "cpu":
        return patch_feed_spans_plain(planes, spans, vals, digests)
    if dev.type != "cuda":
        raise ValueError(f"patch runs on cuda or cpu, not {dev}")
    return _spans_cuda(planes, spans, m, vals, digests)


def _spans_cuda(planes, spans: np.ndarray, m: int, vals, digests):
    """The launch behind ``patch_feed_spans``, its arguments checked."""
    global span_launches
    if m == 0 and digests is None:
        return None
    widths = [a.element_size() for a in planes]
    out = _launch(
        planes, m, vals, digests,
        lambda host_vals: plan_spans(widths, len(spans), m, host_vals,
                                     digests is not None),
        lambda lay, v, recs, out_ptr, table_ptr: pack_spans(
            lay, planes, spans, v, recs, out_ptr, table_ptr))
    span_launches += 1
    return out
