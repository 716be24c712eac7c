"""The cross-shard merges of a row-sharded feed: the wrappers and plain
PyTorch versions of the CUDA kernels ``csrc/shard_merge.cu``.

Counterparts of the JAX package's collectives in ``device/runner.py``:
``_pallas_sharded_wrap`` (:3930; the psum of the fused kernel's packed
partials) and ``_finalize_psum_summed`` (:2599; the psum of every summed
state leaf) become ``shard_psum``; ``_finalize_hash_bucket_merge`` (:2606;
the all-to-all by key bucket and the MIN/MAX reduce of each (S, slots_m/S)
pile) becomes ``shard_bucket_merge``; ``shard_merge`` takes both kinds of
segment in one launch.  The runner drives the mesh from one process and
has every shard's buffer on the first card for the psum already, so it
reduces the whole (S, slots) pile there in the same launch as the psum:
the reference's all-to-all, which spreads the reduce over chips, would
only add copies.

The kernels read S sources of int64 words (float64 values by their bits)
over a list of segments ``(first word, words, op)``, the same offsets in
every source and in the output, and write the output's words of those
segments (the rest are left as they were).  Per op:

- ``"sum_i64"``, ``"sum_f64"``: ``out[w] = part_0[w] + part_1[w] + … +
  part_{S-1}[w]`` in shard order, int64 with wraparound or float64:
  deterministic, bit-equal to the plain version;
- ``"min_i64"``, ``"max_i64"``, ``"min_f64"``, ``"max_f64"``: ``out[w]`` =
  min or max over the sources.  A NaN propagates, as
  ``torch.amin``/``torch.amax`` and ``jnp.min`` do (the first NaN in shard
  order, bits kept); among equal values, +0.0 and -0.0, the first in shard
  order is kept.

``shard_psum`` takes sum segments only, ``shard_bucket_merge`` min/max
segments only, ``shard_merge`` any mix.  On CUDA tensors each is one
launch of up to ``MAX_SRC`` sources over up to ``MAX_Y`` segments, all on
one device: segments that are all sums take the psum's kernel, any other
list the merge kernel, which picks each block's op before its word loop;
on CPU tensors the plain version.  A launch's parameter block is sized to
the request: the S source pointers and up to ``INLINE_SEGS`` segments
inline, more segments in a table copied to the card on the launch stream.
The packed block of each layout (the device, S, the 16-byte phase and the
segments with their ops) is cached (``plan_layout``), so a plan's repeated
requests only bind their pointers (``bind``).  The launch is programmatic:
it may overlap the drain of the kernel before it on the stream
(``csrc/shard_merge.cu``).  ``psum_launches`` counts the launches of the
psum's kernel, ``merge_launches`` those of the merge kernel (a launch that
carries a min/max segment), and nothing else.  The runner's mesh path
(``DeviceRunner(mesh=...)``) copies each shard's partial to the mesh's
first card (``Tensor.to``: nothing on one card) before calling these.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence

import torch

MAX_SRC = 32            # sources of one launch (csrc/shard_merge.cu)
INLINE_SEGS = 8         # segments in a launch's parameters; more: a table
MAX_Y = 65535           # segments of one launch (its grid's y)
_OPS = {"sum_i64": 0, "sum_f64": 1, "min_i64": 2, "max_i64": 3,
        "min_f64": 4, "max_f64": 5}
_SUM_OPS = ("sum_i64", "sum_f64")

# kernel launches since import (the chip smoke resets them around a run)
psum_launches = 0
merge_launches = 0


def _words(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _check(parts: Sequence[torch.Tensor], segments, kind: str) -> None:
    """``kind``: "psum" (sum segments only), "bucket" (min/max segments
    only) or "merge" (any mix)."""
    if not parts:
        raise ValueError("no source")
    if len(parts) > MAX_SRC:
        raise ValueError(f"{len(parts)} sources > {MAX_SRC}")
    w, dev, dt = parts[0].numel(), parts[0].device, parts[0].dtype
    for p in parts:
        if p.dtype not in (torch.int64, torch.float64) or p.dtype != dt:
            raise ValueError(f"sources must be one of int64 / float64, got "
                             f"{[str(q.dtype) for q in parts]}")
        if p.device != dev:
            raise ValueError(f"sources on {p.device} and {dev}: copy them "
                             f"to one device first")
        if p.dim() != 1 or not p.is_contiguous() or p.numel() != w:
            raise ValueError("sources must be contiguous 1-D tensors of one "
                             "length")
    for off, n, op in segments:
        if op not in _OPS or (kind != "merge" and
                              (op in _SUM_OPS) != (kind == "psum")):
            raise ValueError(f"op {op!r} in a {kind}")
        if off < 0 or n < 0 or off + n > w:
            raise ValueError(f"segment ({off}, {n}) outside {w} words")
    if len(segments) > MAX_Y:
        raise ValueError(f"{len(segments)} segments > {MAX_Y}")


def _default_segments(parts) -> list:
    if not parts:
        return []
    w = parts[0].numel()
    return [(0, w, "sum_f64" if parts[0].dtype == torch.float64
             else "sum_i64")]


def _merge_plain(parts, segments, out) -> torch.Tensor:
    """Each segment's op in shard order: a sum ``acc = acc + part_s``; a
    min / max where a value replaces the running one when it is NaN or
    strictly better and the running one is not NaN."""
    out = torch.empty_like(parts[0]) if out is None else out
    ow = _words(out)
    for off, n, op in segments:
        ints = op.endswith("_i64")
        view = (lambda t: _words(t)[off:off + n]) if ints else \
            (lambda t: _words(t)[off:off + n].view(torch.float64))
        acc = view(parts[0]).clone()
        for p in parts[1:]:
            v = view(p)
            if op in _SUM_OPS:
                acc = acc + v
                continue
            better = v < acc if op.startswith("min") else v > acc
            if not ints:
                better = ~torch.isnan(acc) & (torch.isnan(v) | better)
            acc = torch.where(better, v, acc)
        ow[off:off + n] = acc if ints else _words(acc)
    return out


def shard_psum_plain(parts: Sequence[torch.Tensor], segments=None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc = acc + part_s`` in shard order over each segment."""
    segments = _default_segments(parts) if segments is None else segments
    _check(parts, segments, "psum")
    return _merge_plain(parts, segments, out)


def shard_bucket_merge_plain(parts: Sequence[torch.Tensor], segments,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Min / max in shard order over each segment: a value replaces the
    running one when it is NaN or strictly better and the running one is
    not NaN."""
    _check(parts, segments, "bucket")
    return _merge_plain(parts, segments, out)


def shard_merge_plain(parts: Sequence[torch.Tensor], segments,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each segment's op as ``shard_psum_plain`` or
    ``shard_bucket_merge_plain`` applies it."""
    _check(parts, segments, "merge")
    return _merge_plain(parts, segments, out)


class _Seg(ctypes.Structure):
    """``struct Seg`` of csrc/shard_merge.cu."""

    _fields_ = [("off", ctypes.c_longlong), ("len", ctypes.c_longlong),
                ("op", ctypes.c_int), ("pad", ctypes.c_int)]


_ARGS_TYPES: dict = {}


def source_class(S: int) -> int:
    """The kernel instance that takes S sources: 2, 4 or 8, else 0 (the
    general path)."""
    return S if S in (2, 4, 8) else 0


def _args_type(sc: int):
    """``struct MergeArgs<sc>`` of csrc/shard_merge.cu: the S source
    pointers (MAX_SRC slots on the general path), the output, the device
    table of segments (null: up to INLINE_SEGS ride inline), n_segs, vec
    and n_src (S)."""
    if sc not in _ARGS_TYPES:
        _ARGS_TYPES[sc] = type(f"MergeArgs{sc}", (ctypes.Structure,), {
            "_fields_": [("src", ctypes.c_void_p * (sc or MAX_SRC)),
                         ("out", ctypes.c_void_p),
                         ("table", ctypes.c_void_p),
                         ("seg", _Seg * INLINE_SEGS),
                         ("n_segs", ctypes.c_int), ("vec", ctypes.c_int),
                         ("n_src", ctypes.c_int), ("pad", ctypes.c_int)]})
    return _ARGS_TYPES[sc]


class Layout(NamedTuple):
    """One merge launch, packed once for a (device, S, 16-byte phase,
    segments) request and reused by every request of that layout."""

    sc: int                     # the kernel instance (source_class)
    args: ctypes.Structure      # MergeArgs<sc>, its pointers set by bind
    grid_x: int
    n_y: int                    # segments: the grid's y
    table_host: Optional[torch.Tensor]  # past INLINE_SEGS: the segments
    #                             (pinned on a card), copied per call


def plan_layout(S: int, segments, vec: bool, sms: int,
                pin: bool = False) -> Layout:
    """The launch of a merge of S sources over ``segments`` (checked by
    the caller) on a card of ``sms`` SMs: up to INLINE_SEGS segments in
    its parameters, more in a table."""
    sc = source_class(S)
    a = _args_type(sc)()
    a.n_segs, a.vec, a.n_src = len(segments), int(vec), S
    rows, table = a.seg, None
    if len(segments) > INLINE_SEGS:
        table = torch.empty(len(segments) * ctypes.sizeof(_Seg),
                            dtype=torch.uint8, pin_memory=pin)
        rows = (_Seg * len(segments)).from_address(table.data_ptr())
    for i, (off, n, op) in enumerate(segments):
        rows[i] = _Seg(off, n, _OPS[op], 0)
    units = max(n for _o, n, _op in segments)
    units = -(-units // 2) if vec else units
    grid_x = max(1, min(-(-units // _THREADS),
                        max(1, 8 * sms // len(segments))))
    return Layout(sc, a, grid_x, len(segments), table)


def bind(lay: Layout, parts, out, table: Optional[torch.Tensor] = None):
    """The layout's parameter block with this call's pointers: the
    sources, the output and the device copy of its segment table."""
    a = lay.args
    for s, t in enumerate(parts):
        a.src[s] = t.data_ptr()
    a.out = out.data_ptr()
    a.table = None if table is None else table.data_ptr()
    return a


_lib = None
_THREADS = 256
_SMS: dict = {}
_LAYOUTS: dict = {}
_LAYOUTS_MAX = 256      # layouts kept; the cache starts over past it
_MU = threading.Lock()  # one call at a time binds a cached block


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load_checked
        layout = {"shard_seg_size": ctypes.sizeof(_Seg),
                  "shard_inline_segs": INLINE_SEGS,
                  "shard_threads": _THREADS}
        lib = load_checked("shard_merge", layout, "shard_error_string")
        lib.shard_args_size.argtypes = [ctypes.c_int]
        lib.shard_args_size.restype = ctypes.c_int
        for sc in (0, 2, 4, 8):
            if lib.shard_args_size(sc) != ctypes.sizeof(_args_type(sc)):
                raise RuntimeError(
                    f"shard_merge: the kernel's MergeArgs<{sc}> is "
                    f"{lib.shard_args_size(sc)} bytes, the wrapper's "
                    f"{ctypes.sizeof(_args_type(sc))}")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.shard_merge_launch.argtypes = [i, i, i, p, i, i, i, i, p]
        lib.shard_merge_launch.restype = i
        _lib = lib
    return _lib


def _sms(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _layout(dev, parts, segments, out) -> Layout:
    """The cached layout of this request (its segments, source count and
    16-byte phase) on ``dev``."""
    # every source and the output in one 16-byte phase: two words a thread
    vec = len({t.data_ptr() & 15 for t in (*parts, out)}) == 1
    key = (dev.index, len(parts), vec, tuple(map(tuple, segments)))
    lay = _LAYOUTS.get(key)
    if lay is None:
        if len(_LAYOUTS) >= _LAYOUTS_MAX:
            _LAYOUTS.clear()
        lay = _LAYOUTS[key] = plan_layout(len(parts), segments, vec,
                                          _sms(dev), dev.type == "cuda")
    return lay


def _launch(parts, segments, out, sums: bool,
            dependent: bool = True) -> None:
    """The launch of one merge: the psum's kernel (``sums``: every segment
    a sum) or the merge kernel (any mix); ``dependent``: programmatic
    (only the chip smoke's chain measurement launches without it)."""
    global psum_launches, merge_launches
    from .build import raise_on
    lib = _kernel_lib()
    dev = parts[0].device
    lay = _layout(dev, parts, segments, out)
    table = None
    if lay.table_host is not None:      # stream-ordered, from pinned memory
        table = torch.empty_like(lay.table_host, device=dev)
        table.copy_(lay.table_host, non_blocking=True)
    with _MU:
        a = bind(lay, parts, out, table)
        err = lib.shard_merge_launch(
            dev.index, int(sums), lay.sc, ctypes.byref(a), ctypes.sizeof(a),
            lay.grid_x, lay.n_y, int(dependent),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "shard_error_string", err,
             "shard_psum launch" if sums else "shard_merge launch")
    if sums:
        psum_launches += 1
    else:
        merge_launches += 1


def _run(parts, segments, out, kind: str, plain) -> torch.Tensor:
    parts = list(parts)
    _check(parts, segments, kind)
    dev = parts[0].device
    if out is not None and (out.device != dev or out.dtype != parts[0].dtype
                            or out.numel() != parts[0].numel() or
                            not out.is_contiguous()):
        raise ValueError("out must match the sources")
    if dev.type == "cpu":
        return plain(parts, segments, out)
    if dev.type != "cuda":
        raise ValueError(f"the shard merges run on cuda or cpu, not {dev}")
    out = torch.empty_like(parts[0]) if out is None else out
    if segments:
        _launch(parts, segments, out,
                all(op in _SUM_OPS for _o, _n, op in segments))
    return out


def shard_psum(parts: Sequence[torch.Tensor], segments=None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sum of ``parts`` (S tensors of W words, int64 or float64, on one
    device) over ``segments`` (default: every word, by the parts' dtype)
    → ``out`` (a new tensor when None), not synchronized."""
    segments = _default_segments(parts) if segments is None else segments
    return _run(parts, segments, out, "psum", shard_psum_plain)


def shard_bucket_merge(parts: Sequence[torch.Tensor], segments,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The min / max of ``parts`` over ``segments`` → ``out``, not
    synchronized."""
    return _run(parts, segments, out, "bucket", shard_bucket_merge_plain)


def shard_merge(parts: Sequence[torch.Tensor], segments,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum and min / max segments of ``parts`` together → ``out``, in one
    launch, not synchronized: a sum segment as ``shard_psum`` merges it, a
    min / max one as ``shard_bucket_merge`` does."""
    return _run(parts, segments, out, "merge", shard_merge_plain)
