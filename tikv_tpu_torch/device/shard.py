"""The cross-shard merges of a row-sharded feed: the wrappers and plain
PyTorch versions of the CUDA kernels ``csrc/shard_merge.cu``.

Counterparts of the JAX package's collectives in ``device/runner.py``:
``_pallas_sharded_wrap`` (:3930; the psum of the fused kernel's packed
partials) and ``_finalize_psum_summed`` (:2599; the psum of every summed
state leaf) become ``shard_psum``; ``_finalize_hash_bucket_merge`` (:2606;
the all-to-all by key bucket and the MIN/MAX reduce of each (S, slots_m/S)
pile) becomes ``shard_bucket_merge``.  The runner drives the mesh from one
process and has every shard's buffer on the first card for the psum
already, so it reduces the whole (S, slots) pile there in one launch: the
reference's all-to-all, which spreads the reduce over chips, would only
add copies.

Both kernels read S sources of int64 words (float64 values by their bits)
over a list of segments ``(first word, words, op)``, the same offsets in
every source and in the output, and write the output's words of those
segments (the rest are left as they were):

- ``shard_psum``: ``out[w] = part_0[w] + part_1[w] + … + part_{S-1}[w]`` in
  shard order, int64 with wraparound (op ``"sum_i64"``) or float64
  (``"sum_f64"``): deterministic, bit-equal to ``shard_psum_plain``;
- ``shard_bucket_merge``: ``out[w]`` = min or max over the sources
  (``"min_i64"``, ``"max_i64"``, ``"min_f64"``, ``"max_f64"``).  A NaN
  propagates, as ``torch.amin``/``torch.amax`` and ``jnp.min`` do (the
  first NaN in shard order, bits kept); among equal values, +0.0 and -0.0,
  the first in shard order is kept.

On CUDA tensors each is one launch for up to ``MAX_SEGS`` segments (more
take more launches) and up to ``MAX_SRC`` sources, all on one device; on
CPU tensors the plain version.  ``psum_launches`` and ``merge_launches``
count kernel launches and nothing else.  The runner's mesh path
(``DeviceRunner(mesh=...)``) copies each shard's partial to the mesh's
first card (``Tensor.to``: nothing on one card) before calling these.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

MAX_SRC = 32            # sources of one launch (csrc/shard_merge.cu)
MAX_SEGS = 80           # segments of one launch
_OPS = {"sum_i64": 0, "sum_f64": 1, "min_i64": 2, "max_i64": 3,
        "min_f64": 4, "max_f64": 5}
_SUM_OPS = ("sum_i64", "sum_f64")

# kernel launches since import (the chip smoke resets them around a run)
psum_launches = 0
merge_launches = 0


def _words(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _check(parts: Sequence[torch.Tensor], segments, sums: bool) -> None:
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
        if op not in _OPS or (op in _SUM_OPS) != sums:
            raise ValueError(f"op {op!r} in a {'psum' if sums else 'merge'}")
        if off < 0 or n < 0 or off + n > w:
            raise ValueError(f"segment ({off}, {n}) outside {w} words")


def _default_segments(parts) -> list:
    if not parts:
        return []
    w = parts[0].numel()
    return [(0, w, "sum_f64" if parts[0].dtype == torch.float64
             else "sum_i64")]


def shard_psum_plain(parts: Sequence[torch.Tensor], segments=None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc = acc + part_s`` in shard order over each segment."""
    segments = _default_segments(parts) if segments is None else segments
    _check(parts, segments, True)
    out = torch.empty_like(parts[0]) if out is None else out
    ow = _words(out)
    for off, n, op in segments:
        view = (lambda t: _words(t)[off:off + n].view(torch.float64)) \
            if op == "sum_f64" else (lambda t: _words(t)[off:off + n])
        acc = view(parts[0]).clone()
        for p in parts[1:]:
            acc = acc + view(p)
        ow[off:off + n] = _words(acc) if op == "sum_f64" else acc
    return out


def shard_bucket_merge_plain(parts: Sequence[torch.Tensor], segments,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Min / max in shard order over each segment: a value replaces the
    running one when it is NaN or strictly better and the running one is
    not NaN."""
    _check(parts, segments, False)
    out = torch.empty_like(parts[0]) if out is None else out
    ow = _words(out)
    for off, n, op in segments:
        ints = op.endswith("_i64")
        view = (lambda t: _words(t)[off:off + n]) if ints else \
            (lambda t: _words(t)[off:off + n].view(torch.float64))
        acc = view(parts[0]).clone()
        for p in parts[1:]:
            v = view(p)
            better = v < acc if op.startswith("min") else v > acc
            if not ints:
                better = ~torch.isnan(acc) & (torch.isnan(v) | better)
            acc = torch.where(better, v, acc)
        ow[off:off + n] = acc if ints else _words(acc)
    return out


class _MergeParams(ctypes.Structure):
    """``struct MergeParams`` of csrc/shard_merge.cu."""

    _fields_ = [("src", ctypes.c_void_p * MAX_SRC), ("out", ctypes.c_void_p),
                ("seg_off", ctypes.c_longlong * MAX_SEGS),
                ("seg_len", ctypes.c_longlong * MAX_SEGS),
                ("seg_op", ctypes.c_int * MAX_SEGS), ("S", ctypes.c_int),
                ("n_segs", ctypes.c_int), ("vec", ctypes.c_int),
                ("pad", ctypes.c_int)]


_lib = None
_THREADS = 256
_SMS: dict = {}


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load_checked
        lib = load_checked("shard_merge",
                           {"shard_params_size": ctypes.sizeof(_MergeParams),
                            "shard_threads": _THREADS},
                           "shard_error_string")
        for fn in ("shard_psum_launch", "shard_bucket_merge_launch"):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p]
            f.restype = ctypes.c_int
        _lib = lib
    return _lib


def _sms(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _launch(parts, segments, out, sums: bool) -> None:
    global psum_launches, merge_launches
    from .build import raise_on
    lib = _kernel_lib()
    dev = parts[0].device
    # every source and the output in one 16-byte phase: two words a thread
    vec = len({t.data_ptr() & 15 for t in (*parts, out)}) == 1
    fn = lib.shard_psum_launch if sums else lib.shard_bucket_merge_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    for at in range(0, len(segments), MAX_SEGS):
        chunk = segments[at:at + MAX_SEGS]
        p = _MergeParams()
        for s, t in enumerate(parts):
            p.src[s] = t.data_ptr()
        p.out = out.data_ptr()
        for i, (off, n, op) in enumerate(chunk):
            p.seg_off[i], p.seg_len[i], p.seg_op[i] = off, n, _OPS[op]
        p.S, p.n_segs, p.vec = len(parts), len(chunk), int(vec)
        units = max(n for _o, n, _op in chunk)
        units = -(-units // 2) if vec else units
        grid_x = max(1, min(-(-units // _THREADS),
                            max(1, 8 * _sms(dev) // len(chunk))))
        raise_on(lib, "shard_error_string",
                 fn(dev.index, ctypes.byref(p), grid_x, stream),
                 "shard_psum launch" if sums else
                 "shard_bucket_merge launch")
        if sums:
            psum_launches += 1
        else:
            merge_launches += 1


def _run(parts, segments, out, sums: bool, plain) -> torch.Tensor:
    parts = list(parts)
    _check(parts, segments, sums)
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
        _launch(parts, segments, out, sums)
    return out


def shard_psum(parts: Sequence[torch.Tensor], segments=None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sum of ``parts`` (S tensors of W words, int64 or float64, on one
    device) over ``segments`` (default: every word, by the parts' dtype)
    → ``out`` (a new tensor when None), not synchronized."""
    segments = _default_segments(parts) if segments is None else segments
    return _run(parts, segments, out, True, shard_psum_plain)


def shard_bucket_merge(parts: Sequence[torch.Tensor], segments,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The min / max of ``parts`` over ``segments`` → ``out``, not
    synchronized."""
    return _run(parts, segments, out, False, shard_bucket_merge_plain)

