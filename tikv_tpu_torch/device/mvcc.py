"""MVCC version resolution on the device: a region's CF_WRITE versions
become the runner's feed, born resident.

Counterpart of the JAX package's ``device/mvcc.py``.  The host keeps the
version planes of one CF_WRITE range (``WritePlanes``: one row per stored
version, one segment per user key, the keys' versions contiguous and
newest first) and a numpy mirror of their resolution (``resolve_host``,
``host_mirror``): the snapshot's host truth, which the feed digests are
recorded from.  The device resolves the same versions at the runner's
first feed miss (``ColdFeedBundle.mint``):

- ``mvcc_resolve`` (the CUDA kernel ``csrc/mvcc.cu``): eligibility
  (``commit_ts ≤ read_ts``, compared as int64, and a PUT or DELETE), the
  newest eligible version per key (a DELETE hides the key), compaction and
  a gather straight into the ``_build_flat`` layout;
- the CF_DEFAULT spill rows (PUTs whose row lives outside the write
  record; the caller fetched their values) are written into the gathered
  planes by one ``digest.patch_feed_rows`` launch for every plane.

The planes come from the native parse of a CF_WRITE range
(``parse_write_planes`` over ``native/fastbuild.cpp``
``mvcc_parse_planes``): at build time with the query's schema, or in
discovery mode on the streaming ingest (``copr/stream_build.py``), whose
chunks ``align_planes`` reconciles with the schema.  They reach the card
at the mint, or before the first query through ``DeviceVersionPlanes``
(chunks appended into capacity-bucketed buffers).
"""

from __future__ import annotations

import ctypes
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..datatype import Column, EvalType
from .digest import patch_feed_rows

# plane kind codes (the parse's): 0 = int64, 1 = float64, 3 = uint64
_PLANE_KINDS = {
    EvalType.INT: 0, EvalType.DURATION: 0,
    EvalType.REAL: 1,
    EvalType.DATETIME: 3, EvalType.ENUM: 3, EvalType.SET: 3,
}

_NP_BY_KIND = {0: np.int64, 1: np.float64, 3: np.uint64}

# write-type codes in the wtype plane
WT_PUT, WT_DELETE, WT_LOCK, WT_ROLLBACK = 0, 1, 2, 3

# kernel launches since import (the chip smoke resets it around a run)
resolve_launches = 0


def plane_schema(col_infos: Sequence):
    """→ (col_ids, kinds) of the version planes a schema needs, or None
    when it leaves the device envelope (BYTES/DECIMAL/JSON payloads or
    non-NULL defaults)."""
    ids, kinds = [], []
    for info in col_infos:
        if info.is_pk_handle:
            continue
        ft = info.field_type
        kind = _PLANE_KINDS.get(ft.eval_type)
        if kind is None or info.default_value is not None:
            return None
        if kind == 0 and ft.is_unsigned:
            kind = 3            # unsigned BIGINT: values live above 2^63
        ids.append(info.col_id)
        kinds.append(kind)
    return tuple(ids), tuple(kinds)


class WritePlanes:
    """Flat planes of one CF_WRITE range (or a concatenation of chunks):
    one row per stored VERSION, one segment per user key, plus per-column
    datum planes decoded from the short values."""

    __slots__ = ("n_ver", "n_keys", "table_id", "safe_ts", "commit_ts",
                 "start_ts", "wtype", "has_payload", "seg_id", "handles",
                 "seg_start", "cols", "need_default", "col_ids")

    def __init__(self, n_ver: int, n_keys: int, table_id: int,
                 safe_ts: int, commit_ts, start_ts, wtype, has_payload,
                 seg_id, handles, seg_start, cols: dict, need_default,
                 col_ids: tuple):
        self.n_ver = n_ver
        self.n_keys = n_keys
        self.table_id = table_id
        self.safe_ts = safe_ts
        self.commit_ts = commit_ts          # uint64[n_ver]
        self.start_ts = start_ts            # uint64[n_ver]
        self.wtype = wtype                  # uint8[n_ver]
        self.has_payload = has_payload      # uint8[n_ver]
        self.seg_id = seg_id                # int32[n_ver]
        self.handles = handles              # int64[n_keys]
        self.seg_start = seg_start          # int64[n_keys + 1]
        # col_id -> (kind, values ndarray[n_ver], valid bool[n_ver])
        self.cols = cols
        self.need_default = need_default    # [(ver_row, start_ts, ukey)]
        self.col_ids = col_ids

    def nbytes(self) -> int:
        """Host bytes of the planes: per version 8 + 8 + 1 + 1 + 4, and 9
        a column (value and validity); per key 8."""
        return self.n_ver * (22 + 9 * len(self.cols)) + self.n_keys * 8


def _parse_may_yield() -> bool:
    """Whether the build-time parse should release the GIL: only with a
    core to spare (on one core, yielding hands it to background threads
    and the parse's wall time grows)."""
    from ..utils import spare_cores
    return spare_cores() > 1


def parse_write_planes(keys, vals, prefix_skip: int,
                       col_infos: Optional[Sequence] = None,
                       release_gil: Optional[bool] = None) -> \
        Optional[WritePlanes]:
    """The native flat-plane parse of one contiguous CF_WRITE slice, or
    None when the data or schema is outside its envelope (index keys,
    mixed tables, datums it cannot decode, a commit_ts past int64).

    ``col_infos=None`` is discovery mode (the streaming ingest, which has
    no query schema yet): every column id seen in a row payload gets a
    plane of its stored kind.  ``release_gil``: None = only with a spare
    core; the streaming worker passes True.  A native module that cannot
    be built raises."""
    from ..native import mvcc_parse_planes
    if not keys:
        return None
    if col_infos is None:
        ids, kinds = (), ()
    else:
        schema = plane_schema(col_infos)
        if schema is None:
            return None
        ids, kinds = schema
    if release_gil is None:
        release_gil = _parse_may_yield()
    try:
        out = mvcc_parse_planes(keys, vals, prefix_skip, ids, kinds,
                                bool(release_gil))
    except ValueError:
        return None
    if out["safe_ts"] >= 1 << 63:
        return None     # the device compares timestamps as int64
    cols = {}
    out_ids = []
    for col_id, kind, payload, valid in out["cols"]:
        out_ids.append(col_id)
        cols[col_id] = (kind, np.frombuffer(payload, _NP_BY_KIND[kind]),
                        np.frombuffer(valid, np.uint8).astype(np.bool_))
    return WritePlanes(
        out["n_ver"], out["n_keys"], out["table_id"], out["safe_ts"],
        np.frombuffer(out["commit_ts"], np.uint64),
        np.frombuffer(out["start_ts"], np.uint64),
        np.frombuffer(out["wtype"], np.uint8),
        np.frombuffer(out["has_payload"], np.uint8),
        np.frombuffer(out["seg_id"], np.int32),
        np.frombuffer(out["handles"], np.int64),
        np.frombuffer(out["seg_start"], np.int64),
        cols, out["need_default"],
        tuple(out_ids) if col_infos is None else ids)


def align_planes(planes: WritePlanes,
                 col_infos: Sequence) -> Optional[WritePlanes]:
    """Reconcile planes with a query schema, or None when they cannot
    serve it: an int64 plane serves an unsigned kind by its uint64 view and
    a REAL request by ``astype``; a column never seen is all-NULL (an
    invalid zero plane); a float plane serves only REAL."""
    schema = plane_schema(col_infos)
    if schema is None:
        return None
    ids, kinds = schema
    cols: dict = {}
    for cid, want in zip(ids, kinds):
        got = planes.cols.get(cid)
        if got is None:
            cols[cid] = (want,
                         np.zeros(planes.n_ver, _NP_BY_KIND[want]),
                         np.zeros(planes.n_ver, np.bool_))
            continue
        kind, vals, valid = got
        if kind == want:
            cols[cid] = got
        elif kind == 0 and want == 3:
            cols[cid] = (3, vals.view(np.uint64), valid)
        elif kind == 0 and want == 1:
            cols[cid] = (1, vals.astype(np.float64), valid)
        else:
            return None
    return WritePlanes(
        planes.n_ver, planes.n_keys, planes.table_id, planes.safe_ts,
        planes.commit_ts, planes.start_ts, planes.wtype,
        planes.has_payload, planes.seg_id, planes.handles,
        planes.seg_start, cols, planes.need_default, ids)


def concat_planes(chunks: Sequence[WritePlanes]) -> WritePlanes:
    """Chunks of strictly ascending, non-overlapping user keys → one
    WritePlanes: segment ids offset by the running key count, version rows
    by the running version count.  A chunk without a column contributes an
    invalid zero slice; an int and a float plane of one column promote to
    float64."""
    if len(chunks) == 1:
        return chunks[0]
    n_ver = sum(c.n_ver for c in chunks)
    n_keys = sum(c.n_keys for c in chunks)
    first = chunks[0]
    seg_id = np.empty(n_ver, np.int32)
    seg_start = np.empty(n_keys + 1, np.int64)
    need = []
    vb = kb = 0
    for c in chunks:
        seg_id[vb:vb + c.n_ver] = c.seg_id + kb
        seg_start[kb:kb + c.n_keys] = c.seg_start[:-1] + vb
        need.extend((row + vb, sts, uk) for row, sts, uk in
                    c.need_default)
        vb += c.n_ver
        kb += c.n_keys
    seg_start[n_keys] = n_ver
    all_ids, kinds = [], {}
    for c in chunks:
        for cid in c.col_ids:
            if cid not in kinds:
                all_ids.append(cid)
                kinds[cid] = c.cols[cid][0]
            elif kinds[cid] != c.cols[cid][0]:
                kinds[cid] = 1
    cols = {}
    for cid in all_ids:
        kind = kinds[cid]
        dt = _NP_BY_KIND[kind]
        vparts, mparts = [], []
        for c in chunks:
            got = c.cols.get(cid)
            if got is None:
                vparts.append(np.zeros(c.n_ver, dt))
                mparts.append(np.zeros(c.n_ver, np.bool_))
            else:
                vparts.append(got[1].astype(dt, copy=False))
                mparts.append(got[2])
        cols[cid] = (kind, np.concatenate(vparts),
                     np.concatenate(mparts))
    return WritePlanes(
        n_ver, n_keys, first.table_id,
        max(c.safe_ts for c in chunks),
        np.concatenate([c.commit_ts for c in chunks]),
        np.concatenate([c.start_ts for c in chunks]),
        np.concatenate([c.wtype for c in chunks]),
        np.concatenate([c.has_payload for c in chunks]),
        seg_id,
        np.concatenate([c.handles for c in chunks]),
        seg_start, cols, need, tuple(all_ids))


def resolve_host(planes: WritePlanes, read_ts: int) -> np.ndarray:
    """Numpy mirror of the device resolution: ascending version rows of
    the newest committed PUT ≤ read_ts per key."""
    if planes.n_ver == 0:
        return np.empty(0, np.int64)
    elig = (planes.commit_ts <= np.uint64(read_ts)) & \
        (planes.wtype <= WT_DELETE)
    score = np.where(elig, planes.commit_ts, np.uint64(0))
    seg_max = np.maximum.reduceat(score, planes.seg_start[:-1])
    win = elig & (score == seg_max[planes.seg_id]) & (score > 0)
    vis = win & (planes.wtype == WT_PUT)
    return np.nonzero(vis)[0]


def host_mirror(planes: WritePlanes, winners: np.ndarray,
                col_infos: Sequence):
    """The host-truth columnar arrays of the resolved rows → (handles,
    {col_id: Column})."""
    seg = planes.seg_id[winners]
    handles = np.ascontiguousarray(planes.handles[seg])
    columns: dict = {}
    for info in col_infos:
        if info.is_pk_handle:
            continue
        _kind, vals, valid = planes.cols[info.col_id]
        columns[info.col_id] = Column(
            info.field_type.eval_type,
            np.ascontiguousarray(vals[winners]),
            np.ascontiguousarray(valid[winners]))
    return handles, columns


def _bucket(n: int, floor: int = 256) -> int:
    """Geometric capacity bucket (k·2^s, 8 ≤ k ≤ 15 — the feed's
    ``_pad_rows`` grid): a growing buffer reallocates O(log n) times."""
    n = max(floor, n)
    if n <= 8:
        return 8
    s = max(0, n.bit_length() - 4)
    k = -(-n // (1 << s))
    if k > 15:
        s += 1
        k = -(-n // (1 << s))
    return k << s


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host plane as a CPU tensor; a uint64 plane as its int64 bits (the
    kernel is told the kind)."""
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a)


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    return _host_tensor(arr).to(device)


class DeviceVersionPlanes:
    """Device-resident, capacity-bucketed version planes of one
    (region, table), filled chunk by chunk before the first query, so the
    mint reads planes already on the card.

    A chunk lands by a copy into its slice of each buffer; growth to the
    next bucket is a device-to-device copy of the old buffer into a zeroed
    one.  Padding is dead: rows past ``n_ver`` lie outside every key's
    segment.  Buffers: ``commit_ts`` (int64 bits), ``wtype``,
    ``seg_start`` (cap_keys + 1), ``handles``, and per column ``v<id>``
    (int64 bits or float64) and ``m<id>`` (bool)."""

    __slots__ = ("device", "n_ver", "n_keys", "cap_ver", "cap_keys", "bufs",
                 "nbytes")

    def __init__(self, device):
        self.device = torch.device(device)
        self.n_ver = 0
        self.n_keys = 0
        self.cap_ver = 0
        self.cap_keys = 0
        self.bufs: dict = {}        # name -> device tensor
        self.nbytes = 0

    def _specs(self, planes: WritePlanes) -> list:
        """(name, host chunk, rows of the chunk's first element, buffer
        capacity)."""
        seg_start = planes.seg_start[:-1] + np.int64(self.n_ver)
        specs = [("commit_ts", planes.commit_ts, self.n_ver, self.cap_ver),
                 ("wtype", planes.wtype, self.n_ver, self.cap_ver),
                 ("seg_start", seg_start, self.n_keys, self.cap_keys + 1),
                 ("handles", planes.handles, self.n_keys, self.cap_keys)]
        for cid in planes.col_ids:
            _k, vals, valid = planes.cols[cid]
            specs.append((f"v{cid}", vals, self.n_ver, self.cap_ver))
            specs.append((f"m{cid}", valid, self.n_ver, self.cap_ver))
        return specs

    def append(self, planes: WritePlanes) -> None:
        """Append one chunk (keys after every key already held)."""
        new_ver = self.n_ver + planes.n_ver
        new_keys = self.n_keys + planes.n_keys
        cap_v, cap_k = _bucket(new_ver), _bucket(new_keys)
        if cap_v > self.cap_ver or cap_k > self.cap_keys:
            cap_v = max(cap_v, self.cap_ver)
            cap_k = max(cap_k, self.cap_keys)
            for name, old in list(self.bufs.items()):
                cap = cap_k + 1 if name == "seg_start" else \
                    cap_k if name == "handles" else cap_v
                grown = torch.zeros(cap, dtype=old.dtype, device=self.device)
                grown[:old.shape[0]].copy_(old)
                self.bufs[name] = grown
            self.cap_ver, self.cap_keys = cap_v, cap_k
        for name, chunk, off, cap in self._specs(planes):
            src = _host_tensor(chunk)
            buf = self.bufs.get(name)
            if buf is None:
                # a plane's first content (the first chunk, or a column
                # first seen now: its earlier rows stay zero = invalid)
                buf = self.bufs[name] = torch.zeros(cap, dtype=src.dtype,
                                                    device=self.device)
            buf[off:off + src.shape[0]].copy_(src)      # H2D into place
        self.bufs["seg_start"][new_keys] = new_ver
        self.n_ver, self.n_keys = new_ver, new_keys
        self.nbytes = sum(b.numel() * b.element_size()
                          for b in self.bufs.values())


class ColdFeedBundle:
    """One cold build's resolve artifacts, stashed on the snapshot's feed
    lineage until the runner's first feed miss mints the born-resident
    feed from them.  One-shot: a mint attempt, served or refused, releases
    it."""

    __slots__ = ("resolver", "planes", "device", "n", "read_ts",
                 "mirror_handles", "mirror_cols", "has_nulls",
                 "spill_patches", "consumed", "lineage_v")

    def __init__(self, resolver: "DeviceMvccResolver",
                 planes: WritePlanes, device: Optional[DeviceVersionPlanes],
                 n: int, read_ts: int, mirror_handles: np.ndarray,
                 mirror_cols: dict, spill_patches: Optional[dict] = None):
        self.resolver = resolver
        self.planes = planes
        self.device = device            # resident planes, or None
        self.n = n
        self.read_ts = read_ts
        self.mirror_handles = mirror_handles
        self.mirror_cols = mirror_cols  # col_id -> Column (host truth)
        self.has_nulls = {cid: not bool(col.validity.all())
                          for cid, col in mirror_cols.items()}
        # feed rows whose PUT row lives in CF_DEFAULT: the kernel gathers
        # zero cells there; patched from the mirror after the gather
        self.spill_patches = spill_patches or {}
        self.consumed = False
        # the lineage version it was stashed at (FeedLineage.stash_cold)
        self.lineage_v = None

    def release(self) -> None:
        """Drop every device and host reference."""
        self.consumed = True
        self.planes = None
        self.device = None
        self.mirror_cols = {}
        self.mirror_handles = None

    def mint(self, runner, used_infos: Sequence, dtypes: Sequence,
             n: int, n_pad: int):
        """The feed dict (the exact ``_build_flat`` layout) resolved and
        gathered on the device, or None when this bundle cannot serve the
        request (row count moved, a column missing): the caller uploads.
        A failing kernel raises."""
        try:
            if self.consumed or self.planes is None or n != self.n or \
                    n == 0 or any(not info.is_pk_handle and
                                  info.col_id not in self.mirror_cols
                                  for info in used_infos):
                return None
            return self.resolver._mint(self, runner, used_infos, dtypes, n,
                                       n_pad)
        finally:
            self.release()


# ---------------------------------------------------------------------------
# the resolve kernel (csrc/mvcc.cu) and its plain version
# ---------------------------------------------------------------------------

_INT64_MIN = -(1 << 63)
# (plane kind, output dtype) pairs a value plane may take (the port's feed
# dtypes: INT as int32 or int64, REAL as float32 or float64)
_VALUE_CASTS = {0: (torch.int32, torch.int64),
                1: (torch.float32, torch.float64),
                3: (torch.int32, torch.int64)}
_HANDLE_DTYPES = (torch.int32, torch.int64)


def _check_spec(spec, kinds, sources) -> None:
    for s in spec:
        if s[0] == "h":
            ok = s[1] in _HANDLE_DTYPES
        elif s[0] == "v":
            kind = kinds[s[1]]
            ok = sources[s[1]].dtype == (torch.float64 if kind == 1
                                         else torch.int64) and \
                s[2] in _VALUE_CASTS.get(kind, ())
        elif s[0] == "m":
            ok = sources[s[1]].dtype == torch.bool
        else:
            ok = False
        if not ok:
            raise ValueError(f"mvcc_resolve: output {s} is not one the "
                             f"feed takes")


def mvcc_resolve_plain(commit_ts, wtype, seg_start, handles, sources,
                       kinds, spec, read_ts: int, n_keys: int,
                       n_pad: int) -> tuple:
    """The reference's ``resolve`` (mvcc.py:548-580) in torch: a
    segmented max (``scatter_reduce`` amax), a ``cumsum`` compaction and
    an index gather → (output planes of ``n_pad`` rows, the 0-d visible
    count)."""
    dev = commit_ts.device
    seg_start = seg_start[:n_keys + 1]
    n_ver = int(seg_start[-1]) if n_keys else 0
    if n_ver == 0:
        return [torch.zeros(n_pad, dtype=s[1] if s[0] == "h" else
                            s[2] if s[0] == "v" else torch.bool, device=dev)
                for s in spec], torch.zeros((), dtype=torch.int64,
                                            device=dev)
    ts, wt = commit_ts[:n_ver], wtype[:n_ver]
    seg_id = torch.repeat_interleave(
        torch.arange(n_keys, device=dev), seg_start.diff())
    elig = (ts <= read_ts) & (wt <= WT_DELETE)
    score = torch.where(elig, ts, torch.zeros((), dtype=ts.dtype,
                                              device=dev))
    seg_max = torch.full((n_keys,), _INT64_MIN, dtype=torch.int64,
                         device=dev).scatter_reduce(
        0, seg_id, score, "amax", include_self=True)
    win = elig & (score == seg_max[seg_id]) & (score > 0)
    vis = win & (wt == WT_PUT)
    count = vis.sum()
    pos = torch.cumsum(vis.to(torch.int64), 0) - 1
    tgt = torch.where(vis & (pos < n_pad), pos,
                      torch.full((), n_pad, dtype=torch.int64, device=dev))
    idx = torch.zeros(n_pad + 1, dtype=torch.int64, device=dev).scatter_(
        0, tgt, torch.arange(n_ver, device=dev))[:n_pad]
    live = torch.arange(n_pad, device=dev) < count
    outs = []
    for s in spec:
        if s[0] == "h":
            v = handles[seg_id[idx]].to(s[1])
        elif s[0] == "v":
            v = sources[s[1]][idx].to(s[2])
        else:
            v = sources[s[1]][idx]
        outs.append(torch.where(live, v, torch.zeros((), dtype=v.dtype,
                                                      device=dev)))
    return outs, count


_MAX_OUT = 64
TILE_KEYS = 1024    # csrc/mvcc.cu TILE_KEYS: keys of a resolve tile
_OP = {"h": 0, "v": 1, "m": 2}
_SRC_BOOL = 4
_DST = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3,
        torch.bool: 4}


class _ResolveParams(ctypes.Structure):
    _fields_ = [("commit_ts", ctypes.c_void_p),
                ("wtype", ctypes.c_void_p),
                ("seg_start", ctypes.c_void_p),
                ("handles", ctypes.c_void_p),
                ("n_keys", ctypes.c_longlong),
                ("read_ts", ctypes.c_longlong),
                ("n_pad", ctypes.c_longlong),
                ("n_tiles", ctypes.c_longlong),
                ("work", ctypes.c_void_p),
                ("n_out", ctypes.c_int),
                ("op", ctypes.c_int * _MAX_OUT),
                ("src_kind", ctypes.c_int * _MAX_OUT),
                ("dst_kind", ctypes.c_int * _MAX_OUT),
                ("src", ctypes.c_void_p * _MAX_OUT),
                ("dst", ctypes.c_void_p * _MAX_OUT)]


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("mvcc")
        lib.mvcc_resolve_launch.argtypes = [
            ctypes.c_int, ctypes.POINTER(_ResolveParams), ctypes.c_void_p]
        lib.mvcc_resolve_launch.restype = ctypes.c_int
        lib.mvcc_params_bytes.restype = ctypes.c_int
        lib.mvcc_max_out.restype = ctypes.c_int
        lib.mvcc_tile_keys.restype = ctypes.c_longlong
        lib.mvcc_error_string.argtypes = [ctypes.c_int]
        lib.mvcc_error_string.restype = ctypes.c_char_p
        if lib.mvcc_params_bytes() != ctypes.sizeof(_ResolveParams) or \
                lib.mvcc_max_out() != _MAX_OUT or \
                lib.mvcc_tile_keys() != TILE_KEYS:
            raise RuntimeError("mvcc: the kernel's parameter layout "
                               "differs from the wrapper's")
        _lib = lib
    return _lib


def _mvcc_resolve_cuda(commit_ts, wtype, seg_start, handles, sources,
                       kinds, spec, read_ts, n_keys, n_pad) -> tuple:
    global resolve_launches
    lib = _kernel_lib()
    dev = commit_ts.device
    n_tiles = -(-n_keys // TILE_KEYS)
    # status words, the tile counter, the count (zeroed by the launcher)
    work = torch.empty(n_tiles + 2, dtype=torch.int64, device=dev)
    outs = [torch.empty(n_pad, dtype=s[1] if s[0] == "h" else
                        s[2] if s[0] == "v" else torch.bool, device=dev)
            for s in spec]
    p = _ResolveParams(
        commit_ts=commit_ts.data_ptr(), wtype=wtype.data_ptr(),
        seg_start=seg_start.data_ptr(), handles=handles.data_ptr(),
        n_keys=n_keys, read_ts=read_ts, n_pad=n_pad, n_tiles=n_tiles,
        work=work.data_ptr(), n_out=len(spec))
    for q, (s, out) in enumerate(zip(spec, outs)):
        p.op[q] = _OP[s[0]]
        if s[0] == "h":
            p.src[q], p.src_kind[q] = handles.data_ptr(), 0
        else:
            src = sources[s[1]]
            p.src[q] = src.data_ptr()
            p.src_kind[q] = _SRC_BOOL if s[0] == "m" else kinds[s[1]]
        p.dst[q], p.dst_kind[q] = out.data_ptr(), _DST[out.dtype]
    err = lib.mvcc_resolve_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("mvcc_resolve launch failed: "
                           + lib.mvcc_error_string(err).decode())
    resolve_launches += 1
    return outs, work[n_tiles + 1]


def mvcc_resolve(commit_ts: torch.Tensor, wtype: torch.Tensor,
                 seg_start: torch.Tensor, handles: torch.Tensor,
                 sources: Sequence[torch.Tensor], kinds: Sequence[int],
                 spec: Sequence[tuple], read_ts: int, n_keys: int,
                 n_pad: int) -> tuple:
    """Resolve ``n_keys`` keys' versions at ``read_ts`` and gather the
    visible ones into ``n_pad``-row feed planes → (the planes, per
    ``spec``; the 0-d int64 visible count), not synchronized.

    ``commit_ts`` (int64 bits of the uint64 timestamps) and ``wtype``
    (uint8) hold every version row below ``seg_start[n_keys]``; key k's
    versions are rows [seg_start[k], seg_start[k+1]); ``handles`` is
    int64.  ``sources`` are value planes (int64 bits of plane kind
    ``kinds[i]`` — 0 int64, 3 uint64 — or float64, kind 1) and validity
    planes (bool), per version row.  ``spec`` per output plane:
    ("h", dtype) the handle, ("v", source, dtype) a value plane cast to
    its feed dtype (numpy's ``astype``: integers wrap, floats round to
    nearest), ("m", source) a validity plane.  Rows at or past the
    visible count hold 0 / False."""
    if not 0 <= read_ts < 1 << 63:
        raise ValueError(f"mvcc_resolve: read_ts {read_ts} outside "
                         f"[0, 2^63) (timestamps compare as int64)")
    if not spec or n_pad <= 0 or n_keys < 0:
        raise ValueError(f"mvcc_resolve: {len(spec)} outputs, n_pad "
                         f"{n_pad}, n_keys {n_keys}")
    dev = commit_ts.device
    want = [(commit_ts, torch.int64), (wtype, torch.uint8),
            (seg_start, torch.int64), (handles, torch.int64)]
    for t, dt in want + [(s, s.dtype) for s in sources]:
        if t.device != dev or t.dtype != dt or t.dim() != 1 or \
                not t.is_contiguous():
            raise ValueError(f"mvcc_resolve: a {t.dtype} plane of shape "
                             f"{tuple(t.shape)} on {t.device}; expected "
                             f"contiguous 1-D {dt} on {dev}")
    if seg_start.shape[0] < n_keys + 1 or handles.shape[0] < n_keys:
        raise ValueError("mvcc_resolve: seg_start or handles shorter than "
                         "the keys")
    _check_spec(spec, kinds, sources)
    if dev.type == "cpu":
        return mvcc_resolve_plain(commit_ts, wtype, seg_start, handles,
                                  sources, kinds, spec, read_ts, n_keys,
                                  n_pad)
    if dev.type != "cuda":
        raise ValueError(f"mvcc_resolve runs on cuda or cpu, not {dev}")
    # a wide schema's outputs in groups of at most _MAX_OUT, one launch
    # each (every group resolves the same rows)
    outs = []
    for at in range(0, len(spec), _MAX_OUT):
        part, count = _mvcc_resolve_cuda(
            commit_ts, wtype, seg_start, handles, sources, kinds,
            spec[at:at + _MAX_OUT], read_ts, n_keys, n_pad)
        outs += part
    return outs, count


def resolve_inputs(planes: WritePlanes,
                   resident: Optional[DeviceVersionPlanes], used_infos,
                   dtypes, has_nulls: dict, device) -> tuple:
    """``mvcc_resolve``'s leading arguments for the feed planes of
    ``used_infos`` in ``dtypes`` → ((commit_ts, wtype, seg_start, handles,
    sources, kinds, spec), null flags per column, whether ``resident``
    served them; else the host planes were uploaded).  A column's validity
    plane is gathered only where ``has_nulls`` says it holds a NULL."""
    if resident is not None and (resident.n_ver != planes.n_ver or
                                 resident.n_keys != planes.n_keys):
        resident = None         # the resident planes diverged: upload
    # which source planes the kernel reads, in input order
    spec, names, kinds, hosts = [], [], [], []

    def slot(name: str, host, kind: int) -> int:
        if name not in names:
            names.append(name)
            hosts.append(host)
            kinds.append(kind)
        return names.index(name)

    null_flags = []
    for info, ds in zip(used_infos, dtypes):
        dt = getattr(torch, ds)
        if info.is_pk_handle:
            spec.append(("h", dt))
            null_flags.append(False)
            continue
        cid = info.col_id
        kind, vals, valid = planes.cols[cid]
        spec.append(("v", slot(f"v{cid}", vals, kind), dt))
        null_flags.append(has_nulls[cid])
        if has_nulls[cid]:
            spec.append(("m", slot(f"m{cid}", valid, _SRC_BOOL)))
    want = [torch.float64 if k == 1 else torch.bool if k == _SRC_BOOL
            else torch.int64 for k in kinds]
    if resident is not None and any(
            nm in resident.bufs and resident.bufs[nm].dtype != w
            for nm, w in zip(names, want)):
        resident = None         # stored kinds differ from the schema's
    if resident is not None:
        bufs = resident.bufs
        fixed = (bufs["commit_ts"], bufs["wtype"], bufs["seg_start"],
                 bufs["handles"])
        # a column with no datum in any chunk has no buffer: invalid zeros
        # serve it (the mirror says the same)
        ins = [bufs[nm] if nm in bufs else
               torch.zeros(resident.cap_ver, dtype=w, device=device)
               for nm, w in zip(names, want)]
    else:
        fixed = tuple(_to_device(a, device) for a in (
            planes.commit_ts, planes.wtype, planes.seg_start,
            planes.handles))
        ins = [_to_device(a, device) for a in hosts]
    return (*fixed, ins, kinds, spec), null_flags, resident is not None


class DeviceMvccResolver:
    """Mints born-resident feeds from cold bundles on the runner's device.
    ``mints`` counts them; ``phases_ms`` holds the last mint's host-clock
    phases (``h2d``: the version planes' upload, or 0 when they were
    resident; ``resolve``: ``mvcc_resolve`` through its count's readback;
    ``patch``: the spill rows; ``digests``: the wait for the host-truth
    digests, hashed on a thread pool from the start of the mint)."""

    def __init__(self, runner=None):
        self._runner = runner
        self.mints = 0
        self.phases_ms: dict = {}

    def available(self) -> bool:
        """The device rung serves only a single-device runner (a mesh's
        cold builds upload)."""
        r = self._runner
        return r is not None and getattr(r, "_single", False)

    def h2d_profitable(self) -> bool:
        """Whether streaming version planes to the device ahead of the
        first query pays: only when the runner's device is a CUDA card (on
        the CPU there is no transfer to overlap)."""
        r = self._runner
        return r is not None and r.device.type == "cuda"

    @property
    def device(self):
        return self._runner.device

    def _mint(self, bundle: ColdFeedBundle, runner, used_infos, dtypes,
              n: int, n_pad: int) -> dict:
        from .supervisor import hash_workers, start_plane_digests
        t0 = time.perf_counter()
        with ThreadPoolExecutor(hash_workers()) as pool:
            # the digests come from the HOST truth, never from the planes
            # they audit (a wrong resolve or gather shows at the next
            # scrub); the pool hashes while the planes upload and resolve
            hosts = []
            for info, ds in zip(used_infos, dtypes):
                if info.is_pk_handle:
                    hosts.append((bundle.mirror_handles, np.dtype(ds)))
                    continue
                col = bundle.mirror_cols[info.col_id]
                hosts.append((col.values, np.dtype(ds)))
                if bundle.has_nulls[info.col_id]:
                    hosts.append((col.validity, None))
            digests = start_plane_digests(pool, hosts, n)
            args, null_flags, resident = resolve_inputs(
                bundle.planes, bundle.device, used_infos, dtypes,
                bundle.has_nulls, runner.device)
            h2d_ms = 0.0 if resident else (time.perf_counter() - t0) * 1e3
            t1 = time.perf_counter()
            flat, count = mvcc_resolve(*args, bundle.read_ts,
                                       bundle.planes.n_keys, n_pad)
            got = int(count)
            if got != n:
                raise RuntimeError(f"mvcc_resolve found {got} visible "
                                   f"rows, the host mirror {n}")
            t2 = time.perf_counter()
            if bundle.spill_patches:
                # PUTs whose row lives in CF_DEFAULT gathered zero cells:
                # write their host-truth cells into every plane they touch
                # in one launch
                rows = np.fromiter(sorted(bundle.spill_patches), np.int64)
                planes, cells, fi = [], [], 0
                for info, ds, nulls in zip(used_infos, dtypes, null_flags):
                    if not info.is_pk_handle:
                        col = bundle.mirror_cols[info.col_id]
                        planes.append(flat[fi])
                        cells.append(np.ascontiguousarray(
                            col.values[rows].astype(ds)))
                        if nulls:
                            planes.append(flat[fi + 1])
                            cells.append(np.ascontiguousarray(
                                col.validity[rows]))
                    fi += 2 if nulls else 1
                if planes:
                    patch_feed_rows(planes, rows, cells)
            t3 = time.perf_counter()
            feed = {"flat": tuple(flat), "null_flags": tuple(null_flags),
                    "n_pad": n_pad, "digests": digests(), "n_live": n}
        self.phases_ms = {"h2d": h2d_ms, "resolve": (t2 - t1) * 1e3,
                          "patch": (t3 - t2) * 1e3,
                          "digests": (time.perf_counter() - t3) * 1e3}
        self.mints += 1
        return feed
