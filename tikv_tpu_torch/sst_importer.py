"""Bulk load: the SST artifact a client builds and the apply path ingests.

A copy of the JAX package's ``sst_importer.py`` (reference:
components/sst_importer/ and src/import/ — TiDB Lightning or a BR restore
builds sorted files locally, and an ingest lands a file atomically).  The
engine has no RocksDB SST to link, so an ingest is one raft entry whose op
carries the file (``raftstore.cmd.exec_write_ops``); this module keeps the
file format:

- v1 (``SstWriter``, ``read_sst``): one msgpack list of (cf, key, value)
  triples, crc32-sealed;
- v2 (``build_sst_v2``, ``read_sst_cf``): one sorted column group a CF,
  so the engine bulk-merges whole runs with no per-row Python.
  ``fast_mvcc_table_sst`` builds one from int64/float64 column buffers
  through the native ``build_mvcc_sst`` (``native/fastbuild.cpp``);
  ``mvcc_sst`` writes pre-timestamped Percolator records row by row.

The apply-side parse memo (``enable_ingest_parse_memo``,
``pop_ingest_parse``) hands the apply thread's decode of a blob to the
streaming cold build (``copr/stream_build.py``), which observes the same
blob object moments later, so the msgpack unpack is paid once.
"""

from __future__ import annotations

import struct
import threading
import zlib

_SST_MAGIC = b"TKVSST1\n"
_SST2_MAGIC = b"TKVSST2\n"


def _packb(obj) -> bytes:
    import msgpack
    return msgpack.packb(obj, use_bin_type=True)


def _unpackb(payload: bytes):
    import msgpack
    return msgpack.unpackb(payload, raw=False)


def _seal(magic: bytes, payload: bytes) -> bytes:
    return magic + payload + struct.pack(">I", zlib.crc32(payload)
                                         & 0xFFFFFFFF)


def _unseal(blob: bytes, magic: bytes, what: str) -> bytes:
    if not blob.startswith(magic) or len(blob) < len(magic) + 4:
        raise ValueError(f"bad {what} magic")
    payload = blob[len(magic):-4]
    (crc,) = struct.unpack(">I", blob[-4:])
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise ValueError(f"{what} checksum mismatch")
    return payload


class SstWriter:
    """Client-side builder: collect (cf, key, value), emit one sorted,
    crc-sealed artifact (sst_importer writer.rs)."""

    def __init__(self):
        self._pairs: list = []

    def put(self, cf: str, key: bytes, value: bytes) -> None:
        self._pairs.append((cf, key, value))

    def __len__(self) -> int:
        return len(self._pairs)

    def finish(self) -> bytes:
        self._pairs.sort(key=lambda p: (p[0], p[1]))
        return _seal(_SST_MAGIC, _packb(
            [[cf, bytes(k), bytes(v)] for cf, k, v in self._pairs]))


# The ingest-parse memo: id(blob) -> (blob, groups).  The blob itself is
# pinned so its id cannot be recycled; a lagging consumer evicts the
# oldest entry and re-parses.  Entries are kept only while a consumer is
# registered.
_INGEST_MEMO: dict = {}
_INGEST_MEMO_CAP = 2
_INGEST_MEMO_MU = threading.Lock()
_memo_consumers = 0


def enable_ingest_parse_memo(on: bool) -> None:
    """Register (or unregister) a consumer of the memo; refcounted."""
    global _memo_consumers
    with _INGEST_MEMO_MU:
        _memo_consumers = max(0, _memo_consumers + (1 if on else -1))
        if not _memo_consumers:
            _INGEST_MEMO.clear()


def pop_ingest_parse(blob):
    """Pop the memoized decode of ``blob`` → {cf: (keys, vals)}, or None."""
    with _INGEST_MEMO_MU:
        hit = _INGEST_MEMO.pop(id(blob), None)
    if hit is not None and hit[0] is blob:
        return hit[1]
    return None


def read_sst(blob: bytes) -> list:
    """→ [(cf, key, value)]; raises ValueError on a corrupt artifact."""
    if is_sst_v2(blob):
        return [(cf, k, v)
                for cf, (keys, vals) in read_sst_cf(blob).items()
                for k, v in zip(keys, vals)]
    return [(cf, k, v) for cf, k, v in
            _unpackb(_unseal(blob, _SST_MAGIC, "sst"))]


def is_sst_v2(blob: bytes) -> bool:
    return blob.startswith(_SST2_MAGIC)


def read_sst_cf(blob: bytes, validate: bool = True,
                memo: bool = False) -> dict:
    """v2 container → {cf: (keys list, values list)}, keys ascending;
    raises ValueError on a corrupt artifact.

    ``validate=False`` skips the strictly-ascending check: sound only for
    a consumer re-reading a blob the apply path already admitted.
    ``memo=True`` (the apply path only) keeps this decode for the
    streaming consumer's read of the same blob object."""
    hit = pop_ingest_parse(blob)
    if hit is not None:
        return hit
    out = {}
    for cf, keys, vals in _unpackb(_unseal(blob, _SST2_MAGIC, "sst v2")):
        if len(keys) != len(vals):
            raise ValueError("sst v2 cf group length mismatch")
        # the engine bulk-merges each group as a sorted run on every
        # replica: out-of-order or duplicate keys would corrupt the merged
        # keyspace, so they are refused before they reach the engine
        if validate and len(keys) > 1 and (keys != sorted(keys) or
                                           len(set(keys)) != len(keys)):
            raise ValueError(
                f"sst v2 cf {cf!r}: keys not strictly ascending")
        out[cf] = (keys, vals)
    if memo and _memo_consumers:
        with _INGEST_MEMO_MU:
            while len(_INGEST_MEMO) >= _INGEST_MEMO_CAP:
                _INGEST_MEMO.pop(next(iter(_INGEST_MEMO)))
            _INGEST_MEMO[id(blob)] = (blob, out)
    return out


def build_sst_v2(cf_map: dict) -> bytes:
    """{cf: (sorted keys, values)} → v2 blob (the container the native
    builder writes)."""
    return _seal(_SST2_MAGIC, _packb(
        [[cf, list(keys), list(vals)]
         for cf, (keys, vals) in sorted(cf_map.items())]))


def fast_mvcc_table_sst(table_id: int, handles, columns, commit_ts: int,
                        start_ts: int = 0) -> bytes:
    """A v2 blob of pre-timestamped MVCC records for one int/float table
    chunk, built by the native ``build_mvcc_sst``.

    ``handles``: ascending int64 array; ``columns``: (col_id, int64 or
    float64 array, validity or None) each.  A row of more columns than a
    map16 header holds takes the row-by-row encoder (``mvcc_sst``)."""
    import numpy as np

    from .native import build_mvcc_sst
    start_ts = start_ts or commit_ts - 1
    h = np.ascontiguousarray(np.asarray(handles, dtype=np.int64))
    ids, kinds, bufs, valids = [], [], [], []
    for col_id, vals, valid in columns:
        a = np.asarray(vals)
        kind = 1 if a.dtype.kind == "f" else 0
        kinds.append(kind)
        ids.append(int(col_id))
        bufs.append(np.ascontiguousarray(
            a, dtype=np.float64 if kind else np.int64).tobytes())
        valids.append(None if valid is None else np.ascontiguousarray(
            valid, dtype=np.uint8).tobytes())
    try:
        return build_mvcc_sst(table_id, h.tobytes(), tuple(ids),
                              tuple(kinds), tuple(bufs), tuple(valids),
                              commit_ts, start_ts)
    except ValueError as e:
        if "too many columns" not in str(e):
            raise
    from .codec.keys import table_record_key
    from .codec.row import encode_row
    rows = []
    col_arrs = [(int(cid), np.asarray(vals), valid)
                for cid, vals, valid in columns]
    for i, handle in enumerate(h.tolist()):
        payload = {}
        for cid, vals, valid in col_arrs:
            if valid is not None and not valid[i]:
                payload[cid] = None
            elif vals.dtype.kind == "f":
                payload[cid] = float(vals[i])
            else:
                payload[cid] = int(vals[i])
        rows.append((table_record_key(table_id, handle),
                     encode_row(payload)))
    w = mvcc_sst(rows, commit_ts, start_ts)
    by_cf: dict = {}
    for cf, k, v in sorted(w._pairs, key=lambda p: (p[0], p[1])):
        got = by_cf.setdefault(cf, ([], []))
        got[0].append(k)
        got[1].append(v)
    return build_sst_v2(by_cf)


def mvcc_sst(rows, commit_ts: int, start_ts: int = 0) -> SstWriter:
    """Pre-timestamped Percolator records for ``rows`` = [(user key,
    value)]: committed state written directly (CF_WRITE, and CF_DEFAULT
    for a value past the short-value limit), the Lightning / BR-restore
    shape."""
    from .engine.traits import CF_DEFAULT, CF_WRITE
    from .storage.txn_types import (SHORT_VALUE_MAX_LEN, Write, WriteType,
                                    append_ts, encode_key)
    start_ts = start_ts or commit_ts - 1
    w = SstWriter()
    for key, value in rows:
        enc = encode_key(key)
        if len(value) <= SHORT_VALUE_MAX_LEN:
            rec = Write(WriteType.PUT, start_ts, short_value=value)
        else:
            rec = Write(WriteType.PUT, start_ts)
            w.put(CF_DEFAULT, append_ts(enc, start_ts), value)
        w.put(CF_WRITE, append_ts(enc, commit_ts), rec.to_bytes())
    return w
