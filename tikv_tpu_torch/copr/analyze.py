"""ANALYZE (tp=104) and CHECKSUM (tp=105) requests: their descriptors,
the host half of ANALYZE and the CHECKSUM fold.

A copy of the JAX package's ``copr/analyze.py`` (reference:
src/coprocessor/statistics/ — column equi-depth histograms, distinct and
NULL counts, endpoint.rs:275-312 — and src/coprocessor/checksum.rs —
crc64-xz over each KV pair, XOR-folded so region checksums compose).

The host half (``analyze_columns``) sorts each column with numpy; the
device runner (``device/runner.py`` ``handle_analyze``) sorts INT, REAL,
DATETIME and DURATION columns on the card (``device/analyze.py``) and
unpacks the same statistics.  ``checksum_kv_pairs`` folds with the Python
``crc64``; the port has no native module.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..datatype import EvalType
from ..executors.ranges import KeyRange
from .dag import TableScanDesc

# the eval types whose statistics the device runner computes on the card
ANALYZE_DEVICE_ETS = (EvalType.INT, EvalType.REAL, EvalType.DATETIME,
                      EvalType.DURATION)


@dataclass
class AnalyzeReq:
    """coppb Request tp=104 (AnalyzeReq analog): per-column stats."""

    scan: TableScanDesc
    ranges: Sequence[KeyRange] = ()
    buckets: int = 64
    start_ts: int = 0


@dataclass
class ChecksumReq:
    """coppb Request tp=105 (ChecksumRequest analog)."""

    scan: TableScanDesc
    ranges: Sequence[KeyRange] = ()
    start_ts: int = 0


@dataclass
class ColumnStats:
    col_id: int
    total: int
    null_count: int
    distinct: int
    # equi-depth buckets: (upper_bound, cumulative_count) — the
    # reference's Histogram::append shape
    buckets: list = field(default_factory=list)


def histogram_from_sorted(svals: np.ndarray, n_buckets: int):
    """Equi-depth buckets over an ascending-sorted non-null array.

    Returns ([(upper_bound, cumulative_count)], distinct)."""
    n = len(svals)
    if n == 0:
        return [], 0
    if n > 1:
        distinct = int((svals[1:] != svals[:-1]).sum()) + 1
    else:
        distinct = 1
    n_buckets = max(1, min(n_buckets, n))
    # rank positions of bucket upper bounds (inclusive)
    ranks = ((np.arange(1, n_buckets + 1) * n) // n_buckets) - 1
    out = []
    for r in ranks:
        v = svals[int(r)]
        out.append((v.item() if hasattr(v, "item") else v, int(r) + 1))
    return out, distinct


def analyze_columns(batch, col_infos, n_buckets: int) -> list:
    """Host half: stats per requested column over a ColumnBatch."""
    out = []
    for i, info in enumerate(col_infos):
        col = batch.columns[i]
        total = len(col)
        if col.eval_type in ANALYZE_DEVICE_ETS:
            valid = col.values[col.validity]
            nulls = total - len(valid)
            svals = np.sort(valid)
        else:
            # bytes columns: a Python-object sort (an admin path's cost)
            vals = [col.values[j] for j in range(total)
                    if col.validity[j]]
            nulls = total - len(vals)
            vals.sort()
            svals = np.asarray(vals, dtype=object)
        buckets, distinct = histogram_from_sorted(svals, n_buckets)
        out.append(ColumnStats(info.col_id, total, nulls, distinct,
                               buckets))
    return out


# ---------------------------------------------------------------- checksum

_CRC64_POLY_REFL = 0xC96C5795D7870F42   # crc64-xz: ECMA-182 reflected
_crc64_table: Optional[list] = None


def _table() -> list:
    global _crc64_table
    if _crc64_table is None:
        tbl = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ _CRC64_POLY_REFL if crc & 1 \
                    else crc >> 1
            tbl.append(crc)
        _crc64_table = tbl
    return _crc64_table


def crc64(data: bytes, crc: int = 0) -> int:
    """crc64-xz (reflected, check value 0x995DC9BBDF1939FA) — the variant
    the reference's crc64fast computes."""
    tbl = _table()
    crc ^= 0xFFFFFFFFFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ tbl[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFFFFFFFFFF


def checksum_kv_pairs(keys, vals) -> dict:
    """XOR-fold crc64(key || value) over pairs — order-independent, so
    region checksums compose across replicas and shards (checksum.rs)."""
    total_bytes = 0
    cs = 0
    for k, v in zip(keys, vals):
        total_bytes += len(k) + len(v)
        cs ^= crc64(k + v)
    return {"checksum": cs, "total_kvs": len(keys),
            "total_bytes": total_bytes}
