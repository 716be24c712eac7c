"""Seeded MVCC version histories in the layout of the CF_WRITE parse, with
their visible rows worked out independently, as the truth.

A history is a list of ``Event``s, each a commit of one write type at one
commit_ts over some keys.  ``version_history`` lays it out as
``device.mvcc.WritePlanes`` the way the JAX package's native parse does
(``tikv_tpu/native/fastbuild.cpp`` ``mvcc_parse_planes``): one segment per
key, a key's versions contiguous and newest first, ``seg_id`` =
``repeat(arange(n_keys), diff(seg_start))``, start_ts = commit_ts − 1
(a ROLLBACK's = its commit_ts), a payload only on PUTs, NULL and non-PUT
cells 0 and invalid, safe_ts the largest commit_ts.  The truth replays the
commits in timestamp order up to read_ts (a PUT sets the row, a DELETE
removes it, LOCK and ROLLBACK leave it), which is not how
``resolve_host`` computes it.

The two cold-path configurations of the chip smoke:

- ``history_6c``: ``bench.py``'s config 6 (:501-560) as ``_bulk_load``
  (:457-462) writes it: one PUT per key at one commit_ts, ``c0 = h %
  1024`` and ``c1 = h % 1000``;
- ``history_4h``: config 4's table (``configs.build_table``, seed 7) with
  a chosen version mix: every key a base PUT at 100; by share of keys, 10%
  an update PUT at 200 (``v`` NULL on 5% of those), 2% a newest DELETE at
  300, 1% a ROLLBACK at 250, 1% a LOCK at 260 and 1% a PUT at 500, above
  the read_ts of 400.  No benchmark of the repository commits these
  shares: ``bench.py``'s write churn (config 6w, :696) runs point writes
  only, over ``int_table(2)``.  The mix puts every write type and both
  sides of read_ts into one history.

``kv_history`` writes the same ``Event``s as the engine's records instead:
``(cf, key, value)`` triples of CF_WRITE versions (short-value PUT rows,
DELETE, LOCK, ROLLBACK) and CF_LOCK locks, which
``convert.engine_from_triples`` loads into a ``MemoryEngine`` for the
columnar cache to build from.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..datatype import Column, EvalType, FieldType
from ..device.mvcc import (_NP_BY_KIND, WT_DELETE, WT_LOCK, WT_PUT,
                           WT_ROLLBACK, WritePlanes)
from ..executors.columnar import ColumnarTable
from . import configs
from .fixture import Table, TableColumn

# the columns of the smoke's tables, by col_id
ETS_INT = {2: EvalType.INT, 3: EvalType.INT}


@dataclass
class Event:
    """One commit: ``wtype`` at ``commit_ts`` over the keys ``keys``
    (ascending key ordinals); a PUT's cells per column aligned with
    ``keys``: {col_id: (values, validity)}."""

    commit_ts: int
    wtype: int
    keys: np.ndarray
    cols: Optional[dict] = None


def version_history(handles: np.ndarray, events: Sequence[Event],
                    kinds: dict, read_ts: int, table_id: int = 0) -> tuple:
    """→ (WritePlanes, truth handles, {col_id: (values, validity)} of the
    rows visible at ``read_ts``).  ``kinds``: {col_id: plane kind}.  Every
    key needs a version, and no two events of a key share a commit_ts."""
    n = len(handles)
    by_ts = sorted(events, key=lambda e: -e.commit_ts)
    if len({e.commit_ts for e in by_ts}) != len(by_ts):
        raise ValueError("two events share a commit_ts")
    counts = np.zeros(n, np.int64)
    for e in by_ts:
        counts[e.keys] += 1
    if n and counts.min() == 0:
        raise ValueError("a key without a version")
    seg_start = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=seg_start[1:])
    n_ver = int(seg_start[-1])
    commit_ts = np.empty(n_ver, np.uint64)
    wtype = np.empty(n_ver, np.uint8)
    cols = {cid: (kind, np.zeros(n_ver, _NP_BY_KIND[kind]),
                  np.zeros(n_ver, np.bool_)) for cid, kind in kinds.items()}
    filled = seg_start[:-1].copy()      # each key's next version row
    for e in by_ts:
        if len(e.keys) == n:            # every key: no gather
            rows = filled.copy()
            filled += 1
        else:
            rows = filled[e.keys]
            filled[e.keys] += 1
        commit_ts[rows] = e.commit_ts
        wtype[rows] = e.wtype
        if e.wtype == WT_PUT:
            for cid, (vals, ok) in e.cols.items():
                _kind, pv, pm = cols[cid]
                pv[rows] = vals if ok.all() else np.where(ok, vals, 0)
                pm[rows] = ok
    start_ts = commit_ts - (wtype != WT_ROLLBACK).astype(np.uint64)
    has_payload = (wtype == WT_PUT).astype(np.uint8)
    seg_id = np.repeat(np.arange(n, dtype=np.int32), counts)
    planes = WritePlanes(
        n_ver, n, table_id, int(commit_ts.max()) if n_ver else 0, commit_ts,
        start_ts, wtype, has_payload, seg_id,
        np.ascontiguousarray(handles, np.int64), seg_start, cols, [],
        tuple(kinds))
    # the truth: the commits replayed in timestamp order up to read_ts
    visible = np.zeros(n, np.bool_)
    tv = {cid: np.zeros(n, _NP_BY_KIND[k]) for cid, k in kinds.items()}
    tm = {cid: np.zeros(n, np.bool_) for cid in kinds}
    for e in reversed(by_ts):
        if e.commit_ts > read_ts or e.wtype not in (WT_PUT, WT_DELETE):
            continue
        visible[e.keys] = e.wtype == WT_PUT
        if e.wtype == WT_PUT:
            for cid, (vals, ok) in e.cols.items():
                tv[cid][e.keys] = np.where(ok, vals, 0)
                tm[cid][e.keys] = ok
    truth = {cid: (tv[cid][visible], tm[cid][visible]) for cid in kinds}
    return planes, np.asarray(handles, np.int64)[visible], truth


def equal_ts_planes() -> WritePlanes:
    """Planes no parse yields (a key's commit_ts is part of its CF_WRITE
    key): key 0 has two PUTs at 50, key 1 a DELETE and a PUT at 50, key 2 a
    PUT and a LOCK at 50, key 3 a PUT at 40; INT, REAL and unsigned
    columns.  The reference's resolve lets every PUT at a key's newest
    eligible commit_ts win."""
    wt = np.asarray([0, 0, 1, 0, 0, 2, 0], np.uint8)
    seg_start = np.asarray([0, 2, 4, 6, 7], np.int64)
    n = len(wt)
    cols = {2: (0, np.arange(n) * 11 - 20, np.ones(n, np.bool_)),
            3: (1, np.arange(n) * 0.25, np.arange(n) % 3 != 0),
            4: (3, np.arange(n, dtype=np.uint64) + np.uint64(1 << 63),
                np.ones(n, np.bool_))}
    return WritePlanes(
        n, 4, 5, 50, np.asarray([50] * 6 + [40], np.uint64),
        np.asarray([49] * 6 + [39], np.uint64), wt,
        (wt == WT_PUT).astype(np.uint8),
        np.repeat(np.arange(4, dtype=np.int32), np.diff(seg_start)),
        np.asarray([3, 8, 9, 12], np.int64), seg_start, cols, [], (2, 3, 4))


def spill(planes: WritePlanes, rows: np.ndarray) -> tuple:
    """Move the cells of the PUT version rows ``rows`` out of the write
    records, as rows too long for a short value are stored (CF_DEFAULT):
    → (the planes without those cells, their ``need_default`` entries
    set; the cells as {version row: {col_id: value}}, NULLs left out)."""
    rows = np.asarray(rows, np.int64)
    if (planes.wtype[rows] != WT_PUT).any():
        raise ValueError("only a PUT's row can spill")
    defaults = {int(r): {} for r in rows}
    cols = {}
    for cid, (kind, vals, ok) in planes.cols.items():
        for r in rows.tolist():
            if ok[r]:
                defaults[r][cid] = vals[r].item()
        vals, ok = vals.copy(), ok.copy()
        vals[rows], ok[rows] = 0, False
        cols[cid] = (kind, vals, ok)
    has_payload = planes.has_payload.copy()
    has_payload[rows] = 0
    need = sorted(planes.need_default + [
        (int(r), int(planes.start_ts[r]), b"") for r in rows])
    return WritePlanes(
        planes.n_ver, planes.n_keys, planes.table_id, planes.safe_ts,
        planes.commit_ts, planes.start_ts, planes.wtype, has_payload,
        planes.seg_id, planes.handles, planes.seg_start, cols, need,
        planes.col_ids), defaults


def split_planes(planes: WritePlanes, chunk_keys: int) -> list:
    """The planes cut into chunks of at most ``chunk_keys`` keys, in key
    order (what a streamed ingest hands over chunk by chunk); their
    ``concat_planes`` is ``planes`` again."""
    out = []
    for k0 in range(0, planes.n_keys, chunk_keys):
        k1 = min(k0 + chunk_keys, planes.n_keys)
        v0, v1 = int(planes.seg_start[k0]), int(planes.seg_start[k1])
        out.append(WritePlanes(
            v1 - v0, k1 - k0, planes.table_id,
            int(planes.commit_ts[v0:v1].max()) if v1 > v0 else 0,
            planes.commit_ts[v0:v1], planes.start_ts[v0:v1],
            planes.wtype[v0:v1], planes.has_payload[v0:v1],
            planes.seg_id[v0:v1] - np.int32(k0), planes.handles[k0:k1],
            planes.seg_start[k0:k1 + 1] - np.int64(v0),
            {c: (kind, v[v0:v1], ok[v0:v1])
             for c, (kind, v, ok) in planes.cols.items()},
            [(r - v0, sts, uk) for r, sts, uk in planes.need_default
             if v0 <= r < v1], planes.col_ids))
    return out


def truth_table(table: Table, handles: np.ndarray, truth: dict,
                ets: dict) -> ColumnarTable:
    """The visible rows as a ColumnarTable; ``ets``: {col_id: EvalType}."""
    cols = {cid: Column(ets[cid], v, ok) for cid, (v, ok) in truth.items()}
    return ColumnarTable(table, handles, cols)


def random_history(rng: np.random.Generator, n_keys: int, kinds: dict,
                   n_events: int = 6, null_share: float = 0.2,
                   shares: Optional[dict] = None) -> list:
    """A base PUT of every key, then ``n_events`` commits at distinct
    timestamps of random write types over random keys (a PUT's cells
    drawn per kind, NULL on ``null_share``) → events, commit_ts from 10 in
    steps of 10.  ``shares``: {wtype: probability} of each later commit's
    type."""
    shares = shares or {WT_PUT: 0.4, WT_DELETE: 0.3, WT_LOCK: 0.15,
                        WT_ROLLBACK: 0.15}
    types = list(shares)
    probs = np.asarray([shares[t] for t in types], np.float64)

    def cells(m):
        out = {}
        for cid, kind in kinds.items():
            if kind == 1:
                v = rng.normal(0.0, 1000.0, m)
            elif kind == 3:
                v = rng.integers(0, 1 << 63, m).astype(np.uint64) * \
                    np.uint64(2) + np.uint64(1)
            else:
                v = rng.integers(-(1 << 40), 1 << 40, m)
            out[cid] = (v, rng.random(m) >= null_share)
        return out

    keys = np.arange(n_keys)
    events = [Event(10, WT_PUT, keys, cells(n_keys))]
    for i in range(n_events):
        sel = np.nonzero(rng.random(n_keys) < rng.uniform(0.05, 0.6))[0]
        wt = int(types[rng.choice(len(types), p=probs / probs.sum())])
        events.append(Event(20 + 10 * i, wt, sel,
                            cells(len(sel)) if wt == WT_PUT else None))
    return events


def segment_history(rng: np.random.Generator, lengths, kinds: dict,
                    null_share: float = 0.2) -> WritePlanes:
    """Planes of one key per entry of ``lengths``, with that many versions
    each: long segments (a hot counter row's thousands of versions) that
    ``random_history`` does not make.  A key's versions are newest first
    at commit_ts base + 10·(versions left), its base drawn from [0, 10);
    write types PUT 0.5, DELETE 0.1, LOCK 0.2, ROLLBACK 0.2; a PUT's
    cells drawn per kind, NULL on ``null_share``."""
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    seg_start = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=seg_start[1:])
    n_ver = int(seg_start[-1])
    seg_id = np.repeat(np.arange(n, dtype=np.int32), lengths)
    left = lengths[seg_id] - (np.arange(n_ver) - seg_start[seg_id])
    commit_ts = (rng.integers(0, 10, n)[seg_id] + 10 * left).astype(
        np.uint64)
    wtype = rng.choice(4, n_ver, p=[0.5, 0.1, 0.2, 0.2]).astype(np.uint8)
    put = wtype == WT_PUT
    cols = {}
    for cid, kind in kinds.items():
        if kind == 1:
            v = rng.normal(0.0, 1000.0, n_ver)
        elif kind == 3:
            v = rng.integers(0, 1 << 63, n_ver).astype(np.uint64)
        else:
            v = rng.integers(-(1 << 40), 1 << 40, n_ver)
        ok = put & (rng.random(n_ver) >= null_share)
        cols[cid] = (kind, np.where(ok, v, 0).astype(v.dtype), ok)
    start_ts = commit_ts - (wtype != WT_ROLLBACK).astype(np.uint64)
    return WritePlanes(
        n_ver, n, 0, int(commit_ts.max()) if n_ver else 0, commit_ts,
        start_ts, wtype, put.astype(np.uint8), seg_id,
        np.arange(n, dtype=np.int64) * 2 + 1, seg_start, cols, [],
        tuple(kinds))


def long_segment_planes(case: str, kinds: dict) -> tuple:
    """The long-segment histories → (planes, read_ts): ``hot_key``, one
    key of 50,000 versions among 3000 keys of 1-3; ``long_run``, a run of
    200 keys of 300 versions each among 2000 keys of 1-3.  About half of
    each long key's versions lie above read_ts."""
    rng = np.random.default_rng({"hot_key": 51, "long_run": 52}[case])
    if case == "hot_key":
        lengths = rng.integers(1, 4, 3000)
        lengths[1500] = 50_000
        return segment_history(rng, lengths, kinds), 250_000
    lengths = rng.integers(1, 4, 2000)
    lengths[500:700] = 300
    return segment_history(rng, lengths, kinds), 1500


# ---------------------------------------------------------------------------
# the chip smoke's cold-path configurations
# ---------------------------------------------------------------------------

TS_6C = 100
READ_TS_6C = 200
READ_TS_4H = 400


def table_6c() -> Table:
    """``bench.py``'s config 6 table: ``int_table(2)``, id pk and two INT
    columns."""
    return Table(9900, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("c0", 2, FieldType.long()),
        TableColumn("c1", 3, FieldType.long()),
    ))


def history_6c(n_keys: int, groups: int = configs.GROUPS) -> tuple:
    """→ (table, WritePlanes, truth handles, truth cells, read_ts)."""
    h = np.arange(n_keys, dtype=np.int64)
    ones = np.ones(n_keys, np.bool_)
    ev = Event(TS_6C, WT_PUT, h, {2: (h % groups, ones),
                                  3: (h % 1000, ones)})
    table = table_6c()
    planes, th, truth = version_history(h, [ev], {2: 0, 3: 0}, READ_TS_6C,
                                        table.table_id)
    return table, planes, th, truth, READ_TS_6C


def history_4h(n_keys: int, seed: int = 7) -> tuple:
    """→ (table, WritePlanes, truth handles, truth cells, read_ts): config
    4's table with the chosen version mix above."""
    table, snap = configs.build_table(n_keys, seed=seed)
    h = snap.handles
    k0, v0 = snap.columns[2].values, snap.columns[3].values
    del snap
    ones = np.ones(n_keys, np.bool_)
    rng = np.random.default_rng(seed + 3)

    def pick(share):
        return np.nonzero(rng.random(n_keys) < share)[0]

    def fresh(keys, null_share=0.0):
        m = len(keys)
        return {2: (rng.integers(0, configs.GROUPS, m), np.ones(m, np.bool_)),
                3: (rng.integers(-1000, 1000, m),
                    rng.random(m) >= null_share)}

    upd, dele, rb, lk, fut = (pick(0.10), pick(0.02), pick(0.01),
                              pick(0.01), pick(0.01))
    events = [Event(100, WT_PUT, h, {2: (k0, ones), 3: (v0, ones)}),
              Event(200, WT_PUT, upd, fresh(upd, 0.05)),
              Event(250, WT_ROLLBACK, rb),
              Event(260, WT_LOCK, lk),
              Event(300, WT_DELETE, dele),
              Event(500, WT_PUT, fut, fresh(fut))]
    planes, th, truth = version_history(h, events, {2: 0, 3: 0},
                                        READ_TS_4H, table.table_id)
    return table, planes, th, truth, READ_TS_4H


def planes_nbytes(planes: WritePlanes) -> int:
    """Bytes of the planes the device resolve reads (commit_ts, wtype,
    seg_start, handles, each column's values and validity)."""
    return planes.n_ver * (9 + sum(
        np.dtype(_NP_BY_KIND[k]).itemsize + 1
        for k, _v, _m in planes.cols.values())) + \
        (planes.n_keys + 1) * 8 + planes.n_keys * 8



def kv_history(table_id: int, handles: np.ndarray, events: Sequence[Event],
               locks: Sequence[tuple] = ()) -> list:
    """``events`` (over ordinals into ``handles``) as engine records →
    sorted ``(cf, engine key, value)`` triples, data prefix included.  A
    PUT's row holds its valid cells (a NULL cell is absent); start_ts =
    commit_ts − 1, a ROLLBACK's = its commit_ts.  ``locks``: (handle,
    start_ts, "put" | "delete" | "lock") pending prewrites."""
    from ..codec.keys import data_key, table_record_key
    from ..codec.row import encode_row
    from ..engine.traits import CF_LOCK, CF_WRITE
    from ..storage.txn_types import (Lock, LockType, Write, WriteType,
                                     append_ts, encode_key)
    kinds = {WT_PUT: WriteType.PUT, WT_DELETE: WriteType.DELETE,
             WT_LOCK: WriteType.LOCK, WT_ROLLBACK: WriteType.ROLLBACK}
    out = []
    for e in events:
        start = e.commit_ts if e.wtype == WT_ROLLBACK else e.commit_ts - 1
        for j, k in enumerate(np.asarray(e.keys).tolist()):
            key = encode_key(table_record_key(table_id, int(handles[k])))
            short = None
            if e.wtype == WT_PUT:
                short = encode_row({
                    cid: vals[j].item() for cid, (vals, ok) in e.cols.items()
                    if ok[j]})
            out.append((CF_WRITE, data_key(append_ts(key, e.commit_ts)),
                        Write(kinds[e.wtype], start, short).to_bytes()))
    lock_types = {"put": LockType.PUT, "delete": LockType.DELETE,
                  "lock": LockType.LOCK}
    for h, start_ts, kind in locks:
        rk = table_record_key(table_id, int(h))
        out.append((CF_LOCK, data_key(encode_key(rk)),
                    Lock(lock_types[kind], rk, int(start_ts), ttl=3000,
                         short_value=b"" if kind == "put" else None
                         ).to_bytes()))
    out.sort(key=lambda t: (t[0], t[1]))
    return out


def apply_write(engine, host, region_id: int, index: int, triples) -> list:
    """Apply ``triples`` (``kv_history``'s engine records; a value of None
    deletes the key) to ``engine`` as one entry at ``index`` and hand its
    ops to ``host``'s observers, as the apply path does
    (``notify_apply_write`` after the engine write) → the entry's
    ``WriteOp``s."""
    from ..raftstore.cmd import write_ops
    wb = engine.write_batch()
    for cf, key, value in triples:
        if value is None:
            wb.delete_cf(cf, bytes(key))
        else:
            wb.put_cf(cf, bytes(key), bytes(value))
    engine.write(wb)
    ops = write_ops(wb)
    host.notify_apply_write(region_id, index, ops)
    return ops


def apply_ingest(engine, host, region_id: int, index: int, blob) -> list:
    """Apply one SST ingest of the v2 ``blob`` to ``engine`` as the entry
    at ``index`` (``raftstore.cmd.exec_write_ops``) and hand the entry's
    one ``ingest`` op to ``host``'s observers, as the apply path does →
    the entry's ops."""
    from ..raftstore.cmd import WriteOp, exec_write_ops
    ops = [WriteOp("ingest", "", b"", blob)]
    wb = engine.write_batch()
    exec_write_ops(wb, ops)
    engine.write(wb)
    host.notify_apply_write(region_id, index, ops)
    return ops
