"""TopN executors of the host pipeline.

Reference: tidb_query_executors/src/top_n_executor.rs — a k-sized heap of
rows ordered by the ORDER BY expressions.  Vectorized: per batch, evaluate
the sort keys, concatenate with the running k candidates, lexsort, keep k.
NULLs sort first ASC / last DESC (MySQL), ties by arrival order (stable,
like the reference's heap).  BYTES keys take a comparison sort over the
bounded candidate set.
"""

from __future__ import annotations

import functools

import numpy as np

from ..datatype import ColumnBatch, EvalType, FieldType
from ..expr import build_rpn, eval_rpn
from .interface import BatchExecuteResult, TimedExecutor


def eval_order_keys(rpns, batch: ColumnBatch) -> list[tuple]:
    """Evaluate ORDER BY expressions over one batch → per-key
    (values, validity) pairs broadcast to row length."""
    n = batch.num_rows
    cols = [(c.values, c.validity) for c in batch.columns]
    keys = []
    for rpn in rpns:
        v, ok = eval_rpn(rpn, cols, n, np)
        keys.append((np.broadcast_to(v, (n,)), np.broadcast_to(ok, (n,))))
    return keys


def order_indices(keys, descs, seq, gids=None) -> np.ndarray:
    """Stable best-first ordering over a candidate set.

    ``keys``: per ORDER BY column (values, validity); ``descs``: per-key
    DESC flags; ``seq``: arrival order (tie break). ``gids``, when given,
    sorts ascending as the most-significant key (partition grouping).
    NULLs sort first ASC / last DESC (MySQL).
    """
    has_obj = any(v.dtype == np.dtype(object) for v, _ in keys)
    if not has_obj:
        lex: list[np.ndarray] = [seq]
        for (v, ok), desc in zip(reversed(keys), reversed(descs)):
            if v.dtype.kind in "iu":
                # exact int ordering (f64 would collapse above 2^53);
                # reserve int64 min as the NULL sentinel
                iv = np.maximum(v.astype(np.int64, copy=False),
                                np.iinfo(np.int64).min + 2)
                if desc:
                    lex.append(np.where(ok, -iv, np.iinfo(np.int64).max))
                else:
                    lex.append(np.where(ok, iv, np.iinfo(np.int64).min))
                continue
            fv = v.astype(np.float64, copy=False)
            if desc:
                lex.append(np.where(ok, -fv, np.inf))   # NULL last
            else:
                lex.append(np.where(ok, fv, -np.inf))   # NULL first
        if gids is not None:
            lex.append(gids)
        return np.lexsort(tuple(lex))

    n = len(seq)

    def cmp(i: int, j: int) -> int:
        if gids is not None and gids[i] != gids[j]:
            return -1 if gids[i] < gids[j] else 1
        for (v, ok), desc in zip(keys, descs):
            a_null, b_null = not ok[i], not ok[j]
            if a_null or b_null:
                if a_null and b_null:
                    continue
                # ASC: NULL first (NULL is "smaller"); DESC: NULL last
                null_wins = not desc
                if a_null:
                    return -1 if null_wins else 1
                return 1 if null_wins else -1
            a, b = v[i], v[j]
            if a == b:
                continue
            lt = a < b
            if desc:
                lt = not lt
            return -1 if lt else 1
        return -1 if seq[i] < seq[j] else 1

    return np.asarray(sorted(range(n), key=functools.cmp_to_key(cmp)),
                      dtype=np.int64)


class BatchTopNExecutor(TimedExecutor):
    def __init__(self, child, desc):
        super().__init__()
        self._child = child
        self._desc = desc
        self._rpns = [build_rpn(e) for e, _ in desc.order_by]
        self._descs = [d for _, d in desc.order_by]
        self._k = desc.limit
        self._cand: ColumnBatch | None = None
        self._cand_keys: list | None = None   # per ORDER BY: (values, validity)
        self._cand_seq: np.ndarray | None = None
        self._next_seq = 0
        self._done = False

    @property
    def schema(self) -> list[FieldType]:
        return self._child.schema

    def _eval_keys(self, batch: ColumnBatch) -> list[tuple]:
        return eval_order_keys(self._rpns, batch)

    def _order(self, keys: list[tuple], seq: np.ndarray) -> np.ndarray:
        """Indices of the best-first ordering over the candidate set."""
        return order_indices(keys, self._descs, seq)[:self._k]

    def _fold(self, batch: ColumnBatch):
        if batch.num_rows == 0:
            return
        keys = self._eval_keys(batch)
        seq = np.arange(self._next_seq, self._next_seq + batch.num_rows,
                        dtype=np.int64)
        self._next_seq += batch.num_rows
        if self._cand is None:
            cand, ckeys, cseq = batch, keys, seq
        else:
            cand = ColumnBatch.concat([self._cand, batch])
            ckeys = [(np.concatenate([av, bv]), np.concatenate([am, bm]))
                     for (av, am), (bv, bm) in zip(self._cand_keys, keys)]
            cseq = np.concatenate([self._cand_seq, seq])
        order = self._order(ckeys, cseq)
        self._cand = cand.take(order)
        self._cand_keys = [(v[order], ok[order]) for v, ok in ckeys]
        self._cand_seq = cseq[order]

    def _next_batch(self, scan_rows: int) -> BatchExecuteResult:
        # one child batch per call so the runner's batch growth reaches
        # the scan below (see _HashAggBase._next_batch)
        if self._done:
            return BatchExecuteResult(ColumnBatch.empty(self.schema), True)
        r = self._child.next_batch(scan_rows)
        self._fold(r.batch)
        if r.is_drained:
            self._done = True
            out = self._cand if self._cand is not None \
                else ColumnBatch.empty(self.schema)
            return BatchExecuteResult(out, True, r.warnings)
        return BatchExecuteResult(ColumnBatch.empty(self.schema), False,
                                  r.warnings)


class BatchPartitionTopNExecutor(TimedExecutor):
    """Per-partition TopN — reference:
    tidb_query_executors/src/partition_top_n_executor.rs.

    The reference requires input grouped by the partition columns and
    flushes a heap at each partition-prefix change; this implementation
    dictionary-encodes partition keys (GroupKeyEncoder — same machinery
    as hash agg) so the result is correct for ANY input order, a strict
    superset of the reference contract. Per fold the candidate set is
    sorted by (partition id, order keys) in one lexsort and cut to the
    first k rows of each partition with a vectorized rank filter, so the
    retained state is O(P·k) rows.

    Output: partitions in first-seen order, rows best-first within each
    partition (the reference emits partitions in input order the same
    way)."""

    def __init__(self, child, desc):
        super().__init__()
        from .aggregation import GroupKeyEncoder
        self._child = child
        self._desc = desc
        self._enc = GroupKeyEncoder([build_rpn(e)
                                     for e in desc.partition_by])
        self._rpns = [build_rpn(e) for e, _ in desc.order_by]
        self._descs = [d for _, d in desc.order_by]
        self._k = desc.limit
        self._cand: ColumnBatch | None = None
        self._cand_keys: list | None = None
        self._cand_gids: np.ndarray | None = None
        self._cand_seq: np.ndarray | None = None
        self._next_seq = 0
        self._done = False

    @property
    def schema(self) -> list[FieldType]:
        return self._child.schema

    def _eval_keys(self, batch: ColumnBatch) -> list[tuple]:
        return eval_order_keys(self._rpns, batch)

    def _fold(self, batch: ColumnBatch):
        if batch.num_rows == 0 or self._k == 0:
            return
        keys = self._eval_keys(batch)
        gids = self._enc.gids(batch)
        seq = np.arange(self._next_seq, self._next_seq + batch.num_rows,
                        dtype=np.int64)
        self._next_seq += batch.num_rows
        if self._cand is None:
            cand, ckeys, cgids, cseq = batch, keys, gids, seq
        else:
            cand = ColumnBatch.concat([self._cand, batch])
            ckeys = [(np.concatenate([av, bv]), np.concatenate([am, bm]))
                     for (av, am), (bv, bm) in zip(self._cand_keys, keys)]
            cgids = np.concatenate([self._cand_gids, gids])
            cseq = np.concatenate([self._cand_seq, seq])
        order = order_indices(ckeys, self._descs, cseq, gids=cgids)
        g_sorted = cgids[order]
        m = len(order)
        pos = np.arange(m, dtype=np.int64)
        new_grp = np.empty(m, dtype=bool)
        new_grp[0] = True
        new_grp[1:] = g_sorted[1:] != g_sorted[:-1]
        start = np.maximum.accumulate(np.where(new_grp, pos, 0))
        keep = order[pos - start < self._k]
        self._cand = cand.take(keep)
        self._cand_keys = [(v[keep], ok[keep]) for v, ok in ckeys]
        self._cand_gids = cgids[keep]
        self._cand_seq = cseq[keep]

    def _next_batch(self, scan_rows: int) -> BatchExecuteResult:
        if self._done:
            return BatchExecuteResult(ColumnBatch.empty(self.schema), True)
        r = self._child.next_batch(scan_rows)
        self._fold(r.batch)
        if r.is_drained:
            self._done = True
            out = self._cand if self._cand is not None \
                else ColumnBatch.empty(self.schema)
            return BatchExecuteResult(out, True, r.warnings)
        return BatchExecuteResult(ColumnBatch.empty(self.schema), False,
                                  r.warnings)
