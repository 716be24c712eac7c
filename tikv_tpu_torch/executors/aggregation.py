"""Aggregation executors of the host pipeline.

Reference: tidb_query_executors/src/simple_aggr_executor.rs,
fast_hash_aggr_executor.rs (one key), slow_hash_aggr_executor.rs (several
keys), stream_aggr_executor.rs (input sorted by the group key).  Output
schema: the aggregate columns, then the group-by columns
(util/aggr_executor.rs).  Vectorized numpy: group keys are dictionary-
encoded per batch into global ids in first-seen order, states scatter with
``ufunc.at``.  DECIMAL arguments are outside the port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..datatype import Column, ColumnBatch, EvalType, FieldType, FieldTypeTp
from ..expr import build_rpn, eval_rpn
from .interface import BatchExecuteResult, TimedExecutor

VAR_KINDS = ("var_pop", "var_samp", "stddev_pop", "stddev_samp")
BIT_KINDS = ("bit_and", "bit_or", "bit_xor")
# MySQL BIT_AND() of zero rows is ~0 (u64 max); OR/XOR start at 0
_BIT_IDENT = {"bit_and": -1, "bit_or": 0, "bit_xor": 0}
_BIT_UFUNC = {"bit_and": np.bitwise_and, "bit_or": np.bitwise_or,
              "bit_xor": np.bitwise_xor}


def _bit_int64(values):
    """BIT_* operand coercion: a REAL rounds half away from zero before
    the bit op (impl_bit_op.rs casts through u64): ``rint``, with exact .5
    fractions moved away from zero."""
    if values.dtype.kind == "f":
        r = np.rint(values)
        frac = values - np.trunc(values)
        ties = np.abs(frac) == 0.5
        r = np.where(ties, np.trunc(values) + np.copysign(1.0, values), r)
        return r.astype(np.int64)
    return values.astype(np.int64)


def var_arrays(kind: str, s, sq, c):
    """Variance finalize over per-group moments → (values f64, validity):
    ``*_pop`` NULL when count = 0, ``*_samp`` NULL when count < 2."""
    s = np.asarray(s, np.float64)
    sq = np.asarray(sq, np.float64)
    c = np.asarray(c, np.float64)
    samp = kind in ("var_samp", "stddev_samp")
    validity = c >= (2 if samp else 1)
    cd = np.where(validity, c, 1.0)
    denom = cd - 1 if samp else cd
    var = np.maximum(0.0, (sq - s * s / cd) /
                     np.where(validity, denom, 1.0))
    if kind.startswith("stddev"):
        var = np.sqrt(var)
    return np.where(validity, var, 0.0), validity


def agg_ret_ft(kind: str, arg_et: Optional[EvalType]) -> FieldType:
    """Output field type of an aggregate: COUNT a NOT NULL BIGINT; BIT_*
    a NOT NULL unsigned BIGINT; MIN/MAX/FIRST keep a time argument's type;
    AVG and the variances DOUBLE; else the argument's type."""
    if kind in ("count", "count_star"):
        return FieldType.long(not_null=True)
    if kind in BIT_KINDS:
        return FieldType.long(unsigned=True, not_null=True)
    if kind in ("min", "max", "first"):
        if arg_et is EvalType.DATETIME:
            return FieldType(tp=FieldTypeTp.DATETIME)
        if arg_et is EvalType.DURATION:
            return FieldType(tp=FieldTypeTp.DURATION)
    if kind == "avg" or kind in VAR_KINDS or arg_et is EvalType.REAL:
        return FieldType.double()
    if arg_et is EvalType.BYTES:
        return FieldType.var_char()
    return FieldType.long()


class _AggState:
    """Per-group growable state arrays of one aggregate."""

    def __init__(self, kind: str, et: Optional[EvalType]):
        if et is EvalType.DECIMAL:
            raise NotImplementedError("DECIMAL aggregates are outside the "
                                      "port")
        self.kind = kind
        self.et = et
        if et is EvalType.REAL:
            dtype = np.float64
        elif et in (EvalType.DATETIME, EvalType.ENUM, EvalType.SET):
            # unsigned cores: mixing them with int64 identities would
            # promote to float64
            dtype = np.uint64
        else:
            dtype = np.int64
        # BYTES compare as python objects, row by row
        self.obj = et is EvalType.BYTES
        self.sum = np.zeros(0, dtype=dtype) if not self.obj else None
        self.count = np.zeros(0, dtype=np.int64)
        if kind in ("min", "max"):
            if self.obj:
                self.vals: list = []
            else:
                if dtype == np.float64:
                    ident = np.inf if kind == "min" else -np.inf
                else:
                    info = np.iinfo(dtype)
                    ident = info.max if kind == "min" else info.min
                self.ident = dtype(ident)
                self.vals = np.zeros(0, dtype=dtype)
        if kind == "first":
            self.first_vals: list = []
            self.first_set: list = []
        if kind in VAR_KINDS:
            self.sum = np.zeros(0, dtype=np.float64)
            self.sumsq = np.zeros(0, dtype=np.float64)
        if kind in BIT_KINDS:
            self.bit_ident = np.int64(_BIT_IDENT[kind])
            self.bits = np.zeros(0, dtype=np.int64)

    def grow(self, n_groups: int):
        extra = n_groups - len(self.count)
        if extra <= 0:
            return
        self.count = np.concatenate([self.count, np.zeros(extra, np.int64)])
        if self.sum is not None:
            self.sum = np.concatenate([self.sum,
                                       np.zeros(extra, self.sum.dtype)])
        if self.kind in ("min", "max"):
            if self.obj:
                self.vals.extend([None] * extra)
            else:
                self.vals = np.concatenate(
                    [self.vals, np.full(extra, self.ident, self.vals.dtype)])
        if self.kind == "first":
            self.first_vals.extend([None] * extra)
            self.first_set.extend([False] * extra)
        if self.kind in VAR_KINDS:
            self.sumsq = np.concatenate(
                [self.sumsq, np.zeros(extra, np.float64)])
        if self.kind in BIT_KINDS:
            self.bits = np.concatenate(
                [self.bits, np.full(extra, self.bit_ident, np.int64)])

    def keep_only(self, idx: int) -> None:
        """Retain only group ``idx`` (stream agg emitted the rest)."""
        sl = slice(idx, idx + 1)
        self.count = self.count[sl].copy()
        if self.sum is not None:
            self.sum = self.sum[sl].copy()
        if self.kind in ("min", "max"):
            self.vals = self.vals[sl] if self.obj else self.vals[sl].copy()
        if self.kind == "first":
            self.first_vals = self.first_vals[sl]
            self.first_set = self.first_set[sl]
        if self.kind in VAR_KINDS:
            self.sumsq = self.sumsq[sl].copy()
        if self.kind in BIT_KINDS:
            self.bits = self.bits[sl].copy()

    def update(self, gids: np.ndarray, values, validity):
        """Scatter one batch into the group states."""
        kind = self.kind
        if kind == "count_star":
            np.add.at(self.count, gids, 1)
            return
        ok = validity
        oki = ok.astype(np.int64)
        if kind == "count":
            np.add.at(self.count, gids, oki)
        elif kind in ("sum", "avg"):
            np.add.at(self.count, gids, oki)
            masked = np.where(ok, values, 0).astype(self.sum.dtype)
            np.add.at(self.sum, gids, masked)
        elif kind in ("min", "max"):
            np.add.at(self.count, gids, oki)
            if self.obj:
                for g, v, o in zip(gids, values, ok):
                    if o:
                        cur = self.vals[g]
                        if cur is None or (v < cur if kind == "min"
                                           else v > cur):
                            self.vals[g] = v
            else:
                filled = np.where(ok, values, self.ident)
                (np.minimum if kind == "min" else np.maximum).at(
                    self.vals, gids, filled)
        elif kind == "first":
            for g, v, o in zip(gids, values, ok):
                if not self.first_set[g]:
                    self.first_set[g] = True
                    self.first_vals[g] = (v.item() if hasattr(v, "item")
                                          else v) if o else None
        elif kind in VAR_KINDS:
            np.add.at(self.count, gids, oki)
            v64 = np.where(ok, values.astype(np.float64), 0.0)
            np.add.at(self.sum, gids, v64)
            np.add.at(self.sumsq, gids, v64 * v64)
        elif kind in BIT_KINDS:
            filled = np.where(ok, _bit_int64(values), self.bit_ident)
            _BIT_UFUNC[kind].at(self.bits, gids, filled)
        else:
            raise ValueError(kind)

    def finalize_column(self, n_groups: int) -> Column:
        kind = self.kind
        if kind in ("count", "count_star"):
            return Column.from_values(EvalType.INT,
                                      self.count[:n_groups].copy())
        if kind == "sum":
            validity = self.count[:n_groups] > 0
            et = EvalType.REAL if self.sum.dtype == np.float64 \
                else EvalType.INT
            return Column(et, self.sum[:n_groups].copy(), validity)
        if kind == "avg":
            validity = self.count[:n_groups] > 0
            denom = np.maximum(self.count[:n_groups], 1)
            return Column(EvalType.REAL, self.sum[:n_groups] / denom,
                          validity)
        if kind in ("min", "max"):
            validity = self.count[:n_groups] > 0
            if self.obj:
                return Column.from_list(self.et, self.vals[:n_groups])
            vals = np.where(validity, self.vals[:n_groups], 0)
            if self.et in (EvalType.DATETIME, EvalType.DURATION,
                           EvalType.ENUM, EvalType.SET):
                et = self.et
            elif vals.dtype == np.float64:
                et = EvalType.REAL
            else:
                et = EvalType.INT
            return Column(et, vals.astype(self.vals.dtype), validity)
        if kind == "first":
            return Column.from_list(self.et or EvalType.INT,
                                    self.first_vals[:n_groups])
        if kind in VAR_KINDS:
            var, validity = var_arrays(kind, self.sum[:n_groups],
                                       self.sumsq[:n_groups],
                                       self.count[:n_groups])
            return Column(EvalType.REAL, var, validity)
        if kind in BIT_KINDS:
            return Column.from_list(
                EvalType.INT, [b & 0xFFFFFFFFFFFFFFFF
                               for b in self.bits[:n_groups].tolist()],
                unsigned=True)
        raise ValueError(kind)


def _appearance_order(inverse: np.ndarray, local_keys: list, n: int):
    """Remap batch-local ids (in VALUE order from the int/float paths) to
    first-seen input order, as the reference's hashmaps assign them."""
    k = len(local_keys)
    if k <= 1:
        return inverse, local_keys
    first_pos = np.full(k, n, dtype=np.int64)
    np.minimum.at(first_pos, inverse, np.arange(n, dtype=np.int64))
    order = np.argsort(first_pos, kind="stable")
    rank = np.empty(k, dtype=np.int64)
    rank[order] = np.arange(k, dtype=np.int64)
    return rank[inverse], [local_keys[j] for j in order]


def _local_ids(key_cols: list, n: int):
    """Batch-local dictionary encode → (inverse, local key tuples,
    value_ordered)."""
    if len(key_cols) == 1 and key_cols[0][0].dtype.kind in "iu":
        v, ok = key_cols[0]
        any_null = not ok.all()
        valid = v[ok] if any_null else v
        if valid.size == 0:
            return np.zeros(n, dtype=np.int64), [(None,)], False
        m = int(valid.min())
        span = int(valid.max()) - m + 1
        if span <= 4 * n:
            # dense key domain: direct-index encode, no sort
            idx = np.where(ok, v - m, span) if any_null else v - m
            seen = np.zeros(span + (2 if any_null else 1), np.bool_)
            seen[idx] = True
            local_of = np.cumsum(seen, dtype=np.int64) - 1
            uniq_off = np.flatnonzero(seen[:span])
            # keys in v's dtype: a uint64 domain above 2^63 overflows
            uniq_vals = uniq_off.astype(v.dtype) + v.dtype.type(m)
            keys = [(x,) for x in uniq_vals.tolist()]
            if any_null and seen[span]:
                keys.append((None,))
            return local_of[idx], keys, True
        uniq, inv_valid = np.unique(valid, return_inverse=True)
        keys = [(x,) for x in uniq.tolist()]
        if any_null:
            inverse = np.full(n, len(keys), np.int64)
            inverse[ok] = inv_valid
            keys.append((None,))
        else:
            inverse = inv_valid.astype(np.int64, copy=False)
        return inverse, keys, True
    if len(key_cols) == 1 and key_cols[0][0].dtype.kind == "f":
        v, ok = key_cols[0]
        uniq, inverse = np.unique(
            np.stack([np.where(ok, v, 0), ok.astype(v.dtype)]),
            axis=1, return_inverse=True)
        keys = [((uniq[0, j].item() if uniq[1, j] else None),)
                for j in range(uniq.shape[1])]
        return inverse.reshape(-1), keys, True
    rows = list(zip(*[
        [vv.item() if o and hasattr(vv, "item") else (vv if o else None)
         for vv, o in zip(v, ok)] for v, ok in key_cols]))
    index: dict = {}
    inverse = np.empty(n, dtype=np.int64)
    keys = []
    for i, key in enumerate(rows):
        j = index.get(key)
        if j is None:
            j = index[key] = len(keys)
            keys.append(key)
        inverse[i] = j
    return inverse, keys, False


class GroupKeyEncoder:
    """Dictionary-encodes group (or partition) key expressions into
    global group ids in first-seen order; shared by the hash aggregations
    and ``BatchPartitionTopNExecutor``."""

    def __init__(self, group_rpns):
        self.rpns = group_rpns
        self.index: dict = {}       # key tuple -> group id
        self.keys: list = []        # group id -> key tuple

    def gids(self, batch: ColumnBatch) -> np.ndarray:
        n = batch.num_rows
        cols = [(c.values, c.validity) for c in batch.columns]
        key_cols = []
        for rpn in self.rpns:
            v, ok = eval_rpn(rpn, cols, n, np)
            key_cols.append((np.broadcast_to(v, (n,)),
                             np.broadcast_to(ok, (n,))))
        inverse, local_keys, value_ordered = _local_ids(key_cols, n)
        if value_ordered:
            inverse, local_keys = _appearance_order(inverse, local_keys, n)
        l2g = np.empty(len(local_keys), dtype=np.int64)
        for j, key in enumerate(local_keys):
            g = self.index.get(key)
            if g is None:
                g = self.index[key] = len(self.keys)
                self.keys.append(key)
            l2g[j] = g
        return l2g[inverse]


class _HashAggBase(TimedExecutor):
    """Dictionary-encode the group keys per batch, scatter into growable
    per-group states, emit on drain."""

    def __init__(self, child, desc):
        super().__init__()
        self._child = child
        self._desc = desc
        self._group_rpns = [build_rpn(e) for e in desc.group_by]
        self._agg_rpns = [build_rpn(a.arg) if a.arg is not None else None
                          for a in desc.aggs]
        arg_ets = [r.ret_type if r else None for r in self._agg_rpns]
        self._states = [_AggState(a.kind, et)
                        for a, et in zip(desc.aggs, arg_ets)]
        self._enc = GroupKeyEncoder(self._group_rpns)
        self._done = False
        group_fts = [FieldType.double() if r.ret_type is EvalType.REAL
                     else FieldType.var_char()
                     if r.ret_type is EvalType.BYTES else FieldType.long()
                     for r in self._group_rpns]
        self._schema = [agg_ret_ft(a.kind, et)
                        for a, et in zip(desc.aggs, arg_ets)] + group_fts

    @property
    def schema(self) -> list[FieldType]:
        return self._schema

    def _update(self, batch: ColumnBatch):
        n = batch.num_rows
        if n == 0 and self._desc.group_by:
            return
        gids = self._enc.gids(batch) if self._desc.group_by else \
            np.zeros(n, dtype=np.int64)
        if n:
            # the group still receiving rows (stream agg keeps it)
            self._last_gid = int(gids[-1])
        if not self._desc.group_by and not self._enc.keys:
            self._enc.keys.append(())
        n_groups = len(self._enc.keys)
        cols = [(c.values, c.validity) for c in batch.columns]
        for st, rpn in zip(self._states, self._agg_rpns):
            st.grow(n_groups)
            if rpn is None:
                st.update(gids, None, None)
            else:
                v, ok = eval_rpn(rpn, cols, n, np)
                st.update(gids, np.broadcast_to(v, (n,)),
                          np.broadcast_to(ok, (n,)))

    def _emit(self) -> ColumnBatch:
        n_groups = len(self._enc.keys)
        agg_cols = [st.finalize_column(n_groups) for st in self._states]
        group_cols = [Column.from_list(rpn.ret_type,
                                       [key[k] for key in self._enc.keys])
                      for k, rpn in enumerate(self._group_rpns)]
        return ColumnBatch(self._schema, agg_cols + group_cols)

    def _next_batch(self, scan_rows: int) -> BatchExecuteResult:
        # one child batch per call, so the runner's batch growth reaches
        # the scan below
        if self._done:
            return BatchExecuteResult(ColumnBatch.empty(self._schema), True)
        r = self._child.next_batch(scan_rows)
        self._update(r.batch)
        if r.is_drained:
            self._done = True
            return BatchExecuteResult(self._emit(), True, r.warnings)
        return BatchExecuteResult(ColumnBatch.empty(self._schema), False,
                                  r.warnings)


class BatchFastHashAggExecutor(_HashAggBase):
    """Reference: fast_hash_aggr_executor.rs — one group-by key."""


class BatchSlowHashAggExecutor(_HashAggBase):
    """Reference: slow_hash_aggr_executor.rs — several group keys."""


class BatchSimpleAggExecutor(_HashAggBase):
    """Reference: simple_aggr_executor.rs — no GROUP BY; exactly one
    output row even for empty input (COUNT() = 0, SUM() = NULL)."""

    def _next_batch(self, scan_rows: int) -> BatchExecuteResult:
        if self._done:
            return BatchExecuteResult(ColumnBatch.empty(self._schema), True)
        if not self._enc.keys:
            self._enc.keys.append(())
        r = self._child.next_batch(scan_rows)
        self._update(r.batch)
        if r.is_drained:
            self._done = True
            for st in self._states:
                st.grow(1)
            return BatchExecuteResult(self._emit(), True, r.warnings)
        return BatchExecuteResult(ColumnBatch.empty(self._schema), False,
                                  r.warnings)


class BatchStreamAggExecutor(_HashAggBase):
    """Reference: stream_aggr_executor.rs — input sorted by the group key:
    every group but the one still receiving rows is complete at each batch
    boundary and streams out, so the state holds O(1) groups.  Sortedness
    is the plan's contract."""

    def _flush_completed(self) -> ColumnBatch:
        keep = self._last_gid
        done = np.array([g for g in range(len(self._enc.keys))
                         if g != keep], dtype=np.int64)
        out = self._emit().take(done)
        kept_key = self._enc.keys[keep]
        for st in self._states:
            st.keep_only(keep)
        self._enc.keys = [kept_key]
        self._enc.index = {kept_key: 0}
        self._last_gid = 0
        return out

    def _next_batch(self, scan_rows: int) -> BatchExecuteResult:
        if self._done:
            return BatchExecuteResult(ColumnBatch.empty(self._schema), True)
        r = self._child.next_batch(scan_rows)
        self._update(r.batch)
        if r.is_drained:
            self._done = True
            return BatchExecuteResult(self._emit(), True, r.warnings)
        if len(self._enc.keys) > 1:
            return BatchExecuteResult(self._flush_completed(), False,
                                      r.warnings)
        return BatchExecuteResult(ColumnBatch.empty(self._schema), False,
                                  r.warnings)
