"""Device coprocessor backend — the aggregation path on one CUDA device.

Counterpart of the JAX package's ``device/runner.py`` ``DeviceRunner``,
reduced to its single-device, synchronous aggregation path.  A DAG
request of the form TableScan → Selection* → Aggregation (COUNT/SUM/AVG,
at most one INT GROUP BY key) over a columnar snapshot runs as:

- the used columns are uploaded once per snapshot as a padded feed that
  stays on the device (``_pad_rows``/``_build_flat``, the reference's
  feed buckets, so feed shapes line up with the reference);
- the selection predicates and any computed key/argument expressions
  are evaluated by ``eval_rpn`` over torch tensors on the device;
- one ``hash_agg`` pass (the CUDA kernel, ``csrc/hash_agg.cu``) turns
  every live row into its slot's int64 states, in ``simple``, ``dense``
  or ``sparse`` mode (host dictionary-encoded keys, cached per snapshot);
- the states come back in one transfer and the host finalizes them.

Cases outside this slice are refused, never served elsewhere: plans
(``supports`` is False; ``handle_request`` raises NotImplementedError) and
data outside the kernel's gate (NULLs or int64 values in a kernel input,
more than ``hash_agg.MAX_SLOTS`` slots; ``handle_request`` raises
NotImplementedError).  Each refusal names the ROADMAP.md item that will
serve it.  An empty scan gets the finalize of empty states.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..copr.dag import (AggregationDesc, DAGRequest, SelectionDesc,
                        TableScanDesc)
from ..datatype import Column, ColumnBatch, EvalType, FieldType
from ..datatype.tile import _device_dtype
from ..executors.result import SelectResult, _agg_ret_ft
from ..expr import FUNCTIONS, build_rpn, eval_rpn
from ..expr.rpn import RpnColumnRef, RpnConst, RpnExpression, RpnFnCall
from ..ops.agg import AggSpec, finalize_hash, finalize_simple
from . import hash_agg as ha
from . import resolve_device

_DEVICE_ETS = (EvalType.INT, EvalType.REAL)
_SLICE_AGGS = ("count", "count_star", "sum", "avg")

# where each case outside this slice is to be served (ROADMAP.md, queue 1)
_TODO_EXPR = "ROADMAP.md queue 1 item 2 (device expression families)"
_TODO_AGG = "ROADMAP.md queue 1 item 3 (aggregation outside the kernel gate)"
_TODO_ROUTES = ("ROADMAP.md queue 1 item 5 (selection, top-k and "
                "index-scan routes)")
_TODO_STORAGE = "ROADMAP.md queue 1 item 6 (production read path)"


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _rpn_col_indices(rpn: RpnExpression) -> set:
    return {n.col_idx for n in rpn.nodes if isinstance(n, RpnColumnRef)}


def _remap_rpn(rpn: RpnExpression, mapping: dict) -> RpnExpression:
    return RpnExpression(tuple(
        RpnColumnRef(mapping[n.col_idx], n.eval_type)
        if isinstance(n, RpnColumnRef) else n for n in rpn.nodes))


def _rpn_device_safe(rpn: RpnExpression, scan_ets: Sequence[EvalType]) -> bool:
    for n in rpn.nodes:
        if isinstance(n, RpnConst):
            if n.value is not None and \
                    not isinstance(n.value, (int, float, bool)):
                return False
        elif isinstance(n, RpnColumnRef):
            if n.col_idx >= len(scan_ets) or \
                    scan_ets[n.col_idx] not in _DEVICE_ETS:
                return False
        elif isinstance(n, RpnFnCall):
            if n.meta.ret not in _DEVICE_ETS:
                return False
    return True


def _expr_sigs(e) -> set:
    out, stack = set(), [e]
    while stack:
        x = stack.pop()
        if x.kind == "call":
            out.add(x.sig)
        stack.extend(x.children)
    return out


def _bare_col(rpn: Optional[RpnExpression]) -> Optional[int]:
    if rpn is not None and len(rpn.nodes) == 1 and \
            isinstance(rpn.nodes[0], RpnColumnRef):
        return rpn.nodes[0].col_idx
    return None


@dataclass
class _Plan:
    """Analyzed plan (rpns remapped onto ``used_cols`` positions)."""

    scan: TableScanDesc
    kind: str                        # simple_agg | hash_agg
    used_cols: list                  # scan column offsets shipped to device
    sel_rpns: list = field(default_factory=list)
    specs: list = field(default_factory=list)        # AggSpec per agg
    agg_rpns: list = field(default_factory=list)     # RpnExpression | None
    key_rpn: Optional[RpnExpression] = None


class DeviceRunner:
    """Executes the slice's aggregation plans on one device.

    ``device``: ``None`` (``cuda:0``), a CUDA device, or ``"cpu"`` — the
    plain PyTorch version of every kernel, which the tests use.  Without
    CUDA, only ``"cpu"`` constructs.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._block_local = ha.BLOCK
        # plan_key → (plan | None, refusal reason); FIFO-bounded
        self._plan_cache: dict = {}
        self._plan_cache_max = 4096
        # snapshot → {"feeds": {feed_key: feed}, "meta": {meta_key: dict}};
        # entries die with their snapshot
        self._snaps: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    # ---------------------------------------------------------------- plan

    def supports(self, dag: DAGRequest) -> bool:
        return self._analyze(dag)[0] is not None

    def _analyze(self, dag: DAGRequest) -> tuple:
        key = dag.plan_key()
        got = self._plan_cache.get(key)
        if got is None:
            got = self._analyze_uncached(dag)
            if len(self._plan_cache) >= self._plan_cache_max:
                self._plan_cache.pop(next(iter(self._plan_cache)))
            self._plan_cache[key] = got
        return got

    def _analyze_uncached(self, dag: DAGRequest) -> tuple:
        execs = dag.executors
        if not execs or not isinstance(execs[0], TableScanDesc):
            return None, f"plan does not start with a TableScan: {_TODO_ROUTES}"
        scan = execs[0]
        scan_ets = [c.field_type.eval_type for c in scan.columns]
        sel_exprs: list = []
        terminal = None
        for d in execs[1:]:
            if isinstance(d, SelectionDesc) and terminal is None:
                sel_exprs.extend(d.conditions)
            elif isinstance(d, AggregationDesc) and terminal is None:
                terminal = d
            else:
                return None, f"{type(d).__name__} in the plan: {_TODO_ROUTES}"
        if terminal is None:
            return None, f"scan without aggregation: {_TODO_ROUTES}"
        if len(terminal.group_by) > 1:
            return None, f"multi-key GROUP BY: {_TODO_AGG}"
        for a in terminal.aggs:
            if a.kind not in _SLICE_AGGS:
                return None, f"{a.kind.upper()} aggregate: {_TODO_AGG}"
        exprs = sel_exprs + [a.arg for a in terminal.aggs
                             if a.arg is not None] + list(terminal.group_by)
        unknown = set().union(*map(_expr_sigs, exprs)) - set(FUNCTIONS) \
            if exprs else set()
        if unknown:
            return None, f"functions {sorted(unknown)}: {_TODO_EXPR}"

        sel_rpns = [build_rpn(e) for e in sel_exprs]
        agg_rpns, specs = [], []
        for i, a in enumerate(terminal.aggs):
            if a.arg is None:
                agg_rpns.append(None)
                specs.append(AggSpec(a.kind, i))
                continue
            r = build_rpn(a.arg)
            if a.kind in ("sum", "avg") and r.ret_type is EvalType.REAL:
                return None, f"{a.kind.upper()} over REAL: {_TODO_AGG}"
            agg_rpns.append(r)
            specs.append(AggSpec(a.kind, i, r.ret_type))
        key_rpn = None
        if terminal.group_by:
            key_rpn = build_rpn(terminal.group_by[0])
            if key_rpn.ret_type is not EvalType.INT:
                return None, f"non-INT GROUP BY key: {_TODO_AGG}"
        inputs = sel_rpns + [r for r in agg_rpns if r is not None]
        rpns = inputs + ([key_rpn] if key_rpn is not None else [])
        for r in rpns:
            if not _rpn_device_safe(r, scan_ets):
                return None, f"non-numeric column or constant: {_TODO_AGG}"
        # selection and aggregate inputs are always kernel inputs, and a
        # REAL column is never int32 on the device
        for r in inputs:
            if any(scan_ets[i] is not EvalType.INT
                   for i in _rpn_col_indices(r)):
                return None, f"REAL column as a kernel input: {_TODO_AGG}"

        used = sorted(set().union(*map(_rpn_col_indices, rpns))) \
            if rpns else []
        mapping = {old: new for new, old in enumerate(used)}
        return _Plan(
            scan=scan,
            kind="hash_agg" if key_rpn is not None else "simple_agg",
            used_cols=used,
            sel_rpns=[_remap_rpn(r, mapping) for r in sel_rpns],
            specs=specs,
            agg_rpns=[None if r is None else _remap_rpn(r, mapping)
                      for r in agg_rpns],
            key_rpn=None if key_rpn is None else _remap_rpn(key_rpn, mapping),
        ), ""

    # ---------------------------------------------------------------- feed

    def _pad_rows(self, n: int) -> int:
        unit = self._block_local
        blocks = max(1, -(-n // unit))
        # bucket the block count into the reference's 9/8-geometric grid
        # (one block of growth headroom first, then a 4-significant-bit
        # count k·2^s, 8 ≤ k ≤ 15), so feed shapes match its feeds
        if blocks > 8:
            blocks += 1
            s = blocks.bit_length() - 4
            k = -(-blocks // (1 << s))
            if k > 15:
                s += 1
                k = -(-blocks // (1 << s))
            blocks = k << s
        return blocks * unit

    def _upload(self, arr: np.ndarray, n_pad: int) -> torch.Tensor:
        # pad on the host: one copy, then one H2D transfer
        p = np.zeros(n_pad, dtype=arr.dtype)
        p[:len(arr)] = arr
        return torch.from_numpy(p).to(self.device)

    def _build_flat(self, host_cols, n: int) -> dict:
        """→ {"flat": device tensors, "null_flags": per-col bool, "n_pad"}.

        One flat padded tensor per column value; a validity tensor only
        for columns that actually contain NULLs."""
        n_pad = self._pad_rows(n)
        flat, flags = [], []
        for v, ok in host_cols:
            flat.append(self._upload(v, n_pad))
            has_nulls = not bool(ok.all())
            flags.append(has_nulls)
            if has_nulls:
                flat.append(self._upload(ok, n_pad))
        return {"flat": tuple(flat), "null_flags": tuple(flags),
                "n_pad": n_pad}

    def _snap(self, storage) -> dict:
        st = self._snaps.get(storage)
        if st is None:
            st = self._snaps[storage] = {"feeds": {}, "meta": {}}
        return st

    @staticmethod
    def _planes(feed) -> list:
        """Per used column: (value tensor, validity tensor | None)."""
        out, fi = [], 0
        for has_nulls in feed["null_flags"]:
            out.append((feed["flat"][fi],
                        feed["flat"][fi + 1] if has_nulls else None))
            fi += 2 if has_nulls else 1
        return out

    # ------------------------------------------------------------ dispatch

    def handle_request(self, dag: DAGRequest, storage) -> SelectResult:
        """Execute a supported plan on the device (synchronously)."""
        plan, why = self._analyze(dag)
        if plan is None:
            raise NotImplementedError(why)
        if not (hasattr(storage, "scan_columns") and
                hasattr(storage, "count_rows")):
            raise NotImplementedError(
                f"{type(storage).__name__} is not a columnar snapshot: "
                f"{_TODO_STORAGE}")
        st = self._snap(storage)
        meta = st["meta"].setdefault((dag.plan_key(), dag.ranges), {})
        if "n_rows" not in meta:
            meta["n_rows"] = storage.count_rows(dag.ranges)
        n = meta["n_rows"]
        if n == 0:
            return self._apply_output_offsets(dag, self._empty_result(plan))

        memo: dict = {}

        def get_batch() -> ColumnBatch:
            if "batch" not in memo:
                memo["batch"] = storage.scan_columns(plan.scan, dag.ranges)
            return memo["batch"]

        if "dtypes" not in meta:
            batch = get_batch()
            meta["dtypes"] = tuple(
                str(_device_dtype(batch.columns[ci].eval_type,
                                  batch.columns[ci].values))
                for ci in plan.used_cols)
        dtypes = meta["dtypes"]

        def host_cols() -> list:
            """Device-dtype numpy (values, validity) pairs; request-local
            (the warm path needs only the feed and the memoized bounds)."""
            if "host_cols" not in memo:
                batch = get_batch()
                memo["host_cols"] = [
                    (np.ascontiguousarray(batch.columns[ci].values.astype(
                        np.dtype(ds), copy=False)),
                     np.ascontiguousarray(batch.columns[ci].validity))
                    for ci, ds in zip(plan.used_cols, dtypes)]
            return memo["host_cols"]

        feed_key = (tuple(plan.scan.columns[ci].col_id
                          for ci in plan.used_cols), dtypes, dag.ranges)
        feed = st["feeds"].get(feed_key)
        if feed is None:
            feed = st["feeds"][feed_key] = self._build_flat(host_cols(), n)

        if plan.kind == "simple_agg":
            result = self._run_simple(plan, feed, dtypes, n)
        else:
            result = self._run_hash(plan, host_cols, feed, dtypes, n, meta)
        return self._apply_output_offsets(dag, result)

    @staticmethod
    def _apply_output_offsets(dag, result):
        if dag.output_offsets is not None:
            b = result.batch
            result.batch = ColumnBatch(
                [b.schema[i] for i in dag.output_offsets],
                [b.columns[i] for i in dag.output_offsets])
        return result

    def _refuse_data(self, plan, feed, dtypes, capacity, mode):
        """NotImplementedError naming the kernel-gate clause the data
        fails (hash_agg.supported)."""
        reasons = []
        n_sl = ha.n_slots(plan, capacity, mode)
        if n_sl > ha.MAX_SLOTS:
            reasons.append(f"{n_sl} slots > {ha.MAX_SLOTS}")
        for i in ha.kernel_col_ids(plan, mode):
            ci = plan.scan.columns[plan.used_cols[i]]
            if feed["null_flags"][i]:
                reasons.append(f"column {ci.col_id} holds NULLs")
            if dtypes[i] != "int32":
                reasons.append(f"column {ci.col_id} is {dtypes[i]}")
        raise NotImplementedError(
            f"data outside the aggregation kernel's gate "
            f"({'; '.join(reasons)}): {_TODO_AGG}")

    # ---------------------------------------------------------- aggregate

    def _arg_ok_is_mask(self, plan, feed) -> list:
        """Per-agg flag: the arg's validity provably equals the row mask
        (bare NOT NULL column ref), so it needs no validity plane."""
        return [ci is not None and not feed["null_flags"][ci]
                for ci in map(_bare_col, plan.agg_rpns)]

    def _aggregate(self, plan, feed, n, mode, base, capacity, slots, n_sl,
                   slot_ids=None):
        """One kernel pass → (present, states) as numpy, ops/agg layout."""
        dev = self.device
        planes = self._planes(feed)
        true = torch.ones((), dtype=torch.bool, device=dev)
        pairs = [(v[:n], true if ok is None else ok[:n]) for v, ok in planes]

        mask = None
        for rpn in plan.sel_rpns:
            v, ok = eval_rpn(rpn, pairs, n, torch, dev)
            m = ok & (v != 0)
            mask = m if mask is None else mask & m
        if mask is not None:
            mask = mask.contiguous()

        key = key_ok = None
        if mode == ha.MODE_SPARSE:
            key = slot_ids
        elif mode == ha.MODE_DENSE:
            ci = _bare_col(plan.key_rpn)
            if ci is not None:
                key = planes[ci][0]     # int32, NOT NULL (gated)
            else:
                kv, km = eval_rpn(plan.key_rpn, pairs, n, torch, dev)
                # int32 slot arithmetic, as the reference's kernel: exact,
                # since every valid key lies in [base, base + span)
                key = kv.to(torch.int32).contiguous()
                key_ok = km.contiguous()

        ok_is_mask = self._arg_ok_is_mask(plan, feed)
        lanes, lane_of = [], []
        for spec, rpn, aliased in zip(plan.specs, plan.agg_rpns, ok_is_mask):
            if spec.kind == "count_star" or (spec.kind == "count" and
                                             aliased):
                lane_of.append(None)
                continue
            lane_of.append(len(lanes))
            if aliased:
                lanes.append(ha.Lane(values=planes[_bare_col(rpn)][0]))
                continue
            v, ok = eval_rpn(rpn, pairs, n, torch, dev)
            if spec.kind == "count":
                lanes.append(ha.Lane(ok=ok.contiguous()))
                continue
            if v.dtype != torch.int32:
                raise NotImplementedError(
                    f"{spec.kind.upper()} argument evaluates to {v.dtype}, "
                    f"the kernel sums int32: {_TODO_AGG}")
            lanes.append(ha.Lane(values=v.contiguous(), ok=ok.contiguous()))

        count, outs = ha.hash_agg(mode, n, slots, n_sl, key=key,
                                  key_ok=key_ok, base=base,
                                  capacity=capacity, mask=mask, lanes=lanes,
                                  device=dev)
        # one device→host transfer for every output plane
        tensors = [count] + [t for pair in outs for t in pair
                             if t is not None]
        host = list(torch.stack(tensors).cpu().numpy())
        count_np = host.pop(0)
        outs_np = [tuple(None if t is None else host.pop(0) for t in pair)
                   for pair in outs]
        return ha.states_from_lanes(plan.specs, lane_of, count_np, outs_np)

    # -- simple agg --

    def _simple_result(self, plan, merged) -> SelectResult:
        finals = finalize_simple(plan.specs, merged)
        schema, cols = [], []
        for spec, val in zip(plan.specs, finals):
            ft = _agg_ret_ft(spec.kind, spec.eval_type if spec.kind not in
                             ("count", "count_star") else None)
            schema.append(ft)
            cols.append(Column.from_list(ft.eval_type, [val]))
        return SelectResult(ColumnBatch(schema, cols))

    def _run_simple(self, plan, feed, dtypes, n) -> SelectResult:
        if not ha.supported(plan, feed, dtypes, 1, ha.MODE_SIMPLE):
            self._refuse_data(plan, feed, dtypes, 1, ha.MODE_SIMPLE)
        _present, states = self._aggregate(plan, feed, n, ha.MODE_SIMPLE,
                                           0, 1, 1, 1)
        merged = [{k: v[0] for k, v in s.items()} for s in states]
        return self._simple_result(plan, merged)

    # -- hash agg --

    def _sparse_slots(self, plan, host_cols, n, feed, meta):
        """Host recode of a sparse GROUP BY key into dense slot ids.

        A sparse int64 key domain cannot direct-index into [0, capacity);
        the distinct keys are dictionary-encoded once per snapshot on the
        host (``np.unique``) and the int32 slot plane is cached on the
        device next to the feed.  Returns (uniq, capacity, slot plane), or
        (uniq, capacity, None) when the distinct keys need more slots than
        the kernel holds.
        """
        if "sparse_slots" in meta:
            return meta["sparse_slots"]
        kv, km = eval_rpn(plan.key_rpn, host_cols(), n, np)
        kv = np.broadcast_to(kv, (n,))
        km = np.broadcast_to(km, (n,))
        valid = kv[km] if not km.all() else kv
        uniq, inv = np.unique(valid, return_inverse=True)
        capacity = max(1024, _next_pow2(len(uniq)))
        slot_ids = None
        if ha.n_slots(plan, capacity, ha.MODE_SPARSE) <= ha.MAX_SLOTS:
            idx = np.full(n, capacity, np.int32)           # NULL slot
            if km.all():
                idx[:] = inv.astype(np.int32)
            else:
                idx[km] = inv.astype(np.int32)
            padded = np.full(feed["n_pad"], capacity + 1, np.int32)
            padded[:n] = idx                                # pad: scrap
            slot_ids = torch.from_numpy(padded).to(self.device)
        got = meta["sparse_slots"] = (uniq, capacity, slot_ids)
        return got

    def _hash_result(self, plan, state, base, capacity,
                     slot_keys=None) -> SelectResult:
        keys, results = finalize_hash(plan.specs, state, base, capacity,
                                      slot_keys=slot_keys)
        schema, cols = [], []
        for spec, vals in zip(plan.specs, results):
            ft = _agg_ret_ft(spec.kind, spec.eval_type if spec.kind not in
                             ("count", "count_star") else None)
            schema.append(ft)
            cols.append(Column.from_list(ft.eval_type, vals))
        schema.append(FieldType.long())
        cols.append(Column.from_list(EvalType.INT, keys))
        return SelectResult(ColumnBatch(schema, cols))

    def _run_hash(self, plan, host_cols, feed, dtypes, n, meta):
        if "hash_bounds" in meta:
            base, span = meta["hash_bounds"]
        else:
            kv, km = eval_rpn(plan.key_rpn, host_cols(), n, np)
            valid_keys = np.broadcast_to(kv, (n,))[np.broadcast_to(km, (n,))]
            if valid_keys.size:
                base = int(valid_keys.min())
                span = int(valid_keys.max()) - base + 1
            else:
                base, span = 0, 1
            meta["hash_bounds"] = (base, span)
        # dense direct indexing while the key span fits the kernel's slots;
        # beyond that, host dictionary-encoded slot ids (sparse)
        slot_keys = slot_ids = None
        capacity = max(1024, _next_pow2(span))
        mode = ha.MODE_DENSE
        if ha.n_slots(plan, capacity, mode) > ha.MAX_SLOTS:
            mode = ha.MODE_SPARSE
            slot_keys, capacity, slot_ids = self._sparse_slots(
                plan, host_cols, n, feed, meta)
        if not ha.supported(plan, feed, dtypes, capacity, mode):
            self._refuse_data(plan, feed, dtypes, capacity, mode)
        present, states = self._aggregate(
            plan, feed, n, mode, base, capacity, capacity + 2,
            ha.n_slots(plan, capacity, mode), slot_ids)
        return self._hash_result(plan, {"present": present,
                                        "states": states},
                                 base, capacity, slot_keys)

    # -- empty scan --

    def _empty_result(self, plan) -> SelectResult:
        """The finalize of empty states — the reference's host answer for
        a scan that covers no row."""
        if plan.kind == "simple_agg":
            empty = {"count": 0, "sum": 0, "nonnull": 0}
            return self._simple_result(plan, [empty] * len(plan.specs))
        zero = np.zeros(2, np.int64)        # the NULL and scrap slots
        empty = {"count": zero, "sum": zero, "nonnull": zero}
        return self._hash_result(plan, {"present": zero > 0,
                                        "states": [empty] * len(plan.specs)},
                                 0, 0)
