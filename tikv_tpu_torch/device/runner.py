"""Device coprocessor backend on one CUDA device.

Counterpart of the JAX package's ``device/runner.py`` ``DeviceRunner``,
reduced to one device.  A DAG request is a scan
head — a TableScan, or an IndexScan over one indexed column (and the
handle) — then Selection*, then one terminal or none (the reference's
analyzer, runner.py:1362-1487):

- Aggregation (COUNT, SUM, AVG, MIN, MAX, FIRST, VAR_POP/VAR_SAMP/
  STDDEV_POP/STDDEV_SAMP, at most one INT GROUP BY key);
- TopN with one order key and ``limit ≤ topn.MAX_LIMIT`` (``topn``);
- none, with at least one selection (``scan_sel``).

It runs as:

- the used columns are uploaded once per snapshot as a padded feed that
  stays on the device (``_pad_rows``/``_build_flat``, the reference's
  feed buckets, so feed shapes line up with the reference's); INT columns
  are int32 when their values fit, else int64, REAL columns float32 —
  except a REAL column that a TopN orders by, which also gets a float64
  plane, so the order is exact (ROADMAP queue 3 fault 6 stays open for
  predicates and MIN/MAX);
- the selection predicates are evaluated inside one kernel pass
  (``selection.sel_pred``, the CUDA kernel ``csrc/selection.cu``, over an
  encoded program) when every signature is one it covers — decided once
  per plan at analysis — else, like any computed key/argument/order
  expression, by ``eval_rpn`` over torch tensors on the device; INT
  arithmetic evaluates in int64 unless the columns' bounds prove it exact
  in int32 (``narrow_int32``, fault 5's repair), on either route;
- aggregations fold the rows into per-slot states by the first route that
  takes the plan and its data, in the reference's order
  (``_run_simple``/``_run_hash``):

  1. ``hash_agg`` (the CUDA kernel ``csrc/hash_agg.cu``): COUNT/SUM/AVG
     inside its gate — int32 non-NULL inputs, int32 arguments, at most
     ``hash_agg.MAX_SLOTS`` slots;
  2. the two-level route (GROUP BY only): COUNT/SUM/AVG outside that
     gate.  ``twolevel_fused`` (the CUDA kernel ``csrc/twolevel.cu``)
     reads the key, the mask and the arguments' columns, splits each row
     into its slot and its int8 byte / float32 planes in registers
     (``kernels.build_layouts``' layout) and sums them per slot;
  3. the scatter route (GROUP BY) and the simple body (no GROUP BY):
     every other plan (MIN, MAX, FIRST, the variances, NULL-bearing or
     wide arguments), one pass of ``agg_fold`` (the CUDA kernel
     ``csrc/agg_fold.cu``) over the key, the selection and each distinct
     argument, into one state buffer;
  GROUP BY keys index their slots directly while the key span is at most
  ``MAX_HASH_CAPACITY``; wider spans are dictionary-encoded on the host
  once per snapshot (``_sparse_slots``);
- a selection packs and counts its mask (in ``sel_pred``'s pass, or by
  ``selection.sel_mask`` after the torch route) and ships the mask, the
  selected row indices or the selected rows themselves
  (``selection.sel_compact``),
  routed by a per-plan selectivity EWMA (``_run_scan_sel``);
- a TopN takes the top rows on the device (``topn.topn_select``, the CUDA
  kernel ``csrc/topn.cu``: a histogram of one digit placed by the order
  column's bounds, then the rows at or above the k-th key's bin) and
  orders the candidates exactly on the host (``_run_topn``);
- the results come back to the host, which finalizes them.

A request's plan analysis, feed lookup and kernel launches hold the
runner's dispatch lock; its result buffers then start their copy to
pinned host memory (``deferred.PinnedStager``), and the wait for that copy
and the host finalize run outside the lock: at once (``handle_request``),
or later on any thread (``handle_request(..., deferred=True)`` → a
``DeferredResult``; every route above defers).  ``batch_class`` and
``handle_batched`` serve the request coalescer (``server/coalescer.py``): a
group of selections that differ only in their constants runs as one
``selection.sel_pred_batched`` launch with one fetch; a group of identical
plans shares one solo dispatch.  Failpoints ``device::before_dispatch``
and ``device::before_fetch`` raise ``DeviceUnavailable`` at the dispatch
and at the fetch.

A snapshot built cold from MVCC versions (``copr.region_cache``) carries a
``ColdFeedBundle`` on its ``feed_lineage``: the first feed miss of an
ascending TableScan over all its rows mints the feed on the device
(``mvcc.mvcc_resolve``, the CUDA kernel ``csrc/mvcc.cu``) instead of
uploading it; any other first scan drops the bundle and uploads
(``feed_routes`` counts both).  Every feed records a digest of each plane
from the host truth; ``scrub_feed`` re-hashes the resident planes
(``digest.plane_digest``, ``csrc/digest.cu``) and names those that
differ.

Cases outside the device envelope are refused, never served on the CPU
by the runner: plans (``supports`` is False; ``handle_request`` raises
NotImplementedError) and more than ``MAX_HASH_CAPACITY`` distinct GROUP BY
keys.  The endpoint (``copr/endpoint.py``) serves them on the host
pipeline (``executors/``), as the reference does.  Each refusal names its
ROADMAP.md item.  An empty scan gets the host pipeline's answer: the
finalize of empty states, or no rows.  ``joiner()`` is the runner's
``DeviceJoiner``: the plan IR's join, sort and window fragments.
``handle_analyze`` answers an ANALYZE request: each INT, REAL, DATETIME
and DURATION column sorted and summarised on the card
(``analyze.analyze_column``, the CUDA kernel ``csrc/analyze.cu``), every
other column by the host half (``copr.analyze``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..copr.dag import (AggregationDesc, DAGRequest, IndexScanDesc,
                        SelectionDesc, TableScanDesc, TopNDesc)
from ..datatype import Column, ColumnBatch, EvalType, FieldType
from ..datatype.tile import _device_dtype
from ..executors.aggregation import agg_ret_ft
from ..executors.runner import SelectResult
from ..expr import FUNCTIONS, build_rpn, eval_rpn
from ..expr.eval import _TORCH_DTYPES, narrow_int32
from ..expr.rpn import RpnColumnRef, RpnConst, RpnExpression, RpnFnCall
from ..ops.agg import _BIG, AggSpec, finalize_hash, finalize_simple
from ..utils import tracker
from ..utils.failpoint import fail_point
from . import DEVICE_FAULTS, DeviceUnavailable
from . import agg_fold as af
from . import hash_agg as ha
from . import kernels as kn
from . import resolve_device
from . import selection as sm
from . import topn as tn
from .agg_fold import agg_fold
from .deferred import (DeferredResult, _BatchedSelectionGroup,
                       _BatchUnavailable, _GroupPending, _Pending)
from .digest import _INT_OF_WIDTH, as_u64, patch_rows, plane_digest
from .supervisor import hash_workers, start_plane_digests
from .twolevel import twolevel_fused

_DEVICE_ETS = (EvalType.INT, EvalType.REAL)
# the selection's routes (``_Plan.sel_route``, counted in ``pred_routes``)
PRED_KERNEL, PRED_TORCH = "sel_pred", "torch"
# how a feed was built (counted in ``feed_routes``)
FEED_DEVICE_RESOLVE, FEED_UPLOAD = "device_resolve", "upload"
# the reference's device aggregate set (runner.py:1401-1407)
_DEVICE_AGGS = ("count", "count_star", "sum", "avg", "min", "max", "first",
                "var_pop", "var_samp", "stddev_pop", "stddev_samp")

# widest dense GROUP BY key span (the reference's max_hash_capacity,
# runner.py:632); beyond it the keys are dictionary-encoded
MAX_HASH_CAPACITY = 1 << 20

# where each case outside this port is to be served (ROADMAP.md, queue 1)
_TODO_EXPR = "ROADMAP.md queue 1 item 2 (device expression families)"
_TODO_AGG = ("ROADMAP.md queue 1 item 3 (bit aggregates, multi-key GROUP "
             "BY, FIRST with GROUP BY and over 2^20 distinct keys: the "
             "endpoint's host pipeline serves them)")
_TODO_HOST = ("ROADMAP.md queue 1 item 6 (bare scans, projections, limits, "
              "multi-column indexes and the other plans the reference "
              "serves on the host: the endpoint's host pipeline serves "
              "them)")
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


def _fp_fault(name: str) -> None:
    """A failpoint site: a ``return`` action raises ``DeviceUnavailable``
    (a device fault the caller may degrade to the host on)."""
    if fail_point(name) is not None:
        raise DeviceUnavailable(f"failpoint {name}")


def _stack_classes(dicts: list) -> tuple:
    """Dicts of device tensors → (one flat tensor per value class:
    integers and bools as int64, floats as float64 (exact for the
    int32/float32 values MIN/MAX/FIRST keep); the layout ``_of_classes``
    reads them back with), so one transfer a class brings them home."""
    flat = [(i, k, t) for i, d in enumerate(dicts) for k, t in d.items()]
    tensors, layout = [], []
    for is_float in (False, True):
        part = [x for x in flat if x[2].is_floating_point() == is_float]
        if not part:
            continue
        dt = torch.float64 if is_float else torch.int64
        tensors.append(torch.cat([t.reshape(-1).to(dt)
                                  for _i, _k, t in part]))
        layout.append([(i, k, tuple(t.shape)) for i, k, t in part])
    return tensors, (len(dicts), layout)


def _of_classes(host: list, layout: tuple) -> list:
    """The dicts of numpy arrays from ``_stack_classes``' tensors, fetched."""
    n_dicts, parts = layout
    out: list = [{} for _ in range(n_dicts)]
    for arr, part in zip(host, parts):
        at = 0
        for i, k, shape in part:
            size = int(np.prod(shape, dtype=np.int64))
            out[i][k] = arr[at:at + size].reshape(shape)
            at += size
    return out


@dataclass
class _Plan:
    """Analyzed plan (rpns remapped onto the feed's planes: ``used_cols``
    in their device dtypes, then ``f64_cols`` in float64)."""

    scan: object                     # TableScanDesc | IndexScanDesc
    kind: str                        # simple_agg | hash_agg | topn | scan_sel
    used_cols: list                  # scan column offsets shipped to device
    sel_rpns: list = field(default_factory=list)
    specs: list = field(default_factory=list)        # AggSpec per agg
    agg_rpns: list = field(default_factory=list)     # RpnExpression | None
    key_rpn: Optional[RpnExpression] = None
    # REAL scan columns a TopN orders by, shipped again as float64 planes
    f64_cols: list = field(default_factory=list)
    order_rpn: Optional[RpnExpression] = None        # over the feed planes
    order_host_rpn: Optional[RpnExpression] = None   # over the scan columns
    order_desc: bool = False
    limit: int = 0
    compact_ok: bool = False         # scan_sel: every scan column shipped
    sel_params: Optional[tuple] = None   # selection.split_params, lazily
    sel_stat_key: Optional[tuple] = None
    # how the selection is evaluated, chosen at analysis: PRED_KERNEL
    # (sel_pred) or PRED_TORCH (eval_rpn, then sel_mask); the encoded
    # program per tuple of plane dtypes, lazily
    sel_route: str = ""
    sel_programs: dict = field(default_factory=dict)


def _scan_key(scan) -> tuple:
    """What decides a scan's row order, for feed identity."""
    return (type(scan).__name__, getattr(scan, "index_id", None),
            bool(scan.desc))


def _has_int64_calls(rpns) -> bool:
    return any(isinstance(nd, RpnFnCall) and nd.meta.int64
               for r in rpns if r is not None for nd in r.nodes)


class DeviceRunner:
    """Executes the port's plans on one device.

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
        # selectivity EWMA per exact plan key and per const-blind shape key
        # (LRU), and the selection routes taken, by name
        self._sel_stats: OrderedDict = OrderedDict()
        self.sel_routes: dict = {}
        # the predicate route of each request that evaluated a selection
        self.pred_routes: dict = {}
        # hoisted predicate constants as 0-d device tensors, FIFO-bounded
        self._params: dict = {}
        # how each feed was built: minted by the device resolve, or uploaded
        self.feed_routes: dict = {}
        self._mvcc_resolver = None
        self._joiner = None
        # host-clock ms by phase of the last ANALYZE request
        self.analyze_phases_ms: dict = {}
        # plan analysis, feed lookup and build, and every kernel launch of
        # a request hold it (the launch counters are module globals, and
        # one stream orders the launches); a fetch waits outside it
        self._dispatch_mu = threading.RLock()
        # the plan cache, the selectivity statistics and the route counts,
        # which request threads (the cost router) and the fetch side (any
        # completion worker) read and update
        self._stats_mu = threading.Lock()

    # ---------------------------------------------------------------- plan

    def supports(self, dag: DAGRequest) -> bool:
        return self._analyze(dag)[0] is not None

    def _analyze(self, dag: DAGRequest) -> tuple:
        key = dag.plan_key()
        with self._stats_mu:
            got = self._plan_cache.get(key)
        if got is None:
            got = self._analyze_uncached(dag)
            with self._stats_mu:
                if len(self._plan_cache) >= self._plan_cache_max:
                    self._plan_cache.pop(next(iter(self._plan_cache)))
                got = self._plan_cache.setdefault(key, got)
        return got

    def _analyze_uncached(self, dag: DAGRequest) -> tuple:
        execs = dag.executors
        if not execs or not isinstance(execs[0],
                                       (TableScanDesc, IndexScanDesc)):
            return None, f"plan does not start with a scan: {_TODO_HOST}"
        scan = execs[0]
        if isinstance(scan, IndexScanDesc):
            n_idx = len(scan.columns) - (
                1 if scan.columns and scan.columns[-1].is_pk_handle else 0)
            if n_idx != 1:
                return None, f"index scan over {n_idx} columns: {_TODO_HOST}"
        scan_ets = [c.field_type.eval_type for c in scan.columns]
        sel_exprs: list = []
        terminal = None
        for d in execs[1:]:
            if isinstance(d, SelectionDesc) and terminal is None:
                sel_exprs.extend(d.conditions)
            elif isinstance(d, (AggregationDesc, TopNDesc)) and \
                    terminal is None:
                terminal = d
            else:
                return None, f"{type(d).__name__} in the plan: {_TODO_HOST}"
        if terminal is None and not sel_exprs:
            return None, f"bare scan: {_TODO_HOST}"
        exprs = list(sel_exprs)
        if isinstance(terminal, AggregationDesc):
            if len(terminal.group_by) > 1:
                return None, f"multi-key GROUP BY: {_TODO_AGG}"
            for a in terminal.aggs:
                if a.kind not in _DEVICE_AGGS:
                    return None, f"{a.kind.upper()} aggregate: {_TODO_AGG}"
                if a.kind == "first" and terminal.group_by:
                    return None, f"FIRST with GROUP BY: {_TODO_AGG}"
            exprs += [a.arg for a in terminal.aggs if a.arg is not None] + \
                list(terminal.group_by)
        elif isinstance(terminal, TopNDesc):
            if len(terminal.order_by) != 1 or \
                    terminal.limit > tn.MAX_LIMIT:
                return None, (f"TopN over {len(terminal.order_by)} keys, "
                              f"limit {terminal.limit}: {_TODO_HOST}")
            exprs.append(terminal.order_by[0][0])
        unknown = set().union(*map(_expr_sigs, exprs)) - set(FUNCTIONS) \
            if exprs else set()
        if unknown:
            return None, f"functions {sorted(unknown)}: {_TODO_EXPR}"

        sel_rpns = [build_rpn(e) for e in sel_exprs]
        plan = _Plan(scan=scan, kind="scan_sel", used_cols=[])
        rpns = list(sel_rpns)
        order_cols: set = set()
        if isinstance(terminal, AggregationDesc):
            for i, a in enumerate(terminal.aggs):
                if a.arg is None:
                    plan.agg_rpns.append(None)
                    plan.specs.append(AggSpec(a.kind, i))
                    continue
                r = build_rpn(a.arg)
                plan.agg_rpns.append(r)
                plan.specs.append(AggSpec(a.kind, i, r.ret_type))
            rpns += [r for r in plan.agg_rpns if r is not None]
            plan.kind = "simple_agg"
            if terminal.group_by:
                plan.kind = "hash_agg"
                plan.key_rpn = build_rpn(terminal.group_by[0])
                if plan.key_rpn.ret_type is not EvalType.INT:
                    return None, f"non-INT GROUP BY key: {_TODO_AGG}"
                rpns.append(plan.key_rpn)
        elif isinstance(terminal, TopNDesc):
            order_expr, plan.order_desc = terminal.order_by[0]
            plan.order_host_rpn = build_rpn(order_expr)
            if plan.order_host_rpn.ret_type not in _DEVICE_ETS:
                return None, f"non-numeric TopN key: {_TODO_HOST}"
            plan.kind = "topn"
            plan.limit = terminal.limit
            order_cols = _rpn_col_indices(plan.order_host_rpn)
        for r in rpns + [r for r in [plan.order_host_rpn] if r is not None]:
            if not _rpn_device_safe(r, scan_ets):
                return None, f"non-numeric column or constant: {_TODO_EXPR}"

        # the order expression reads REAL columns in float64, INT ones in
        # their device dtype beside the other expressions' columns
        f64 = sorted(c for c in order_cols if scan_ets[c] is EvalType.REAL)
        used = set().union(*map(_rpn_col_indices, rpns)) if rpns else set()
        used |= order_cols - set(f64)
        if plan.kind == "scan_sel" and isinstance(scan, TableScanDesc) and \
                all(c.is_pk_handle or (c.field_type.eval_type is EvalType.INT
                                       and not c.field_type.is_unsigned)
                    for c in scan.columns):
            # every scan column round-trips its device dtype: ship them
            # all, so the compact route can gather the selected rows on
            # the device (runner.py:1456-1477)
            used = set(range(len(scan.columns)))
            plan.compact_ok = 2 * len(scan.columns) <= sm.MAX_PLANES
        plan.used_cols = sorted(used)
        plan.f64_cols = f64
        mapping = {old: new for new, old in enumerate(plan.used_cols)}
        plan.sel_rpns = [_remap_rpn(r, mapping) for r in sel_rpns]
        if plan.sel_rpns:
            plan.sel_route = PRED_TORCH if sm.pred_covered(plan.sel_rpns) \
                else PRED_KERNEL
        plan.agg_rpns = [None if r is None else _remap_rpn(r, mapping)
                         for r in plan.agg_rpns]
        if plan.key_rpn is not None:
            plan.key_rpn = _remap_rpn(plan.key_rpn, mapping)
        if plan.order_host_rpn is not None:
            order_map = dict(mapping)
            order_map.update({c: len(plan.used_cols) + j
                              for j, c in enumerate(f64)})
            plan.order_rpn = _remap_rpn(plan.order_host_rpn, order_map)
        return plan, ""

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
        """→ {"flat": device tensors, "null_flags": per-col bool, "n_pad",
        "digests": each plane's host digest, "n_live": n}.

        One flat padded tensor per column value; a validity tensor only
        for columns that actually contain NULLs.  A thread pool hashes the
        host planes while they upload."""
        n_pad = self._pad_rows(n)
        flags = tuple(not bool(ok.all()) for _, ok in host_cols)
        hosts = [a for (v, ok), has_nulls in zip(host_cols, flags)
                 for a in ((v, ok) if has_nulls else (v,))]
        with ThreadPoolExecutor(hash_workers()) as pool:
            digests = start_plane_digests(pool, [(a, None) for a in hosts],
                                          n)
            flat = tuple(self._upload(a, n_pad) for a in hosts)
            return {"flat": flat, "null_flags": flags, "n_pad": n_pad,
                    "digests": digests(), "n_live": n}

    def _new_feed(self, storage, plan, planes, dtypes, host_cols,
                  n: int) -> dict:
        """The feed of a miss: minted on the device from the snapshot's
        cold bundle when the scan is an ascending TableScan over all the
        bundle's rows, else uploaded (the bundle, if any, is dropped)."""
        lineage = getattr(storage, "feed_lineage", None)
        if lineage is not None:
            if isinstance(plan.scan, TableScanDesc) and not plan.scan.desc:
                bundle = lineage.take_cold()
                feed = None if bundle is None else bundle.mint(
                    self, [plan.scan.columns[ci] for ci, _ in planes],
                    dtypes, n, self._pad_rows(n))
                if feed is not None:
                    self._note_route(FEED_DEVICE_RESOLVE, self.feed_routes)
                    return feed
            else:
                # an index or descending scan cannot take the bundle:
                # release the version planes now
                lineage.drop_cold()
        self._note_route(FEED_UPLOAD, self.feed_routes)
        return self._build_flat(host_cols(), n)

    def mvcc_resolver(self):
        """The runner's ``DeviceMvccResolver`` (created on first use)."""
        if self._mvcc_resolver is None:
            from .mvcc import DeviceMvccResolver
            self._mvcc_resolver = DeviceMvccResolver()
        return self._mvcc_resolver

    def joiner(self):
        """The runner's ``DeviceJoiner`` (created on first use): the plan
        IR's join, sort and window fragments on this device."""
        if self._joiner is None:
            from .join import DeviceJoiner
            self._joiner = DeviceJoiner(self)
        return self._joiner

    # ------------------------------------------------------------- scrub

    @staticmethod
    def device_digest(arr: torch.Tensor, n: int) -> torch.Tensor:
        """Digest of one resident plane's live prefix (a 0-d int64 device
        tensor; the caller decides when to read it)."""
        return plane_digest(arr, 0, n)

    def scrub_feed(self, feed: dict) -> list:
        """Re-hash every resident plane of ``feed`` on the device → the
        indices (into ``feed["flat"]``) of the planes whose digest differs
        from the recorded one."""
        got = torch.stack([self.device_digest(a, feed["n_live"])
                           for a in feed["flat"]]).cpu().tolist()
        return [i for i, (g, r) in enumerate(zip(got, feed["digests"]))
                if as_u64(g) != as_u64(r)]

    def _patch_plane(self, feed: dict, fi: int, pos, vals) -> None:
        """Write ``vals`` at rows ``pos`` of plane ``fi`` in place, keeping
        its recorded digest by the incremental rule ``R' = R − H(old) +
        H(new)`` over the rows written (runner.py:1793-1814): never a
        re-hash of the plane, which would launder a corruption that landed
        since the last scrub into the record."""
        plane = feed["flat"][fi]
        old, new = patch_rows(plane, pos, vals, digest=True)
        digests = list(feed["digests"])
        recorded = as_u64(digests[fi])
        base = torch.tensor(recorded - (1 << 64) if recorded >= 1 << 63
                            else recorded, dtype=torch.int64,
                            device=plane.device)
        digests[fi] = base - old + new
        feed["digests"] = tuple(digests)

    @staticmethod
    def corrupt_resident_plane(feed: dict, fi: int = 0) -> None:
        """Fault injection: flip the low bit of element 0 of resident plane
        ``fi`` in place (the HBM bit flip a device fault would cause), by a
        one-row ``patch_rows`` over the plane's same-width integer view;
        the recorded digest is left as it was."""
        arr = feed["flat"][fi]
        view = arr.view(_INT_OF_WIDTH[arr.element_size()])
        patch_rows(view, [0], view[:1] ^ 1)

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

    # ------------------------------------------------------------- analyze

    def handle_analyze(self, dag: DAGRequest, storage,
                       n_buckets: int) -> list:
        """An ANALYZE request's ``ColumnStats`` per column of the scan
        (the reference's ``_analyze_on_device_impl``, runner.py:4546-4619).

        Each INT, REAL, DATETIME and DURATION column is uploaded (REAL as
        float64: the statistics are exact) and summarised by one
        ``analyze.analyze_column``; every packed vector comes back in one
        D2H copy.  Other columns, and uint64 columns holding a value at or
        past 2^63, take the host half (``copr.analyze.analyze_columns``)
        after every device column has been launched.  ``analyze_phases_ms``
        holds the host-clock phases of the last request."""
        from ..copr.analyze import (ANALYZE_DEVICE_ETS, ColumnStats,
                                    analyze_columns)
        from . import analyze as an
        scan = dag.executors[0]
        phases: dict = {}
        t0 = time.perf_counter()
        batch = storage.scan_columns(scan, dag.ranges)
        t1 = time.perf_counter()
        phases["scan"] = (t1 - t0) * 1e3
        n = batch.num_rows
        if n == 0:
            self.analyze_phases_ms = phases
            return analyze_columns(batch, scan.columns, n_buckets)
        n_pad = self._pad_rows(n)
        pending, host_idx = {}, []
        dtype_s = upload_s = 0.0
        for i, col in enumerate(batch.columns):
            et = col.eval_type
            t = time.perf_counter()
            if et not in ANALYZE_DEVICE_ETS or (
                    col.values.dtype == np.uint64 and col.values.size and
                    int(col.values.max()) >= 1 << 63):
                host_idx.append(i)
                continue
            dt = np.dtype(np.float64) if et is EvalType.REAL \
                else _device_dtype(et, col.values)
            t2 = time.perf_counter()
            vals = self._upload(col.values.astype(dt, copy=False), n_pad)
            valid = self._upload(col.validity, n_pad)
            dtype_s += t2 - t
            upload_s += time.perf_counter() - t2
            pending[i] = an.analyze_column(vals, valid, n, n_buckets,
                                           phases)
        phases["dtype"] = dtype_s * 1e3
        phases["pad_h2d"] = upload_s * 1e3
        t = time.perf_counter()
        out = {i: analyze_columns(
            ColumnBatch([batch.schema[i]], [batch.columns[i]]),
            [scan.columns[i]], n_buckets)[0] for i in host_idx}
        phases["host_columns"] = (time.perf_counter() - t) * 1e3
        if pending:
            t = time.perf_counter()
            packed = torch.stack(list(pending.values())).cpu().numpy()
            t2 = time.perf_counter()
            phases["d2h"] = (t2 - t) * 1e3
            for row, i in zip(packed, pending):
                n_valid, distinct, buckets = an.unpack(
                    row, n_buckets, batch.columns[i].eval_type is
                    EvalType.REAL)
                out[i] = ColumnStats(scan.columns[i].col_id, n, n - n_valid,
                                     distinct, buckets)
            phases["unpack"] = (time.perf_counter() - t2) * 1e3
        self.analyze_phases_ms = phases
        return [out[i] for i in range(len(scan.columns))]

    # ------------------------------------------------------------ dispatch

    def handle_request(self, dag: DAGRequest, storage,
                       deferred: bool = False, _stack=None):
        """Execute a supported plan on the device.

        The request's kernels launch under the dispatch lock and its
        result buffers start their copy to pinned host memory; then, with
        ``deferred`` False, the call waits for the copy and finalizes on
        the host (``_finish``), outside the lock.  ``deferred=True`` returns
        a ``DeferredResult`` instead, whose ``result()`` does that on
        whichever thread calls it, so requests in flight overlap their
        launches, transfers and finalizes (the reference's contract,
        runner.py:2986-3040).  A request that launches nothing (an empty
        scan, a TopN of limit 0) returns its settled ``SelectResult``
        either way.

        ``_stack`` (``handle_batched`` only): the DAGs of a stacked group
        whose lead is ``dag``; the selection then runs as one
        ``sel_pred_batched`` launch and the call returns its
        ``_GroupPending``, or raises ``_BatchUnavailable``.

        The ``device::before_dispatch`` failpoint raises
        ``DeviceUnavailable`` before anything launches."""
        plan, why = self._analyze(dag)
        if plan is None:
            raise NotImplementedError(why)
        if not (hasattr(storage, "scan_columns") and
                hasattr(storage, "count_rows")):
            raise NotImplementedError(
                f"{type(storage).__name__} is not a columnar snapshot: "
                f"{_TODO_STORAGE}")
        with self._dispatch_mu:
            _fp_fault("device::before_dispatch")
            out = self._dispatch(dag, plan, storage, _stack)
        if _stack is not None:
            if isinstance(out, _Pending):
                return _GroupPending(self, out)
            raise _BatchUnavailable("the group launched nothing")
        if not isinstance(out, _Pending):
            return self._apply_output_offsets(dag, out)
        if deferred:
            return DeferredResult(self, out, dag, storage)
        return self._apply_output_offsets(dag, self._finish(out))

    def _readback(self, pending: _Pending) -> list:
        """Wait for a dispatched request's copies to the host → numpy
        arrays.  The ``device::before_fetch`` failpoint raises
        ``DeviceUnavailable`` here (runner.py:2949)."""
        _fp_fault("device::before_fetch")
        with tracker.phase("d2h_wait"):
            return pending.staged.fetch()

    def _finish(self, pending: _Pending):
        """The blocking fetch and the host finalize of a dispatched
        request (runner.py:3334)."""
        fetched = self._readback(pending)
        with tracker.phase("host_materialize"):
            return pending.finalize(fetched)

    def _dispatch(self, dag, plan, storage, stack):
        """Under the dispatch lock: the snapshot's feed and the plan's
        per-snapshot facts, then the plan's kernels → a ``_Pending``, or
        a settled ``SelectResult`` when nothing needs the device."""
        st = self._snap(storage)
        meta = st["meta"].setdefault((dag.plan_key(), dag.ranges), {})
        memo: dict = {}

        def get_batch() -> ColumnBatch:
            if "batch" not in memo:
                memo["batch"] = storage.scan_columns(plan.scan, dag.ranges)
            return memo["batch"]

        if "n_rows" not in meta:
            # an index scan's ranges are index keys: count its output
            meta["n_rows"] = storage.count_rows(dag.ranges) \
                if isinstance(plan.scan, TableScanDesc) \
                else get_batch().num_rows
        n = meta["n_rows"]
        if n == 0:
            return self._empty_result(plan) if plan.kind in (
                "simple_agg", "hash_agg") else SelectResult(get_batch())

        planes = self._feed_planes(plan)
        dtypes = self._feed_dtypes(st, plan, dag.ranges, planes, get_batch)

        def host_cols() -> list:
            """Device-dtype numpy (values, validity) pairs; request-local
            (the warm path needs only the feed and the memoized bounds)."""
            if "host_cols" not in memo:
                batch = get_batch()
                memo["host_cols"] = [
                    (np.ascontiguousarray(batch.columns[ci].values.astype(
                        np.dtype(ds), copy=False)),
                     np.ascontiguousarray(batch.columns[ci].validity))
                    for (ci, _), ds in zip(planes, dtypes)]
            return memo["host_cols"]

        feed_key = (_scan_key(plan.scan),
                    tuple(plan.scan.columns[ci].col_id for ci, _ in planes),
                    dtypes, dag.ranges)
        feed = st["feeds"].get(feed_key)
        if feed is None:
            feed = st["feeds"][feed_key] = self._new_feed(
                storage, plan, planes, dtypes, host_cols, n)
        if "plan" not in meta:
            meta["plan"] = self._narrowed(plan, host_cols, dtypes)
        plan = meta["plan"]

        if plan.kind == "scan_sel":
            if stack is not None:
                return self._run_stacked(stack, st, feed, n, host_cols,
                                         dtypes)
            return self._run_scan_sel(dag, plan, feed, n, get_batch,
                                      storage)
        if stack is not None:
            raise _BatchUnavailable(f"a {plan.kind} plan has no stacked "
                                    f"form")
        if plan.kind == "topn":
            if "order_bounds" not in meta:
                meta["order_bounds"] = self._order_bounds(plan, host_cols)
            return self._run_topn(dag, plan, feed, n, get_batch, storage,
                                  meta["order_bounds"])
        if "arg_nbytes" not in meta:
            meta["arg_nbytes"] = self._arg_nbytes(plan, host_cols, dtypes)
        if "fold_bound" not in meta:
            meta["fold_bound"] = self._fold_bound(plan, host_cols, dtypes)
        arg_nbytes = meta["arg_nbytes"]
        if plan.kind == "simple_agg":
            return self._run_simple(plan, feed, dtypes, n, arg_nbytes,
                                    meta["fold_bound"])
        return self._run_hash(plan, host_cols, feed, dtypes, n, meta,
                              arg_nbytes)

    @staticmethod
    def _feed_planes(plan) -> list:
        """(scan column, dtype override) per feed plane: the used columns
        in their device dtypes, then the float64 order planes."""
        return [(ci, None) for ci in plan.used_cols] + \
            [(ci, "float64") for ci in plan.f64_cols]

    @staticmethod
    def _feed_dtypes(st, plan, ranges, planes, get_batch) -> tuple:
        """The feed planes' dtypes on this snapshot: a column's device
        dtype depends on its values, so it is memoized per snapshot, scan
        and columns (every plan over them shares it)."""
        key = ("dtypes", _scan_key(plan.scan),
               tuple(plan.scan.columns[ci].col_id for ci, _ in planes),
               tuple(dt for _ci, dt in planes), ranges)
        got = st["meta"].get(key)
        if got is None:
            batch = get_batch()
            got = st["meta"][key] = tuple(
                dt or str(_device_dtype(batch.columns[ci].eval_type,
                                        batch.columns[ci].values))
                for ci, dt in planes)
        return got

    # ----------------------------------------- cross-request batching

    def batch_class(self, dag: DAGRequest, storage):
        """The coalescing identity of this request, or None when it cannot
        share a dispatch (runner.py:1172-1227).  Requests under one key are
        served by one launch; they read one snapshot (by ``id``: the port
        has no feed arena anchor yet) over the same ranges.

        ``("stack", ...)``: a selection that ``sel_pred`` evaluates and that
        holds numeric constants: members differing only in those constants
        (one const-blind ``shape_key``, one feed plane dtype each) run as
        one ``sel_pred_batched`` launch.  ``("share", ...)``:
        byte-identical plans (aggregations, top-k, the other selections):
        one solo dispatch and its fetch serve every member.  A selection
        that ``sel_pred`` does not cover (the torch route) only shares,
        where the reference stacks any hoisted selection (ROADMAP.md)."""
        if not (hasattr(storage, "scan_columns") and
                hasattr(storage, "count_rows")):
            return None
        plan = self._analyze(dag)[0]
        if plan is None:
            return None
        if plan.kind == "scan_sel" and plan.sel_route == PRED_KERNEL:
            if plan.sel_params is None:
                plan.sel_params = sm.split_params(plan.sel_rpns,
                                                  len(plan.used_cols))
            if plan.sel_params[2]:
                with self._dispatch_mu:
                    st = self._snap(storage)
                    planes = self._feed_planes(plan)
                    dtypes = self._feed_dtypes(
                        st, plan, dag.ranges, planes,
                        lambda: storage.scan_columns(plan.scan, dag.ranges))
                return ("stack", id(storage), sm.shape_key(plan), dtypes,
                        dag.ranges, dag.output_offsets)
        return ("share", id(storage), dag.plan_key(), dag.ranges)

    def handle_batched(self, members) -> _BatchedSelectionGroup:
        """One stacked dispatch for ``members``, a list of ``(dag,
        storage)`` pairs of one ``("stack", ...)`` batch class
        (runner.py:1229) → a ``_BatchedSelectionGroup``.  Raises
        ``_BatchUnavailable`` when the group cannot be one launch: the
        caller retries each member solo."""
        if not members:
            raise _BatchUnavailable("an empty group")
        lead_dag, lead_storage = members[0]
        if any(s is not lead_storage for _d, s in members):
            raise _BatchUnavailable("members read different snapshots")
        for dag, _s in members:
            plan = self._analyze(dag)[0]
            if plan is None or plan.kind != "scan_sel" or \
                    plan.sel_route != PRED_KERNEL:
                raise _BatchUnavailable("not a stacked selection plan")
        try:
            gp = self.handle_request(lead_dag, lead_storage, deferred=True,
                                     _stack=[d for d, _s in members])
        except DEVICE_FAULTS as e:
            # a fault mid-group must not serve the lead's degrade to every
            # member: each retries solo, with its own degrade
            raise _BatchUnavailable(f"device fault: {e}") from e
        return _BatchedSelectionGroup(self, gp, list(members))

    def _member_plan(self, st, dag, host_cols, dtypes):
        """A stacked member's plan, narrowed on this snapshot as its own
        solo request would be (memoized in its meta)."""
        meta = st["meta"].setdefault((dag.plan_key(), dag.ranges), {})
        if "plan" not in meta:
            plan = self._analyze(dag)[0]
            meta["plan"] = self._narrowed(plan, host_cols, dtypes)
        return meta["plan"]

    def _run_stacked(self, dags, st, feed, n, host_cols, dtypes):
        """The stacked selection (runner.py:4217-4245): every member's
        program, encoded against the same feed, runs as one lane of one
        ``sel_pred_batched`` launch; the whole group's counts and packed
        masks come home in one copy.  Always the packed masks: each
        member's count is unknown until the fetch."""
        planes = self._planes(feed)
        pdt = tuple(v.dtype for v, _ok in planes)
        plans, progs = [], []
        for dag in dags:
            plan = self._member_plan(st, dag, host_cols, dtypes)
            if plan.sel_route != PRED_KERNEL:
                raise _BatchUnavailable("a member off the sel_pred route")
            prog = plan.sel_programs.get(pdt)
            if prog is None:
                prog = plan.sel_programs[pdt] = sm.encode_predicate(
                    plan.sel_rpns, pdt)
            plans.append(plan)
            progs.append(prog)
        try:
            out = sm.sel_pred_batched(progs, planes, n)
        except sm.LanesDiffer as e:
            raise _BatchUnavailable(str(e)) from e
        self._note_route("batched")
        for _ in progs:
            self._note_route(PRED_KERNEL, self.pred_routes)
        G = len(progs)
        return _Pending([out.buf], lambda f: sm.batched_host(f[0], G, n) +
                        (n, plans), small=False)

    def _stacked_member(self, dag, plan, storage, count, packed, n):
        """Member ``dag``'s answer from its lane of a stacked group: its
        selectivity observed, its rows gathered on the host."""
        self._sel_observe(self._sel_keys(dag, plan), count / n)
        mask = np.unpackbits(packed, count=n).view(np.bool_)
        with tracker.phase("host_materialize"):
            out = self._gather(dag, plan, storage, mask, lambda: (
                storage.scan_columns(plan.scan, dag.ranges)))
        return self._apply_output_offsets(dag, out)

    @staticmethod
    def _gather(dag, plan, storage, rows, get_batch) -> SelectResult:
        """The scan's rows ``rows`` (a bool mask over the scan output, or
        its ascending positions): gathered from a table snapshot, taken
        from the scan's batch otherwise."""
        if isinstance(plan.scan, TableScanDesc) and \
                hasattr(storage, "gather_rows"):
            out = storage.gather_rows(plan.scan, dag.ranges, rows)
        else:
            b = get_batch()
            out = b.filter(rows) if rows.dtype == np.bool_ else b.take(rows)
        return SelectResult(out)

    @staticmethod
    def _narrowed(plan, host_cols, dtypes):
        """``plan`` with its INT arithmetic kept in int32 wherever this
        snapshot's column bounds prove it exact (``narrow_int32``); every
        other INT arithmetic call evaluates in int64."""
        rpns = plan.sel_rpns + plan.agg_rpns + [plan.key_rpn, plan.order_rpn]
        if not _has_int64_calls(rpns):
            return plan
        bounds = []
        for (v, _ok), d in zip(host_cols(), dtypes):
            if np.dtype(d).kind == "f":
                bounds.append(None)
            else:   # NULL slots hold 0, and count: they are computed too
                bounds.append((int(v.min()), int(v.max())) if v.size
                              else (0, 0))

        def narrow(r):
            return None if r is None else narrow_int32(r, bounds)

        return dataclasses.replace(
            plan, sel_params=None, sel_programs={},
            sel_rpns=[narrow(r) for r in plan.sel_rpns],
            agg_rpns=[narrow(r) for r in plan.agg_rpns],
            key_rpn=narrow(plan.key_rpn), order_rpn=narrow(plan.order_rpn))

    @staticmethod
    def _apply_output_offsets(dag, result):
        if dag.output_offsets is not None:
            b = result.batch
            result.batch = ColumnBatch(
                [b.schema[i] for i in dag.output_offsets],
                [b.columns[i] for i in dag.output_offsets])
        return result

    # ------------------------------------------------------------- routing

    @staticmethod
    def _arg_nbytes(plan, host_cols, dtypes) -> tuple:
        """Byte planes per SUM/AVG argument on the two-level route (0 for
        REAL and for the other kinds).

        The reference's ``_arg_nbytes`` (runner.py:4148) with its fault 3
        repaired: a bare column takes the bytes of its value range, and a
        computed argument the width of the dtype it evaluates to on the
        device (8 for int64; the reference takes its input column's width
        and truncates).  The dtype comes from evaluating the expression
        over one row of zeros in the feed's dtypes, with the device's
        typing rules."""
        probe = [(torch.zeros(1, dtype=_TORCH_DTYPES[d]),
                  torch.ones(1, dtype=torch.bool)) for d in dtypes]
        out = []
        for spec, r in zip(plan.specs, plan.agg_rpns):
            if spec.kind not in ("sum", "avg") or r.ret_type is EvalType.REAL:
                out.append(0)
                continue
            ci = _bare_col(r)
            if ci is None:
                out.append(eval_rpn(r, probe, 1, torch, "cpu")[0]
                           .element_size())
                continue
            v = host_cols()[ci][0]
            out.append(kn.int_planes_needed(int(v.min()), int(v.max()))
                       if v.size else 1)
        return tuple(out)

    @staticmethod
    def _fold_bound(plan, host_cols, dtypes) -> Optional[int]:
        """The largest |v| of this snapshot's int32 aggregate arguments —
        how ``agg_fold``'s shared route sizes its cells — or None when an
        int32 argument is computed (its values are not known here)."""
        bound = 0
        for r in plan.agg_rpns:
            if r is None or r.ret_type is not EvalType.INT:
                continue
            ci = _bare_col(r)
            if ci is None:
                return None
            if dtypes[ci] != "int32":
                continue        # the shared route reads no int64 lane
            v = host_cols()[ci][0]
            if v.size:
                bound = max(bound, abs(int(v.min())), abs(int(v.max())))
        return bound

    @staticmethod
    def _fused_ok(plan, feed, dtypes, capacity, mode, arg_nbytes) -> bool:
        """The ``hash_agg`` kernel's gate: COUNT/SUM/AVG only, its data
        gate (``hash_agg.supported``), and SUM/AVG arguments that
        evaluate to int32."""
        return kn.matmul_supported(plan.specs) and \
            ha.supported(plan, feed, dtypes, capacity, mode) and \
            all(nb <= 4 for nb in arg_nbytes)

    def _arg_ok_is_mask(self, plan, feed) -> list:
        """Per-agg flag: the arg's validity provably equals the row mask
        (bare NOT NULL column ref), so it needs no validity plane."""
        return [ci is not None and not feed["null_flags"][ci]
                for ci in map(_bare_col, plan.agg_rpns)]

    def _inputs(self, plan, feed, n):
        """(per-column (value, validity) pairs over rows [0, n), the
        selection's bool mask or None when there is no selection)."""
        true = torch.ones((), dtype=torch.bool, device=self.device)
        pairs = [(v[:n], true if ok is None else ok[:n])
                 for v, ok in self._planes(feed)]
        if not plan.sel_rpns:
            return pairs, None
        return pairs, self._selection(plan, feed, n, True)[1]

    def _selection(self, plan, feed, n, bools: bool) -> tuple:
        """The selection over rows [0, n) by the plan's route → (its
        ``MaskOut`` — count, packed mask, block counts — or None where the
        torch route was asked for the bool mask; the bool mask when
        ``bools``, else None).

        ``PRED_KERNEL``: ``sel_pred`` evaluates the encoded predicate over
        the feed's planes in one pass (the bool mask only when asked for).
        ``PRED_TORCH`` (a signature ``sel_pred`` does not cover):
        ``eval_rpn`` over torch tensors, the numeric constants hoisted
        (``split_params``) into 0-d device tensors cached across requests,
        then ``sel_mask`` for the count and packed mask."""
        self._note_route(plan.sel_route, self.pred_routes)
        planes = self._planes(feed)
        if plan.sel_route == PRED_KERNEL:
            dtypes = tuple(v.dtype for v, _ok in planes)
            prog = plan.sel_programs.get(dtypes)
            if prog is None:
                prog = plan.sel_programs[dtypes] = sm.encode_predicate(
                    plan.sel_rpns, dtypes)
            return sm.sel_pred(prog, planes, n, bools)
        true = torch.ones((), dtype=torch.bool, device=self.device)
        pairs = [(v[:n], true if ok is None else ok[:n]) for v, ok in planes]
        if plan.sel_params is None:
            plan.sel_params = sm.split_params(plan.sel_rpns, len(pairs))
        rpns, values, dts = plan.sel_params
        cols = pairs + [(self._param(v, dt), true)
                        for v, dt in zip(values, dts)]
        mask = None
        for rpn in rpns:
            v, ok = eval_rpn(rpn, cols, n, torch, self.device)
            m = ok & (v != 0)
            mask = m if mask is None else mask & m
        mask = mask.contiguous()
        return (None, mask) if bools else (sm.sel_mask(mask, n), None)

    # ------------------------------------------- route 1: hash_agg kernel

    def _aggregate(self, plan, feed, n, mode, base, capacity, slots, n_sl,
                   slot_ids=None, arg_nbytes=()):
        """One kernel pass → (present, states) as numpy, ops/agg layout
        (``_aggregate_launch``, then its one copy and decode here)."""
        stacked, decode = self._aggregate_launch(
            plan, feed, n, mode, base, capacity, slots, n_sl, slot_ids,
            arg_nbytes)
        return decode(stacked.cpu().numpy())

    def _aggregate_launch(self, plan, feed, n, mode, base, capacity, slots,
                          n_sl, slot_ids=None, arg_nbytes=()):
        """One ``hash_agg`` pass → (every output plane stacked in one
        device tensor, ``decode``: that tensor fetched → (present, states)
        as numpy, ops/agg layout).  ``arg_nbytes``: ``_arg_nbytes`` of the
        plan, the value width the kernel may assume (4 bytes where it is
        not given)."""
        dev = self.device
        planes = self._planes(feed)
        pairs, mask = self._inputs(plan, feed, n)
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
            else:       # an int32 argument (the gate's arg_nbytes clause)
                lanes.append(ha.Lane(values=v.contiguous(),
                                     ok=ok.contiguous()))

        count, outs = ha.hash_agg(mode, n, slots, n_sl, key=key,
                                  key_ok=key_ok, base=base,
                                  capacity=capacity, mask=mask, lanes=lanes,
                                  device=dev, value_bytes=max(
                                      [nb for nb in arg_nbytes if nb] or [4]))
        # one device→host transfer for every output plane
        tensors = [count] + [t for pair in outs for t in pair
                             if t is not None]
        shape = [[t is not None for t in pair] for pair in outs]

        def decode(host):
            host = list(host)
            count_np = host.pop(0)
            outs_np = [tuple(host.pop(0) if has else None for has in pair)
                       for pair in shape]
            return ha.states_from_lanes(plan.specs, lane_of, count_np,
                                        outs_np)
        return torch.stack(tensors), decode

    # ------------------------------------------------------- simple agg

    def _simple_result(self, plan, merged) -> SelectResult:
        finals = finalize_simple(plan.specs, merged)
        schema, cols = [], []
        for spec, val in zip(plan.specs, finals):
            ft = agg_ret_ft(spec.kind, spec.eval_type if spec.kind not in
                            ("count", "count_star") else None)
            schema.append(ft)
            cols.append(Column.from_list(ft.eval_type, [val]))
        return SelectResult(ColumnBatch(schema, cols))

    def _run_simple(self, plan, feed, dtypes, n, arg_nbytes,
                    fold_bound=None) -> _Pending:
        def result(states):
            merged = [{k: v[0] for k, v in st.items()} for st in states]
            return self._simple_result(plan, merged)

        if self._fused_ok(plan, feed, dtypes, 1, ha.MODE_SIMPLE, arg_nbytes):
            stacked, decode = self._aggregate_launch(
                plan, feed, n, ha.MODE_SIMPLE, 0, 1, 1, 1,
                arg_nbytes=arg_nbytes)
            return _Pending([stacked],
                            lambda f: result(decode(f[0])[1]), small=True)
        # the simple body (runner.py:2668): the agg_fold kernel
        pairs, mask = self._inputs(plan, feed, n)
        out = agg_fold(plan.specs, self._fold_cols(plan, feed, pairs, n), n,
                       af.MODE_SIMPLE, mask=mask, device=self.device,
                       value_bound=fold_bound)
        return _Pending([out.buf], lambda f: result(
            af.decode(f[0], out.plan, out.n_slots)[2]), small=True)

    # --------------------------------------------------------- hash agg

    def _sparse_slots(self, plan, host_cols, n, feed, meta):
        """Host recode of a sparse GROUP BY key into dense slot ids.

        A key span beyond ``MAX_HASH_CAPACITY`` cannot direct-index; the
        distinct keys are dictionary-encoded once per snapshot on the host
        (``np.unique``) and the int32 slot plane is cached on the device
        next to the feed.  Returns (uniq, capacity, slot plane); raises
        NotImplementedError beyond ``MAX_HASH_CAPACITY`` distinct keys.
        """
        if "sparse_slots" in meta:
            return meta["sparse_slots"]
        kv, km = eval_rpn(plan.key_rpn, host_cols(), n, np)
        kv = np.broadcast_to(kv, (n,))
        km = np.broadcast_to(km, (n,))
        valid = kv[km] if not km.all() else kv
        uniq, inv = np.unique(valid, return_inverse=True)
        if len(uniq) > MAX_HASH_CAPACITY:
            raise NotImplementedError(
                f"{len(uniq)} distinct GROUP BY keys > {MAX_HASH_CAPACITY}: "
                f"{_TODO_AGG}")
        capacity = max(1024, _next_pow2(len(uniq)))
        idx = np.full(n, capacity, np.int32)               # NULL slot
        if km.all():
            idx[:] = inv.astype(np.int32)
        else:
            idx[km] = inv.astype(np.int32)
        padded = np.full(feed["n_pad"], capacity + 1, np.int32)
        padded[:n] = idx                                    # pad: scrap
        slot_ids = torch.from_numpy(padded).to(self.device)
        got = meta["sparse_slots"] = (uniq, capacity, slot_ids)
        return got

    def _hash_result(self, plan, state, base, capacity,
                     slot_keys=None) -> SelectResult:
        keys, results = finalize_hash(plan.specs, state, base, capacity,
                                      slot_keys=slot_keys)
        schema, cols = [], []
        for spec, vals in zip(plan.specs, results):
            ft = agg_ret_ft(spec.kind, spec.eval_type if spec.kind not in
                            ("count", "count_star") else None)
            schema.append(ft)
            cols.append(Column.from_list(ft.eval_type, vals))
        schema.append(FieldType.long())
        cols.append(Column.from_list(EvalType.INT, keys))
        return SelectResult(ColumnBatch(schema, cols))

    def _run_hash(self, plan, host_cols, feed, dtypes, n, meta, arg_nbytes):
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
        # dense direct indexing while the key span fits MAX_HASH_CAPACITY;
        # beyond that, host dictionary-encoded slot ids (sparse)
        slot_keys = slot_ids = None
        mode = ha.MODE_DENSE
        if span > MAX_HASH_CAPACITY:
            mode = ha.MODE_SPARSE
            slot_keys, capacity, slot_ids = self._sparse_slots(
                plan, host_cols, n, feed, meta)
        else:
            capacity = max(1024, _next_pow2(span))
        slots = capacity + 2

        layouts = None
        if kn.matmul_supported(plan.specs):
            arg_is_real = [r is not None and r.ret_type is EvalType.REAL
                           for r in plan.agg_rpns]
            layouts, p8, pf = kn.build_layouts(
                plan.specs, arg_is_real, arg_nbytes,
                self._arg_ok_is_mask(plan, feed))
        if self._fused_ok(plan, feed, dtypes, capacity, mode, arg_nbytes):
            stacked, decode = self._aggregate_launch(
                plan, feed, n, mode, base, capacity, slots,
                ha.n_slots(plan, capacity, mode), slot_ids, arg_nbytes)
            tensors, decode = [stacked], (lambda f, d=decode: d(f[0]))
        elif layouts is not None and kn.twolevel_lo(p8, pf) is not None:
            tensors, decode = self._run_twolevel(
                plan, feed, n, base, capacity, slot_ids, layouts, p8, pf)
        else:
            tensors, decode = self._run_scatter(plan, feed, n, base,
                                                capacity, slot_ids,
                                                meta["fold_bound"])

        def finalize(fetched):
            present, states = decode(fetched)
            return self._hash_result(plan, {"present": present,
                                            "states": states},
                                     base, capacity, slot_keys)
        return _Pending(tensors, finalize, small=True)

    @staticmethod
    def _check_overflow(overflow) -> None:
        # a live key outside [base, base + capacity): the bounds came from
        # this snapshot's keys, so this is a fault, never data to drop
        if overflow is not None and int(overflow):
            raise AssertionError("hash agg key range overflow")

    # -- route 2: the two-level contraction (runner.py:2743, :3816-3849)

    def _run_twolevel(self, plan, feed, n, base, capacity, slot_ids,
                      layouts, p8, pf):
        """→ (the device tensors to fetch, their decode to (present,
        states))."""
        slots = capacity + 2
        pairs, mask = self._inputs(plan, feed, n)
        # each distinct argument once: aggregates over one expression
        # share its tensors, so the kernel reads its column once
        evaluated: dict = {}
        cols = []
        for r in plan.agg_rpns:
            if r is not None and r not in evaluated:
                evaluated[r] = eval_rpn(r, pairs, n, torch, self.device)
            cols.append(None if r is None else evaluated[r])
        key = key_ok = None
        if slot_ids is None:
            key, key_ok = self._key(plan, feed, pairs, n)
        LO, HI = kn.twolevel_dims(slots, p8, pf)
        S8p, Sfp, overflow = twolevel_fused(
            n, layouts, cols, LO, HI, capacity, base=base, key=key,
            key_ok=key_ok, slot_ids=slot_ids, mask=mask)
        got = {"S8": S8p}
        if Sfp is not None:
            got["Sf"] = Sfp
        if overflow is not None:
            got["overflow"] = overflow
        tensors, layout = _stack_classes([got])

        def decode(fetched):
            host, = _of_classes(fetched, layout)
            self._check_overflow(host.get("overflow"))
            S8 = kn.twolevel_unpack(host["S8"], p8, LO, slots)
            Sf = kn.twolevel_unpack(host["Sf"], pf, LO, slots) if pf \
                else None
            return kn.states_from_matmul(layouts, plan.specs, S8, Sf)
        return tensors, decode

    # -- route 3: the scatter body (runner.py:2701)

    def _run_scatter(self, plan, feed, n, base, capacity, slot_ids,
                     fold_bound=None):
        """The scatter body: one ``agg_fold`` pass over the key (or slot
        ids), the selection and each distinct argument → (its buffer, the
        decode of that buffer fetched to (present, states))."""
        pairs, mask = self._inputs(plan, feed, n)
        cols = self._fold_cols(plan, feed, pairs, n)
        if slot_ids is not None:
            out = agg_fold(plan.specs, cols, n, af.MODE_SPARSE,
                           capacity=capacity, slot_ids=slot_ids, mask=mask,
                           device=self.device, value_bound=fold_bound)
        else:
            key, key_ok = self._key(plan, feed, pairs, n)
            out = agg_fold(plan.specs, cols, n, af.MODE_DENSE, key=key,
                           key_ok=key_ok, base=base, capacity=capacity,
                           mask=mask, device=self.device,
                           value_bound=fold_bound)

        def decode(fetched):
            present, overflow, states = af.decode(fetched[0], out.plan,
                                                  out.n_slots)
            self._check_overflow(overflow)
            return present, states
        return [out.buf], decode

    def _key(self, plan, feed, pairs, n) -> tuple:
        """The GROUP BY key's (values, validity), no validity for a bare
        column without NULLs (nothing to read)."""
        key, key_ok = eval_rpn(plan.key_rpn, pairs, n, torch, self.device)
        ci = _bare_col(plan.key_rpn)
        if ci is not None and not feed["null_flags"][ci]:
            key_ok = None
        return key, key_ok

    def _fold_cols(self, plan, feed, pairs, n) -> list:
        """Per aggregate its argument's (values, validity), None for
        COUNT(*); each distinct expression evaluated once (so aggregates
        over one argument share its tensors: one lane), and no validity
        for a bare column without NULLs."""
        evaluated: dict = {}
        cols = []
        for r in plan.agg_rpns:
            if r is None:
                cols.append(None)
                continue
            if r not in evaluated:
                v, ok = eval_rpn(r, pairs, n, torch, self.device)
                ci = _bare_col(r)
                if ci is not None and not feed["null_flags"][ci]:
                    ok = None
                evaluated[r] = (v, ok)
            cols.append(evaluated[r])
        return cols

    # -------------------------------------------- selection (scan_sel)

    _SEL_EWMA_ALPHA = 0.3
    _SEL_STATS_MAX = 256

    def _sel_keys(self, dag, plan) -> tuple:
        """(exact, shape) statistic keys: the const-inclusive plan key, and
        the table plus the const-blind predicate structure, so a workload
        rotating constants still warms (runner.py:1264-1327)."""
        if plan.sel_stat_key is None:
            plan.sel_stat_key = ("shape", getattr(plan.scan, "table_id", 0),
                                 sm.shape_key(plan))
        return dag.plan_key(), plan.sel_stat_key

    def _sel_stat(self, key, create: bool):
        st = self._sel_stats.get(key)
        if st is None and create:
            st = self._sel_stats[key] = {"ewma": None, "n_obs": 0}
            while len(self._sel_stats) > self._SEL_STATS_MAX:
                self._sel_stats.popitem(last=False)
        elif st is not None:
            self._sel_stats.move_to_end(key)
        return st

    def _sel_observe(self, keys, sel: float) -> None:
        a = self._SEL_EWMA_ALPHA
        with self._stats_mu:
            for key in keys:
                st = self._sel_stat(key, True)
                st["ewma"] = sel if st["ewma"] is None else \
                    a * sel + (1 - a) * st["ewma"]
                st["n_obs"] += 1

    def _sel_predict(self, keys) -> Optional[float]:
        """The EWMA selectivity after 3 observations (exact key first),
        else None: the request takes the mask route."""
        with self._stats_mu:
            for key in keys:
                st = self._sel_stat(key, False)
                if st is not None and st["n_obs"] >= 3:
                    return st["ewma"]
        return None

    def _note_route(self, route: str, table: Optional[dict] = None) -> None:
        """Count ``route`` in ``table`` (the scan_sel routes by default)."""
        table = self.sel_routes if table is None else table
        with self._stats_mu:
            table[route] = table.get(route, 0) + 1

    def _param(self, value, dtype: str) -> torch.Tensor:
        """A hoisted constant as a cached 0-d device tensor."""
        key = (type(value), value, dtype)
        t = self._params.get(key)
        if t is None:
            if len(self._params) >= self._plan_cache_max:
                self._params.pop(next(iter(self._params)))
            t = self._params[key] = torch.tensor(
                value, dtype=_TORCH_DTYPES[dtype], device=self.device)
        return t

    def _run_scan_sel(self, dag, plan, feed, n, get_batch,
                      storage) -> _Pending:
        """Selection with no terminal (runner.py:4186): one pass counts and
        packs the predicate mask (``_selection``: ``sel_pred``, or torch
        and ``sel_mask``; no bool mask is written), then the route the
        selectivity EWMA predicts ships the packed mask, the row indices
        (``sel_compact``, launched here too) or the rows themselves.  A
        cold plan takes the mask route; its count seeds the EWMA at the
        fetch.  An index or compact capacity that proves too small falls
        back to the packed mask, still on the device."""
        mout = self._selection(plan, feed, n, False)[0]
        keys = self._sel_keys(dag, plan)
        pred = self._sel_predict(keys)
        route, cap = sm.ROUTE_MASK, 0
        if pred is not None:
            k_est = pred * n
            cap = sm.index_capacity(k_est * 1.5 + 64, n)
            route = sm.choose_route(n, k_est, plan.compact_ok,
                                    idx_bytes=4 * cap)

        def gather(rows):
            return self._gather(dag, plan, storage, rows, get_batch)

        def mask_route(count: int, packed, fallback: bool):
            if fallback:
                self._note_route("mask_fallback")
            else:
                self._sel_observe(keys, count / n)
                self._note_route(sm.ROUTE_MASK)
            return gather(np.unpackbits(packed, count=n).view(np.bool_))

        if route == sm.ROUTE_MASK:
            return _Pending([mout.buf[:sm.HEADER + -(-n // 8)]],
                            lambda f: mask_route(*sm.mask_host(f[0]), False),
                            small=False)
        planes = []
        if route == sm.ROUTE_COMPACT:
            planes = [t for v, ok in self._planes(feed)
                      for t in ((v,) if ok is None else (v, ok))]
        cout = sm.sel_compact(mout, cap, planes)

        def finalize(fetched):
            count, overflow, idx, outs = cout.from_host(fetched[0])
            self._sel_observe(keys, count / n)
            if overflow:
                return mask_route(*mout.host(), True)
            self._note_route(route)
            if route == sm.ROUTE_INDEX:
                return gather(idx[:count].astype(np.int64))
            schema, cols = [], []
            at = iter(outs)
            for info, has_nulls in zip(plan.scan.columns,
                                       feed["null_flags"]):
                vals = next(at)[:count].astype(np.int64)
                valid = next(at)[:count].astype(np.bool_) if has_nulls \
                    else np.ones(count, np.bool_)
                schema.append(info.field_type)
                cols.append(Column(EvalType.INT, vals, valid))
            return SelectResult(ColumnBatch(schema, cols))
        return _Pending([cout.buf], finalize, small=False)

    # ---------------------------------------------------------------- top-n

    @staticmethod
    def _order_bounds(plan, host_cols) -> Optional[tuple]:
        """(least, greatest) non-NULL value of a bare order column in this
        snapshot — where ``topn_select`` places its digit — or None (a
        computed order expression, or no value)."""
        ci = _bare_col(plan.order_rpn)
        if ci is None:
            return None
        v, ok = host_cols()[ci]
        v = v[ok] if not ok.all() else v
        if not v.size:
            return None
        return v.min().item(), v.max().item()

    def _run_topn(self, dag, plan, feed, n, get_batch, storage, bounds):
        """TopN (runner.py:4391): the candidates on the device
        (``topn_select``, its digit placed by the order column's
        ``bounds``), then the exact order on the host — MySQL NULL order
        (first for ASC, last for DESC), rows the selection drops never,
        ties by row position."""
        if plan.limit == 0:
            return SelectResult(get_batch().take(np.empty(0, np.int64)))
        pairs, mask = self._inputs(plan, feed, n)
        ci = _bare_col(plan.order_rpn)
        if ci is not None:
            values, ok = self._planes(feed)[ci]
        else:
            # REAL columns are float64 planes here, REAL constants float64
            values, ok = eval_rpn(plan.order_rpn, pairs, n, torch,
                                  self.device, real=torch.float64)
            values, ok = values.contiguous(), ok.contiguous()
        n_used, seglen = tn.segments(n, feed["n_pad"])
        placement = tn.digit_placement(values.dtype, plan.order_desc,
                                       bounds)
        picked = tn.topn_select(values, ok, mask, plan.order_desc, n, n_used,
                                seglen, plan.limit, placement=placement)
        return _Pending([picked], lambda f: self._topn_rows(
            dag, plan, storage, get_batch, n, f[0]), small=False)

    @staticmethod
    def _topn_rows(dag, plan, storage, get_batch, n, host) -> SelectResult:
        """The TopN's rows from ``topn_select``'s fetched positions and
        flags: the candidates gathered, then ordered exactly."""
        gidx = host[0]
        live = (host[1] & 1 != 0) & (gidx < n)
        gidx, okk = gidx[live], host[1][live] & 2 != 0
        # the candidate rows only (a table scan gathers them from the
        # snapshot; an index scan's output is views of its sorted index)
        if isinstance(plan.scan, TableScanDesc) and \
                hasattr(storage, "gather_rows"):
            cand = storage.gather_rows(plan.scan, dag.ranges, gidx)
        else:
            cand = get_batch().take(gidx)
        ov, _ = eval_rpn(plan.order_host_rpn, [
            (c.values, c.validity) for c in cand.columns], len(gidx), np)
        ov = np.broadcast_to(ov, (len(gidx),))
        if plan.order_host_rpn.ret_type is EvalType.INT:
            # NULL smallest: first for ASC, last for DESC; clamped so the
            # negation cannot overflow
            lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
            vals = np.maximum(np.asarray(ov).astype(np.int64), lo + 2)
            skey = np.where(okk, -vals, hi) if plan.order_desc \
                else np.where(okk, vals, lo)
            order = np.lexsort((gidx, skey))
        else:
            keyf = np.where(okk, np.asarray(ov, np.float64), -np.inf)
            order = np.lexsort((gidx, -keyf if plan.order_desc else keyf))
        return SelectResult(cand.take(order[:plan.limit]))

    # -- empty scan --

    def _empty_result(self, plan) -> SelectResult:
        """The finalize of empty states — the reference's host answer for
        a scan that covers no row (every aggregate NULL, COUNT 0)."""
        if plan.kind == "simple_agg":
            empty = {"count": 0, "sum": 0, "nonnull": 0, "min": 0, "max": 0,
                     "pos": _BIG, "value": 0, "sumsq": 0.0}
            return self._simple_result(plan, [empty] * len(plan.specs))
        zero = np.zeros(2, np.int64)        # the NULL and scrap slots
        empty = dict.fromkeys(("count", "sum", "nonnull", "min", "max",
                               "sumsq"), zero)
        return self._hash_result(plan, {"present": zero > 0,
                                        "states": [empty] * len(plan.specs)},
                                 0, 0)
