"""Device coprocessor backend on one CUDA device.

Counterpart of the JAX package's ``device/runner.py`` ``DeviceRunner``,
reduced to one device.  A DAG request is a scan
head — a TableScan, or an IndexScan over one indexed column (and the
handle) — then Selection*, then one terminal or none (the reference's
analyzer, runner.py:1362-1487):

- Aggregation (COUNT, SUM, AVG, MIN, MAX, FIRST, VAR_POP/VAR_SAMP/
  STDDEV_POP/STDDEV_SAMP, at most one INT GROUP BY key; of a DATETIME or
  DURATION argument only COUNT, MIN, MAX and FIRST);
- TopN with one order key and ``limit ≤ topn.MAX_LIMIT`` (``topn``);
- none, with at least one selection (``scan_sel``).

It runs as:

- the used columns are uploaded once per snapshot as a padded feed that
  stays on the device (``_pad_rows``/``_build_flat``, the reference's
  feed buckets, so feed shapes line up with the reference's); INT and
  DURATION columns are int32 when their values fit, else int64, DATETIME
  columns the int64 bits of their cores, REAL columns float32 —
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

On a mesh (``DeviceRunner(mesh=make_mesh(...))``, ``parallel/mesh.py``;
the reference's scale-up half, runner.py:640-720, 1513-1600) every feed is
row-sharded: each plane is cut into S contiguous slices of ``n_pad / S``
rows, slice s its own tensor on mesh device s, shard s holding rows
``[s·n_local, s·n_local + clip(n − s·n_local, 0, n_local))``.  Each shard
with live rows runs the routes above over its own slice, in device order
(``_per_shard``), and the partials merge on the mesh's first device: the
summed states (hash_agg's packed outputs, the two-level planes, a simple
fold's counts and sums) by one ``shard.shard_psum``
(``csrc/shard_merge.cu``); a GROUP BY fold's counts, sums and MIN/MAX rows
together by one ``shard.shard_merge``; a simple aggregation's MIN, MAX
and FIRST on the host (phase ``shard_merge``).  A selection concatenates
the shards' packed masks (or their row indices, each offset by its
shard's first row), a TopN orders the shards' candidates on the host.
The GROUP BY dictionary of a sparse key is built once from the whole
snapshot.  The cold mint, the split
stash, the device split, the compact route, stacked batches and ANALYZE
stay single-device, as in the reference (a mesh's ANALYZE is served by
the host half).  The ``device::shard_launch`` failpoint fails a shard's
launches: the whole request is then answered by the host pipeline
(``degrades``), never by the shards that did launch.  A mesh of one device
takes the single-device code.

With ``placement=True`` a mesh also serves scale-out (runner.py:682-1090,
``device/placement.py``): a ``SlicePlacer`` owns one single-device
sub-runner a slice and routes each request's feed anchor to one by load
and resident bytes; a feed of ``placement_rows`` rows or more stays on the
whole mesh.  A ``SliceHealthBoard`` (``device/supervisor.py``) scores each
slice: dispatch, fetch and scrub faults strike it (``device::slice_dead``
names dead slices), a tripped slice refuses dispatch and its anchors drain
to healthy slices by migration — ``extract_feeds`` on the source, a
device-to-device copy, then ``install_feeds``, whose arrival check is one
``digest.feed_verify`` launch (``csrc/digest.cu``) against the digests
that travelled —, a whole-mesh plan runs on the largest healthy submesh
(its feeds minted again there; the host pipeline only when that rebuild
fails), a deferred request whose slice died before its fetch is served
once more through the root (``_rescue``), and a half-open canary
re-admits the slice with a decayed score.  Without ``placement`` none of
this exists and a mesh runs as above.

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

Feeds live in the runner's ``FeedArena`` (``device/supervisor.py``), one
bucket per feed anchor: a snapshot's ``feed_lineage`` (a columnar cache
line's identity, ``copr.region_cache``), else the snapshot itself.  The
bucket holds the anchor's feeds and its per-plan memos; the arena counts
their bytes against ``hbm_budget_bytes`` (0: no budget) and evicts the
least used unpinned anchors past it; an in-flight request pins its anchor
until its fetch; a retired cache line drops its anchor (``drop_feed``).
A feed whose lineage moved on is patched forward from the lineage's
journal (``_try_patch_feed``, label ``patch``: each journal patch one
``digest.patch_feed_spans`` launch over every plane, its digests kept by
R' = R − H(old) + H(new)); a row-sharded feed, a structural patch, a
crossed pad bucket or a value its plane cannot hold re-uploads instead.
A feed miss (``_get_feed``, labelled per request ``device_feed`` and
counted in ``feed_routes``) takes, in order: the split stash — a child
feed that a device split sliced from the parent's resident planes and
verified against the child's host digests (``split_resident_feeds``:
``split.split_planes``, the CUDA kernel ``csrc/split.cu``, one launch a
child) —; then the lineage's ``ColdFeedBundle`` of a cold build, minted on
the device (``mvcc.mvcc_resolve``, ``csrc/mvcc.cu``); then the upload.
Only an ascending TableScan is positional: it alone takes a stash or a
bundle, and only its feeds over every row are split.  Every feed records
a digest of each plane from the host truth; ``scrub_feed`` re-hashes the
resident planes (``digest.plane_digest``, ``csrc/digest.cu``) and names
those that differ; ``quarantine`` drops a diverged anchor's feeds and
answers its next request on the host (``FeedQuarantined``, which the
endpoint degrades), the one after uploads.

Cases outside the device envelope are refused, never served on the CPU
by the runner: plans (``supports`` is False; ``handle_request`` raises
NotImplementedError) — among them any plan with a sig whose
``RpnFnMeta.device_safe`` is False —, more than ``MAX_HASH_CAPACITY``
distinct GROUP BY keys, and a DATETIME core at or above 2^63
(``FeedBeyondInt64``, a ``DeviceUnavailable`` the endpoint degrades).  The
endpoint (``copr/endpoint.py``) serves them on the host pipeline
(``executors/``), as the reference does.  Each refusal names its
ROADMAP.md item.  An empty scan gets the host pipeline's answer: the
finalize of empty states, or no rows.  ``joiner()`` is the runner's
``DeviceJoiner``: the plan IR's join, sort and window fragments.
``handle_analyze`` answers an ANALYZE request: each INT, REAL, DATETIME
and DURATION column summarised on the card (``analyze.analyze_column``,
the CUDA kernel ``csrc/analyze.cu``: a counting route for narrow key
spans, a partition into buckets for wide ones; one wait a request), every
other column by the host half (``copr.analyze``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
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
from ..expr import build_rpn, eval_rpn
from ..expr.eval import _TORCH_DTYPES, narrow_int32
from ..expr.rpn import RpnColumnRef, RpnConst, RpnExpression, RpnFnCall
from ..ops.agg import _BIG, AggSpec, finalize_hash, finalize_simple
from ..utils import tracker
from ..utils.failpoint import fail_point
from . import DEVICE_FAULTS, DeviceUnavailable, FeedQuarantined
from . import agg_fold as af
from . import hash_agg as ha
from . import kernels as kn
from . import resolve_device
from . import selection as sm
from . import shard as sh
from . import split as sp
from . import topn as tn
from .agg_fold import agg_fold
from .deferred import (DeferredResult, _BatchedSelectionGroup,
                       _BatchUnavailable, _GroupPending, _Pending)
from .digest import (_INT_OF_WIDTH, as_u64, feed_verify, patch_feed_rows,
                     patch_feed_spans,
                     plane_digest)
from .supervisor import FeedArena, hash_workers, start_plane_digests
from .twolevel import twolevel_fused

# DATETIME (the packed u64 core, whose bit layout keeps time order) and
# DURATION (int64 ns) are dense columns on the device: comparisons, top-k
# and COUNT/MIN/MAX/FIRST take the INT kernels.  A DATETIME plane holds the
# core's bits as int64 (``_plane_dtype``), exact and in order below 2^63;
# a column with a core at or above it (year >= 8192) is refused at its feed
# (``FeedBeyondInt64``), as the reference's feed guard sends it to the host
_DEVICE_ETS = (EvalType.INT, EvalType.REAL, EvalType.DATETIME,
               EvalType.DURATION)
_TIME_ETS = (EvalType.DATETIME, EvalType.DURATION)
# the selection's routes (``_Plan.sel_route``, counted in ``pred_routes``)
PRED_KERNEL, PRED_TORCH = "sel_pred", "torch"
# how a feed was built (counted in ``feed_routes``)
FEED_SPLIT, FEED_DEVICE_RESOLVE, FEED_UPLOAD, FEED_PATCH = \
    "split", "device_resolve", "upload", "patch"
# the reference's device aggregate set (runner.py:1401-1407)
_DEVICE_AGGS = ("count", "count_star", "sum", "avg", "min", "max", "first",
                "var_pop", "var_samp", "stddev_pop", "stddev_samp")

# widest dense GROUP BY key span (the reference's max_hash_capacity,
# runner.py:632); beyond it the keys are dictionary-encoded
MAX_HASH_CAPACITY = 1 << 20

# where each case outside this port is to be served (ROADMAP.md, queue 1)
_TODO_AGG = ("ROADMAP.md queue 1 item 3 (bit aggregates, multi-key GROUP "
             "BY, FIRST with GROUP BY and over 2^20 distinct keys: the "
             "endpoint's host pipeline serves them)")
_TODO_HOST = ("ROADMAP.md queue 1 item 6 (bare scans, projections, limits, "
              "multi-column indexes and the other plans the reference "
              "serves on the host: the endpoint's host pipeline serves "
              "them)")
_TODO_STORAGE = "ROADMAP.md queue 1 item 6 (production read path)"
# what the reference serves on its host pipeline too (no queue item)
_HOST_ONLY = "served by the endpoint's host pipeline, as in the reference"


class FeedBeyondInt64(DeviceUnavailable):
    """A DATETIME column of the request holds a packed core at or above
    2^63 (a year of 8192 or more), which its int64 plane cannot hold in
    order (runner.py:3150-3164).  The verdict is kept for the snapshot's
    columns; the endpoint answers on the host unless the device was
    forced."""

    reason = "beyond_int64"


def _plane_dtype(col) -> str:
    """The feed plane dtype of a scan column: DATETIME as int64 bits,
    every other type by ``tile._device_dtype`` (DURATION as INT is)."""
    if col.eval_type is EvalType.DATETIME:
        return "int64"
    return str(_device_dtype(col.eval_type, col.values))


def _beyond_int64(col) -> bool:
    return col.eval_type is EvalType.DATETIME and col.values.size > 0 and \
        int(col.values.max()) >= 1 << 63


def _fits_dtype(vals: np.ndarray, valid, dt: np.dtype) -> bool:
    """May ``vals`` be held in a feed plane of dtype ``dt``
    (runner.py:126-140)?  A float narrows as a fresh upload's astype does;
    an integer must lie in the dtype's range (a uint64 below 2^63), its
    NULL rows aside."""
    if dt.kind not in "iu":
        return True
    live = vals if valid is None or valid.all() else vals[valid]
    if not live.size:
        return True
    lo, hi = int(live.min()), int(live.max())
    if dt == np.dtype(np.uint64):
        return 0 <= lo and hi < (1 << 63)
    info = np.iinfo(dt)
    return info.min <= lo and hi <= info.max


# the plan memo's constants derived from the data (``_refresh_meta``)
_DERIVED = ("dtypes", "hash_bounds", "plan", "arg_nbytes", "fold_bound",
            "order_bounds")


def _pin_dtypes(meta: dict, dtypes: tuple) -> None:
    """Record the plane dtypes a plan's memo derives its constants under;
    a memo derived under other dtypes loses them."""
    if meta.get("dtypes", dtypes) != dtypes:
        for k in _DERIVED:
            meta.pop(k, None)
    meta["dtypes"] = dtypes


def _journal_spans(lineage, from_v: int, to_v: int) -> Optional[list]:
    """The dirty spans of the lineage's patches ``from_v`` → ``to_v``, or
    None when the gap holds a structural patch or the journal no longer
    covers it."""
    patches = lineage.since(from_v, until=to_v)
    if patches is None or any(p.get("structural") for p in patches):
        return None
    return [sp for p in patches for sp in p["spans"]]


def _span_col(span, info):
    """(values, validity or None) of ``info``'s column in a journal span,
    or None when the span does not carry it."""
    if info.is_pk_handle:
        return span["handles"], None
    return span["cols"].get(info.col_id)


def _span_pairs(span, infos) -> Optional[list]:
    """The span's (values, validity) a plane, NULL rows holding 0 (as a
    column's do), or None when a column is missing."""
    out = []
    for info in infos:
        got = _span_col(span, info)
        if got is None:
            return None
        v, ok = got
        ok = np.ones(len(v), np.bool_) if ok is None else ok
        out.append((np.where(ok, v, 0) if not ok.all() else v, ok))
    return out


def _live(got) -> np.ndarray:
    """The non-NULL values of a span column's (values, validity)."""
    vals, ok = got
    return vals if ok is None or ok.all() else vals[ok]


def _dtypes_hold(spans, infos, planes, dtypes) -> bool:
    """Every dirty value fits its plane's dtype (a float64 order plane
    holds any)."""
    if spans is None:
        return False
    for j, (info, (_ci, override)) in enumerate(zip(infos, planes)):
        if override is not None:
            continue
        for sp in spans:
            got = _span_col(sp, info)
            if got is None or not _fits_dtype(got[0], got[1],
                                              np.dtype(dtypes[j])):
                return False
    return True


def _keys_hold(spans, infos, key_rpn, base: int, span: int) -> bool:
    """Every dirty row's GROUP BY key lies in [base, base + span)."""
    for sp in spans:
        pairs = _span_pairs(sp, infos)
        if pairs is None:
            return False
        m = len(sp["handles"])
        kv, km = eval_rpn(key_rpn, pairs, m, np)
        live = np.broadcast_to(kv, (m,))[np.broadcast_to(km, (m,))]
        if live.size and (int(live.min()) < base or
                          int(live.max()) >= base + span):
            return False
    return True


def _widths_hold(spans, infos, agg_rpns, arg_nbytes) -> bool:
    """Every dirty value of a bare SUM/AVG argument needs no more byte
    planes than its width."""
    for r, nb in zip(agg_rpns, arg_nbytes):
        ci = _bare_col(r)
        if not nb or ci is None:
            continue    # REAL, another kind, or the width of a dtype
        for sp in spans:
            got = _span_col(sp, infos[ci])
            if got is None:
                return False
            live = _live(got)
            if live.size and kn.int_planes_needed(
                    int(live.min()), int(live.max())) > nb:
                return False
    return True


def _bounds_hold(spans, infos, bounds) -> bool:
    """Every dirty value (0 at a NULL) lies within its plane's (least,
    greatest) bounds of the int32 narrowing's proof."""
    for sp in spans:
        pairs = _span_pairs(sp, infos)
        if pairs is None:
            return False
        for (v, _ok), b in zip(pairs, bounds):
            if b is not None and v.size and (int(v.min()) < b[0] or
                                             int(v.max()) > b[1]):
                return False
    return True


def _fold_bound_holds(spans, infos, agg_rpns, dtypes, bound) -> bool:
    """Every dirty value of an int32 INT argument has |v| ≤ ``bound``."""
    if bound is None:
        return True     # a computed argument: no value bound was taken
    if dtypes is None:
        return False
    for r in agg_rpns:
        ci = _bare_col(r)
        if ci is None or r.ret_type is not EvalType.INT or \
                dtypes[ci] != "int32":
            continue
        for sp in spans:
            got = _span_col(sp, infos[ci])
            if got is None:
                return False
            live = _live(got)
            if live.size and max(-int(live.min()), int(live.max())) > bound:
                return False
    return True


def _order_bounds_hold(spans, infos, order_rpn, bounds) -> bool:
    """Every dirty non-NULL value of the bare order column lies within the
    (least, greatest) bounds the top-k digit was placed by."""
    ci = _bare_col(order_rpn)
    if ci is None:
        return True
    for sp in spans:
        got = _span_col(sp, infos[ci])
        if got is None:
            return False
        live = _live(got)
        if live.size and (bounds is None or live.min() < bounds[0] or
                          live.max() > bounds[1]):
            return False
    return True


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _rpn_col_indices(rpn: RpnExpression) -> set:
    return {n.col_idx for n in rpn.nodes if isinstance(n, RpnColumnRef)}


def _remap_rpn(rpn: RpnExpression, mapping: dict) -> RpnExpression:
    return RpnExpression(tuple(
        RpnColumnRef(mapping[n.col_idx], n.eval_type)
        if isinstance(n, RpnColumnRef) else n for n in rpn.nodes))


def _rpn_device_safe(rpn: RpnExpression, scan_ets: Sequence[EvalType]) -> bool:
    """Every column of a device type, every constant a number an int64 or
    float holds, every call device-safe (a host-only body would meet a
    tensor) and of a device type."""
    for n in rpn.nodes:
        if isinstance(n, RpnConst):
            if n.value is not None and \
                    not isinstance(n.value, (int, float, bool)):
                return False
            if isinstance(n.value, int) and \
                    not -(1 << 63) <= n.value < 1 << 63:
                return False
        elif isinstance(n, RpnColumnRef):
            if n.col_idx >= len(scan_ets) or \
                    scan_ets[n.col_idx] not in _DEVICE_ETS:
                return False
        elif isinstance(n, RpnFnCall):
            if n.meta.ret not in _DEVICE_ETS or not n.meta.device_safe:
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
    _fp_fault_as(name, DeviceUnavailable)


def _fp_fault_as(name: str, exc) -> None:
    if fail_point(name) is not None:
        raise exc(f"failpoint {name}")


class _ShardLaunchFault(Exception):
    """A shard's launches failed (the ``device::shard_launch`` failpoint):
    the whole request goes to the host pipeline."""


class _SliceDead(DeviceUnavailable):
    """A slice of a placement mesh cannot serve: ``device::slice_dead``
    names it at a dispatch or a fetch, or no healthy submesh can be built.
    A dispatch answers on the host pipeline; a fetch is rescued through the
    root runner first (``_rescue``)."""


def _on_device(dev: torch.device):
    """The context that makes ``dev`` current for its launches."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _fold_merge_rows(plan: "af.FoldPlan", n_slots: int) -> tuple:
    """The cross-shard merge of an ``agg_fold`` buffer: (``shard_psum``
    segments of its summed words — the overflow flag, row counts, non-NULL
    counts and integer sums as int64, the float sums as float64, adjacent
    segments of one op joined —, its MIN/MAX rows as (row, op) over the
    int64 order images, its FIRST rows as {lane: {state: row}})."""
    sums, stacked, first = [(0, 1, "sum_i64")], [], {}
    for r, (state, j) in enumerate(plan.rows):
        off = 1 + r * n_slots
        if state in ("min", "max"):
            stacked.append((r, state + "_i64"))
            continue
        if state in ("first", "firstval", "firstok"):
            first.setdefault(j, {})[state] = r
            continue
        op = "sum_f64" if state in ("fsum", "sumsq") else "sum_i64"
        lo, n, prev = sums[-1]
        if prev == op and lo + n == off:
            sums[-1] = (lo, n + n_slots, op)
        else:
            sums.append((off, n_slots, op))
    return sums, stacked, first


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
    """Executes the port's plans on one device or on a mesh.

    ``device``: ``None`` (``cuda:0``), a CUDA device, or ``"cpu"`` — the
    plain PyTorch version of every kernel, which the tests use.  Without
    CUDA, only ``"cpu"`` constructs.  ``mesh`` (``parallel.make_mesh``;
    not with ``device``): row-shard every feed over its devices, which may
    repeat.  ``chunk_rows``: the feed's block of rows over all shards
    (rounded down to 8-row multiples a shard), for small test feeds;
    without it a shard's block is ``hash_agg.BLOCK``, padded to the
    reference's 9/8-geometric bucket.
    ``hbm_budget_bytes``: the feed arena's budget (0: none).
    ``placement`` (a mesh of more than one device): scale-out routing over
    single-device slices (``placer``), feeds of ``placement_rows`` rows or
    more (``placement.DEFAULT_WHOLE_MESH_ROWS``) on the whole mesh, and
    the slices' failure domain, a ``SliceHealthBoard``: a slice trips at
    ``slice_trip_strikes`` strikes (None: ``supervisor.DEFAULT_TRIP_STRIKES``), a served fetch of
    ``slice_latency_outlier_s`` seconds or more strikes 0.25 (None or 0:
    no latency strikes), and the half-open probe waits
    ``slice_probe_cooldown_s`` after a trip.
    """

    def __init__(self, device=None, mesh=None,
                 chunk_rows: Optional[int] = None,
                 hbm_budget_bytes: int = 0, placement: bool = False,
                 placement_rows: Optional[int] = None,
                 slice_probe_cooldown_s: Optional[float] = None,
                 slice_latency_outlier_s: Optional[float] = None,
                 slice_trip_strikes: Optional[float] = None):
        if device is not None and mesh is not None:
            raise ValueError("give a device or a mesh, not both")
        self._mesh = mesh
        # the mesh's devices in flat ("range", "tile") order: shard s of a
        # feed lives on _devices[s]; merges and readbacks on the first
        self._devices = [resolve_device(device)] if mesh is None else \
            [resolve_device(d) for d in mesh.devices.flat]
        self.device = self._devices[0]
        S = len(self._devices)
        self._single = S == 1
        self._chunk_override = chunk_rows is not None
        if chunk_rows is not None:
            self._block_local = max(8, ((max(chunk_rows, 8) // S) // 8) * 8)
        else:
            # a shard's slice splits into whole hash_agg blocks, so the
            # fused kernel's gate holds per shard (pallas_hash.py:180-195)
            self._block_local = ha.BLOCK
        # the requests answered by the host pipeline for a shard's failed
        # launches, by failpoint
        self.degrades: dict = {}
        # plan_key → (plan | None, refusal reason); FIFO-bounded
        self._plan_cache: dict = {}
        self._plan_cache_max = 4096
        # feed anchor → bucket: {feed_key: feed, ("meta", ...): per-plan
        # memo, ("dtypes", ...): the feed planes' dtypes}; a memo holds one
        # lineage version, rolled forward across the journal's patches by
        # what they provably leave valid (``_request_meta``)
        self._arena = FeedArena(budget_bytes=hbm_budget_bytes)
        # the plan memos rolled forward: "kept" (the derived constants
        # survived the gap), "dropped" (derived again); ``last_refresh``
        # holds the last roll-forward's record, field by field
        self.memo_routes: dict = {}
        self.last_refresh: Optional[dict] = None
        # host-clock ms by phase of the last split_resident_feeds
        self.split_phases_ms: dict = {}
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
        # -- scale-out and its failure domain (placement only) --
        # _board: this mesh's slice health (the root runner's); _health:
        # the slice this runner is; _failover_parent: the root that
        # rescues; _slice_indices: the root mesh's indices of my devices
        # (what device::slice_dead names)
        self._chunk_rows = chunk_rows
        self._board = None
        self._health = None
        self._failover_parent = None
        self._slice_indices = tuple(range(S))
        # (frozenset of dead slices, the runner over the healthy submesh)
        self._degraded: Optional[tuple] = None
        self._degrade_mu = threading.Lock()
        # the failure domain's events on the root: rescue, mesh_downsize,
        # mesh_restore
        self.failure_events: dict = {}
        # host-clock ms by phase of the last install_feeds
        self.migrate_phases_ms: dict = {}
        # scrub-quarantined anchors: id(anchor) → (anchor, reason).  The
        # next request of a quarantined anchor is answered on the host (its
        # feeds were dropped at the quarantine), the one after uploads from
        # host truth.  Its own lock: the scrub thread quarantines while
        # request threads consume
        self._quarantined: dict = {}
        self._quar_mu = threading.Lock()
        self._placer = None
        if placement and not self._single:
            from .placement import DEFAULT_WHOLE_MESH_ROWS, SlicePlacer
            from .supervisor import DEFAULT_PROBE_COOLDOWN_S, SliceHealthBoard
            from .supervisor import DEFAULT_TRIP_STRIKES
            self._board = SliceHealthBoard(
                S, trip_strikes=DEFAULT_TRIP_STRIKES
                if slice_trip_strikes is None else slice_trip_strikes,
                cooldown_s=DEFAULT_PROBE_COOLDOWN_S
                if slice_probe_cooldown_s is None
                else slice_probe_cooldown_s,
                latency_outlier_s=slice_latency_outlier_s)
            self._placer = SlicePlacer(
                self, whole_mesh_rows=DEFAULT_WHOLE_MESH_ROWS
                if placement_rows is None else placement_rows)

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
        # a sig that no registry knows raises here (``build_rpn``'s
        # ValueError), as in the reference; a known host-only sig (the JSON,
        # string, DECIMAL families) is refused by ``_rpn_device_safe``
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
                if r.ret_type in _TIME_ETS and a.kind not in (
                        "count", "min", "max", "first"):
                    # SUM/AVG/variance of a time value (runner.py:1408)
                    return None, (f"{a.kind.upper()} over "
                                  f"{r.ret_type.value}: {_HOST_ONLY}")
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
                return None, (f"a host-only function, column or constant: "
                              f"{_HOST_ONLY}")

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

    def _nshards(self) -> int:
        return len(self._devices)

    def _feed_unit(self) -> int:
        """Rows of one feed block: a block of every shard."""
        return self._nshards() * self._block_local

    def _pad_rows(self, n: int) -> int:
        unit = self._feed_unit()
        blocks = max(1, -(-n // unit))
        # bucket the block count into the reference's 9/8-geometric grid
        # (one block of growth headroom first, then a 4-significant-bit
        # count k·2^s, 8 ≤ k ≤ 15), so feed shapes match its feeds; a
        # chunk_rows override pads to whole blocks only (runner.py:1536)
        if not self._chunk_override and blocks > 8:
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

    def _upload_sharded(self, arr: np.ndarray, n_pad: int) -> list:
        """``arr`` padded to ``n_pad`` rows on the host, then slice s of
        ``n_pad / S`` rows to mesh device s (runner.py:1566-1574)."""
        p = np.zeros(n_pad, dtype=arr.dtype)
        p[:len(arr)] = arr
        nl = n_pad // self._nshards()
        return [torch.from_numpy(p[s * nl:(s + 1) * nl]).to(dev)
                for s, dev in enumerate(self._devices)]

    def _shard_feeds(self, per_shard: list, flags: tuple, n: int,
                     n_pad: int) -> list:
        """Shard s's feed: its planes, ``n_pad / S`` rows, ``clip(n −
        base, 0, n_local)`` live from its first row ``base = s·n_local``,
        on its device."""
        nl = n_pad // self._nshards()
        return [{"flat": tuple(planes), "null_flags": flags, "n_pad": nl,
                 "n_live": min(max(n - s * nl, 0), nl), "base": s * nl,
                 "device": self._devices[s]}
                for s, planes in enumerate(per_shard)]

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
            if self._single:
                flat = tuple(self._upload(a, n_pad) for a in hosts)
                return {"flat": flat, "null_flags": flags, "n_pad": n_pad,
                        "digests": digests(), "n_live": n}
            # row-sharded: "flat" holds every shard's planes, shard-major
            # (the arena's bytes), "shards" each shard's feed
            per_shard = [list(x) for x in zip(*(
                self._upload_sharded(a, n_pad) for a in hosts))] \
                if hosts else [[] for _ in self._devices]
            return {"flat": tuple(t for planes in per_shard for t in planes),
                    "null_flags": flags, "n_pad": n_pad,
                    "digests": digests(), "n_live": n,
                    "shards": self._shard_feeds(per_shard, flags, n, n_pad)}

    @staticmethod
    def _feed_anchor(storage):
        """The arena key of ``storage``'s feeds and memos: its
        ``feed_lineage`` (stable across the snapshots a cache line
        publishes), else the snapshot itself."""
        lineage = getattr(storage, "feed_lineage", None)
        return storage if lineage is None else lineage

    @staticmethod
    def _feed_version(storage) -> Optional[int]:
        """The lineage version ``storage``'s data reflects, or None."""
        lineage = getattr(storage, "feed_lineage", None)
        if lineage is None:
            return None
        v = getattr(storage, "feed_version", None)
        return lineage.version if v is None else v

    def _bucket(self, storage) -> dict:
        """``storage``'s arena bucket (a throwaway dict when its anchor
        cannot be tracked: nothing is cached then)."""
        got = self._arena.bucket(self._feed_anchor(storage))
        return {} if got is None else got

    def _get_feed(self, storage, st, feed_key, plan, planes, dtypes,
                  host_cols, n: int) -> dict:
        """The request's feed (runner.py:1622-1716): the resident one when
        its lineage version is the request's, or patched forward to it from
        the lineage's journal (``_try_patch_feed``); else the split stash's
        child feed of this shape (patched forward too when the child moved
        on); else the cold bundle minted on the device; else an upload.  A
        read of an older generation (served from the line's history) gets a
        feed of its own, never cached: the shared one is not taken back."""
        lineage = getattr(storage, "feed_lineage", None)
        req_v = self._feed_version(storage)
        anchor = self._feed_anchor(storage)
        used_infos = [plan.scan.columns[ci] for ci, _ in planes]
        # only an ascending table scan maps feed rows to line rows; a mesh
        # re-mints: no patch, no split stash, no cold bundle (runner.py:1111,
        # :2223; ROADMAP.md queue 1 item 10)
        positional = isinstance(plan.scan, TableScanDesc) and \
            not plan.scan.desc and self._single
        feed = st.get(feed_key)
        if feed is not None:
            fv = feed.get("lineage_v")
            if lineage is None or fv == req_v:
                tracker.label("device_feed", "hit")
                return feed
            if fv is not None and req_v is not None and fv > req_v:
                tracker.label("device_feed", FEED_UPLOAD)
                self._note_route(FEED_UPLOAD, self.feed_routes)
                with tracker.phase("feed_upload"):
                    return self._build_flat(host_cols(), n)
            if positional and self._try_patch_feed(feed, lineage, used_infos,
                                                   dtypes, n, req_v):
                tracker.label("device_feed", FEED_PATCH)
                self._note_route(FEED_PATCH, self.feed_routes)
                self._register_digests(lineage, feed_key, feed)
                return feed
        route = None
        if lineage is not None and positional and lineage.split_stash:
            feed = self._take_split_feed(lineage, feed_key, n)
            if feed is not None and (
                    feed.get("lineage_v") == req_v or self._try_patch_feed(
                        feed, lineage, used_infos, dtypes, n, req_v)):
                route = FEED_SPLIT
            else:
                feed = None
        if route is None and lineage is not None and \
                lineage.cold_bundle is not None:
            if positional:
                bundle = lineage.take_cold(req_v)
                feed = None if bundle is None else bundle.mint(
                    self, used_infos, dtypes, n, self._pad_rows(n))
                if feed is not None:
                    route = FEED_DEVICE_RESOLVE
            else:
                # an index or descending scan cannot take the bundle:
                # release the version planes now
                lineage.drop_cold()
        if route is None:
            route = FEED_UPLOAD
            with tracker.phase("feed_upload"):
                feed = self._build_flat(host_cols(), n)
        if route != FEED_SPLIT:
            feed["lineage_v"] = req_v
            if positional:
                self._mark_splittable(feed, used_infos)
        tracker.label("device_feed", route)
        self._note_route(route, self.feed_routes)
        st[feed_key] = feed
        # under the dispatch lock: the budget may evict other, unpinned
        # anchors (or refuse this one: the request still serves from feed)
        self._arena.admit(anchor)
        self._register_digests(lineage, feed_key, feed)
        return feed

    def _try_patch_feed(self, feed, lineage, used_infos, dtypes, n: int,
                        req_v) -> bool:
        """Replay the lineage's journal onto ``feed`` in place of an upload
        (runner.py:1727-1791) → True when the feed now reflects ``req_v``.
        Refused (nothing written) for a row-sharded feed, a gap the journal
        no longer covers or that holds a structural patch, a ranged feed
        (its rows do not map 1:1), a row count that crosses the feed's pad
        bucket, a value outside its plane's dtype, and the first NULL of a
        column whose feed has no validity plane.  Every value is checked
        before the first write: one ``patch_feed_spans`` launch a journal
        patch with spans, over every plane of the feed, keeps each plane's
        digest by R' = R − H(old) + H(new)."""
        if "shards" in feed or feed.get("digests") is None:
            return False
        patches = lineage.since(feed.get("lineage_v", -1), until=req_v)
        if patches is None or any(p.get("structural") for p in patches):
            return False
        if patches and patches[-1]["n"] != n:
            return False
        if self._pad_rows(max(n, 1)) != feed["n_pad"]:
            return False
        work = []       # (spans, the values of every flat plane)
        for p in patches:
            spans = p["spans"]
            if not spans:
                continue
            flat_vals = []
            for j, info in enumerate(used_infos):
                dt = np.dtype(dtypes[j])
                if info.is_pk_handle:
                    vals = np.concatenate([s["handles"] for s in spans])
                    valid = None
                else:
                    parts = [s["cols"].get(info.col_id) for s in spans]
                    if any(c is None for c in parts):
                        return False
                    vals = np.concatenate([v for v, _ in parts])
                    valid = np.concatenate([ok for _, ok in parts])
                if not _fits_dtype(vals, valid, dt):
                    return False
                has_nulls = feed["null_flags"][j]
                if valid is not None and not has_nulls and not valid.all():
                    return False
                flat_vals.append(np.ascontiguousarray(
                    vals.astype(dt, copy=False)))
                if has_nulls:
                    flat_vals.append(np.ascontiguousarray(
                        valid if valid is not None
                        else np.ones(len(vals), np.bool_)))
            work.append(([(s["lo"], s["hi"]) for s in spans], flat_vals))
        with tracker.phase("feed_patch"):
            for spans, flat_vals in work:
                self._patch_plane(feed, spans, flat_vals)
        feed["lineage_v"] = req_v
        feed["n_live"] = n
        return True

    @staticmethod
    def _register_digests(lineage, feed_key, feed) -> None:
        """Mirror the feed's plane digests into its lineage's record."""
        if lineage is not None and feed.get("digests") is not None:
            lineage.feed_digests[feed_key] = (feed.get("lineage_v"),
                                              feed["digests"])

    @staticmethod
    def _mark_splittable(feed: dict, used_infos) -> None:
        """A positional feed records which of its columns is the pk handle
        (a split child's digests re-anchor to the child's host handles)."""
        feed["positional"] = True
        feed["pk_flags"] = tuple(bool(i.is_pk_handle) for i in used_infos)

    def _take_split_feed(self, lineage, feed_key, n: int):
        """Pop the stashed child feed of this request's shape (one-shot):
        the same columns and dtypes, ``n`` live rows, and the pad bucket
        this runner gives ``n`` (runner.py:2060-2080)."""
        stash = lineage.split_stash
        if not stash:
            return None
        _scan, col_ids, dtypes, _ranges = feed_key
        want_pad = self._pad_rows(max(n, 1))
        for i, cand in enumerate(stash):
            f = cand["feed"]
            if cand["col_ids"] == col_ids and \
                    cand["dtypes"] == tuple(dtypes) and \
                    f.get("n_live") == n and f.get("n_pad") == want_pad:
                del stash[i]
                return dict(f)
        return None

    # ------------------------------------------------------ lifecycle

    def _sub_runners(self) -> list:
        """The placement slices and the degraded submesh runner, if any:
        the runners whose arenas this one's statistics fold in."""
        subs = list(self._placer.slices) if self._placer is not None else []
        degraded = self._degraded_sub()
        return subs + ([degraded] if degraded is not None else [])

    def arena_items(self) -> list:
        """(anchor, bucket) of every resident anchor (a placement mesh's
        slices and degraded submesh included)."""
        items = self._arena.items()
        for r in self._sub_runners():
            items.extend(r.arena_items())
        return items

    def resident_feeds(self, storage) -> dict:
        """{feed key: feed} resident for ``storage``'s anchor."""
        bucket = self._arena.bucket(self._feed_anchor(storage),
                                    create=False)
        return {k: v for k, v in (bucket or {}).items()
                if isinstance(v, dict) and "flat" in v}

    def pinned_readback_stats(self) -> dict:
        """The pinned D2H staging pool's rollup (``/health``'s fastpath
        block; runner.py:1862)."""
        from .deferred import HOST_STAGER
        return HOST_STAGER.stats()

    def hbm_stats(self) -> dict:
        """The arena's accounting and the anchors quarantined; a placement
        mesh adds its slices' and its degraded submesh's (runner.py:
        1862-1880)."""
        out = self._arena.stats()
        with self._quar_mu:
            out["quarantined"] = len(self._quarantined)
        for r in self._sub_runners():
            sub = r.hbm_stats()
            for k in ("resident_bytes", "resident_lines", "pinned_lines",
                      "pinned_bytes", "evictions", "rejections", "drops",
                      "quarantined"):
                out[k] += sub[k]
        return out

    def set_hbm_budget(self, nbytes: int) -> None:
        """Set (0: clear) the arena's budget and enforce it now; a placement
        mesh's slices take an even share each, its degraded submesh the
        whole (runner.py:1841-1860)."""
        self._arena.budget_bytes = int(nbytes)
        self._arena.enforce()
        if self._placer is not None:
            self._placer.set_hbm_budget(int(nbytes))
        degraded = self._degraded_sub()
        if degraded is not None:
            degraded.set_hbm_budget(int(nbytes))

    def route_stats(self) -> dict:
        """``sel_routes``, ``pred_routes``, ``feed_routes`` and ``degrades``,
        a placement mesh's slices and degraded submesh folded in (the
        requests run there: runner.py:1331-1340)."""
        names = ("sel_routes", "pred_routes", "feed_routes", "degrades")
        with self._stats_mu:
            out = {k: dict(getattr(self, k)) for k in names}
        for r in self._sub_runners():
            for k, table in r.route_stats().items():
                for route, v in table.items():
                    out[k][route] = out[k].get(route, 0) + v
        return out

    def drop_feed(self, anchor) -> int:
        """Release every feed and memo anchored on ``anchor`` (a lineage
        or a snapshot), its unminted cold bundle, its unconsumed split
        stash and its quarantine → the bytes released from the accounting.
        A request in flight keeps the planes it reads."""
        with self._quar_mu:
            self._quarantined.pop(id(anchor), None)
        drop_cold = getattr(anchor, "drop_cold", None)
        if callable(drop_cold):
            drop_cold()
        if getattr(anchor, "split_stash", None) is not None:
            anchor.split_stash = None
        freed = self._arena.drop(anchor)
        if self._placer is not None:
            freed += self._placer.drop_feed_all(anchor)
        degraded = self._degraded_sub()
        if degraded is not None:
            freed += degraded.drop_feed(anchor)
        return freed

    def split_resident_feeds(self, spec) -> str:
        """The device split of every resident feed anchored on the parent
        lineage (``spec`` from ``RegionColumnarCache.split_lines``) →
        ``"split"`` when at least one child feed was minted, else
        ``"none"``.  It runs on whichever runner holds the parent's bucket:
        this one, a placement slice or the degraded submesh
        (runner.py:2195-2214)."""
        for r in [self] + self._sub_runners():
            bucket = r._arena.bucket(spec["parent_lineage"], create=False)
            if bucket:
                # a row-sharded feed re-mints (runner.py:2223)
                return r._split_local_feeds(bucket, spec) if r._single \
                    else "none"
        return "none"

    def _split_local_feeds(self, bucket, spec) -> str:
        """Slice the parent's positional feeds into child feeds, stashed
        on the child lineages for their first requests.  Under the
        dispatch lock, so the split's launches are ordered with the
        requests' on one stream.  One thread pool hashes every child's
        host planes."""
        out = "none"
        phases: dict = {}
        with self._dispatch_mu, ThreadPoolExecutor(hash_workers()) as pool:
            for fkey, feed in list(bucket.items()):
                if not (isinstance(feed, dict) and "flat" in feed):
                    continue
                if not feed.get("positional") or \
                        feed.get("digests") is None:
                    continue
                if feed.get("lineage_v") != spec["parent_version"] or \
                        feed.get("n_live") != spec["n_parent"]:
                    continue    # a stale generation or a partial range
                for side in ("left", "right"):
                    child = spec.get(side)
                    if child is None or child["n"] <= 0:
                        continue
                    cf = self._mint_split_child(feed, fkey, spec, child,
                                                side == "right", pool,
                                                phases)
                    if cf is None:
                        continue
                    lineage = child["lineage"]
                    if lineage.split_stash is None:
                        lineage.split_stash = []
                    lineage.split_stash.append({"col_ids": fkey[1],
                                                "dtypes": tuple(fkey[2]),
                                                "feed": cf})
                    out = "split"
        self.split_phases_ms = phases
        return out

    def _mint_split_child(self, feed, fkey, spec, child, right: bool,
                          pool, phases: dict):
        """One child feed (runner.py:2254-2315): every parent plane sliced
        by one ``split_planes`` launch, its fused digests fetched in one
        copy and held against the digests of the child's host state, which
        ``pool`` hashes while the kernel runs — never derived from
        device planes, so a corruption that landed on the parent fails
        here instead of passing into the child.  → the child feed, or None
        when anything differs (that child then uploads)."""
        pos, n_child = spec["pos"], child["n"]
        n_pad_child = self._pad_rows(max(n_child, 1))
        if n_pad_child > feed["n_pad"]:
            return None
        state = child["state"]
        hosts = []      # (host array, dtype) per flat plane, in order
        for j, has_nulls in enumerate(feed["null_flags"]):
            if feed["pk_flags"][j]:
                vals, valid = state.handles, None
            else:
                bufs = state.cols.get(fkey[1][j])
                if bufs is None:
                    return None
                vals, valid = bufs
            hosts.append((vals, np.dtype(fkey[2][j])))
            if has_nulls:
                hosts.append((np.ones(n_child, np.bool_) if valid is None
                              else valid, None))
        if len(hosts) != len(feed["flat"]):
            return None
        if not hosts:
            # a feed of no plane (COUNT(*) alone): the child's is empty
            # too, and there is nothing to launch
            return {"flat": (), "null_flags": feed["null_flags"],
                    "n_pad": n_pad_child, "digests": (), "n_live": n_child,
                    "lineage_v": child["lineage"].version,
                    "positional": True, "pk_flags": feed["pk_flags"]}

        def add(name, t0):
            phases[name] = phases.get(name, 0.0) + \
                (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        wait = start_plane_digests(pool, hosts, n_child)
        t1 = time.perf_counter()
        flat, got = sp.split_planes(list(feed["flat"]), pos, n_child,
                                    n_pad_child, right)
        add("launch", t1)
        t2 = time.perf_counter()
        want = wait()
        phases["host_digests"] = phases.get("host_digests", 0.0) + \
            (time.perf_counter() - t2 + t1 - t0) * 1e3
        t3 = time.perf_counter()
        got = got.cpu().tolist()        # the one verify copy
        add("verify", t3)
        if [as_u64(g) for g in got] != [as_u64(w) for w in want]:
            return None
        return {"flat": tuple(flat), "null_flags": feed["null_flags"],
                "n_pad": n_pad_child, "digests": want, "n_live": n_child,
                "lineage_v": child["lineage"].version,
                "positional": True, "pk_flags": feed["pk_flags"]}

    def mvcc_resolver(self):
        """The runner's ``DeviceMvccResolver`` (created on first use);
        None on a mesh, whose cold builds upload (runner.py:1104-1115)."""
        if self._mvcc_resolver is None and self._single:
            from .mvcc import DeviceMvccResolver
            self._mvcc_resolver = DeviceMvccResolver(self)
        return self._mvcc_resolver

    def joiner(self):
        """The runner's ``DeviceJoiner`` (created on first use): the plan
        IR's join, sort and window fragments on this device."""
        if self._joiner is None:
            from .join import DeviceJoiner
            self._joiner = DeviceJoiner(self)
        return self._joiner

    # -------------------------------------- scale-out and failure domains
    #
    # The reference's runner.py:682-1090 on a placement mesh.  The root
    # runner owns the board; each placement slice is a single-device
    # sub-runner bound to its slice's health (``_health``); a degraded
    # submesh runner strikes the root's board without a health of its own.

    @property
    def placer(self):
        return self._placer

    def _make_slice_runner(self, mesh, slice_indices=None,
                           bind_health: bool = False) -> "DeviceRunner":
        """A sub-runner over some of this mesh's devices (a placement slice,
        or a degraded healthy submesh) with this runner's ``chunk_rows``;
        ``slice_indices``: this mesh's indices of its devices.
        ``bind_health``: its faults and latencies score its one slice (a
        degraded submesh never binds: its requests are whole-mesh plans
        squeezed onto the survivors)."""
        sub = DeviceRunner(mesh=mesh, chunk_rows=self._chunk_rows)
        sub._failover_parent = self
        if slice_indices is not None:
            sub._slice_indices = tuple(slice_indices)
            if bind_health and len(slice_indices) == 1 and \
                    self._board is not None:
                sub._health = self._board.slice(slice_indices[0])
        return sub

    def _in_domain(self) -> bool:
        """A runner of a placement mesh: its root, a slice or a submesh."""
        return self._board is not None or self._failover_parent is not None

    def _strike_board(self):
        """The board this runner's slice faults land on: its own (the
        root), else its root's."""
        if self._board is not None:
            return self._board
        p = self._failover_parent
        return p._board if p is not None else None

    def _slice_dead_targets(self, indices=None) -> tuple:
        """Which of my slice indices (or ``indices``) the
        ``device::slice_dead`` failpoint names now: ``return`` names every
        slice, ``return(i j)`` slices i and j; () unarmed, or off a
        placement mesh."""
        if not self._in_domain():
            return ()
        fp = fail_point("device::slice_dead")
        if fp is None:
            return ()
        mine = self._slice_indices if indices is None else tuple(indices)
        v = fp.value
        if v is None or not str(v).strip():
            return mine
        try:
            targets = {int(t) for t in str(v).replace(",", " ").split()}
        except ValueError:
            return mine
        return tuple(i for i in mine if i in targets)

    def _note_slice_fault(self, kind: str) -> None:
        """A fault of this slice runner's request: one strike on its slice
        (a trip fires the board's listeners: the placer drains it)."""
        h = self._health
        if h is not None and h.note_fault(kind):
            board = self._strike_board()
            if board is not None:
                board._fire_trip(h.idx, kind)

    def _note_slice_ok(self, latency_s: Optional[float] = None) -> None:
        """A served request decays its slice's score (or strikes a latency
        outlier); a whole-mesh or submesh request decays every slice it
        ran on."""
        h = self._health
        if h is not None:
            if h.note_ok(latency_s):
                board = self._strike_board()
                if board is not None:
                    board._fire_trip(h.idx, "latency")
            return
        board = self._strike_board()
        if board is not None:
            for i in self._slice_indices:
                board.slice(i).note_ok()

    def _refuse_if_quarantined(self) -> bool:
        """The dispatch gate of a quarantined slice, before any of its state
        is touched → True when the request must be served on the host."""
        h = self._health
        if h is not None and h.quarantined():
            h.refusals += 1
            return True
        return False

    def _preflight_slice(self) -> None:
        """A slice that ``device::slice_dead`` names fails the dispatch as
        the dead card would: a whole-mesh or submesh runner strikes each
        named slice here, a slice runner once where the fault is caught."""
        hit = self._slice_dead_targets()
        if hit:
            if self._health is None:
                board = self._strike_board()
                if board is not None:
                    for i in hit:
                        board.note_fault(i, "dispatch")
            raise _SliceDead("device::slice_dead")

    def _canary(self, idx: int) -> bool:
        """The half-open probe of slice ``idx``: one ``plane_digest`` launch
        over 8 rows on its device, read back (a dead card fails it), behind
        the same ``device::slice_dead`` gate as a dispatch."""
        try:
            if self._slice_dead_targets(indices=(idx,)):
                return False
            dev = self._devices[self._slice_indices.index(idx)]
            with _on_device(dev):
                x = torch.arange(8, dtype=torch.int64, device=dev)
                return as_u64(plane_digest(x, 0, 8)) == \
                    sum(i * (2 * i + 1) for i in range(8))
        except Exception:   # noqa: BLE001 — any runtime error: still dead
            return False

    def probe_quarantined(self) -> int:
        """Canaries for the quarantined slices whose cooldown has passed →
        how many ran (routing calls it on every request)."""
        if self._board is None:
            return 0
        return self._board.maybe_probe(self._canary)

    def _degraded_sub(self) -> Optional["DeviceRunner"]:
        with self._degrade_mu:
            return self._degraded[1] if self._degraded is not None else None

    def _degraded_target(self) -> Optional["DeviceRunner"]:
        """The runner whole-mesh plans use now: None while every slice is
        healthy (dropping a submesh runner that served before); else a
        runner over the largest healthy power-of-two submesh, its feeds
        minted again from the host.  Raises ``_SliceDead`` when no slice
        survives or the rebuild fails (``device::mesh_rebuild``): the host
        pipeline is the last rung."""
        self.probe_quarantined()
        dead = self._board.quarantined_set()
        with self._degrade_mu:
            if not dead:
                if self._degraded is not None:
                    self._degraded[1]._arena.drop_all()
                    self._degraded = None
                    self._note_route("mesh_restore", self.failure_events)
                return None
            key = frozenset(dead)
            if self._degraded is None or self._degraded[0] != key:
                _fp_fault_as("device::mesh_rebuild", _SliceDead)
                from ..parallel import healthy_submesh, make_mesh
                devs = healthy_submesh(self._mesh, dead)
                if devs is None:
                    raise _SliceDead("no healthy submesh")
                # by index: a mesh may repeat a device
                alive = [i for i in range(self._nshards()) if i not in dead]
                with tracker.phase("mesh_rebuild"):
                    sub = self._make_slice_runner(
                        make_mesh(devs), slice_indices=alive[:len(devs)])
                    sub._arena.budget_bytes = self._arena.budget_bytes
                if self._degraded is not None:
                    self._degraded[1]._arena.drop_all()
                # the full mesh's feeds span the dead slice; requests in
                # flight keep their planes
                self._arena.drop_all()
                self._degraded = (key, sub)
                self._note_route("mesh_downsize", self.failure_events)
            return self._degraded[1]

    def _rescue(self, dag: DAGRequest, storage):
        """A request whose slice died between its dispatch and its fetch,
        served once more through the root's front door (the placer routes
        it around the dead slice, or the degraded submesh serves it) →
        (result, degraded): ``degraded`` is None where a card answered,
        else the reason the host answered the retry's fetch; or None when
        this runner is not sick or the retry failed (the caller's own
        degrade stands).  Never raises."""
        if not self._in_domain():
            return None
        try:
            h = self._health
            board = self._strike_board()
            hit = self._slice_dead_targets()
            sick = h is not None and h.quarantined()
            if hit:
                sick = True     # a persistent death: trip now
                if h is not None:
                    if h.trip("slice_dead") and board is not None:
                        board._fire_trip(h.idx, "slice_dead")
                elif board is not None:
                    for i in hit:
                        board.trip(i, "slice_dead")
            if not sick and self._board is not None and \
                    self._board.quarantined_set():
                sick = True
            if not sick:
                return None
            root = self._failover_parent or self
            root._note_route("rescue", root.failure_events)
            tracker.label("device_rescue", "slice_failover")
            out = root.handle_request(dag, storage, deferred=True)
            if isinstance(out, DeferredResult):
                return out.result(), out.degraded
            return out, None
        except Exception:   # noqa: BLE001 — the host answer follows
            return None

    def device_health(self) -> dict:
        """Per-slice health and the degraded submesh, if any."""
        out: dict = {"n_slices": len(self._slice_indices),
                     "slices": self._board.stats()
                     if self._board is not None else []}
        with self._degrade_mu:
            if self._degraded is not None:
                dead, sub = self._degraded
                out["degraded"] = {"dead_slices": sorted(dead),
                                   "healthy_devices": sub._nshards()}
        return out

    def mesh_stats(self) -> dict:
        """The mesh's shape and devices, and the placer's statistics."""
        out = {"shape": dict(self._mesh.shape) if self._mesh is not None
               else {"range": 1, "tile": 1},
               "n_devices": self._nshards(),
               "devices": [str(d) for d in self._devices]}
        if self._placer is not None:
            out["placement"] = self._placer.stats()
        return out

    def close(self) -> None:
        """Drop every resident feed (the slices' and the degraded
        submesh's too) and heal the board.  Idempotent."""
        if self._placer is not None:
            for r in self._placer.slices:
                r.close()
        with self._degrade_mu:
            if self._degraded is not None:
                self._degraded[1].close()
                self._degraded = None
        self._arena.drop_all()
        with self._quar_mu:
            self._quarantined.clear()
        if self._board is not None:
            self._board.reset()

    def quarantine(self, anchor, reason: str = "") -> None:
        """The anchor's resident feeds are not to be trusted (a scrub
        divergence, a migration whose arrival check failed): drop them where
        they live, strike that slice as a scrub fault, and answer the
        anchor's next request on the host (``FeedQuarantined``); the one
        after uploads from host truth (runner.py:1941-1975).  A placed
        anchor is quarantined on its owning slice; while the mesh is
        degraded, on the submesh runner too, which serves its requests."""
        if self._placer is not None:
            owner = self._placer.owner(anchor)
            if owner is not None:
                owner.quarantine(anchor, reason)
                return
        self._note_slice_fault("scrub")
        self._arena.drop(anchor)
        degraded = self._degraded_sub()
        if degraded is not None:
            degraded._arena.drop(anchor)
            degraded._mark_quarantined(anchor, reason)
        self._mark_quarantined(anchor, reason)

    def _mark_quarantined(self, anchor, reason: str) -> None:
        with self._quar_mu:
            self._quarantined[id(anchor)] = (anchor, reason)
            # bounded: a quarantined region never asked again (and never
            # torn down) must not pin its lineage for ever
            while len(self._quarantined) > 128:
                self._quarantined.pop(next(iter(self._quarantined)))

    def _consume_quarantine(self, anchor) -> bool:
        with self._quar_mu:
            return self._quarantined.pop(id(anchor), None) is not None

    def _is_quarantined(self, anchor) -> bool:
        with self._quar_mu:
            return id(anchor) in self._quarantined

    # ---------------------------------------------------- feed migration

    def extract_feeds(self, anchor):
        """→ ({feed key: feed} of ``anchor``'s feeds that can move off this
        single-device runner, how many were skipped), or (None, 0) when
        nothing can (runner.py:2082-2106).  A feed moves only with its
        digests, which the destination checks; one without is skipped and
        counted.  Taken under the dispatch lock (a patch updates a feed's
        planes and digests together)."""
        if not self._single:
            return None, 0
        bucket = self._arena.bucket(anchor, create=False)
        if not bucket:
            return None, 0
        out, skipped = {}, 0
        with self._dispatch_mu:
            for k, v in list(bucket.items()):
                if not (isinstance(v, dict) and "flat" in v):
                    continue
                if v.get("digests") is None:
                    skipped += 1
                    continue
                out[k] = dict(v)
        return (out or None), skipped

    def install_feeds(self, anchor, feeds: dict) -> str:
        """The arrival side of a feed's move (runner.py:2108-2166) →
        ``"moved"`` or ``"corrupt"``.  Each plane is copied into storage
        of this runner's own (never a view of the source's, even on one
        card), then one ``feed_verify`` launch hashes every arrived plane
        of the feed and one copy brings the P digests home, held against
        the digests that travelled; any difference returns ``"corrupt"``
        before anything is installed.  Only then, under the dispatch lock:
        each feed is installed unless a resident one of the same key is of
        the same or a newer lineage version, its digests are registered
        with the lineage, and the anchor is admitted to the arena.
        ``device::feed_migrate`` flips one bit of an arrived plane.
        ``migrate_phases_ms``: the host-clock copy, verify and install."""
        dev = self.device
        phases = {"copy": 0.0, "verify": 0.0, "install": 0.0}
        arrived = {}
        with _on_device(dev):
            for fkey, feed in feeds.items():
                t0 = time.perf_counter()
                flat = []
                for a in feed["flat"]:
                    b = torch.empty_like(a, device=dev)
                    b.copy_(a, non_blocking=True)
                    flat.append(b)
                nf = dict(feed, flat=tuple(flat))
                if fail_point("device::feed_migrate") is not None:
                    self.corrupt_resident_plane(nf)
                t1 = time.perf_counter()
                got = feed_verify(flat, 0, feed["n_live"]).cpu().tolist()
                want = [as_u64(w) for w in feed["digests"]]
                phases["copy"] += (t1 - t0) * 1e3
                phases["verify"] += (time.perf_counter() - t1) * 1e3
                if [as_u64(g) for g in got] != want:
                    self.migrate_phases_ms = phases
                    return "corrupt"
                nf["digests"] = tuple(want)
                arrived[fkey] = nf
        t = time.perf_counter()
        with self._dispatch_mu:
            bucket = self._arena.bucket(anchor)
            if bucket is None:
                return "corrupt"    # an untrackable anchor: minted again
            lineage = anchor if hasattr(anchor, "feed_digests") else None
            for fkey, nf in arrived.items():
                cur = bucket.get(fkey)
                if isinstance(cur, dict) and \
                        cur.get("lineage_v") is not None and \
                        nf.get("lineage_v") is not None and \
                        cur["lineage_v"] >= nf["lineage_v"]:
                    continue
                bucket[fkey] = nf
                self._register_digests(lineage, fkey, nf)
            self._arena.admit(anchor)
        phases["install"] = (time.perf_counter() - t) * 1e3
        self.migrate_phases_ms = phases
        return "moved"

    # ------------------------------------------------------------- scrub

    @staticmethod
    def device_digest(arr: torch.Tensor, n: int) -> torch.Tensor:
        """Digest of one resident plane's live prefix (a 0-d int64 device
        tensor; the caller decides when to read it)."""
        return plane_digest(arr, 0, n)

    def scrub_feed(self, feed: dict) -> list:
        """Re-hash every resident plane of ``feed`` on the device → the
        indices (into ``feed["flat"]``; a row-sharded feed's plane index,
        its shards copied back together on the first device) of the planes
        whose digest differs from the recorded one."""
        planes = feed["flat"]
        if "shards" in feed:
            planes = [torch.cat([sub["flat"][p].to(self.device)
                                 for sub in feed["shards"]])
                      for p in range(len(feed["digests"]))]
        got = torch.stack([self.device_digest(a, feed["n_live"])
                           for a in planes]).cpu().tolist()
        return [i for i, (g, r) in enumerate(zip(got, feed["digests"]))
                if as_u64(g) != as_u64(r)]

    def _patch_plane(self, feed: dict, spans, vals: list,
                     planes: Optional[Sequence[int]] = None) -> None:
        """Write ``vals[j]`` (the rows of ``spans``, sorted, disjoint [lo,
        hi) row spans, end to end) over plane ``planes[j]`` of ``feed`` in
        place — every plane of the feed when ``planes`` is None, as a
        journal patch writes — in one ``patch_feed_spans`` launch, keeping
        each recorded digest by the incremental rule ``R' = R − H(old) +
        H(new)`` over the rows written (runner.py:1793-1814): never a
        re-hash of the plane, which would launder a corruption that landed
        since the last scrub into the record.  R' stays a 0-d tensor on the
        card, which the next patch reads there.  Single-device feeds
        only."""
        if "shards" in feed:
            raise NotImplementedError(
                "a row-sharded feed is not patched in place: it re-uploads "
                "(ROADMAP.md queue 1 item 10)")
        fis = range(len(feed["flat"])) if planes is None else list(planes)
        digests = list(feed["digests"])
        out = patch_feed_spans([feed["flat"][i] for i in fis], spans, vals,
                               [digests[i] for i in fis])
        for j, i in enumerate(fis):
            digests[i] = out[j, 2]
        feed["digests"] = tuple(digests)

    @staticmethod
    def corrupt_resident_plane(feed: dict, fi: int = 0) -> None:
        """Fault injection: flip the low bit of element 0 of resident plane
        ``fi`` in place (the HBM bit flip a device fault would cause), by a
        one-row patch over the plane's same-width integer view (its old
        element read back first); the recorded digest is left as it
        was."""
        arr = feed["flat"][fi]
        view = arr.view(_INT_OF_WIDTH[arr.element_size()])
        patch_feed_rows([view], [0], [view[:1].cpu() ^ 1])

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
        ``analyze.analyze_column`` into the request's ``AnalyzeBatch``:
        each column's range kernel launches after its upload, the batch
        reads every range back in one copy (the request's one wait before
        its result, ``range_waits`` in the phases) and launches each
        column's route; every packed vector comes back in one D2H copy.  Other columns, and uint64 columns holding a value at or
        past 2^63, take the host half (``copr.analyze.analyze_columns``)
        after every device column has been launched.  ``analyze_phases_ms``
        holds the host-clock phases of the last request.  A mesh runner
        answers on the host half (runner.py:4546-4552); a placement mesh
        sends the request to its anchor's slice (runner.py:4534-4541)."""
        from ..copr.analyze import (ANALYZE_DEVICE_ETS, ColumnStats,
                                    analyze_columns)
        from . import analyze as an
        if self._placer is not None and hasattr(storage, "scan_columns"):
            target = self._placer.route(storage)
            if target is not self:
                return target.handle_analyze(dag, storage, n_buckets)
        scan = dag.executors[0]
        phases: dict = {}
        t0 = time.perf_counter()
        batch = storage.scan_columns(scan, dag.ranges)
        t1 = time.perf_counter()
        phases["scan"] = (t1 - t0) * 1e3
        n = batch.num_rows
        if n == 0 or not self._single:
            self.analyze_phases_ms = phases
            return analyze_columns(batch, scan.columns, n_buckets)
        n_pad = self._pad_rows(n)
        pending, host_idx = {}, []
        launches = an.AnalyzeBatch()
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
                                           phases, batch=launches)
        phases["dtype"] = dtype_s * 1e3
        phases["pad_h2d"] = upload_s * 1e3
        launches.run(phases)    # the request's one wait: every range
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
        ``DeviceUnavailable`` before anything launches.  On a mesh, a
        shard whose launches fail (``device::shard_launch``) sends the whole
        request to the host pipeline (runner.py:3252, :3304-3319), after the
        dispatch lock is released; it is counted in ``degrades``.

        On a placement mesh (runner.py:3008-3044) the root routes the
        request to its anchor's slice (``placer.route``), or, while a slice
        is quarantined, a whole-mesh request to the degraded submesh; a
        quarantined slice refuses the dispatch and a slice that
        ``device::slice_dead`` names fails it (both answered by the host
        pipeline, counted in ``degrades`` as "slice_quarantined" and
        "slice_dead"); a fetch fault of a dead slice is served once more
        through the root (``_rescue``).  A synchronous fetch fault that no
        healthy slice served raises to the caller, as off a placement
        mesh; a deferred one answers on the host (``DeferredResult``)."""
        from ..executors.runner import BatchExecutorsRunner
        if self._placer is not None and _stack is None and \
                hasattr(storage, "scan_columns"):
            target = self._placer.route(storage)
            if target is not self:
                return target.handle_request(dag, storage, deferred=deferred)
        if self._board is not None:
            try:
                degraded = self._degraded_target()
            except _SliceDead:
                self._note_route("mesh_rebuild", self.degrades)
                tracker.label("degraded", "mesh_rebuild")
                if _stack is not None:
                    raise _BatchUnavailable("no healthy submesh")
                return BatchExecutorsRunner(dag, storage).handle_request()
            if degraded is not None:
                return degraded.handle_request(dag, storage,
                                               deferred=deferred,
                                               _stack=_stack)
        plan, why = self._analyze(dag)
        if plan is None:
            raise NotImplementedError(why)
        if not (hasattr(storage, "scan_columns") and
                hasattr(storage, "count_rows")):
            raise NotImplementedError(
                f"{type(storage).__name__} is not a columnar snapshot: "
                f"{_TODO_STORAGE}")
        if self._refuse_if_quarantined():
            if _stack is not None:
                raise _BatchUnavailable("slice quarantined")
            self._note_route("slice_quarantined", self.degrades)
            tracker.label("device_feed", "slice_quarantined")
            return BatchExecutorsRunner(dag, storage).handle_request()
        if self._quarantined:
            # a scrub divergence on this anchor (runner.py:3051-3059): its
            # feeds are gone; this request is answered on the host by the
            # caller, the next one uploads.  A group leaves the quarantine
            # to its members' solo retries
            anchor = self._feed_anchor(storage)
            if _stack is not None and self._is_quarantined(anchor):
                raise _BatchUnavailable("feed quarantined")
            if self._consume_quarantine(anchor):
                tracker.label("device_feed", "quarantined")
                raise FeedQuarantined("the feed was quarantined by a scrub")
        out = fault = None
        try:
            self._preflight_slice()
        except _SliceDead as e:
            fault = e
        if fault is None:
            with self._dispatch_mu:
                _fp_fault("device::before_dispatch")
                try:
                    out = self._dispatch(dag, plan, storage, _stack)
                except _ShardLaunchFault as e:
                    out, fault = None, e
                if isinstance(out, _Pending):
                    if self._health is not None and \
                            self._health.quarantined():
                        self._health.launched_quarantined += 1
                    # the arena must not evict what a launched kernel reads
                    # until its fetch (runner.py:3286-3294); re-accounted
                    # for the memos the run cached (sparse slot ids)
                    anchor = self._feed_anchor(storage)
                    out.hold(self._arena, self._arena.pin(anchor))
                    self._arena.admit(anchor)
        if fault is not None:
            # the shards that did launch answer nothing
            kind = "slice_dead" if isinstance(fault, _SliceDead) \
                else "shard_launch"
            if kind == "slice_dead":
                self._note_slice_fault("dispatch")
            self._note_route(kind, self.degrades)
            tracker.label("degraded", kind)
            if _stack is not None:
                raise _BatchUnavailable(f"{kind}: the group cannot launch")
            return BatchExecutorsRunner(dag, storage).handle_request()
        if _stack is not None:
            if isinstance(out, _Pending):
                return _GroupPending(self, out)
            raise _BatchUnavailable("the group launched nothing")
        if not isinstance(out, _Pending):
            return self._apply_output_offsets(dag, out)
        if deferred:
            return DeferredResult(self, out, dag, storage)
        try:
            r = self._finish(out)
        except DEVICE_FAULTS:
            # a slice that died before its fetch: served once more on a
            # healthy slice, else the fault reaches the caller
            self._note_slice_fault("fetch")
            rescued = self._rescue(dag, storage)
            if rescued is None or rescued[1] is not None:
                raise
            return rescued[0]
        return self._apply_output_offsets(dag, r)

    def _readback(self, pending: _Pending) -> list:
        """Wait for a dispatched request's copies to the host → numpy
        arrays.  The ``device::before_fetch`` failpoint raises
        ``DeviceUnavailable`` here (runner.py:2949)."""
        _fp_fault("device::before_fetch")
        # a slice that died between the dispatch and the fetch fails it
        hit = self._slice_dead_targets()
        if hit:
            board = self._strike_board()
            if self._health is None and board is not None:
                for i in hit:
                    board.note_fault(i, "fetch")
            raise _SliceDead("device::slice_dead")
        with tracker.phase("d2h_wait"):
            return pending.staged.fetch()

    def _finish(self, pending: _Pending):
        """The blocking fetch and the host finalize of a dispatched
        request (runner.py:3334); its arena pin is released either way.  On
        a placement mesh a served request decays its slices' scores."""
        t0 = time.perf_counter()
        try:
            fetched = self._readback(pending)
        finally:
            pending.release()
        with tracker.phase("host_materialize"):
            out = pending.finalize(fetched)
        if self._in_domain():
            self._note_slice_ok(time.perf_counter() - t0)
        return out

    def _dispatch(self, dag, plan, storage, stack):
        """Under the dispatch lock: the snapshot's feed and the plan's
        per-snapshot facts, then the plan's kernels → a ``_Pending``, or
        a settled ``SelectResult`` when nothing needs the device."""
        st = self._bucket(storage)
        req_v = self._feed_version(storage)
        meta = self._request_meta(st, dag, plan, storage, req_v)
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
        dtypes = self._feed_dtypes(st, plan, dag.ranges, planes, get_batch,
                                   storage, req_v)
        _pin_dtypes(meta, dtypes)

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
        feed = self._get_feed(storage, st, feed_key, plan, planes, dtypes,
                              host_cols, n)
        out = self._run(dag, plan, storage, stack, st, meta, feed, n,
                        get_batch, host_cols, dtypes, req_v)
        if isinstance(out, _Pending):
            # the request's planes live until its fetch, even when the
            # feed is dropped first (a split retiring its parent)
            out.keep = feed["flat"]
        return out

    def _run(self, dag, plan, storage, stack, st, meta, feed, n, get_batch,
             host_cols, dtypes, req_v):
        """The plan's kernels over ``feed`` → a ``_Pending`` or a settled
        result."""
        if "plan" not in meta:
            meta["plan"], meta["narrow_bounds"] = self._narrowed(
                plan, host_cols, dtypes)
        plan = meta["plan"]

        if plan.kind == "scan_sel":
            if stack is not None:
                return self._run_stacked(stack, st, storage, feed, n,
                                         host_cols, dtypes, req_v)
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

    def _request_meta(self, st, dag, plan, storage, req_v) -> dict:
        """The plan's memo in ``st`` for lineage version ``req_v``: one a
        plan and ranges, shared by the requests of every version
        (runner.py:3085-3105).  A memo that lags ``req_v`` is rolled
        forward across the journal's patches (``_refresh_meta``); a read of
        an older generation (served from the line's history) gets a memo
        of its own and leaves the shared one as it is."""
        key = ("meta", dag.plan_key(), dag.ranges)
        meta = st.get(key)
        if meta is None:
            meta = st[key] = {"lineage_v": req_v}
        mv = meta["lineage_v"]
        if mv is None or req_v is None or mv == req_v:
            return meta
        if mv > req_v:
            return {"lineage_v": req_v}
        self._refresh_meta(meta, storage.feed_lineage, plan, mv, req_v)
        return meta

    def _refresh_meta(self, meta: dict, lineage, plan, from_v: int,
                      to_v: int) -> None:
        """Roll a plan's memo forward across the journal's patches
        ``from_v`` → ``to_v`` (runner.py:3467-3554).

        The row count always drops, and so does a sparse key's slot recode
        (new rows have no slot ids).  The constants derived from the data
        — the plane dtypes, the hash key bounds, the byte-plane widths of
        the SUM/AVG arguments — survive together only when every dirty
        span provably stays inside them, as in the reference: a kept
        violated constant would corrupt answers, a dropped valid one costs
        a derivation.  A structural patch, or a gap the journal no longer
        covers, drops them all.  The constants this port derives beside
        them (the int32 narrowing's bounds, ``agg_fold``'s value bound,
        the top-k digit's bounds) survive only with them and by their own
        proof.  ``last_refresh`` records each field: "kept", "dropped" or
        "absent"."""
        for k in ("n_rows", "sparse_slots"):
            meta.pop(k, None)
        spans = _journal_spans(lineage, from_v, to_v)
        planes = self._feed_planes(plan)
        infos = [plan.scan.columns[ci] for ci, _dt in planes]
        dtypes = meta.get("dtypes")
        keep = spans is not None and (dtypes is None or _dtypes_hold(
            spans, infos, planes, dtypes))
        if keep and "hash_bounds" in meta:
            keep = _keys_hold(spans, infos, plan.key_rpn,
                              *meta["hash_bounds"])
        if keep and "arg_nbytes" in meta:
            keep = _widths_hold(spans, infos, plan.agg_rpns,
                                meta["arg_nbytes"])
        # the port's own constants: each kept by its own proof too
        own = {"plan": lambda: meta.get("narrow_bounds") is None or
               _bounds_hold(spans, infos, meta["narrow_bounds"]),
               "fold_bound": lambda: _fold_bound_holds(
                   spans, infos, plan.agg_rpns, dtypes, meta["fold_bound"]),
               "order_bounds": lambda: _order_bounds_hold(
                   spans, infos, plan.order_rpn, meta["order_bounds"])}
        record = {"from": from_v, "to": to_v, "kept": keep}
        for k in _DERIVED:
            if k not in meta:
                record[k] = "absent"
                continue
            ok = keep and (k not in own or own[k]())
            if k == "arg_nbytes" and record["plan"] == "dropped":
                # a computed argument's width is that of its narrowed dtype
                ok = ok and all(_bare_col(r) is not None or not nb
                                for r, nb in zip(plan.agg_rpns, meta[k]))
            record[k] = "kept" if ok else "dropped"
            if not ok:
                meta.pop(k)
        if "plan" not in meta:
            meta.pop("narrow_bounds", None)
        meta["lineage_v"] = to_v
        self.last_refresh = record
        self._note_route("kept" if keep else "dropped", self.memo_routes)
        tracker.label("memo", "kept" if keep else "dropped")

    def _feed_dtypes(self, st, plan, ranges, planes, get_batch, storage,
                     req_v=None) -> tuple:
        """The feed planes' dtypes on this snapshot: a column's device
        dtype depends on its values, so it is memoized per anchor, scan and
        columns (every plan over them shares it), with the verdict of
        ``FeedBeyondInt64``.  It rolls forward across the journal's patches
        while every dirty span fits it, as the plans' memos do; an older
        generation's read derives its own."""
        key = ("dtypes", _scan_key(plan.scan),
               tuple(plan.scan.columns[ci].col_id for ci, _ in planes),
               tuple(dt for _ci, dt in planes), ranges)
        got = st.get(key)
        if got is not None and got[0] != req_v:
            gv = got[0]
            if gv is not None and req_v is not None and gv > req_v:
                got = None
                st = {}     # derived for this read alone
            elif gv is not None and req_v is not None and \
                    got[1] is not None and _dtypes_hold(
                        _journal_spans(storage.feed_lineage, gv, req_v),
                        [plan.scan.columns[ci] for ci, _ in planes], planes,
                        got[1]):
                got = st[key] = (req_v, got[1])
            else:
                got = None
        if got is None:
            batch = get_batch()
            if any(_beyond_int64(batch.columns[ci]) for ci, _dt in planes):
                got = st[key] = (req_v, None)
            else:
                got = st[key] = (req_v, tuple(
                    dt or _plane_dtype(batch.columns[ci])
                    for ci, dt in planes))
        if got[1] is None:
            # the verdict stands for this version of the columns
            raise FeedBeyondInt64("a DATETIME core at or above 2^63")
        return got[1]

    # ----------------------------------------- cross-request batching

    def batch_class(self, dag: DAGRequest, storage):
        """The coalescing identity of this request, or None when it cannot
        share a dispatch (runner.py:1172-1227).  Requests under one key are
        served by one launch; they read one snapshot (by ``id``) over the
        same ranges.

        ``("stack", ...)``: a selection that ``sel_pred`` evaluates and that
        holds numeric constants: members differing only in those constants
        (one const-blind ``shape_key``, one feed plane dtype each) run as
        one ``sel_pred_batched`` launch.  ``("share", ...)``:
        byte-identical plans (aggregations, top-k, the other selections):
        one solo dispatch and its fetch serve every member.  A selection
        that ``sel_pred`` does not cover (the torch route) only shares,
        where the reference stacks any hoisted selection (ROADMAP.md).
        None on a mesh: a whole-mesh dispatch stays solo (runner.py:1204);
        on a placement mesh a request routed to a slice takes the slice's
        key behind ``("slice", id(slice runner))``, so that a group never
        straddles slices (runner.py:1197-1204)."""
        if self._placer is not None and hasattr(storage, "scan_columns"):
            target = self._placer.route(storage)
            if target is not self:
                key = target.batch_class(dag, storage)
                return None if key is None else ("slice", id(target)) + key
        if not (hasattr(storage, "scan_columns") and
                hasattr(storage, "count_rows")) or not self._single:
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
                    st = self._bucket(storage)
                    planes = self._feed_planes(plan)
                    try:
                        dtypes = self._feed_dtypes(
                            st, plan, dag.ranges, planes,
                            lambda: storage.scan_columns(plan.scan,
                                                         dag.ranges),
                            storage, self._feed_version(storage))
                    except FeedBeyondInt64:
                        # its solo dispatch raises it to the endpoint
                        return None
                return ("stack", id(storage), sm.shape_key(plan), dtypes,
                        dag.ranges, dag.output_offsets)
        return ("share", id(storage), dag.plan_key(), dag.ranges)

    def handle_batched(self, members) -> _BatchedSelectionGroup:
        """One stacked dispatch for ``members``, a list of ``(dag,
        storage)`` pairs of one ``("stack", ...)`` batch class
        (runner.py:1229) → a ``_BatchedSelectionGroup``.  Raises
        ``_BatchUnavailable`` when the group cannot be one launch: the
        caller retries each member solo.  A placement mesh hands the group
        to the slice of its snapshot's anchor (runner.py:1235-1238)."""
        if not members:
            raise _BatchUnavailable("an empty group")
        if self._placer is not None:
            target = self._placer.route(members[0][1])
            if target is not self:
                return target.handle_batched(members)
        if not self._single:
            raise _BatchUnavailable("a mesh dispatch is never stacked")
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

    def _member_plan(self, st, storage, dag, host_cols, dtypes, req_v):
        """A stacked member's plan, narrowed on this snapshot as its own
        solo request would be (memoized in its meta)."""
        plan = self._analyze(dag)[0]
        meta = self._request_meta(st, dag, plan, storage, req_v)
        _pin_dtypes(meta, dtypes)
        if "plan" not in meta:
            meta["plan"], meta["narrow_bounds"] = self._narrowed(
                plan, host_cols, dtypes)
        return meta["plan"]

    def _run_stacked(self, dags, st, storage, feed, n, host_cols, dtypes,
                     req_v):
        """The stacked selection (runner.py:4217-4245): every member's
        program, encoded against the same feed, runs as one lane of one
        ``sel_pred_batched`` launch; the whole group's counts and packed
        masks come home in one copy.  Always the packed masks: each
        member's count is unknown until the fetch."""
        planes = self._planes(feed)
        pdt = tuple(v.dtype for v, _ok in planes)
        plans, progs = [], []
        for dag in dags:
            plan = self._member_plan(st, storage, dag, host_cols, dtypes,
                                     req_v)
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
        other INT arithmetic call evaluates in int64 → (plan, the bounds a
        plane the proof used, or None where it used none)."""
        rpns = plan.sel_rpns + plan.agg_rpns + [plan.key_rpn, plan.order_rpn]
        if not _has_int64_calls(rpns):
            return plan, None
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
            key_rpn=narrow(plan.key_rpn),
            order_rpn=narrow(plan.order_rpn)), tuple(bounds)

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

    # ------------------------------------------------------------ shards

    def _dev(self, feed) -> torch.device:
        """The device of ``feed`` (a shard's feed, or a whole one)."""
        return feed.get("device", self.device)

    def _shard0(self, feed) -> dict:
        """The feed whose shape a kernel's gate reads: shard 0's on a mesh
        (every shard has its rows and planes), else the feed itself."""
        return feed["shards"][0] if "shards" in feed else feed

    def _per_shard(self, feed, n: int, fn) -> list:
        """``fn(shard feed, its live rows, its shard index)`` for each shard
        holding live rows, in device order, its launches on its device (the
        dispatch lock is held: runner.py:717-722) → their results.  A
        single device runs ``fn(feed, n, 0)``.  On a mesh the
        ``device::shard_launch`` failpoint fires before a shard's launches
        (``return`` at the first shard, ``return(i)`` at shard i) and
        raises ``_ShardLaunchFault``: what the earlier shards launched is
        dropped."""
        if self._single:
            return [fn(feed, n, 0)]
        out = []
        for s, sub in enumerate(feed["shards"]):
            if sub["n_live"] <= 0:
                break               # the trailing shards hold padding only
            hit = fail_point("device::shard_launch")
            if hit is not None and (hit.value is None or
                                    int(hit.value) == s):
                raise _ShardLaunchFault(f"shard {s}")
            with _on_device(sub["device"]):
                out.append(fn(sub, sub["n_live"], s))
        return out

    def _psum(self, parts: list, segments=None) -> torch.Tensor:
        """The shards' partials summed on the first device by one
        ``shard_psum`` (``_finalize_psum_summed``); a single device's part
        as it is."""
        if self._single:
            return parts[0]
        return sh.shard_psum([p.to(self.device, non_blocking=True)
                              .reshape(-1) for p in parts],
                             segments).reshape(parts[0].shape)

    def _merge_folds(self, outs: list, bases: list, simple: bool) -> tuple:
        """The shards' ``agg_fold`` buffers merged → (the tensors to fetch,
        their host half: fetched → one buffer in the fold's layout).

        With GROUP BY (``_finalize_psum_summed`` and
        ``_finalize_hash_bucket_merge``): one ``shard_merge`` over the
        shards' buffers on the first card, its summed words and its
        MIN/MAX rows in one launch.  Without GROUP BY the summed words go
        through ``shard_psum``, and MIN, MAX and FIRST come home as S rows
        each and the host reduces them (``_merge_stacked``, runner.py:
        2391-2410): FIRST takes the shard with the least global position
        (its own plus the shard's first row ``bases[i]``)."""
        if self._single:
            return [outs[0].buf], lambda f: f[0]
        plan, n_slots = outs[0].plan, outs[0].n_slots
        sums, stacked, first = _fold_merge_rows(plan, n_slots)
        root = self.device
        bufs = [o.buf.to(root, non_blocking=True) for o in outs]
        if not simple:
            # every shard's buffer is on the first card already: one launch
            # over the whole (S, slots) pile
            return [sh.shard_merge(bufs, sums + [
                (1 + r * n_slots, n_slots, op) for r, op in stacked])], \
                lambda f: f[0]
        merged = sh.shard_psum(bufs, sums)
        if not (stacked or first):
            return [merged], lambda f: f[0]
        return [merged, torch.stack(bufs)], lambda f: self._merge_simple(
            f[0], f[1], stacked, first, plan, bases)

    @staticmethod
    def _merge_simple(summed, parts, stacked, first, plan, bases):
        """The host's reduce of a simple fold's MIN, MAX and FIRST rows
        over the shards' buffers ``parts`` (S, W) into ``summed``, whose
        words of those rows the psum left unwritten: every one of them is
        set here.  FIRST takes the first shard that selected a row, its
        position made global; with none, shard 0's empty state as it is
        (``np.argmin`` over positions all ``_BIG`` picks shard 0)."""
        buf = summed.copy()
        with tracker.phase("shard_merge"):
            for r, op in stacked:
                col = parts[:, 1 + r]
                buf[1 + r] = col.min() if op.startswith("min") else col.max()
            for rows in first.values():
                pos = parts[:, 1 + rows["first"]]
                hit = np.flatnonzero(pos != _BIG)
                i = int(hit[0]) if hit.size else 0
                buf[1 + rows["first"]] = pos[i] + bases[i] if hit.size \
                    else pos[i]
                for state in ("firstval", "firstok"):
                    buf[1 + rows[state]] = parts[i, 1 + rows[state]]
        return buf

    def _home(self, tensors: list) -> list:
        """``tensors`` on the first device, where a request's readback
        starts (``Tensor.to``; nothing moves on one card)."""
        return [t.to(self.device, non_blocking=True) for t in tensors]

    def _arg_ok_is_mask(self, plan, feed) -> list:
        """Per-agg flag: the arg's validity provably equals the row mask
        (bare NOT NULL column ref), so it needs no validity plane."""
        return [ci is not None and not feed["null_flags"][ci]
                for ci in map(_bare_col, plan.agg_rpns)]

    def _inputs(self, plan, feed, n):
        """(per-column (value, validity) pairs over rows [0, n), the
        selection's bool mask or None when there is no selection)."""
        true = torch.ones((), dtype=torch.bool, device=self._dev(feed))
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
        dev = self._dev(feed)
        if plan.sel_route == PRED_KERNEL:
            dtypes = tuple(v.dtype for v, _ok in planes)
            prog = plan.sel_programs.get(dtypes)
            if prog is None:
                prog = plan.sel_programs[dtypes] = sm.encode_predicate(
                    plan.sel_rpns, dtypes)
            return sm.sel_pred(prog, planes, n, bools)
        true = torch.ones((), dtype=torch.bool, device=dev)
        pairs = [(v[:n], true if ok is None else ok[:n]) for v, ok in planes]
        if plan.sel_params is None:
            plan.sel_params = sm.split_params(plan.sel_rpns, len(pairs))
        rpns, values, dts = plan.sel_params
        cols = pairs + [(self._param(v, dt, dev), true)
                        for v, dt in zip(values, dts)]
        mask = None
        for rpn in rpns:
            v, ok = eval_rpn(rpn, cols, n, torch, dev)
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
        dev = self._dev(feed)
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

        if self._fused_ok(plan, self._shard0(feed), dtypes, 1,
                          ha.MODE_SIMPLE, arg_nbytes):
            parts = self._per_shard(feed, n, lambda f, m, _s: (
                self._aggregate_launch(plan, f, m, ha.MODE_SIMPLE, 0, 1, 1,
                                       1, arg_nbytes=arg_nbytes)))
            decode = parts[0][1]
            return _Pending([self._psum([t for t, _d in parts])],
                            lambda f: result(decode(f[0])[1]), small=True)
        # the simple body (runner.py:2668): the agg_fold kernel
        outs = self._per_shard(feed, n, lambda f, m, _s: self._fold(
            plan, f, m, af.MODE_SIMPLE, fold_bound))
        tensors, host = self._merge_folds(
            outs, [sub["base"] for sub in feed.get("shards", ())], True)
        return _Pending(tensors, lambda f: result(
            af.decode(host(f), outs[0].plan, outs[0].n_slots)[2]),
            small=True)

    def _fold(self, plan, feed, n, mode, fold_bound, inputs=None,
              **kw) -> "af.FoldOut":
        """One ``agg_fold`` pass over ``feed``'s rows [0, n) (the scatter
        and simple bodies); ``inputs``: ``_inputs``' result, when the
        caller has it."""
        pairs, mask = self._inputs(plan, feed, n) if inputs is None \
            else inputs
        return agg_fold(plan.specs, self._fold_cols(plan, feed, pairs, n), n,
                        mode, mask=mask, device=self._dev(feed),
                        value_bound=fold_bound, **kw)

    # --------------------------------------------------------- hash agg

    def _sparse_slots(self, plan, host_cols, n, feed, meta):
        """Host recode of a sparse GROUP BY key into dense slot ids.

        A key span beyond ``MAX_HASH_CAPACITY`` cannot direct-index; the
        distinct keys are dictionary-encoded once per snapshot on the host
        (``np.unique``) and the int32 slot plane is cached on the device
        next to the feed — on a mesh, the one global dictionary's plane
        row-sharded as the feed is (runner.py:3662-3705).  Returns (uniq,
        capacity, slot planes: one a shard); raises NotImplementedError
        beyond ``MAX_HASH_CAPACITY`` distinct keys.
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
        slot_ids = [torch.from_numpy(padded).to(self.device)] \
            if self._single else self._upload_sharded(padded, feed["n_pad"])
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

        def ids(s):
            return None if slot_ids is None else slot_ids[s]

        if self._fused_ok(plan, self._shard0(feed), dtypes, capacity, mode,
                          arg_nbytes):
            # _pallas_sharded_wrap (runner.py:3930): the kernel per shard,
            # the packed outputs psummed
            parts = self._per_shard(feed, n, lambda f, m, s: (
                self._aggregate_launch(
                    plan, f, m, mode, base, capacity, slots,
                    ha.n_slots(plan, capacity, mode), ids(s), arg_nbytes)))
            tensors = [self._psum([t for t, _d in parts])]
            decode = (lambda f, d=parts[0][1]: d(f[0]))
        elif layouts is not None and kn.twolevel_lo(p8, pf) is not None:
            parts = self._per_shard(feed, n, lambda f, m, s: (
                self._run_twolevel(plan, f, m, base, capacity, ids(s),
                                   layouts, p8, pf)))
            tensors = [self._psum([p[0][i] for p in parts])
                       for i in range(len(parts[0][0]))]
            decode = parts[0][1]
        else:
            outs = self._per_shard(feed, n, lambda f, m, s: (
                self._run_scatter(plan, f, m, base, capacity, ids(s),
                                  meta["fold_bound"])))
            tensors, host = self._merge_folds(outs, [], False)
            fold = outs[0]

            def decode(fetched):
                present, overflow, states = af.decode(
                    host(fetched), fold.plan, fold.n_slots)
                self._check_overflow(overflow)
                return present, states

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
                evaluated[r] = eval_rpn(r, pairs, n, torch, self._dev(feed))
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
                     fold_bound=None) -> "af.FoldOut":
        """The scatter body: one ``agg_fold`` pass over the key (or slot
        ids), the selection and each distinct argument."""
        if slot_ids is not None:
            return self._fold(plan, feed, n, af.MODE_SPARSE, fold_bound,
                              capacity=capacity, slot_ids=slot_ids)
        inputs = self._inputs(plan, feed, n)
        key, key_ok = self._key(plan, feed, inputs[0], n)
        return self._fold(plan, feed, n, af.MODE_DENSE, fold_bound, inputs,
                          key=key, key_ok=key_ok, base=base,
                          capacity=capacity)

    def _key(self, plan, feed, pairs, n) -> tuple:
        """The GROUP BY key's (values, validity), no validity for a bare
        column without NULLs (nothing to read)."""
        key, key_ok = eval_rpn(plan.key_rpn, pairs, n, torch, self._dev(feed))
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
                v, ok = eval_rpn(r, pairs, n, torch, self._dev(feed))
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

    def _param(self, value, dtype: str, device) -> torch.Tensor:
        """A hoisted constant as a cached 0-d tensor on ``device``."""
        key = (type(value), value, dtype, device)
        t = self._params.get(key)
        if t is None:
            if len(self._params) >= self._plan_cache_max:
                self._params.pop(next(iter(self._params)))
            t = self._params[key] = torch.tensor(
                value, dtype=_TORCH_DTYPES[dtype], device=device)
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
        back to the packed mask, still on the device.

        On a mesh each shard packs its own rows (a whole number of mask
        bytes: its rows are a multiple of 8) and the host joins the packed
        masks in row order and adds the counts; the index route runs
        ``sel_compact`` per shard with one capacity each, sized over every
        shard (runner.py:4279-4286), and offsets each shard's indices by
        its first row.  The compact route is single-device."""
        mouts = self._per_shard(feed, n, lambda f, m, _s: (
            self._selection(plan, f, m, False)[0]))
        keys = self._sel_keys(dag, plan)
        pred = self._sel_predict(keys)
        route, cap = sm.ROUTE_MASK, 0
        if pred is not None:
            k_est = pred * n
            cap = sm.index_capacity(k_est * 1.5 + 64,
                                    self._shard0(feed)["n_pad"]
                                    if "shards" in feed else n)
            route = sm.choose_route(n, k_est,
                                    plan.compact_ok and self._single,
                                    idx_bytes=4 * cap * self._nshards())

        def gather(rows):
            return self._gather(dag, plan, storage, rows, get_batch)

        def mask_route(count: int, packed, fallback: bool):
            if fallback:
                self._note_route("mask_fallback")
            else:
                self._sel_observe(keys, count / n)
                self._note_route(sm.ROUTE_MASK)
            return gather(np.unpackbits(packed, count=n).view(np.bool_))

        def masks(fetched) -> tuple:
            """(count, packed bytes) of every shard's fetched mask buffer."""
            got = [sm.mask_host(h) for h in fetched]
            return sum(c for c, _p in got), \
                np.concatenate([p for _c, p in got])

        def mask_bufs() -> list:
            return [mo.buf[:sm.HEADER + -(-mo.n // 8)] for mo in mouts]

        if route == sm.ROUTE_MASK:
            return _Pending(self._home(mask_bufs()),
                            lambda f: mask_route(*masks(f), False),
                            small=False)
        bases = [sub["base"] for sub in feed.get("shards", ())] or [0]
        couts = self._per_shard(feed, n, lambda f, m, s: sm.sel_compact(
            mouts[s], cap, [] if route != sm.ROUTE_COMPACT else
            [t for v, ok in self._planes(f)
             for t in ((v,) if ok is None else (v, ok))]))

        def finalize(fetched):
            got = [c.from_host(h) for c, h in zip(couts, fetched)]
            count = sum(g[0] for g in got)
            self._sel_observe(keys, count / n)
            if any(g[1] for g in got):
                return mask_route(*masks([t.cpu().numpy()
                                          for t in mask_bufs()]), True)
            self._note_route(route)
            if route == sm.ROUTE_INDEX:
                return gather(np.concatenate([
                    idx[:c].astype(np.int64) + b
                    for (c, _o, idx, _outs), b in zip(got, bases)]))
            outs = got[0][3]
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
        return _Pending(self._home([c.buf for c in couts]), finalize,
                        small=False)

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

        def select(f, m, _s):
            pairs, mask = self._inputs(plan, f, m)
            ci = _bare_col(plan.order_rpn)
            if ci is not None:
                values, ok = self._planes(f)[ci]
            else:
                # REAL columns are float64 planes here, REAL constants
                # float64
                values, ok = eval_rpn(plan.order_rpn, pairs, m, torch,
                                      self._dev(f), real=torch.float64)
                values, ok = values.contiguous(), ok.contiguous()
            n_used, seglen = tn.segments(m, f["n_pad"])
            placement = tn.digit_placement(values.dtype, plan.order_desc,
                                           bounds)
            return tn.topn_select(values, ok, mask, plan.order_desc, m,
                                  n_used, seglen, plan.limit,
                                  placement=placement)

        picked = self._per_shard(feed, n, select)
        # each shard's (first row, live rows): its candidates' global ids
        spans = [(sub["base"], sub["n_live"])
                 for sub in feed["shards"][:len(picked)]] \
            if "shards" in feed else [(0, n)]
        return _Pending(self._home(picked), lambda f: self._topn_rows(
            dag, plan, storage, get_batch, f, spans), small=False)

    @staticmethod
    def _topn_rows(dag, plan, storage, get_batch, fetched,
                   spans) -> SelectResult:
        """The TopN's rows from every shard's fetched ``topn_select``
        positions and flags (≤ k a shard; ``spans``: each shard's first row
        and live rows): the candidates gathered, then ordered exactly."""
        gidx, okk = [], []
        for host, (base, m) in zip(fetched, spans):
            live = (host[1] & 1 != 0) & (host[0] < m)
            gidx.append(host[0][live] + base)
            okk.append(host[1][live] & 2 != 0)
        gidx, okk = np.concatenate(gidx), np.concatenate(okk)
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
        if plan.order_host_rpn.ret_type is not EvalType.REAL:
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
