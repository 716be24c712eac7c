"""The plan IR: one operator-DAG request, routed per fragment.

A trimmed copy of the JAX package's ``copr/plan_ir.py``.  The tipb
vocabulary (``copr/dag.py``) is a linear chain rooted at one scan; a
:class:`PlanRequest` holds an operator DAG (:class:`ScanNode`,
:class:`SelectNode`, …, :class:`JoinNode`, :class:`SortNode`,
:class:`WindowNode`) of which every linear chain is a special case
(:func:`from_dag`).

- The plan splits into FRAGMENTS (:func:`fragmentize`): maximal linear
  chains rooted at a scan (``LeafFragment``, exactly a DAGRequest), one
  fragment per join / sort / window, and the host operator chain above
  one (``HostOpsFragment``).
- :class:`FragmentRouter` places each fragment on the host or the device:
  a leaf by the endpoint's verdict (``supports`` and the row threshold), a
  join / sort / window by a cost model anchored on the same threshold,
  then by the per-kind wall-clock EWMAs this process observed.  One card
  is one slice: there is no placement.  The ``copr::plan_route`` failpoint
  sends every fragment to the host.
- :class:`PlanExecutor` runs the routed tree: device leaves through the
  ``DeviceRunner``, joins / sorts / windows through its ``DeviceJoiner``
  (``device/join.py``), host fragments through the host pipeline
  (``executors/``, ``run_host_ops``).  A device fault
  (``device.DEVICE_FAULTS``) degrades that fragment only to its host twin,
  counted in the endpoint's ``degrades``; under ``force_backend="device"``
  it raises.  Any other error (a kernel that fails to build or launch)
  propagates.

Determinism: an inner join emits pairs in probe scan order, then build
scan order (NULL keys never match); SORT is stable over the transformed
keys of :func:`sort_key_i64` / :func:`sort_key_f64` (NULLs first ASC, last
DESC); WINDOW emits its rows sorted by (partition, order) with the window
columns appended.  Host and device share the transforms, so both routes
give the same rows in the same order.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np

from ..datatype import Column, ColumnBatch, EvalType, FieldType
from ..device import DEVICE_FAULTS
from ..expr import Expr, build_rpn
from ..expr.eval import eval_rpn
from ..utils.failpoint import fail_point
from .dag import (
    AggregationDesc,
    DAGRequest,
    IndexScanDesc,
    LimitDesc,
    PartitionTopNDesc,
    ProjectionDesc,
    SelectionDesc,
    TableScanDesc,
    TopNDesc,
)

# ------------------------------------------------------------------ nodes


@dataclass(frozen=True)
class ScanNode:
    """Leaf: one table/index scan with its OWN key ranges — a join's two
    sides each carry their own region's ranges, and the endpoint
    acquires one snapshot per leaf."""

    scan: Union[TableScanDesc, IndexScanDesc]
    ranges: tuple            # tuple[KeyRange]


@dataclass(frozen=True)
class SelectNode:
    child: "PlanNode"
    conditions: tuple        # tuple[Expr] — ANDed


@dataclass(frozen=True)
class ProjectNode:
    child: "PlanNode"
    exprs: tuple


@dataclass(frozen=True)
class AggNode:
    child: "PlanNode"
    desc: AggregationDesc


@dataclass(frozen=True)
class TopNNode:
    child: "PlanNode"
    desc: TopNDesc


@dataclass(frozen=True)
class PartTopNNode:
    child: "PlanNode"
    desc: PartitionTopNDesc


@dataclass(frozen=True)
class LimitNode:
    child: "PlanNode"
    limit: int


@dataclass(frozen=True)
class JoinNode:
    """Inner equi-join.  ``left`` is the PROBE side (large; its
    selection predicates fuse into the device probe dispatch), ``right``
    is the BUILD side (small; its key column dictionary-sorts into the
    device-resident build structure).  Keys are column OFFSETS into
    each child's output schema.  Output schema = left columns ++ right
    columns; pairs emit ordered by probe scan position, then build scan
    position."""

    left: "PlanNode"
    right: "PlanNode"
    left_key: int
    right_key: int
    join_type: str = "inner"


@dataclass(frozen=True)
class SortNode:
    """Full stable sort (no limit — TopN stays the bounded variant).
    ``order_by``: tuple of (Expr, desc) evaluated over the child's
    output; NULLs first for ASC, last for DESC (MySQL)."""

    child: "PlanNode"
    order_by: tuple          # tuple[(Expr, desc: bool)]


@dataclass(frozen=True)
class WindowFuncDesc:
    """kind ∈ row_number | count | sum | avg | lag | lead.  ``arg`` is
    required for all but row_number; ``offset`` applies to lag/lead.
    count/sum/avg are RUNNING (rows from partition start to current
    row) — the shifted-segmented-scan shapes the device kernel serves."""

    kind: str
    arg: Optional[Expr] = None
    offset: int = 1


@dataclass(frozen=True)
class WindowNode:
    child: "PlanNode"
    partition_by: tuple      # tuple[Expr]
    order_by: tuple          # tuple[(Expr, desc: bool)]
    funcs: tuple             # tuple[WindowFuncDesc]


PlanNode = Union[ScanNode, SelectNode, ProjectNode, AggNode, TopNNode,
                 PartTopNNode, LimitNode, JoinNode, SortNode, WindowNode]

_LINEAR = (SelectNode, ProjectNode, AggNode, TopNNode, PartTopNNode,
           LimitNode)


@dataclass(frozen=True)
class PlanRequest:
    """The IR request envelope (the coppb Request analog for plans)."""

    root: PlanNode
    start_ts: int = 0
    output_offsets: Optional[tuple] = None
    encode_type: str = "chunk"

    def scan_leaves(self) -> list[ScanNode]:
        out: list[ScanNode] = []

        def walk(n: PlanNode) -> None:
            if isinstance(n, ScanNode):
                out.append(n)
            elif isinstance(n, JoinNode):
                walk(n.left)
                walk(n.right)
            else:
                walk(n.child)
        walk(self.root)
        return out

    def has_join(self) -> bool:
        return any(True for _ in _iter_nodes(self.root)
                   if isinstance(_, JoinNode))


def _iter_nodes(n: PlanNode):
    yield n
    if isinstance(n, ScanNode):
        return
    if isinstance(n, JoinNode):
        yield from _iter_nodes(n.left)
        yield from _iter_nodes(n.right)
        return
    yield from _iter_nodes(n.child)


def from_dag(dag: DAGRequest) -> PlanRequest:
    """Embed a tipb-shaped linear DAGRequest into the IR (lossless)."""
    node: PlanNode = ScanNode(dag.executors[0], tuple(dag.ranges))
    for d in dag.executors[1:]:
        if isinstance(d, SelectionDesc):
            node = SelectNode(node, d.conditions)
        elif isinstance(d, ProjectionDesc):
            node = ProjectNode(node, d.exprs)
        elif isinstance(d, AggregationDesc):
            node = AggNode(node, d)
        elif isinstance(d, TopNDesc):
            node = TopNNode(node, d)
        elif isinstance(d, PartitionTopNDesc):
            node = PartTopNNode(node, d)
        elif isinstance(d, LimitDesc):
            node = LimitNode(node, d.limit)
        else:
            raise ValueError(f"unsupported executor {d}")
    return PlanRequest(node, start_ts=dag.start_ts,
                       output_offsets=dag.output_offsets,
                       encode_type=dag.encode_type)


# ------------------------------------------------------------- fragments


@dataclass
class LeafFragment:
    """Maximal linear chain rooted at a scan — exactly a DAGRequest, so
    it routes through the endpoint's existing host/device machinery."""

    chain: list              # [ScanNode, op descs...] bottom-up
    start_ts: int
    backend: str = "host"

    @property
    def scan_node(self) -> ScanNode:
        return self.chain[0]

    def dag(self) -> DAGRequest:
        descs: list = [self.scan_node.scan]
        for n in self.chain[1:]:
            if isinstance(n, SelectNode):
                descs.append(SelectionDesc(n.conditions))
            elif isinstance(n, ProjectNode):
                descs.append(ProjectionDesc(n.exprs))
            elif isinstance(n, (AggNode, TopNNode, PartTopNNode)):
                descs.append(n.desc)
            elif isinstance(n, LimitNode):
                descs.append(LimitDesc(n.limit))
        return DAGRequest(tuple(descs), tuple(self.scan_node.ranges),
                          start_ts=self.start_ts)

    def probe_shape(self):
        """→ (scan_node, sel_conditions) when this fragment is a bare
        scan or scan+selection — the shape whose predicates fuse into a
        device join's probe dispatch — else None."""
        conds: tuple = ()
        for n in self.chain[1:]:
            if isinstance(n, SelectNode):
                conds = conds + tuple(n.conditions)
            else:
                return None
        return self.scan_node, conds


@dataclass
class JoinFragment:
    left: "Fragment"
    right: "Fragment"
    node: JoinNode
    backend: str = "host"


@dataclass
class SortFragment:
    child: "Fragment"
    node: SortNode
    backend: str = "host"


@dataclass
class WindowFragment:
    child: "Fragment"
    node: WindowNode
    backend: str = "host"


@dataclass
class HostOpsFragment:
    """Host-only operator chain above a join/sort/window fragment — the
    'host finalize' half of a mixed plan.  Runs the stock executors
    (aggregation/top_n/simple) over the child fragment's batch."""

    child: "Fragment"
    ops: list                # SelectNode/ProjectNode/AggNode/... bottom-up
    backend: str = "host"


Fragment = Union[LeafFragment, JoinFragment, SortFragment, WindowFragment,
                 HostOpsFragment]


def fragmentize(preq: PlanRequest) -> Fragment:
    def walk(n: PlanNode) -> Fragment:
        if isinstance(n, ScanNode):
            return LeafFragment([n], preq.start_ts)
        if isinstance(n, JoinNode):
            return JoinFragment(walk(n.left), walk(n.right), n)
        if isinstance(n, SortNode):
            return SortFragment(walk(n.child), n)
        if isinstance(n, WindowNode):
            return WindowFragment(walk(n.child), n)
        child = walk(n.child)
        if isinstance(child, LeafFragment):
            child.chain.append(n)
            return child
        if isinstance(child, HostOpsFragment):
            child.ops.append(n)
            return child
        return HostOpsFragment(child, [n])
    return walk(preq.root)


def _frag_kind(frag: Fragment) -> str:
    return {LeafFragment: "leaf", JoinFragment: "join",
            SortFragment: "sort", WindowFragment: "window",
            HostOpsFragment: "host_ops"}[type(frag)]


# -------------------------------------------------- shared sort transforms
#
# The device and host implementations of SORT/WINDOW (and the join's
# build-side ordering) share these EXACT key transforms, so stable
# sorts over the transformed keys are bit-identical across routes.
# Values at the int64 extremes clamp by 2 to make room for the NULL
# sentinels (order is preserved except that the two lowest/highest
# representable values collapse — consistently on both routes).

_I64 = np.iinfo(np.int64)


def sort_key_i64(values, validity, desc: bool, xp=np):
    v = xp.clip(values.astype(np.int64) if xp is np
                else values.astype("int64"), _I64.min + 2, _I64.max)
    if desc:
        return xp.where(validity, -v, _I64.max)
    return xp.where(validity, v, _I64.min)


def sort_key_f64(values, validity, desc: bool, xp=np):
    v = values.astype(np.float64) if xp is np else values.astype("float64")
    if desc:
        return xp.where(validity, -v, np.inf)
    return xp.where(validity, v, -np.inf)


def eval_order_keys(batch: ColumnBatch, order_by) -> list[np.ndarray]:
    """Evaluate (Expr, desc) pairs over a host batch → transformed
    int64/float64 key arrays (ascending stable sort of these yields the
    requested order)."""
    n = batch.num_rows
    cols = [(c.values, c.validity) for c in batch.columns]
    keys = []
    for e, desc in order_by:
        rpn = build_rpn(e)
        if rpn.ret_type not in (EvalType.INT, EvalType.REAL):
            raise ValueError(f"unsupported sort key type {rpn.ret_type}")
        v, ok = eval_rpn(rpn, cols, n, np)
        v = np.broadcast_to(v, (n,))
        ok = np.broadcast_to(ok, (n,))
        if rpn.ret_type is EvalType.INT:
            keys.append(sort_key_i64(v, ok, desc))
        else:
            keys.append(sort_key_f64(v, ok, desc))
    return keys


def stable_perm(keys: Sequence[np.ndarray],
                n: Optional[int] = None) -> np.ndarray:
    """Composed stable argsort (last key least significant — lexsort
    semantics with keys[0] as the primary).  ``n`` is required when
    ``keys`` may be empty (a keyless sort is the identity — it must
    not collapse to zero rows)."""
    if n is None:
        n = len(keys[0]) if keys else 0
    perm = np.arange(n, dtype=np.int64)
    for k in reversed(keys):
        perm = perm[np.argsort(k[perm], kind="stable")]
    return perm


# ------------------------------------------------------- host join / ops


def join_pairs_host(lk, lok, rk, rok):
    """Inner equi-join pair emission — the parity reference shared by
    the host route and the degrade path.  Returns
    ``(probe_idx, build_idx)`` ordered by probe position then build
    position; NULL keys never match."""
    lk = np.asarray(lk, dtype=np.int64)
    rk = np.asarray(rk, dtype=np.int64)
    vidx = np.flatnonzero(rok)
    order = vidx[np.argsort(rk[vidx], kind="stable")]
    skeys = rk[order]
    lo = np.searchsorted(skeys, lk, side="left")
    hi = np.searchsorted(skeys, lk, side="right")
    cnt = np.where(lok, hi - lo, 0)
    total = int(cnt.sum())
    probe_idx = np.repeat(np.arange(len(lk), dtype=np.int64), cnt)
    csum = np.cumsum(cnt)
    within = np.arange(total, dtype=np.int64) - \
        np.repeat(csum - cnt, cnt)
    build_idx = order[np.repeat(lo, cnt) + within]
    return probe_idx, build_idx


def concat_schemas(left: ColumnBatch, right: ColumnBatch) -> ColumnBatch:
    return ColumnBatch(list(left.schema) + list(right.schema),
                       list(left.columns) + list(right.columns))


class _BatchFeedExecutor:
    """Adapter: serve an in-memory ColumnBatch through the
    BatchExecutor pull interface, so the stock host executors
    (selection/projection/aggregation/top_n/limit) finalize plans whose
    input is a join/sort/window fragment's output instead of a scan."""

    def __init__(self, batch: ColumnBatch):
        from ..executors.interface import ExecSummary
        self.summary = ExecSummary()
        self._batch = batch
        self._pos = 0

    @property
    def schema(self):
        return self._batch.schema

    def next_batch(self, scan_rows: int):
        from ..executors.interface import BatchExecuteResult
        start = self._pos
        stop = min(start + scan_rows, self._batch.num_rows)
        self._pos = stop
        return BatchExecuteResult(self._batch.slice(start, stop),
                                  stop >= self._batch.num_rows)


def run_host_ops(batch: ColumnBatch, ops: Sequence) -> ColumnBatch:
    """Drive the host executors over an in-memory batch."""
    from ..executors.runner import agg_executor
    from ..executors.simple import (
        BatchLimitExecutor,
        BatchProjectionExecutor,
        BatchSelectionExecutor,
    )
    from ..executors.top_n import (BatchPartitionTopNExecutor,
                                   BatchTopNExecutor)
    ex = _BatchFeedExecutor(batch)
    for n in ops:
        if isinstance(n, SelectNode):
            ex = BatchSelectionExecutor(ex, SelectionDesc(n.conditions))
        elif isinstance(n, ProjectNode):
            ex = BatchProjectionExecutor(ex, ProjectionDesc(n.exprs))
        elif isinstance(n, AggNode):
            ex = agg_executor(ex, n.desc)
        elif isinstance(n, TopNNode):
            ex = BatchTopNExecutor(ex, n.desc)
        elif isinstance(n, PartTopNNode):
            ex = BatchPartitionTopNExecutor(ex, n.desc)
        elif isinstance(n, LimitNode):
            ex = BatchLimitExecutor(ex, LimitDesc(n.limit))
        else:
            raise ValueError(f"unsupported host op {n}")
    chunks = []
    while True:
        r = ex.next_batch(1 << 20)
        if r.batch.num_rows:
            chunks.append(r.batch)
        if r.is_drained:
            break
    return ColumnBatch.concat(chunks) if chunks \
        else ColumnBatch.empty(ex.schema)


def window_host(batch: ColumnBatch, node: WindowNode) -> ColumnBatch:
    """Host window fragment: sort by (partition, order), then running
    aggregates as segmented scans over the sorted view — the numpy twin
    of the device kernel (device/join.py), same transforms, same
    emission order (sorted)."""
    n = batch.num_rows
    part_keys = eval_order_keys(
        batch, tuple((e, False) for e in node.partition_by))
    order_keys = eval_order_keys(batch, node.order_by)
    perm = stable_perm(part_keys + order_keys, n)
    sorted_batch = batch.take(perm)
    if part_keys:
        sp = np.stack([k[perm] for k in part_keys])
        boundary = np.ones(n, np.bool_)
        if n > 1:
            boundary[1:] = (sp[:, 1:] != sp[:, :-1]).any(axis=0)
    else:
        boundary = np.zeros(n, np.bool_)
        if n:
            boundary[0] = True
    seg_start = np.maximum.accumulate(
        np.where(boundary, np.arange(n, dtype=np.int64), 0))
    out_cols, out_schema = list(sorted_batch.columns), \
        list(sorted_batch.schema)
    cols = [(c.values, c.validity) for c in sorted_batch.columns]
    rn = np.arange(n, dtype=np.int64) - seg_start + 1
    ones = np.ones(n, np.bool_)
    for f in node.funcs:
        if f.kind == "row_number":
            out_cols.append(Column(EvalType.INT, rn.copy(), ones.copy()))
            out_schema.append(FieldType.long())
            continue
        rpn = build_rpn(f.arg)
        if rpn.ret_type not in (EvalType.INT, EvalType.REAL):
            raise ValueError(f"unsupported window arg type {rpn.ret_type}")
        v, ok = eval_rpn(rpn, cols, n, np)
        v = np.broadcast_to(v, (n,))
        ok = np.broadcast_to(ok, (n,))
        if f.kind in ("count", "sum", "avg"):
            okf = ok.astype(np.int64)
            ccnt = _seg_running(okf, seg_start)
            if f.kind == "count":
                out_cols.append(Column(EvalType.INT, ccnt, ones.copy()))
                out_schema.append(FieldType.long())
                continue
            vv = np.where(ok, v, 0)
            if rpn.ret_type is EvalType.INT:
                csum = _seg_running(vv.astype(np.int64), seg_start)
            else:
                csum = _seg_running(vv.astype(np.float64), seg_start)
            if f.kind == "sum":
                et = rpn.ret_type
                out_cols.append(Column(et, csum, ccnt > 0))
                out_schema.append(FieldType.long()
                                  if et is EvalType.INT
                                  else FieldType.double())
            else:       # avg
                with np.errstate(divide="ignore", invalid="ignore"):
                    avg = csum.astype(np.float64) / ccnt
                out_cols.append(Column(EvalType.REAL,
                                       np.where(ccnt > 0, avg, 0.0),
                                       ccnt > 0))
                out_schema.append(FieldType.double())
        elif f.kind in ("lag", "lead"):
            off = max(1, int(f.offset))
            idx = np.arange(n, dtype=np.int64)
            src = idx - off if f.kind == "lag" else idx + off
            in_seg = (src >= seg_start) if f.kind == "lag" else \
                (src < _seg_end(seg_start, n))
            in_bounds = (src >= 0) & (src < n)
            safe = np.clip(src, 0, max(0, n - 1))
            valid = in_bounds & in_seg & \
                (ok[safe] if n else np.zeros(0, np.bool_))
            vals = v[safe] if n else v
            out_cols.append(Column(rpn.ret_type,
                                   np.where(valid, vals, 0), valid))
            out_schema.append(FieldType.long()
                              if rpn.ret_type is EvalType.INT
                              else FieldType.double())
        else:
            raise ValueError(f"unsupported window func {f.kind}")
    return ColumnBatch(out_schema, out_cols)


def _seg_running(vals: np.ndarray, seg_start: np.ndarray) -> np.ndarray:
    """Inclusive running reduction (sum) within segments: the classic
    'cumsum minus the segment-start offset' shifted segmented scan."""
    n = len(vals)
    if not n:
        return vals
    cs = np.cumsum(vals)
    base = cs[seg_start] - vals[seg_start]
    return cs - base


def _seg_end(seg_start: np.ndarray, n: int) -> np.ndarray:
    """Exclusive end index of each row's segment."""
    if not n:
        return seg_start
    is_start = seg_start == np.arange(n)
    starts = np.flatnonzero(is_start)
    # rows of segment i end where segment i+1 starts
    bounds = np.append(starts[1:], n)
    return bounds[np.cumsum(is_start) - 1]


# ----------------------------------------------------------- the router


class FragmentRouter:
    """Per-fragment host/device placement.

    Leaves take the endpoint's verdict (``supports`` and the row
    threshold).  A join / sort / window compares a modeled device cost —
    the launch figure (``LAUNCH_S``) per dispatch plus its D2H payload —
    against a host cost anchored on the same row threshold; once both
    routes of a kind have measured walls, the faster wins, and every
    ``REPROBE_EVERY`` such decisions the other route serves once to
    refresh its wall."""

    D2H_BYTES_PER_S = 8e9
    EWMA_ALPHA = 0.25
    REPROBE_EVERY = 16
    # the reference's launch figure where no coalescer measures one
    LAUNCH_S = 1.5e-3

    def __init__(self, endpoint):
        self._endpoint = endpoint
        self._mu = threading.Lock()
        self._walls: dict = {}          # (kind, backend) → EWMA seconds
        self._probe_ticks: dict = {}
        self.decisions: dict = {}

    def note_wall(self, kind: str, backend: str, wall_s: float) -> None:
        with self._mu:
            cur = self._walls.get((kind, backend))
            self._walls[(kind, backend)] = wall_s if cur is None else \
                (self.EWMA_ALPHA * wall_s + (1 - self.EWMA_ALPHA) * cur)

    def _wall(self, kind: str, backend: str) -> Optional[float]:
        with self._mu:
            return self._walls.get((kind, backend))

    def _threshold(self) -> int:
        return getattr(self._endpoint, "_device_row_threshold", 0) or 131072

    def _note(self, kind: str, backend: str) -> str:
        with self._mu:
            k = (kind, backend)
            self.decisions[k] = self.decisions.get(k, 0) + 1
        return backend

    def route(self, frag: Fragment, storages: dict,
              force_backend: Optional[str] = None) -> None:
        """Annotate ``frag`` (recursively) with per-fragment backends."""
        forced_host = force_backend == "host" or \
            fail_point("copr::plan_route") is not None
        self._route_rec(frag, storages, forced_host,
                        force_dev=force_backend == "device")

    def _route_rec(self, frag, storages, forced_host: bool,
                   force_dev: bool) -> None:
        runner = getattr(self._endpoint, "_device_runner", None)
        if isinstance(frag, LeafFragment):
            frag.backend = self._route_leaf(frag, storages, forced_host,
                                            force_dev, runner)
            self._note("leaf", frag.backend)
            return
        if isinstance(frag, HostOpsFragment):
            frag.backend = "host"
            self._note("host_ops", "host")
            self._route_rec(frag.child, storages, forced_host, force_dev)
            return
        children = [frag.left, frag.right] if isinstance(
            frag, JoinFragment) else [frag.child]
        for c in children:
            self._route_rec(c, storages, forced_host, force_dev)
        if forced_host or runner is None:
            frag.backend = "host"
        elif force_dev:
            frag.backend = "device"
        else:
            frag.backend = self._model(frag, storages)
        self._note(_frag_kind(frag), frag.backend)

    def _route_leaf(self, frag, storages, forced_host, force_dev,
                    runner) -> str:
        if forced_host or runner is None:
            return "host"
        storage = storages.get(id(frag.scan_node))
        if storage is None or not runner.supports(frag.dag()):
            return "host"
        if force_dev:
            return "device"
        n = self._rows_of(frag, storages)
        return "device" if n is not None and n >= self._threshold() \
            else "host"

    def _rows_of(self, frag, storages) -> Optional[int]:
        if isinstance(frag, LeafFragment):
            est = getattr(storages.get(id(frag.scan_node)),
                          "estimated_rows", None)
            return est() if callable(est) else None
        if isinstance(frag, JoinFragment):
            return self._rows_of(frag.left, storages)
        return self._rows_of(frag.child, storages)

    def _model(self, frag, storages) -> str:
        """The modeled device-vs-host choice of a join / sort / window;
        the observed per-kind walls override it once both exist."""
        kind = _frag_kind(frag)
        dev_w, host_w = self._wall(kind, "device"), self._wall(kind, "host")
        if dev_w is not None and host_w is not None:
            winner = "device" if dev_w <= host_w else "host"
            with self._mu:
                self._probe_ticks[kind] = self._probe_ticks.get(kind, 0) + 1
                if self._probe_ticks[kind] >= self.REPROBE_EVERY:
                    self._probe_ticks[kind] = 0
                    return "host" if winner == "device" else "device"
            return winner
        n = self._rows_of(frag, storages)
        if n is None:
            return "host"
        # 8 B a pair (a join) or a permutation row (sort / window) cross
        # to the host; a join is two dispatches
        d2h = 8.0 * n / self.D2H_BYTES_PER_S
        cost_dev = self.LAUNCH_S * (2.0 if kind == "join" else 1.0) + d2h
        # a join / sort is a super-linear host pass: ~2x the linear
        # per-row figure the threshold calibrates
        cost_host = 2.0 * n * self.LAUNCH_S / max(1, self._threshold())
        return "device" if cost_dev < cost_host else "host"

    def stats(self) -> dict:
        with self._mu:
            return {
                "decisions": {f"{k[0]}:{k[1]}": v
                              for k, v in self.decisions.items()},
                "wall_ewma_ms": {f"{k[0]}:{k[1]}": v * 1e3
                                 for k, v in self._walls.items()},
            }


# --------------------------------------------------------- the executor


class PlanExecutor:
    """Executes a routed fragment tree: device fragments through the
    runner and its joiner with a per-fragment host degrade, host
    fragments through the host pipeline.  One per endpoint."""

    def __init__(self, endpoint):
        self._endpoint = endpoint
        self.router = FragmentRouter(endpoint)
        self._mu = threading.Lock()
        self.join_backends: dict = {}       # device / host / degrade
        self.plans_served = 0
        # host-clock ms of the last plan, by phase (``_timed``)
        self.phases_ms: dict = {}

    def _note_join(self, backend: str) -> None:
        with self._mu:
            self.join_backends[backend] = \
                self.join_backends.get(backend, 0) + 1

    def _degrade(self, reason: str) -> None:
        note = getattr(self._endpoint, "note_degrade", None)
        if note is not None:
            note(reason)

    def _timed(self, name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.phases_ms[name] = self.phases_ms.get(name, 0.0) + \
                (time.perf_counter() - t0) * 1e3

    def execute(self, preq: PlanRequest, storages: dict,
                force_backend: Optional[str] = None):
        """→ SelectResult; ``storages``: {id(scan node): storage}.

        ``force_backend="device"`` routes every fragment to the device
        and raises on a device FAULT; a fragment outside the device
        envelope (a non-INT join key, a REAL running sum, …) still runs
        on its host twin — capability, not failure.
        ``force_backend="host"`` routes everything to the host."""
        from ..executors.interface import ExecSummary
        from ..executors.runner import SelectResult
        self.phases_ms = {}
        frag = fragmentize(preq)
        self._timed("route", self.router.route, frag, storages,
                    force_backend)
        batch = self._exec(frag, storages, force_backend)
        if preq.output_offsets is not None:
            batch = ColumnBatch(
                [batch.schema[i] for i in preq.output_offsets],
                [batch.columns[i] for i in preq.output_offsets])
        with self._mu:
            self.plans_served += 1
        summary = ExecSummary(num_produced_rows=batch.num_rows,
                              num_iterations=1)
        return SelectResult(batch, [summary])

    def _exec(self, frag: Fragment, storages, force) -> ColumnBatch:
        t0 = time.perf_counter()
        # the wall is charged to the backend the router CHOSE, so a
        # device route that keeps faulting inflates the device EWMA
        chosen = frag.backend
        try:
            if isinstance(frag, LeafFragment):
                return self._timed("leaf", self._exec_leaf, frag,
                                   storages, force)
            if isinstance(frag, HostOpsFragment):
                child = self._exec(frag.child, storages, force)
                return self._timed("host_ops", run_host_ops, child,
                                   frag.ops)
            if isinstance(frag, JoinFragment):
                return self._exec_join(frag, storages, force)
            if isinstance(frag, SortFragment):
                return self._exec_sort(frag, storages, force)
            if isinstance(frag, WindowFragment):
                return self._exec_window(frag, storages, force)
            raise TypeError(frag)
        finally:
            self.router.note_wall(_frag_kind(frag), chosen,
                                  time.perf_counter() - t0)

    def _exec_leaf(self, frag: LeafFragment, storages, force) -> ColumnBatch:
        from ..executors.runner import BatchExecutorsRunner
        dag = frag.dag()
        storage = storages[id(frag.scan_node)]
        if frag.backend == "device":
            runner = self._endpoint._device_runner
            try:
                return runner.handle_request(dag, storage).batch
            except DEVICE_FAULTS:   # per-fragment degrade
                if force == "device":
                    raise
                self._degrade("plan_leaf")
                frag.backend = "host"
        return BatchExecutorsRunner(dag, storage).handle_request().batch

    # -- join --

    def _exec_join(self, frag: JoinFragment, storages, force) -> ColumnBatch:
        node = frag.node
        if node.join_type != "inner":
            # refuse loudly: inner-joining a left/semi plan would return
            # wrong rows with no error
            raise ValueError(f"unsupported join_type {node.join_type!r} "
                             "(the IR serves inner equi-joins)")
        counted = False
        if frag.backend == "device":
            try:
                out = self._device_join(frag, storages)
                if out is not None:
                    self._note_join("device")
                    return out
            except DEVICE_FAULTS:
                # a faulted device join falls back to the host join for
                # this fragment only
                if force == "device":
                    raise
                self._degrade("join")
                self._note_join("degrade")
                counted = True
            frag.backend = "host"
        if not counted:
            self._note_join("host")
        left = self._exec(frag.left, storages, force)
        right = self._exec(frag.right, storages, force)
        lc, rc = left.columns[node.left_key], right.columns[node.right_key]
        pi, bi = self._timed("host_join", join_pairs_host, lc.values,
                             lc.validity, rc.values, rc.validity)
        return self._timed("gather", lambda: concat_schemas(
            left.take(pi), right.take(bi)))

    def _device_join(self, frag: JoinFragment, storages):
        """Late-materialized device join: row pairs from the device, the
        host gathers the columns.  None when the fragment's shape is
        outside the device envelope (the caller joins on the host)."""
        from ..device.join import join_supported
        node = frag.node
        if not isinstance(frag.left, LeafFragment) or \
                not isinstance(frag.right, LeafFragment):
            return None
        probe = frag.left.probe_shape()
        build = frag.right.probe_shape()
        if probe is None or build is None or build[1]:
            return None     # the build side must be a bare scan
        probe_scan, probe_conds = probe
        build_scan, _ = build
        if not join_supported(probe_scan.scan, probe_conds, node.left_key,
                              build_scan.scan, node.right_key):
            return None
        lstor = storages[id(probe_scan)]
        rstor = storages[id(build_scan)]
        runner = self._endpoint._device_runner
        if runner is None or not hasattr(lstor, "scan_columns") or \
                not hasattr(rstor, "scan_columns"):
            return None
        pairs = runner.joiner().join(
            probe_scan.scan, probe_scan.ranges, lstor, probe_conds,
            node.left_key, build_scan.scan, build_scan.ranges, rstor,
            node.right_key)
        if pairs is None:
            return None
        pi, bi = pairs
        # late materialization: only the matched rows, from the host
        # snapshots
        return self._timed("gather", lambda: concat_schemas(
            lstor.gather_rows(probe_scan.scan, probe_scan.ranges, pi),
            rstor.gather_rows(build_scan.scan, build_scan.ranges, bi)))

    # -- sort / window --

    def _exec_sort(self, frag: SortFragment, storages, force) -> ColumnBatch:
        child = self._exec(frag.child, storages, force)
        keys = self._timed("keys", eval_order_keys, child,
                           frag.node.order_by)
        if not keys:
            return child        # a keyless sort is the identity
        n = child.num_rows
        if frag.backend == "device":
            runner = self._endpoint._device_runner
            try:
                perm = runner.joiner().sort_perm(keys, n)
                if perm is not None:
                    return self._timed("gather", child.take, perm)
            except DEVICE_FAULTS:   # per-fragment degrade
                if force == "device":
                    raise
                self._degrade("sort")
            frag.backend = "host"
        return child.take(stable_perm(keys, n))

    def _exec_window(self, frag: WindowFragment, storages,
                     force) -> ColumnBatch:
        child = self._exec(frag.child, storages, force)
        if frag.backend == "device":
            runner = self._endpoint._device_runner
            try:
                out = runner.joiner().window(child, frag.node)
                if out is not None:
                    return out
            except DEVICE_FAULTS:   # per-fragment degrade
                if force == "device":
                    raise
                self._degrade("window")
            frag.backend = "host"
        return window_host(child, frag.node)
