"""The host pipeline: built from a DAG, then run to completion.

Reference: tidb_query_executors/src/runner.rs — ``build_executors``
(:181) maps the DAG's descriptors onto executors (a scan first; the
aggregation executor picked by plan shape, :293-318), and
``BatchExecutorsRunner::handle_request`` (:498) drives the pipeline with
batches growing 32 → ×2 → 1024 (:38-45), collecting exec summaries.  A
columnar snapshot (``scan_columns``) is scanned without a row decode
(``columnar.BatchColumnarTableScanExecutor``), in batches of up to 2^20
rows, since every executor is vectorized.

The endpoint runs every DAG outside the device envelope here, and a
device fault (``device.DEVICE_FAULTS``) degrades here unless the device
was forced; the plan IR runs
its host fragments here (``copr/plan_ir.py``).  Paged requests (the
reference's resume tokens) are outside the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..copr.dag import (
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
from ..datatype import ColumnBatch, EvalType
from .aggregation import (
    BatchFastHashAggExecutor,
    BatchSimpleAggExecutor,
    BatchSlowHashAggExecutor,
    BatchStreamAggExecutor,
)
from .interface import BatchExecutor, ExecSummary
from .scan import BatchIndexScanExecutor, BatchTableScanExecutor
from .simple import (
    BatchLimitExecutor,
    BatchProjectionExecutor,
    BatchSelectionExecutor,
)
from .top_n import BatchPartitionTopNExecutor, BatchTopNExecutor

BATCH_INITIAL_SIZE = 32
BATCH_MAX_SIZE = 1024
BATCH_GROW_FACTOR = 2
# a columnar feed's batches: the cap only bounds the runner's loop
BATCH_MAX_SIZE_COLUMNAR = 1 << 20


@dataclass
class SelectResult:
    """A response: the final columns, each executor's summary (the scan's
    first; none from the device runner) and the warnings."""

    batch: ColumnBatch
    exec_summaries: list = field(default_factory=list)
    warnings: list = field(default_factory=list)
    is_drained: bool = True

    def rows(self):
        return self.batch.rows()


def build_executors(dag: DAGRequest, storage) -> BatchExecutor:
    """Reference: runner.rs build_executors — the first descriptor is a
    scan; the aggregation executor follows runner.rs:293-318."""
    descs = dag.executors
    if not descs:
        raise ValueError("empty executor list")
    head = descs[0]
    if not isinstance(head, (TableScanDesc, IndexScanDesc)):
        raise ValueError(f"pipeline must start with a scan, got {head}")
    if hasattr(storage, "scan_columns"):
        from .columnar import BatchColumnarTableScanExecutor
        ex: BatchExecutor = BatchColumnarTableScanExecutor(
            storage, head, dag.ranges)
    elif isinstance(head, TableScanDesc):
        ex = BatchTableScanExecutor(storage, head, dag.ranges)
    else:
        ex = BatchIndexScanExecutor(storage, head, dag.ranges)
    for d in descs[1:]:
        if isinstance(d, SelectionDesc):
            ex = BatchSelectionExecutor(ex, d)
        elif isinstance(d, ProjectionDesc):
            ex = BatchProjectionExecutor(ex, d)
        elif isinstance(d, AggregationDesc):
            ex = agg_executor(ex, d)
        elif isinstance(d, TopNDesc):
            ex = BatchTopNExecutor(ex, d)
        elif isinstance(d, PartitionTopNDesc):
            ex = BatchPartitionTopNExecutor(ex, d)
        elif isinstance(d, LimitDesc):
            ex = BatchLimitExecutor(ex, d)
        else:
            raise ValueError(f"unsupported executor {d}")
    return ex


def agg_executor(child, d: AggregationDesc):
    """The aggregation executor of ``d``'s shape (runner.rs:293-318)."""
    if not d.group_by:
        return BatchSimpleAggExecutor(child, d)
    if d.streamed:
        return BatchStreamAggExecutor(child, d)
    if len(d.group_by) == 1 and _is_fast_key(d.group_by[0]):
        return BatchFastHashAggExecutor(child, d)
    return BatchSlowHashAggExecutor(child, d)


def _is_fast_key(e) -> bool:
    """Fast hash agg: one INT or REAL key (a column or a call)."""
    if e.kind == "call":
        from ..expr.functions import FUNCTIONS
        return FUNCTIONS[e.sig].ret in (EvalType.INT, EvalType.REAL)
    return e.eval_type in (EvalType.INT, EvalType.REAL)


class BatchExecutorsRunner:
    """Drives the pipeline to completion (reference: runner.rs
    handle_request / internal_handle_request)."""

    def __init__(self, dag: DAGRequest, storage):
        self._dag = dag
        self._out = build_executors(dag, storage)
        self._max_batch = BATCH_MAX_SIZE_COLUMNAR \
            if hasattr(storage, "scan_columns") else BATCH_MAX_SIZE

    def handle_request(self) -> SelectResult:
        batch_size = BATCH_INITIAL_SIZE
        chunks: list[ColumnBatch] = []
        warnings: list = []
        while True:
            r = self._out.next_batch(batch_size)
            if r.batch.num_rows:
                chunks.append(r.batch)
            warnings.extend(r.warnings)
            if r.is_drained:
                break
            batch_size = min(batch_size * BATCH_GROW_FACTOR,
                             self._max_batch)
        batch = ColumnBatch.concat(chunks) if chunks \
            else ColumnBatch.empty(self._out.schema)
        if self._dag.output_offsets is not None:
            batch = ColumnBatch(
                [batch.schema[i] for i in self._dag.output_offsets],
                [batch.columns[i] for i in self._dag.output_offsets])
        return SelectResult(batch, _collect_summaries(self._out), warnings)


def _collect_summaries(ex) -> list[ExecSummary]:
    out = []
    cur = ex
    while cur is not None:
        out.append(cur.summary)
        cur = getattr(cur, "_child", None)
    return list(reversed(out))      # the scan's first, as the reference
