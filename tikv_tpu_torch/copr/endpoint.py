"""Coprocessor endpoint: a request's snapshot, its backend, and its answer.

A trimmed copy of the JAX package's ``copr/endpoint.py`` (reference:
src/coprocessor/endpoint.rs ``parse_and_handle_unary_request``), on the
synchronous path:

- ``handle(CopRequest)``: a DAG request against the snapshot the provider
  gives; ``_pick_backend`` sends it to the device runner when the runner
  supports the plan and the snapshot holds at least
  ``device_row_threshold`` rows (or when ``force_backend`` says so), else
  to the host pipeline (``executors/``).  A device fault
  (``device.DEVICE_FAULTS``) degrades the request to the host pipeline,
  counted by reason in ``degrades``, unless the request forced the device:
  then it raises.  Any other error, such as a kernel that fails to build
  or launch, propagates.
- ``handle_plan(PlanRequest)``: a plan-IR request (``copr/plan_ir.py``):
  one snapshot per scan leaf, then the ``plan_executor`` routes and runs
  each fragment; a fragment's degrade is counted in ``degrades`` too.
- ``handle_analyze(AnalyzeReq)`` (tp 104): per-column statistics, on the
  device runner (``handle_analyze``: the column sorts on the card) when
  the snapshot holds at least ``device_row_threshold`` rows, else by the
  host half (``copr/analyze.py``) over the host pipeline's scan; a device
  fault degrades it to the host half, counted in ``degrades["analyze"]``.
- ``handle_checksum(ChecksumReq)`` (tp 105): the crc64-xz XOR fold of the
  snapshot's logical KV pairs within the ranges, on the host.

Paged requests and the deferred (asynchronous) path are outside the port.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..device import DEVICE_FAULTS
from .dag import DAGRequest

REQ_TYPE_DAG = 103
REQ_TYPE_ANALYZE = 104
REQ_TYPE_CHECKSUM = 105


@dataclass
class CopRequest:
    """Reference: coppb::Request (tp + the DAG with its ranges and
    start_ts); ``force_backend``: "host", "device" or None (by the row
    threshold)."""

    tp: int
    dag: DAGRequest
    force_backend: Optional[str] = None


@dataclass
class CopResponse:
    result: object          # executors.runner.SelectResult
    elapsed_ns: int = 0
    backend: str = "host"

    def rows(self):
        return self.result.rows()


class Endpoint:
    """Unary coprocessor endpoint over a snapshot provider:
    ``snapshot_provider(CopRequest)`` returns the storage a request reads
    (a columnar snapshot, or a KV feed for the host pipeline)."""

    # the solo device break-even of the reference (endpoint.py:132), in
    # rows of the snapshot
    DEFAULT_DEVICE_ROW_THRESHOLD = 131072

    def __init__(self, snapshot_provider: Callable, device_runner=None,
                 device_row_threshold: int = DEFAULT_DEVICE_ROW_THRESHOLD):
        self._snapshot_provider = snapshot_provider
        self._device_runner = device_runner
        self._device_row_threshold = device_row_threshold
        self._plan_executor = None
        self._mu = threading.Lock()
        # degrades to the host, by reason: "dispatch" (a DAG request),
        # "plan_leaf", "join", "sort", "window" (a plan's fragment),
        # "analyze" (an ANALYZE request)
        self.degrades: dict = {}

    def note_degrade(self, reason: str) -> None:
        with self._mu:
            self.degrades[reason] = self.degrades.get(reason, 0) + 1

    @property
    def plan_executor(self):
        with self._mu:
            if self._plan_executor is None:
                from .plan_ir import PlanExecutor
                self._plan_executor = PlanExecutor(self)
            return self._plan_executor

    def handle(self, req: CopRequest) -> CopResponse:
        from ..executors.runner import BatchExecutorsRunner
        if req.tp != REQ_TYPE_DAG:
            raise NotImplementedError(f"request type {req.tp}")
        t0 = time.perf_counter_ns()
        storage = self._snapshot_provider(req)
        backend = self._pick_backend(req, storage)
        result = None
        if backend == "device":
            try:
                result = self._device_runner.handle_request(req.dag,
                                                            storage)
            except DEVICE_FAULTS:
                # a device fault degrades the request to the host
                # pipeline; a forced device request surfaces it (a kernel
                # that fails to build or launch is not one: it raises)
                if req.force_backend == "device":
                    raise
                self.note_degrade("dispatch")
                backend = "host"
        if result is None:
            result = BatchExecutorsRunner(req.dag, storage).handle_request()
        return CopResponse(result, time.perf_counter_ns() - t0, backend)

    def handle_plan(self, preq, force_backend: Optional[str] = None
                    ) -> CopResponse:
        """A plan-IR request: one snapshot per scan leaf through the same
        provider (each leaf routes by its own scan and ranges), then the
        plan executor."""
        t0 = time.perf_counter_ns()
        storages = {}
        for leaf in preq.scan_leaves():
            sub = CopRequest(REQ_TYPE_DAG, DAGRequest(
                (leaf.scan,), tuple(leaf.ranges), start_ts=preq.start_ts))
            storages[id(leaf)] = self._snapshot_provider(sub)
        result = self.plan_executor.execute(preq, storages, force_backend)
        return CopResponse(result, time.perf_counter_ns() - t0, "plan")

    def handle_analyze(self, areq, storage=None) -> dict:
        """tp=104 (src/coprocessor/statistics/, endpoint.rs:275-312):
        per-column equi-depth histograms with distinct and NULL counts →
        {"columns": [ColumnStats]}.  Routed like a DAG request: a snapshot
        of at least ``device_row_threshold`` rows sorts its columns on the
        card, a smaller one on the host."""
        from ..executors.runner import BatchExecutorsRunner
        from .analyze import analyze_columns
        dag = DAGRequest((areq.scan,), tuple(areq.ranges),
                         start_ts=areq.start_ts)
        if storage is None:
            storage = self._snapshot_provider(
                CopRequest(REQ_TYPE_ANALYZE, dag))
        runner = self._device_runner
        est = getattr(storage, "estimated_rows", None)
        n = est() if callable(est) else None
        if runner is not None and n is not None and \
                n >= self._device_row_threshold and \
                hasattr(storage, "scan_columns"):
            try:
                return {"columns": runner.handle_analyze(dag, storage,
                                                         areq.buckets)}
            except DEVICE_FAULTS:
                # a device fault degrades the request to the host half; a
                # kernel that fails to build or launch is not one: it
                # raises
                self.note_degrade("analyze")
        result = BatchExecutorsRunner(dag, storage).handle_request()
        return {"columns": analyze_columns(result.batch, areq.scan.columns,
                                           areq.buckets)}

    def handle_checksum(self, creq, storage=None) -> dict:
        """tp=105 (src/coprocessor/checksum.rs): crc64-xz XOR-folded over
        the logical rows (record key + row payload) within the request's
        ranges: the same visible content gives the same checksum on every
        replica, whatever its MVCC history."""
        from .analyze import checksum_kv_pairs
        dag = DAGRequest((creq.scan,), tuple(creq.ranges),
                         start_ts=creq.start_ts)
        if storage is None:
            storage = self._snapshot_provider(
                CopRequest(REQ_TYPE_CHECKSUM, dag))
        if not hasattr(storage, "to_kv_pairs"):
            raise NotImplementedError(
                "checksum requires a table snapshot feed")
        pairs = storage.to_kv_pairs(tuple(creq.ranges) or None)
        return checksum_kv_pairs([k for k, _ in pairs],
                                 [v for _, v in pairs])

    def _pick_backend(self, req: CopRequest, storage) -> str:
        runner = self._device_runner
        if req.force_backend in ("host", "device"):
            if req.force_backend == "device":
                if runner is None:
                    raise RuntimeError("no device runner registered")
                if not runner.supports(req.dag):
                    raise RuntimeError("plan not supported by the device "
                                       "backend")
            return req.force_backend
        if runner is None or not runner.supports(req.dag):
            return "host"
        est = getattr(storage, "estimated_rows", None)
        n = est() if callable(est) else None
        if n is not None and n >= self._device_row_threshold:
            return "device"
        return "host"
