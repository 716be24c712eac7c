"""Coprocessor endpoint: a request's snapshot, its backend, and its answer.

A trimmed copy of the JAX package's ``copr/endpoint.py`` (reference:
src/coprocessor/endpoint.rs ``parse_and_handle_unary_request``):

- ``handle_async(CopRequest)`` → ``CopDeferred``: a DAG request against the
  snapshot the provider gives.  ``_pick_backend`` sends it to the device
  runner when the runner supports the plan and the snapshot holds at
  least ``device_row_threshold`` rows (or when ``force_backend`` says so),
  else to the host pipeline (``executors/``), which answers at once.
  With a ``RequestCoalescer`` bound (``coalescer=``), its cost router
  decides each device request that was not forced: batched into a
  coalesced group, solo, back to the host, or shed (``ServerIsBusy`` with
  ``retry_after_ms``).  A solo device request returns as soon as its
  kernels are launched; its fetch and host finalize run on the endpoint's
  ``CompletionPool``, and ``CopDeferred.wait()`` joins them.
  ``handle(req)`` is ``handle_async(req).wait()``.
- A device fault (``device.DEVICE_FAULTS``) at dispatch or at the fetch
  degrades the request to the host pipeline, counted by reason in
  ``degrades`` ("dispatch", "fetch"), unless the request forced the
  device: then it raises.  Any other error, such as a kernel that fails
  to build or launch, propagates.
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

Each DAG request gets a ``utils.tracker.Tracker`` (unless its caller has
one current): its phases and labels come back on ``CopResponse.tracker``.
Paged requests, the fast path and resource tags are outside the port
(ROADMAP.md queue 1 items 6 and 7).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..device import DEVICE_FAULTS, DeviceUnavailable
from ..utils import tracker
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
    tracker: Optional[object] = None    # utils.tracker.Tracker

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
                 device_row_threshold: int = DEFAULT_DEVICE_ROW_THRESHOLD,
                 completion_workers: int = 8, coalescer=None):
        self._snapshot_provider = snapshot_provider
        self._device_runner = device_runner
        self._device_row_threshold = device_row_threshold
        self._plan_executor = None
        self._mu = threading.Lock()
        # degrades to the host, by reason: "dispatch" and "fetch" (a DAG
        # request), "plan_leaf", "join", "sort", "window" (a plan's
        # fragment), "analyze" (an ANALYZE request)
        self.degrades: dict = {}
        # cross-request device batching (server/coalescer.py); None: every
        # device request dispatches solo
        self.coalescer = coalescer
        if coalescer is not None:
            coalescer.bind(self)
        # deferred fetches resolve on a small pool, so requests in flight
        # overlap their waits (created at the first deferred fetch)
        self._completion_workers = completion_workers
        self._completion_pool = None
        self._completion_mu = threading.Lock()
        # whether the runner's handle_request takes ``deferred`` (probed
        # once: a runner without it is served synchronously)
        self._runner_deferred: Optional[bool] = None

    def close(self) -> None:
        """Flush the coalescer (its parked members resolve through the
        completion pool), then retire the completion pool's workers."""
        if self.coalescer is not None:
            self.coalescer.close()
        with self._completion_mu:
            if self._completion_pool is not None:
                self._completion_pool.shutdown()
                self._completion_pool = None

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

    def _completion(self):
        with self._completion_mu:
            if self._completion_pool is None:
                from ..server.read_pool import CompletionPool
                self._completion_pool = CompletionPool(
                    self._completion_workers)
            return self._completion_pool

    def _supports_deferred(self) -> bool:
        if self._runner_deferred is None:
            import inspect
            try:
                sig = inspect.signature(self._device_runner.handle_request)
                self._runner_deferred = "deferred" in sig.parameters
            except (TypeError, ValueError):
                self._runner_deferred = False
        return self._runner_deferred

    def handle(self, req: CopRequest) -> CopResponse:
        """Synchronous unary execution: dispatch and wait in one call."""
        return self.handle_async(req).wait()

    def handle_async(self, req: CopRequest) -> "CopDeferred":
        """Dispatch now, fetch later (endpoint.py:351-456): a device
        request returns once its kernels are launched (or, coalesced, once
        it is parked in its group); a host request comes back answered.
        The caller's deadline (``utils.deadline``) is checked before a
        device dispatch, and the cost router reads it."""
        if req.tp != REQ_TYPE_DAG:
            raise NotImplementedError(f"request type {req.tp}")
        tr, tok = tracker.current(), None
        if tr is None:
            tr, tok = tracker.install()
        try:
            return self._handle_async(req, tr)
        finally:
            if tok is not None:
                tracker.uninstall(tok)

    def _handle_async(self, req: CopRequest, tr) -> "CopDeferred":
        from ..utils.deadline import check_current
        t0 = time.perf_counter_ns()
        storage = self._snapshot_provider(req)
        backend = self._pick_backend(req, storage)
        tracker.label("backend", backend)
        if backend != "device":
            return CopDeferred(self, req, storage, t0, "host", tr,
                               result=self._host_exec(req, storage))
        # an expired request must not take a launch or a worker
        check_current("device_dispatch")
        coal = self.coalescer
        if coal is not None and req.force_backend is None:
            from ..server.coalescer import DEVICE_BATCHED, HOST, SHED
            decision, bkey, hint = coal.route(req.dag, storage)
            if decision == SHED:
                from ..server.read_pool import ServerIsBusy
                raise ServerIsBusy("device router: remaining budget below "
                                   "the modeled request cost",
                                   retry_after_ms=hint)
            if decision == HOST:
                tracker.label("backend", "host")
                return CopDeferred(self, req, storage, t0, "host", tr,
                                   result=self._host_exec(req, storage))
            if decision == DEVICE_BATCHED and bkey is not None:
                fut = coal.submit(bkey, req.dag, storage)
                return CopDeferred(self, req, storage, t0, backend, tr,
                                   future=fut)
        return self._dispatch_device_solo(req, storage, t0, backend, tr)

    def _dispatch_device_solo(self, req: CopRequest, storage, t0: int,
                              backend: str, tr) -> "CopDeferred":
        """The direct device dispatch (endpoint.py:458-517): launch, then
        hand the fetch to the completion pool; a device fault degrades to
        the host unless the request forced the device."""
        from ..device.deferred import DeferredResult
        runner = self._device_runner
        try:
            if self._supports_deferred():
                out = runner.handle_request(req.dag, storage, deferred=True)
            else:
                out = runner.handle_request(req.dag, storage)
        except DEVICE_FAULTS:
            # a device fault degrades the request to the host pipeline; a
            # forced device request surfaces it (a kernel that fails to
            # build or launch is not one: it raises)
            if req.force_backend == "device":
                raise
            self.note_degrade("dispatch")
            tracker.label("backend", "host")
            tracker.label("degraded", "dispatch")
            return CopDeferred(self, req, storage, t0, "host", tr,
                               result=self._host_exec(req, storage))
        if not isinstance(out, DeferredResult):
            return CopDeferred(self, req, storage, t0, backend, tr,
                               result=out)

        def fetch():
            tok = tracker.adopt(tr)
            try:
                return out.result(), out.degraded
            finally:
                tracker.uninstall(tok)

        fut = self._completion().submit(
            fetch, priority="high" if out.small else "normal")
        return CopDeferred(self, req, storage, t0, backend, tr, future=fut)

    def _host_exec(self, req: CopRequest, storage):
        from ..executors.runner import BatchExecutorsRunner
        with tracker.phase("host_exec"):
            return BatchExecutorsRunner(req.dag, storage).handle_request()

    def _finish_response(self, d: "CopDeferred", result,
                         backend: str) -> CopResponse:
        """The completion tail (endpoint.py:575)."""
        return CopResponse(result, time.perf_counter_ns() - d.t0, backend,
                           d.tracker)

    def _degrade_at_wait(self, d: "CopDeferred", reason: str):
        """A device fault at the fetch → the host pipeline's answer
        (endpoint.py:602)."""
        self.note_degrade(reason)
        tok = tracker.adopt(d.tracker)
        try:
            tracker.label("backend", "host")
            tracker.label("degraded", reason)
            return self._host_exec(d.req, d.storage)
        finally:
            tracker.uninstall(tok)

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


class CopDeferred:
    """An in-flight coprocessor request (``Endpoint.handle_async``,
    endpoint.py:639-686).

    ``wait()`` joins the deferred device fetch (or returns the inline host
    answer), applies the endpoint's degrade policy to a device fault at
    the fetch, and memoizes: idempotent and thread-safe."""

    __slots__ = ("_endpoint", "req", "storage", "t0", "tracker", "_backend",
                 "_result", "_future", "_mu", "_resp")

    def __init__(self, endpoint, req, storage, t0, backend, tr,
                 result=None, future=None):
        self._endpoint = endpoint
        self.req = req
        self.storage = storage
        self.t0 = t0
        self.tracker = tr
        self._backend = backend
        self._result = result
        self._future = future       # of (result, degraded)
        self._mu = threading.Lock()
        self._resp = None

    @property
    def resolved(self) -> bool:
        """Answered at dispatch: no fetch to wait for."""
        return self._future is None

    def wait(self) -> CopResponse:
        with self._mu:
            if self._resp is None:
                backend, result = self._backend, self._result
                if result is None:
                    forced = self.req.force_backend == "device"
                    try:
                        result, degraded = self._future.result()
                    except DEVICE_FAULTS:
                        if forced:
                            raise
                        result = self._endpoint._degrade_at_wait(self,
                                                                 "fetch")
                        backend = "host"
                    else:
                        if degraded is not None:
                            # the runner answered on the host after a
                            # device fault in the fetch
                            if forced:
                                raise DeviceUnavailable(
                                    f"the device {degraded} failed and the "
                                    f"request forced the device")
                            self._endpoint.note_degrade(degraded)
                            self.tracker.label("backend", "host")
                            self.tracker.label("degraded", degraded)
                            backend = "host"
                self._resp = self._endpoint._finish_response(
                    self, result, backend)
            return self._resp
