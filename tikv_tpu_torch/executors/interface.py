"""Executor interfaces of the host pipeline.

Reference: tidb_query_executors/src/interface.rs — ``BatchExecutor``
(:21): ``schema()``, ``next_batch(scan_rows) -> BatchExecuteResult``
(columns + is_drained), and the exec summary of each executor (:45).
Executors emit already-filtered batches (logical rows folded into the
batch).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Protocol

from ..datatype import ColumnBatch, FieldType


@dataclass
class ExecSummary:
    """Per-executor summary (tipb ExecutorExecutionSummary): rows
    produced, ``next_batch`` calls, wall time."""

    num_produced_rows: int = 0
    num_iterations: int = 0
    time_processed_ns: int = 0

    def record(self, rows: int, elapsed_ns: int):
        self.num_produced_rows += rows
        self.num_iterations += 1
        self.time_processed_ns += elapsed_ns


@dataclass
class BatchExecuteResult:
    batch: ColumnBatch
    is_drained: bool
    warnings: list = field(default_factory=list)


class BatchExecutor(Protocol):
    summary: ExecSummary

    @property
    def schema(self) -> list[FieldType]: ...

    def next_batch(self, scan_rows: int) -> BatchExecuteResult: ...


class TimedExecutor:
    """Base class: the exec-summary timing around ``next_batch``."""

    def __init__(self):
        self.summary = ExecSummary()

    @property
    def schema(self) -> list[FieldType]:
        raise NotImplementedError

    def _next_batch(self, scan_rows: int) -> BatchExecuteResult:
        raise NotImplementedError

    def next_batch(self, scan_rows: int) -> BatchExecuteResult:
        t0 = time.perf_counter_ns()
        r = self._next_batch(scan_rows)
        self.summary.record(r.batch.num_rows, time.perf_counter_ns() - t0)
        return r
