"""Txn command scheduler — latch, snapshot, execute, flush.

A copy of the JAX package's ``storage/txn/scheduler.py``.  With
``lock_manager=None`` (the default here; the node passes a
``storage.lock_manager.LockManager``) no pessimistic waiter parks, so a
conflicting pessimistic lock raises at once, as a request with no wait
timeout does.  Reference: src/storage/txn/scheduler.rs — ``TxnScheduler``: every write
command acquires latches on its keys (:396), takes an engine snapshot
(:1174), runs ``process_write`` (:1252) buffering into MvccTxn, flushes
through ``Engine::async_write``, then releases latches (:544) waking
queued commands.  The Python surface is synchronous per command but safe
for concurrent caller threads (the reference runs commands on a worker
pool; conflicting commands serialize on latches either way).
"""

from __future__ import annotations

from typing import Optional

from ...kv.engine import Engine, SnapContext, WriteData
from ..mvcc.reader import MvccReader
from ..mvcc.txn import MvccTxn
from .commands import Command, ResolveLock
from .latch import Latches


class TxnScheduler:
    def __init__(self, engine: Engine, latches: Optional[Latches] = None,
                 concurrency_manager=None, lock_manager=None):
        from ..concurrency_manager import ConcurrencyManager
        self._engine = engine
        self._latches = latches if latches is not None else Latches()
        self.cm = concurrency_manager if concurrency_manager is not None \
            else ConcurrencyManager()
        self.lock_manager = lock_manager

    def run(self, cmd: Command, ctx: Optional[SnapContext] = None):
        import time as _time

        from ..mvcc.errors import KeyIsLocked
        from .commands import AcquirePessimisticLock
        wait_budget = getattr(cmd, "wait_timeout_s", 0.0)
        deadline = _time.monotonic() + wait_budget if wait_budget else None
        while True:
            try:
                return self._run_once(cmd, ctx)
            except KeyIsLocked as e:
                if not isinstance(cmd, AcquirePessimisticLock) or \
                        deadline is None or self.lock_manager is None:
                    raise
                # park OUTSIDE the latches (already released): waiting
                # while latched would deadlock against the holder's
                # commit (scheduler.rs hands conflicts to the waiter
                # manager the same way)
                remain = deadline - _time.monotonic()
                if remain <= 0:
                    raise
                woken = self.lock_manager.wait_for(
                    cmd.start_ts, e.key, e.lock.start_ts,
                    min(remain, 1.0))
                if not woken and _time.monotonic() >= deadline:
                    raise

    def _run_once(self, cmd: Command, ctx: Optional[SnapContext]):
        if ctx is None:
            from ..txn_types import encode_key
            keys = cmd.write_keys()
            ctx = SnapContext(key_hint=encode_key(keys[0]) if keys else b"")
        if isinstance(cmd, ResolveLock):
            # read phase before latching (resolve_lock.rs scan → write)
            cmd.prepare(MvccReader(self._engine.snapshot(ctx)))
        from ...utils.failpoint import fail_point
        from .commands import Commit, Prewrite
        fail_point("txn::before_latch")
        cid = self._latches.gen_cid()
        slots = self._latches.acquire(cid, cmd.write_keys())
        fail_point("txn::after_latch")
        mem_keys = ()
        released: list = []
        try:
            fail_point("txn::before_process")
            if isinstance(cmd, Commit):
                # the commit boundary: a crash here leaves prewrite
                # locks for the resolver (the 2PC indeterminate window)
                fail_point("txn::before_commit")
            if isinstance(cmd, Prewrite) and \
                    (cmd.use_async_commit or cmd.try_one_pc):
                # async commit step (a): publish memory locks BEFORE
                # reading max_ts so no concurrent read can slip between
                # the min_commit_ts decision and the engine lock
                # (concurrency_manager/src/lib.rs).  The memory lock
                # carries the real TTL so a blocked reader backs off
                # instead of instantly resolving an "expired" lock.
                from ..txn_types import Lock, LockType
                cmd._cm = self.cm
                mem_keys = tuple(m.key for m in cmd.mutations)
                self.cm.lock_keys(
                    mem_keys,
                    [Lock(LockType.PUT, cmd.primary, cmd.start_ts,
                          ttl=cmd.lock_ttl) for _ in mem_keys])
            snapshot = self._engine.snapshot(ctx)
            reader = MvccReader(snapshot)
            txn = MvccTxn(cmd.start_ts)
            result = cmd.process_write(txn, reader)
            fail_point("txn::before_engine_write")
            if not txn.is_empty():
                self._engine.write(ctx, WriteData.from_txn(txn))
            fail_point("txn::after_engine_write")
            released = txn.released_keys
            return result
        finally:
            fail_point("txn::before_release_latch")
            if mem_keys:
                self.cm.unlock_keys(mem_keys)
            self._latches.release(cid, slots)
            if released and self.lock_manager is not None:
                # AFTER latch release: any command that removed engine
                # locks (commit/rollback/resolve/1PC/ttl-expiry) wakes
                # parked pessimistic waiters; the detector clean_up may
                # be a remote RPC and must never run latched
                self.lock_manager.on_release(cmd.start_ts, released)
