"""Transaction commands — one class per scheduler command.

A copy of the JAX package's ``storage/txn/commands.py``.

Reference: src/storage/txn/commands/ (command pattern, one file per
command: prewrite.rs, commit.rs, rollback.rs, cleanup.rs,
check_txn_status.rs, resolve_lock.rs, acquire_pessimistic_lock.rs,
pessimistic_rollback.rs, txn_heart_beat.rs, resolve_lock_lite.rs).
Each command implements ``process_write(txn, reader) -> result`` over the
pure actions (actions.py); the scheduler owns latching + snapshot + flush.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..mvcc.errors import KeyIsLocked
from ..mvcc.reader import MvccReader
from ..mvcc.txn import MvccTxn
from ..txn_types import Lock, LockType
from . import actions
from .actions import Mutation


class Command:
    # subclasses are dataclasses declaring start_ts; no default here (a
    # class-level default would leak into subclass dataclass fields)
    start_ts: int

    def write_keys(self) -> list[bytes]:
        """Keys to latch (latch.rs: commands declare their key set)."""
        raise NotImplementedError

    def process_write(self, txn: MvccTxn, reader: MvccReader):
        raise NotImplementedError


@dataclass
class Prewrite(Command):
    """commands/prewrite.rs (incl. the async-commit and 1PC modes).

    Async commit: min_commit_ts is finalized from the concurrency
    manager's max_ts (the scheduler injects ``_cm`` and publishes the
    memory locks around this command); the primary's lock carries the
    secondary keys.  1PC additionally skips the lock phase, committing
    at that same ts when the whole txn fits one region.
    """

    mutations: Sequence[Mutation]
    primary: bytes
    start_ts: int
    lock_ttl: int = 3000
    txn_size: int = 0
    min_commit_ts: int = 0
    # per-mutation: True if the key holds this txn's pessimistic lock
    is_pessimistic_lock: Sequence[bool] = ()
    use_async_commit: bool = False
    secondaries: Sequence[bytes] = ()
    try_one_pc: bool = False
    _cm: object = field(default=None, repr=False, compare=False)

    def write_keys(self):
        return [m.key for m in self.mutations]

    def process_write(self, txn, reader):
        flags = self.is_pessimistic_lock or [False] * len(self.mutations)
        assert len(flags) == len(self.mutations), \
            "is_pessimistic_lock must match mutations 1:1"
        final_min_commit = self.min_commit_ts
        one_pc_ts = 0
        if self.use_async_commit or self.try_one_pc:
            assert self._cm is not None, \
                "async commit requires the concurrency manager"
            final_min_commit = max(self._cm.max_ts + 1,
                                   self.start_ts + 1,
                                   self.min_commit_ts)
            if self.try_one_pc:
                one_pc_ts = final_min_commit
        for m, pess in zip(self.mutations, flags):
            actions.prewrite(
                txn, reader, m, self.primary, self.lock_ttl,
                self.txn_size, final_min_commit,
                is_pessimistic_lock=pess,
                use_async_commit=self.use_async_commit,
                secondaries=(tuple(self.secondaries)
                             if m.key == self.primary else ()),
                one_pc_commit_ts=one_pc_ts)
        return {"min_commit_ts": final_min_commit
                if (self.use_async_commit or self.try_one_pc)
                else self.min_commit_ts,
                "one_pc_commit_ts": one_pc_ts}


@dataclass
class Commit(Command):
    """commands/commit.rs"""

    keys: Sequence[bytes]
    start_ts: int
    commit_ts: int

    def write_keys(self):
        return list(self.keys)

    def process_write(self, txn, reader):
        for k in self.keys:
            actions.commit(txn, reader, k, self.commit_ts)
        return {"commit_ts": self.commit_ts}


@dataclass
class Rollback(Command):
    """commands/rollback.rs"""

    keys: Sequence[bytes]
    start_ts: int

    def write_keys(self):
        return list(self.keys)

    def process_write(self, txn, reader):
        for k in self.keys:
            actions.rollback(txn, reader, k)
        return {}


@dataclass
class Cleanup(Command):
    """commands/cleanup.rs — rollback a single (expired) lock."""

    key: bytes
    start_ts: int
    current_ts: int

    def write_keys(self):
        return [self.key]

    def process_write(self, txn, reader):
        actions.cleanup(txn, reader, self.key, self.current_ts)
        return {}


@dataclass
class CheckTxnStatus(Command):
    """commands/check_txn_status.rs"""

    primary: bytes
    lock_ts: int
    caller_start_ts: int
    current_ts: int

    @property
    def start_ts(self):
        return self.lock_ts

    def write_keys(self):
        return [self.primary]

    def process_write(self, txn, reader):
        status, ts = actions.check_txn_status(
            txn, reader, self.primary, self.current_ts,
            self.caller_start_ts)
        out = {"status": status, "ts": ts}
        if status == "locked":
            lock = reader.load_lock(self.primary)
            if lock is not None and lock.use_async_commit:
                # the caller resolves via CheckSecondaryLocks
                out["use_async_commit"] = True
                out["secondaries"] = list(lock.secondaries)
                out["min_commit_ts"] = lock.min_commit_ts
        return out


@dataclass
class CheckSecondaryLocks(Command):
    """commands/check_secondary_locks.rs — the async-commit resolution
    probe: for each secondary, report its lock (still pending) or its
    final state; keys with neither get a protective rollback so a late
    prewrite cannot resurrect the txn."""

    keys: Sequence[bytes]
    start_ts: int

    def write_keys(self):
        return list(self.keys)

    def process_write(self, txn, reader):
        min_commit_ts = 0
        for k in self.keys:
            lock = reader.load_lock(k)
            if lock is not None and lock.start_ts == self.start_ts:
                if lock.lock_type is LockType.PESSIMISTIC:
                    # an unprewritten pessimistic lock can't commit:
                    # drop it and mark rolled back (check_secondary_locks.rs)
                    txn.unlock_key(k)
                    actions._put_rollback(txn, reader, k)
                    return {"status": "rolled_back", "commit_ts": 0}
                min_commit_ts = max(min_commit_ts, lock.min_commit_ts)
                continue
            status, ts, _w = reader.get_txn_commit_record(k, self.start_ts)
            if status == "committed":
                return {"status": "committed", "commit_ts": ts}
            if status == "rolled_back":
                return {"status": "rolled_back", "commit_ts": 0}
            # no lock, no record: protective rollback
            actions._put_rollback(txn, reader, k)
            return {"status": "rolled_back", "commit_ts": 0}
        return {"status": "locked", "commit_ts": 0,
                "min_commit_ts": min_commit_ts}


@dataclass
class ResolveLockLite(Command):
    """commands/resolve_lock_lite.rs — commit/rollback a known key set of
    one txn (commit_ts == 0 → rollback)."""

    start_ts: int
    commit_ts: int
    keys: Sequence[bytes] = ()

    def write_keys(self):
        return list(self.keys)

    def process_write(self, txn, reader):
        for k in self.keys:
            if self.commit_ts:
                actions.commit(txn, reader, k, self.commit_ts)
            else:
                actions.rollback(txn, reader, k)
        return {}


@dataclass
class ResolveLock(Command):
    """commands/resolve_lock.rs — scan this txn's locks in range and
    commit/rollback them (the resolver's bulk path)."""

    start_ts: int
    commit_ts: int
    start_key: Optional[bytes] = None
    end_key: Optional[bytes] = None
    scan_limit: int = 256

    _found: list = field(default_factory=list, repr=False)

    def write_keys(self):
        return [k for k, _ in self._found]

    def prepare(self, reader: MvccReader):
        """Scan phase (runs before latching; reference splits the same
        way: read command → write command with the found locks)."""
        self._found = reader.scan_locks(
            self.start_key, self.end_key,
            lambda lock: lock.start_ts == self.start_ts, self.scan_limit)

    def process_write(self, txn, reader):
        for k, _lock in self._found:
            if self.commit_ts:
                actions.commit(txn, reader, k, self.commit_ts)
            else:
                actions.rollback(txn, reader, k)
        return {"resolved": len(self._found),
                "has_more": len(self._found) >= self.scan_limit}


@dataclass
class AcquirePessimisticLock(Command):
    """commands/acquire_pessimistic_lock.rs"""

    keys: Sequence[bytes]
    primary: bytes
    start_ts: int
    for_update_ts: int
    lock_ttl: int = 3000
    return_values: bool = False
    # > 0: on conflict, park in the waiter manager (with deadlock
    # detection) instead of failing — lock_manager/waiter_manager.rs
    wait_timeout_s: float = 0.0

    def write_keys(self):
        return list(self.keys)

    def process_write(self, txn, reader):
        values = []
        for k in self.keys:
            v = actions.acquire_pessimistic_lock(
                txn, reader, k, self.primary, self.for_update_ts,
                self.lock_ttl)
            values.append(v)
        return {"values": values if self.return_values else None}


@dataclass
class PessimisticRollback(Command):
    """commands/pessimistic_rollback.rs — drop our pessimistic locks
    (no rollback record: the txn may still prewrite elsewhere)."""

    keys: Sequence[bytes]
    start_ts: int
    for_update_ts: int

    def write_keys(self):
        return list(self.keys)

    def process_write(self, txn, reader):
        for k in self.keys:
            lock = reader.load_lock(k)
            if lock is not None and lock.start_ts == self.start_ts and \
                    lock.lock_type is LockType.PESSIMISTIC and \
                    lock.for_update_ts <= self.for_update_ts:
                txn.unlock_key(k)
        return {}


@dataclass
class TxnHeartBeat(Command):
    """commands/txn_heart_beat.rs — extend the primary lock's TTL."""

    primary: bytes
    start_ts: int
    advise_ttl: int

    def write_keys(self):
        return [self.primary]

    def process_write(self, txn, reader):
        lock = reader.load_lock(self.primary)
        if lock is None or lock.start_ts != self.start_ts:
            from ..mvcc.errors import TxnLockNotFound
            raise TxnLockNotFound(self.primary, self.start_ts)
        if self.advise_ttl > lock.ttl:
            lock.ttl = self.advise_ttl
            txn.put_lock(self.primary, lock)
        return {"ttl": lock.ttl}
