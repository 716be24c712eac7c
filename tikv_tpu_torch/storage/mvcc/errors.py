"""MVCC error taxonomy.

A copy of the JAX package's ``storage/mvcc/errors.py``. Reference:
src/storage/mvcc/mod.rs ErrorInner variants (KeyIsLocked, WriteConflict,
TxnLockNotFound, Committed, AlreadyExist, PessimisticLockRolledBack) —
stable error identities the txn scheduler and clients dispatch on.
"""

from __future__ import annotations


class MvccError(Exception):
    pass


class KeyIsLocked(MvccError):
    def __init__(self, key: bytes, lock):
        super().__init__(f"key {key!r} is locked by txn {lock.start_ts}")
        self.key = key
        self.lock = lock


class WriteConflict(MvccError):
    """reason: "optimistic" | "self_rolled_back" | "pessimistic"
    (reference: mvcc/mod.rs WriteConflictReason)."""

    def __init__(self, key: bytes, start_ts: int, conflict_start_ts: int,
                 conflict_commit_ts: int, reason: str = "optimistic"):
        super().__init__(
            f"write conflict on {key!r}: txn {start_ts} vs committed "
            f"[{conflict_start_ts}, {conflict_commit_ts}] ({reason})")
        self.key = key
        self.start_ts = start_ts
        self.conflict_start_ts = conflict_start_ts
        self.conflict_commit_ts = conflict_commit_ts
        self.reason = reason


class TxnLockNotFound(MvccError):
    def __init__(self, key: bytes, start_ts: int):
        super().__init__(f"lock of txn {start_ts} not found on {key!r}")
        self.key = key
        self.start_ts = start_ts


class Committed(MvccError):
    def __init__(self, key: bytes, start_ts: int, commit_ts: int):
        super().__init__(f"txn {start_ts} already committed @{commit_ts}")
        self.key = key
        self.start_ts = start_ts
        self.commit_ts = commit_ts


class AlreadyExist(MvccError):
    def __init__(self, key: bytes):
        super().__init__(f"key {key!r} already exists")
        self.key = key


class PessimisticLockRolledBack(MvccError):
    def __init__(self, key: bytes, start_ts: int):
        super().__init__(
            f"pessimistic lock of txn {start_ts} on {key!r} rolled back")
        self.key = key
        self.start_ts = start_ts
