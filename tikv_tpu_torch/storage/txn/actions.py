"""Pure Percolator actions over (MvccTxn, MvccReader).

A copy of the JAX package's ``storage/txn/actions.py``.

Reference: src/storage/txn/actions/ — prewrite.rs:36 (prewrite),
commit.rs (commit), cleanup.rs (rollback path), check_txn_status.rs,
acquire_pessimistic_lock.rs.  Each action reads through MvccReader and
buffers effects in MvccTxn; the scheduler flushes the buffer atomically.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..mvcc.errors import (
    AlreadyExist,
    Committed,
    KeyIsLocked,
    PessimisticLockRolledBack,
    TxnLockNotFound,
    WriteConflict,
)
from ..mvcc.reader import MvccReader
from ..mvcc.txn import MvccTxn
from ..txn_types import (
    Lock,
    LockType,
    SHORT_VALUE_MAX_LEN,
    TS_MAX,
    Write,
    WriteType,
    ts_physical,
)


@dataclass(frozen=True)
class Mutation:
    """One prewrite mutation.  op: put | delete | lock | insert.

    ``insert`` is put + must-not-exist (reference: Mutation::Insert,
    prewrite.rs check_for_newer_version with should_not_exist)."""

    op: str
    key: bytes
    value: Optional[bytes] = None


def _lock_type_of(m: Mutation) -> LockType:
    return {"put": LockType.PUT, "insert": LockType.PUT,
            "delete": LockType.DELETE, "lock": LockType.LOCK}[m.op]


def prewrite(txn: MvccTxn, reader: MvccReader, m: Mutation, primary: bytes,
             lock_ttl: int = 3000, txn_size: int = 0,
             min_commit_ts: int = 0,
             is_pessimistic_lock: bool = False,
             use_async_commit: bool = False,
             secondaries: tuple = (),
             one_pc_commit_ts: int = 0) -> None:
    """Reference: actions/prewrite.rs:36.

    Optimistic: conflict-check against newer committed writes, then lock.
    Pessimistic (``is_pessimistic_lock``): the key must already hold this
    txn's pessimistic lock; convert it in place (no conflict check — it
    happened at acquire time).
    Async commit (``use_async_commit``): the lock carries min_commit_ts
    (computed from the concurrency manager's max_ts by the command) and,
    on the primary, the secondary key list.
    1PC (``one_pc_commit_ts``): skip the lock entirely — write the
    commit record at that ts (prewrite.rs one_pc path).
    """
    start_ts = txn.start_ts
    lock = reader.load_lock(m.key)
    if lock is not None:
        if lock.start_ts != start_ts:
            raise KeyIsLocked(m.key, lock)
        if lock.lock_type is not LockType.PESSIMISTIC:
            return      # duplicate prewrite: idempotent (prewrite.rs)
        # fall through: convert pessimistic lock below
    elif is_pessimistic_lock:
        # lock lost (e.g. rolled back by a resolver): reject
        raise PessimisticLockRolledBack(m.key, start_ts)

    if lock is None:        # optimistic path checks for newer versions
        found = reader.seek_write(m.key, TS_MAX)
        if found is not None:
            commit_ts, write = found
            if commit_ts >= start_ts:
                reason = "self_rolled_back" if (
                    write.start_ts == start_ts and
                    write.write_type is WriteType.ROLLBACK) else "optimistic"
                raise WriteConflict(m.key, start_ts, write.start_ts,
                                    commit_ts, reason)
            if m.op == "insert" and _key_exists(reader, m.key, commit_ts,
                                                write):
                raise AlreadyExist(m.key)
    elif m.op == "insert":
        found = reader.seek_write(m.key, TS_MAX)
        if found is not None and _key_exists(reader, m.key, *found):
            raise AlreadyExist(m.key)

    short_value = None
    if m.value is not None and len(m.value) <= SHORT_VALUE_MAX_LEN:
        short_value = m.value

    if one_pc_commit_ts:
        # 1PC: conflict checks passed; commit directly, no lock phase
        if lock is not None:
            txn.unlock_key(m.key)   # converted pessimistic lock
        wt = {LockType.PUT: WriteType.PUT,
              LockType.DELETE: WriteType.DELETE,
              LockType.LOCK: WriteType.LOCK}[_lock_type_of(m)]
        txn.put_write(m.key, one_pc_commit_ts,
                      Write(wt, start_ts, short_value))
        if m.value is not None and short_value is None:
            txn.put_value(m.key, start_ts, m.value)
        return

    new_lock = Lock(_lock_type_of(m), primary, start_ts, lock_ttl,
                    short_value,
                    for_update_ts=lock.for_update_ts if lock else 0,
                    txn_size=txn_size, min_commit_ts=min_commit_ts,
                    use_async_commit=use_async_commit,
                    secondaries=tuple(secondaries))
    txn.put_lock(m.key, new_lock)
    if m.value is not None and short_value is None:
        txn.put_value(m.key, start_ts, m.value)


def _key_exists(reader: MvccReader, key: bytes, commit_ts: int,
                write: Write) -> bool:
    """Is there a visible value at/under commit_ts? (insert check)"""
    while True:
        if write.write_type is WriteType.PUT:
            return True
        if write.write_type is WriteType.DELETE:
            return False
        found = reader.seek_write(key, commit_ts - 1)
        if found is None:
            return False
        commit_ts, write = found


def commit(txn: MvccTxn, reader: MvccReader, key: bytes,
           commit_ts: int) -> Optional[Lock]:
    """Reference: actions/commit.rs — move lock → write record."""
    start_ts = txn.start_ts
    lock = reader.load_lock(key)
    if lock is None or lock.start_ts != start_ts:
        status, ts, _w = reader.get_txn_commit_record(key, start_ts)
        if status == "committed":
            return None     # idempotent re-commit
        raise TxnLockNotFound(key, start_ts)
    if lock.lock_type is LockType.PESSIMISTIC:
        # committing an un-prewritten pessimistic lock is a protocol error
        raise TxnLockNotFound(key, start_ts)
    assert commit_ts > start_ts, (start_ts, commit_ts)
    wt = {LockType.PUT: WriteType.PUT, LockType.DELETE: WriteType.DELETE,
          LockType.LOCK: WriteType.LOCK}[lock.lock_type]
    txn.put_write(key, commit_ts, Write(wt, start_ts, lock.short_value))
    txn.unlock_key(key)
    return lock


def rollback(txn: MvccTxn, reader: MvccReader, key: bytes,
             protect: bool = True) -> None:
    """Reference: actions/cleanup.rs rollback_lock + check_txn_status
    rollback path.  Writes a ROLLBACK marker at start_ts so a late
    prewrite of the same txn conflicts."""
    start_ts = txn.start_ts
    lock = reader.load_lock(key)
    if lock is not None and lock.start_ts == start_ts:
        if lock.short_value is None and lock.lock_type is LockType.PUT:
            txn.delete_value(key, start_ts)
        txn.unlock_key(key)
        _put_rollback(txn, reader, key)
        return
    status, ts, _w = reader.get_txn_commit_record(key, start_ts)
    if status == "committed":
        raise Committed(key, start_ts, ts)
    if status == "rolled_back":
        return      # idempotent
    _put_rollback(txn, reader, key)     # rollback before prewrite arrives


def _put_rollback(txn: MvccTxn, reader: MvccReader, key: bytes) -> None:
    start_ts = txn.start_ts
    found = reader.seek_write(key, start_ts)
    if found is not None and found[0] == start_ts:
        # a write committed exactly at our start_ts: fold the rollback in
        # (write.rs overlapped rollback)
        commit_ts, w = found
        w.has_overlapped_rollback = True
        txn.put_write(key, commit_ts, w)
        return
    txn.put_write(key, start_ts, Write(WriteType.ROLLBACK, start_ts))


def cleanup(txn: MvccTxn, reader: MvccReader, key: bytes,
            current_ts: int) -> None:
    """Rollback iff the lock is expired (or current_ts == 0 → force).

    Reference: actions/cleanup.rs — used by the resolve path on orphan
    locks."""
    lock = reader.load_lock(key)
    if lock is not None and lock.start_ts == txn.start_ts:
        if current_ts and \
                ts_physical(lock.start_ts) + lock.ttl > ts_physical(current_ts):
            raise KeyIsLocked(key, lock)    # still alive
    rollback(txn, reader, key)


def check_txn_status(txn: MvccTxn, reader: MvccReader, primary: bytes,
                     current_ts: int,
                     caller_start_ts: int = 0) -> tuple[str, int]:
    """Reference: actions/check_txn_status.rs — the resolver's probe on a
    txn's primary key.  Returns (status, ts):
    ("committed", commit_ts) | ("rolled_back", 0) | ("locked", ttl)
    | ("ttl_expired", 0) — ttl_expired also rolls the primary back.
    """
    start_ts = txn.start_ts
    lock = reader.load_lock(primary)
    if lock is not None and lock.start_ts == start_ts:
        if lock.use_async_commit:
            # async-commit fate is decided by the secondaries, never by
            # TTL here (check_txn_status.rs returns the lock info so the
            # caller runs CheckSecondaryLocks)
            return ("locked", lock.ttl)
        if ts_physical(lock.start_ts) + lock.ttl < ts_physical(current_ts):
            rollback(txn, reader, primary)
            return ("ttl_expired", 0)
        if caller_start_ts and lock.min_commit_ts <= caller_start_ts:
            # push min_commit_ts so the reader at caller_start_ts can't be
            # blocked by a later commit (check_txn_status.rs push)
            lock.min_commit_ts = caller_start_ts + 1
            txn.put_lock(primary, lock)
        return ("locked", lock.ttl)
    status, ts, _w = reader.get_txn_commit_record(primary, start_ts)
    if status == "committed":
        return ("committed", ts)
    if status == "rolled_back":
        return ("rolled_back", 0)
    # no lock, no record: roll back so a late prewrite cannot succeed
    _put_rollback(txn, reader, primary)
    return ("rolled_back", 0)


def acquire_pessimistic_lock(txn: MvccTxn, reader: MvccReader, key: bytes,
                             primary: bytes, for_update_ts: int,
                             lock_ttl: int = 3000,
                             should_not_exist: bool = False) -> Optional[bytes]:
    """Reference: actions/acquire_pessimistic_lock.rs.  Returns the
    current value (pessimistic locks read-lock the latest version)."""
    start_ts = txn.start_ts
    lock = reader.load_lock(key)
    if lock is not None:
        if lock.start_ts != start_ts:
            raise KeyIsLocked(key, lock)
        # already ours: refresh for_update_ts if newer
        if for_update_ts > lock.for_update_ts:
            lock.for_update_ts = for_update_ts
            txn.put_lock(key, lock)
        return None
    found = reader.seek_write(key, TS_MAX)
    value = None
    if found is not None:
        commit_ts, write = found
        if commit_ts > for_update_ts:
            raise WriteConflict(key, start_ts, write.start_ts, commit_ts)
        if write.start_ts == start_ts and \
                write.write_type is WriteType.ROLLBACK:
            raise PessimisticLockRolledBack(key, start_ts)
        rec = reader.get_txn_commit_record(key, start_ts)
        if rec[0] == "rolled_back":
            raise PessimisticLockRolledBack(key, start_ts)
        if _key_exists(reader, key, commit_ts, write):
            if should_not_exist:
                raise AlreadyExist(key)
            value = reader.get(key, TS_MAX, bypass_locks=(start_ts,))
    txn.put_lock(key, Lock(LockType.PESSIMISTIC, primary, start_ts,
                           lock_ttl, for_update_ts=for_update_ts))
    return value
