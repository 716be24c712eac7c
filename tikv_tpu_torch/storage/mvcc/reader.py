"""MVCC readers: point get + range scan resolving lock/write/default CFs.

A copy of the JAX package's ``storage/mvcc/reader.py``. Reference:
src/storage/mvcc/reader/point_getter.rs (PointGetter::get — CF_LOCK
check → CF_WRITE seek(key, read_ts) → CF_DEFAULT fetch), reader.rs
(MvccReader: load_lock, seek_write, get_txn_commit_record) and
reader/scanner/forward.rs / backward.rs (lock-aware version-resolving
range scans).
"""

from __future__ import annotations

from typing import Callable, Optional

from ...engine.traits import CF_DEFAULT, CF_LOCK, CF_WRITE, Snapshot
from ..txn_types import (
    Lock,
    LockType,
    TS_MAX,
    Write,
    WriteType,
    append_ts,
    encode_key,
    split_ts,
)
from .errors import KeyIsLocked

# seeking past every version of an encoded key: versions are key+8 bytes,
# and memcomparable keys are prefix-free, so key+9×0xff sorts after all of
# them and before the next distinct key
_PAST_VERSIONS = b"\xff" * 9


def check_lock_conflict(lock: Lock, key: bytes, read_ts: int,
                        bypass_locks=()) -> None:
    """SI visibility check.  Reference: lock.rs check_ts_conflict —
    LOCK/PESSIMISTIC locks never block reads; a PUT/DELETE lock blocks
    reads at ts >= lock.start_ts (TS_MAX reads block too, unless the
    reader resolves it)."""
    if lock.lock_type in (LockType.LOCK, LockType.PESSIMISTIC):
        return
    if lock.start_ts > read_ts:
        return
    if lock.start_ts in bypass_locks:
        return
    raise KeyIsLocked(key, lock)


class MvccReader:
    """Reads one snapshot's Percolator state."""

    def __init__(self, snapshot: Snapshot):
        self._snap = snapshot

    # -- locks --

    def load_lock(self, key: bytes) -> Optional[Lock]:
        raw = self._snap.get_value_cf(CF_LOCK, encode_key(key))
        return Lock.from_bytes(raw) if raw is not None else None

    def scan_locks(self, start: Optional[bytes], end: Optional[bytes],
                   filter_fn: Optional[Callable[[Lock], bool]] = None,
                   limit: int = 0) -> list[tuple[bytes, Lock]]:
        """Reference: reader.rs scan_locks."""
        lower = encode_key(start) if start else None
        upper = encode_key(end) if end else None
        it = self._snap.iterator_cf(CF_LOCK, lower, upper)
        out: list[tuple[bytes, Lock]] = []
        ok = it.seek_to_first()
        while ok:
            lock = Lock.from_bytes(it.value())
            if filter_fn is None or filter_fn(lock):
                from ..txn_types import decode_key
                out.append((decode_key(it.key()), lock))
                if limit and len(out) >= limit:
                    break
            ok = it.next()
        return out

    # -- write records --

    def seek_write(self, key: bytes, ts: int) -> Optional[tuple[int, Write]]:
        """Newest write with commit_ts <= ts.  Reference: reader.rs
        seek_write."""
        enc = encode_key(key)
        it = self._snap.iterator_cf(CF_WRITE, enc, enc + _PAST_VERSIONS)
        if not it.seek(append_ts(enc, ts)):
            return None
        k, commit_ts = split_ts(it.key())
        if k != enc:
            return None
        return commit_ts, Write.from_bytes(it.value())

    def get_txn_commit_record(self, key: bytes, start_ts: int):
        """Find how txn ``start_ts`` ended on ``key``.

        Reference: reader.rs get_txn_commit_record.  Returns one of
        ("committed", commit_ts, Write) | ("rolled_back", ts, Write) |
        ("none", None, None).  Commit_ts of a write >= its start_ts, so
        only versions with commit_ts >= start_ts need examining.
        """
        enc = encode_key(key)
        it = self._snap.iterator_cf(CF_WRITE, enc, enc + _PAST_VERSIONS)
        ok = it.seek(enc)       # newest first (higher ts sorts first)
        while ok:
            k, commit_ts = split_ts(it.key())
            if k != enc or commit_ts < start_ts:
                break
            w = Write.from_bytes(it.value())
            if w.start_ts == start_ts:
                if w.write_type is WriteType.ROLLBACK:
                    return ("rolled_back", commit_ts, w)
                return ("committed", commit_ts, w)
            if commit_ts == start_ts and w.has_overlapped_rollback:
                return ("rolled_back", commit_ts, w)
            ok = it.next()
        return ("none", None, None)

    # -- values --

    def load_data(self, key: bytes, write: Write) -> Optional[bytes]:
        """Materialize a PUT's value (write.rs: short value else default
        CF at (key, start_ts))."""
        if write.write_type is not WriteType.PUT:
            return None
        if write.short_value is not None:
            return write.short_value
        enc = append_ts(encode_key(key), write.start_ts)
        v = self._snap.get_value_cf(CF_DEFAULT, enc)
        assert v is not None, f"default CF missing for {key!r}@{write.start_ts}"
        return v

    # -- point get (the kv_get path, SURVEY.md §3.3) --

    def get(self, key: bytes, read_ts: int, bypass_locks=()) -> Optional[bytes]:
        lock = self.load_lock(key)
        if lock is not None:
            check_lock_conflict(lock, key, read_ts, bypass_locks)
        ts = read_ts
        while True:
            found = self.seek_write(key, ts)
            if found is None:
                return None
            commit_ts, write = found
            if write.write_type is WriteType.PUT:
                return self.load_data(key, write)
            if write.write_type is WriteType.DELETE:
                return None
            # LOCK / ROLLBACK: look at the next older version
            ts = commit_ts - 1
            if ts < 0:
                return None

    # -- range scan (feeds coprocessor snapshots + Storage::scan) --

    def scan(self, start: Optional[bytes], end: Optional[bytes],
             limit: int, read_ts: int, desc: bool = False,
             bypass_locks=(), ignore_locks: bool = False) -> list[tuple[bytes, bytes]]:
        """Resolve up to ``limit`` visible (user_key, value) pairs.

        Reference: reader/scanner/forward.rs (ForwardKvScanner) and
        backward.rs; SI isolation — a conflicting lock on any key reached
        before the limit is satisfied raises KeyIsLocked (including keys
        with no committed version yet).  ``ignore_locks`` reads only
        committed data, skipping conflict checks entirely — the CDC
        initializer's mode (its resolver tracks the pending locks, so
        resolved-ts stays below them and no downstream finalizes early).
        """
        from ..txn_types import decode_key
        lower = encode_key(start) if start else None
        upper = encode_key(end) if end else None

        # locks are sparse: collect them once, check as keys are passed
        locks: list[tuple[bytes, Lock]] = []
        lit = self._snap.iterator_cf(CF_LOCK, lower, upper)
        ok = lit.seek_to_first()
        while ok:
            locks.append((lit.key(), Lock.from_bytes(lit.value())))
            ok = lit.next()
        if desc:
            locks.reverse()
        lock_i = 0

        def check_locks_through(enc: Optional[bytes]):
            nonlocal lock_i
            if ignore_locks:
                return
            while lock_i < len(locks):
                lk_enc, lock = locks[lock_i]
                if enc is not None:
                    passed = (lk_enc >= enc) if desc else (lk_enc <= enc)
                    if not passed:
                        return
                check_lock_conflict(lock, decode_key(lk_enc), read_ts,
                                    bypass_locks)
                lock_i += 1

        out: list[tuple[bytes, bytes]] = []
        it = self._snap.iterator_cf(CF_WRITE, lower, upper)
        ok = it.seek_to_last() if desc else it.seek_to_first()
        while ok and len(out) < limit:
            enc, _ = split_ts(it.key())
            check_locks_through(enc)
            value = self._resolve(enc, read_ts)
            if value is not None:
                out.append((decode_key(enc), value))
            if desc:
                # versions of enc sort after enc itself; step before them
                ok = it.seek_for_prev(enc)
            else:
                ok = it.seek(enc + _PAST_VERSIONS)
        if len(out) < limit:
            check_locks_through(None)   # locks on keys with no data yet
        return out

    def _resolve(self, enc: bytes, read_ts: int) -> Optional[bytes]:
        """Visible value of one encoded user key at read_ts (no locks)."""
        sub = self._snap.iterator_cf(CF_WRITE, enc, enc + _PAST_VERSIONS)
        ok = sub.seek(append_ts(enc, read_ts))
        while ok:
            k, _commit_ts = split_ts(sub.key())
            if k != enc:
                return None
            w = Write.from_bytes(sub.value())
            if w.write_type is WriteType.PUT:
                from ..txn_types import decode_key
                return self.load_data(decode_key(enc), w)
            if w.write_type is WriteType.DELETE:
                return None
            ok = sub.next()
        return None
