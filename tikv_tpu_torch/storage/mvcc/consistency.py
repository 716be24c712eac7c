"""MVCC cross-CF consistency scan.

A copy of the JAX package's ``storage/mvcc/consistency.py``.

Reference: SURVEY.md §5.2 — the reference enforces these invariants with
its scan-based consistency checker (worker/consistency_check.rs Mvcc
observer) and debug-service `bad-regions`/mvcc checks (src/server/debug.rs
MvccChecker): the Percolator record families in CF_LOCK / CF_WRITE /
CF_DEFAULT must cross-reference exactly.

Invariants checked over a key range:
1. every committed PUT without an inline short value has its payload row
   in CF_DEFAULT at (key, start_ts);
2. every CF_DEFAULT row is referenced by a committed write or by the
   key's current lock (no orphan payloads);
3. commit_ts > start_ts for every committed write;
4. a current lock's start_ts is above every committed commit_ts of that
   key (a lock standing below a committed version could never commit
   without violating snapshot isolation);
5. ROLLBACK/LOCK writes carry no payload.
"""

from __future__ import annotations

from typing import Optional

from ...engine.traits import CF_DEFAULT, CF_LOCK, CF_WRITE
from ..txn_types import Lock, Write, WriteType, split_ts


class MvccInconsistency(Exception):
    def __init__(self, problems: list):
        super().__init__(f"{len(problems)} MVCC inconsistencies: "
                         + "; ".join(problems[:5]))
        self.problems = problems


def _range_iter(snap, cf: str, lower: bytes, upper: Optional[bytes]):
    it = snap.iterator_cf(cf, lower, upper)
    ok = it.seek_to_first()
    while ok:
        yield it.key(), it.value()
        ok = it.next()


def check_mvcc_consistency(snap, lower: bytes = b"x",
                           upper: Optional[bytes] = None,
                           raise_on_problem: bool = False) -> list:
    """Scan [lower, upper) of the txn keyspace on an engine snapshot →
    list of problem strings (empty = consistent)."""
    if upper is None:
        upper = bytes([lower[0] + 1])
    problems: list[str] = []

    # CF_DEFAULT payload index: encoded_key -> {start_ts}
    defaults: dict = {}
    for k, _v in _range_iter(snap, CF_DEFAULT, lower, upper):
        if len(k) <= 8:
            problems.append(f"default key too short: {k!r}")
            continue
        enc, ts = split_ts(k)
        defaults.setdefault(enc, set()).add(ts)

    locks: dict = {}
    for k, v in _range_iter(snap, CF_LOCK, lower, upper):
        try:
            locks[k] = Lock.from_bytes(v)
        except Exception as e:   # noqa: BLE001 — corrupt record IS a finding
            problems.append(f"undecodable lock at {k!r}: {e}")

    referenced: dict = {}
    max_commit: dict = {}
    for k, v in _range_iter(snap, CF_WRITE, lower, upper):
        if len(k) <= 8:
            problems.append(f"write key too short: {k!r}")
            continue
        enc, commit_ts = split_ts(k)
        try:
            w = Write.from_bytes(v)
        except Exception as e:   # noqa: BLE001
            problems.append(f"undecodable write at {k!r}: {e}")
            continue
        if w.write_type in (WriteType.PUT, WriteType.DELETE):
            if commit_ts <= w.start_ts:
                problems.append(
                    f"commit_ts {commit_ts} <= start_ts {w.start_ts} "
                    f"on {enc!r}")
            max_commit[enc] = max(max_commit.get(enc, 0), commit_ts)
        if w.write_type is WriteType.PUT:
            if w.short_value is None:
                if w.start_ts not in defaults.get(enc, ()):
                    problems.append(
                        f"PUT {enc!r}@{commit_ts} missing default row "
                        f"at start_ts {w.start_ts}")
                else:
                    referenced.setdefault(enc, set()).add(w.start_ts)
        elif w.write_type in (WriteType.ROLLBACK, WriteType.LOCK):
            if w.short_value:
                problems.append(
                    f"{w.write_type.name} write with payload on {enc!r}")

    for enc, lock in locks.items():
        if lock.start_ts <= max_commit.get(enc, -1):
            problems.append(
                f"lock at start_ts {lock.start_ts} below committed "
                f"version {max_commit[enc]} on {enc!r}")
        if lock.short_value is None:
            # big-value prewrite: payload must already sit in default
            if lock.lock_type.name in ("PUT",) and \
                    lock.start_ts not in defaults.get(enc, ()):
                problems.append(
                    f"PUT lock on {enc!r} missing default row at "
                    f"start_ts {lock.start_ts}")
        referenced.setdefault(enc, set()).add(lock.start_ts)

    for enc, tss in defaults.items():
        orphan = tss - referenced.get(enc, set())
        for ts in sorted(orphan):
            problems.append(f"orphan default row {enc!r}@{ts}")

    if problems and raise_on_problem:
        raise MvccInconsistency(problems)
    return problems
