"""MvccTxn — buffered modifications of one command execution.

A copy of the JAX package's ``storage/mvcc/txn.py``.

Reference: src/storage/mvcc/txn.rs:60 (MvccTxn: modifies vec, lock
put/unlock, put_write/delete_write, put_value/delete_value), flushed into
one engine WriteBatch when the command succeeds (atomicity unit).
"""

from __future__ import annotations

from typing import Optional

from ...engine.traits import CF_DEFAULT, CF_LOCK, CF_WRITE
from ..txn_types import Lock, Write, append_ts, encode_key


class MvccTxn:
    def __init__(self, start_ts: int):
        self.start_ts = start_ts
        self.modifies: list[tuple] = []     # (op, cf, key, value?)
        # user keys whose engine lock this command removes — the waiter
        # manager wakes parked pessimistic lockers on exactly these
        self.released_keys: list[bytes] = []

    # -- locks --

    def put_lock(self, key: bytes, lock: Lock) -> None:
        self.modifies.append(("put", CF_LOCK, encode_key(key),
                              lock.to_bytes()))

    def unlock_key(self, key: bytes) -> None:
        self.modifies.append(("del", CF_LOCK, encode_key(key), None))
        self.released_keys.append(key)

    # -- write records --

    def put_write(self, key: bytes, commit_ts: int, write: Write) -> None:
        self.modifies.append(("put", CF_WRITE,
                              append_ts(encode_key(key), commit_ts),
                              write.to_bytes()))

    def delete_write(self, key: bytes, commit_ts: int) -> None:
        self.modifies.append(("del", CF_WRITE,
                              append_ts(encode_key(key), commit_ts), None))

    # -- values --

    def put_value(self, key: bytes, start_ts: int, value: bytes) -> None:
        self.modifies.append(("put", CF_DEFAULT,
                              append_ts(encode_key(key), start_ts), value))

    def delete_value(self, key: bytes, start_ts: int) -> None:
        self.modifies.append(("del", CF_DEFAULT,
                              append_ts(encode_key(key), start_ts), None))

    # -- flush (the scheduler wraps ``modifies`` into kv.WriteData) --

    def is_empty(self) -> bool:
        return not self.modifies
