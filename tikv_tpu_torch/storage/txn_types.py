"""MVCC on-disk record formats — the Percolator data model.

A copy of the JAX package's ``storage/txn_types.py``.  Reference:
components/txn_types/src/:
- ``TimeStamp`` (timestamp.rs:14): u64, physical<<18 | logical
- ``Key`` (types.rs:49): memcomparable-encoded user key, optionally
  suffixed with 8 bytes of bitwise-NOT commit/start ts so that higher
  timestamps sort FIRST under ascending byte order
- ``Lock`` (lock.rs:75): CF_LOCK value — who holds the key, since when,
  with what intent
- ``Write`` (write.rs:16,70): CF_WRITE value — one committed/rolled-back
  version: (write_type, start_ts, short_value?)

Short values (≤ 255 bytes, write.rs SHORT_VALUE_MAX_LEN) are inlined into
the lock/write record so point reads skip the CF_DEFAULT lookup.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from enum import Enum
from typing import Optional

from ..codec.number import (
    decode_bytes_memcomparable,
    decode_var_u64,
    encode_bytes_memcomparable,
    encode_var_u64,
)

TS_MAX = (1 << 64) - 1
SHORT_VALUE_MAX_LEN = 255


# ---------------------------------------------------------------- TimeStamp

def compose_ts(physical_ms: int, logical: int) -> int:
    """Reference: timestamp.rs compose — TSO layout."""
    return (physical_ms << 18) | logical


def ts_physical(ts: int) -> int:
    return ts >> 18


# ---------------------------------------------------------------- Key

# Keyspace mode prefixes: txn and raw keys must never collide in the
# engine (reference: api_version/src/keyspace.rs ApiV2 key modes).  The
# raw keyspace uses b"r" (storage/__init__.py); txn keys get b"x".
TXN_PREFIX = b"x"


def encode_key(user_key: bytes) -> bytes:
    """User key → engine key (mode prefix + memcomparable, no ts)."""
    return TXN_PREFIX + encode_bytes_memcomparable(user_key)


def decode_key(encoded: bytes):
    """Engine key (no ts suffix) → user key."""
    assert encoded[:1] == TXN_PREFIX, encoded[:1]
    key, off = decode_bytes_memcomparable(encoded, 1)
    assert off == len(encoded), "trailing bytes after key"
    return key


def append_ts(encoded_key: bytes, ts: int) -> bytes:
    """Append ts so higher ts sorts first (types.rs append_ts: !ts BE)."""
    return encoded_key + struct.pack(">Q", TS_MAX - ts)


def split_ts(key_with_ts: bytes) -> tuple[bytes, int]:
    """→ (encoded key without ts, ts).  Reference: types.rs split_on_ts_for."""
    assert len(key_with_ts) >= 8, key_with_ts
    (inv,) = struct.unpack_from(">Q", key_with_ts, len(key_with_ts) - 8)
    return key_with_ts[:-8], TS_MAX - inv


# ---------------------------------------------------------------- Lock

class LockType(Enum):
    PUT = b"P"
    DELETE = b"D"
    LOCK = b"L"             # prewrite of a LOCK mutation (read lock)
    PESSIMISTIC = b"S"      # acquire_pessimistic_lock placeholder


@dataclass
class Lock:
    """CF_LOCK record.  Reference: lock.rs:75 (Lock struct + to_bytes).

    ``use_async_commit`` + ``secondaries``: the primary lock of an
    async-commit txn carries every secondary key, so any reader can
    resolve the txn's fate from the primary alone (lock.rs async commit
    fields; the resolution protocol is CheckSecondaryLocks)."""

    lock_type: LockType
    primary: bytes
    start_ts: int
    ttl: int = 0
    short_value: Optional[bytes] = None
    for_update_ts: int = 0          # pessimistic txns
    txn_size: int = 0
    min_commit_ts: int = 0
    use_async_commit: bool = False
    secondaries: tuple = ()

    def to_bytes(self) -> bytes:
        out = bytearray()
        out += self.lock_type.value
        out += encode_var_u64(len(self.primary))
        out += self.primary
        out += encode_var_u64(self.start_ts)
        out += encode_var_u64(self.ttl)
        out += encode_var_u64(self.for_update_ts)
        out += encode_var_u64(self.txn_size)
        out += encode_var_u64(self.min_commit_ts)
        if self.short_value is not None:
            out += b"v"
            out += encode_var_u64(len(self.short_value))
            out += self.short_value
        if self.use_async_commit:
            out += b"a"
            out += encode_var_u64(len(self.secondaries))
            for s in self.secondaries:
                out += encode_var_u64(len(s))
                out += s
        return bytes(out)

    @staticmethod
    def from_bytes(b: bytes) -> "Lock":
        lt = LockType(b[0:1])
        off = 1
        n, off = decode_var_u64(b, off)
        primary = b[off:off + n]
        off += n
        start_ts, off = decode_var_u64(b, off)
        ttl, off = decode_var_u64(b, off)
        for_update_ts, off = decode_var_u64(b, off)
        txn_size, off = decode_var_u64(b, off)
        min_commit_ts, off = decode_var_u64(b, off)
        short_value = None
        use_async_commit = False
        secondaries: list = []
        while off < len(b):
            tag = b[off:off + 1]
            off += 1
            if tag == b"v":
                n, off = decode_var_u64(b, off)
                short_value = b[off:off + n]
                off += n
            elif tag == b"a":
                use_async_commit = True
                cnt, off = decode_var_u64(b, off)
                for _ in range(cnt):
                    n, off = decode_var_u64(b, off)
                    secondaries.append(b[off:off + n])
                    off += n
            else:
                raise ValueError(f"bad lock tag {tag!r}")
        return Lock(lt, primary, start_ts, ttl, short_value,
                    for_update_ts, txn_size, min_commit_ts,
                    use_async_commit, tuple(secondaries))


# ---------------------------------------------------------------- Write

class WriteType(Enum):
    PUT = b"P"
    DELETE = b"D"
    LOCK = b"L"
    ROLLBACK = b"R"


@dataclass
class Write:
    """CF_WRITE record.  Reference: write.rs:16 (Write struct).

    ``has_overlapped_rollback``: a Rollback whose ts collided with this
    committed write's commit_ts is folded in (write.rs overlapped rollback).
    """

    write_type: WriteType
    start_ts: int
    short_value: Optional[bytes] = None
    has_overlapped_rollback: bool = False

    def to_bytes(self) -> bytes:
        out = bytearray()
        out += self.write_type.value
        out += encode_var_u64(self.start_ts)
        if self.short_value is not None:
            out += b"v"
            out += encode_var_u64(len(self.short_value))
            out += self.short_value
        if self.has_overlapped_rollback:
            out += b"R"
        return bytes(out)

    @staticmethod
    def from_bytes(b: bytes) -> "Write":
        wt = WriteType(b[0:1])
        off = 1
        start_ts, off = decode_var_u64(b, off)
        short_value = None
        overlapped = False
        while off < len(b):
            tag = b[off:off + 1]
            off += 1
            if tag == b"v":
                n, off = decode_var_u64(b, off)
                short_value = b[off:off + n]
                off += n
            elif tag == b"R":
                overlapped = True
            else:
                raise ValueError(f"bad write tag {tag!r}")
        return Write(wt, start_ts, short_value, overlapped)
