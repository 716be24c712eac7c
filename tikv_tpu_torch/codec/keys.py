"""Record and index key layout (table codec ``t{table_id}_r{handle}``,
``t{table_id}_i{index_id}...``) and the engine's data-key prefix.

Reference: the tidb-side table codec as consumed by the coprocessor
executors' key ranges (only what record ranges, handle bounds and index
ranges need), and components/keys/src/lib.rs:23-59 (the ``z`` prefix of
every data key in the engine).
"""

from __future__ import annotations

from .number import decode_i64, encode_i64

DATA_PREFIX = b"z"

_TABLE_PREFIX = b"t"
_RECORD_SEP = b"_r"
_INDEX_SEP = b"_i"


def table_record_key(table_id: int, handle: int) -> bytes:
    return _TABLE_PREFIX + encode_i64(table_id) + _RECORD_SEP + encode_i64(handle)


def table_record_range(table_id: int) -> tuple[bytes, bytes]:
    """[start, end) covering all records of a table."""
    prefix = _TABLE_PREFIX + encode_i64(table_id) + _RECORD_SEP
    return prefix + encode_i64(-(2**63)), prefix + b"\xff" * 9


def decode_record_handle(key: bytes) -> int:
    """The handle of a record key: ``t`` + 8 + ``_r`` → offset 11."""
    return decode_i64(key, 11)


def index_key_prefix(table_id: int, index_id: int) -> bytes:
    return _TABLE_PREFIX + encode_i64(table_id) + _INDEX_SEP + \
        encode_i64(index_id)


def data_key(key: bytes) -> bytes:
    """User key → engine key (reference: keys::data_key)."""
    return DATA_PREFIX + key


def origin_key(key: bytes) -> bytes:
    assert key.startswith(DATA_PREFIX), key[:1]
    return key[1:]
