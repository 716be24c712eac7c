"""Memcomparable datum encoding — the datums inside index keys.

Reference: tidb_query_datatype/src/codec/datum.rs (flag-prefixed datums,
NIL_FLAG=0, INT_FLAG=3, FLOAT_FLAG=5): byte order equals SQL order, NULL
first.  Trimmed to the numeric datums the port's index scans address
(INT and REAL indexed columns, the handle); other flags raise.
"""

from __future__ import annotations

import struct

from .number import decode_i64, encode_i64

NIL_FLAG = 0x00
INT_FLAG = 0x03
FLOAT_FLAG = 0x05


def _encode_f64(v: float) -> bytes:
    u = struct.unpack(">Q", struct.pack(">d", v))[0]
    if u & 0x8000000000000000:
        u ^= 0xFFFFFFFFFFFFFFFF
    else:
        u ^= 0x8000000000000000
    return struct.pack(">Q", u)


def _decode_f64(b: bytes, offset: int) -> float:
    (u,) = struct.unpack_from(">Q", b, offset)
    if u & 0x8000000000000000:
        u ^= 0x8000000000000000
    else:
        u ^= 0xFFFFFFFFFFFFFFFF
    return struct.unpack(">d", struct.pack(">Q", u))[0]


def encode_mc_datum(v) -> bytes:
    if v is None:
        return bytes([NIL_FLAG])
    if isinstance(v, (bool, int)):
        return bytes([INT_FLAG]) + encode_i64(int(v))
    if isinstance(v, float):
        return bytes([FLOAT_FLAG]) + _encode_f64(v)
    raise TypeError(f"cannot mc-encode {type(v)} in the port")


def decode_mc_datum(b: bytes, offset: int = 0):
    """Returns (value, next_offset); raises ValueError on a flag the port
    does not decode (e.g. the 0xff range sentinel)."""
    flag = b[offset]
    offset += 1
    if flag == NIL_FLAG:
        return None, offset
    if flag == INT_FLAG:
        return decode_i64(b, offset), offset + 8
    if flag == FLOAT_FLAG:
        return _decode_f64(b, offset), offset + 8
    raise ValueError(f"bad datum flag {flag}")
