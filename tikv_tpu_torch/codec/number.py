"""Memcomparable int64 codec (the part record keys need).

Reference: components/codec/src/number.rs (encode_i64: sign-bit flip +
big-endian so byte order == numeric order).
"""

from __future__ import annotations

import struct

_SIGN_MASK = 0x8000000000000000


def encode_i64(v: int) -> bytes:
    """Sign-flipped big-endian: memcmp order == numeric order."""
    return struct.pack(">Q", (v + _SIGN_MASK) & 0xFFFFFFFFFFFFFFFF)


def decode_i64(b: bytes, offset: int = 0) -> int:
    (u,) = struct.unpack_from(">Q", b, offset)
    return u - _SIGN_MASK
