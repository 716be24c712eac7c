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


# memcomparable bytes and var-ints (reference: components/codec/src/byte.rs
# encode_bytes, number.rs encode_var_u64): what engine keys and the MVCC
# records need

_PAD = 8
_MARKER = 0xFF


def encode_bytes_memcomparable(data: bytes) -> bytes:
    """0x00-padded 8-byte groups, each followed by 0xFF − pad_count:
    order-preserving and self-terminating."""
    out = bytearray()
    for i in range(0, len(data) + 1, _PAD):
        chunk = data[i:i + _PAD]
        pad = _PAD - len(chunk)
        out += chunk + b"\x00" * pad
        out.append(_MARKER - pad)
    return bytes(out)


def decode_bytes_memcomparable(b: bytes, offset: int = 0) -> tuple:
    """→ (data, next offset)."""
    out = bytearray()
    while True:
        chunk = b[offset:offset + _PAD]
        if len(chunk) < _PAD or offset + _PAD >= len(b):
            raise ValueError("truncated memcomparable bytes")
        marker = b[offset + _PAD]
        offset += _PAD + 1
        pad = _MARKER - marker
        if pad < 0 or pad > _PAD:
            raise ValueError("corrupt memcomparable bytes")
        if pad == 0:
            out += chunk
        else:
            out += chunk[:_PAD - pad]
            return bytes(out), offset


def encode_var_u64(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def decode_var_u64(b: bytes, offset: int = 0) -> tuple:
    """→ (value, next offset)."""
    shift = 0
    v = 0
    while True:
        byte = b[offset]
        offset += 1
        v |= (byte & 0x7F) << shift
        if byte < 0x80:
            return v, offset
        shift += 7
