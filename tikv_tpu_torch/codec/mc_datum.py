"""Memcomparable datum encoding — the datums inside index keys.

Reference: tidb_query_datatype/src/codec/datum.rs (flag-prefixed datums,
NIL_FLAG=0, BYTES_FLAG=1, INT_FLAG=3, FLOAT_FLAG=5, DECIMAL_FLAG=6): byte
order equals SQL order, NULL first.  Other flags raise.
"""

from __future__ import annotations

import decimal
import struct

from .number import (decode_bytes_memcomparable, decode_i64,
                     encode_bytes_memcomparable, encode_i64)

NIL_FLAG = 0x00
BYTES_FLAG = 0x01
INT_FLAG = 0x03
FLOAT_FLAG = 0x05
DECIMAL_FLAG = 0x06

# DECIMAL memcomparable form (the JAX package's): the value scaled to 10^30
# (MySQL's max scale) as a bias-shifted fixed-width big-endian integer —
# byte order is numeric order across signs.  65+30 digits < 2^383, so 48
# bytes with a 2^383 bias always fit.
_DEC_W = 48
_DEC_BIAS = 1 << (_DEC_W * 8 - 1)


def _wide_ctx() -> decimal.Context:
    """A context whose precision covers the scaled form (65 digits + 30
    scale): the default 28 digits would collide distinct keys."""
    ctx = decimal.getcontext().copy()
    ctx.prec = 100
    return ctx


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
    if isinstance(v, (bytes, bytearray)):
        return bytes([BYTES_FLAG]) + encode_bytes_memcomparable(bytes(v))
    if isinstance(v, decimal.Decimal):
        with decimal.localcontext(_wide_ctx()):
            scaled = int(v.scaleb(30).to_integral_value(
                rounding=decimal.ROUND_HALF_UP))
        # saturate at the representable bound, as MySQL clamps to the
        # largest decimal
        lim = _DEC_BIAS - 1
        scaled = max(-lim, min(lim, scaled))
        return bytes([DECIMAL_FLAG]) + \
            (scaled + _DEC_BIAS).to_bytes(_DEC_W, "big")
    raise TypeError(f"cannot mc-encode {type(v)}")


def decode_mc_datum(b: bytes, offset: int = 0):
    """Returns (value, next_offset); raises ValueError on a flag it does
    not decode (e.g. the 0xff range sentinel)."""
    flag = b[offset]
    offset += 1
    if flag == NIL_FLAG:
        return None, offset
    if flag == INT_FLAG:
        return decode_i64(b, offset), offset + 8
    if flag == FLOAT_FLAG:
        return _decode_f64(b, offset), offset + 8
    if flag == BYTES_FLAG:
        return decode_bytes_memcomparable(b, offset)
    if flag == DECIMAL_FLAG:
        scaled = int.from_bytes(b[offset:offset + _DEC_W], "big") - _DEC_BIAS
        # numerically exact; the printed scale is not kept (1.20 decodes
        # as 1.2): order and equality are what index keys need
        with decimal.localcontext(_wide_ctx()):
            d = decimal.Decimal(scaled).scaleb(-30).normalize()
        return d, offset + _DEC_W
    raise ValueError(f"bad datum flag {flag}")
