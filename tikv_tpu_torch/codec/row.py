"""Row payload codec: a msgpack map {column_id: datum}, a datum a native
msgpack scalar (int / float / bytes / str / bool / None) or a DECIMAL, an
ExtType(1) carrying its exact, scale-preserving text form.  DATETIME,
DURATION, ENUM and SET travel as their integer cores; a JSON document as
its parsed value: an object a msgpack map with string keys, an array a
msgpack array (decoded as a list), a scalar as itself.

Reference: tidb_query_datatype/src/codec/row (the JAX package's
``codec/row.py`` wire format).  ``encode_row`` is the port's own packer of
that subset, byte for byte what ``msgpack.packb(cols, use_bin_type=True)``
writes, so the KV pairs of a columnar snapshot (``to_kv_pairs``, the
CHECKSUM request) need no msgpack package.  Only the row scan of a KV
feed (``executors/scan.py``) decodes rows; ``msgpack`` is imported there,
at first use.
"""

from __future__ import annotations

import decimal
import struct

# the ExtType code of a DECIMAL datum (its ``format(d, "f")`` text)
_EXT_DECIMAL = 1


def _pack_int(x: int, out: list) -> None:
    if 0 <= x < 0x80 or -32 <= x < 0:
        out.append(struct.pack(">b" if x < 0 else ">B", x))
    elif x >= 0:
        for lim, tag, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                              (0xFFFFFFFF, 0xCE, ">I"),
                              ((1 << 64) - 1, 0xCF, ">Q")):
            if x <= lim:
                out.append(bytes([tag]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"int {x} does not fit msgpack")
    else:
        for lim, tag, fmt in ((-(1 << 7), 0xD0, ">b"),
                              (-(1 << 15), 0xD1, ">h"),
                              (-(1 << 31), 0xD2, ">i"),
                              (-(1 << 63), 0xD3, ">q")):
            if x >= lim:
                out.append(bytes([tag]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"int {x} does not fit msgpack")


def _pack_len(n: int, small: tuple, tags: tuple, out: list) -> None:
    """A length header: ``small`` = (fix tag, fix limit) or None, then the
    8/16/32-bit tags (None where the family has no such form)."""
    if small is not None and n < small[1]:
        out.append(bytes([small[0] | n]))
        return
    for lim, tag, fmt in ((1 << 8, tags[0], ">B"), (1 << 16, tags[1], ">H"),
                          (1 << 32, tags[2], ">I")):
        if tag is not None and n < lim:
            out.append(bytes([tag]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_ext(code: int, data: bytes, out: list) -> None:
    """An ExtType: fixext 1/2/4/8/16 where the length is one of those,
    else ext 8/16/32."""
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(data))
    if fix is not None:
        out.append(bytes([fix]))
    else:
        _pack_len(len(data), None, (0xC7, 0xC8, 0xC9), out)
    out.append(struct.pack(">b", code))
    out.append(data)


def _ext_hook(code: int, data: bytes):
    if code == _EXT_DECIMAL:
        from ..datatype.mydecimal import CTX
        return CTX.create_decimal(data.decode())
    import msgpack
    return msgpack.ExtType(code, data)


def _pack(v, out: list) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        _pack_int(v, out)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        _pack_len(len(b), None, (0xC4, 0xC5, 0xC6), out)
        out.append(b)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _pack_len(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif isinstance(v, decimal.Decimal):
        _pack_ext(_EXT_DECIMAL, format(v, "f").encode(), out)
    elif isinstance(v, dict):
        _pack_len(len(v), (0x80, 16), (None, 0xDE, 0xDF), out)
        for k, x in v.items():
            _pack(k, out)
            _pack(x, out)
    elif isinstance(v, (list, tuple)):
        _pack_len(len(v), (0x90, 16), (None, 0xDC, 0xDD), out)
        for x in v:
            _pack(x, out)
    else:
        raise TypeError(f"cannot encode {type(v).__name__} in a row")


def encode_row(cols: dict) -> bytes:
    """cols: {column_id: python value or None}."""
    out: list = []
    _pack(cols, out)
    return b"".join(out)


def decode_row(data: bytes) -> dict:
    import msgpack
    return msgpack.unpackb(data, raw=False, strict_map_key=False,
                           ext_hook=_ext_hook)
