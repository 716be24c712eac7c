"""Row payload codec: a msgpack map {column_id: datum}, a datum a native
msgpack scalar (int / float / bytes / None).

Reference: tidb_query_datatype/src/codec/row (the JAX package's
``codec/row.py`` wire format).  Only the row scan of a KV feed
(``executors/scan.py``) decodes rows; ``msgpack`` is imported there, at
first use, so the columnar paths never need it.  DECIMAL datums (the
reference's ExtType 1) are outside the port.
"""

from __future__ import annotations


def encode_row(cols: dict) -> bytes:
    """cols: {column_id: python value or None}."""
    import msgpack
    return msgpack.packb(cols, use_bin_type=True)


def decode_row(data: bytes) -> dict:
    import msgpack
    return msgpack.unpackb(data, raw=False, strict_map_key=False)
