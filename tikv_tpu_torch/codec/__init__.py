"""Key codecs (the record- and index-key subset the scans need) and the
row payload codec of a KV feed (``row``)."""

from .keys import (decode_record_handle, index_key_prefix,
                   table_record_key, table_record_range)
from .mc_datum import decode_mc_datum, encode_mc_datum
from .number import decode_i64, encode_i64

__all__ = ["decode_record_handle", "index_key_prefix", "table_record_key",
           "table_record_range", "decode_mc_datum", "encode_mc_datum",
           "decode_i64", "encode_i64"]
