"""Key codecs: the record-key subset the columnar scan needs."""

from .keys import table_record_key, table_record_range
from .number import decode_i64, encode_i64

__all__ = ["table_record_key", "table_record_range", "decode_i64",
           "encode_i64"]
