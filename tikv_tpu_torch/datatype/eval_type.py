"""Evaluation types and field types.

Reference: components/tidb_query_datatype/src/lib.rs (EvalType),
src/def/field_type.rs (FieldType/FieldTypeTp/FieldTypeFlag). The reference
distinguishes the wire-level MySQL column type (FieldTypeTp, ~30 variants)
from the evaluation type the vectorized engine computes on (EvalType, 9
variants, eval_type via EvalType::try_from_field_type). We keep the same
split: FieldType carries schema metadata; EvalType picks the kernel dtype.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class EvalType(enum.Enum):
    """The 9 evaluation types of the vectorized engine.

    Reference: tidb_query_datatype/src/lib.rs EvalType enum.
    """

    INT = "int"            # signed/unsigned 64-bit (device: int32 when it fits)
    REAL = "real"          # f64 on host, f32 on device
    DECIMAL = "decimal"    # fixed point, decimal.Decimal (host-only)
    BYTES = "bytes"        # var-length binary/string (host-only)
    DATETIME = "datetime"  # packed u64 core time
    DURATION = "duration"  # i64 nanoseconds
    JSON = "json"          # host-side only
    ENUM = "enum"          # u64 ordinal + shared name table
    SET = "set"            # u64 bitmask + shared name table

    @property
    def np_dtype(self) -> np.dtype:
        """Host-side storage dtype for the dense value array."""
        if self in (EvalType.INT, EvalType.DURATION):
            return np.dtype(np.int64)
        if self is EvalType.REAL:
            return np.dtype(np.float64)
        if self in (EvalType.DATETIME, EvalType.ENUM, EvalType.SET):
            return np.dtype(np.uint64)
        return np.dtype(object)  # BYTES / JSON / DECIMAL


class FieldTypeTp(enum.IntEnum):
    """MySQL protocol column types (subset that TiKV's coprocessor sees).

    Reference: tidb_query_datatype/src/def/field_type.rs FieldTypeTp.
    Values follow the MySQL wire protocol so DAG plans can round-trip.
    """

    UNSPECIFIED = 0
    TINY = 1
    SHORT = 2
    LONG = 3
    FLOAT = 4
    DOUBLE = 5
    NULL = 6
    TIMESTAMP = 7
    LONG_LONG = 8
    INT24 = 9
    DATE = 10
    DURATION = 11
    DATETIME = 12
    YEAR = 13
    NEW_DATE = 14
    VAR_CHAR = 15
    BIT = 16
    JSON = 0xF5
    NEW_DECIMAL = 0xF6
    ENUM = 0xF7
    SET = 0xF8
    TINY_BLOB = 0xF9
    MEDIUM_BLOB = 0xFA
    LONG_BLOB = 0xFB
    BLOB = 0xFC
    VAR_STRING = 0xFD
    STRING = 0xFE
    GEOMETRY = 0xFF


class FieldTypeFlag(enum.IntFlag):
    """Column flags. Reference: field_type.rs FieldTypeFlag."""

    NONE = 0
    NOT_NULL = 1
    PRI_KEY = 1 << 1
    UNSIGNED = 1 << 5
    BINARY = 1 << 7
    IS_BOOLEAN = 1 << 62  # internal


_TP_TO_EVAL = {
    FieldTypeTp.TINY: EvalType.INT,
    FieldTypeTp.SHORT: EvalType.INT,
    FieldTypeTp.INT24: EvalType.INT,
    FieldTypeTp.LONG: EvalType.INT,
    FieldTypeTp.LONG_LONG: EvalType.INT,
    FieldTypeTp.YEAR: EvalType.INT,
    FieldTypeTp.BIT: EvalType.INT,
    FieldTypeTp.FLOAT: EvalType.REAL,
    FieldTypeTp.DOUBLE: EvalType.REAL,
    FieldTypeTp.NEW_DECIMAL: EvalType.DECIMAL,
    FieldTypeTp.TIMESTAMP: EvalType.DATETIME,
    FieldTypeTp.DATE: EvalType.DATETIME,
    FieldTypeTp.NEW_DATE: EvalType.DATETIME,
    FieldTypeTp.DATETIME: EvalType.DATETIME,
    FieldTypeTp.DURATION: EvalType.DURATION,
    FieldTypeTp.JSON: EvalType.JSON,
    FieldTypeTp.ENUM: EvalType.ENUM,
    FieldTypeTp.SET: EvalType.SET,
    FieldTypeTp.VAR_CHAR: EvalType.BYTES,
    FieldTypeTp.VAR_STRING: EvalType.BYTES,
    FieldTypeTp.STRING: EvalType.BYTES,
    FieldTypeTp.TINY_BLOB: EvalType.BYTES,
    FieldTypeTp.MEDIUM_BLOB: EvalType.BYTES,
    FieldTypeTp.LONG_BLOB: EvalType.BYTES,
    FieldTypeTp.BLOB: EvalType.BYTES,
}


@dataclass(frozen=True)
class FieldType:
    """Schema metadata for one column.

    Reference: tipb FieldType / tidb_query_datatype field_type.rs accessors.
    """

    tp: FieldTypeTp = FieldTypeTp.LONG_LONG
    flag: FieldTypeFlag = FieldTypeFlag.NONE
    flen: int = -1
    decimal: int = -1
    collation: int = 63  # binary
    elems: tuple = field(default_factory=tuple)  # enum/set name table

    @property
    def eval_type(self) -> EvalType:
        try:
            return _TP_TO_EVAL[self.tp]
        except KeyError:
            raise ValueError(f"unsupported field type {self.tp!r}") from None

    @property
    def is_unsigned(self) -> bool:
        return bool(self.flag & FieldTypeFlag.UNSIGNED)

    @property
    def is_nullable(self) -> bool:
        return not (self.flag & FieldTypeFlag.NOT_NULL)

    @staticmethod
    def long(unsigned: bool = False, not_null: bool = False) -> "FieldType":
        flag = FieldTypeFlag.NONE
        if unsigned:
            flag |= FieldTypeFlag.UNSIGNED
        if not_null:
            flag |= FieldTypeFlag.NOT_NULL
        return FieldType(tp=FieldTypeTp.LONG_LONG, flag=flag)

    @staticmethod
    def double(not_null: bool = False) -> "FieldType":
        flag = FieldTypeFlag.NOT_NULL if not_null else FieldTypeFlag.NONE
        return FieldType(tp=FieldTypeTp.DOUBLE, flag=flag)

    @staticmethod
    def var_char(collation: int = 63) -> "FieldType":
        return FieldType(tp=FieldTypeTp.VAR_CHAR, collation=collation)

    @staticmethod
    def enum(elems, collation: int = 63) -> "FieldType":
        return FieldType(tp=FieldTypeTp.ENUM, collation=collation,
                         elems=tuple(elems))

    @staticmethod
    def set_(elems, collation: int = 63) -> "FieldType":
        return FieldType(tp=FieldTypeTp.SET, collation=collation,
                         elems=tuple(elems))

    @staticmethod
    def json() -> "FieldType":
        return FieldType(tp=FieldTypeTp.JSON)

    @staticmethod
    def new_decimal(flen: int = 20, frac: int = 4) -> "FieldType":
        # not "decimal": that would shadow the dataclass field's default
        return FieldType(tp=FieldTypeTp.NEW_DECIMAL, flen=flen, decimal=frac)


def device_const_dtype(v) -> str:
    """Device dtype bucket for a numeric constant: a float is float32;
    an int is int32 unless it crosses the int32 boundary.  Shared by the
    expression evaluator's constants (expr/eval.py) and the const-blind
    plan class (copr/dag.DAGRequest.class_key) so the two never drift."""
    if isinstance(v, float):
        return "float32"
    return "int32" if -(2 ** 31) <= v < 2 ** 31 else "int64"
