"""Type system + columnar containers (eval types, field types, columns),
and the value semantics of the host-only types: ``time`` (the packed
DATETIME core), ``mydecimal`` (MySQL DECIMAL over ``decimal.Decimal``) and
``collation`` (sort keys, enum and set names)."""

from .eval_type import (EvalType, FieldType, FieldTypeFlag, FieldTypeTp,
                        device_const_dtype)
from .column import Column, ColumnBatch

__all__ = [
    "EvalType",
    "FieldType",
    "FieldTypeFlag",
    "FieldTypeTp",
    "device_const_dtype",
    "Column",
    "ColumnBatch",
]
