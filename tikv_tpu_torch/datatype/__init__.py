"""Type system + columnar containers (eval types, field types, columns)."""

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
