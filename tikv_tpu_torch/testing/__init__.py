"""Test and smoke builders: table schemas, a KV feed of encoded rows and
the DagSelect plan builder."""

from .dag import DagSelect
from .fixture import Table, TableColumn, init_with_data

__all__ = ["DagSelect", "Table", "TableColumn", "init_with_data"]
