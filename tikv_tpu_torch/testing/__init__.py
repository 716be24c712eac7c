"""Test and smoke builders: table schemas and the DagSelect plan builder."""

from .dag import DagSelect
from .fixture import Table, TableColumn

__all__ = ["DagSelect", "Table", "TableColumn"]
