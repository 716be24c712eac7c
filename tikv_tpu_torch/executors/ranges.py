"""Key ranges.

Reference: tidb_query_common/src/storage/range.rs — ``IntervalRange`` /
``PointRange`` / ``Range``. A scan request carries a sorted list of these.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class KeyRange:
    """[start, end) byte range; a point range has end == start + NUL."""

    start: bytes
    end: bytes

    @staticmethod
    def point(key: bytes) -> "KeyRange":
        return KeyRange(key, key + b"\x00")

    @property
    def is_point(self) -> bool:
        return self.end == self.start + b"\x00"
