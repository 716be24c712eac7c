"""Engine traits — the seam every storage backend implements.

A trimmed copy of the JAX package's ``engine/traits.py`` (reference:
components/engine_traits/src/): the column families (cf_defs.rs:4-11) and
the read protocols a snapshot offers (peekable.rs:11, iterable.rs:120,
snapshot.rs:11), and the engine's own (engine.rs:13).
"""

from __future__ import annotations

from typing import Optional, Protocol

CF_DEFAULT = "default"
CF_LOCK = "lock"
CF_WRITE = "write"
CF_RAFT = "raft"
DATA_CFS = (CF_DEFAULT, CF_LOCK, CF_WRITE)
ALL_CFS = (CF_DEFAULT, CF_LOCK, CF_WRITE, CF_RAFT)


class Iterator(Protocol):
    """Ordered CF iterator bounded to [lower, upper) by its creator."""

    def valid(self) -> bool: ...

    def seek(self, key: bytes) -> bool:
        """Position at the first key >= ``key``; returns valid()."""
        ...

    def seek_for_prev(self, key: bytes) -> bool:
        """Position at the last key <= ``key``; returns valid()."""
        ...

    def seek_to_first(self) -> bool: ...

    def seek_to_last(self) -> bool: ...

    def next(self) -> bool: ...

    def prev(self) -> bool: ...

    def key(self) -> bytes: ...

    def value(self) -> bytes: ...


class Snapshot(Protocol):
    """Immutable point-in-time view."""

    def get_value_cf(self, cf: str, key: bytes) -> Optional[bytes]: ...

    def get_value(self, key: bytes) -> Optional[bytes]: ...

    def iterator_cf(self, cf: str,
                    lower: Optional[bytes] = None,
                    upper: Optional[bytes] = None) -> Iterator: ...


class KvEngine(Protocol):
    """Reference: engine.rs:13 (KvEngine: Peekable + Iterable + WriteBatchExt
    + snapshot())."""

    def snapshot(self) -> Snapshot: ...

    def write_batch(self): ...

    def write(self, batch) -> None:
        """Apply a batch atomically."""
        ...

    def get_value_cf(self, cf: str, key: bytes) -> Optional[bytes]: ...

    def iterator_cf(self, cf: str,
                    lower: Optional[bytes] = None,
                    upper: Optional[bytes] = None) -> Iterator: ...
