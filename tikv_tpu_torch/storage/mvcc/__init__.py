"""MVCC layer — Percolator readers + transaction write buffer.

A copy of the JAX package's ``storage/mvcc/__init__.py``.

Reference: src/storage/mvcc/ (MvccTxn txn.rs:60, PointGetter
reader/point_getter.rs, MvccReader, forward/backward Scanner
reader/scanner/).
"""

from .errors import (
    AlreadyExist,
    Committed,
    KeyIsLocked,
    MvccError,
    PessimisticLockRolledBack,
    TxnLockNotFound,
    WriteConflict,
)
from .reader import MvccReader
from .txn import MvccTxn

__all__ = [
    "MvccReader", "MvccTxn", "MvccError", "KeyIsLocked", "WriteConflict",
    "TxnLockNotFound", "Committed", "AlreadyExist",
    "PessimisticLockRolledBack",
]
