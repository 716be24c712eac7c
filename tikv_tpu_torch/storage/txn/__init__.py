"""Transaction layer: Percolator actions, latches, command scheduler.

A copy of the JAX package's ``storage/txn/__init__.py``.

Reference: src/storage/txn/ (actions/, commands/, scheduler.rs, latch.rs).
"""

from .actions import (
    Mutation,
    acquire_pessimistic_lock,
    check_txn_status,
    cleanup,
    commit,
    prewrite,
    rollback,
)
from .latch import Latches
from .scheduler import TxnScheduler

__all__ = [
    "Mutation", "prewrite", "commit", "rollback", "cleanup",
    "check_txn_status", "acquire_pessimistic_lock", "Latches",
    "TxnScheduler",
]
