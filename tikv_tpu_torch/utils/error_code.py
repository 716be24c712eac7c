"""Stable error codes for every subsystem.

A copy of the JAX package's ``utils/error_code.py``.

Reference: components/error_code/ — each error type carries a stable
``KV:Subsystem:Name`` code so operators and tooling can match on
errors across versions regardless of message wording.
"""

from __future__ import annotations

# subsystem registries: exception class name -> code
_CODES = {
    # raftstore
    "NotLeaderError": "KV:Raftstore:NotLeader",
    "RegionNotFound": "KV:Raftstore:RegionNotFound",
    "EpochNotMatch": "KV:Raftstore:EpochNotMatch",
    "KeyNotInRegion": "KV:Raftstore:KeyNotInRegion",
    "RegionMerging": "KV:Raftstore:ProposalInMergingMode",
    # storage / mvcc
    "KeyIsLocked": "KV:Storage:KeyIsLocked",
    "WriteConflict": "KV:Storage:WriteConflict",
    "TxnLockNotFound": "KV:Storage:TxnLockNotFound",
    "Committed": "KV:Storage:Committed",
    "AlreadyExist": "KV:Storage:AlreadyExist",
    "PessimisticLockRolledBack": "KV:Storage:PessimisticLockRolledBack",
    "Deadlock": "KV:Storage:Deadlock",
    # server
    "ServerIsBusy": "KV:Server:IsBusy",
    "TimeoutError": "KV:Server:Timeout",
    "DeadlineExceeded": "KV:Server:DeadlineExceeded",
    "DataIsNotReady": "KV:Raftstore:DataIsNotReady",
    "CircuitOpen": "KV:Client:CircuitOpen",
    # engine
    "CorruptionError": "KV:Engine:Corruption",
}

UNKNOWN = "KV:Unknown"


def code_of(e: Exception) -> str:
    """Stable code for an exception (class-name keyed; subclass-aware)."""
    for cls in type(e).__mro__:
        code = _CODES.get(cls.__name__)
        if code is not None:
            return code
    return UNKNOWN
