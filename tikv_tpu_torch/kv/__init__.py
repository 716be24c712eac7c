"""Distributed-KV engine facade: the port's copy of the JAX package's
``kv`` package.

Reference: components/tikv_kv/src/lib.rs — the ``Engine`` trait
(async_snapshot :368 / async_write :386) that unites raft-replicated
(RaftKv) and local engines; ``BTreeEngine``/``RocksEngine`` are the local
impls used by the txn layer's tests and by standalone deployments.
"""

from .engine import Engine, LocalEngine, SnapContext, WriteData

__all__ = ["Engine", "LocalEngine", "SnapContext", "WriteData"]
