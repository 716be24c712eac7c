"""Multi-raft replication layer, on one store: the port's copy of the JAX
package's ``raftstore`` package, trimmed to the single-store in-process
path.

The region metadata (``metapb``), the raft command payloads (``cmd``),
the apply-path observer seam (``observer``), the durable raft state
(``peer_storage``), the peer with its region-clamped snapshot (``peer``),
the store that drives its peers (``store``) and RaftKv, the
consensus-backed kv.Engine (``raftkv``).

Reference: components/raftstore: peers multiplexed per store, the apply
path, and RaftKv.
"""

from .cmd import AdminCmd, RaftCmd, WriteOp
from .metapb import (
    EpochNotMatch,
    InconsistentRegion,
    KeyNotInRegion,
    NotLeaderError,
    Peer,
    Region,
    RegionEpoch,
    RegionNotFound,
    Store,
)
from .peer import RaftPeer, RegionSnapshot
from .raftkv import RaftKv
from .store import RaftStore, Transport

__all__ = [
    "AdminCmd", "RaftCmd", "WriteOp", "EpochNotMatch", "InconsistentRegion",
    "KeyNotInRegion", "NotLeaderError", "Peer", "Region", "RegionEpoch",
    "RegionNotFound", "Store", "RaftPeer", "RegionSnapshot", "RaftKv",
    "RaftStore", "Transport",
]
