"""Cluster metadata types.

A trimmed copy of the JAX package's ``raftstore/metapb.py`` (reference:
the kvproto ``metapb`` messages): ``Peer``, ``RegionEpoch``, ``Region``,
``Store`` and the region errors the raftstore, a region-clamped read and
the consistency check raise.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence


@dataclass(frozen=True)
class Peer:
    id: int
    store_id: int
    is_learner: bool = False


@dataclass(frozen=True)
class RegionEpoch:
    """conf_ver bumps on membership change; version on split/merge."""

    conf_ver: int = 1
    version: int = 1


@dataclass(frozen=True)
class Region:
    """A contiguous key range replicated by one raft group.

    ``start_key``/``end_key`` bound the keys the region holds (the
    engine's encoded keys in practice); an empty end_key is +inf.
    """

    id: int
    start_key: bytes = b""
    end_key: bytes = b""
    epoch: RegionEpoch = RegionEpoch()
    peers: tuple = ()

    def contains(self, key: bytes) -> bool:
        if key < self.start_key:
            return False
        return not self.end_key or key < self.end_key

    def with_peers(self, peers: Sequence[Peer],
                   bump_conf: bool = True) -> "Region":
        epoch = RegionEpoch(self.epoch.conf_ver + (1 if bump_conf else 0),
                            self.epoch.version)
        return replace(self, peers=tuple(peers), epoch=epoch)

    def peer_on_store(self, store_id: int):
        for p in self.peers:
            if p.store_id == store_id:
                return p
        return None


@dataclass(frozen=True)
class Store:
    id: int
    address: str = ""


class NotLeaderError(Exception):
    def __init__(self, region_id: int, leader=None):
        super().__init__(f"region {region_id}: not leader")
        self.region_id = region_id
        self.leader = leader


class EpochNotMatch(Exception):
    def __init__(self, current: Region):
        super().__init__(f"epoch not match; current {current.epoch}")
        self.current = current


class KeyNotInRegion(Exception):
    def __init__(self, key: bytes, region: Region):
        super().__init__(f"{key!r} not in region {region.id}")
        self.key = key
        self.region = region


class RegionNotFound(Exception):
    def __init__(self, region_id: int):
        super().__init__(f"region {region_id} not found")
        self.region_id = region_id


class DataIsNotReady(Exception):
    """A stale read's read_ts is above this replica's resolved-ts
    watermark (kvproto errorpb DataIsNotReady): serving it could miss a
    commit still in flight below read_ts.  The client falls back to a
    leader or ReadIndex replica read."""

    def __init__(self, region_id: int, safe_ts: int, read_ts: int):
        super().__init__(f"region {region_id}: read_ts {read_ts} > "
                         f"resolved_ts {safe_ts}")
        self.region_id = region_id
        self.safe_ts = safe_ts
        self.read_ts = read_ts


class RegionMerging(Exception):
    """Writes rejected while a PrepareMerge is in flight (reference:
    raftstore Error::ProposalInMergingMode) — retryable after the merge
    commits or rolls back."""

    def __init__(self, region_id: int):
        super().__init__(f"region {region_id} is merging")
        self.region_id = region_id


class InconsistentRegion(Exception):
    """Consistency check failed: this replica's data digest differs from
    the leader's at the same applied index (the reference panics —
    fsm/apply.rs exec_verify_hash)."""
