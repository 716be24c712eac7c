"""Cluster metadata types.

A trimmed copy of the JAX package's ``raftstore/metapb.py`` (reference:
the kvproto ``metapb`` messages): ``Peer``, ``RegionEpoch``, ``Region``
and the region errors a region-clamped read raises.
"""

from __future__ import annotations

from dataclasses import dataclass


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


class EpochNotMatch(Exception):
    def __init__(self, current: Region):
        super().__init__(f"epoch not match; current {current.epoch}")
        self.current = current


class KeyNotInRegion(Exception):
    def __init__(self, key: bytes, region: Region):
        super().__init__(f"{key!r} not in region {region.id}")
        self.key = key
        self.region = region
