"""The engine snapshot clamped to one region.

A trimmed copy of the JAX package's ``raftstore/peer.py``: only
``RegionSnapshot`` (reference: raftstore RegionSnapshot) and
``region_data_bounds`` (``raftstore/peer_storage.py``).
"""

from __future__ import annotations

from typing import Optional

from ..codec.keys import DATA_PREFIX, data_key
from ..engine.traits import CF_DEFAULT
from .metapb import KeyNotInRegion, Region


def region_data_bounds(region: Region) -> tuple:
    """The region's [lower, upper) in the engine's data-key space."""
    lower = DATA_PREFIX + region.start_key
    upper = DATA_PREFIX + region.end_key if region.end_key else \
        bytes([DATA_PREFIX[0] + 1])
    return lower, upper


class RegionSnapshot:
    """Engine snapshot clamped to one region, with the data-key prefix
    applied transparently.

    ``data_index`` stamps the last applied data-mutating entry index — the
    snapshot's data version for the columnar cache (read barriers and
    leader noops do not bump it, so repeated reads share a version).
    """

    data_index: Optional[int] = None
    apply_index: Optional[int] = None

    def __init__(self, snap, region: Region):
        self._snap = snap
        self.region = region

    def _check(self, key: bytes) -> bytes:
        if not self.region.contains(key):
            raise KeyNotInRegion(key, self.region)
        return data_key(key)

    def get_value_cf(self, cf: str, key: bytes):
        return self._snap.get_value_cf(cf, self._check(key))

    def get_value(self, key: bytes):
        return self.get_value_cf(CF_DEFAULT, key)

    def iterator_cf(self, cf: str, lower: Optional[bytes] = None,
                    upper: Optional[bytes] = None):
        rlo, rhi = region_data_bounds(self.region)
        lo = rlo if lower is None else max(rlo, data_key(lower))
        hi = rhi if upper is None else min(rhi, data_key(upper))
        return _PrefixStripIterator(self._snap.iterator_cf(cf, lo, hi))

    def range_cf(self, cf: str, lower: bytes, upper: bytes):
        """Bulk range read clamped to the region → (keys, values,
        prefix_skip); keys keep the data-key prefix, which prefix_skip
        counts."""
        rng = getattr(self._snap, "range_cf", None)
        if rng is None:
            return None
        rlo, rhi = region_data_bounds(self.region)
        lo = max(rlo, data_key(lower))
        hi = min(rhi, data_key(upper))
        if lo >= hi:
            return [], [], 0
        keys, vals, skip = rng(cf, lo, hi)
        return keys, vals, skip + 1


class _PrefixStripIterator:
    """Strips the data-key prefix so the layers above see user keys."""

    def __init__(self, it):
        self._it = it

    def valid(self):
        return self._it.valid()

    def seek(self, key: bytes):
        return self._it.seek(data_key(key))

    def seek_for_prev(self, key: bytes):
        return self._it.seek_for_prev(data_key(key))

    def seek_to_first(self):
        return self._it.seek_to_first()

    def seek_to_last(self):
        return self._it.seek_to_last()

    def next(self):
        return self._it.next()

    def prev(self):
        return self._it.prev()

    def key(self) -> bytes:
        return self._it.key()[len(DATA_PREFIX):]

    def value(self) -> bytes:
        return self._it.value()
