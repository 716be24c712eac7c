"""The cold build of a region's columnar snapshot from its MVCC versions.

Counterpart of the JAX package's ``copr/region_cache.py``, trimmed to the
device rung of its build ladder (``_build_device``, :296-397) from the
parsed version planes on, and to the snapshot it yields:

- ``build_region_columnar_device``: the host mirror of the resolution
  (the snapshot's rows, host truth) and the ``ColdFeedBundle`` from which
  the runner's first feed miss mints the feed on the device;
- ``MvccColumnarSnapshot``: the columnar view at one read timestamp, with a
  ``FeedLineage`` that carries the bundle to the runner.

Not ported yet (ROADMAP.md queue 1 items 6 and 8): the snapshot read of
the CF_WRITE range, its native parse into planes, the streaming ingest,
the delta journal of the lineage, the lock check and the host rungs.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np

from ..executors.columnar import ColumnarTable


def build_region_columnar_device(planes, table, col_infos: Sequence,
                                 read_ts: int, resolver,
                                 defaults: Optional[dict] = None,
                                 device_planes=None):
    """Resolve ``planes`` (``device.mvcc.WritePlanes`` of ``table``'s
    record range) at ``read_ts`` on the host and stage the device resolve.

    ``defaults``: {version row: {col_id: value}}, the cells of the PUTs
    whose row lives in CF_DEFAULT (the caller fetched and decoded them);
    ``device_planes``: the same planes already on the card
    (``DeviceVersionPlanes``), or None to upload them at the mint.

    → (ColumnarTable, safe_ts, ColdFeedBundle), or None when the planes
    cannot serve the schema (a column outside the device envelope, a
    read_ts the device cannot compare, a spilled row without its cells).
    Raises ValueError when two visible versions of one key share a
    commit_ts (no CF_WRITE range holds that: it is its key)."""
    from ..device.mvcc import (ColdFeedBundle, align_planes, host_mirror,
                               resolve_host)
    if resolver is None or not 0 <= read_ts < 1 << 63:
        return None
    planes = align_planes(planes, col_infos)
    if planes is None:
        return None
    winners = resolve_host(planes, read_ts)
    n = len(winners)
    handles, columns = host_mirror(planes, winners, col_infos)
    if n > 1 and not bool(np.all(handles[1:] > handles[:-1])):
        raise ValueError("two visible versions of one key share a "
                         "commit_ts")
    # CF_DEFAULT spills among the WINNERS only: a superseded version's
    # row is never fetched
    spill_patches: dict = {}
    if planes.need_default:
        spill_rows = np.nonzero(planes.has_payload[winners] == 0)[0]
        for fr in spill_rows.tolist():
            payload = (defaults or {}).get(int(winners[fr]))
            if payload is None:
                return None     # the row's cells are not known
            for info in col_infos:
                if info.is_pk_handle:
                    continue
                pv = payload.get(info.col_id)
                if pv is not None:
                    col = columns[info.col_id]
                    col.values[fr] = pv
                    col.validity[fr] = True
            spill_patches[fr] = True
    tbl = ColumnarTable(table, handles, columns)
    bundle = ColdFeedBundle(resolver, planes, device_planes, n, read_ts,
                            handles, columns, spill_patches=spill_patches)
    return tbl, int(planes.safe_ts), bundle


class FeedLineage:
    """What a snapshot hands the runner beside its rows: the one-shot cold
    bundle (the reference's lineage also journals deltas; not ported)."""

    __slots__ = ("cold_bundle", "_mu")

    def __init__(self):
        self.cold_bundle = None
        self._mu = threading.Lock()

    def stash_cold(self, bundle) -> None:
        with self._mu:
            old, self.cold_bundle = self.cold_bundle, bundle
        if old is not None:
            old.release()

    def take_cold(self):
        """Pop the cold bundle (one-shot), or None."""
        with self._mu:
            b, self.cold_bundle = self.cold_bundle, None
        return b

    def drop_cold(self) -> None:
        b = self.take_cold()
        if b is not None:
            b.release()


class MvccColumnarSnapshot:
    """Columnar view of one region's table slice at a pinned read_ts: the
    scan feed of the runner (``scan_columns``, ``count_rows``,
    ``gather_rows``) over the host mirror, and the ``feed_lineage`` that
    carries a cold bundle to the runner's first feed miss."""

    def __init__(self, tbl: ColumnarTable, build_ts: int, safe_ts: int,
                 bundle=None):
        self._tbl = tbl
        self.build_ts = build_ts
        self.safe_ts = safe_ts
        self.feed_lineage = FeedLineage()
        if bundle is not None:
            self.feed_lineage.stash_cold(bundle)

    def scan_columns(self, desc, ranges):
        return self._tbl.scan_columns(desc, ranges)

    def count_rows(self, ranges) -> int:
        return self._tbl.count_rows(ranges)

    def gather_rows(self, desc, ranges, rows):
        return self._tbl.gather_rows(desc, ranges, rows)

    def to_kv_pairs(self, ranges=None):
        """Logical row pairs for the CHECKSUM request."""
        return self._tbl.to_kv_pairs(ranges)

    def estimated_rows(self) -> int:
        return len(self._tbl)
