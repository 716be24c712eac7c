"""Coprocessor observer host — the apply-path event seam.

A copy of the JAX package's ``raftstore/observer.py`` (reference:
components/raftstore/src/coprocessor/mod.rs:98-594).  Observers see
committed apply events in order, plus region and role changes.  Unlike
the reference's host, which swallows an observer's exception, this one
raises it once every observer has seen the event: the port's observers
refuse their own inputs without raising, so what raises is a fault (a
split kernel that fails to build or launch), never a fallback.

Events delivered:
- ``on_apply_write(region_id, index, ops)``: the data WriteOps of one
  applied entry, after the engine write succeeded;
- ``on_data_replaced(region_id, index)``: the region's data was replaced
  wholesale at ``index`` (snapshot apply);
- ``on_region_split(left, right, left_index, right_index)``: a split was
  just executed, before the generic ``on_region_changed`` fires for the
  surviving left region — subscribers that can serve the split
  incrementally (the device-side line and feed slicing) act here;
  ``right_index`` is None when no right peer was materialized on this
  store.  The generic event still follows;
- ``on_region_changed(region)``: split/merge/conf-change/snapshot;
- ``on_role_change(region_id, is_leader)``: leadership transitions;
- ``on_peer_destroyed(region_id)``: the peer was removed from this store.
"""

from __future__ import annotations

from typing import Sequence


class Observer:
    """Base observer: override what you need."""

    def on_apply_write(self, region_id: int, index: int,
                       ops: Sequence) -> None:
        pass

    def on_data_replaced(self, region_id: int, index: int) -> None:
        pass

    def on_region_split(self, left, right, left_index, right_index) -> None:
        pass

    def on_region_changed(self, region) -> None:
        pass

    def on_role_change(self, region_id: int, is_leader: bool) -> None:
        pass

    def on_peer_destroyed(self, region_id: int) -> None:
        pass


class CoprocessorHost:
    """Observer registry attached to one store.

    Dispatch is synchronous on the apply path.  Every observer sees each
    event; the first exception an observer raised is raised after the
    last one has seen it.
    """

    def __init__(self):
        self._observers: list = []

    def register(self, obs: Observer) -> None:
        self._observers.append(obs)

    def unregister(self, obs: Observer) -> None:
        try:
            self._observers.remove(obs)
        except ValueError:
            pass

    def _notify(self, event: str, *args) -> None:
        first = None
        for obs in self._observers:
            try:
                getattr(obs, event)(*args)
            except Exception as e:   # noqa: BLE001 — raised below
                first = first or e
        if first is not None:
            raise first

    def notify_apply_write(self, region_id: int, index: int,
                           ops: Sequence) -> None:
        self._notify("on_apply_write", region_id, index, ops)

    def notify_data_replaced(self, region_id: int, index: int) -> None:
        self._notify("on_data_replaced", region_id, index)

    def notify_region_split(self, left, right, left_index,
                            right_index) -> None:
        self._notify("on_region_split", left, right, left_index,
                     right_index)

    def notify_region_changed(self, region) -> None:
        self._notify("on_region_changed", region)

    def notify_role_change(self, region_id: int, is_leader: bool) -> None:
        self._notify("on_role_change", region_id, is_leader)

    def notify_peer_destroyed(self, region_id: int) -> None:
        self._notify("on_peer_destroyed", region_id)
