"""Hot-region → mesh-slice placement: the scale-out half of a mesh.

Counterpart of the JAX package's ``device/placement.py`` without its join
co-location (``note_join``, ``colocated``, ``_partner_slice_locked``) and
without metrics.  A node with several cards can shard one large region's
feed over every card (scale-up, ``DeviceRunner(mesh=...)``), or keep many
small regions' feeds each whole on one card, so that concurrent requests
each run on one card (scale-out).  ``SlicePlacer`` owns one single-device
sub-runner per mesh slice (``parallel.mesh_slices``; a mesh may repeat a
device, so four slices may share one card) and routes each request's feed
anchor to one:

- a feed of ``whole_mesh_rows`` rows or more (by the snapshot's
  ``estimated_rows``) stays on the whole-mesh root runner; an anchor that
  grew past it "graduates" there and its slice copy is dropped;
- a new anchor is pinned to the slice ``pd.scheduler.pick_slice`` picks
  over a blend of each slice's resident bytes and its decayed dispatch
  load (half-life ``LOAD_HALFLIFE_S``), each normalized by its largest,
  plus the slice's health penalty; the pin is sticky, keyed by
  ``id(anchor)`` with a weakref that forgets it;
- every ``REBALANCE_EVERY`` routes, ``rebalance`` moves the coldest anchor
  off the hottest slice when ``pd.scheduler.rebalance_donor`` finds the
  spread unjustified.

A move is a migration (``migrate``): the source's ``extract_feeds``, a
device-to-device copy and the destination's ``install_feeds``, whose
arrival check is one ``feed_verify`` launch over the feed's planes.  A feed
that fails the check is dropped on both sides (the source quarantined),
and its next request mints it again from the host.

The slices are failure domains.  The root runner's ``SliceHealthBoard``
scores them; on a trip (``_on_slice_trip``) every anchor of the dead slice
migrates to the healthy slices ``drain_receivers`` spreads them over, and
a route that still finds an anchor pinned to a quarantined slice fails it
over on the spot — unless every slice is quarantined: then the pin stays
and the refusal gate serves on the host, with no failover churn.  Routing
runs the half-open canaries of quarantined slices whose cooldown passed.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Optional

from ..parallel import make_mesh, mesh_slices
from ..pd.scheduler import (drain_receivers, pick_slice, rebalance_donor,
                            slice_scores)

# feeds of this many rows or more shard over the whole mesh
DEFAULT_WHOLE_MESH_ROWS = 1 << 22
# half-life of the decayed dispatch load, seconds
LOAD_HALFLIFE_S = 30.0
# the rebalance check runs every this many routes
REBALANCE_EVERY = 64


class SlicePlacer:
    """One single-device sub-runner per slice of ``parent``'s mesh, and the
    placement of feed anchors over them.  The counters ``places``,
    ``failovers``, ``moves``, ``drained``, ``migrations``, ``migration_ms``,
    ``last_migration_ms``, ``migration_failures``, ``feeds_moved``,
    ``adoptions`` and ``whole_mesh_routes`` are read by ``stats``."""

    def __init__(self, parent, whole_mesh_rows: int = DEFAULT_WHOLE_MESH_ROWS):
        self._parent = parent
        self.whole_mesh_rows = whole_mesh_rows
        self._mu = threading.Lock()
        self._slices = [parent._make_slice_runner(make_mesh(devs),
                                                  slice_indices=(i,),
                                                  bind_health=True)
                        for i, devs in enumerate(mesh_slices(parent._mesh))]
        if parent._arena.budget_bytes > 0:
            self.set_hbm_budget(parent._arena.budget_bytes)
        self._load = [0.0] * len(self._slices)
        self._load_t = time.monotonic()
        # id(anchor) → slice index; the weakrefs forget dead anchors
        self._placed: dict = {}
        self._refs: dict = {}
        self._routes = 0
        self.places = 0
        self.moves = 0
        self.whole_mesh_routes = 0
        self._board = parent._board
        self.failovers = 0
        self.drained = 0
        self.migrations = 0
        self.migration_ms = 0.0
        self.last_migration_ms = 0.0
        # the destination's host-clock copy / verify / install ms of the
        # last migration that moved
        self.last_migration_phases: dict = {}
        self.migration_failures = 0
        # feeds that arrived and passed their check, over every migration
        self.feeds_moved = 0
        self.adoptions = 0
        if self._board is not None:
            self._board.add_trip_listener(self._on_slice_trip)

    @property
    def slices(self) -> list:
        return list(self._slices)

    # -- scoring ------------------------------------------------------

    def _decay_locked(self) -> None:
        now = time.monotonic()
        dt = now - self._load_t
        if dt <= 0:
            return
        f = 0.5 ** (dt / LOAD_HALFLIFE_S)
        self._load = [v * f for v in self._load]
        self._load_t = now

    def _scores_locked(self) -> list:
        """Each slice's resident bytes and load, each over its largest,
        blended, plus its health penalty."""
        self._decay_locked()
        occ = {i: r._arena.resident_bytes()
               for i, r in enumerate(self._slices)}
        mx_b = max(occ.values(), default=0) or 1
        mx_l = max(self._load, default=0.0) or 1.0
        scores = slice_scores({i: b / mx_b for i, b in occ.items()},
                              {i: v / mx_l for i, v in enumerate(self._load)},
                              len(self._slices))
        if self._board is not None:
            scores = [s + self._board.penalty(i)
                      for i, s in enumerate(scores)]
        return scores

    def scores(self) -> list:
        with self._mu:
            return self._scores_locked()

    def _dead_locked(self) -> frozenset:
        return self._board.quarantined_set() \
            if self._board is not None else frozenset()

    def _pin_locked(self, anchor, key: int, idx: int) -> bool:
        """Pin ``anchor`` to slice ``idx`` → False when it cannot be
        tracked (not weak-referenceable)."""
        try:
            self._refs[key] = weakref.ref(
                anchor, lambda _r, k=key: self._forget(k))
        except TypeError:
            return False
        self._placed[key] = idx
        return True

    # -- routing ------------------------------------------------------

    def route(self, storage, n_hint: Optional[int] = None):
        """→ the runner that serves this request: its anchor's slice
        runner, or the root for a whole-mesh feed or an untrackable
        anchor (placement.py:279-357)."""
        anchor = self._parent._feed_anchor(storage)
        if n_hint is None:
            est = getattr(storage, "estimated_rows", None)
            n_hint = est() if callable(est) else None
        key = id(anchor)
        if n_hint is not None and n_hint >= self.whole_mesh_rows:
            with self._mu:
                self.whole_mesh_routes += 1
                # an anchor that grew past the threshold graduates: its
                # slice copy would sit there unused
                idx = self._placed.pop(key, None)
                self._refs.pop(key, None)
            if idx is not None:
                self._slices[idx].drop_feed(anchor)
            return self._parent
        self._parent.probe_quarantined()
        failover_from = None
        with self._mu:
            dead = self._dead_locked()
            idx = self._placed.get(key)
            if idx is not None and idx in dead and \
                    len(dead) < len(self._slices):
                # its slice died since: fail over now (with every slice
                # dead the pin stays and the refusal gate answers)
                failover_from, idx = idx, None
            if idx is None:
                idx = pick_slice(self._scores_locked(), exclude=dead)
                if not self._pin_locked(anchor, key, idx):
                    return self._parent
                if failover_from is None:
                    self.places += 1
                else:
                    self.failovers += 1
            self._load[idx] += 1.0
            self._routes += 1
            rebalance = self._routes % REBALANCE_EVERY == 0
        if failover_from is not None:
            self._slices[failover_from].drop_feed(anchor)
        if rebalance:
            self.rebalance()
        return self._slices[idx]

    def owner(self, anchor):
        """The slice runner ``anchor`` is pinned to, or None."""
        with self._mu:
            idx = self._placed.get(id(anchor))
        return None if idx is None else self._slices[idx]

    def _forget(self, key: int) -> None:
        with self._mu:
            self._placed.pop(key, None)
            self._refs.pop(key, None)

    def forget(self, anchor) -> None:
        self._forget(id(anchor))

    # -- migration ----------------------------------------------------

    def migrate(self, anchor, src: int, dst: int) -> bool:
        """Move ``anchor``'s resident feeds from slice ``src`` to ``dst`` →
        True when ``dst`` now holds them (placement.py:383-455).  The
        source's lock is taken to extract and the destination's to
        install, one after the other, never nested.  A feed whose arrival
        check fails is dropped on ``dst`` and quarantined on ``src``
        (False: its next request mints it again).  The pin flips to
        ``dst`` before the source copy is dropped; a request in flight on
        ``src`` keeps its planes through its arena pin."""
        if src == dst or not (0 <= src < len(self._slices)) or \
                not (0 <= dst < len(self._slices)):
            return False
        src_r, dst_r = self._slices[src], self._slices[dst]
        t0 = time.perf_counter()
        try:
            feeds, _skipped = src_r.extract_feeds(anchor)
        except Exception:   # noqa: BLE001 — a migration is best effort
            feeds = None
        if not feeds:
            with self._mu:
                self.migration_failures += 1
            return False
        try:
            verdict = dst_r.install_feeds(anchor, feeds)
        except Exception:   # noqa: BLE001 — a copy or check that raises
            verdict = "corrupt"
        if verdict != "moved":
            dst_r.drop_feed(anchor)
            try:
                src_r.quarantine(anchor, reason="migrate divergence")
            except Exception:   # noqa: BLE001
                pass
            with self._mu:
                self.migration_failures += 1
            return False
        key = id(anchor)
        ms = (time.perf_counter() - t0) * 1e3
        with self._mu:
            if key not in self._placed:
                self._pin_locked(anchor, key, dst)
            elif key in self._refs:
                self._placed[key] = dst
            self.migrations += 1
            self.feeds_moved += len(feeds)
            self.migration_ms += ms
            self.last_migration_ms = ms
            self.last_migration_phases = dict(dst_r.migrate_phases_ms)
        src_r.drop_feed(anchor)
        return True

    def adopt(self, parent, children) -> None:
        """Pin a split's children to the slice of their parent, where the
        device split stashed their feeds (placement.py:456)."""
        with self._mu:
            idx = self._placed.get(id(parent))
            if idx is None or idx in self._dead_locked():
                return
            for ch in children:
                if ch is not None and self._pin_locked(ch, id(ch), idx):
                    self.adoptions += 1

    # -- failure-domain drain -----------------------------------------

    def _on_slice_trip(self, idx: int, reason: str) -> None:
        """The board's trip listener (placement.py:485): every anchor of
        slice ``idx`` migrates to a healthy slice, round-robin over
        ``drain_receivers``; one that cannot (no receiver, or its check
        failed) is re-pinned there and its feeds dropped (minted again on
        its next request)."""
        with self._mu:
            victims = [k for k, v in self._placed.items() if v == idx]
            if not victims:
                return
            dead = self._dead_locked() | {idx}
            targets = drain_receivers(self._scores_locked(), exclude=dead,
                                      k=len(victims))
            moves = []
            for j, k in enumerate(victims):
                ref = self._refs.get(k)
                a = ref() if ref is not None else None
                if a is not None:
                    moves.append((a, targets[j] if targets else None))
            self.drained += len(victims)
        for a, tgt in moves:
            with self._mu:
                if self._placed.get(id(a)) != idx:
                    continue        # a route's failover came first
            moved = False
            if tgt is not None:
                try:
                    moved = self.migrate(a, idx, tgt)
                except Exception:   # noqa: BLE001 — the drain must finish
                    moved = False
            if not moved:
                if tgt is not None:
                    with self._mu:
                        if self._placed.get(id(a)) == idx:
                            self._placed[id(a)] = tgt
                self._slices[idx].drop_feed(a)

    # -- rebalance ----------------------------------------------------

    def rebalance(self) -> bool:
        """One balance step (placement.py:541): when ``rebalance_donor``
        finds the hottest slice's score unjustified, its coldest unpinned
        anchor (fewest arena hits, then least recent) moves to the coolest
        slice, by migration, else by re-pin and drop → True when one
        moved."""
        with self._mu:
            pair = rebalance_donor(self._scores_locked(), min_ratio=2.0,
                                   min_gap=0.25)
            if pair is None:
                return False
            hot, cool = pair
            if cool in self._dead_locked():
                return False
            donor = self._slices[hot]
            victim = v_stats = None
            for anchor, hits, tick, pins in donor._arena.entry_stats():
                if pins > 0 or self._placed.get(id(anchor)) != hot:
                    continue
                if v_stats is None or (hits, tick) < v_stats:
                    victim, v_stats = anchor, (hits, tick)
            if victim is None:
                return False
            self.moves += 1
        if not self.migrate(victim, hot, cool):
            with self._mu:
                self._placed[id(victim)] = cool
            donor.drop_feed(victim)
        return True

    # -- fan-out ------------------------------------------------------

    def drop_feed_all(self, anchor) -> int:
        freed = sum(r.drop_feed(anchor) for r in self._slices)
        self.forget(anchor)
        return freed

    def set_hbm_budget(self, parent_budget: int) -> None:
        """The node's budget split evenly over the slices (each holds its
        own anchors); the root keeps the whole for whole-mesh feeds."""
        share = parent_budget // len(self._slices) if parent_budget > 0 \
            else 0
        for r in self._slices:
            r.set_hbm_budget(share)

    def stats(self) -> dict:
        with self._mu:
            self._decay_locked()
            placed = [0] * len(self._slices)
            for idx in self._placed.values():
                placed[idx] += 1
            dead = self._dead_locked()
            return {
                "slices": [{"resident_bytes": r._arena.resident_bytes(),
                            "resident_lines":
                            r._arena.stats()["resident_lines"],
                            "load": round(self._load[i], 3),
                            "placed_anchors": placed[i],
                            "quarantined": i in dead}
                           for i, r in enumerate(self._slices)],
                "places": self.places, "moves": self.moves,
                "whole_mesh_routes": self.whole_mesh_routes,
                "failovers": self.failovers, "drained": self.drained,
                "migrations": self.migrations,
                "migration_ms": self.migration_ms,
                "last_migration_ms": self.last_migration_ms,
                "last_migration_phases": dict(self.last_migration_phases),
                "migration_failures": self.migration_failures,
                "feeds_moved": self.feeds_moved,
                "adoptions": self.adoptions}
