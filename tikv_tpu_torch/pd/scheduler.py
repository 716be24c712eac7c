"""Slice placement policy: PD's balance-region scheduler applied to a
node's mesh slices.

A trimmed copy of the JAX package's ``pd/scheduler.py`` (:44-110, :192):
only the pure functions over per-slice score lists that
``device/placement.py`` drives — the receiver pick, the one-step
rebalance, the drain spread and the score blend.  The score of a slice
blends its resident feed bytes (the capacity half) with its decayed
dispatch load (the traffic half); the placer normalizes both and adds
each slice's health penalty.  The tie orders and the all-excluded
fallback are the reference's.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence


def pick_slice(scores: Sequence[float],
               exclude: Sequence[int] = ()) -> int:
    """The least-loaded slice index, ties to the lowest index, never one in
    ``exclude`` — unless every slice is excluded: then the least-loaded
    one anyway (a degraded placement beats none)."""
    best = None
    for i, s in enumerate(scores):
        if i in exclude:
            continue
        if best is None or s < scores[best]:
            best = i
    if best is None:
        best = min(range(len(scores)), key=lambda i: scores[i])
    return best


def rebalance_donor(scores: Sequence[float],
                    min_ratio: float = 2.0,
                    min_gap: float = 1.0) -> Optional[tuple[int, int]]:
    """→ (donor, receiver) when the hottest slice carries at least
    ``min_ratio`` times the coolest's score and ``min_gap`` more, else
    None (two near-idle slices never trade feeds back and forth)."""
    if len(scores) < 2:
        return None
    hot = max(range(len(scores)), key=lambda i: scores[i])
    cool = min(range(len(scores)), key=lambda i: scores[i])
    if hot == cool:
        return None
    if scores[hot] < min_gap + scores[cool]:
        return None
    if scores[hot] < min_ratio * max(scores[cool], 1e-9):
        return None
    return hot, cool


def drain_receivers(scores: Sequence[float], exclude,
                    k: int) -> list[int]:
    """``k`` receivers for a tripped slice's anchors: the healthy slices in
    ascending score order, round-robin (never one receiver for all); empty
    when every slice is excluded."""
    order = sorted((i for i in range(len(scores)) if i not in exclude),
                   key=lambda i: scores[i])
    if not order:
        return []
    return [order[j % len(order)] for j in range(k)]


def slice_scores(occupancy: Mapping[int, float],
                 load: Mapping[int, float], n_slices: int,
                 occupancy_weight: float = 1.0,
                 load_weight: float = 1.0) -> list[float]:
    """Per-slice occupancy and load (both normalized by the caller)
    blended into one score list."""
    return [occupancy_weight * float(occupancy.get(i, 0.0))
            + load_weight * float(load.get(i, 0.0))
            for i in range(n_slices)]
