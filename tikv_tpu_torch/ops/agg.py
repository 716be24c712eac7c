"""Aggregate specs and the host finalize of COUNT/SUM/AVG states.

Reference: components/tidb_query_aggr (impl_count.rs, impl_sum.rs,
impl_avg.rs).  States are dense int64 arrays over the slot layout
(G = group capacity; G = 1 for a simple aggregation):

- COUNT  → {"count": i64[G]}
- SUM    → {"sum": i64[G], "nonnull": i64[G]}     (SUM of all-NULL is NULL)
- AVG    → {"sum": i64[G], "count": i64[G]}

Hash layout: slots [0, G) are groups (``key - base`` dense, or the rank
among the distinct keys when sparse), slot G the NULL-key group, slot
G+1 scrap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..datatype import EvalType


@dataclass(frozen=True)
class AggSpec:
    """One aggregate function instance in a plan.

    ``kind``: count | count_star | sum | avg.  ``arg``: position of the
    aggregate among the plan's aggregates (ignored for count_star).
    """

    kind: str
    arg: int = 0
    eval_type: EvalType = EvalType.INT


def finalize_simple(specs, states: list[dict]) -> list:
    """Produce final scalar results (Python values; None = NULL)."""
    out = []
    for spec, s in zip(specs, states):
        if spec.kind in ("count", "count_star"):
            out.append(int(s["count"]))
        elif spec.kind == "sum":
            out.append(None if int(s["nonnull"]) == 0
                       else np.asarray(s["sum"]).item())
        elif spec.kind == "avg":
            c = int(s["count"])
            out.append(None if c == 0 else float(s["sum"]) / c)
        else:
            raise ValueError(f"finalize_simple: {spec.kind} unsupported")
    return out


def finalize_hash(specs, state: dict, base: int, capacity: int,
                  slot_keys=None):
    """Produce (group_keys, per-spec result columns) for present groups.

    Groups are emitted in ascending key order (deterministic), NULL group
    last.  ``slot_keys``: sparse recode — per-slot key values (sorted
    distinct keys) instead of the dense ``slot + base`` arithmetic.
    Returns (keys: list[Optional[int]], results: list[list]).
    """
    present = np.asarray(state["present"])
    slots = np.nonzero(present[:capacity])[0]
    has_null = bool(present[capacity])
    if slot_keys is not None:
        keys: list[Optional[int]] = [int(slot_keys[s]) for s in slots]
    else:
        keys = [int(s) + base for s in slots]
    all_slots = list(slots)
    if has_null:
        keys.append(None)
        all_slots.append(capacity)
    sel = np.asarray(all_slots, dtype=np.int64)

    results = []
    for spec, s in zip(specs, state["states"]):
        if spec.kind in ("count", "count_star"):
            results.append([int(x) for x in np.asarray(s["count"])[sel]])
        elif spec.kind == "sum":
            sums = np.asarray(s["sum"])[sel]
            nn = np.asarray(s["nonnull"])[sel]
            results.append([None if c == 0 else sums[i].item()
                            for i, c in enumerate(nn)])
        elif spec.kind == "avg":
            sums = np.asarray(s["sum"])[sel]
            cnt = np.asarray(s["count"])[sel]
            results.append([None if c == 0 else float(sums[i]) / int(c)
                            for i, c in enumerate(cnt)])
        else:
            raise ValueError(f"finalize_hash: {spec.kind} unsupported")
    return keys, results
