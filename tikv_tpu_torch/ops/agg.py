"""Aggregate specs, the torch tile reductions, and the host finalize.

Reference: components/tidb_query_aggr (impl_count.rs, impl_sum.rs,
impl_avg.rs, impl_max_min.rs, impl_first.rs, impl_variance.rs).  States
are dense arrays over the slot layout (G = group capacity; G = 1 for a
simple aggregation):

- COUNT  → {"count": i64[G]}
- SUM    → {"sum": v[G], "nonnull": i64[G]}     (SUM of all-NULL is NULL)
- AVG    → {"sum": v[G], "count": i64[G]}
- MIN    → {"min": v[G] (identity-filled), "nonnull": i64[G]}
- MAX    → symmetric
- FIRST  → {"value": v, "pos": i64, "ok": i64} (simple; pos = the first
  selected row, NULL or not, int64 max when none; ok = that row's
  validity, as TiKV's ``AggrFnFirst``); {"pos": i64[G]} (hash)
- VAR_*  → {"sum": f64[G], "sumsq": f64[G], "count": i64[G]}

Integer sums accumulate in int64; REAL sums in float64 (the reference
keeps a float32 tile sum and widens between tiles — float64 here only
makes the sum closer to exact).  MIN/MAX keep the value dtype.

Hash layout: slots [0, G) are groups (``key - base`` dense, or the rank
among the distinct keys when sparse), slot G the NULL-key group, slot
G+1 scrap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..datatype import EvalType


@dataclass(frozen=True)
class AggSpec:
    """One aggregate function instance in a plan.

    ``kind``: count | count_star | sum | avg | min | max | first |
    var_pop | var_samp | stddev_pop | stddev_samp.  ``arg``: position of
    the aggregate among the plan's aggregates (ignored for count_star).
    """

    kind: str
    arg: int = 0
    eval_type: EvalType = EvalType.INT


VAR_KINDS = ("var_pop", "var_samp", "stddev_pop", "stddev_samp")

_BIG = np.iinfo(np.int64).max


def _finalize_var(kind: str, s: float, sq: float, c: int):
    """(sum, sumsq, count) → variance/stddev, the reference device
    finalize's formula; MySQL NULLability: *_pop NULL when count=0,
    *_samp NULL when count<2."""
    if kind in ("var_samp", "stddev_samp"):
        if c < 2:
            return None
        var = max(0.0, (sq - s * s / c) / (c - 1))
    else:
        if c == 0:
            return None
        var = max(0.0, sq / c - (s / c) ** 2)
    if kind.startswith("stddev"):
        return float(np.sqrt(var))
    return var


def _acc_dtype(values: torch.Tensor) -> torch.dtype:
    """Accumulator dtype: integer sums widen to int64, real ones to
    float64 (torch dtypes carry no numpy ``kind``)."""
    return torch.float64 if values.dtype.is_floating_point else torch.int64


# MIN/MAX identities per device value dtype (torch has no np.iinfo-style
# scalar constructors to derive them from a dtype generically)
_MINMAX_IDENTITY = {
    torch.int32: (np.iinfo(np.int32).max, np.iinfo(np.int32).min),
    torch.int64: (np.iinfo(np.int64).max, np.iinfo(np.int64).min),
    torch.float32: (float("inf"), float("-inf")),
    torch.float64: (float("inf"), float("-inf")),
}


def _minmax_identity(dtype: torch.dtype, is_min: bool):
    try:
        lo_ident, hi_ident = _MINMAX_IDENTITY[dtype]
    except KeyError:
        raise ValueError(f"MIN/MAX over {dtype} has no device form") from None
    return lo_ident if is_min else hi_ident


def _masked(values, ok, fill=0):
    return torch.where(ok, values, torch.full_like(values, fill))


# ---------------------------------------------------------------------------
# Simple (single-group) aggregation — reference: simple_aggr_executor.rs
# ---------------------------------------------------------------------------

def simple_agg_tile(specs: Sequence[AggSpec], cols: Sequence[tuple],
                    n_valid_rows, row_mask=None) -> list:
    """Reduce the rows to per-spec scalar (0-d tensor) states.

    ``cols[i]``: (values, validity) of spec i, validity already ANDed with
    the row mask.  ``n_valid_rows``: the masked row count (COUNT(*)).
    ``row_mask``: the selection (None: every row), where FIRST takes its
    row.
    """
    states = []
    for spec in specs:
        if spec.kind == "count_star":
            states.append({"count": torch.as_tensor(n_valid_rows,
                                                    dtype=torch.int64)})
            continue
        values, ok = cols[spec.arg]
        nonnull = ok.sum(dtype=torch.int64)
        if spec.kind == "count":
            states.append({"count": nonnull})
        elif spec.kind in ("sum", "avg"):
            s = _masked(values, ok).sum(dtype=_acc_dtype(values))
            states.append({"sum": s, "nonnull": nonnull} if spec.kind == "sum"
                          else {"sum": s, "count": nonnull})
        elif spec.kind in ("min", "max"):
            is_min = spec.kind == "min"
            filled = _masked(values, ok, _minmax_identity(values.dtype,
                                                          is_min))
            states.append({spec.kind: filled.amin() if is_min
                           else filled.amax(), "nonnull": nonnull})
        elif spec.kind == "first":
            # the first selected row, whatever its validity: a NULL there
            # makes the answer NULL (the reference's device skips it)
            n = values.shape[0]
            rows = torch.arange(n, dtype=torch.int64, device=values.device)
            pos = (rows if row_mask is None
                   else _masked(rows, row_mask, _BIG)).amin()
            at = pos.clamp(max=max(n - 1, 0))
            states.append({"value": values[at], "pos": pos,
                           "ok": (ok[at] & (pos != _BIG)).to(torch.int64)})
        elif spec.kind in VAR_KINDS:
            v64 = _masked(values, ok).to(torch.float64)
            states.append({"sum": v64.sum(), "sumsq": (v64 * v64).sum(),
                           "count": nonnull})
        else:
            raise ValueError(f"{spec.kind} has no device tile reduction")
    return states


def finalize_simple(specs, states: list) -> list:
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
        elif spec.kind in ("min", "max"):
            out.append(None if int(s["nonnull"]) == 0
                       else np.asarray(s[spec.kind]).item())
        elif spec.kind == "first":
            out.append(None if int(s["pos"]) == _BIG or not int(s["ok"])
                       else np.asarray(s["value"]).item())
        elif spec.kind in VAR_KINDS:
            out.append(_finalize_var(spec.kind, float(s["sum"]),
                                     float(s["sumsq"]), int(s["count"])))
        else:
            raise ValueError(f"finalize_simple: {spec.kind} unsupported")
    return out


# ---------------------------------------------------------------------------
# Hash (group-by) aggregation — reference: fast_hash_aggr_executor.rs
# ---------------------------------------------------------------------------

def hash_slots(key: tuple, capacity: int, base, row_mask):
    """(idx int64 slot per row, overflow 0-d bool) in the hash layout.

    ``base``: the dense key minimum, or ``("precomp", slot ids)`` for a
    sparse recode (the NULL slot already filled in; only the row mask is
    applied here).  A live key outside [base, base + capacity) raises
    ``overflow`` and lands in the scrap slot.
    """
    scrap = capacity + 1
    if isinstance(base, tuple):
        idx = torch.where(row_mask, base[1].to(torch.int64),
                          torch.full_like(row_mask, scrap, dtype=torch.int64))
        return idx, torch.zeros((), dtype=torch.bool, device=row_mask.device)
    kv, km = key
    shifted = kv.to(torch.int64) - int(base)
    in_range = (shifted >= 0) & (shifted < capacity)
    idx = torch.where(km, torch.where(in_range, shifted,
                                      torch.full_like(shifted, scrap)),
                      torch.full_like(shifted, capacity))
    idx = torch.where(row_mask, idx, torch.full_like(idx, scrap))
    return idx, (row_mask & km & ~in_range).any()


def _scatter_add(slots, idx, vals, dtype):
    out = torch.zeros(slots, dtype=dtype, device=idx.device)
    return out.index_add_(0, idx, vals.to(dtype))


def hash_agg_tile(specs: Sequence[AggSpec], key: tuple,
                  cols: Sequence[tuple], capacity: int, base,
                  row_mask) -> dict:
    """Direct-index group-by over the rows.

    ``key``: (values, validity) int key pair; ``cols[i]``: (values,
    validity) of spec i; ``row_mask``: the selection.  Returns
    {"present": bool[C+2], "overflow": 0-d bool, "states": [per-spec dict
    of (C+2,) tensors]}.  ``present`` is the masked row count > 0.
    """
    slots = capacity + 2
    idx, overflow = hash_slots(key, capacity, base, row_mask)
    rows = _scatter_add(slots, idx, row_mask, torch.int64)
    states = []
    for spec in specs:
        if spec.kind == "count_star":
            states.append({"count": rows})
            continue
        values, validity = cols[spec.arg]
        ok = row_mask & validity
        nonnull = _scatter_add(slots, idx, ok, torch.int64)
        if spec.kind == "count":
            states.append({"count": nonnull})
        elif spec.kind in ("sum", "avg"):
            acc = _acc_dtype(values)
            s = _scatter_add(slots, idx, _masked(values, ok), acc)
            states.append({"sum": s, "nonnull": nonnull} if spec.kind == "sum"
                          else {"sum": s, "count": nonnull})
        elif spec.kind in ("min", "max"):
            is_min = spec.kind == "min"
            ident = _minmax_identity(values.dtype, is_min)
            t = torch.full((slots,), ident, dtype=values.dtype,
                           device=values.device)
            t.scatter_reduce_(0, idx, _masked(values, ok, ident),
                              reduce="amin" if is_min else "amax",
                              include_self=True)
            states.append({spec.kind: t, "nonnull": nonnull})
        elif spec.kind == "first":
            p = torch.full((slots,), _BIG, dtype=torch.int64,
                           device=values.device)
            rowpos = torch.arange(values.shape[0], dtype=torch.int64,
                                  device=values.device)
            p.scatter_reduce_(0, idx, _masked(rowpos, ok, _BIG),
                              reduce="amin", include_self=True)
            states.append({"pos": p})
        elif spec.kind in VAR_KINDS:
            v64 = _masked(values, ok).to(torch.float64)
            states.append({
                "sum": _scatter_add(slots, idx, v64, torch.float64),
                "sumsq": _scatter_add(slots, idx, v64 * v64, torch.float64),
                "count": nonnull})
        else:
            raise ValueError(f"{spec.kind} has no device tile reduction")
    return {"present": rows > 0, "overflow": overflow, "states": states}


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
        elif spec.kind in ("min", "max"):
            vals = np.asarray(s[spec.kind])[sel]
            nn = np.asarray(s["nonnull"])[sel]
            results.append([None if c == 0 else vals[i].item()
                            for i, c in enumerate(nn)])
        elif spec.kind in VAR_KINDS:
            sums = np.asarray(s["sum"])[sel]
            sqs = np.asarray(s["sumsq"])[sel]
            cnt = np.asarray(s["count"])[sel]
            results.append([_finalize_var(spec.kind, float(sums[i]),
                                          float(sqs[i]), int(c))
                            for i, c in enumerate(cnt)])
        else:
            raise ValueError(f"finalize_hash: {spec.kind} unsupported")
    return keys, results
