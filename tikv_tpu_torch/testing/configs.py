"""The benchmark configurations of the aggregation slices, as plain builders.

One table ``(id pk, k INT, v INT | REAL)`` with ``k`` uniform over
``groups`` values and ``v`` uniform over [-1000, 1000) (or, REAL, normal
with mean 0 and standard deviation 1000), made from a numpy seed (the JAX
package's ``bench.build_table`` / ``build_sparse_table`` draw the same
arrays from the same seed):

- config 3: SUM(v), COUNT(*), AVG(v) over 50·2^20 rows;
- config 4: GROUP BY k with COUNT(*) and SUM(v) over 100·2^20 rows,
  1024 groups;
- config 4s: config 4 with the 1024 keys drawn from [0, 2^62);
- config 4n: config 4's table with ``v`` NULL on 10% of the rows (a
  seeded mask); GROUP BY k: COUNT(*), COUNT(v), SUM(v), AVG(v);
- config 4w: config 4 with 65,536 groups;
- config 4r: REAL ``v``; GROUP BY k: SUM(v), AVG(v);
- config 4m: config 4's table; GROUP BY k: MIN(v), MAX(v), VAR_POP(v),
  STDDEV_SAMP(v);
- config 3n: config 3's table with ``v`` NULL on 10%; SUM(v), COUNT(v),
  AVG(v), MIN(v), MAX(v), FIRST(v).

``CONFIGS`` maps each name to its table builder and its plan.
"""

from __future__ import annotations

import numpy as np

from ..datatype import Column, EvalType, FieldType
from ..executors.columnar import ColumnarTable
from .dag import DagSelect
from .fixture import Table, TableColumn

GROUPS = 1024
WIDE_GROUPS = 1 << 16
NULL_SHARE = 0.1


def bench_table(real_v: bool = False) -> Table:
    return Table(99, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("v", 3, FieldType.double() if real_v
                    else FieldType.long(), index_id=2),
    ))


def build_table(n: int, groups: int = GROUPS, seed: int = 7,
                real_v: bool = False):
    """→ (table, snapshot) with dense keys in [0, groups)."""
    rng = np.random.default_rng(seed)
    table = bench_table(real_v)
    k = rng.integers(0, groups, n).astype(np.int64)
    if real_v:
        v = rng.normal(0.0, 1000.0, n)
    else:
        v = rng.integers(-1000, 1000, n).astype(np.int64)
    ones = np.ones(n, dtype=np.bool_)
    snap = ColumnarTable.from_arrays(
        table, np.arange(n, dtype=np.int64),
        {"k": Column(EvalType.INT, k, ones),
         "v": Column(EvalType.REAL if real_v else EvalType.INT, v, ones)})
    return table, snap


def build_sparse_table(n: int, groups: int = GROUPS, seed: int = 7):
    """Config-4 shape, but the ``groups`` distinct keys are drawn from
    [0, 2^62) — the arbitrary-int64 GROUP BY domain."""
    table, snap = build_table(n, groups, seed=seed)
    rng = np.random.default_rng(seed + 1)
    doms = np.sort(rng.integers(0, 1 << 62, groups))
    k = snap.columns[2]
    snap.columns[2] = Column(k.eval_type, doms[k.values % groups], k.validity)
    return table, snap


def build_null_table(n: int, groups: int = GROUPS, seed: int = 7):
    """Config-4 shape with ``v`` NULL on ``NULL_SHARE`` of the rows (a mask
    drawn from ``seed + 2``; a NULL slot holds 0)."""
    table, snap = build_table(n, groups, seed=seed)
    valid = np.random.default_rng(seed + 2).random(n) >= NULL_SHARE
    v = snap.columns[3]
    snap.columns[3] = Column(v.eval_type, np.where(valid, v.values, 0), valid)
    return table, snap


def dag_simple_agg(table: Table):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    return s.aggregate([], [("sum", s.col("v")), ("count_star", None),
                            ("avg", s.col("v"))]).build()


def dag_hash_agg(table: Table):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    return s.aggregate([s.col("k")],
                       [("count_star", None), ("sum", s.col("v"))]).build()


def _dag(table: Table, group: bool, kinds) -> object:
    s = DagSelect.from_table(table, ["id", "k", "v"])
    return s.aggregate([s.col("k")] if group else [],
                       [(kd, None if kd == "count_star" else s.col("v"))
                        for kd in kinds]).build()


def dag_4n(table: Table):
    return _dag(table, True, ("count_star", "count", "sum", "avg"))


def dag_4r(table: Table):
    return _dag(table, True, ("sum", "avg"))


def dag_4m(table: Table):
    return _dag(table, True, ("min", "max", "var_pop", "stddev_samp"))


def dag_3n(table: Table):
    return _dag(table, False, ("sum", "count", "avg", "min", "max", "first"))


def _wide(n: int):
    return build_table(n, WIDE_GROUPS)


def _real(n: int):
    return build_table(n, real_v=True)


# name → (table builder of n rows, plan builder)
CONFIGS = {
    "3": (build_table, dag_simple_agg),
    "4": (build_table, dag_hash_agg),
    "4s": (build_sparse_table, dag_hash_agg),
    "4n": (build_null_table, dag_4n),
    "4w": (_wide, dag_hash_agg),
    "4r": (_real, dag_4r),
    "4m": (build_table, dag_4m),
    "3n": (build_null_table, dag_3n),
}


# ---------------------------------------------------------------------------
# numpy truth
# ---------------------------------------------------------------------------

def _first_valid(v, ok):
    at = np.flatnonzero(ok)
    return v[at[0]].item() if at.size else None


def _cells(kind, v, ok, inv, g, real):
    """Per group of ``inv`` (g groups): (values, error scales) of one
    aggregate over ``v`` where ``ok``.  A scale is 0 where the value is
    exact, else the magnitude its error is measured against: Σ|v| of the
    group for a REAL SUM, the mean |v| for a REAL AVG, the value itself
    for the variance kinds."""
    c = np.bincount(inv, weights=ok, minlength=g).astype(np.int64)
    vf = np.where(ok, v, 0).astype(np.float64)
    s = np.bincount(inv, weights=vf, minlength=g)
    mag = np.bincount(inv, weights=np.abs(vf), minlength=g)
    if kind == "count":
        return [int(x) for x in c], [0] * g
    if kind in ("sum", "avg"):
        if real:
            vals = s if kind == "sum" else s / np.maximum(c, 1)
            scales = mag if kind == "sum" else mag / np.maximum(c, 1)
        else:
            assert mag.max(initial=0) < 2 ** 53   # float64 sums are exact
            si = s.astype(np.int64)
            vals = si if kind == "sum" else \
                [float(int(x)) / max(int(n), 1) for x, n in zip(si, c)]
            scales = np.zeros(g)
        return [None if n == 0 else (float(x) if real or kind == "avg"
                                     else int(x))
                for x, n in zip(vals, c)], list(scales)
    if kind in ("min", "max"):
        big = np.inf if real else np.iinfo(np.int64).max
        t = np.full(g, big if kind == "min" else -big,
                    np.float64 if real else np.int64)
        (np.minimum if kind == "min" else np.maximum).at(
            t, inv[ok], v[ok])
        return [None if n == 0 else t[i].item() for i, n in enumerate(c)], \
            [0] * g
    # variance kinds: two passes around each group's mean
    mean = s / np.maximum(c, 1)
    dev = np.where(ok, v - mean[inv], 0.0)
    ss = np.bincount(inv, weights=dev * dev, minlength=g)
    samp = kind.endswith("samp")
    need = 2 if samp else 1
    var = ss / np.maximum(c - (1 if samp else 0), 1)
    if kind.startswith("stddev"):
        var = np.sqrt(var)
    return [None if n < need else float(x) for x, n in zip(var, c)], \
        [abs(float(x)) for x in var]


def truth(name: str, snap) -> tuple:
    """(rows, scales) of config ``name`` over ``snap``, from numpy alone:
    the rows in the runner's order (ascending key, aggregates then key),
    and per row the error scale of each cell (see ``_cells``).  REAL
    values are taken as the float32 the device column holds."""
    _build, make = CONFIGS[name]
    agg = make(bench_table()).executors[-1]
    kinds = [a.kind for a in agg.aggs]
    k = snap.columns[2].values
    vcol = snap.columns[3]
    real = vcol.eval_type is EvalType.REAL
    v = vcol.values.astype(np.float32).astype(np.float64) if real \
        else vcol.values
    ok = vcol.validity
    n = len(k)
    if agg.group_by:
        if k.size and k.min() >= 0 and k.max() < (1 << 20):
            inv = k
            g = int(k.max()) + 1
        else:
            keys, inv = np.unique(k, return_inverse=True)
            g = len(keys)
        rows_per = np.bincount(inv, minlength=g)
        key_of = np.arange(g) if inv is k else keys
    else:
        inv, g, rows_per, key_of = np.zeros(n, np.int64), 1, [n], None
    cols, scales = [], []
    for kind in kinds:
        if kind == "count_star":
            cols.append([int(x) for x in rows_per])
            scales.append([0] * g)
        elif kind == "first":
            cols.append([_first_valid(v, ok)])
            scales.append([0])
        else:
            vals, sc = _cells(kind, v, ok, inv, g, real)
            cols.append(vals)
            scales.append(sc)
    live = [i for i in range(g) if rows_per[i] > 0]
    rows = [tuple(c[i] for c in cols) +
            ((int(key_of[i]),) if key_of is not None else ()) for i in live]
    row_scales = [tuple(s[i] for s in scales) +
                  ((0,) if key_of is not None else ()) for i in live]
    return rows, row_scales


def rows_agree(got, want, scales, tol: float) -> bool:
    """Row lists equal, exactly where a cell's scale is 0, else within
    ``tol`` × its scale."""
    if len(got) != len(want):
        return False
    for g_row, w_row, s_row in zip(got, want, scales):
        if len(g_row) != len(w_row):
            return False
        for g, w, s in zip(g_row, w_row, s_row):
            if s == 0 or g is None or w is None:
                if g != w:
                    return False
            elif abs(g - w) > tol * s:
                return False
    return True
