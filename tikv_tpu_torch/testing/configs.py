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

``CONFIGS`` maps each name to its table builder and its plan.  The
configurations that return rows are in ``ROW_CONFIGS`` (``bench.py``'s
configs 1, 2 and 5, plus 5t), with ``row_truth``:

- config 1: a bare scan of 2^20 rows; it is a host plan (bare scans are
  decode-bound), so its device figure is its probe, ``v > -10^9`` — a
  predicate that keeps every row (``bench.py:2408-2422``);
- config 2: ``WHERE v > 800`` over 10·2^20 rows (about 10% selected);
- config 2s: config 2's table at the selectivities of ``SWEEP``
  (``sweep_threshold``), which take the compact, index and mask routes;
- config 5: an IndexScan of REAL ``v`` (and the handle), ``ORDER BY v DESC
  LIMIT 1000``, over 100·2^20 rows;
- config 5t: config 5's table with a TableScan head and ``v`` NULL on 10%:
  ``WHERE k < 512 ORDER BY v DESC LIMIT 1000`` — unsorted rows, a
  selection inside the top-k and NULL keys.

Cell 6b-ep (``serving_table``, ``serving_schedule``, ``dag_serving``,
``serving_truth``) is config 6b of ``bench.py`` (:30-35, :1130-1300) at the
endpoint: three tables of ``int_table(2)``'s shape (``c0 = h % 1024``,
``c1 = h % 1000``), ids 9920-9922, and the seeded (61) schedule of
selections ``c1 > thr`` (thr Zipf over 980..995) and ``GROUP BY c0:
COUNT(*), SUM(c1)``, 3:1, over Zipf-drawn tables.

The plan-IR configurations (``PLAN_CELLS``, ``plan_truth``) run on config
7's pair of tables (``build_join_pair``, ``bench.py:243-312``): a probe
table ``(id, k ∈ [0, n_build), v ∈ [-1000, 1000))`` against a build table
``(id, bk = 0..n_build-1, w ∈ [0, 64))``, seed 11:

- config 7: ``WHERE v > 0``, inner join on ``k = bk``, then ``GROUP BY w:
  COUNT(*), SUM(v)`` on the host (10·2^20 × 2^20 rows);
- cell 7s: the probe table ``ORDER BY k DESC, v ASC``, every row;
- cell 7w: the probe table ``PARTITION BY k ORDER BY v``: row_number,
  count(v), sum(v), avg(v), lag(v, 2), lead(v, 1).
"""

from __future__ import annotations

import zlib

import numpy as np

from ..codec.keys import table_record_range
from ..copr import plan_ir as pir
from ..copr.dag import AggExprDesc, AggregationDesc, TableScanDesc
from ..datatype import Column, EvalType, FieldType
from ..executors.columnar import ColumnarTable
from ..executors.ranges import KeyRange
from ..expr import Expr
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


def build_real_null_table(n: int, groups: int = GROUPS, seed: int = 7):
    """Config 5's table (REAL ``v``) with ``v`` NULL on ``NULL_SHARE`` of
    the rows (the mask of ``build_null_table``)."""
    table, snap = build_table(n, groups, seed=seed, real_v=True)
    valid = np.random.default_rng(seed + 2).random(n) >= NULL_SHARE
    v = snap.columns[3]
    snap.columns[3] = Column(v.eval_type, np.where(valid, v.values, 0.0),
                             valid)
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


PROBE_THRESHOLD = -(10 ** 9)
TOPN_LIMIT = 1000
# config 2s: the sweep's selectivities (bench.py:2263)
SWEEP = {"0.1%": 0.001, "1%": 0.01, "10%": 0.10, "50%": 0.50}


def dag_selection(table: Table, threshold: int = 800):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    return s.where(s.col("v") > threshold).build()


def dag_scan_probe(table: Table):
    return dag_selection(table, PROBE_THRESHOLD)


def dag_topn_index(table: Table, limit: int = TOPN_LIMIT):
    s = DagSelect.from_index(table, "v", with_handle=True)
    return s.order_by(s.col("v"), desc=True, limit=limit).build()


def dag_topn_table(table: Table, limit: int = TOPN_LIMIT):
    s = DagSelect.from_table(table, ["id", "k", "v"])
    return s.where(s.col("k") < 512).order_by(s.col("v"), desc=True,
                                             limit=limit).build()


def sweep_threshold(snap, frac: float) -> int:
    """The ``v > t`` threshold that keeps about ``frac`` of the rows."""
    return int(np.quantile(snap.columns[3].values, 1.0 - frac))


# name → (table builder of n rows, plan builder); the plans return rows
ROW_CONFIGS = {
    "1": (build_table, dag_scan_probe),
    "2": (build_table, dag_selection),
    "5": (_real, dag_topn_index),
    "5t": (build_real_null_table, dag_topn_table),
}


# ---------------------------------------------------------------------------
# numpy truth
# ---------------------------------------------------------------------------

def top_rows(values, valid, desc: bool, limit: int) -> np.ndarray:
    """Positions of the ``limit`` best rows by (value, NULL last for DESC
    and first for ASC, then position), best first; O(n)."""
    key = np.where(valid, values if desc else -values,
                   -np.inf if desc else np.inf)
    n = len(key)
    if limit < n:
        kth = np.partition(key, n - limit)[n - limit]
        above = np.flatnonzero(key > kth)
        tied = np.flatnonzero(key == kth)[:limit - len(above)]
        chosen = np.concatenate([above, tied])
    else:
        chosen = np.arange(n)
    return chosen[np.lexsort((chosen, -key[chosen]))]


def row_truth_columns(name: str, snap, threshold: int = 800) -> list:
    """The output columns, as (values, validity) numpy pairs, of a
    ``ROW_CONFIGS`` plan (or of config 2s at ``threshold``) over ``snap``,
    from numpy alone."""
    ids, k, v = snap.handles, snap.columns[2], snap.columns[3]
    if name in ("1", "2", "2s"):
        t = PROBE_THRESHOLD if name == "1" else threshold
        rows = np.flatnonzero(v.validity & (v.values > t))
    elif name == "5":
        # the index orders equal values by handle, as the table does
        rows = top_rows(v.values, v.validity, True, TOPN_LIMIT)
        return [(v.values[rows], v.validity[rows]),
                (ids[rows], np.ones(len(rows), np.bool_))]
    else:
        keep = np.flatnonzero(k.values < 512)
        rows = keep[top_rows(v.values[keep], v.validity[keep], True,
                             TOPN_LIMIT)]
    return [(ids[rows], np.ones(len(rows), np.bool_)),
            (k.values[rows], k.validity[rows]),
            (v.values[rows], v.validity[rows])]


def row_truth(name: str, snap, threshold: int = 800) -> list:
    """``row_truth_columns`` as a list of row tuples (None for NULL)."""
    cols = row_truth_columns(name, snap, threshold)
    return list(zip(*[[x if ok else None for x, ok in zip(v.tolist(), m)]
                      for v, m in cols]))


def columns_agree(batch, cols) -> bool:
    """A result batch equals truth columns exactly: the same validity, and
    the same values where valid."""
    if len(batch.columns) != len(cols):
        return False
    for c, (v, m) in zip(batch.columns, cols):
        if len(c.values) != len(v) or not np.array_equal(c.validity, m) or \
                not np.array_equal(c.values[m], v[m]):
            return False
    return True


def _first_selected(v, ok):
    """FIRST over every row: the first row's value, NULL when that row is
    NULL (the host pipeline's ``AggrFnFirst``)."""
    return v[0].item() if len(v) and ok[0] else None


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
            cols.append([_first_selected(v, ok)])
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


# ---------------------------------------------------------------------------
# config 7 and its cells: the plan IR
# ---------------------------------------------------------------------------

JOIN_GROUPS = 64
WINDOW_FUNCS = (("row_number", 1), ("count", 1), ("sum", 1), ("avg", 1),
                ("lag", 2), ("lead", 1))


def build_join_pair(n_probe: int, n_build: int, seed: int = 11):
    """→ (probe table, probe snapshot, build table, build snapshot): the
    arrays ``bench.build_join_pair`` draws from the same seed."""
    rng = np.random.default_rng(seed)
    probe_t = Table(97, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("k", 2, FieldType.long()),
        TableColumn("v", 3, FieldType.long()),
    ))
    ones_p = np.ones(n_probe, dtype=np.bool_)
    probe = ColumnarTable.from_arrays(
        probe_t, np.arange(n_probe, dtype=np.int64),
        {"k": Column(EvalType.INT,
                     rng.integers(0, n_build, n_probe).astype(np.int64),
                     ones_p),
         "v": Column(EvalType.INT,
                     rng.integers(-1000, 1000, n_probe).astype(np.int64),
                     ones_p)})
    build_t = Table(98, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("bk", 2, FieldType.long()),
        TableColumn("w", 3, FieldType.long()),
    ))
    ones_b = np.ones(n_build, dtype=np.bool_)
    build = ColumnarTable.from_arrays(
        build_t, np.arange(n_build, dtype=np.int64),
        {"bk": Column(EvalType.INT, np.arange(n_build, dtype=np.int64),
                      ones_b),
         "w": Column(EvalType.INT,
                     rng.integers(0, JOIN_GROUPS, n_build).astype(np.int64),
                     ones_b)})
    return probe_t, probe, build_t, build


def scan_node(table: Table) -> pir.ScanNode:
    start, end = table_record_range(table.table_id)
    return pir.ScanNode(
        TableScanDesc(table.table_id, tuple(table.column_info(c.name)
                                            for c in table.columns)),
        (KeyRange(start, end),))


def plan_join(probe_t: Table, build_t: Table) -> pir.PlanRequest:
    """Config 7 (``bench._join_plan``): scan + ``v > 0`` → join on k = bk
    → GROUP BY w: COUNT(*), SUM(v)."""
    sel = pir.SelectNode(scan_node(probe_t), (
        Expr.column(2, EvalType.INT) > Expr.const(0, EvalType.INT),))
    join = pir.JoinNode(sel, scan_node(build_t), 1, 1)
    return pir.PlanRequest(pir.AggNode(join, AggregationDesc(
        (Expr.column(5, EvalType.INT),),
        (AggExprDesc("count_star", None),
         AggExprDesc("sum", Expr.column(2, EvalType.INT))), False)))


def plan_sort(probe_t: Table) -> pir.PlanRequest:
    """Cell 7s: ORDER BY k DESC, v ASC."""
    return pir.PlanRequest(pir.SortNode(scan_node(probe_t), (
        (Expr.column(1, EvalType.INT), True),
        (Expr.column(2, EvalType.INT), False))))


def plan_window(probe_t: Table) -> pir.PlanRequest:
    """Cell 7w: PARTITION BY k ORDER BY v, ``WINDOW_FUNCS`` over v."""
    v = Expr.column(2, EvalType.INT)
    funcs = tuple(pir.WindowFuncDesc(kind, None if kind == "row_number"
                                     else v, off)
                  for kind, off in WINDOW_FUNCS)
    return pir.PlanRequest(pir.WindowNode(
        scan_node(probe_t), (Expr.column(1, EvalType.INT),),
        ((v, False),), funcs))


# cell → its plan over (probe table, build table)
PLAN_CELLS = {
    "7": plan_join,
    "7s": lambda probe_t, _build_t: plan_sort(probe_t),
    "7w": lambda probe_t, _build_t: plan_window(probe_t),
}


def plan_truth(cell: str, probe, build) -> list:
    """The output columns, as (values, validity) numpy pairs, of a
    ``PLAN_CELLS`` plan over config 7's snapshots, from numpy alone.
    Config 7's groups come in the host aggregation's first-seen order."""
    ids = probe.handles
    k, v = probe.columns[2].values, probe.columns[3].values
    if cell == "7":
        w = build.columns[3].values
        sel = v > 0
        wk = w[k[sel]]
        cnt = np.bincount(wk, minlength=JOIN_GROUPS)
        vs = v[sel]
        assert np.abs(vs).sum() < 2 ** 53       # float64 sums are exact
        tot = np.bincount(wk, weights=vs,
                          minlength=JOIN_GROUPS).astype(np.int64)
        _, first = np.unique(wk, return_index=True)
        groups = wk[np.sort(first)]
        ones = np.ones(len(groups), np.bool_)
        return [(cnt[groups], ones), (tot[groups], cnt[groups] > 0),
                (groups, ones)]
    if cell == "7s":
        order = np.lexsort((v, -k))
        ones = np.ones(len(order), np.bool_)
        return [(ids[order], ones), (k[order], ones), (v[order], ones)]
    order = np.lexsort((v, k))
    n = len(order)
    sk, sv = k[order], v[order]
    head = np.ones(n, np.bool_)
    head[1:] = sk[1:] != sk[:-1]
    idx = np.arange(n)
    start = np.maximum.accumulate(np.where(head, idx, 0))
    rn = idx - start + 1
    cs = np.cumsum(sv)
    run = cs - (cs[start] - sv[start])
    ones = np.ones(n, np.bool_)
    cols = [(ids[order], ones), (sk, ones), (sv, ones), (rn, ones),
            (rn.copy(), ones), (run, ones),
            (run.astype(np.float64) / rn, ones)]
    for kind, off in WINDOW_FUNCS[4:]:
        src = idx - off if kind == "lag" else idx + off
        safe = np.clip(src, 0, n - 1)
        ok = (src >= 0) & (src < n) & (start[safe] == start)
        cols.append((np.where(ok, sv[safe], 0), ok))
    return cols


# ---------------------------------------------------------------------------
# ANALYZE cells: every column of a table, 256 buckets
# ---------------------------------------------------------------------------

# TiDB's default of ANALYZE TABLE ... WITH NUM BUCKETS
# cell 6b-ep: config 6b (bench.py:30-35, :1130-1300) at the endpoint in
# process — concurrent clients over a seeded Zipf mix of three tables of
# int_table(2)'s shape (c0 = h % 1024, c1 = h % 1000: bench.py:420's
# _bulk_load), selections ``c1 > thr`` over the palette 980..995 (0.4-1.9%
# selected) and ``GROUP BY c0: COUNT(*), SUM(c1)``, 3:1
SERVE_TABLE_IDS = (9920, 9921, 9922)
SERVE_PALETTE = tuple(range(980, 996))
SERVE_GROUPS = 1024


def serving_table(n: int, table_id: int):
    """→ (table, snapshot) of one 6b table: id, c0 = h % 1024, c1 = h %
    1000 over handles 0..n-1, no NULLs."""
    table = Table(table_id, (
        TableColumn("id", 1, FieldType.long(not_null=True),
                    is_pk_handle=True),
        TableColumn("c0", 2, FieldType.long(), index_id=1),
        TableColumn("c1", 3, FieldType.long(), index_id=2)))
    h = np.arange(n, dtype=np.int64)
    ones = np.ones(n, np.bool_)
    snap = ColumnarTable.from_arrays(table, h, {
        "c0": Column(EvalType.INT, h % SERVE_GROUPS, ones),
        "c1": Column(EvalType.INT, h % 1000, ones)})
    return table, snap


def serving_schedule(total: int, n_tables: int = len(SERVE_TABLE_IDS),
                     seed: int = 61) -> list:
    """bench.py:1198-1212's seeded schedule: (table, palette index, is a
    selection) per request — tables Zipf s = 2.0, thresholds Zipf s = 1.2,
    75% selections."""
    rng = np.random.default_rng(seed)

    def zipf_pick(k, size, s=1.2):
        p = 1.0 / np.arange(1, k + 1) ** s
        return rng.choice(k, size=size, p=p / p.sum())

    tables = zipf_pick(n_tables, total, s=2.0)
    thresholds = zipf_pick(len(SERVE_PALETTE), total)
    return list(zip(tables.tolist(), thresholds.tolist(),
                    (rng.random(total) < 0.75).tolist()))


def dag_serving(table: Table, thr=None):
    """A 6b request: ``c1 > thr``, or (``thr`` None) the GROUP BY."""
    s = DagSelect.from_table(table, ["id", "c0", "c1"])
    if thr is not None:
        return s.where(s.col("c1") > thr).build()
    return s.aggregate([s.col("c0")],
                       [("count_star", None), ("sum", s.col("c1"))]).build()


def serving_truth(n: int, thr=None):
    """The numpy answer of ``dag_serving`` over a 6b table of n rows:
    truth columns (``columns_agree``) of a selection, or the sorted rows
    (COUNT(*), SUM(c1), c0) of the GROUP BY."""
    h = np.arange(n, dtype=np.int64)
    c0, c1 = h % SERVE_GROUPS, h % 1000
    if thr is not None:
        ids = np.flatnonzero(c1 > thr).astype(np.int64)
        ones = np.ones(len(ids), np.bool_)
        return [(ids, ones), (c0[ids], ones), (c1[ids], ones)]
    cnt = np.bincount(c0, minlength=SERVE_GROUPS)
    sums = np.bincount(c0, weights=c1, minlength=SERVE_GROUPS)
    return sorted((int(cnt[g]), int(sums[g]), g)
                  for g in range(SERVE_GROUPS) if cnt[g])


ANALYZE_BUCKETS = 256
# cell → its table builder over n rows (an6c's snapshot is config 6c's
# cold mint, testing/mvcc.py history_6c)
ANALYZE_CELLS = {
    "an4": build_table,
    "an4n": build_null_table,
    "an4s": build_sparse_table,
    "an4r": lambda n: build_table(n, real_v=True),
}
# an integer column whose valid values span fewer values than this is
# summarised by a bincount (exact order statistics without a sort)
_BINCOUNT_SPAN = 1 << 22


def analyze_request(table: Table, buckets: int = ANALYZE_BUCKETS):
    """An ANALYZE request over every column of ``table``'s record range."""
    from ..copr.analyze import AnalyzeReq
    dag = DagSelect.from_table(table).build()
    return AnalyzeReq(dag.executors[0], dag.ranges, buckets=buckets)


def column_stats_truth(col_id: int, values: np.ndarray,
                       validity: np.ndarray, buckets: int):
    """One column's ``ColumnStats`` from numpy: the order statistics of a
    narrow integer column from a bincount, of an ascending one (a handle)
    as it is, of any other by ``np.sort``; the buckets and the distinct
    count as the host half (``histogram_from_sorted``) forms them."""
    from ..copr.analyze import ColumnStats, histogram_from_sorted
    v = values[validity]
    total, nv = len(values), len(v)
    if nv and v.dtype.kind in "iu" and \
            int(v.max()) - int(v.min()) < _BINCOUNT_SPAN:
        lo = int(v.min())
        cum = np.cumsum(np.bincount((v - lo).astype(np.int64)))
        nb = max(1, min(buckets, nv))
        ranks = np.arange(1, nb + 1, dtype=np.int64) * nv // nb - 1
        at = np.searchsorted(cum, ranks, side="right") + lo
        out = [(int(b), int(r) + 1) for b, r in zip(at, ranks)]
        distinct = int(np.count_nonzero(np.diff(cum, prepend=0)))
        return ColumnStats(col_id, total, total - nv, distinct, out)
    if nv > 1 and v.dtype.kind in "iu" and bool(np.all(v[1:] >= v[:-1])):
        svals = v
    else:
        svals = np.sort(v)
    out, distinct = histogram_from_sorted(svals, buckets)
    return ColumnStats(col_id, total, total - nv, distinct, out)


def analyze_truth(areq, storage) -> list:
    """Every column's ``ColumnStats`` of ``areq`` over ``storage``, from
    numpy alone (``column_stats_truth``)."""
    batch = storage.scan_columns(areq.scan, tuple(areq.ranges))
    return [column_stats_truth(info.col_id, col.values, col.validity,
                               areq.buckets)
            for info, col in zip(areq.scan.columns, batch.columns)]


# the kernel's edge cases (the CPU tests and the chip smoke): each device
# dtype of an ANALYZE column, by the eval type it serves
ANALYZE_KINDS = {"int32": np.int32, "int64": np.int64, "datetime32": np.uint32,
                 "datetime64": np.uint64, "duration": np.int64,
                 "float64": np.float64}
ANALYZE_EDGE_CASES = ("random", "specials", "dtype_max", "all_null",
                      "one_valid", "few_valid", "one_bucket", "one_row",
                      "ties", "padding_valid")


def _edge_values(rng, dt, m: int) -> np.ndarray:
    if dt == np.float64:
        return rng.normal(0, 100, m).round(1)
    if dt == np.uint32:
        return rng.integers(0, 1 << 32, m, dtype=np.uint64).astype(dt)
    if dt == np.uint64:
        return rng.integers(0, 1 << 63, m, dtype=np.uint64)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, m, dtype=dt, endpoint=True)


def analyze_edge_case(kind: str, case: str, rows: int = 300) -> tuple:
    """One column of ``ANALYZE_KINDS[kind]`` → (values[rows], validity
    [rows], n, buckets): NULLs on 20% and the padding rows past n = rows −
    rows/6, then per case: NaN, −NaN, ±0.0, ±inf (float64) or the dtype's
    extremes; a share of the dtype's max; all NULL; one valid row; five;
    one bucket; one row; four values; padding rows marked valid."""
    dt = ANALYZE_KINDS[kind]
    rng = np.random.default_rng(zlib.crc32(f"{kind}/{case}/{rows}".encode()))
    n_pad, n, b = rows, rows - rows // 6, 16
    v = _edge_values(rng, dt, n_pad)
    ok = rng.random(n_pad) > 0.2
    if case == "specials":
        if dt == np.float64:
            specials = [np.nan, np.copysign(np.nan, -1), 0.0, -0.0,
                        np.inf, -np.inf]
        else:
            info = np.iinfo(dt)
            specials = [info.min, info.max, 0, 1, info.max - 1]
        sp = np.resize(np.asarray(specials, dtype=dt), min(n_pad, 60))
        v[:len(sp)] = sp
        b = 8
    elif case == "dtype_max":
        top = np.inf if dt == np.float64 else np.iinfo(dt).max
        v[rng.random(n_pad) < 0.3] = top
        b = 4
    elif case == "all_null":
        ok[:] = False
        b = 8
    elif case == "one_valid":
        ok[:] = False
        ok[min(37, n - 1)] = True
        b = 8
    elif case == "few_valid":
        ok[:] = False
        ok[rng.choice(n, min(5, n), replace=False)] = True
    elif case == "one_bucket":
        b = 1
    elif case == "one_row":
        v, ok, n, b = v[:1], np.ones(1, np.bool_), 1, 4
    elif case == "ties":
        v = rng.integers(0, 4, n_pad).astype(dt)
        b = 32
    elif case == "padding_valid":
        ok[n:] = True           # rows at or past n never count
    if dt != np.float64:
        v[~ok] = 0              # a NULL slot holds 0, as a feed's does
    return v, ok, n, b
