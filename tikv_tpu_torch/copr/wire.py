"""Wire form of DAG plans (the tipb analog): plain dicts of ints, strings
and lists, so a request encoded by either package decodes in the other.

The dict layout is the server's msgpack body schema field for field.
"""

from __future__ import annotations

from ..datatype import EvalType, FieldType, FieldTypeFlag, FieldTypeTp
from ..executors.ranges import KeyRange
from ..expr import Expr
from .dag import (
    AggExprDesc,
    AggregationDesc,
    ColumnInfo,
    DAGRequest,
    IndexScanDesc,
    LimitDesc,
    PartitionTopNDesc,
    ProjectionDesc,
    SelectionDesc,
    TableScanDesc,
    TopNDesc,
)


def enc_field_type(ft: FieldType) -> dict:
    return {"tp": int(ft.tp), "flag": int(ft.flag), "flen": ft.flen,
            "decimal": ft.decimal, "collation": ft.collation,
            "elems": list(ft.elems)}


def dec_field_type(d: dict) -> FieldType:
    return FieldType(FieldTypeTp(d["tp"]), FieldTypeFlag(d["flag"]),
                     d["flen"], d["decimal"], d["collation"],
                     tuple(d["elems"]))


def enc_expr(e: Expr) -> dict:
    if e.kind == "const":
        return {"k": "c", "v": e.value,
                "et": e.eval_type.value if e.eval_type else None}
    if e.kind == "column":
        out = {"k": "col", "i": e.col_idx,
               "et": e.eval_type.value if e.eval_type else None}
        if e.collation != 63:
            out["coll"] = e.collation
        if e.elems:
            out["elems"] = list(e.elems)
        return out
    out = {"k": "f", "sig": e.sig,
           "ch": [enc_expr(c) for c in e.children]}
    if e.collation != 63:
        out["coll"] = e.collation
    if e.elems:
        out["elems"] = list(e.elems)
    return out


def dec_expr(d: dict) -> Expr:
    et = EvalType(d["et"]) if d.get("et") else None
    if d["k"] == "c":
        return Expr(kind="const", value=d["v"], eval_type=et)
    if d["k"] == "col":
        return Expr(kind="column", col_idx=d["i"], eval_type=et,
                    collation=d.get("coll", 63),
                    elems=tuple(d.get("elems", ())))
    return Expr.call(d["sig"], *(dec_expr(c) for c in d["ch"]),
                     collation=d.get("coll", 63),
                     elems=tuple(d.get("elems", ())))


def _enc_cols(columns) -> list:
    return [{"id": c.col_id, "ft": enc_field_type(c.field_type),
             "pk": c.is_pk_handle} for c in columns]


def enc_dag(dag: DAGRequest) -> dict:
    execs = []
    for ex in dag.executors:
        if isinstance(ex, TableScanDesc):
            execs.append({"k": "tscan", "table_id": ex.table_id,
                          "desc": ex.desc, "cols": _enc_cols(ex.columns)})
        elif isinstance(ex, IndexScanDesc):
            execs.append({"k": "iscan", "table_id": ex.table_id,
                          "index_id": ex.index_id, "desc": ex.desc,
                          "unique": ex.unique,
                          "cols": _enc_cols(ex.columns)})
        elif isinstance(ex, SelectionDesc):
            execs.append({"k": "sel",
                          "conds": [enc_expr(e) for e in ex.conditions]})
        elif isinstance(ex, ProjectionDesc):
            execs.append({"k": "proj",
                          "exprs": [enc_expr(e) for e in ex.exprs]})
        elif isinstance(ex, AggregationDesc):
            execs.append({"k": "agg", "streamed": ex.streamed,
                          "group_by": [enc_expr(e) for e in ex.group_by],
                          "aggs": [{"kind": a.kind,
                                    "arg": enc_expr(a.arg)
                                    if a.arg is not None else None}
                                   for a in ex.aggs]})
        elif isinstance(ex, TopNDesc):
            execs.append({"k": "topn", "limit": ex.limit,
                          "order_by": [{"e": enc_expr(e), "desc": d}
                                       for e, d in ex.order_by]})
        elif isinstance(ex, PartitionTopNDesc):
            execs.append({"k": "ptopn", "limit": ex.limit,
                          "partition_by": [enc_expr(e)
                                           for e in ex.partition_by],
                          "order_by": [{"e": enc_expr(e), "desc": d}
                                       for e, d in ex.order_by]})
        elif isinstance(ex, LimitDesc):
            execs.append({"k": "limit", "limit": ex.limit})
        else:   # pragma: no cover
            raise ValueError(ex)
    return {"execs": execs,
            "ranges": [{"s": r.start, "e": r.end} for r in dag.ranges],
            "start_ts": dag.start_ts,
            "output_offsets": list(dag.output_offsets)
            if dag.output_offsets is not None else None,
            "encode_type": dag.encode_type}


def dec_dag(d: dict) -> DAGRequest:
    execs = []
    for ex in d["execs"]:
        k = ex["k"]
        if k in ("tscan", "iscan"):
            cols = tuple(ColumnInfo(c["id"], dec_field_type(c["ft"]),
                                    c["pk"]) for c in ex["cols"])
            if k == "tscan":
                execs.append(TableScanDesc(ex["table_id"], cols,
                                           ex["desc"]))
            else:
                execs.append(IndexScanDesc(ex["table_id"], ex["index_id"],
                                           cols, ex["desc"], ex["unique"]))
        elif k == "sel":
            execs.append(SelectionDesc(
                tuple(dec_expr(e) for e in ex["conds"])))
        elif k == "proj":
            execs.append(ProjectionDesc(
                tuple(dec_expr(e) for e in ex["exprs"])))
        elif k == "agg":
            execs.append(AggregationDesc(
                tuple(dec_expr(e) for e in ex["group_by"]),
                tuple(AggExprDesc(a["kind"],
                                  dec_expr(a["arg"])
                                  if a["arg"] is not None else None)
                      for a in ex["aggs"]),
                ex["streamed"]))
        elif k == "topn":
            execs.append(TopNDesc(
                tuple((dec_expr(o["e"]), o["desc"])
                      for o in ex["order_by"]), ex["limit"]))
        elif k == "ptopn":
            execs.append(PartitionTopNDesc(
                tuple(dec_expr(e) for e in ex["partition_by"]),
                tuple((dec_expr(o["e"]), o["desc"])
                      for o in ex["order_by"]), ex["limit"]))
        elif k == "limit":
            execs.append(LimitDesc(ex["limit"]))
    return DAGRequest(
        executors=tuple(execs),
        ranges=tuple(KeyRange(r["s"], r["e"]) for r in d["ranges"]),
        start_ts=d["start_ts"],
        output_offsets=tuple(d["output_offsets"])
        if d["output_offsets"] is not None else None,
        encode_type=d["encode_type"])


# -- plan IR (copr/plan_ir.py): a linear fragment uses the executor
# encoding above per scan / operator; join, sort and window nodes extend
# it (the reference's server/wire.py enc_plan / dec_plan).

def _enc_scan_desc(scan) -> dict:
    if isinstance(scan, IndexScanDesc):
        return {"k": "iscan", "table_id": scan.table_id,
                "index_id": scan.index_id, "desc": scan.desc,
                "unique": scan.unique, "cols": _enc_cols(scan.columns)}
    return {"k": "tscan", "table_id": scan.table_id, "desc": scan.desc,
            "cols": _enc_cols(scan.columns)}


def _enc_order(order_by) -> list:
    return [{"e": enc_expr(e), "desc": d} for e, d in order_by]


def _dec_order(items) -> tuple:
    return tuple((dec_expr(o["e"]), o["desc"]) for o in items)


def _enc_aggs(aggs) -> list:
    return [{"kind": a.kind,
             "arg": enc_expr(a.arg) if a.arg is not None else None}
            for a in aggs]


def enc_plan(preq) -> dict:
    from . import plan_ir as pir

    def node(n) -> dict:
        if isinstance(n, pir.ScanNode):
            return {"k": "scan", "scan": _enc_scan_desc(n.scan),
                    "ranges": [{"s": r.start, "e": r.end}
                               for r in n.ranges]}
        if isinstance(n, pir.SelectNode):
            return {"k": "sel", "child": node(n.child),
                    "conds": [enc_expr(e) for e in n.conditions]}
        if isinstance(n, pir.ProjectNode):
            return {"k": "proj", "child": node(n.child),
                    "exprs": [enc_expr(e) for e in n.exprs]}
        if isinstance(n, pir.AggNode):
            return {"k": "agg", "child": node(n.child),
                    "streamed": n.desc.streamed,
                    "group_by": [enc_expr(e) for e in n.desc.group_by],
                    "aggs": _enc_aggs(n.desc.aggs)}
        if isinstance(n, pir.TopNNode):
            return {"k": "topn", "child": node(n.child),
                    "limit": n.desc.limit,
                    "order_by": _enc_order(n.desc.order_by)}
        if isinstance(n, pir.PartTopNNode):
            return {"k": "ptopn", "child": node(n.child),
                    "limit": n.desc.limit,
                    "partition_by": [enc_expr(e)
                                     for e in n.desc.partition_by],
                    "order_by": _enc_order(n.desc.order_by)}
        if isinstance(n, pir.LimitNode):
            return {"k": "limit", "child": node(n.child), "limit": n.limit}
        if isinstance(n, pir.JoinNode):
            return {"k": "join", "left": node(n.left),
                    "right": node(n.right), "left_key": n.left_key,
                    "right_key": n.right_key, "join_type": n.join_type}
        if isinstance(n, pir.SortNode):
            return {"k": "sort", "child": node(n.child),
                    "order_by": _enc_order(n.order_by)}
        if isinstance(n, pir.WindowNode):
            return {"k": "window", "child": node(n.child),
                    "partition_by": [enc_expr(e) for e in n.partition_by],
                    "order_by": _enc_order(n.order_by),
                    "funcs": [{"kind": f.kind,
                               "arg": enc_expr(f.arg)
                               if f.arg is not None else None,
                               "offset": f.offset} for f in n.funcs]}
        raise ValueError(n)

    return {"root": node(preq.root), "start_ts": preq.start_ts,
            "output_offsets": list(preq.output_offsets)
            if preq.output_offsets is not None else None,
            "encode_type": preq.encode_type}


def dec_plan(d: dict):
    from . import plan_ir as pir

    def scan_desc(s):
        cols = tuple(ColumnInfo(c["id"], dec_field_type(c["ft"]), c["pk"])
                     for c in s["cols"])
        if s["k"] == "iscan":
            return IndexScanDesc(s["table_id"], s["index_id"], cols,
                                 s["desc"], s["unique"])
        return TableScanDesc(s["table_id"], cols, s["desc"])

    def node(nd):
        k = nd["k"]
        if k == "scan":
            return pir.ScanNode(scan_desc(nd["scan"]), tuple(
                KeyRange(r["s"], r["e"]) for r in nd["ranges"]))
        if k == "join":
            return pir.JoinNode(node(nd["left"]), node(nd["right"]),
                                nd["left_key"], nd["right_key"],
                                nd.get("join_type", "inner"))
        child = node(nd["child"])
        if k == "sel":
            return pir.SelectNode(child, tuple(dec_expr(e)
                                               for e in nd["conds"]))
        if k == "proj":
            return pir.ProjectNode(child, tuple(dec_expr(e)
                                                for e in nd["exprs"]))
        if k == "agg":
            return pir.AggNode(child, AggregationDesc(
                tuple(dec_expr(e) for e in nd["group_by"]),
                tuple(AggExprDesc(a["kind"], dec_expr(a["arg"])
                                  if a["arg"] is not None else None)
                      for a in nd["aggs"]), nd["streamed"]))
        if k == "topn":
            return pir.TopNNode(child, TopNDesc(_dec_order(nd["order_by"]),
                                                nd["limit"]))
        if k == "ptopn":
            return pir.PartTopNNode(child, PartitionTopNDesc(
                tuple(dec_expr(e) for e in nd["partition_by"]),
                _dec_order(nd["order_by"]), nd["limit"]))
        if k == "limit":
            return pir.LimitNode(child, nd["limit"])
        if k == "sort":
            return pir.SortNode(child, _dec_order(nd["order_by"]))
        if k == "window":
            return pir.WindowNode(
                child, tuple(dec_expr(e) for e in nd["partition_by"]),
                _dec_order(nd["order_by"]),
                tuple(pir.WindowFuncDesc(
                    f["kind"],
                    dec_expr(f["arg"]) if f["arg"] is not None else None,
                    f.get("offset", 1)) for f in nd["funcs"]))
        raise ValueError(nd)

    return pir.PlanRequest(
        node(d["root"]), start_ts=d["start_ts"],
        output_offsets=tuple(d["output_offsets"])
        if d["output_offsets"] is not None else None,
        encode_type=d["encode_type"])
