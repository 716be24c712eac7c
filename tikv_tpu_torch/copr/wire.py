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
