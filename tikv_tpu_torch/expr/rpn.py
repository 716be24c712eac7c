"""RPN programs and the tree→RPN builder.

Reference: tidb_query_expr/src/types/expr.rs:12 (RpnExpressionNode /
RpnExpression), types/expr_builder.rs (append_rpn_nodes_recursively).  The
program is the post-order traversal of the expression tree; evaluation is
a stack machine (eval.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

from ..datatype import EvalType
from .functions import FUNCTIONS, RpnFnMeta
from .tree import Expr


@dataclass(frozen=True)
class RpnConst:
    value: object               # None = NULL
    eval_type: EvalType


@dataclass(frozen=True)
class RpnColumnRef:
    col_idx: int
    eval_type: EvalType


@dataclass(frozen=True)
class RpnFnCall:
    meta: RpnFnMeta
    n_args: int
    # (collation, enum/set elems) — consulted only when meta.needs_ctx;
    # the reference's collator/elems dispatch from the tipb FieldType
    ctx: tuple = (63, ())


RpnNode = Union[RpnConst, RpnColumnRef, RpnFnCall]


@dataclass(frozen=True)
class RpnExpression:
    nodes: tuple

    @property
    def ret_type(self) -> EvalType:
        last = self.nodes[-1]
        if isinstance(last, RpnFnCall):
            return last.meta.ret
        return last.eval_type


def _subtree_ctx(e: Expr) -> tuple:
    """Effective (collation, elems) of ``e``'s subtree.

    Collation coercion follows MySQL: an explicit collation on a call or
    constant below (a COLLATE clause) wins; else a binary string column
    wins over a ci one (comparing bin_col to ci_col compares bytes); a ci
    collation applies only when no string column says binary.  Elems: the
    first non-empty table anywhere below."""
    col_colls: list = []
    explicit = None
    elems: tuple = ()
    stack = list(e.children)
    while stack:
        n = stack.pop(0)
        if n.kind == "column" and n.eval_type is EvalType.BYTES:
            col_colls.append(n.collation)
        elif n.collation != 63 and explicit is None:
            explicit = n.collation
        if not elems and n.elems:
            elems = n.elems
        stack.extend(n.children)
    if explicit is not None:
        return explicit, elems
    if any(c == 63 for c in col_colls):
        return 63, elems
    return next((c for c in col_colls if c != 63), 63), elems


def build_rpn(tree: Expr) -> RpnExpression:
    """Lower an expression tree to a postfix program.

    Reference: expr_builder.rs append_rpn_nodes_recursively — post-order
    walk; function nodes validated against the registry (arity + name).
    """
    nodes: list[RpnNode] = []

    def walk(e: Expr):
        if e.kind == "const":
            nodes.append(RpnConst(e.value, e.eval_type or EvalType.INT))
        elif e.kind == "column":
            nodes.append(RpnColumnRef(e.col_idx, e.eval_type or EvalType.INT))
        elif e.kind == "call":
            meta = FUNCTIONS.get(e.sig)
            if meta is None:
                raise ValueError(f"unknown ScalarFuncSig {e.sig!r}")
            if meta.arity is not None and len(e.children) != meta.arity:
                raise ValueError(
                    f"{e.sig}: expected {meta.arity} args, got {len(e.children)}")
            if meta.arity is None and len(e.children) < 1:
                raise ValueError(f"{e.sig}: variadic sig needs >=1 arg")
            for c in e.children:
                walk(c)
            ctx = (63, ())
            if meta.needs_ctx:
                # explicit on the call, else inherited from the subtree,
                # as tipb derives a call's field type (``Upper(ci_col)``
                # keeps ci)
                coll, elems = e.collation, tuple(e.elems)
                if coll == 63 or not elems:
                    sc, se = _subtree_ctx(e)
                    coll = sc if coll == 63 else coll
                    elems = elems or tuple(se)
                ctx = (coll, elems)
            nodes.append(RpnFnCall(meta, len(e.children), ctx))
        else:
            raise ValueError(f"bad expr kind {e.kind}")

    walk(tree)
    return RpnExpression(tuple(nodes))
