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
            nodes.append(RpnFnCall(meta, len(e.children)))
        else:
            raise ValueError(f"bad expr kind {e.kind}")

    walk(tree)
    return RpnExpression(tuple(nodes))
