"""Expression trees — the plan-side AST.

Reference: ``tipb::Expr`` protobuf trees consumed by
tidb_query_expr/src/types/expr_builder.rs. Plans (copr/dag.py) carry these;
``build_rpn`` lowers them to postfix RpnExpression programs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

from ..datatype import EvalType, FieldType


@dataclass(frozen=True)
class Expr:
    """One AST node: a constant, a column reference, or a function call.

    ``sig`` is the ScalarFuncSig name for calls (e.g. "GtInt", "PlusReal") —
    the same naming as the reference's ScalarFuncSig enum so parity can be
    audited sig-by-sig.
    """

    kind: str                     # "const" | "column" | "call"
    value: object = None          # const payload (None = NULL literal)
    eval_type: Optional[EvalType] = None
    col_idx: int = -1
    sig: str = ""
    children: tuple = field(default_factory=tuple)
    # tipb Expr.field_type carries these; string sigs dispatch on the
    # collation, enum/set sigs need the definition's name table
    collation: int = 63
    elems: tuple = ()

    # -- constructors -------------------------------------------------------

    @staticmethod
    def const(value, eval_type: EvalType) -> "Expr":
        return Expr(kind="const", value=value, eval_type=eval_type)

    @staticmethod
    def null(eval_type: EvalType) -> "Expr":
        return Expr(kind="const", value=None, eval_type=eval_type)

    @staticmethod
    def column(idx: int, eval_type: EvalType = EvalType.INT,
               collation: int = 63, elems: tuple = ()) -> "Expr":
        return Expr(kind="column", col_idx=idx, eval_type=eval_type,
                    collation=collation, elems=tuple(elems))

    @staticmethod
    def call(sig: str, *children: "Expr", collation: int = 63,
             elems: tuple = ()) -> "Expr":
        return Expr(kind="call", sig=sig, children=tuple(children),
                    collation=collation, elems=tuple(elems))

    # -- sugar for tests / plan builders ------------------------------------

    def _bin(self, other, int_sig: str, real_sig: str) -> "Expr":
        other = _coerce(other, self)
        et = _common_type(self, other)
        sig = real_sig if et is EvalType.REAL else int_sig
        return Expr.call(sig, self, other)

    def __add__(self, o): return self._bin(o, "PlusInt", "PlusReal")
    def __sub__(self, o): return self._bin(o, "MinusInt", "MinusReal")
    def __mul__(self, o): return self._bin(o, "MultiplyInt", "MultiplyReal")
    def __gt__(self, o): return self._bin(o, "GtInt", "GtReal")
    def __ge__(self, o): return self._bin(o, "GeInt", "GeReal")
    def __lt__(self, o): return self._bin(o, "LtInt", "LtReal")
    def __le__(self, o): return self._bin(o, "LeInt", "LeReal")
    def eq(self, o): return self._bin(o, "EqInt", "EqReal")
    def ne(self, o): return self._bin(o, "NeInt", "NeReal")
    def and_(self, o): return Expr.call("LogicalAnd", self, _coerce(o, self))
    def or_(self, o): return Expr.call("LogicalOr", self, _coerce(o, self))
    def not_(self): return Expr.call("UnaryNotInt", self)
    def is_null(self): return Expr.call("IsNullInt", self)


def _coerce(x, like: Expr) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, bool):
        return Expr.const(int(x), EvalType.INT)
    if isinstance(x, int):
        return Expr.const(x, EvalType.INT)
    if isinstance(x, float):
        return Expr.const(x, EvalType.REAL)
    if isinstance(x, bytes):
        return Expr.const(x, EvalType.BYTES)
    raise TypeError(f"cannot coerce {type(x)} to Expr")


def _expr_type(e: Expr) -> Optional[EvalType]:
    if e.kind == "call":
        # derive from the registered sig's return type
        from .functions import FUNCTIONS
        meta = FUNCTIONS.get(e.sig)
        return meta.ret if meta else None
    return e.eval_type


def _common_type(a: Expr, b: Expr) -> EvalType:
    ta, tb = _expr_type(a), _expr_type(b)
    if EvalType.REAL in (ta, tb):
        return EvalType.REAL
    return ta or tb or EvalType.INT
