"""Vectorized scalar expressions: trees, RPN programs, the evaluator and
the device-safe function registry."""

from .tree import Expr
from .rpn import RpnExpression, RpnConst, RpnColumnRef, RpnFnCall, build_rpn
from .functions import FUNCTIONS, RpnFnMeta
from .eval import eval_rpn

__all__ = [
    "Expr",
    "RpnExpression",
    "RpnConst",
    "RpnColumnRef",
    "RpnFnCall",
    "build_rpn",
    "FUNCTIONS",
    "RpnFnMeta",
    "eval_rpn",
]
