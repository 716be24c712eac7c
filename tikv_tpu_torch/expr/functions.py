"""ScalarFuncSig registry — the device-safe families of the slice.

Reference: components/tidb_query_expr/src/lib.rs ``map_expr_node_to_rpn_func``
(impl_arithmetic.rs, impl_compare.rs, impl_op.rs).  Signature names match
the reference's ScalarFuncSig variants one-for-one.

Each implementation is written against an array namespace ``xp`` —
``numpy`` for host-side bounds and recodes, ``torch`` on the device — and
maps ``(values, validity) × arity → (values, validity)``:

- NULL slots hold value 0, so kernels never see garbage;
- tri-state logic follows MySQL (impl_op.rs logical_and/logical_or);
- division by zero yields NULL;
- boolean-valued results are int32 (0/1).

Only the families the device gate admits are here: arithmetic,
comparison, logic and the NULL tests.  A plan calling any other sig is
outside the port's envelope (``DeviceRunner.supports`` is False).
Integer overflow wraps in the operands' dtype, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..datatype import EvalType

Pair = tuple  # (values, validity)


@dataclass(frozen=True)
class RpnFnMeta:
    name: str
    arity: Optional[int]          # None = variadic
    ret: EvalType
    args: tuple                   # arg EvalTypes; for variadic, the repeated type
    fn: Callable                  # fn(xp, *pairs) -> pair


FUNCTIONS: dict[str, RpnFnMeta] = {}


def rpn_fn(name: str, arity: Optional[int], ret: EvalType, args: tuple):

    def deco(fn):
        FUNCTIONS[name] = RpnFnMeta(name, arity, ret, args, fn)
        return fn
    return deco


def _ibool(xp, cond):
    """bool → int32 0/1 in the namespace's own idiom."""
    if xp is np:
        return np.asarray(cond).astype(np.int32)
    return cond.to(xp.int32)


# ---------------------------------------------------------------------------
# Arithmetic — reference: impl_arithmetic.rs
# ---------------------------------------------------------------------------

def _register_arith():
    I, R = EvalType.INT, EvalType.REAL

    def binop(name, ret, ty, op):
        @rpn_fn(name, 2, ret, (ty, ty))
        def _f(xp, a, b, _op=op):
            (av, am), (bv, bm) = a, b
            return _op(av, bv), am & bm
        return _f

    binop("PlusInt", I, I, lambda a, b: a + b)
    binop("MinusInt", I, I, lambda a, b: a - b)
    binop("MultiplyInt", I, I, lambda a, b: a * b)
    binop("PlusReal", R, R, lambda a, b: a + b)
    binop("MinusReal", R, R, lambda a, b: a - b)
    binop("MultiplyReal", R, R, lambda a, b: a * b)

    @rpn_fn("DivideReal", 2, R, (R, R))
    def divide_real(xp, a, b):
        (av, am), (bv, bm) = a, b
        zero = bv == 0
        safe = xp.where(zero, xp.ones_like(bv), bv)
        return av / safe, am & bm & ~zero

    @rpn_fn("IntDivideInt", 2, I, (I, I))
    def int_divide_int(xp, a, b):
        (av, am), (bv, bm) = a, b
        zero = bv == 0
        safe = xp.where(zero, xp.ones_like(bv), bv)
        # MySQL DIV truncates toward zero; // floors — correct the sign case.
        q = av // safe
        r = av - q * safe
        q = xp.where((r != 0) & ((av < 0) != (bv < 0)), q + 1, q)
        return q, am & bm & ~zero

    @rpn_fn("ModInt", 2, I, (I, I))
    def mod_int(xp, a, b):
        (av, am), (bv, bm) = a, b
        zero = bv == 0
        safe = xp.where(zero, xp.ones_like(bv), bv)
        # MySQL % takes the sign of the dividend (truncated division).
        m = av - (xp.where((av - (av // safe) * safe != 0)
                           & ((av < 0) != (bv < 0)),
                           av // safe + 1, av // safe)) * safe
        return m, am & bm & ~zero

    @rpn_fn("ModReal", 2, R, (R, R))
    def mod_real(xp, a, b):
        (av, am), (bv, bm) = a, b
        zero = bv == 0
        safe = xp.where(zero, xp.ones_like(bv), bv)
        m = av - xp.trunc(av / safe) * safe
        return m, am & bm & ~zero

    for suffix, ty in (("Int", I), ("Real", R)):
        @rpn_fn("UnaryMinus" + suffix, 1, ty, (ty,))
        def unary_minus(xp, a):
            (av, am) = a
            return -av, am

        @rpn_fn("Abs" + suffix, 1, ty, (ty,))
        def abs_(xp, a):
            (av, am) = a
            return xp.abs(av), am


# ---------------------------------------------------------------------------
# Comparison — reference: impl_compare.rs
# ---------------------------------------------------------------------------

def _register_compare():
    I, R = EvalType.INT, EvalType.REAL
    cmps = {
        "Gt": lambda a, b: a > b,
        "Ge": lambda a, b: a >= b,
        "Lt": lambda a, b: a < b,
        "Le": lambda a, b: a <= b,
        "Eq": lambda a, b: a == b,
        "Ne": lambda a, b: a != b,
    }
    for stem, op in cmps.items():
        for suffix, ty in (("Int", I), ("Real", R)):
            @rpn_fn(stem + suffix, 2, I, (ty, ty))
            def _f(xp, a, b, _op=op):
                (av, am), (bv, bm) = a, b
                return _ibool(xp, _op(av, bv)), am & bm

    for suffix, ty in (("Int", I), ("Real", R)):
        @rpn_fn("NullEq" + suffix, 2, I, (ty, ty))
        def null_eq(xp, a, b):
            (av, am), (bv, bm) = a, b
            both_null = ~am & ~bm
            eq = am & bm & (av == bv)
            return _ibool(xp, both_null | eq), xp.ones_like(am)

        @rpn_fn("Greatest" + suffix, None, ty, (ty,))
        def greatest(xp, *pairs):
            out, valid = pairs[0]
            for v, m in pairs[1:]:
                out = xp.maximum(out, v)
                valid = valid & m
            return out, valid

        @rpn_fn("Least" + suffix, None, ty, (ty,))
        def least(xp, *pairs):
            out, valid = pairs[0]
            for v, m in pairs[1:]:
                out = xp.minimum(out, v)
                valid = valid & m
            return out, valid

        @rpn_fn("In" + suffix, None, I, (ty,))
        def in_list(xp, *pairs):
            # pairs[0] is the probe; the rest the list.  MySQL IN: NULL if
            # no match and any list element (or the probe) is NULL.
            (pv, pm) = pairs[0]
            hit = None
            any_null = ~pm
            for (lv, lm) in pairs[1:]:
                h = pm & lm & (pv == lv)
                hit = h if hit is None else (hit | h)
                any_null = any_null | ~lm
            if hit is None:
                hit = xp.zeros_like(pm)
            return _ibool(xp, hit), hit | ~any_null


# ---------------------------------------------------------------------------
# Logical ops and NULL tests — reference: impl_op.rs
# ---------------------------------------------------------------------------

def _register_logic():
    I, R = EvalType.INT, EvalType.REAL

    @rpn_fn("LogicalAnd", 2, I, (I, I))
    def logical_and(xp, a, b):
        (av, am), (bv, bm) = a, b
        a_false = am & (av == 0)
        b_false = bm & (bv == 0)
        value = _ibool(xp, ~(a_false | b_false))
        valid = (am & bm) | a_false | b_false
        return value, valid

    @rpn_fn("LogicalOr", 2, I, (I, I))
    def logical_or(xp, a, b):
        (av, am), (bv, bm) = a, b
        a_true = am & (av != 0)
        b_true = bm & (bv != 0)
        value = _ibool(xp, a_true | b_true)
        valid = (am & bm) | a_true | b_true
        return value, valid

    @rpn_fn("LogicalXor", 2, I, (I, I))
    def logical_xor(xp, a, b):
        (av, am), (bv, bm) = a, b
        return _ibool(xp, (av != 0) ^ (bv != 0)), am & bm

    for suffix, ty in (("Int", I), ("Real", R)):
        @rpn_fn("UnaryNot" + suffix, 1, I, (ty,))
        def unary_not(xp, a):
            (av, am) = a
            return _ibool(xp, av == 0), am

        @rpn_fn("IsNull" + suffix, 1, I, (ty,))
        def is_null(xp, a):
            (av, am) = a
            return _ibool(xp, ~am), xp.ones_like(am)

        @rpn_fn(suffix + "IsTrue", 1, I, (ty,))
        def is_true(xp, a):
            (av, am) = a
            return _ibool(xp, am & (av != 0)), xp.ones_like(am)

        @rpn_fn(suffix + "IsFalse", 1, I, (ty,))
        def is_false(xp, a):
            (av, am) = a
            return _ibool(xp, am & (av == 0)), xp.ones_like(am)

    # bit ops — impl_op.rs bit_and etc.
    bitops = {"BitAndSig": lambda a, b: a & b,
              "BitOrSig": lambda a, b: a | b,
              "BitXorSig": lambda a, b: a ^ b}
    for name, op in bitops.items():
        @rpn_fn(name, 2, I, (I, I))
        def _bit(xp, a, b, _op=op):
            (av, am), (bv, bm) = a, b
            return _op(av, bv), am & bm

    @rpn_fn("BitNegSig", 1, I, (I,))
    def bit_neg(xp, a):
        (av, am) = a
        return ~av, am


_register_arith()
_register_compare()
_register_logic()
