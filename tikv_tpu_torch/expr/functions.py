"""ScalarFuncSig registry — vectorized scalar functions.

Reference: components/tidb_query_expr/src/lib.rs ``map_expr_node_to_rpn_func``
(impl_arithmetic.rs, impl_compare.rs, impl_op.rs, impl_control.rs,
impl_cast.rs, impl_math.rs) and the family modules (``impl_types``,
``impl_time``, ``impl_string``, ``impl_like``, ``impl_misc``).  Signature
names match the reference's ScalarFuncSig variants one-for-one; the JAX
package's registry holds the same sigs and the JSON family besides.

Each implementation is written against an array namespace ``xp`` —
``numpy`` for host-side bounds and recodes, ``torch`` on the device — and
maps ``(values, validity) × arity → (values, validity)``:

- NULL slots hold value 0, so kernels never see garbage;
- tri-state logic follows MySQL (impl_op.rs logical_and/logical_or);
- division by zero yields NULL;
- boolean-valued results are int32 (0/1).

``RpnFnMeta.device_safe`` marks the bodies that run on torch tensors: the
arithmetic, comparison, logic, NULL-test, control, identity-cast and math
families over INT and REAL, the shifts, and the Time and Duration
comparisons.  The device runner admits only those (``_rpn_device_safe``);
every other sig — the converting casts, CRC32 and the family modules over
strings, DECIMAL, time fields, enum/set and addresses — computes with
numpy on the host pipeline whatever ``xp`` it is handed.  ``needs_ctx``
sigs take the node's (collation, enum/set names) as ``ctx=``, ``needs_rows``
sigs the row count as ``n_rows=`` (``eval.py``).  The JSON family
(``impl_json``) is host only, as in the reference.

INT arithmetic (``PlusInt``, ``MinusInt``, ``MultiplyInt``,
``UnaryMinusInt``) and the shifts (``LeftShift``, ``RightShift``) carry
``RpnFnMeta.int64``: they evaluate in int64 on the torch path, so an int32
column does not wrap where the host's int64 pipeline does not;
``eval.narrow_int32`` keeps an arithmetic call in int32 where the
columns' bounds prove its result fits (a shift stays int64).
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..datatype import EvalType

Pair = tuple  # (values, validity)


@dataclass(frozen=True)
class RpnFnMeta:
    name: str
    arity: Optional[int]          # None = variadic
    ret: EvalType
    args: tuple                   # arg EvalTypes; for variadic, the repeated type
    fn: Callable                  # fn(xp, *pairs) -> pair
    # sig consults the node's (collation, elems) context — eval passes
    # ``ctx=`` (collation-dispatched string sigs, enum/set sigs)
    needs_ctx: bool = False
    # nondeterministic 0-arity sigs (UUID) produce one value per row —
    # eval passes ``n_rows=``
    needs_rows: bool = False
    # the body runs on torch tensors: the device runner admits only these
    device_safe: bool = False
    # torch path: widen integer operands to a common dtype before the
    # call (eval.py); off where an argument never meets the others in
    # arithmetic, so the result keeps the first argument's dtype
    widen: bool = True
    # torch path: int32 operands are cast to int64 before the call (INT
    # arithmetic, whose int32 result could wrap)
    int64: bool = False


FUNCTIONS: dict[str, RpnFnMeta] = {}


def rpn_fn(name: str, arity: Optional[int], ret: EvalType, args: tuple,
           needs_ctx: bool = False, needs_rows: bool = False,
           device_safe: bool = False, widen: bool = True,
           int64: bool = False):

    def deco(fn):
        FUNCTIONS[name] = RpnFnMeta(name, arity, ret, args, fn, needs_ctx,
                                    needs_rows, device_safe, widen, int64)
        return fn
    return deco


def _rpn_fn_xp(name: str, arity: Optional[int], ret: EvalType,
               args: tuple, **kw):
    """``rpn_fn`` for bodies written against ``xp`` (numpy or torch):
    device-safe at the declaration site."""
    return rpn_fn(name, arity, ret, args, device_safe=True, **kw)


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
        @_rpn_fn_xp(name, 2, ret, (ty, ty), int64=ty is I)
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

    @_rpn_fn_xp("DivideReal", 2, R, (R, R))
    def divide_real(xp, a, b):
        (av, am), (bv, bm) = a, b
        zero = bv == 0
        safe = xp.where(zero, xp.ones_like(bv), bv)
        return av / safe, am & bm & ~zero

    @_rpn_fn_xp("IntDivideInt", 2, I, (I, I))
    def int_divide_int(xp, a, b):
        (av, am), (bv, bm) = a, b
        zero = bv == 0
        safe = xp.where(zero, xp.ones_like(bv), bv)
        # MySQL DIV truncates toward zero; // floors — correct the sign case.
        q = av // safe
        r = av - q * safe
        q = xp.where((r != 0) & ((av < 0) != (bv < 0)), q + 1, q)
        return q, am & bm & ~zero

    @_rpn_fn_xp("ModInt", 2, I, (I, I))
    def mod_int(xp, a, b):
        (av, am), (bv, bm) = a, b
        zero = bv == 0
        safe = xp.where(zero, xp.ones_like(bv), bv)
        # MySQL % takes the sign of the dividend (truncated division).
        m = av - (xp.where((av - (av // safe) * safe != 0)
                           & ((av < 0) != (bv < 0)),
                           av // safe + 1, av // safe)) * safe
        return m, am & bm & ~zero

    @_rpn_fn_xp("ModReal", 2, R, (R, R))
    def mod_real(xp, a, b):
        (av, am), (bv, bm) = a, b
        zero = bv == 0
        safe = xp.where(zero, xp.ones_like(bv), bv)
        m = av - xp.trunc(av / safe) * safe
        return m, am & bm & ~zero

    for suffix, ty in (("Int", I), ("Real", R)):
        @_rpn_fn_xp("UnaryMinus" + suffix, 1, ty, (ty,), int64=ty is I)
        def unary_minus(xp, a):
            (av, am) = a
            return -av, am

        @_rpn_fn_xp("Abs" + suffix, 1, ty, (ty,))
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
            @_rpn_fn_xp(stem + suffix, 2, I, (ty, ty))
            def _f(xp, a, b, _op=op):
                (av, am), (bv, bm) = a, b
                return _ibool(xp, _op(av, bv)), am & bm

    for suffix, ty in (("Int", I), ("Real", R)):
        @_rpn_fn_xp("NullEq" + suffix, 2, I, (ty, ty))
        def null_eq(xp, a, b):
            (av, am), (bv, bm) = a, b
            both_null = ~am & ~bm
            eq = am & bm & (av == bv)
            return _ibool(xp, both_null | eq), xp.ones_like(am)

        @_rpn_fn_xp("Greatest" + suffix, None, ty, (ty,))
        def greatest(xp, *pairs):
            out, valid = pairs[0]
            for v, m in pairs[1:]:
                out = xp.maximum(out, v)
                valid = valid & m
            return out, valid

        @_rpn_fn_xp("Least" + suffix, None, ty, (ty,))
        def least(xp, *pairs):
            out, valid = pairs[0]
            for v, m in pairs[1:]:
                out = xp.minimum(out, v)
                valid = valid & m
            return out, valid

        @_rpn_fn_xp("In" + suffix, None, I, (ty,))
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

    @_rpn_fn_xp("LogicalAnd", 2, I, (I, I))
    def logical_and(xp, a, b):
        (av, am), (bv, bm) = a, b
        a_false = am & (av == 0)
        b_false = bm & (bv == 0)
        value = _ibool(xp, ~(a_false | b_false))
        valid = (am & bm) | a_false | b_false
        return value, valid

    @_rpn_fn_xp("LogicalOr", 2, I, (I, I))
    def logical_or(xp, a, b):
        (av, am), (bv, bm) = a, b
        a_true = am & (av != 0)
        b_true = bm & (bv != 0)
        value = _ibool(xp, a_true | b_true)
        valid = (am & bm) | a_true | b_true
        return value, valid

    @_rpn_fn_xp("LogicalXor", 2, I, (I, I))
    def logical_xor(xp, a, b):
        (av, am), (bv, bm) = a, b
        return _ibool(xp, (av != 0) ^ (bv != 0)), am & bm

    for suffix, ty in (("Int", I), ("Real", R)):
        @_rpn_fn_xp("UnaryNot" + suffix, 1, I, (ty,))
        def unary_not(xp, a):
            (av, am) = a
            return _ibool(xp, av == 0), am

        @_rpn_fn_xp("IsNull" + suffix, 1, I, (ty,))
        def is_null(xp, a):
            (av, am) = a
            return _ibool(xp, ~am), xp.ones_like(am)

        @_rpn_fn_xp(suffix + "IsTrue", 1, I, (ty,))
        def is_true(xp, a):
            (av, am) = a
            return _ibool(xp, am & (av != 0)), xp.ones_like(am)

        @_rpn_fn_xp(suffix + "IsFalse", 1, I, (ty,))
        def is_false(xp, a):
            (av, am) = a
            return _ibool(xp, am & (av == 0)), xp.ones_like(am)

    # bit ops — impl_op.rs bit_and etc.
    bitops = {"BitAndSig": lambda a, b: a & b,
              "BitOrSig": lambda a, b: a | b,
              "BitXorSig": lambda a, b: a ^ b}
    for name, op in bitops.items():
        @_rpn_fn_xp(name, 2, I, (I, I))
        def _bit(xp, a, b, _op=op):
            (av, am), (bv, bm) = a, b
            return _op(av, bv), am & bm

    @_rpn_fn_xp("BitNegSig", 1, I, (I,))
    def bit_neg(xp, a):
        (av, am) = a
        return ~av, am

    # shifts of 64 or more (or negative) give 0; int64 on every route, so
    # an int32 plane shifts as the host's int64 pipeline does
    for name, left in (("LeftShift", True), ("RightShift", False)):
        @_rpn_fn_xp(name, 2, I, (I, I), int64=True)
        def _shift(xp, a, b, _left=left):
            (av, am), (bv, bm) = a, b
            big = (bv < 0) | (bv >= 64)
            safe = xp.where(big, xp.zeros_like(bv), bv)
            shifted = av << safe if _left else av >> safe
            return xp.where(big, xp.zeros_like(av), shifted), am & bm


# ---------------------------------------------------------------------------
# Control — reference: impl_control.rs
# ---------------------------------------------------------------------------

def _register_control():
    I, R = EvalType.INT, EvalType.REAL
    for suffix, ty in (("Int", I), ("Real", R)):
        @_rpn_fn_xp("If" + suffix, 3, ty, (I, ty, ty))
        def if_fn(xp, c, t, f):
            (cv, cm), (tv, tm), (fv, fm) = c, t, f
            cond = cm & (cv != 0)
            return xp.where(cond, tv, fv), xp.where(cond, tm, fm)

        @_rpn_fn_xp("IfNull" + suffix, 2, ty, (ty, ty))
        def if_null(xp, a, b):
            (av, am), (bv, bm) = a, b
            return xp.where(am, av, bv), am | bm

        @_rpn_fn_xp("CaseWhen" + suffix, None, ty, (ty,))
        def case_when(xp, *pairs):
            # cond1, res1, cond2, res2, ..., [else]: the first true cond wins
            n = len(pairs)
            conds = [(pairs[i], pairs[i + 1]) for i in range(0, n - 1, 2)]
            if n % 2 == 1:
                out_v, out_m = pairs[-1]
            else:
                (v0, m0) = conds[0][1]
                out_v, out_m = xp.zeros_like(v0), xp.zeros_like(m0)
            for (cv, cm), (rv, rm) in reversed(conds):
                hit = cm & (cv != 0)
                out_v = xp.where(hit, rv, out_v)
                out_m = xp.where(hit, rm, out_m)
            return out_v, out_m

        @_rpn_fn_xp("Coalesce" + suffix, None, ty, (ty,))
        def coalesce(xp, *pairs):
            out_v, out_m = pairs[-1]
            for (v, m) in reversed(pairs[:-1]):
                out_v = xp.where(m, v, out_v)
                out_m = m | out_m
            return out_v, out_m


# ---------------------------------------------------------------------------
# Casts — reference: impl_cast.rs (the identity casts are device-safe; the
# converting casts run on the host pipeline only, over numpy)
# ---------------------------------------------------------------------------

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _cast_string_int(s: bytes) -> int:
    """MySQL's longest numeric prefix (empty or invalid → 0), clamped to
    the int64 bounds (a truncation warning in MySQL; silent here)."""
    s = s.strip()
    i, n = 0, len(s)
    if i < n and s[i:i + 1] in (b"+", b"-"):
        i += 1
    j = i
    while j < n and 0x30 <= s[j] <= 0x39:
        j += 1
    try:
        v = int(s[:j])
    except ValueError:
        return 0
    return min(max(v, _I64_MIN), _I64_MAX)


def _cast_string_real(s: bytes) -> float:
    """The longest valid float prefix; an exponent counts only with a
    digit after it (b"15e" parses as 15)."""
    s = s.strip()
    j, n = 0, len(s)
    if j < n and s[j:j + 1] in (b"+", b"-"):
        j += 1
    digits = 0
    seen_dot = False
    while j < n:
        c = s[j:j + 1]
        if c.isdigit():
            digits += 1
            j += 1
        elif c == b"." and not seen_dot:
            seen_dot = True
            j += 1
        else:
            break
    if digits and j < n and s[j:j + 1] in (b"e", b"E"):
        k = j + 1
        if k < n and s[k:k + 1] in (b"+", b"-"):
            k += 1
        if k < n and s[k:k + 1].isdigit():
            while k < n and s[k:k + 1].isdigit():
                k += 1
            j = k
    try:
        return float(s[:j])
    except ValueError:
        return 0.0


def _map_object(fn, values) -> np.ndarray:
    return np.asarray(np.frompyfunc(fn, 1, 1)(
        np.asarray(values, dtype=object)), dtype=object)


def _register_cast():
    I, R, B = EvalType.INT, EvalType.REAL, EvalType.BYTES

    @_rpn_fn_xp("CastIntAsInt", 1, I, (I,))
    def cast_int_int(xp, a):
        return a

    @_rpn_fn_xp("CastRealAsReal", 1, R, (R,))
    def cast_real_real(xp, a):
        return a

    @rpn_fn("CastIntAsReal", 1, R, (I,))
    def cast_int_real(xp, a):
        (av, am) = a
        return np.asarray(av).astype(np.float64), am

    @rpn_fn("CastRealAsInt", 1, I, (R,))
    def cast_real_int(xp, a):
        # MySQL rounds half away from zero on cast
        (av, am) = a
        rounded = np.where(av >= 0, np.floor(av + 0.5), np.ceil(av - 0.5))
        return rounded.astype(np.int64), am

    @rpn_fn("CastStringAsInt", 1, I, (B,))
    def cast_string_int(xp, a):
        (av, am) = a
        return _map_object(_cast_string_int, av).astype(np.int64), am

    @rpn_fn("CastStringAsReal", 1, R, (B,))
    def cast_string_real(xp, a):
        (av, am) = a
        return _map_object(_cast_string_real, av).astype(np.float64), am

    @rpn_fn("CastIntAsString", 1, B, (I,))
    def cast_int_string(xp, a):
        (av, am) = a
        return np.frompyfunc(lambda v: b"%d" % int(v), 1, 1)(
            np.asarray(av, dtype=np.int64)), am

    @rpn_fn("CastRealAsString", 1, B, (R,))
    def cast_real_string(xp, a):
        (av, am) = a
        return np.frompyfunc(lambda v: repr(float(v)).encode(), 1, 1)(
            np.asarray(av, dtype=np.float64)), am

    @rpn_fn("CastStringAsString", 1, B, (B,))
    def cast_string_string(xp, a):
        return a


# ---------------------------------------------------------------------------
# Math — reference: impl_math.rs
# ---------------------------------------------------------------------------

def _power(xp, base, exponent):
    return np.power(base, exponent) if xp is np else torch.pow(base, exponent)


def _register_math():
    I, R = EvalType.INT, EvalType.REAL

    def unary_real(name, op, domain=None):
        @_rpn_fn_xp(name, 1, R, (R,))
        def _f(xp, a, _op=op, _dom=domain):
            (av, am) = a
            if _dom is not None:
                ok = _dom(xp, av)
                safe = xp.where(ok, av, xp.ones_like(av))
                return _op(xp, safe), am & ok
            return _op(xp, av), am

    unary_real("Sqrt", lambda xp, v: xp.sqrt(v), lambda xp, v: v >= 0)
    unary_real("Exp", lambda xp, v: xp.exp(v))
    unary_real("Ln", lambda xp, v: xp.log(v), lambda xp, v: v > 0)
    unary_real("Log2", lambda xp, v: xp.log2(v), lambda xp, v: v > 0)
    unary_real("Log10", lambda xp, v: xp.log10(v), lambda xp, v: v > 0)
    unary_real("Sin", lambda xp, v: xp.sin(v))
    unary_real("Cos", lambda xp, v: xp.cos(v))
    unary_real("Tan", lambda xp, v: xp.tan(v))
    unary_real("Cot", lambda xp, v: 1.0 / xp.tan(v),
               lambda xp, v: xp.sin(v) != 0)
    unary_real("Asin", lambda xp, v: xp.arcsin(v),
               lambda xp, v: xp.abs(v) <= 1)
    unary_real("Acos", lambda xp, v: xp.arccos(v),
               lambda xp, v: xp.abs(v) <= 1)
    unary_real("Atan1Arg", lambda xp, v: xp.arctan(v))
    unary_real("CeilReal", lambda xp, v: xp.ceil(v))
    unary_real("FloorReal", lambda xp, v: xp.floor(v))
    unary_real("RoundReal", lambda xp, v: xp.where(
        v >= 0, xp.floor(v + 0.5), xp.ceil(v - 0.5)))
    unary_real("Radians", lambda xp, v: v * (math.pi / 180.0))
    unary_real("Degrees", lambda xp, v: v * (180.0 / math.pi))

    @_rpn_fn_xp("Atan2Args", 2, R, (R, R))
    def atan2(xp, a, b):
        (av, am), (bv, bm) = a, b
        return xp.arctan2(av, bv), am & bm

    @_rpn_fn_xp("Pow", 2, R, (R, R))
    def pow_(xp, a, b):
        (av, am), (bv, bm) = a, b
        # guard 0^negative and negative^fractional
        bad = ((av == 0) & (bv < 0)) | ((av < 0) & (bv != xp.trunc(bv)))
        safe_a = xp.where(bad, xp.ones_like(av), av)
        return _power(xp, safe_a, bv), am & bm & ~bad

    @_rpn_fn_xp("Pi", 0, R, ())
    def pi(xp):
        # float64, as the reference's weakly typed jnp scalar: beside a
        # float32 column it yields to the column's dtype in both packages
        if xp is np:
            return np.asarray(math.pi), np.ones((), dtype=np.bool_)
        return (torch.tensor(math.pi, dtype=torch.float64),
                torch.ones((), dtype=torch.bool))

    @_rpn_fn_xp("SignReal", 1, I, (R,))
    def sign(xp, a):
        (av, am) = a
        s = xp.sign(av)
        return (s.astype(np.int32) if xp is np else s.to(torch.int32)), am

    @_rpn_fn_xp("SignInt", 1, I, (I,))
    def sign_int(xp, a):
        (av, am) = a
        return xp.sign(av), am

    for name in ("CeilIntToInt", "FloorIntToInt", "RoundInt"):
        @_rpn_fn_xp(name, 1, I, (I,))
        def int_identity(xp, a):
            return a

    @_rpn_fn_xp("TruncateReal", 2, R, (R, I))
    def truncate_real(xp, a, d):
        (av, am), (dv, dm) = a, d
        dv = dv.astype(av.dtype) if xp is np else dv.to(av.dtype)
        scale = _power(xp, 10.0, dv)
        return xp.trunc(av * scale) / scale, am & dm

    @rpn_fn("CRC32", 1, I, (EvalType.BYTES,))
    def crc32(xp, a):
        (av, am) = a
        return np.fromiter((zlib.crc32(x) for x in av), dtype=np.int64,
                           count=len(av)), am

    # the digit count only masks and scales: the result keeps the value's
    # dtype, as under the reference's per-operation promotion
    @_rpn_fn_xp("TruncateInt", 2, I, (I, I), widen=False)
    def truncate_int(xp, a, d):
        (av, am), (dv, dm) = a, d
        neg = xp.where(dv < 0, -dv, xp.zeros_like(dv))
        if xp is np:
            neg = np.minimum(neg, 18)
            p = np.asarray(10, dtype=av.dtype) ** neg.astype(av.dtype)
        else:
            p = torch.pow(10, neg.clamp(max=18).to(av.dtype))
        # MySQL truncates toward zero; // floors — correct negative values
        q = av // p
        q = xp.where((av < 0) & (q * p != av), q + 1, q)
        return xp.where(dv < 0, q * p, av), am & dm


_register_arith()
_register_compare()
_register_logic()
_register_control()
_register_cast()
_register_math()

# family modules (imported late: they need the registry decorator above)
from . import impl_json as _impl_json      # noqa: E402
from . import impl_like as _impl_like      # noqa: E402
from . import impl_misc as _impl_misc      # noqa: E402
from . import impl_string as _impl_string  # noqa: E402
from . import impl_time as _impl_time      # noqa: E402
from . import impl_types as _impl_types    # noqa: E402

_impl_string.register()
_impl_like.register()
_impl_time.register()
_impl_types.register()
_impl_json.register()
_impl_misc.register()
