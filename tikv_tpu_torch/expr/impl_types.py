"""Compare / control / IsNull / decimal families across eval types.

Reference: components/tidb_query_expr/src/impl_compare.rs (the Gt/Ge/…
sig matrix over every eval type), impl_control.rs (If/IfNull/CaseWhen/
Coalesce per type), impl_op.rs (*IsNull), impl_arithmetic.rs decimal
ops.  Sig names match the reference ScalarFuncSig variants.

Type representations (datatype/eval_type.py): String = object array of
bytes (binary collation — bytewise order matches MySQL's binary
collation); Decimal = object array of decimal.Decimal with MySQL
65-digit scale/rounding semantics (datatype/mydecimal.py); Time =
packed u64 core (the bit layout is order-preserving: year in the top
bits); Duration = i64 nanoseconds.  The JAX package's
``expr/impl_types.py``, copied.  Only the Time and Duration comparisons are
device-safe: on the device they compare the cores as int64 bits, the
runner's plane for both types.
"""

from __future__ import annotations

import numpy as np

from ..datatype import EvalType
from .functions import FUNCTIONS, RpnFnMeta, rpn_fn, _ibool

I, R, B = EvalType.INT, EvalType.REAL, EvalType.BYTES
DEC, T, D = EvalType.DECIMAL, EvalType.DATETIME, EvalType.DURATION

_FAMS = (("String", B), ("Decimal", DEC), ("Time", T), ("Duration", D))


def _cmp_vals(ty, xp, av, bv, op):
    if ty is B:
        a = np.asarray(av, dtype=object)
        b = np.asarray(bv, dtype=object)
        out = np.frompyfunc(op, 2, 1)(a, b)
        return np.asarray(out, dtype=bool)
    return op(av, bv)


def register() -> None:
    # ---- comparisons ----
    cmps = {
        "Gt": lambda a, b: a > b,
        "Ge": lambda a, b: a >= b,
        "Lt": lambda a, b: a < b,
        "Le": lambda a, b: a <= b,
        "Eq": lambda a, b: a == b,
        "Ne": lambda a, b: a != b,
    }
    from ..datatype import collation as coll

    def _collate(av, bv, c):
        """Map both string operands to their collation sort keys (63 =
        binary = identity, the overwhelmingly common case)."""
        if coll.normalize_id(c) == coll.BINARY:
            return av, bv
        sk = np.frompyfunc(lambda s: coll.sort_key(s, c), 1, 1)
        return sk(np.asarray(av, object)), sk(np.asarray(bv, object))

    for fam, ty in _FAMS:
        for stem, op in cmps.items():
            if ty is B:
                @rpn_fn(stem + fam, 2, I, (ty, ty), needs_ctx=True)
                def _cmp_str(xp, a, b, ctx=(63, ()), _op=op):
                    (av, am), (bv, bm) = a, b
                    av, bv = _collate(av, bv, ctx[0])
                    return _ibool(xp, _cmp_vals(B, xp, av, bv, _op)), \
                        am & bm
                continue

            @rpn_fn(stem + fam, 2, I, (ty, ty),
                    device_safe=(ty in (T, D)))
            def _cmp(xp, a, b, _op=op, _ty=ty):
                # Time/Duration: plain xp comparisons on packed cores —
                # traceable, so these ride the device gate
                (av, am), (bv, bm) = a, b
                return _ibool(xp, _cmp_vals(_ty, xp, av, bv, _op)), am & bm

        @rpn_fn("NullEq" + fam, 2, I, (ty, ty), needs_ctx=(ty is B))
        def _null_eq(xp, a, b, _ty=ty, ctx=(63, ())):
            (av, am), (bv, bm) = a, b
            if _ty is B:
                av, bv = _collate(av, bv, ctx[0])
            both_null = ~am & ~bm
            eq = am & bm & _cmp_vals(_ty, xp, av, bv, lambda x, y: x == y)
            return _ibool(xp, both_null | eq), np.ones_like(np.asarray(am))

        @rpn_fn("In" + fam, None, I, (ty,), needs_ctx=(ty is B))
        def _in(xp, *pairs, _ty=ty, ctx=(63, ())):
            (pv, pm) = pairs[0]
            if _ty is B:
                # IN must agree with = under the collation
                pv, _ = _collate(pv, pv, ctx[0])
            hit = None
            any_null = ~np.asarray(pm)
            for (lv, lm) in pairs[1:]:
                if _ty is B:
                    lv, _ = _collate(lv, lv, ctx[0])
                h = pm & lm & _cmp_vals(_ty, xp, pv, lv,
                                        lambda x, y: x == y)
                hit = h if hit is None else (hit | h)
                any_null = any_null | ~np.asarray(lm)
            if hit is None:
                hit = np.zeros_like(np.asarray(pm))
            return _ibool(xp, hit), hit | ~any_null

    # ---- control ----
    for fam, ty in _FAMS:
        @rpn_fn("If" + fam, 3, ty, (I, ty, ty))
        def _if(xp, c, t, f, _ty=ty):
            (cv, cm), (tv, tm), (fv, fm) = c, t, f
            cond = cm & (cv != 0)
            return np.where(cond, tv, fv), np.where(cond, tm, fm)

        @rpn_fn("IfNull" + fam, 2, ty, (ty, ty))
        def _if_null(xp, a, b, _ty=ty):
            (av, am), (bv, bm) = a, b
            return np.where(am, av, bv), am | bm

        @rpn_fn("CaseWhen" + fam, None, ty, (ty,))
        def _case_when(xp, *pairs, _ty=ty):
            n = len(pairs)
            has_else = n % 2 == 1
            conds = [(pairs[i], pairs[i + 1]) for i in range(0, n - 1, 2)]
            if has_else:
                out_v, out_m = pairs[-1]
            else:
                (v0, m0) = conds[0][1]
                out_v = np.zeros_like(np.asarray(v0))
                out_m = np.zeros_like(np.asarray(m0))
            for (cv, cm), (rv, rm) in reversed(conds):
                hitc = cm & (cv != 0)
                out_v = np.where(hitc, rv, out_v)
                out_m = np.where(hitc, rm, out_m)
            return out_v, out_m

        @rpn_fn("Coalesce" + fam, None, ty, (ty,))
        def _coalesce(xp, *pairs, _ty=ty):
            out_v, out_m = pairs[-1]
            for (v, m) in reversed(pairs[:-1]):
                out_v = np.where(m, v, out_v)
                out_m = m | out_m
            return out_v, out_m

    # ---- Greatest / Least (order types; String orders by collation) ----
    for fam, ty in (("String", B), ("Decimal", DEC), ("Time", T),
                    ("Duration", D)):
        for stem, gt in (("Greatest", True), ("Least", False)):
            @rpn_fn(stem + fam, None, ty, (ty,),
                    needs_ctx=(ty is B))
            def _extreme(xp, *pairs, _ty=ty, _gt=gt, ctx=(63, ())):
                out_v, valid = pairs[0]
                if _ty is B:
                    # collate each operand ONCE; carry the
                    # accumulator's keys instead of re-collating it
                    # per operand (sort_key is a per-char python loop)
                    out_k, _ = _collate(out_v, out_v, ctx[0])
                    for (v, m) in pairs[1:]:
                        kv, _ = _collate(v, v, ctx[0])
                        take = _cmp_vals(
                            B, xp, kv, out_k,
                            (lambda x, y: x > y) if _gt
                            else (lambda x, y: x < y))
                        out_v = np.where(take, v, out_v)
                        out_k = np.where(take, kv, out_k)
                        valid = valid & m
                    return out_v, valid
                for (v, m) in pairs[1:]:
                    out_v = (np.maximum if _gt else np.minimum)(
                        out_v, v)
                    valid = valid & m
                return out_v, valid

    # ---- IsNull / IsTrue / IsFalse (canonical reference names) ----
    for fam, ty in (("Int", I), ("Real", R), ("String", B),
                    ("Decimal", DEC), ("Time", T), ("Duration", D)):
        @rpn_fn(fam + "IsNull", 1, I, (ty,))
        def _is_null(xp, a, _ty=ty):
            (av, am) = a
            return _ibool(xp, ~np.asarray(am)), \
                np.ones_like(np.asarray(am))

    @rpn_fn("DecimalIsTrue", 1, I, (DEC,))
    def dec_is_true(xp, a):
        (av, am) = a
        return _ibool(xp, am & (av != 0)), np.ones_like(np.asarray(am))

    @rpn_fn("DecimalIsFalse", 1, I, (DEC,))
    def dec_is_false(xp, a):
        (av, am) = a
        return _ibool(xp, am & (av == 0)), np.ones_like(np.asarray(am))

    # ---- decimal arithmetic (decimal.Decimal objects, MySQL 65-digit
    #      semantics — datatype/mydecimal.py; reference decimal.rs) ----

    from ..datatype import mydecimal as md

    def _dec_map(fn, *arrs):
        """Elementwise object-array map through a mydecimal op."""
        return np.frompyfunc(fn, len(arrs), 1)(*arrs)

    def _dec_nullable(fn, am, bm, av, bv):
        """Binary op that may yield None (div/mod by zero → NULL)."""
        res = _dec_map(fn, av, bv)
        is_none = np.frompyfunc(lambda x: x is None, 1, 1)(res) \
            .astype(bool)
        res = np.where(is_none, md.ZERO, res)
        return res, am & bm & ~is_none

    for name, fn in (("PlusDecimal", md.add), ("MinusDecimal", md.sub),
                     ("MultiplyDecimal", md.mul)):
        @rpn_fn(name, 2, DEC, (DEC, DEC))
        def _dec_arith(xp, a, b, _fn=fn):
            (av, am), (bv, bm) = a, b
            return _dec_map(_fn, av, bv), am & bm

    for name, fn in (("DivideDecimal", md.div), ("ModDecimal", md.mod)):
        @rpn_fn(name, 2, DEC, (DEC, DEC))
        def _dec_divmod(xp, a, b, _fn=fn):
            (av, am), (bv, bm) = a, b
            return _dec_nullable(_fn, am, bm, av, bv)

    @rpn_fn("UnaryMinusDecimal", 1, DEC, (DEC,))
    def neg_dec(xp, a):
        (av, am) = a
        return _dec_map(lambda x: -x, av), am

    @rpn_fn("AbsDecimal", 1, DEC, (DEC,))
    def abs_dec(xp, a):
        (av, am) = a
        return _dec_map(abs, av), am

    for name, fn in (("CeilDecToDec", md.ceil), ("FloorDecToDec", md.floor),
                     ("RoundDec", md.round_frac),
                     ("TruncateDecimalNoFrac", md.truncate)):
        @rpn_fn(name, 1, DEC, (DEC,))
        def _dec_round1(xp, a, _fn=fn):
            (av, am) = a
            return _dec_map(_fn, av), am

    for name, fn in (("CeilDecToInt", md.ceil), ("FloorDecToInt", md.floor)):
        @rpn_fn(name, 1, I, (DEC,))
        def _dec_to_int_round(xp, a, _fn=fn):
            (av, am) = a
            # bind through _fn (early-bound default) — a late-bound `fn`
            # would leave BOTH sigs evaluating the loop's last function
            ints = _dec_map(lambda x: int(_fn(x)), av)
            return ints.astype(np.int64), am

    @rpn_fn("RoundWithFracDec", 2, DEC, (DEC, I))
    def round_frac_dec(xp, a, f):
        (av, am), (fv, fm) = a, f
        return _dec_map(lambda x, k: md.round_frac(x, int(k)), av,
                        np.broadcast_to(fv, np.shape(av))), am & fm

    # ---- decimal casts ----

    @rpn_fn("CastDecimalAsDecimal", 1, DEC, (DEC,))
    def cast_dec_dec(xp, a):
        return a

    @rpn_fn("CastDecimalAsReal", 1, R, (DEC,))
    def cast_dec_real(xp, a):
        (av, am) = a
        return _dec_map(float, av).astype(np.float64), am

    @rpn_fn("CastIntAsDecimal", 1, DEC, (I,))
    def cast_int_dec(xp, a):
        (av, am) = a
        return _dec_map(md.from_int, np.asarray(av)), am

    @rpn_fn("CastRealAsDecimal", 1, DEC, (R,))
    def cast_real_dec(xp, a):
        (av, am) = a
        return _dec_map(md.from_float, np.asarray(av)), am

    @rpn_fn("CastDecimalAsInt", 1, I, (DEC,))
    def cast_dec_int(xp, a):
        (av, am) = a
        return _dec_map(md.to_int, av).astype(np.int64), am

    @rpn_fn("CastStringAsDecimal", 1, DEC, (B,))
    def cast_str_dec(xp, a):
        (av, am) = a
        return _dec_map(md.from_string, av), am

    @rpn_fn("CastDecimalAsString", 1, B, (DEC,))
    def cast_dec_str(xp, a):
        (av, am) = a
        return _dec_map(md.to_string, av), am

    # ---- collation surface (codec/collation/) ----

    @rpn_fn("WeightString", 1, B, (B,), needs_ctx=True)
    def weight_string(xp, a, ctx=(63, ())):
        """WEIGHT_STRING(str): the collation sort key — what MySQL uses
        for ORDER BY/GROUP BY under the collation; planners wrap string
        order/group expressions with this to get collated semantics."""
        (av, am) = a
        sk = np.frompyfunc(lambda s: coll.sort_key(s, ctx[0]), 1, 1)
        return np.asarray(sk(np.asarray(av, object)), object), am

    # ---- enum / set (codec/mysql/enums.rs, set.rs; cast arms) ----
    #
    # ENUM columns hold the 1-based ordinal (0 = ''), SET columns the
    # element bitmask — both uint64 on host and device-native; the name
    # table rides the FieldType elems through the expr ctx.

    E, S = EvalType.ENUM, EvalType.SET

    @rpn_fn("CastEnumAsString", 1, B, (E,), needs_ctx=True)
    def cast_enum_str(xp, a, ctx=(63, ())):
        (av, am) = a
        f = np.frompyfunc(lambda o: coll.enum_name(int(o), ctx[1]), 1, 1)
        return np.asarray(f(np.asarray(av)), object), am

    @rpn_fn("CastEnumAsInt", 1, I, (E,))
    def cast_enum_int(xp, a):
        (av, am) = a
        return np.asarray(av).astype(np.int64), am

    @rpn_fn("CastStringAsEnum", 1, EvalType.ENUM, (B,), needs_ctx=True)
    def cast_str_enum(xp, a, ctx=(63, ())):
        (av, am) = a
        f = np.frompyfunc(
            lambda s: coll.parse_enum(s, ctx[1], ctx[0]), 1, 1)
        return np.asarray(f(np.asarray(av, object))).astype(np.uint64), am

    @rpn_fn("CastSetAsString", 1, B, (S,), needs_ctx=True)
    def cast_set_str(xp, a, ctx=(63, ())):
        (av, am) = a
        f = np.frompyfunc(lambda m: coll.set_names(int(m), ctx[1]), 1, 1)
        return np.asarray(f(np.asarray(av)), object), am

    @rpn_fn("CastSetAsInt", 1, I, (S,))
    def cast_set_int(xp, a):
        (av, am) = a
        return np.asarray(av).astype(np.int64), am

    @rpn_fn("CastStringAsSet", 1, EvalType.SET, (B,), needs_ctx=True)
    def cast_str_set(xp, a, ctx=(63, ())):
        (av, am) = a
        f = np.frompyfunc(
            lambda s: coll.parse_set(s, ctx[1], ctx[0]), 1, 1)
        return np.asarray(f(np.asarray(av, object))).astype(np.uint64), am
