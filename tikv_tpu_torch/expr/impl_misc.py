"""Math/op/net/string sigs rounding out the registry.

Reference: tidb_query_expr/src/impl_math.rs (Log/Sign/PI/Conv/Round),
impl_op.rs, impl_miscellaneous.rs (the inet/uuid family),
impl_string.rs (FIELD/MAKE_SET/FORMAT/HEX/OCT/INSERT).  Sig names match
the reference's ScalarFuncSig variants.  Host only; ``socket`` parses
and formats addresses and opens no connection.  The JAX package's
``expr/impl_misc.py``, copied.
"""

from __future__ import annotations

import ipaddress
import socket
import struct
import uuid as _uuid

import numpy as np

from ..datatype import EvalType
from .functions import _ibool, rpn_fn

I, R, B = EvalType.INT, EvalType.REAL, EvalType.BYTES
DEC = EvalType.DECIMAL


def _uf(f, nin):
    g = np.frompyfunc(f, nin, 1)

    def call(*args):
        return np.asarray(g(*args), dtype=object)
    return call


def _nulls(out) -> np.ndarray:
    return np.asarray(
        np.frompyfunc(lambda x: x is None, 1, 1)(
            np.asarray(out, dtype=object)), dtype=bool)


def register() -> None:
    # ---- math (impl_math.rs) ----

    @rpn_fn("Log1Arg", 1, R, (R,))
    def log1(xp, a):
        (av, am) = a
        v = np.asarray(av, np.float64)
        ok = np.asarray(am, bool) & (v > 0)     # ln(x<=0) → NULL
        return np.log(np.where(v > 0, v, 1.0)), ok

    @rpn_fn("Log2Args", 2, R, (R, R))
    def log2args(xp, base, x):
        """LOG(base, x): NULL unless base > 0, base != 1, x > 0."""
        (bv, bm), (xv, xm) = base, x
        b = np.asarray(bv, np.float64)
        v = np.asarray(xv, np.float64)
        legal = (b > 0) & (b != 1.0) & (v > 0)
        ok = np.asarray(bm, bool) & np.asarray(xm, bool) & legal
        b_ = np.where(legal, b, 2.0)
        v_ = np.where(legal, v, 1.0)
        return np.log(v_) / np.log(b_), ok

    @rpn_fn("Sign", 1, I, (R,))
    def sign(xp, a):
        (av, am) = a
        v = np.asarray(av, np.float64)
        nan = np.isnan(v)
        s = np.sign(np.where(nan, 0.0, v)).astype(np.int64)
        return s, np.asarray(am, bool) & ~nan   # SIGN(NaN) → NULL

    @rpn_fn("PI", 0, R, ())
    def pi(xp):
        return np.asarray(np.pi, np.float64), np.ones((), bool)

    @rpn_fn("Conv", 3, B, (B, I, I))
    def conv(xp, s, frm, to):
        """CONV(str, from_base, to_base) — bases 2..36, negative to_base
        = signed output (impl_math.rs conv)."""
        (sv, sm), (fv, fm), (tv, tm) = s, frm, to

        def one(txt, f, t):
            f, t = int(f), int(t)
            if not (2 <= abs(f) <= 36 and 2 <= abs(t) <= 36):
                return None
            if isinstance(txt, (bytes, bytearray)):
                txt = txt.decode("utf-8", "replace")
            txt = txt.strip()
            neg = txt.startswith("-")
            if neg:
                txt = txt[1:]
            # longest valid prefix in base |f|
            digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:abs(f)]
            acc = 0
            seen = False
            for ch in txt.lower():
                if ch not in digits:
                    break
                acc = acc * abs(f) + digits.index(ch)
                seen = True
            if not seen:
                return b"0"
            if neg:
                acc = -acc
            # the value domain is u64 (impl_math.rs conv goes through
            # u64); a negative to_base then REINTERPRETS it as i64
            acc &= (1 << 64) - 1
            if t < 0 and acc >= (1 << 63):
                acc -= 1 << 64
            out_digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"[:abs(t)]
            n = acc
            sign_ = ""
            if n < 0:
                sign_, n = "-", -n
            if n == 0:
                return b"0"
            out = []
            while n:
                out.append(out_digits[n % abs(t)])
                n //= abs(t)
            return (sign_ + "".join(reversed(out))).encode()
        res = _uf(one, 3)(np.asarray(sv, object), np.asarray(fv),
                          np.asarray(tv))
        bad = _nulls(res)
        ok = np.asarray(sm, bool) & np.asarray(fm, bool) & \
            np.asarray(tm, bool) & ~bad
        return np.where(bad, b"", res), ok

    @rpn_fn("RoundWithFracReal", 2, R, (R, I))
    def round_frac_real(xp, a, f):
        (av, am), (fv, fm) = a, f

        def one(x, k):
            import decimal
            # f64 carries ~17 significant digits: beyond ±30 the round
            # is an identity, and unclamped exponents overflow the
            # decimal context (InvalidOperation killing the batch)
            k = max(-30, min(30, int(k)))
            # context-object form (localcontext kwargs need 3.11+)
            _ctx = decimal.getcontext().copy()
            _ctx.prec = 40
            with decimal.localcontext(_ctx):
                q = decimal.Decimal(1).scaleb(-k)
                try:
                    return float(decimal.Decimal(repr(float(x)))
                                 .quantize(q,
                                           rounding=decimal.ROUND_HALF_UP))
                except decimal.InvalidOperation:
                    return float(x)     # |x| too large for the frac
        res = _uf(one, 2)(np.asarray(av), np.asarray(fv))
        return res.astype(np.float64), am & fm

    @rpn_fn("RoundWithFracInt", 2, I, (I, I))
    def round_frac_int(xp, a, f):
        (av, am), (fv, fm) = a, f

        def one(x, k):
            k = int(k)
            if k >= 0:
                return int(x)
            if -k > 18:
                return 0        # 10^19 exceeds every int64 magnitude
            m = 10 ** (-k)
            q, r = divmod(abs(int(x)), m)
            q += 1 if r * 2 >= m else 0     # half away from zero
            return q * m * (1 if int(x) >= 0 else -1)
        return _uf(one, 2)(np.asarray(av), np.asarray(fv)) \
            .astype(np.int64), am & fm

    @rpn_fn("AbsUInt", 1, I, (I,))
    def abs_uint(xp, a):
        return a        # unsigned abs is identity (impl_math.rs)

    @rpn_fn("MultiplyIntUnsigned", 2, I, (I, I))
    def mul_uint(xp, a, b):
        (av, am), (bv, bm) = a, b
        prod = (np.asarray(av).astype(np.uint64) *
                np.asarray(bv).astype(np.uint64))
        return prod, am & bm

    @rpn_fn("UnaryNotDecimal", 1, I, (DEC,))
    def not_dec(xp, a):
        (av, am) = a
        return _ibool(np, np.asarray(av, object) == 0), am

    # ---- inet / uuid (impl_miscellaneous.rs) ----

    @rpn_fn("IsIPv4", 1, I, (B,))
    def is_ipv4(xp, a):
        (av, am) = a

        def one(s):
            try:
                ipaddress.IPv4Address(
                    s.decode() if isinstance(s, bytes) else s)
                return 1
            except (ValueError, UnicodeDecodeError):
                return 0
        # MySQL: IS_IPV4(NULL) = 0, never NULL
        res = _uf(one, 1)(np.asarray(av, object)).astype(np.int32)
        res = np.where(np.asarray(am, bool), res, 0)
        return res, np.ones_like(np.asarray(am, bool))

    @rpn_fn("IsIPv6", 1, I, (B,))
    def is_ipv6(xp, a):
        (av, am) = a

        def one(s):
            try:
                ipaddress.IPv6Address(
                    s.decode() if isinstance(s, bytes) else s)
                return 1
            except (ValueError, UnicodeDecodeError):
                return 0
        res = _uf(one, 1)(np.asarray(av, object)).astype(np.int32)
        res = np.where(np.asarray(am, bool), res, 0)
        return res, np.ones_like(np.asarray(am, bool))

    @rpn_fn("InetAton", 1, I, (B,))
    def inet_aton(xp, a):
        (av, am) = a

        def one(s):
            """MySQL accepts SHORT forms: '127.1' = 127.0.0.1 is NOT a
            dotted quad but parses (the last part fills the remaining
            bytes) — ipaddress alone would reject it."""
            if isinstance(s, (bytes, bytearray)):
                s = s.decode("utf-8", "replace")
            parts = s.strip().split(".")
            if not 1 <= len(parts) <= 4:
                return None
            # strict decimal digits only: python int() would admit
            # '+1', '1_0' and padded parts that MySQL rejects
            if any(not p or not all("0" <= ch <= "9" for ch in p)
                   for p in parts):
                return None
            nums = [int(p) for p in parts]
            *heads, last = nums
            fill = 4 - len(heads)
            if any(not 0 <= h <= 255 for h in heads) or \
                    not 0 <= last < (1 << (8 * fill)):
                return None
            acc = 0
            for h in heads:
                acc = (acc << 8) | h
            return (acc << (8 * fill)) | last
        res = _uf(one, 1)(np.asarray(av, object))
        bad = _nulls(res)
        return np.where(bad, 0, res).astype(np.int64), \
            np.asarray(am, bool) & ~bad

    @rpn_fn("InetNtoa", 1, B, (I,))
    def inet_ntoa(xp, a):
        (av, am) = a

        def one(n):
            n = int(n)
            if not 0 <= n <= 0xFFFFFFFF:
                return None
            return str(ipaddress.IPv4Address(n)).encode()
        res = _uf(one, 1)(np.asarray(av))
        bad = _nulls(res)
        return np.where(bad, b"", res), np.asarray(am, bool) & ~bad

    @rpn_fn("Inet6Aton", 1, B, (B,))
    def inet6_aton(xp, a):
        (av, am) = a

        def one(s):
            try:
                return ipaddress.ip_address(
                    s.decode() if isinstance(s, bytes) else s).packed
            except (ValueError, UnicodeDecodeError):
                return None
        res = _uf(one, 1)(np.asarray(av, object))
        bad = _nulls(res)
        return np.where(bad, b"", res), np.asarray(am, bool) & ~bad

    @rpn_fn("Inet6Ntoa", 1, B, (B,))
    def inet6_ntoa(xp, a):
        (av, am) = a

        def one(b):
            if len(b) == 4:
                return str(ipaddress.IPv4Address(b)).encode()
            if len(b) == 16:
                return str(ipaddress.IPv6Address(b)).encode()
            return None
        res = _uf(one, 1)(np.asarray(av, object))
        bad = _nulls(res)
        return np.where(bad, b"", res), np.asarray(am, bool) & ~bad

    @rpn_fn("Uuid", 0, B, (), needs_rows=True)
    def uuid_sig(xp, n_rows=1):
        # one DISTINCT uuid per row (a 0-d scalar would broadcast the
        # same uuid across the whole batch)
        out = np.empty(n_rows, dtype=object)
        for i in range(n_rows):
            out[i] = str(_uuid.uuid4()).encode()
        return out, np.ones(n_rows, bool)

    # ---- string stragglers (impl_string.rs) ----

    for name, ty in (("FieldInt", I), ("FieldReal", R)):
        @rpn_fn(name, None, I, (ty,))
        def field_num(xp, *pairs, _ty=ty):
            """FIELD(x, a, b, ...): 1-based index of the first match;
            0 when absent or x is NULL (never NULL itself)."""
            (xv, xm) = pairs[0]
            n_rows = np.shape(np.asarray(xv)) or (1,)
            out = np.zeros(n_rows, np.int64)
            for idx, (lv, lm) in enumerate(pairs[1:], start=1):
                hit = (out == 0) & np.asarray(xm, bool) & \
                    np.asarray(lm, bool) & \
                    (np.asarray(xv) == np.asarray(lv))
                out = np.where(hit, idx, out)
            return out, np.ones(n_rows, bool)

    @rpn_fn("MakeSet", None, B, (I, B))
    def make_set(xp, bits, *strs):
        (bv, bm) = bits
        rows = [np.broadcast_to(np.asarray(v, object),
                                np.shape(np.asarray(bv)) or (1,))
                for v, _m in strs]
        masks = [np.broadcast_to(np.asarray(m, bool),
                                 np.shape(np.asarray(bv)) or (1,))
                 for _v, m in strs]
        shape = np.shape(np.asarray(bv)) or (1,)
        bvv = np.broadcast_to(np.asarray(bv), shape)
        out = np.empty(shape, object)
        for i in range(shape[0]):
            parts = [rows[j][i] for j in range(len(rows))
                     if (int(bvv[i]) >> j) & 1 and masks[j][i]]
            out[i] = b",".join(
                p if isinstance(p, bytes) else str(p).encode()
                for p in parts)
        return out, np.broadcast_to(np.asarray(bm, bool), shape)

    @rpn_fn("Format", 2, B, (R, I))
    def format_sig(xp, x, d):
        """FORMAT(x, d): thousands separators + d decimals."""
        (xv, xm), (dv, dm) = x, d

        def one(v, k):
            k = max(0, min(30, int(k)))
            return f"{float(v):,.{k}f}".encode()
        return _uf(one, 2)(np.asarray(xv), np.asarray(dv)), xm & dm

    @rpn_fn("OctString", 1, B, (B,))
    def oct_string(xp, a):
        """OCT(str): numeric prefix → octal text."""
        (av, am) = a

        def one(s):
            if isinstance(s, (bytes, bytearray)):
                s = s.decode("utf-8", "replace")
            s = s.strip()
            neg = s.startswith("-")
            if neg:
                s = s[1:]
            num = ""
            for ch in s:
                if ch.isdigit():
                    num += ch
                else:
                    break
            v = int(num) if num else 0
            if neg:
                v = ((1 << 64) - v) % (1 << 64)     # MySQL u64 wrap
            else:
                v %= 1 << 64
            return oct(v)[2:].encode()
        return _uf(one, 1)(np.asarray(av, object)), am

    @rpn_fn("InsertUtf8", 4, B, (B, I, I, B))
    def insert_utf8(xp, s, pos, ln, repl):
        (sv, sm), (pv, pm), (lv, lm), (rv, rm) = s, pos, ln, repl

        def one(txt, p, n, rep):
            t = txt.decode("utf-8", "replace") \
                if isinstance(txt, (bytes, bytearray)) else txt
            r = rep.decode("utf-8", "replace") \
                if isinstance(rep, (bytes, bytearray)) else rep
            p, n = int(p), int(n)
            if p < 1 or p > len(t):
                return t.encode()
            if n < 0 or p + n - 1 >= len(t):
                return (t[:p - 1] + r).encode()
            return (t[:p - 1] + r + t[p - 1 + n:]).encode()
        return _uf(one, 4)(np.asarray(sv, object), np.asarray(pv),
                           np.asarray(lv), np.asarray(rv, object)), \
            sm & pm & lm & rm
