"""String ScalarFuncSig implementations (host path).

Reference: components/tidb_query_expr/src/impl_string.rs and
impl_encryption.rs — signature names match the reference's ScalarFuncSig
variants one-for-one.  BYTES columns are numpy object arrays of
``bytes``; these sigs never run on the device (their ``device_safe`` is
False, so the runner's ``_rpn_device_safe`` keeps them out of a device
plan), so every implementation computes with numpy regardless of the
``xp`` handed in.  The JAX package's ``expr/impl_string.py``, copied.

Per-element work uses ``np.frompyfunc`` (broadcasts like a ufunc and
keeps the object dtype).  MySQL semantics notes live on each function;
``Upper``/``Lower`` on binary-collation strings are identity, the
``*Utf8`` variants operate on decoded text (impl_string.rs upper/
upper_utf8 split).
"""

from __future__ import annotations

import base64
import hashlib

import numpy as np

from ..datatype import EvalType
from .functions import rpn_fn, _ibool

I, R, B = EvalType.INT, EvalType.REAL, EvalType.BYTES


def _uf(f, nin):
    g = np.frompyfunc(f, nin, 1)

    def call(*args):
        # frompyfunc returns a bare python scalar for 0-d inputs (all
        # const args); normalize to a 0-d object ndarray
        return np.asarray(g(*args), dtype=object)
    return call


def _nulls(out) -> np.ndarray:
    """None-mask of a frompyfunc result (handles 0-d scalars)."""
    return np.asarray(
        np.frompyfunc(lambda x: x is None, 1, 1)(
            np.asarray(out, dtype=object)), dtype=bool)


def _obj(values) -> np.ndarray:
    """Ensure an object ndarray (consts arrive as 0-d object arrays)."""
    a = np.asarray(values, dtype=object)
    return a


def _ints(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64)


def _and(*masks):
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return np.asarray(out, dtype=bool)


def _utf8(b: bytes) -> str:
    return b.decode("utf-8", errors="replace")


def register() -> None:
    # ---- length / bytes ----

    @rpn_fn("Length", 1, I, (B,))
    def length(xp, a):
        (av, am) = a
        return _uf(len, 1)(_obj(av)).astype(np.int64), am

    @rpn_fn("BitLength", 1, I, (B,))
    def bit_length(xp, a):
        (av, am) = a
        return _uf(lambda s: 8 * len(s), 1)(_obj(av)).astype(np.int64), am

    @rpn_fn("CharLength", 1, I, (B,))
    def char_length(xp, a):
        # binary collation: char length == byte length (impl_string.rs)
        (av, am) = a
        return _uf(len, 1)(_obj(av)).astype(np.int64), am

    @rpn_fn("CharLengthUtf8", 1, I, (B,))
    def char_length_utf8(xp, a):
        (av, am) = a
        return _uf(lambda s: len(_utf8(s)), 1)(_obj(av)).astype(np.int64), am

    @rpn_fn("Ascii", 1, I, (B,))
    def ascii_(xp, a):
        (av, am) = a
        return _uf(lambda s: s[0] if s else 0, 1)(_obj(av)) \
            .astype(np.int64), am

    @rpn_fn("Ord", 1, I, (B,))
    def ord_(xp, a):
        # binary collation: first byte (multi-byte weights are a
        # collation feature; binary strings are single-byte)
        (av, am) = a
        return _uf(lambda s: s[0] if s else 0, 1)(_obj(av)) \
            .astype(np.int64), am

    # ---- case / reverse ----

    @rpn_fn("Upper", 1, B, (B,))
    def upper(xp, a):
        return a        # binary collation: no-op (impl_string.rs upper)

    @rpn_fn("Lower", 1, B, (B,))
    def lower(xp, a):
        return a

    @rpn_fn("UpperUtf8", 1, B, (B,))
    def upper_utf8(xp, a):
        (av, am) = a
        return _uf(lambda s: _utf8(s).upper().encode(), 1)(_obj(av)), am

    @rpn_fn("LowerUtf8", 1, B, (B,))
    def lower_utf8(xp, a):
        (av, am) = a
        return _uf(lambda s: _utf8(s).lower().encode(), 1)(_obj(av)), am

    @rpn_fn("Reverse", 1, B, (B,))
    def reverse(xp, a):
        (av, am) = a
        return _uf(lambda s: s[::-1], 1)(_obj(av)), am

    @rpn_fn("ReverseUtf8", 1, B, (B,))
    def reverse_utf8(xp, a):
        (av, am) = a
        return _uf(lambda s: _utf8(s)[::-1].encode(), 1)(_obj(av)), am

    # ---- concat ----

    @rpn_fn("Concat", None, B, (B,))
    def concat(xp, *pairs):
        vals = [_obj(p[0]) for p in pairs]
        valid = _and(*[np.asarray(p[1]) for p in pairs]) if pairs else \
            np.ones((), bool)
        if not pairs:
            return np.asarray(b"", dtype=object), np.ones((), bool)
        out = _uf(lambda *ss: b"".join(ss), len(vals))(*vals)
        return out, valid

    @rpn_fn("ConcatWs", None, B, (B,))
    def concat_ws(xp, *pairs):
        # MySQL: NULL separator → NULL; NULL args are skipped.
        (sv, sm) = pairs[0]
        args_v = [_obj(p[0]) for p in pairs[1:]]
        args_m = [np.asarray(p[1]) for p in pairs[1:]]

        def go(sep, *rest):
            n = len(rest) // 2
            vals = rest[:n]
            oks = rest[n:]
            return sep.join(v for v, ok in zip(vals, oks) if ok)
        out = _uf(go, 1 + 2 * len(args_v))(_obj(sv), *args_v, *args_m)
        return out, np.asarray(sm, dtype=bool)

    # ---- substrings / pieces ----

    def _left(s, n):
        return s[:max(int(n), 0)]

    def _right(s, n):
        n = max(int(n), 0)
        return s[len(s) - n:] if n else b""

    @rpn_fn("Left", 2, B, (B, I))
    def left(xp, a, n):
        (av, am), (nv, nm) = a, n
        return _uf(_left, 2)(_obj(av), _ints(nv)), _and(am, nm)

    @rpn_fn("Right", 2, B, (B, I))
    def right(xp, a, n):
        (av, am), (nv, nm) = a, n
        return _uf(_right, 2)(_obj(av), _ints(nv)), _and(am, nm)

    @rpn_fn("LeftUtf8", 2, B, (B, I))
    def left_utf8(xp, a, n):
        (av, am), (nv, nm) = a, n
        return _uf(lambda s, k: _utf8(s)[:max(int(k), 0)].encode(),
                   2)(_obj(av), _ints(nv)), _and(am, nm)

    @rpn_fn("RightUtf8", 2, B, (B, I))
    def right_utf8(xp, a, n):
        def go(s, k):
            t = _utf8(s)
            k = max(int(k), 0)
            return t[len(t) - k:].encode() if k else b""
        (av, am), (nv, nm) = a, n
        return _uf(go, 2)(_obj(av), _ints(nv)), _and(am, nm)

    def _substr(s, pos, n=None):
        # MySQL SUBSTRING: 1-based; negative pos counts from the end;
        # pos == 0 → empty; n < 0 → empty.
        L = len(s)
        pos = int(pos)
        if pos == 0:
            return s[:0]
        if pos > 0:
            i = pos - 1
        else:
            i = L + pos
            if i < 0:
                return s[:0]
        if n is None:
            return s[i:]
        n = int(n)
        if n <= 0:
            return s[:0]
        return s[i:i + n]

    @rpn_fn("Substring2Args", 2, B, (B, I))
    def substring2(xp, a, p):
        (av, am), (pv, pm) = a, p
        return _uf(_substr, 2)(_obj(av), _ints(pv)), _and(am, pm)

    @rpn_fn("Substring3Args", 3, B, (B, I, I))
    def substring3(xp, a, p, n):
        (av, am), (pv, pm), (nv, nm) = a, p, n
        return _uf(_substr, 3)(_obj(av), _ints(pv), _ints(nv)), \
            _and(am, pm, nm)

    @rpn_fn("Substring2ArgsUtf8", 2, B, (B, I))
    def substring2_utf8(xp, a, p):
        (av, am), (pv, pm) = a, p
        return _uf(lambda s, i: _substr(_utf8(s), i).encode(),
                   2)(_obj(av), _ints(pv)), _and(am, pm)

    @rpn_fn("Substring3ArgsUtf8", 3, B, (B, I, I))
    def substring3_utf8(xp, a, p, n):
        (av, am), (pv, pm), (nv, nm) = a, p, n
        return _uf(lambda s, i, k: _substr(_utf8(s), i, k).encode(),
                   3)(_obj(av), _ints(pv), _ints(nv)), _and(am, pm, nm)

    @rpn_fn("SubstringIndex", 3, B, (B, B, I))
    def substring_index(xp, a, d, c):
        # MySQL SUBSTRING_INDEX(str, delim, count)
        def go(s, delim, count):
            count = int(count)
            if not delim or count == 0:
                return b""
            parts = s.split(delim)
            if count > 0:
                return delim.join(parts[:count])
            return delim.join(parts[count:])
        (av, am), (dv, dm), (cv, cm) = a, d, c
        return _uf(go, 3)(_obj(av), _obj(dv), _ints(cv)), _and(am, dm, cm)

    # ---- search ----

    def _locate(sub, s, pos=1):
        # 1-based; 0 = not found; pos < 1 → 0 (MySQL)
        pos = int(pos)
        if pos < 1 or pos > len(s) + 1:
            return 0
        i = s.find(sub, pos - 1)
        return i + 1 if i >= 0 else 0

    @rpn_fn("Locate2Args", 2, I, (B, B))
    def locate2(xp, sub, s):
        (uv, um), (sv, sm) = sub, s
        return _uf(_locate, 2)(_obj(uv), _obj(sv)).astype(np.int64), \
            _and(um, sm)

    @rpn_fn("Locate3Args", 3, I, (B, B, I))
    def locate3(xp, sub, s, p):
        (uv, um), (sv, sm), (pv, pm) = sub, s, p
        return _uf(_locate, 3)(_obj(uv), _obj(sv), _ints(pv)) \
            .astype(np.int64), _and(um, sm, pm)

    @rpn_fn("Locate2ArgsUtf8", 2, I, (B, B))
    def locate2_utf8(xp, sub, s):
        (uv, um), (sv, sm) = sub, s
        return _uf(lambda u, t: _locate(_utf8(u), _utf8(t)),
                   2)(_obj(uv), _obj(sv)).astype(np.int64), _and(um, sm)

    @rpn_fn("Locate3ArgsUtf8", 3, I, (B, B, I))
    def locate3_utf8(xp, sub, s, p):
        (uv, um), (sv, sm), (pv, pm) = sub, s, p
        return _uf(lambda u, t, k: _locate(_utf8(u), _utf8(t), k),
                   3)(_obj(uv), _obj(sv), _ints(pv)).astype(np.int64), \
            _and(um, sm, pm)

    @rpn_fn("Instr", 2, I, (B, B))
    def instr(xp, s, sub):
        (sv, sm), (uv, um) = s, sub
        return _uf(_locate, 2)(_obj(uv), _obj(sv)).astype(np.int64), \
            _and(sm, um)

    @rpn_fn("InstrUtf8", 2, I, (B, B))
    def instr_utf8(xp, s, sub):
        (sv, sm), (uv, um) = s, sub
        return _uf(lambda u, t: _locate(_utf8(u), _utf8(t)),
                   2)(_obj(uv), _obj(sv)).astype(np.int64), _and(sm, um)

    @rpn_fn("Strcmp", 2, I, (B, B))
    def strcmp(xp, a, b):
        (av, am), (bv, bm) = a, b
        return _uf(lambda x, y: (x > y) - (x < y), 2)(
            _obj(av), _obj(bv)).astype(np.int64), _and(am, bm)

    @rpn_fn("FindInSet", 2, I, (B, B))
    def find_in_set(xp, a, st):
        def go(s, set_str):
            if not set_str:
                return 0
            try:
                return set_str.split(b",").index(s) + 1
            except ValueError:
                return 0
        (av, am), (sv, sm) = a, st
        return _uf(go, 2)(_obj(av), _obj(sv)).astype(np.int64), \
            _and(am, sm)

    # ---- replace / repeat / pad / trim ----

    @rpn_fn("Replace", 3, B, (B, B, B))
    def replace(xp, s, frm, to):
        def go(x, f, t):
            return x.replace(f, t) if f else x
        (sv, sm), (fv, fm), (tv, tm) = s, frm, to
        return _uf(go, 3)(_obj(sv), _obj(fv), _obj(tv)), _and(sm, fm, tm)

    # result-size cap standing in for max_allowed_packet (MySQL returns
    # NULL with a warning when an operand would exceed it)
    _MAX_BLOB = 1 << 26

    @rpn_fn("Repeat", 2, B, (B, I))
    def repeat(xp, s, n):
        def go(x, k):
            k = max(int(k), 0)
            if len(x) * k > _MAX_BLOB:
                return None
            return x * k
        (sv, sm), (nv, nm) = s, n
        out = _uf(go, 2)(_obj(sv), _ints(nv))
        nulls = _nulls(out)
        return np.where(nulls, b"", out), _and(sm, nm) & ~nulls

    @rpn_fn("Space", 1, B, (I,))
    def space(xp, n):
        def go(k):
            k = max(int(k), 0)
            return None if k > _MAX_BLOB else b" " * k
        (nv, nm) = n
        out = _uf(go, 1)(_ints(nv))
        nulls = _nulls(out)
        return np.where(nulls, b"", out), np.asarray(nm, bool) & ~nulls

    def _pad(s, ln, pad, left_side):
        ln = int(ln)
        if ln < 0:
            return None
        if ln <= len(s):
            return s[:ln]
        if not pad:
            return None         # impl_string.rs lpad: empty pad → NULL
        fill = (pad * ((ln - len(s)) // len(pad) + 1))[:ln - len(s)]
        return fill + s if left_side else s + fill

    def _pad_pair(sv, lv, pv, left_side):
        out = _uf(lambda s, ln, p: _pad(s, ln, p, left_side),
                  3)(_obj(sv), _ints(lv), _obj(pv))
        nulls = _nulls(out)
        out = np.where(nulls, b"", out)
        return out, ~nulls

    @rpn_fn("Lpad", 3, B, (B, I, B))
    def lpad(xp, s, ln, p):
        (sv, sm), (lv, lm), (pv, pm) = s, ln, p
        out, ok = _pad_pair(sv, lv, pv, True)
        return out, _and(sm, lm, pm) & ok

    @rpn_fn("Rpad", 3, B, (B, I, B))
    def rpad(xp, s, ln, p):
        (sv, sm), (lv, lm), (pv, pm) = s, ln, p
        out, ok = _pad_pair(sv, lv, pv, False)
        return out, _and(sm, lm, pm) & ok

    def _pad_utf8(s, ln, pad, left_side):
        t, p = _utf8(s), _utf8(pad)
        r = _pad(t, int(ln), p, left_side)
        return None if r is None else r.encode()

    @rpn_fn("LpadUtf8", 3, B, (B, I, B))
    def lpad_utf8(xp, s, ln, p):
        (sv, sm), (lv, lm), (pv, pm) = s, ln, p
        out = _uf(lambda a, b, c: _pad_utf8(a, b, c, True),
                  3)(_obj(sv), _ints(lv), _obj(pv))
        nulls = _nulls(out)
        return np.where(nulls, b"", out), _and(sm, lm, pm) & ~nulls

    @rpn_fn("RpadUtf8", 3, B, (B, I, B))
    def rpad_utf8(xp, s, ln, p):
        (sv, sm), (lv, lm), (pv, pm) = s, ln, p
        out = _uf(lambda a, b, c: _pad_utf8(a, b, c, False),
                  3)(_obj(sv), _ints(lv), _obj(pv))
        nulls = _nulls(out)
        return np.where(nulls, b"", out), _and(sm, lm, pm) & ~nulls

    @rpn_fn("LTrim", 1, B, (B,))
    def ltrim(xp, a):
        (av, am) = a
        return _uf(lambda s: s.lstrip(b" "), 1)(_obj(av)), am

    @rpn_fn("RTrim", 1, B, (B,))
    def rtrim(xp, a):
        (av, am) = a
        return _uf(lambda s: s.rstrip(b" "), 1)(_obj(av)), am

    @rpn_fn("Trim1Arg", 1, B, (B,))
    def trim1(xp, a):
        (av, am) = a
        return _uf(lambda s: s.strip(b" "), 1)(_obj(av)), am

    def _trim_remstr(s, rem, direction):
        # direction: 1 BOTH, 2 LEADING, 3 TRAILING (tipb TrimDirection)
        if not rem:
            return s
        if direction in (1, 2):
            while s.startswith(rem):
                s = s[len(rem):]
        if direction in (1, 3):
            while s.endswith(rem):
                s = s[:len(s) - len(rem)]
        return s

    @rpn_fn("Trim2Args", 2, B, (B, B))
    def trim2(xp, a, r):
        (av, am), (rv, rm) = a, r
        return _uf(lambda s, t: _trim_remstr(s, t, 1), 2)(
            _obj(av), _obj(rv)), _and(am, rm)

    @rpn_fn("Trim3Args", 3, B, (B, B, I))
    def trim3(xp, a, r, d):
        (av, am), (rv, rm), (dv, dm) = a, r, d
        return _uf(lambda s, t, k: _trim_remstr(s, t, int(k)), 3)(
            _obj(av), _obj(rv), _ints(dv)), _and(am, rm, dm)

    # ---- elt / field / insert ----

    @rpn_fn("Elt", None, B, (I,))
    def elt(xp, *pairs):
        # ELT(n, s1, s2, ...): NULL when n out of range or NULL
        (nv, nm) = pairs[0]
        svals = [_obj(p[0]) for p in pairs[1:]]
        smask = [np.asarray(p[1]) for p in pairs[1:]]
        k = len(svals)

        def go(n, *rest):
            n = int(n)
            if n < 1 or n > k:
                return None
            v, ok = rest[n - 1], rest[k + n - 1]
            return v if ok else None
        out = _uf(go, 1 + 2 * k)(_ints(nv), *svals, *smask)
        nulls = _nulls(out)
        return np.where(nulls, b"", out), np.asarray(nm, bool) & ~nulls

    @rpn_fn("FieldString", None, I, (B,))
    def field_string(xp, *pairs):
        (av, am) = pairs[0]
        vals = [_obj(p[0]) for p in pairs[1:]]
        masks = [np.asarray(p[1]) for p in pairs[1:]]
        k = len(vals)

        def go(x, xok, *rest):
            if not xok:
                return 0
            for i in range(k):
                if rest[k + i] and rest[i] == x:
                    return i + 1
            return 0
        out = _uf(go, 2 + 2 * k)(_obj(av), np.asarray(am), *vals, *masks)
        return out.astype(np.int64), np.ones_like(np.asarray(am), bool)

    @rpn_fn("Insert", 4, B, (B, I, I, B))
    def insert(xp, s, pos, ln, new):
        # MySQL INSERT(str, pos, len, newstr)
        def go(x, p, k, nw):
            p, k = int(p), int(k)
            if p < 1 or p > len(x):
                return x
            if k < 0 or p + k - 1 >= len(x):
                return x[:p - 1] + nw
            return x[:p - 1] + nw + x[p - 1 + k:]
        (sv, sm), (pv, pm), (lv, lm), (nv, nm) = s, pos, ln, new
        return _uf(go, 4)(_obj(sv), _ints(pv), _ints(lv), _obj(nv)), \
            _and(sm, pm, lm, nm)

    # ---- hex / hash / base64 ----

    @rpn_fn("HexStrArg", 1, B, (B,))
    def hex_str(xp, a):
        (av, am) = a
        return _uf(lambda s: s.hex().upper().encode(), 1)(_obj(av)), am

    @rpn_fn("HexIntArg", 1, B, (I,))
    def hex_int(xp, a):
        (av, am) = a
        return _uf(lambda v: b"%X" % (int(v) & 0xFFFFFFFFFFFFFFFF),
                   1)(_ints(av)), am

    @rpn_fn("UnHex", 1, B, (B,))
    def unhex(xp, a):
        def go(s):
            if len(s) % 2:
                s = b"0" + s
            try:
                return bytes.fromhex(s.decode("ascii"))
            except (ValueError, UnicodeDecodeError):
                return None
        (av, am) = a
        out = _uf(go, 1)(_obj(av))
        nulls = _nulls(out)
        return np.where(nulls, b"", out), np.asarray(am, bool) & ~nulls

    @rpn_fn("Md5", 1, B, (B,))
    def md5(xp, a):
        (av, am) = a
        return _uf(lambda s: hashlib.md5(s).hexdigest().encode(),
                   1)(_obj(av)), am

    @rpn_fn("Sha1", 1, B, (B,))
    def sha1(xp, a):
        (av, am) = a
        return _uf(lambda s: hashlib.sha1(s).hexdigest().encode(),
                   1)(_obj(av)), am

    @rpn_fn("Sha2", 2, B, (B, I))
    def sha2(xp, a, bits):
        algos = {0: hashlib.sha256, 224: hashlib.sha224,
                 256: hashlib.sha256, 384: hashlib.sha384,
                 512: hashlib.sha512}

        def go(s, b):
            f = algos.get(int(b))
            return None if f is None else f(s).hexdigest().encode()
        (av, am), (bv, bm) = a, bits
        out = _uf(go, 2)(_obj(av), _ints(bv))
        nulls = _nulls(out)
        return np.where(nulls, b"", out), _and(am, bm) & ~nulls

    @rpn_fn("ToBase64", 1, B, (B,))
    def to_base64(xp, a):
        # MySQL wraps at 76 chars
        def go(s):
            raw = base64.b64encode(s)
            return b"\n".join(raw[i:i + 76] for i in range(0, len(raw), 76))
        (av, am) = a
        return _uf(go, 1)(_obj(av)), am

    @rpn_fn("FromBase64", 1, B, (B,))
    def from_base64(xp, a):
        def go(s):
            try:
                return base64.b64decode(s.replace(b"\n", b""),
                                        validate=True)
            except Exception:
                return None
        (av, am) = a
        out = _uf(go, 1)(_obj(av))
        nulls = _nulls(out)
        return np.where(nulls, b"", out), np.asarray(am, bool) & ~nulls

    @rpn_fn("Bin", 1, B, (I,))
    def bin_(xp, a):
        (av, am) = a
        return _uf(lambda v: format(int(v) & 0xFFFFFFFFFFFFFFFF,
                                    "b").encode(), 1)(_ints(av)), am

    @rpn_fn("OctInt", 1, B, (I,))
    def oct_int(xp, a):
        (av, am) = a
        return _uf(lambda v: format(int(v) & 0xFFFFFFFFFFFFFFFF,
                                    "o").encode(), 1)(_ints(av)), am

    @rpn_fn("Quote", 1, B, (B,))
    def quote(xp, a):
        def go(s):
            out = bytearray(b"'")
            for c in s:
                if c in (0x27, 0x5C):       # ' or backslash
                    out += b"\\" + bytes([c])
                elif c == 0:
                    out += b"\\0"
                elif c == 0x1A:
                    out += b"\\Z"
                else:
                    out.append(c)
            out += b"'"
            return bytes(out)
        (av, am) = a
        return _uf(go, 1)(_obj(av)), am
