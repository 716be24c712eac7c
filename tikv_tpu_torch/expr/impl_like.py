"""LIKE and REGEXP ScalarFuncSig implementations (host path).

Reference: components/tidb_query_expr/src/impl_like.rs (LikeSig — the
``%``/``_``/escape matcher) and impl_regexp.rs (RegexpLikeSig /
RegexpInStrSig / RegexpSubstrSig / RegexpReplaceSig, match-type flags
``i``/``m``/``s``).  Patterns are usually constants, so compiled
matchers are memoized per (pattern, escape) / (pattern, flags).  Host
only.  The JAX package's ``expr/impl_like.py``, copied.
"""

from __future__ import annotations

import functools
import re

import numpy as np

from ..datatype import EvalType
from .functions import rpn_fn, _ibool

I, B = EvalType.INT, EvalType.BYTES


@functools.lru_cache(maxsize=4096)
def _like_regex(pattern: bytes, escape: int, ci: bool = False):
    """MySQL LIKE pattern → compiled bytes regex (anchored).

    ``ci``: the comparison collation is case-insensitive (general_ci
    family) — LIKE then matches unicode case-folded (impl_like.rs is
    generic over the Collator the same way).  Pattern compiles over
    str for unicode-correct IGNORECASE; the matcher decodes targets.
    """
    esc = escape & 0xFF
    out = [b"^"]
    i = 0
    n = len(pattern)
    while i < n:
        c = pattern[i]
        if c == esc and i + 1 < n:
            out.append(re.escape(pattern[i + 1:i + 2]))
            i += 2
            continue
        if c == 0x25:               # %
            out.append(b"(?s:.*)")
        elif c == 0x5F:             # _
            out.append(b"(?s:.)")
        else:
            out.append(re.escape(pattern[i:i + 1]))
        i += 1
    out.append(b"$")
    if ci:
        # the str-mode translation is shared with JSON_SEARCH
        # (datatype/collation.like_regex_src) — one LIKE compiler
        from ..datatype.collation import like_regex_src
        return re.compile(
            like_regex_src(pattern.decode("utf-8", "replace"), escape),
            re.IGNORECASE)
    return re.compile(b"".join(out))


@functools.lru_cache(maxsize=4096)
def _regexp(pattern: bytes, match_type: bytes = b""):
    flags = 0
    for f in match_type:
        if f == 0x69:               # i
            flags |= re.IGNORECASE
        elif f == 0x6D:             # m
            flags |= re.MULTILINE
        elif f == 0x73:             # s
            flags |= re.DOTALL
    return re.compile(pattern, flags)


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


def _obj(a):
    return np.asarray(a, dtype=object)


def register() -> None:
    @rpn_fn("LikeSig", 3, I, (B, B, I), needs_ctx=True)
    def like(xp, target, pattern, escape, ctx=(63, ())):
        from ..datatype import collation as coll
        (tv, tm), (pv, pm), (ev, em) = target, pattern, escape
        ci = coll.normalize_id(ctx[0]) in coll._GENERAL_CI

        def one(t, p, e):
            rx = _like_regex(p, int(e), ci)
            if ci:
                t = t.decode("utf-8", "replace") \
                    if isinstance(t, (bytes, bytearray)) else t
            return 1 if rx.match(t) else 0
        out = _uf(one, 3)(_obj(tv), _obj(pv),
                          np.asarray(ev, dtype=np.int64))
        return out.astype(np.int64), \
            np.asarray(tm, bool) & np.asarray(pm, bool) & \
            np.asarray(em, bool)

    def _regexp_like(xp, pairs):
        (tv, tm) = pairs[0]
        (pv, pm) = pairs[1]
        if len(pairs) > 2:
            (mv, mm) = pairs[2]
        else:
            mv, mm = np.asarray(b"", dtype=object), np.ones((), bool)
        out = _uf(lambda t, p, m: 1 if _regexp(p, m).search(t) else 0,
                  3)(_obj(tv), _obj(pv), _obj(mv))
        return out.astype(np.int64), \
            np.asarray(tm, bool) & np.asarray(pm, bool) & \
            np.asarray(mm, bool)

    @rpn_fn("RegexpLikeSig", None, I, (B,))
    def regexp_like(xp, *pairs):
        return _regexp_like(xp, pairs)

    @rpn_fn("RegexpSig", 2, I, (B, B))
    def regexp_sig(xp, t, p):
        return _regexp_like(xp, (t, p))

    @rpn_fn("RegexpUtf8Sig", 2, I, (B, B))
    def regexp_utf8(xp, t, p):
        return _regexp_like(xp, (t, p))

    @rpn_fn("RegexpInStrSig", None, I, (B,))
    def regexp_instr(xp, *pairs):
        # REGEXP_INSTR(expr, pat[, pos[, occurrence[, return_option]]])
        (tv, tm) = pairs[0]
        (pv, pm) = pairs[1]
        pos = pairs[2] if len(pairs) > 2 else (np.asarray(1), np.ones((), bool))
        occ = pairs[3] if len(pairs) > 3 else (np.asarray(1), np.ones((), bool))
        ret = pairs[4] if len(pairs) > 4 else (np.asarray(0), np.ones((), bool))

        def go(t, p, po, oc, rt):
            po, oc, rt = max(int(po), 1), max(int(oc), 1), int(rt)
            rx = _regexp(p)
            k = 0
            for m in rx.finditer(t, po - 1):
                k += 1
                if k == oc:
                    return (m.end() + 1) if rt else (m.start() + 1)
            return 0
        out = _uf(go, 5)(_obj(tv), _obj(pv),
                         np.asarray(pos[0], np.int64),
                         np.asarray(occ[0], np.int64),
                         np.asarray(ret[0], np.int64))
        ok = np.asarray(tm, bool) & np.asarray(pm, bool) & \
            np.asarray(pos[1], bool) & np.asarray(occ[1], bool) & \
            np.asarray(ret[1], bool)
        return out.astype(np.int64), ok

    @rpn_fn("RegexpSubstrSig", None, B, (B,))
    def regexp_substr(xp, *pairs):
        (tv, tm) = pairs[0]
        (pv, pm) = pairs[1]
        pos = pairs[2] if len(pairs) > 2 else (np.asarray(1), np.ones((), bool))
        occ = pairs[3] if len(pairs) > 3 else (np.asarray(1), np.ones((), bool))

        def go(t, p, po, oc):
            po, oc = max(int(po), 1), max(int(oc), 1)
            k = 0
            for m in _regexp(p).finditer(t, po - 1):
                k += 1
                if k == oc:
                    return m.group(0)
            return None
        out = _uf(go, 4)(_obj(tv), _obj(pv),
                         np.asarray(pos[0], np.int64),
                         np.asarray(occ[0], np.int64))
        nulls = _nulls(out)
        ok = np.asarray(tm, bool) & np.asarray(pm, bool) & \
            np.asarray(pos[1], bool) & np.asarray(occ[1], bool) & ~nulls
        return np.where(nulls, b"", out), ok

    @rpn_fn("RegexpReplaceSig", None, B, (B,))
    def regexp_replace(xp, *pairs):
        # REGEXP_REPLACE(expr, pat, repl[, pos[, occurrence]])
        (tv, tm) = pairs[0]
        (pv, pm) = pairs[1]
        (rv, rm) = pairs[2]
        pos = pairs[3] if len(pairs) > 3 else (np.asarray(1), np.ones((), bool))
        occ = pairs[4] if len(pairs) > 4 else (np.asarray(0), np.ones((), bool))

        def go(t, p, r, po, oc):
            po, oc = max(int(po), 1), int(oc)
            rx = _regexp(p)
            head, tail = t[:po - 1], t[po - 1:]
            if oc <= 0:
                return head + rx.sub(r, tail)
            k = 0
            out, last = [], 0
            for m in rx.finditer(tail):
                k += 1
                if k == oc:
                    out.append(tail[last:m.start()])
                    out.append(m.expand(r) if b"\\" in r else r)
                    last = m.end()
                    break
            out.insert(0, head)
            out.append(tail[last:])
            return b"".join(out)
        out = _uf(go, 5)(_obj(tv), _obj(pv), _obj(rv),
                         np.asarray(pos[0], np.int64),
                         np.asarray(occ[0], np.int64))
        ok = np.asarray(tm, bool) & np.asarray(pm, bool) & \
            np.asarray(rm, bool) & np.asarray(pos[1], bool) & \
            np.asarray(occ[1], bool)
        return out, ok
