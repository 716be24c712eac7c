"""JSON ScalarFuncSig implementations (host path).

Reference: components/tidb_query_expr/src/impl_json.rs — sig names match
the reference's ScalarFuncSig variants.  JSON columns are numpy object
arrays of parsed Python values (datatype/myjson.py); SQL NULL rides the
validity mask, the JSON ``null`` literal is the Python ``None`` inside a
valid slot.  Host only: no sig here is ``device_safe``, so the device
runner refuses a plan that calls one (``_rpn_device_safe``) and the
endpoint serves it on the host pipeline.  The JAX package's
``expr/impl_json.py``, copied.
"""

from __future__ import annotations

import numpy as np

from ..datatype import EvalType
from ..datatype import myjson as mj
from .functions import _ibool, rpn_fn

I, R, B, J = EvalType.INT, EvalType.REAL, EvalType.BYTES, EvalType.JSON


def _obj(values) -> np.ndarray:
    return np.asarray(values, dtype=object)


def _map_json(f, arr) -> np.ndarray:
    """Elementwise map preserving shape (incl. 0-d consts), safe for
    list/dict results that np.asarray would try to flatten."""
    arr = _obj(arr)
    out = np.empty(arr.shape, dtype=object)
    it = np.nditer(arr, flags=["multi_index", "refs_ok"])
    for x in it:
        out[it.multi_index] = f(x.item())
    return out


def _rows(pair, n):
    v, m = pair
    return (np.broadcast_to(_obj(v), (n,)),
            np.broadcast_to(np.asarray(m, bool), (n,)))


def _n_of(pairs) -> int:
    n = 1
    for v, _m in pairs:
        shp = np.shape(v)
        if shp:
            n = max(n, shp[0])
    return n


def register() -> None:
    @rpn_fn("JsonTypeSig", 1, B, (J,))
    def json_type(xp, a):
        (av, am) = a
        return np.frompyfunc(mj.type_name, 1, 1)(_obj(av)), am

    @rpn_fn("JsonUnquoteSig", 1, B, (J,))
    def json_unquote(xp, a):
        (av, am) = a
        return np.frompyfunc(mj.unquote, 1, 1)(_obj(av)), am

    @rpn_fn("JsonQuoteSig", 1, B, (B,))
    def json_quote(xp, a):
        (av, am) = a
        return np.frompyfunc(mj.quote, 1, 1)(_obj(av)), am

    @rpn_fn("JsonValidJsonSig", 1, I, (J,))
    def json_valid_json(xp, a):
        # an already-parsed JSON value is valid by construction;
        # JSON_VALID(NULL) is NULL (mask = argument mask).  Shape
        # follows the input (0-d consts stay 0-d for broadcasting).
        (av, am) = a
        return np.ones(np.shape(_obj(av)), np.int32), am

    @rpn_fn("JsonValidStringSig", 1, I, (B,))
    def json_valid_string(xp, a):
        (av, am) = a

        def ok(s):
            try:
                mj.parse(s)
                return True
            except Exception:   # noqa: BLE001 — invalid JSON IS the answer
                return False
        res = np.frompyfunc(ok, 1, 1)(_obj(av)).astype(bool)
        return _ibool(np, res), am

    @rpn_fn("JsonExtractSig", None, J, (J, B))
    def json_extract(xp, doc, *path_pairs):
        n = _n_of((doc,) + path_pairs)
        dv, dm = _rows(doc, n)
        pvs = [_rows(p, n) for p in path_pairs]
        out = np.empty(n, dtype=object)
        ok = np.asarray(dm, bool).copy()
        for i in range(n):
            if not ok[i]:
                continue
            if not all(pm[i] for _pv, pm in pvs):
                ok[i] = False
                continue
            got = mj.extract(dv[i], [pv[i] for pv, _pm in pvs])
            if got is mj.NOT_FOUND:
                ok[i] = False
            else:
                out[i] = got
        return out, ok

    @rpn_fn("JsonLengthSig", None, I, (J, B))
    def json_length(xp, doc, *maybe_path):
        n = _n_of((doc,) + maybe_path)
        dv, dm = _rows(doc, n)
        out = np.zeros(n, dtype=np.int64)
        ok = np.asarray(dm, bool).copy()
        if maybe_path:
            pv, pm = _rows(maybe_path[0], n)
            ok = ok & pm
        for i in range(n):
            if not ok[i]:
                continue
            got = mj.length(dv[i], pv[i] if maybe_path else None)
            if got is None:
                ok[i] = False
            else:
                out[i] = got
        return out, ok

    for name, with_path in (("JsonKeysSig", False),
                            ("JsonKeys2ArgsSig", True)):
        @rpn_fn(name, 2 if with_path else 1, J,
                (J, B) if with_path else (J,))
        def json_keys(xp, doc, *rest, _wp=with_path):
            n = _n_of((doc,) + rest)
            dv, dm = _rows(doc, n)
            out = np.empty(n, dtype=object)
            ok = np.asarray(dm, bool).copy()
            if _wp:
                pv, pm = _rows(rest[0], n)
                ok = ok & pm
            for i in range(n):
                if not ok[i]:
                    continue
                got = mj.keys(dv[i], pv[i] if _wp else None)
                if got is None:
                    ok[i] = False
                else:
                    out[i] = got
            return out, ok

    @rpn_fn("JsonContainsSig", 2, I, (J, J))
    def json_contains(xp, a, b):
        (av, am), (bv, bm) = a, b
        res = np.frompyfunc(mj.contains, 2, 1)(_obj(av), _obj(bv))
        return _ibool(np, res.astype(bool)), \
            np.asarray(am, bool) & np.asarray(bm, bool)

    @rpn_fn("JsonMemberOfSig", 2, I, (J, J))
    def json_member_of(xp, value, arr):
        (av, am), (bv, bm) = value, arr
        res = np.frompyfunc(mj.member_of, 2, 1)(_obj(av), _obj(bv))
        return _ibool(np, res.astype(bool)), \
            np.asarray(am, bool) & np.asarray(bm, bool)

    @rpn_fn("JsonDepthSig", 1, I, (J,))
    def json_depth(xp, a):
        (av, am) = a
        return np.frompyfunc(mj.depth, 1, 1)(_obj(av)) \
            .astype(np.int64), am

    @rpn_fn("JsonArraySig", None, J, (J,))
    def json_array(xp, *pairs):
        n = _n_of(pairs)
        rows = [_rows(p, n) for p in pairs]
        out = np.empty(n, dtype=object)
        for i in range(n):
            # SQL NULL elements become JSON null (MySQL JSON_ARRAY)
            out[i] = [v[i] if m[i] else None for v, m in rows]
        return out, np.ones(n, dtype=bool)

    @rpn_fn("JsonObjectSig", None, J, (B, J))
    def json_object(xp, *pairs):
        assert len(pairs) % 2 == 0, "JSON_OBJECT needs key/value pairs"
        n = _n_of(pairs)
        rows = [_rows(p, n) for p in pairs]
        out = np.empty(n, dtype=object)
        ok = np.ones(n, dtype=bool)
        for i in range(n):
            d = {}
            for k in range(0, len(rows), 2):
                kv, km = rows[k]
                vv, vm = rows[k + 1]
                if not km[i]:
                    ok[i] = False   # NULL key is an error → NULL row
                    break
                key = kv[i]
                if isinstance(key, (bytes, bytearray)):
                    key = key.decode("utf-8", "replace")
                d[key] = vv[i] if vm[i] else None
            else:
                out[i] = d
        return out, ok

    @rpn_fn("JsonMergeSig", None, J, (J,))
    def json_merge(xp, *pairs):
        n = _n_of(pairs)
        rows = [_rows(p, n) for p in pairs]
        out = np.empty(n, dtype=object)
        ok = np.ones(n, dtype=bool)
        for i in range(n):
            if not all(m[i] for _v, m in rows):
                ok[i] = False
                continue
            out[i] = mj.merge_preserve([v[i] for v, _m in rows])
        return out, ok

    for name, fn in (("JsonSetSig", mj.json_set),
                     ("JsonInsertSig", mj.json_insert),
                     ("JsonReplaceSig", mj.json_replace)):
        @rpn_fn(name, None, J, (J, B, J))
        def json_modify(xp, doc, *rest, _fn=fn):
            assert len(rest) % 2 == 0, "path/value pairs required"
            n = _n_of((doc,) + rest)
            dv, dm = _rows(doc, n)
            rows = [_rows(p, n) for p in rest]
            out = np.empty(n, dtype=object)
            ok = np.asarray(dm, bool).copy()
            # only NULL *paths* null the row; a SQL NULL VALUE inserts
            # the JSON null literal (MySQL JSON_SET(d, '$.a', NULL))
            path_masks = [rows[k][1] for k in range(0, len(rows), 2)]
            for i in range(n):
                if not ok[i] or not all(m[i] for m in path_masks):
                    ok[i] = False
                    continue
                pairs = [(rows[k][0][i], rows[k + 1][0][i]
                          if rows[k + 1][1][i] else None)
                         for k in range(0, len(rows), 2)]
                out[i] = _fn(dv[i], pairs)
            return out, ok

    @rpn_fn("JsonRemoveSig", None, J, (J, B))
    def json_remove(xp, doc, *path_pairs):
        n = _n_of((doc,) + path_pairs)
        dv, dm = _rows(doc, n)
        rows = [_rows(p, n) for p in path_pairs]
        out = np.empty(n, dtype=object)
        ok = np.asarray(dm, bool).copy()
        for i in range(n):
            if not ok[i] or not all(m[i] for _v, m in rows):
                ok[i] = False
                continue
            out[i] = mj.json_remove(dv[i], [v[i] for v, _m in rows])
        return out, ok

    @rpn_fn("JsonSearchSig", None, J, (J, B))
    def json_search(xp, doc, one_or_all, target, *rest):
        """JSON_SEARCH(doc, 'one'|'all', pattern[, escape[, path...]])
        → path string / array of paths / NULL.  Scope paths restrict
        the search; wildcard scopes yield NULL (unsupported)."""
        n = _n_of((doc, one_or_all, target) + rest)
        dv, dm = _rows(doc, n)
        ov, om = _rows(one_or_all, n)
        tv, tm = _rows(target, n)
        esc_rows = _rows(rest[0], n) if rest else None
        scope_rows = [_rows(p, n) for p in rest[1:]]
        out = np.empty(n, dtype=object)
        ok = np.asarray(dm, bool) & np.asarray(om, bool) & \
            np.asarray(tm, bool)
        for i in range(n):
            if not ok[i]:
                continue
            esc = 92
            if esc_rows is not None and esc_rows[1][i] and esc_rows[0][i]:
                e = esc_rows[0][i]
                esc = e[0] if isinstance(e, (bytes, bytearray)) else int(e)
            if any(not pm[i] for _pv, pm in scope_rows):
                ok[i] = False   # MySQL: NULL path argument → NULL
                continue
            scopes = tuple(pv[i] for pv, _pm in scope_rows)
            try:
                got = mj.search(dv[i], ov[i], tv[i], esc, scopes)
            except ValueError:      # wildcard scope
                ok[i] = False
                continue
            if got is mj.NOT_FOUND:
                ok[i] = False
            else:
                out[i] = got
        return out, ok

    @rpn_fn("JsonArrayAppendSig", None, J, (J, B, J))
    def json_array_append(xp, doc, *rest):
        assert len(rest) % 2 == 0, "path/value pairs required"
        n = _n_of((doc,) + rest)
        dv, dm = _rows(doc, n)
        rows = [_rows(p, n) for p in rest]
        out = np.empty(n, dtype=object)
        ok = np.asarray(dm, bool).copy()
        path_masks = [rows[k][1] for k in range(0, len(rows), 2)]
        for i in range(n):
            if not ok[i] or not all(m[i] for m in path_masks):
                ok[i] = False
                continue
            pairs = [(rows[k][0][i], rows[k + 1][0][i]
                      if rows[k + 1][1][i] else None)
                     for k in range(0, len(rows), 2)]
            out[i] = mj.array_append(dv[i], pairs)
        return out, ok

    @rpn_fn("JsonStorageSizeSig", 1, I, (J,))
    def json_storage_size(xp, a):
        (av, am) = a
        return np.frompyfunc(lambda v: len(mj.dumps(v)), 1, 1)(
            _obj(av)).astype(np.int64), am

    @rpn_fn("JsonPrettySig", 1, B, (J,))
    def json_pretty(xp, a):
        import json as _json
        (av, am) = a
        return np.frompyfunc(
            lambda v: _json.dumps(v, indent=2,
                                  ensure_ascii=False).encode(),
            1, 1)(_obj(av)), am

    # ---- casts (impl_cast.rs json arms) ----

    @rpn_fn("CastJsonAsJson", 1, J, (J,))
    def cast_json_json(xp, a):
        return a

    @rpn_fn("CastJsonAsString", 1, B, (J,))
    def cast_json_str(xp, a):
        (av, am) = a
        return np.frompyfunc(mj.dumps, 1, 1)(_obj(av)), am

    @rpn_fn("CastStringAsJson", 1, J, (B,))
    def cast_str_json(xp, a):
        """Parses the string as a JSON document; invalid text → NULL
        (the reference errors in strict mode, NULLs in non-strict)."""
        (av, am) = a
        _bad = object()

        def p(s):
            try:
                return mj.parse(s)
            except Exception:   # noqa: BLE001 — map bad JSON to NULL
                return _bad
        res = _map_json(p, av)
        bad = _map_json(lambda x: x is _bad, res).astype(bool)
        out = np.where(bad, None, res)
        return out, np.asarray(am, bool) & ~bad

    @rpn_fn("CastIntAsJson", 1, J, (I,))
    def cast_int_json(xp, a):
        (av, am) = a
        return np.frompyfunc(int, 1, 1)(np.asarray(av)), am

    @rpn_fn("CastRealAsJson", 1, J, (R,))
    def cast_real_json(xp, a):
        (av, am) = a
        return np.frompyfunc(float, 1, 1)(np.asarray(av)), am

    @rpn_fn("CastJsonAsInt", 1, I, (J,))
    def cast_json_int(xp, a):
        """Numeric/boolean/numeric-string JSON → int; other types → 0
        (MySQL warns + zero)."""
        (av, am) = a

        def to_i(v):
            if isinstance(v, bool):
                return int(v)
            if isinstance(v, (int, float)):
                return int(round(v))
            if isinstance(v, str):
                try:
                    return int(round(float(v)))
                except ValueError:
                    return 0
            return 0
        return np.frompyfunc(to_i, 1, 1)(_obj(av)).astype(np.int64), am

    @rpn_fn("CastJsonAsReal", 1, R, (J,))
    def cast_json_real(xp, a):
        (av, am) = a

        def to_f(v):
            if isinstance(v, bool):
                return float(v)
            if isinstance(v, (int, float)):
                return float(v)
            if isinstance(v, str):
                try:
                    return float(v)
                except ValueError:
                    return 0.0
            return 0.0
        return np.frompyfunc(to_f, 1, 1)(_obj(av)) \
            .astype(np.float64), am
