"""Every signature of the reference's registry, on the host path of both
packages.

One case a signature (two for a signature that reads its node's context:
under the binary collation and under ``utf8mb4_general_ci``): the same
seeded columns of each argument type — NULLs, zero dates, negative
durations, DECIMALs of 65 digits, binary and non-ASCII strings, enum and
set values past their name tables, JSON documents of every type with
the JSON null beside SQL NULL — go through the reference's
``build_rpn``/``eval_rpn`` and the port's, with numpy.  The validity must be
equal, and the values where valid: exactly, a REAL within 1 ulp, a DECIMAL
with its scale.  Where the reference raises (a DECIMAL of 65 digits does
not fit an int64, a quotient past 65 digits), the port must raise the same
exception type, and both must then agree on the same columns with those
values replaced by a small one.

``Uuid`` is the one nondeterministic signature (a random UUID a row): it is
held to the shape, the validity and the text form of the reference's
answer, and each row's value must differ from the others.

A JSON signature's BYTES arguments are drawn from pools of their role
(``JSON_ARGS``): JSON paths (concrete ones where the reference rejects
wildcards), JSON texts, object keys, 'one'/'all', LIKE patterns and
escapes; a JSON value is compared by its ``repr``, so ``true`` is not 1.

The registry test holds the port's registry to the reference's: the same
signatures, each with the reference's arity, types, ``needs_ctx``,
``needs_rows`` and ``device_safe``.
"""

import decimal
import re
import zlib
from decimal import Decimal as D

import numpy as np
import pytest

from tikv_tpu.datatype import EvalType as RefET
from tikv_tpu.datatype.time import pack_datetime
from tikv_tpu.expr import Expr as RefExpr
from tikv_tpu.expr import build_rpn as ref_build_rpn
from tikv_tpu.expr import eval_rpn as ref_eval_rpn
from tikv_tpu.expr.functions import FUNCTIONS as REF

from tikv_tpu_torch.datatype import EvalType
from tikv_tpu_torch.expr import Expr, build_rpn, eval_rpn
from tikv_tpu_torch.expr.functions import FUNCTIONS as PORT

N = 48
BINARY, GENERAL_CI = 63, 45
ENUM_ELEMS = (b"red", b"Green", b"blue ")
SET_ELEMS = (b"a", b"B", b"c")
JSON_SIGS = {name for name, m in REF.items()
             if m.fn.__module__.endswith("impl_json")}

# argument types where the registry's (variadic: repeated) ones would not
# exercise the signature
ARG_TYPES = {
    "Elt": ("int", "bytes", "bytes"),
    "RegexpInStrSig": ("bytes", "bytes", "int"),
    "RegexpSubstrSig": ("bytes", "bytes"),
}
# the JSON sigs' arguments by role: a role names a pool of BYTES values
# (``_POOLS``), else it is an eval type
JSON_ARGS = {
    "JsonExtractSig": ("json", "path", "path"),
    "JsonLengthSig": ("json", "path"),
    "JsonKeys2ArgsSig": ("json", "path"),
    "JsonValidStringSig": ("jtext",),
    "CastStringAsJson": ("jtext",),
    "JsonObjectSig": ("key", "json", "key", "json"),
    "JsonSetSig": ("json", "mpath", "json", "mpath", "json"),
    "JsonInsertSig": ("json", "mpath", "json"),
    "JsonReplaceSig": ("json", "mpath", "json"),
    "JsonRemoveSig": ("json", "mpath", "mpath"),
    "JsonArrayAppendSig": ("json", "mpath", "json"),
    "JsonSearchSig": ("json", "oneall", "pattern", "esc"),
}
_POOLS = {
    "path": [b"$", b"$.a", b"$.b", b"$.name", b"$.tags", b"$[0]", b"$[1]",
             b"$.*", b"$[*]", b"$**.a", b"$.tags[1]", b'$."a b"',
             b"$.a.b"],
    "mpath": [b"$.a", b"$.b", b"$.name", b"$[0]", b"$[2]", b"$.tags[0]",
              b"$.a.b", b"$.z"],
    "jtext": [b'{"a": 1}', b"[1, 2]", b"3", b'"s"', b"null", b"true",
              b"bad{", b"", b'{"a": [1, {"b": 2}]}', b"-0.5"],
    "key": [b"a", b"b", b"name", "été".encode()],
    "oneall": [b"one", b"all"],
    "pattern": [b"a%", b"%", b"t_", b"n%", b"x", b"%1%"],
    "esc": [b"\\", b"|", b""],
}

_INTS = [0, 1, -1, 2, 3, 7, 12, 31, 63, 64, 100, 224, 256, 1995, 199712,
         730120]
_BYTES = [b"", b"abc", b"ABC", b"Hello World", b"  pad  ", b"abc ",
          b"a%b_c", b"1995-03-04", b"12.5abc", b"-7", b"0", b"3e2",
          b"192.168.1.1", b"::ffff:1.2.3.4", b"a,b,c", b"a,B",
          "été".encode(), b"MiXeD cAsE", b"b", b"red", b"GREEN",
          b"6ccd780c-baba-1026-9564-5b8c656024db", b"\x00\xff",
          b"%Y-%m-%d %H:%i:%s.%f", b"%W %a %j %w %%w", b"%b %e %c %y %r",
          b"aGVsbG8=", b"\xc0\xa8\x01\x01", bytes(range(16))]
_DECIMALS = [D("0"), D("1.20"), D("-0.005"), D("3.14159265358979323846"),
             D("-99999.99"), D("0.000000000000000000000000000001"),
             D("1" * 65), D("-" + "9" * 35 + "." + "9" * 30), D("12.5"),
             D("-7")]
_DATETIMES = [0, int(pack_datetime(2020, 0, 0)),
              int(pack_datetime(2000, 2, 29, 23, 59, 59, 999999)),
              int(pack_datetime(1999, 12, 31)), int(pack_datetime(1, 1, 1)),
              int(pack_datetime(9999, 12, 31, 23, 59, 59))]
_DURATIONS = [0, -1, 1, 86_400 * 10**9, -(838 * 3600 + 3599) * 10**9,
              (838 * 3600 + 3599) * 10**9 + 999_999_000]


def _column(et: str, rng):
    """(values, validity) of N rows of ``et``: a mix of drawn values and
    the pool of edge cases, ~15% NULL (a NULL slot holds the type's
    harmless value, as a Column's does)."""
    ok = rng.random(N) > 0.15
    pick = rng.random(N) < 0.4
    if et == "int":
        v = np.where(pick, rng.choice(_INTS, N), rng.integers(-5, 41, N))
        return np.where(ok, v, 0).astype(np.int64), ok
    if et == "real":
        v = np.where(pick, rng.choice([0.0, -0.0, 0.5, -2.5, 1e10, 3.25,
                                       0.1], N),
                     rng.integers(-40, 41, N) / 4.0)
        return np.where(ok, v, 0.0).astype(np.float64), ok
    if et in ("bytes", "decimal"):
        pool = _BYTES if et == "bytes" else _DECIMALS
        fill = b"" if et == "bytes" else D(0)
        v = np.empty(N, dtype=object)
        for i, j in enumerate(rng.integers(0, len(pool), N)):
            v[i] = pool[j] if ok[i] else fill
        if et == "decimal":
            drawn = rng.integers(-10**6, 10**6, N)
            for i in np.flatnonzero(ok & ~pick):
                v[i] = D(int(drawn[i])).scaleb(-int(rng.integers(0, 6)))
        return v, ok
    if et == "datetime":
        t = pack_datetime(rng.integers(1990, 2031, N),
                          rng.integers(1, 13, N), rng.integers(1, 29, N),
                          rng.integers(0, 24, N), rng.integers(0, 60, N),
                          rng.integers(0, 60, N),
                          rng.integers(0, 1_000_000, N)).astype(np.uint64)
        v = np.where(pick, np.asarray(rng.choice(_DATETIMES, N), np.uint64),
                     t)
        return np.where(ok, v, 0).astype(np.uint64), ok
    if et == "duration":
        v = np.where(pick, rng.choice(_DURATIONS, N),
                     rng.integers(-100 * 3600 * 10**9,
                                  100 * 3600 * 10**9, N))
        return np.where(ok, v, 0).astype(np.int64), ok
    if et in _POOLS:
        pool = _POOLS[et]
        v = np.empty(N, dtype=object)
        for i, j in enumerate(rng.integers(0, len(pool), N)):
            v[i] = pool[j] if ok[i] else b""
        return v, ok
    if et == "json":
        v = np.empty(N, dtype=object)
        for i in range(N):
            v[i] = _json_doc(rng) if ok[i] else None
        return v, ok
    if et in ("enum", "set"):
        hi = len(ENUM_ELEMS) + 2 if et == "enum" else 1 << (len(SET_ELEMS)
                                                            + 1)
        return np.where(ok, rng.integers(0, hi, N), 0).astype(np.uint64), ok
    raise AssertionError(et)


def _json_doc(rng, depth: int = 0):
    """A JSON document: objects over a few keys, arrays, and scalars of
    every JSON type (the JSON null among them)."""
    r = rng.random()
    if depth > 2 or r < 0.4:
        return [None, True, False, int(rng.integers(-9, 9)),
                float(rng.integers(-8, 8)) / 4, "t" + str(rng.integers(4)),
                "", 2 ** 62][int(rng.integers(8))]
    if r < 0.65:
        return [_json_doc(rng, depth + 1)
                for _ in range(int(rng.integers(0, 4)))]
    return {k: _json_doc(rng, depth + 1) for k in rng.choice(
        ["a", "b", "name", "tags", "a b"], int(rng.integers(0, 4)),
        replace=False).tolist()}


def _tame(cols, types):
    """``cols`` with every DECIMAL of more than 20 digits replaced by
    12.5."""
    out = []
    for (v, ok), t in zip(cols, types):
        if t == "decimal":
            v = np.array([x if len(x.as_tuple().digits) <= 20 else D("12.5")
                          for x in v], dtype=object)
        out.append((v, ok))
    return out


def _cases():
    out = []
    for name in sorted(REF):
        colls = (BINARY, GENERAL_CI) if REF[name].needs_ctx else (BINARY,)
        out += [(name, c) for c in colls]
    return out


def _arg_types(name: str) -> list:
    meta = REF[name]
    if name in ARG_TYPES:
        return list(ARG_TYPES[name])
    if name in JSON_ARGS:
        return list(JSON_ARGS[name])
    arity = meta.arity if meta.arity is not None else 3
    return [meta.args[min(i, len(meta.args) - 1)].value
            for i in range(arity)]


def _run(build, evaluate, expr_cls, et_cls, name, types, cols, coll):
    children = []
    for i, t in enumerate(types):
        elems = ENUM_ELEMS if t == "enum" else SET_ELEMS if t == "set" \
            else ()
        et = "bytes" if t in _POOLS else t
        children.append(expr_cls.column(
            i, et_cls(et), collation=coll if et == "bytes" else BINARY,
            elems=elems))
    copies = [(v.copy(), m.copy()) for v, m in cols]
    try:
        with decimal.localcontext(decimal.Context()):
            v, ok = evaluate(build(expr_cls.call(name, *children)), copies,
                             N, np)
    except Exception as e:      # the reference's error is an answer too
        return e
    return (np.asarray(np.broadcast_to(v, (N,))),
            np.asarray(np.broadcast_to(ok, (N,)), dtype=bool))


def _same(a, b) -> bool:
    if isinstance(a, D) and isinstance(b, D):
        return str(a) == str(b)
    if isinstance(a, (dict, list)) or isinstance(b, (dict, list)):
        return repr(a) == repr(b)
    if isinstance(a, float) and isinstance(b, float):
        return (np.isnan(a) and np.isnan(b)) or a == b or \
            abs(a - b) <= np.spacing(max(abs(a), abs(b)))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("sig,coll", _cases())
def test_host_answer_matches_reference(sig, coll):
    assert sig in PORT
    types = _arg_types(sig)
    rng = np.random.default_rng(zlib.crc32(f"{sig}/{coll}".encode()))
    cols = [_column(t, rng) for t in types]
    want = _run(ref_build_rpn, ref_eval_rpn, RefExpr, RefET, sig, types,
                cols, coll)
    got = _run(build_rpn, eval_rpn, Expr, EvalType, sig, types, cols, coll)
    if isinstance(want, Exception):
        assert type(got) is type(want), (want, got)
        cols = _tame(cols, types)
        want = _run(ref_build_rpn, ref_eval_rpn, RefExpr, RefET, sig, types,
                    cols, coll)
        got = _run(build_rpn, eval_rpn, Expr, EvalType, sig, types, cols,
                   coll)
        assert not isinstance(want, Exception), want
    assert not isinstance(got, Exception), got
    (wv, wok), (gv, gok) = want, got
    np.testing.assert_array_equal(gok, wok)
    assert gv.dtype == wv.dtype
    if sig == "Uuid":
        form = re.compile(rb"^[0-9a-f]{8}(-[0-9a-f]{4}){3}-[0-9a-f]{12}$")
        assert all(form.match(x) for x in gv) and \
            all(form.match(x) for x in wv)
        assert len(set(gv.tolist())) == N
        return
    if wv.dtype.kind == "f":
        np.testing.assert_array_max_ulp(gv[wok], wv[wok], 1)
        return
    for i in np.flatnonzero(wok):
        x, y = gv[i], wv[i]
        x = x.item() if isinstance(x, np.generic) else x
        y = y.item() if isinstance(y, np.generic) else y
        assert _same(x, y), (i, x, y)


def test_registry_matches_reference():
    """The port registers every sig of the reference, the 30 of impl_json
    among them, and nothing the reference lacks; each with the reference's
    metadata (no JSON sig is device-safe)."""
    assert len(JSON_SIGS) == 30
    assert set(REF) == set(PORT)
    assert not any(PORT[k].device_safe for k in JSON_SIGS)

    def meta(m):
        return (m.arity, m.ret.value, [a.value for a in m.args],
                m.needs_ctx, m.needs_rows, m.device_safe)

    assert {k: meta(PORT[k]) for k in PORT} == \
        {k: meta(REF[k]) for k in PORT}
    assert sorted(k for k, m in PORT.items()
                  if m.device_safe and not all(
                      a.value in ("int", "real") for a in m.args)) == \
        sorted(s + t for s in ("Eq", "Ge", "Gt", "Le", "Lt", "Ne")
               for t in ("Duration", "Time"))
