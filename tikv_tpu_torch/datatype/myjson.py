"""MySQL JSON semantics over plain Python values.

Reference: tidb_query_datatype/src/codec/mysql/json/ — the reference
stores a MySQL-binary JSON encoding; the host representation here is the
parsed Python value (dict / list / str / int / float / bool / None for
the JSON null literal), with SQL NULL carried by the column validity
mask, so the two nulls never collide.  This module supplies the
MySQL-specific behavior: path expressions, type names, containment,
merge, and modify operations.  The JAX package's ``datatype/myjson.py``,
copied.
"""

from __future__ import annotations

import json
from typing import Optional


class _NotFound:
    __repr__ = lambda self: "JSON_NOT_FOUND"     # noqa: E731


NOT_FOUND = _NotFound()


def parse(text) -> object:
    """Parse JSON text (bytes/str) → value.  Raises ValueError on bad
    input (callers map to NULL/err per sig semantics)."""
    if isinstance(text, (bytes, bytearray)):
        text = text.decode("utf-8")
    return json.loads(text)


def dumps(value) -> bytes:
    """MySQL display form: ", "-separated, sorted-insertion order kept
    (python dicts preserve insertion; MySQL sorts keys by length then
    alphabetically in its binary format — we normalize to plain
    json.dumps with ", "/": " separators, the form MySQL prints)."""
    return json.dumps(value, separators=(", ", ": "),
                      ensure_ascii=False).encode()


def type_name(v) -> bytes:
    """JSON_TYPE — reference json/mod.rs json_type."""
    if v is None:
        return b"NULL"
    if isinstance(v, bool):
        return b"BOOLEAN"
    if isinstance(v, int):
        return b"INTEGER"
    if isinstance(v, float):
        return b"DOUBLE"
    if isinstance(v, str):
        return b"STRING"
    if isinstance(v, list):
        return b"ARRAY"
    if isinstance(v, dict):
        return b"OBJECT"
    raise TypeError(type(v))


# ---------------------------------------------------------------- paths

def parse_path(path) -> list:
    """$.key / $."quoted" / [3] / [*] / .* / ** → list of legs.

    Legs: ("key", name) | ("idx", n) | ("key*",) | ("idx*",) | ("**",).
    Reference: json/path_expr.rs.
    """
    if isinstance(path, (bytes, bytearray)):
        path = path.decode("utf-8")
    s = path.strip()
    if not s or s[0] != "$":
        raise ValueError(f"bad json path {path!r}")
    i, n = 1, len(s)
    legs: list = []
    while i < n:
        ch = s[i]
        if ch == ".":
            i += 1
            if i < n and s[i] == "*":
                legs.append(("key*",))
                i += 1
                continue
            if i < n and s[i] == '"':
                # closing quote search must skip backslash escapes; the
                # quoted segment is itself a JSON string literal
                j = i + 1
                while j < n:
                    if s[j] == "\\":
                        j += 2
                        continue
                    if s[j] == '"':
                        break
                    j += 1
                if j >= n:
                    raise ValueError(f"unterminated key in {path!r}")
                legs.append(("key", json.loads(s[i:j + 1])))
                i = j + 1
                continue
            j = i
            while j < n and (s[j].isalnum() or s[j] in "_$"):
                j += 1
            if j == i:
                raise ValueError(f"bad member leg in {path!r}")
            legs.append(("key", s[i:j]))
            i = j
        elif ch == "[":
            j = s.index("]", i)
            inner = s[i + 1:j].strip()
            if inner == "*":
                legs.append(("idx*",))
            else:
                legs.append(("idx", int(inner)))
            i = j + 1
        elif ch == "*" and i + 1 < n and s[i + 1] == "*":
            legs.append(("**",))
            i += 2
        elif ch.isspace():
            i += 1
        else:
            raise ValueError(f"bad json path {path!r} at {i}")
    return legs


def path_is_wild(legs) -> bool:
    return any(leg[0] in ("key*", "idx*", "**") for leg in legs)


def _walk(v, legs, out: list):
    if not legs:
        out.append(v)
        return
    leg, rest = legs[0], legs[1:]
    kind = leg[0]
    if kind == "key":
        if isinstance(v, dict) and leg[1] in v:
            _walk(v[leg[1]], rest, out)
    elif kind == "idx":
        if isinstance(v, list):
            if 0 <= leg[1] < len(v):
                _walk(v[leg[1]], rest, out)
        elif leg[1] == 0:
            # MySQL: scalar behaves as a single-element array for [0]
            _walk(v, rest, out)
    elif kind == "key*":
        if isinstance(v, dict):
            for x in v.values():
                _walk(x, rest, out)
    elif kind == "idx*":
        if isinstance(v, list):
            for x in v:
                _walk(x, rest, out)
    elif kind == "**":
        # ** requires a following leg in MySQL; match at every depth
        _walk(v, rest, out)
        if isinstance(v, dict):
            for x in v.values():
                _walk(x, legs, out)
        elif isinstance(v, list):
            for x in v:
                _walk(x, legs, out)


def extract(doc, paths) -> object:
    """JSON_EXTRACT(doc, path...) — single concrete path → the value;
    multiple paths or wildcards → array of matches; none → NOT_FOUND."""
    matches: list = []
    wild = len(paths) > 1
    for p in paths:
        legs = parse_path(p)
        wild = wild or path_is_wild(legs)
        _walk(doc, legs, matches)
    if not matches:
        return NOT_FOUND
    if wild:
        return matches
    return matches[0]


# ------------------------------------------------------------- semantics

def json_eq(a, b) -> bool:
    """Type-aware equality: JSON true != 1 (python True == 1 would)."""
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a is b
    if isinstance(a, int) and isinstance(b, int):
        return a == b       # exact — float() would collapse above 2^53
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, list):
        return len(a) == len(b) and all(json_eq(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(json_eq(a[k], b[k])
                                            for k in a)
    return a == b


def contains(target, candidate) -> bool:
    """JSON_CONTAINS semantics (json/json_contains.rs):
    - object contains object: every key/value of candidate contained;
    - array contains array: every candidate element contained in target;
    - array contains scalar/object: some element contains it;
    - scalar contains scalar: equality."""
    if isinstance(target, list):
        if isinstance(candidate, list):
            return all(contains(target, c) for c in candidate)
        return any(contains(t, candidate) for t in target)
    if isinstance(target, dict):
        if isinstance(candidate, dict):
            return all(k in target and contains(target[k], v)
                       for k, v in candidate.items())
        return False
    return json_eq(target, candidate)


def member_of(value, array) -> bool:
    """value MEMBER OF(array): array → element equality; non-array →
    equality with the whole document."""
    if isinstance(array, list):
        return any(json_eq(value, x) for x in array)
    return json_eq(value, array)


def merge_preserve(docs) -> object:
    """JSON_MERGE_PRESERVE: arrays concat, objects union (recursive),
    scalars wrap to arrays (json/json_merge.rs)."""
    out = docs[0]
    for d in docs[1:]:
        out = _merge2(out, d)
    return out


def _merge2(a, b):
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = _merge2(out[k], v) if k in out else v
        return out
    la = a if isinstance(a, list) else [a]
    lb = b if isinstance(b, list) else [b]
    return la + lb


def depth(v) -> int:
    if isinstance(v, dict):
        return 1 + max((depth(x) for x in v.values()), default=0)
    if isinstance(v, list):
        return 1 + max((depth(x) for x in v), default=0)
    return 1


def length(v, path: Optional[bytes] = None):
    """JSON_LENGTH: scalars → 1; arrays/objects → element count; with a
    path, length of the value at the path (None when absent)."""
    if path is not None:
        got = extract(v, [path])
        if got is NOT_FOUND:
            return None
        v = got
    if isinstance(v, (dict, list)):
        return len(v)
    return 1


def keys(v, path: Optional[bytes] = None):
    if path is not None:
        got = extract(v, [path])
        if got is NOT_FOUND:
            return None
        v = got
    if isinstance(v, dict):
        return list(v.keys())
    return None


def unquote(v) -> bytes:
    """JSON_UNQUOTE: strings print raw; everything else prints as JSON
    text (json/json_unquote.rs)."""
    if isinstance(v, str):
        return v.encode()
    return dumps(v)


def quote(s) -> bytes:
    if isinstance(s, (bytes, bytearray)):
        s = s.decode("utf-8", "replace")
    return json.dumps(s, ensure_ascii=False).encode()


# ----------------------------------------------------------- modify ops

def _modify(doc, path_value_pairs, mode: str):
    """JSON_SET / JSON_INSERT / JSON_REPLACE (json/modifier.rs).

    set: create or replace; insert: create only; replace: existing only.
    Wildcard paths are rejected (as in MySQL).
    """
    import copy
    out = copy.deepcopy(doc)
    for path, value in path_value_pairs:
        legs = parse_path(path)
        if path_is_wild(legs):
            raise ValueError("wildcards not allowed in modify paths")
        # the value is inserted BY VALUE: without this copy a later pair
        # addressing into it would mutate the caller's (shared) object
        value = copy.deepcopy(value)
        if not legs:
            if mode in ("set", "replace"):
                out = value
            continue
        out = _set_leg(out, legs, value, mode)
    return out


def _set_leg(v, legs, value, mode):
    leg, rest = legs[0], legs[1:]
    kind = leg[0]
    if kind == "key":
        if not isinstance(v, dict):
            return v
        k = leg[1]
        if k in v:
            if rest:
                v[k] = _set_leg(v[k], rest, value, mode)
            elif mode in ("set", "replace"):
                v[k] = value
        elif not rest and mode in ("set", "insert"):
            v[k] = value
        return v
    # index leg
    idx = leg[1]
    if not isinstance(v, list):
        # scalar as single-element array: [0] addresses it; appending
        # past the end wraps to an array (MySQL autowrap)
        if idx == 0:
            if rest:
                return _set_leg(v, rest, value, mode)
            return value if mode in ("set", "replace") else v
        if mode in ("set", "insert") and not rest:
            return [v, value]
        return v
    if 0 <= idx < len(v):
        if rest:
            v[idx] = _set_leg(v[idx], rest, value, mode)
        elif mode in ("set", "replace"):
            v[idx] = value
    elif not rest and mode in ("set", "insert"):
        v.append(value)
    return v


def json_set(doc, pairs):
    return _modify(doc, pairs, "set")


def json_insert(doc, pairs):
    return _modify(doc, pairs, "insert")


def json_replace(doc, pairs):
    return _modify(doc, pairs, "replace")


def json_remove(doc, paths):
    import copy
    out = copy.deepcopy(doc)
    for path in paths:
        legs = parse_path(path)
        if path_is_wild(legs) or not legs:
            raise ValueError("bad remove path")
        out = _remove_leg(out, legs)
    return out


def _remove_leg(v, legs):
    leg, rest = legs[0], legs[1:]
    if leg[0] == "key" and isinstance(v, dict) and leg[1] in v:
        if rest:
            v[leg[1]] = _remove_leg(v[leg[1]], rest)
        else:
            del v[leg[1]]
    elif leg[0] == "idx" and isinstance(v, list) and \
            0 <= leg[1] < len(v):
        if rest:
            v[leg[1]] = _remove_leg(v[leg[1]], rest)
        else:
            del v[leg[1]]
    return v


import functools


@functools.lru_cache(maxsize=1024)
def _like_pattern(pattern: str, escape: int):
    """Compiled LIKE matcher (cached per pattern — JSON_SEARCH visits
    thousands of string nodes with ONE pattern).  Translation shared
    with impl_like via collation.like_regex_src."""
    import re
    from .collation import like_regex_src
    return re.compile(like_regex_src(pattern, escape))


def search(doc, one_or_all: bytes, target: bytes, escape: int = 92,
           scope_paths=()) -> object:
    """JSON_SEARCH: paths of STRING values LIKE ``target``; 'one' stops
    at the first hit.  ONE match returns the bare path string, several
    return an array (MySQL autowraps only on multiple matches); none ->
    NOT_FOUND.  ``scope_paths`` restrict the search to concrete
    subtrees; wildcard scopes raise ValueError (NULL at the sig layer).
    """
    if isinstance(one_or_all, (bytes, bytearray)):
        one_or_all = one_or_all.decode()
    if isinstance(target, (bytes, bytearray)):
        target = target.decode("utf-8", "replace")
    rx = _like_pattern(target, escape)
    found: list = []

    def walk(v, path):
        if isinstance(v, str) and rx.match(v):
            found.append(path)
            if one_or_all == "one":
                return True
        if isinstance(v, dict):
            for k, x in v.items():
                key = k if k.isalnum() and not k[:1].isdigit() \
                    else '"' + k.replace('"', '\\"') + '"'
                if walk(x, f"{path}.{key}"):
                    return True
        elif isinstance(v, list):
            for i, x in enumerate(v):
                if walk(x, f"{path}[{i}]"):
                    return True
        return False

    if scope_paths:
        for sp in scope_paths:
            legs = parse_path(sp)
            if path_is_wild(legs):
                raise ValueError("wildcard scope paths unsupported")
            sub = extract(doc, [sp])
            if sub is NOT_FOUND:
                continue
            prefix = (sp.decode() if isinstance(sp, (bytes, bytearray))
                      else sp).strip()
            if walk(sub, prefix):
                break
    else:
        walk(doc, "$")
    if not found:
        return NOT_FOUND
    if len(found) == 1:
        return found[0]
    return found



def array_append(doc, pairs):
    """JSON_ARRAY_APPEND: value at each path wraps to an array (if not
    one already) and the new element appends (json/modifier.rs)."""
    import copy
    out = copy.deepcopy(doc)
    for path, value in pairs:
        legs = parse_path(path)
        if path_is_wild(legs):
            raise ValueError("wildcards not allowed")
        target = extract(out, [path])
        if target is NOT_FOUND:
            continue
        if isinstance(target, list):
            new = target + [copy.deepcopy(value)]
        else:
            new = [copy.deepcopy(target), copy.deepcopy(value)]
        out = json_set(out, [(path, new)]) if legs else new
    return out
