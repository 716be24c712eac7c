"""Collations — string comparison orders beyond raw bytes.

The JAX package's ``datatype/collation.py``, copied.

Reference: tidb_query_datatype/src/codec/collation/ (Collator impls per
collation id, dispatched through ``match_template_collator!``).  The
host representation keeps BYTES columns as raw bytes; a collation is a
pure function bytes → sort key, so compare/order/group under collation
C is bytewise compare of ``sort_key(C, value)`` — exactly the
reference's ``write_sort_key`` contract.

Supported (the set TiDB enables by default with new_collations):
- binary (63): identity.
- ascii_bin (65) / latin1_bin (47) / utf8_bin (83) / utf8mb4_bin (46):
  PAD SPACE — trailing spaces are insignificant, otherwise bytewise.
- utf8_general_ci (33) / utf8mb4_general_ci (45): PAD SPACE +
  case-insensitive; weight = uppercase codepoint (BMP), the
  general_ci simplification the reference implements (collator/
  charset.rs general ci weight tables; supplementary-plane chars weight
  0xFFFD).
- utf8mb4_unicode_ci (224): approximated by general_ci weights — a
  documented deviation (the reference ships full UCA tables).

TiDB wire quirk: new-collation framework sends NEGATED ids; abs() on
ingestion (field_type.rs collation accessor does the same).
"""

from __future__ import annotations

BINARY = 63
ASCII_BIN = 65
LATIN1_BIN = 47
UTF8_BIN = 83
UTF8MB4_BIN = 46
UTF8_GENERAL_CI = 33
UTF8MB4_GENERAL_CI = 45
UTF8MB4_UNICODE_CI = 224

_PAD_BIN = {ASCII_BIN, LATIN1_BIN, UTF8_BIN, UTF8MB4_BIN}
_GENERAL_CI = {UTF8_GENERAL_CI, UTF8MB4_GENERAL_CI, UTF8MB4_UNICODE_CI}

NAMES = {
    BINARY: "binary",
    ASCII_BIN: "ascii_bin",
    LATIN1_BIN: "latin1_bin",
    UTF8_BIN: "utf8_bin",
    UTF8MB4_BIN: "utf8mb4_bin",
    UTF8_GENERAL_CI: "utf8_general_ci",
    UTF8MB4_GENERAL_CI: "utf8mb4_general_ci",
    UTF8MB4_UNICODE_CI: "utf8mb4_unicode_ci",
}


def normalize_id(collation: int) -> int:
    return abs(int(collation))


def sort_key(value: bytes, collation: int = BINARY) -> bytes:
    """bytes → memcomparable weight string for the collation."""
    c = normalize_id(collation)
    if c == BINARY or c not in NAMES:
        return value
    if c in _PAD_BIN:
        return value.rstrip(b" ")
    # general_ci family
    s = value.decode("utf-8", "replace").rstrip(" ")
    out = bytearray()
    for ch in s:
        cp = ord(ch)
        if cp > 0xFFFF:
            w = 0xFFFD          # supplementary plane: replacement weight
        else:
            w = ord(ch.upper()[0]) if ch.upper() else cp
            if w > 0xFFFF:      # rare expanding uppercase (ß→SS etc.)
                w = cp
        out += w.to_bytes(2, "big")
    return bytes(out)


def compare(a: bytes, b: bytes, collation: int = BINARY) -> int:
    ka, kb = sort_key(a, collation), sort_key(b, collation)
    return (ka > kb) - (ka < kb)


def eq(a: bytes, b: bytes, collation: int = BINARY) -> bool:
    return sort_key(a, collation) == sort_key(b, collation)


# ---------------------------------------------------------------- enum/set

def enum_name(ordinal: int, elems) -> bytes:
    """MySQL ENUM: 1-based ordinal into the definition; 0 — and any
    ordinal beyond the table (stale/corrupt row after a definition
    shrink) — is the empty ('data truncated') value, never an error."""
    if ordinal <= 0 or ordinal > len(elems):
        return b""
    name = elems[int(ordinal) - 1]
    return name if isinstance(name, bytes) else str(name).encode()


def set_names(mask: int, elems) -> bytes:
    """MySQL SET: bit i set → elems[i]; display is comma-joined in
    definition order."""
    out = []
    for i, name in enumerate(elems):
        if mask & (1 << i):
            out.append(name if isinstance(name, bytes)
                       else str(name).encode())
    return b",".join(out)


def parse_enum(name: bytes, elems, collation: int = BINARY) -> int:
    """name → 1-based ordinal (0 when absent, MySQL's coercion).
    Name resolution honors the column collation (ci / pad-space)."""
    target = sort_key(name if isinstance(name, bytes)
                      else str(name).encode(), collation)
    for i, e in enumerate(elems):
        e = e if isinstance(e, bytes) else str(e).encode()
        if sort_key(e, collation) == target:
            return i + 1
    return 0


def parse_set(text: bytes, elems, collation: int = BINARY) -> int:
    mask = 0
    if not text:
        return 0
    keys = [sort_key(e if isinstance(e, bytes) else str(e).encode(),
                     collation) for e in elems]
    for part in text.split(b","):
        pk = sort_key(part, collation)
        for i, k in enumerate(keys):
            if k == pk:
                mask |= 1 << i
    return mask


def like_regex_src(pattern: str, escape: int) -> str:
    """MySQL LIKE pattern → anchored regex SOURCE (str mode) — the ONE
    translation shared by expr/impl_like.py (ci branch) and
    myjson.search, so escape/%/_ semantics can never drift."""
    import re as _re
    esc = chr(escape & 0xFF)
    out = ["^"]
    i, n = 0, len(pattern)
    while i < n:
        ch = pattern[i]
        if ch == esc and i + 1 < n:
            out.append(_re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append("(?s:.*)")
        elif ch == "_":
            out.append("(?s:.)")
        else:
            out.append(_re.escape(ch))
        i += 1
    out.append("$")
    return "".join(out)
