"""MySQL NEWDECIMAL semantics over stdlib ``decimal.Decimal``.

Reference: components/tidb_query_datatype/src/codec/mysql/decimal.rs —
a 65-digit fixed-point type with
- round HALF AWAY FROM ZERO (MySQL "round half up"),
- result scale rules: add/sub → max(s1,s2); mul → s1+s2;
  div → s1 + div_precision_increment (4); all capped at 30;
- division by zero → NULL (+warning), not an error, in the coprocessor.

The reference implements its own 9-digits-per-word bignum; here the host
representation IS ``decimal.Decimal`` (arbitrary precision, exact), with
this module supplying the MySQL-specific scale/rounding envelope.  The
device path never sees DECIMAL (the runner's ``_DEVICE_ETS`` leaves it to
the host pipeline).  The JAX package's ``datatype/mydecimal.py``, copied.
"""

from __future__ import annotations

import decimal
from decimal import Decimal
from typing import Optional

WORD_BUF_LEN_MAX_DIGITS = 65    # decimal.rs: WORD_BUF_LEN * DIGITS_PER_WORD
MAX_FRAC = 30                   # mysql max scale
DIV_PRECISION_INCREMENT = 4     # @@div_precision_increment default

# exact arithmetic context: 65 significant digits, MySQL tie rule
CTX = decimal.Context(prec=WORD_BUF_LEN_MAX_DIGITS,
                      rounding=decimal.ROUND_HALF_UP)

ZERO = Decimal(0)


def frac_of(d: Decimal) -> int:
    """The value's scale (digits right of the point), >= 0."""
    exp = d.as_tuple().exponent
    return max(0, -exp) if isinstance(exp, int) else 0


def add(a: Decimal, b: Decimal) -> Decimal:
    return CTX.add(a, b)


def sub(a: Decimal, b: Decimal) -> Decimal:
    return CTX.subtract(a, b)


def mul(a: Decimal, b: Decimal) -> Decimal:
    return CTX.multiply(a, b)


def div(a: Decimal, b: Decimal,
        incr: int = DIV_PRECISION_INCREMENT) -> Optional[Decimal]:
    """a / b at scale frac(a) + incr (capped MAX_FRAC); None on b == 0
    (MySQL: division by zero yields NULL with a warning)."""
    if not b:
        return None
    frac = min(frac_of(a) + incr, MAX_FRAC)
    q = CTX.divide(a, b)
    return round_frac(q, frac)


def mod(a: Decimal, b: Decimal) -> Optional[Decimal]:
    """MySQL MOD: sign follows the dividend; None on b == 0."""
    if not b:
        return None
    return CTX.remainder(a, b)


def round_frac(d: Decimal, frac: int = 0) -> Decimal:
    """ROUND(d, frac) — half away from zero.  Negative frac rounds left
    of the point (MySQL ROUND(123, -2) = 100)."""
    frac = min(frac, MAX_FRAC)
    q = Decimal(1).scaleb(-frac)
    return d.quantize(q, rounding=decimal.ROUND_HALF_UP, context=CTX)


def ceil(d: Decimal) -> Decimal:
    return d.to_integral_value(rounding=decimal.ROUND_CEILING)


def floor(d: Decimal) -> Decimal:
    return d.to_integral_value(rounding=decimal.ROUND_FLOOR)


def truncate(d: Decimal, frac: int = 0) -> Decimal:
    frac = min(frac, MAX_FRAC)
    q = Decimal(1).scaleb(-frac)
    return d.quantize(q, rounding=decimal.ROUND_DOWN, context=CTX)


def to_int(d: Decimal) -> int:
    """CastDecimalAsInt: round half away from zero to an integer."""
    return int(d.to_integral_value(rounding=decimal.ROUND_HALF_UP))


def from_float(x: float) -> Decimal:
    """CastRealAsDecimal: MySQL converts through the decimal printout of
    the double (not the exact binary expansion)."""
    return CTX.create_decimal(repr(float(x)))


def from_int(x: int) -> Decimal:
    return Decimal(int(x))


def from_string(s) -> Optional[Decimal]:
    """Parse the longest numeric prefix (MySQL string→decimal coercion:
    '12.5abc' → 12.5, 'abc' → 0, '' → 0).  Never raises."""
    if isinstance(s, (bytes, bytearray)):
        s = s.decode("utf-8", "replace")
    s = s.strip()
    # longest valid prefix: sign, digits, one dot, optional exponent
    n = len(s)
    i = 0
    if i < n and s[i] in "+-":
        i += 1
    seen_digit = False
    seen_dot = False
    while i < n:
        ch = s[i]
        if ch.isdigit():
            seen_digit = True
        elif ch == "." and not seen_dot:
            seen_dot = True
        else:
            break
        i += 1
    # optional exponent only if digits follow it
    if seen_digit and i < n and s[i] in "eE":
        j = i + 1
        if j < n and s[j] in "+-":
            j += 1
        if j < n and s[j].isdigit():
            while j < n and s[j].isdigit():
                j += 1
            i = j
    prefix = s[:i]
    if not seen_digit:
        return ZERO
    try:
        return CTX.create_decimal(prefix)
    except decimal.InvalidOperation:    # pragma: no cover
        return ZERO


def to_string(d: Decimal) -> bytes:
    """MySQL text form: plain notation, scale preserved ('1.20' stays
    '1.20'), no exponent."""
    s = format(d, "f")
    return s.encode()
