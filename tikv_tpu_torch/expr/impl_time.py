"""Time ScalarFuncSig implementations over the packed u64 core.

Reference: components/tidb_query_expr/src/impl_time.rs (extraction,
TO_DAYS/TO_SECONDS, LAST_DAY, DATEDIFF, PERIOD_ADD/DIFF, week modes) and
tidb_query_datatype/src/codec/mysql/time/mod.rs (the packed CoreTime the
reference moves through its columnar engine).  The packing here is
datatype/time.py's explicit shift/mask layout; all extraction is
vectorized bit math over uint64 arrays, and calendar math uses the
branch-free civil-days algorithm.  These sigs are host only (their
``device_safe`` is False, as in the JAX package, whose
``expr/impl_time.py`` this is, copied): a device plan compares and orders
DATETIME and DURATION values (``impl_types``) but never unpacks a core.

MySQL zero-date semantics: functions needing a real calendar day
(DayOfWeek/DayOfYear/ToDays/LastDay/...) return NULL for zero
year/month/day parts; pure field extraction (Year/Month/Hour/...)
returns the field as stored.
"""

from __future__ import annotations

import numpy as np

from ..datatype import EvalType
from ..datatype.time import (
    civil_from_days,
    days_from_civil,
    days_in_month,
    dt_day,
    dt_hour,
    dt_micro,
    dt_minute,
    dt_month,
    dt_second,
    dt_year,
    iso_week,
    pack_datetime,
    to_days,
)
from .functions import rpn_fn

I, B = EvalType.INT, EvalType.BYTES
T, D = EvalType.DATETIME, EvalType.DURATION

_NANOS_PER_SEC = 1_000_000_000

_MONTH_NAMES = np.array(
    [b"", b"January", b"February", b"March", b"April", b"May", b"June",
     b"July", b"August", b"September", b"October", b"November",
     b"December"], dtype=object)
_DAY_NAMES = np.array(
    [b"Monday", b"Tuesday", b"Wednesday", b"Thursday", b"Friday",
     b"Saturday", b"Sunday"], dtype=object)


def _u64(v):
    return np.asarray(v, dtype=np.uint64)


def _has_date(t) -> np.ndarray:
    """Rows with a usable calendar day (no zero year/month/day)."""
    t = _u64(t)
    return (dt_year(t) > 0) & (dt_month(t) > 0) & (dt_day(t) > 0)


def register() -> None:
    # ---- field extraction (DATETIME) ----

    def extract(name, fn):
        @rpn_fn(name, 1, I, (T,))
        def _f(xp, a, _fn=fn):
            (av, am) = a
            return _fn(_u64(av)), np.asarray(am, bool)
        return _f

    extract("Year", lambda t: dt_year(t))
    extract("Month", lambda t: dt_month(t))
    extract("DayOfMonth", lambda t: dt_day(t))
    extract("MicroSecond", lambda t: dt_micro(t))

    # Hour/Minute/Second take DURATION in the reference (impl_time.rs);
    # MySQL HOUR() on times can exceed 23
    @rpn_fn("Hour", 1, I, (D,))
    def hour_dur(xp, a):
        (av, am) = a
        return np.abs(np.asarray(av, np.int64)) // (3600 * _NANOS_PER_SEC), \
            np.asarray(am, bool)

    @rpn_fn("Minute", 1, I, (D,))
    def minute_dur(xp, a):
        (av, am) = a
        return (np.abs(np.asarray(av, np.int64)) //
                (60 * _NANOS_PER_SEC)) % 60, np.asarray(am, bool)

    @rpn_fn("Second", 1, I, (D,))
    def second_dur(xp, a):
        (av, am) = a
        return (np.abs(np.asarray(av, np.int64)) // _NANOS_PER_SEC) % 60, \
            np.asarray(am, bool)

    @rpn_fn("MicroSecondDuration", 1, I, (D,))
    def micro_dur(xp, a):
        # reference sig name is MicroSecond over Duration; registered
        # separately because this rebuild types sigs by argument
        (av, am) = a
        return (np.abs(np.asarray(av, np.int64)) // 1000) % 1_000_000, \
            np.asarray(am, bool)

    @rpn_fn("TimeToSec", 1, I, (D,))
    def time_to_sec(xp, a):
        (av, am) = a
        v = np.asarray(av, np.int64)
        return np.sign(v) * (np.abs(v) // _NANOS_PER_SEC), \
            np.asarray(am, bool)

    @rpn_fn("Quarter", 1, I, (T,))
    def quarter(xp, a):
        (av, am) = a
        return (dt_month(_u64(av)) + 2) // 3, np.asarray(am, bool)

    # ---- calendar-day functions (NULL on zero dates) ----

    def daymath(name, fn):
        @rpn_fn(name, 1, I, (T,))
        def _f(xp, a, _fn=fn):
            (av, am) = a
            t = _u64(av)
            ok = np.asarray(am, bool) & _has_date(t)
            safe = np.where(ok, t, pack_datetime(1970, 1, 1))
            return _fn(safe), ok
        return _f

    daymath("DayOfWeek",
            lambda t: (to_days(t) + 6) % 7 + 1)        # 1 = Sunday
    daymath("WeekDay",
            lambda t: (to_days(t) + 5) % 7)            # 0 = Monday
    daymath("DayOfYear",
            lambda t: days_from_civil(dt_year(t), dt_month(t), dt_day(t))
            - days_from_civil(dt_year(t), 1, 1) + 1)
    daymath("ToDays", to_days)
    daymath("WeekOfYear",
            lambda t: iso_week(dt_year(t), dt_month(t), dt_day(t)))

    @rpn_fn("ToSeconds", 1, I, (T,))
    def to_seconds(xp, a):
        (av, am) = a
        t = _u64(av)
        ok = np.asarray(am, bool) & _has_date(t)
        safe = np.where(ok, t, pack_datetime(1970, 1, 1))
        return (to_days(safe) * 86400 + dt_hour(safe) * 3600
                + dt_minute(safe) * 60 + dt_second(safe)), ok

    @rpn_fn("LastDay", 1, T, (T,))
    def last_day(xp, a):
        (av, am) = a
        t = _u64(av)
        y, m = dt_year(t), dt_month(t)
        ok = np.asarray(am, bool) & (y > 0) & (m > 0)
        ys = np.where(ok, y, 1970)
        ms = np.where(ok, m, 1)
        return pack_datetime(ys, ms, days_in_month(ys, ms)), ok

    @rpn_fn("Date", 1, T, (T,))
    def date_(xp, a):
        (av, am) = a
        t = _u64(av)
        return pack_datetime(dt_year(t), dt_month(t), dt_day(t)), \
            np.asarray(am, bool)

    @rpn_fn("FromDays", 1, T, (I,))
    def from_days(xp, a):
        from ..datatype.time import _TO_DAYS_EPOCH
        (av, am) = a
        days = np.asarray(av, np.int64) - _TO_DAYS_EPOCH
        y, m, d = civil_from_days(days)
        ok = np.asarray(am, bool) & (y >= 0) & (y <= 9999)
        ys = np.where(ok, y, 1970)
        return pack_datetime(ys, np.where(ok, m, 1), np.where(ok, d, 1)), ok

    @rpn_fn("MakeDate", 2, T, (I, I))
    def make_date(xp, y, d):
        # MAKEDATE(year, dayofyear); dayofyear < 1 -> NULL
        (yv, ym), (dv, dm) = y, d
        yy = np.asarray(yv, np.int64)
        # MySQL 2-digit year rule
        yy = np.where(yy < 70, yy + 2000, np.where(yy < 100, yy + 1900, yy))
        doy = np.asarray(dv, np.int64)
        ok = np.asarray(ym, bool) & np.asarray(dm, bool) & (doy >= 1)
        base = days_from_civil(np.where(ok, yy, 1970), 1, 1) + \
            np.where(ok, doy, 1) - 1
        ry, rm, rd = civil_from_days(base)
        ok = ok & (ry <= 9999)
        return pack_datetime(np.where(ok, ry, 1970), np.where(ok, rm, 1),
                             np.where(ok, rd, 1)), ok

    @rpn_fn("DateDiff", 2, I, (T, T))
    def date_diff(xp, a, b):
        (av, am), (bv, bm) = a, b
        ta, tb = _u64(av), _u64(bv)
        ok = np.asarray(am, bool) & np.asarray(bm, bool) & \
            _has_date(ta) & _has_date(tb)
        sa = np.where(ok, ta, pack_datetime(1970, 1, 1))
        sb = np.where(ok, tb, pack_datetime(1970, 1, 1))
        return to_days(sa) - to_days(sb), ok

    # ---- period arithmetic (YYYYMM ints; impl_time.rs period_add) ----

    def _period_to_months(p):
        p = np.asarray(p, np.int64)
        y = p // 100
        y = np.where(y < 70, y + 2000, np.where(y < 100, y + 1900, y))
        return y * 12 + p % 100 - 1

    def _months_to_period(m):
        y = m // 12
        return y * 100 + m % 12 + 1

    @rpn_fn("PeriodAdd", 2, I, (I, I))
    def period_add(xp, p, n):
        (pv, pm), (nv, nm) = p, n
        months = _period_to_months(pv) + np.asarray(nv, np.int64)
        return _months_to_period(months), \
            np.asarray(pm, bool) & np.asarray(nm, bool)

    @rpn_fn("PeriodDiff", 2, I, (I, I))
    def period_diff(xp, p1, p2):
        (av, am), (bv, bm) = p1, p2
        return _period_to_months(av) - _period_to_months(bv), \
            np.asarray(am, bool) & np.asarray(bm, bool)

    # ---- names / formatting (host object arrays) ----

    @rpn_fn("MonthName", 1, B, (T,))
    def month_name(xp, a):
        (av, am) = a
        m = dt_month(_u64(av))
        ok = np.asarray(am, bool) & (m > 0) & (m <= 12)
        return _MONTH_NAMES[np.where(ok, m, 0)], ok

    @rpn_fn("DayName", 1, B, (T,))
    def day_name(xp, a):
        (av, am) = a
        t = _u64(av)
        ok = np.asarray(am, bool) & _has_date(t)
        safe = np.where(ok, t, pack_datetime(1970, 1, 1))
        wd = (to_days(safe) + 5) % 7
        return _DAY_NAMES[wd], ok

    @rpn_fn("DateFormatSig", 2, B, (T, B))
    def date_format(xp, a, f):
        (av, am), (fv, fm) = a, f
        t = _u64(av)
        y, mo, d = dt_year(t), dt_month(t), dt_day(t)
        h, mi, s, us = dt_hour(t), dt_minute(t), dt_second(t), dt_micro(t)
        hasd = _has_date(t)
        safe = np.where(hasd, t, pack_datetime(1970, 1, 1))
        td = to_days(safe)

        def fmt_one(i, spec: bytes) -> bytes:
            out = bytearray()
            j = 0
            while j < len(spec):
                c = spec[j:j + 1]
                if c != b"%" or j + 1 >= len(spec):
                    out += c
                    j += 1
                    continue
                k = spec[j + 1:j + 2]
                j += 2
                if k == b"Y":
                    out += b"%04d" % y[i]
                elif k == b"y":
                    out += b"%02d" % (y[i] % 100)
                elif k == b"m":
                    out += b"%02d" % mo[i]
                elif k == b"c":
                    out += b"%d" % mo[i]
                elif k == b"M":
                    out += _MONTH_NAMES[mo[i]] if mo[i] else b""
                elif k == b"b":
                    out += _MONTH_NAMES[mo[i]][:3] if mo[i] else b""
                elif k == b"d":
                    out += b"%02d" % d[i]
                elif k == b"e":
                    out += b"%d" % d[i]
                elif k == b"H":
                    out += b"%02d" % h[i]
                elif k == b"k":
                    out += b"%d" % h[i]
                elif k == b"h" or k == b"I":
                    out += b"%02d" % (((h[i] + 11) % 12) + 1)
                elif k == b"l":
                    out += b"%d" % (((h[i] + 11) % 12) + 1)
                elif k == b"i":
                    out += b"%02d" % mi[i]
                elif k == b"s" or k == b"S":
                    out += b"%02d" % s[i]
                elif k == b"f":
                    out += b"%06d" % us[i]
                elif k == b"p":
                    out += b"AM" if h[i] < 12 else b"PM"
                elif k == b"T":
                    out += b"%02d:%02d:%02d" % (h[i], mi[i], s[i])
                elif k == b"r":
                    out += b"%02d:%02d:%02d %s" % (
                        ((h[i] + 11) % 12) + 1, mi[i], s[i],
                        b"AM" if h[i] < 12 else b"PM")
                elif k == b"W":
                    out += _DAY_NAMES[(td[i] + 5) % 7] if hasd[i] else b""
                elif k == b"a":
                    out += _DAY_NAMES[(td[i] + 5) % 7][:3] if hasd[i] \
                        else b""
                elif k == b"j":
                    doy = td[i] - (days_from_civil(y[i], 1, 1)
                                   + 719528) + 1
                    out += b"%03d" % doy
                elif k == b"w":
                    out += b"%d" % ((td[i] + 6) % 7) if hasd[i] else b""
                elif k == b"%":
                    out += b"%"
                else:
                    out += k
            return bytes(out)

        fv_arr = np.asarray(fv, dtype=object)
        n = max(np.shape(av)[0] if np.ndim(av) else 1,
                fv_arr.shape[0] if fv_arr.ndim else 1)
        y, mo, d = (np.broadcast_to(x, (n,)) for x in (y, mo, d))
        h, mi, s, us = (np.broadcast_to(x, (n,)) for x in (h, mi, s, us))
        td = np.broadcast_to(td, (n,))
        hasd = np.broadcast_to(hasd, (n,))
        specs = np.broadcast_to(fv_arr, (n,))
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = fmt_one(i, specs[i])
        ok = np.broadcast_to(np.asarray(am, bool) & np.asarray(fm, bool),
                             (n,)).copy()
        # calendar-day specifiers need a real date: MySQL's date_format
        # errors (→ NULL) on zero dates for %j/%W/%a/%w (impl_time.rs
        # date_format); mask those rows instead of emitting garbage

        def has_day_spec(spec: bytes) -> bool:
            # walk %-pairs exactly as fmt_one does so '%%w' (a literal
            # '%' then 'w') is not mistaken for the %w specifier
            j = 0
            while j < len(spec):
                if spec[j:j + 1] == b"%" and j + 1 < len(spec):
                    if spec[j + 1:j + 2] in (b"j", b"W", b"a", b"w"):
                        return True
                    j += 2
                else:
                    j += 1
            return False

        # formats are near-always a single constant: memoize per spec
        memo: dict[bytes, bool] = {}
        day_based = np.fromiter(
            (memo[sp] if sp in memo else
             memo.setdefault(sp, has_day_spec(sp)) for sp in specs),
            dtype=bool, count=n)
        ok &= hasd | ~day_based
        return out, ok
