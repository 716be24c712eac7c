"""Packed core-time representation + vectorized civil-calendar math.

The JAX package's ``datatype/time.py``, copied.  Reference:
tidb_query_datatype/src/codec/mysql/time/mod.rs — TiDB packs a datetime
into one u64 (``CoreTime``) so the columnar engine moves fixed width
values; this rebuild keeps that idea with an explicit bit layout (not the
reference's) chosen so every field unpacks with one shift+mask:

    bits  0..23   microsecond   (24 bits)
    bits 24..29   second        ( 6 bits)
    bits 30..35   minute        ( 6 bits)
    bits 36..40   hour          ( 5 bits)
    bits 41..45   day           ( 5 bits)
    bits 46..49   month         ( 4 bits)
    bits 50..63   year          (14 bits)

All functions are vectorized over numpy uint64 arrays; the device never
unpacks a core (it compares and orders cores as int64 bits, which keep
their order for every year below 8192).  Calendar conversions use the
days-from-civil algorithm (Howard Hinnant's public-domain
``civil_from_days``/``days_from_civil``), which is branch-free and exact
over MySQL's DATETIME range (year 0..9999).
"""

from __future__ import annotations

import numpy as np

MICRO_BITS = 24
SECOND_SHIFT = 24
MINUTE_SHIFT = 30
HOUR_SHIFT = 36
DAY_SHIFT = 41
MONTH_SHIFT = 46
YEAR_SHIFT = 50

# MySQL TO_DAYS('1970-01-01') == 719528; days_from_civil(1970,1,1) == 0
_TO_DAYS_EPOCH = 719528


def pack_datetime(year, month, day, hour=0, minute=0, second=0, micro=0):
    """Pack component arrays/scalars into the u64 core."""
    y = np.asarray(year, np.uint64)
    return ((y << YEAR_SHIFT)
            | (np.asarray(month, np.uint64) << MONTH_SHIFT)
            | (np.asarray(day, np.uint64) << DAY_SHIFT)
            | (np.asarray(hour, np.uint64) << HOUR_SHIFT)
            | (np.asarray(minute, np.uint64) << MINUTE_SHIFT)
            | (np.asarray(second, np.uint64) << SECOND_SHIFT)
            | np.asarray(micro, np.uint64))


def dt_year(t, xp=np):
    return (t >> YEAR_SHIFT).astype(xp.int64 if xp is np else xp.int32)


def dt_month(t, xp=np):
    return ((t >> MONTH_SHIFT) & 0xF).astype(
        xp.int64 if xp is np else xp.int32)


def dt_day(t, xp=np):
    return ((t >> DAY_SHIFT) & 0x1F).astype(
        xp.int64 if xp is np else xp.int32)


def dt_hour(t, xp=np):
    return ((t >> HOUR_SHIFT) & 0x1F).astype(
        xp.int64 if xp is np else xp.int32)


def dt_minute(t, xp=np):
    return ((t >> MINUTE_SHIFT) & 0x3F).astype(
        xp.int64 if xp is np else xp.int32)


def dt_second(t, xp=np):
    return ((t >> SECOND_SHIFT) & 0x3F).astype(
        xp.int64 if xp is np else xp.int32)


def dt_micro(t, xp=np):
    return (t & np.uint64((1 << MICRO_BITS) - 1)).astype(
        xp.int64 if xp is np else xp.int32)


def days_from_civil(y, m, d):
    """Days since 1970-01-01 for proleptic-Gregorian (y, m, d) arrays."""
    y = np.asarray(y, np.int64)
    m = np.asarray(m, np.int64)
    d = np.asarray(d, np.int64)
    y = y - (m <= 2)
    era = np.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400                              # [0, 399]
    doy = (153 * (m + np.where(m > 2, -3, 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy    # [0, 146096]
    return era * 146097 + doe - 719468


def civil_from_days(z):
    """Inverse of days_from_civil: → (y, m, d) arrays."""
    z = np.asarray(z, np.int64) + 719468
    era = np.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097                            # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)   # [0, 365]
    mp = (5 * doy + 2) // 153                         # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                 # [1, 31]
    m = mp + np.where(mp < 10, 3, -9)                 # [1, 12]
    return y + (m <= 2), m, d


def to_days(t):
    """MySQL TO_DAYS over packed cores (numpy)."""
    return days_from_civil(dt_year(t), dt_month(t), dt_day(t)) \
        + _TO_DAYS_EPOCH


def is_leap(y):
    y = np.asarray(y, np.int64)
    return (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))


_DAYS_IN_MONTH = np.array([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30,
                           31], np.int64)


def days_in_month(y, m):
    m = np.asarray(m, np.int64)
    base = _DAYS_IN_MONTH[np.clip(m, 0, 12)]
    return base + (is_leap(y) & (m == 2))


def iso_week(y, m, d):
    """ISO-8601 week number (MySQL WEEKOFYEAR == WEEK(d, 3))."""
    dfc = days_from_civil(y, m, d)
    # ISO: week containing the year's first Thursday is week 1.
    # weekday: Mon=0 (1970-01-01 was a Thursday, dfc==0 -> 3)
    wd = (dfc + 3) % 7
    thursday = dfc - wd + 3
    iso_y, _, _ = civil_from_days(thursday)
    jan1 = days_from_civil(iso_y, 1, 1)
    return ((thursday - jan1) // 7 + 1).astype(np.int64)
