"""Datetime functions as pure integer arithmetic on the device.

Port of ``datafusion_tpu/functions/datetime_fns.py`` (reference:
datetime_expressions.rs plus the fork's ConvertTz/DateAdd/DateSub/DateBin,
cube_ext/datetime.rs).  Calendar decomposition uses the days-from-civil /
civil-from-days integer algorithms (Hinnant), vectorized over int32
tensors.  Divisions round toward minus infinity and remainders take the
divisor's sign, as ``//`` and ``%`` do in the reference.
"""

from __future__ import annotations

import torch


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


# ---------------------------------------------------------------------------
# civil calendar <-> days since 1970-01-01  (vectorized Hinnant algorithms)
# ---------------------------------------------------------------------------


def civil_from_days(days: torch.Tensor):
    """days since epoch -> (year, month, day), int32."""
    z = days.to(torch.int32) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097  # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)  # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)  # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1  # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)  # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> days since epoch."""
    y = torch.where(m <= 2, y - 1, y)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400  # [0, 399]
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def last_day_of_month(y, m):
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    # 31 days in odd months up to July and in even ones from August, 30 in
    # the others, February aside (arithmetic: no table to copy from the host)
    mc = torch.clamp(m, 1, 12)
    base = torch.where(mc == 2, 28, 30 + (mc + (mc >= 8).to(mc.dtype)) % 2)
    return torch.where((m == 2) & leap, 29, base)


def add_months_days(days: torch.Tensor, months: torch.Tensor) -> torch.Tensor:
    """date + INTERVAL months, clamping day-of-month (SQL semantics:
    2000-01-31 + 1 month = 2000-02-29)."""
    y, m, d = civil_from_days(days)
    tot = (y * 12 + (m - 1)) + months
    ny = _fdiv(tot, 12)
    nm = tot % 12 + 1
    nd = torch.minimum(d, last_day_of_month(ny, nm))
    return days_from_civil(ny, nm, nd)


# ---------------------------------------------------------------------------
# field extraction (EXTRACT / date_part)
# ---------------------------------------------------------------------------

US_PER_DAY = 86_400_000_000


def timestamp_to_days_us(ts_us: torch.Tensor):
    days = _fdiv(ts_us, US_PER_DAY)
    us = ts_us - days * US_PER_DAY
    return days.to(torch.int32), us


def extract_field(field: str, days: torch.Tensor, us_in_day: torch.Tensor | None = None):
    """Extract a date/time part.  ``days`` is days-since-epoch; ``us_in_day``
    the intra-day microseconds (None for DATE columns)."""
    field = field.lower()
    if us_in_day is None:
        us_in_day = torch.zeros_like(days, dtype=torch.int64)
    y, m, d = civil_from_days(days)
    if field in ("year", "years", "y"):
        return y
    if field in ("quarter",):
        return _fdiv(m - 1, 3) + 1
    if field in ("month", "months", "mon"):
        return m
    if field in ("day", "days", "d", "dayofmonth"):
        return d
    if field in ("week", "weeks", "w"):
        doy = days - days_from_civil(y, torch.ones_like(m), torch.ones_like(d)) + 1
        return _fdiv(doy - 1, 7) + 1
    if field in ("doy", "dayofyear"):
        return days - days_from_civil(y, torch.ones_like(m), torch.ones_like(d)) + 1
    if field in ("dow", "dayofweek"):
        return (days + 4) % 7  # 1970-01-01 was a Thursday; 0 = Sunday
    if field in ("hour", "hours", "h"):
        return _fdiv(us_in_day, 3_600_000_000).to(torch.int32)
    if field in ("minute", "minutes", "min"):
        return (_fdiv(us_in_day, 60_000_000) % 60).to(torch.int32)
    if field in ("second", "seconds", "sec", "s"):
        return (_fdiv(us_in_day, 1_000_000) % 60).to(torch.int32)
    if field in ("millisecond", "milliseconds"):
        return (_fdiv(us_in_day, 1000) % 60_000).to(torch.int64)
    if field in ("microsecond", "microseconds"):
        return (us_in_day % 60_000_000).to(torch.int64)
    if field in ("epoch",):
        return days.to(torch.float64) * 86400.0 + us_in_day.to(torch.float64) / 1e6
    raise ValueError(f"unsupported extract field {field!r}")


def date_trunc_days(granularity: str, days: torch.Tensor) -> torch.Tensor:
    g = granularity.lower()
    y, m, d = civil_from_days(days)
    one = torch.ones_like(m)
    if g in ("year",):
        return days_from_civil(y, one, one)
    if g in ("quarter",):
        qm = _fdiv(m - 1, 3) * 3 + 1
        return days_from_civil(y, qm, one)
    if g in ("month",):
        return days_from_civil(y, m, one)
    if g in ("week",):
        dow = (days + 3) % 7  # Monday-based
        return days - dow
    if g in ("day", "hour", "minute", "second"):
        return days
    raise ValueError(f"unsupported date_trunc granularity {g!r}")


def date_trunc_us(granularity: str, ts_us: torch.Tensor) -> torch.Tensor:
    g = granularity.lower()
    days, us = timestamp_to_days_us(ts_us)
    if g in ("year", "quarter", "month", "week", "day"):
        d2 = date_trunc_days(g, days)
        return d2.to(torch.int64) * US_PER_DAY
    unit = {
        "hour": 3_600_000_000,
        "minute": 60_000_000,
        "second": 1_000_000,
        "millisecond": 1000,
        "microsecond": 1,
    }[g]
    return days.to(torch.int64) * US_PER_DAY + _fdiv(us, unit) * unit
