"""Calendar arithmetic over int64 epoch-nanosecond tensors.

Counterpart of `dask_sql_tpu/ops/datetime.py`: the same branch-free integer
algorithms (Howard Hinnant's civil-from-days and its inverse), on torch
tensors.  Every division floors, as ``jnp.floor_divide`` does, so dates
before 1970 land on the right day: `_floordiv` is ``torch.div(...,
rounding_mode="floor")``, never ``//`` on a signed tensor of mixed signs.
DATE and TIMESTAMP values are int64 nanoseconds since the epoch (DATE at
midnight).
"""
from __future__ import annotations

import torch

NS_PER_SECOND = 1_000_000_000
NS_PER_MINUTE = 60 * NS_PER_SECOND
NS_PER_HOUR = 3600 * NS_PER_SECOND
NS_PER_DAY = 86_400 * NS_PER_SECOND

_STEP_NS = {"WEEK": 7 * NS_PER_DAY, "DAY": NS_PER_DAY, "HOUR": NS_PER_HOUR,
            "MINUTE": NS_PER_MINUTE, "SECOND": NS_PER_SECOND,
            "MILLISECOND": 1_000_000, "MICROSECOND": 1000, "NANOSECOND": 1}


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _mod(a, b):
    """Floored remainder (the sign of the divisor), as ``jnp`` ``%``."""
    return torch.remainder(a, b)


def _i64(x):
    return x.to(torch.int64) if torch.is_tensor(x) else torch.tensor(
        x, dtype=torch.int64)


def days_from_ns(ns):
    return _floordiv(ns, NS_PER_DAY)


def civil_from_days(days):
    """(year, month, day) from days since 1970-01-01 (proleptic Gregorian)."""
    z = days + 719468
    era = _floordiv(z, 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(y.dtype)
    return y, m, d


def days_from_civil(y, m, d):
    """Inverse of civil_from_days."""
    y, m, d = _i64(y), _i64(m), _i64(d)
    y = y - (m <= 2).to(y.dtype)
    era = _floordiv(y, 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = _floordiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def extract(unit: str, ns):
    ns = ns.to(torch.int64)
    days = days_from_ns(ns)
    tod = ns - days * NS_PER_DAY  # time of day in ns, always >= 0
    if unit == "epoch":
        return _floordiv(ns, NS_PER_SECOND)
    if unit == "hour":
        return _floordiv(tod, NS_PER_HOUR)
    if unit == "minute":
        return _mod(_floordiv(tod, NS_PER_MINUTE), 60)
    if unit == "second":
        return _mod(_floordiv(tod, NS_PER_SECOND), 60)
    if unit == "millisecond":
        return _mod(_floordiv(tod, 1_000_000), 1000)
    if unit == "microsecond":
        return _mod(_floordiv(tod, 1000), 1_000_000)
    if unit == "nanosecond":
        return _mod(tod, NS_PER_SECOND)
    if unit == "isoyear":
        # the year of the ISO week's Thursday (the reference answers the
        # calendar year, which differs in the first and last days of some
        # years)
        return civil_from_days(days - _iso_dow(days) + 4)[0]
    y, m, d = civil_from_days(days)
    if unit == "year":
        return y
    if unit == "month":
        return m
    if unit == "day":
        return d
    if unit == "quarter":
        return _floordiv(m - 1, 3) + 1
    if unit == "week":
        # ISO week number
        doy = days - days_from_civil(y, torch.ones_like(m),
                                     torch.ones_like(d)) + 1
        dow_iso = _iso_dow(days)
        raw = _floordiv(doy - dow_iso + 10, 7)
        # weeks 0 / 53 belong to the neighbouring ISO year
        prev_weeks = 52 + _is_long_year(y - 1).to(raw.dtype)
        this_weeks = 52 + _is_long_year(y).to(raw.dtype)
        return torch.where(raw < 1, prev_weeks,
                           torch.where(raw > this_weeks, 1, raw))
    if unit == "dow":
        # Calcite's convention, as the reference: 1 = Sunday ... 7 = Saturday
        return _mod(days + 4, 7) + 1
    if unit == "isodow":
        return _iso_dow(days)
    if unit == "doy":
        jan1 = days_from_civil(y, torch.ones_like(m), torch.ones_like(d))
        return days - jan1 + 1
    if unit == "century":
        return _floordiv(y - 1, 100) + 1
    if unit == "decade":
        return _floordiv(y, 10)
    if unit == "millennium":
        return _floordiv(y - 1, 1000) + 1
    raise NotImplementedError(f"EXTRACT unit {unit}")


def _iso_dow(days):
    return _mod(days + 3, 7) + 1  # 1 = Monday ... 7 = Sunday


def _is_long_year(y):
    one = torch.ones_like(y)
    jan1 = days_from_civil(y, one, one)
    dec31 = days_from_civil(y, one * 12, one * 31)
    return (_iso_dow(jan1) == 4) | (_iso_dow(dec31) == 4)


def truncate(unit: str, ns):
    """FLOOR(ts TO unit)."""
    unit = unit.upper()
    ns = ns.to(torch.int64)
    fixed = {"SECOND": NS_PER_SECOND, "MINUTE": NS_PER_MINUTE,
             "HOUR": NS_PER_HOUR, "DAY": NS_PER_DAY,
             "MILLISECOND": 1_000_000, "MICROSECOND": 1000}
    if unit in fixed:
        return _floordiv(ns, fixed[unit]) * fixed[unit]
    days = days_from_ns(ns)
    y, m, d = civil_from_days(days)
    one = torch.ones_like(d)
    if unit == "WEEK":
        start = days - (_iso_dow(days) - 1)
        return start * NS_PER_DAY
    if unit == "MONTH":
        return days_from_civil(y, m, one) * NS_PER_DAY
    if unit == "QUARTER":
        qm = _floordiv(m - 1, 3) * 3 + 1
        return days_from_civil(y, qm, one) * NS_PER_DAY
    if unit == "YEAR":
        return days_from_civil(y, torch.ones_like(m), one) * NS_PER_DAY
    raise NotImplementedError(f"truncate unit {unit}")


def ceil_to(unit: str, ns):
    """CEIL(ts TO unit)."""
    ns = ns.to(torch.int64)
    fl = truncate(unit, ns)
    unit_u = unit.upper()
    if unit_u in ("SECOND", "MINUTE", "HOUR", "DAY", "WEEK", "MILLISECOND",
                  "MICROSECOND"):
        return torch.where(fl == ns, ns, fl + _STEP_NS[unit_u])
    # month-based units: advance to the next boundary
    nxt = add_months(fl, {"MONTH": 1, "QUARTER": 3, "YEAR": 12}[unit_u])
    return torch.where(fl == ns, ns, nxt)


def add_months(ns, months):
    ns = ns.to(torch.int64)
    days = days_from_ns(ns)
    rem = ns - days * NS_PER_DAY
    y, m, d = civil_from_days(days)
    tot = y * 12 + (m - 1) + _i64(months).to(ns.device)
    ny = _floordiv(tot, 12)
    nm = tot - ny * 12 + 1
    # clamp the day to the target month's length
    nd = torch.minimum(d, month_length(ny, nm))
    return days_from_civil(ny, nm, nd) * NS_PER_DAY + rem


def month_length(y, m):
    lengths = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                           dtype=torch.int64, device=m.device)
    base = lengths[torch.clamp(m - 1, 0, 11).to(torch.int64)]
    leap = ((_mod(y, 4) == 0) & (_mod(y, 100) != 0)) | (_mod(y, 400) == 0)
    return torch.where((m == 2) & leap, 29, base)


def last_day(ns):
    days = days_from_ns(ns.to(torch.int64))
    y, m, _ = civil_from_days(days)
    return days_from_civil(y, m, month_length(y, m)) * NS_PER_DAY


def timestampadd(unit: str, n, ns):
    unit = unit.upper().rstrip("S")
    if unit in ("YEAR", "QUARTER", "MONTH"):
        mult = {"YEAR": 12, "QUARTER": 3, "MONTH": 1}[unit]
        return add_months(ns, n * mult)
    return ns.to(torch.int64) + _i64(n) * _STEP_NS[unit]


def timestampdiff(unit: str, a, b):
    """Full units from a to b (SQL TIMESTAMPDIFF argument order)."""
    unit = unit.upper().rstrip("S")
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    if unit in ("YEAR", "QUARTER", "MONTH"):
        ya, ma, da = civil_from_days(days_from_ns(a))
        yb, mb, db = civil_from_days(days_from_ns(b))
        months = (yb * 12 + mb) - (ya * 12 + ma)
        # a partial month does not count
        toda = a - days_from_ns(a) * NS_PER_DAY
        todb = b - days_from_ns(b) * NS_PER_DAY
        adjust = ((db < da) | ((db == da) & (todb < toda))) & (months > 0)
        adjust_neg = ((db > da) | ((db == da) & (todb > toda))) & (months < 0)
        months = months - adjust.to(torch.int64) + adjust_neg.to(torch.int64)
        if unit == "MONTH":
            return months
        if unit == "QUARTER":
            return _div_trunc(months, 3)
        return _div_trunc(months, 12)
    return _div_trunc(b - a, _STEP_NS[unit])


def _div_trunc(a, b):
    """Integer division truncating toward zero (SQL semantics)."""
    q = _floordiv(torch.abs(a), b)
    return torch.where(a < 0, -q, q)
