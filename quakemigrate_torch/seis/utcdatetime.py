# -*- coding: utf-8 -*-
"""
Nanosecond-precision UTC timestamp type for quakemigrate_torch, a copy of
the JAX package's ``seis/utcdatetime.py`` (window bounds computed here must
equal the reference's to the nanosecond: one nanosecond moves a window by
a sample).

The scan pipeline does a large amount of time arithmetic (window maths, event
IDs, file naming); this class provides an integer-nanosecond implementation
with the arithmetic/str semantics the pipeline relies on (timestamps render
with microsecond precision, subtraction of two timestamps yields float
seconds, adding a float shifts by seconds).

"""

from __future__ import annotations

import re
from datetime import datetime, timedelta, timezone, date as _date, time as _time

_NS = 1_000_000_000
_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)

# ISO 8601-ish: date part, optional time part with arbitrary fractional digits
_ISO_RE = re.compile(
    r"^(?P<year>\d{4})[-/]?(?P<month>\d{2})[-/]?(?P<day>\d{2})"
    r"(?:[T ]?(?P<hour>\d{2}):?(?P<minute>\d{2}):?(?P<second>\d{2})"
    r"(?:[.,](?P<frac>\d+))?)?"
    r"(?:Z|\+00:?00)?$"
)
# Year + julian day form: "2014-180" or "2014180T..." (jday always 3 digits)
_JDAY_RE = re.compile(
    r"^(?P<year>\d{4})[-/]?(?P<jday>\d{3})"
    r"(?:[T ](?P<hour>\d{2}):?(?P<minute>\d{2}):?(?P<second>\d{2})"
    r"(?:[.,](?P<frac>\d+))?)?"
    r"(?:Z|\+00:?00)?$"
)


def _frac_to_ns(frac):
    if not frac:
        return 0
    frac = (frac + "000000000")[:9]
    return int(frac)


class UTCDateTime:
    """UTC timestamp backed by an integer count of nanoseconds since epoch."""

    __slots__ = ("_ns",)

    def __init__(self, *args, **kwargs):
        if kwargs.get("ns") is not None:
            self._ns = int(kwargs["ns"])
            return

        if len(args) == 0 and not kwargs:
            self._ns = int(datetime.now(timezone.utc).timestamp() * _NS)
            return

        if len(args) == 1 and not kwargs:
            value = args[0]
            if isinstance(value, UTCDateTime):
                self._ns = value._ns
                return
            if isinstance(value, str):
                self._ns = self._parse_str(value)
                return
            if isinstance(value, datetime):
                if value.tzinfo is None:
                    value = value.replace(tzinfo=timezone.utc)
                else:
                    # Normalise non-UTC offsets before reading components
                    value = value.astimezone(timezone.utc)
                # Compute exactly from date components to avoid float error
                days = (value.date() - _EPOCH.date()).days
                secs = value.hour * 3600 + value.minute * 60 + value.second
                self._ns = (
                    (days * 86400 + secs) * _NS + value.microsecond * 1000
                )
                return
            if isinstance(value, _date):
                days = (value - _EPOCH.date()).days
                self._ns = days * 86400 * _NS
                return
            if isinstance(value, (int, float)):
                self._ns = int(round(float(value) * _NS))
                return
            raise TypeError(f"Cannot construct UTCDateTime from {type(value)}")

        # Component-based construction: positional (year, month, day, ...) or kwargs
        names = ["year", "month", "day", "hour", "minute", "second", "microsecond"]
        comps = dict(zip(names, args))
        comps.update({k: v for k, v in kwargs.items() if k in names})
        julday = kwargs.get("julday")
        year = comps.get("year")
        if year is None:
            raise TypeError("Invalid arguments for UTCDateTime")
        if julday is not None:
            base = datetime(int(year), 1, 1, tzinfo=timezone.utc) + timedelta(
                days=int(julday) - 1
            )
            comps["month"], comps["day"] = base.month, base.day
        dt = datetime(
            int(year),
            int(comps.get("month", 1)),
            int(comps.get("day", 1)),
            int(comps.get("hour", 0)),
            int(comps.get("minute", 0)),
            int(comps.get("second", 0)),
            int(comps.get("microsecond", 0)),
            tzinfo=timezone.utc,
        )
        days = (dt.date() - _EPOCH.date()).days
        secs = dt.hour * 3600 + dt.minute * 60 + dt.second
        self._ns = (days * 86400 + secs) * _NS + dt.microsecond * 1000

    @staticmethod
    def _parse_str(value):
        value = value.strip()
        m = _ISO_RE.match(value)
        if m:
            d = m.groupdict()
            dt = datetime(
                int(d["year"]),
                int(d["month"]),
                int(d["day"]),
                int(d["hour"] or 0),
                int(d["minute"] or 0),
                int(d["second"] or 0),
                tzinfo=timezone.utc,
            )
        else:
            m = _JDAY_RE.match(value)
            if not m:
                raise ValueError(f"Cannot parse datetime string: {value!r}")
            d = m.groupdict()
            dt = datetime(
                int(d["year"]), 1, 1, tzinfo=timezone.utc
            ) + timedelta(days=int(d["jday"]) - 1)
            dt = dt.replace(
                hour=int(d["hour"] or 0),
                minute=int(d["minute"] or 0),
                second=int(d["second"] or 0),
            )
        days = (dt.date() - _EPOCH.date()).days
        secs = dt.hour * 3600 + dt.minute * 60 + dt.second
        return (days * 86400 + secs) * _NS + _frac_to_ns(d.get("frac"))

    # --- accessors ---

    @property
    def ns(self):
        return self._ns

    @property
    def timestamp(self):
        return self._ns / _NS

    @property
    def datetime(self):
        micro, rem = divmod(self._ns, 1000)
        dt = _EPOCH + timedelta(microseconds=micro)
        return dt.replace(tzinfo=None)

    @property
    def date(self):
        return (_EPOCH + timedelta(seconds=self._ns // _NS)).date()

    @property
    def time(self):
        dt = self.datetime
        return _time(dt.hour, dt.minute, dt.second, dt.microsecond)

    @property
    def year(self):
        return self.datetime.year

    @property
    def month(self):
        return self.datetime.month

    @property
    def day(self):
        return self.datetime.day

    @property
    def julday(self):
        dt = self.datetime
        return (dt.date() - _date(dt.year, 1, 1)).days + 1

    @property
    def hour(self):
        return self.datetime.hour

    @property
    def minute(self):
        return self.datetime.minute

    @property
    def second(self):
        return self.datetime.second

    @property
    def microsecond(self):
        return (self._ns % _NS) // 1000

    @property
    def nanosecond(self):
        return self._ns % _NS

    @property
    def matplotlib_date(self):
        """Days since 1970-01-01 (matplotlib's default date epoch)."""

        return self._ns / (86400 * _NS)

    def strftime(self, fmt):
        return self.datetime.strftime(fmt)

    def isoformat(self):
        return str(self)[:-1]

    # --- arithmetic ---

    def __add__(self, other):
        if isinstance(other, (int, float)):
            return UTCDateTime(ns=self._ns + int(round(other * _NS)))
        if isinstance(other, timedelta):
            return UTCDateTime(ns=self._ns + int(round(other.total_seconds() * _NS)))
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, UTCDateTime):
            return (self._ns - other._ns) / _NS
        if isinstance(other, (int, float)):
            return UTCDateTime(ns=self._ns - int(round(other * _NS)))
        if isinstance(other, timedelta):
            return UTCDateTime(ns=self._ns - int(round(other.total_seconds() * _NS)))
        if isinstance(other, datetime):
            return (self._ns - UTCDateTime(other)._ns) / _NS
        return NotImplemented

    # --- comparisons (exact at ns resolution) ---

    def _cmp_ns(self, other):
        if isinstance(other, UTCDateTime):
            return other._ns
        return UTCDateTime(other)._ns

    def __eq__(self, other):
        try:
            return self._ns == self._cmp_ns(other)
        except (TypeError, ValueError):
            return False

    def __ne__(self, other):
        return not self.__eq__(other)

    def __lt__(self, other):
        return self._ns < self._cmp_ns(other)

    def __le__(self, other):
        return self._ns <= self._cmp_ns(other)

    def __gt__(self, other):
        return self._ns > self._cmp_ns(other)

    def __ge__(self, other):
        return self._ns >= self._cmp_ns(other)

    def __hash__(self):
        return hash(self._ns)

    def __float__(self):
        return self.timestamp

    # --- representation (microsecond precision, trailing Z) ---

    def __str__(self):
        micro = round(self._ns / 1000)
        secs, micro = divmod(micro, 1_000_000)
        dt = _EPOCH + timedelta(seconds=secs)
        return (
            f"{dt.year:04d}-{dt.month:02d}-{dt.day:02d}T"
            f"{dt.hour:02d}:{dt.minute:02d}:{dt.second:02d}.{micro:06d}Z"
        )

    def __repr__(self):
        return f"UTCDateTime({str(self)})"
