# -*- coding: utf-8 -*-
"""
A small columnar table, the port's stand-in for the pandas DataFrames of
the JAX package's trigger and locate stages (scan data, candidates,
triggered events, the locate coalescence series and picks), and the CSV
text that pandas' ``DataFrame.to_csv(index=False)`` writes for such a
frame, so that files written by either package read in the other.

The CSV text rules, per column:

- a column whose values are all numbers (int, float, numpy numbers; not
  bool) is a numeric column: if any value is a float, every value is
  written as ``repr(float(value))`` and NaN as an empty field; else as
  ``str(int(value))``;
- any other column is written value by value with ``str``, None and
  float NaN as an empty field (``UTCDateTime`` as its ``str``);
- ``csv`` quoting is minimal and lines end in ``"\\n"``.

"""

import csv
import math
import re

import numpy as np


def _is_number(value):
    return (isinstance(value, (int, float, np.integer, np.floating))
            and not isinstance(value, (bool, np.bool_)))


def _is_missing(value):
    return value is None or (isinstance(value, (float, np.floating))
                             and math.isnan(value))


def column_text(values):
    """The CSV fields of one column's values, as pandas writes them."""

    values = list(values)
    if values and all(_is_number(v) for v in values):
        if any(isinstance(v, (float, np.floating)) for v in values):
            return ["" if math.isnan(v) else repr(float(v)) for v in values]
        return [str(int(v)) for v in values]
    return ["" if _is_missing(v) else str(v) for v in values]


class Table:
    """
    Named columns of equal length, in order: ``table[name]`` is a numpy
    array (dtype object for mixed or non-numeric values).

    Parameters
    ----------
    columns : dict, optional
        Column name -> sequence of values, in column order.
    names : list of str, optional
        The column order, for an empty table or to reorder ``columns``.

    """

    def __init__(self, columns=None, names=None):
        columns = {} if columns is None else dict(columns)
        self.names = list(columns) if names is None else list(names)
        self._cols = {}
        for name in self.names:
            self[name] = columns.get(name, [])

    @classmethod
    def from_rows(cls, rows, names):
        """A table of ``rows`` (dicts keyed by column name)."""

        return cls({name: [row.get(name) for row in rows] for name in names},
                   names)

    def __getitem__(self, name):
        return self._cols[name]

    def __setitem__(self, name, values):
        if isinstance(values, np.ndarray):
            column = values
        else:
            values = list(values)
            column = np.empty(len(values), dtype=object)
            column[:] = values
            if values and all(_is_number(v) for v in values):
                column = np.asarray(values)
        if self._cols and len(column) != len(self):
            raise ValueError(f"column {name} has {len(column)} values, the "
                             f"table {len(self)} rows")
        if name not in self.names:
            self.names.append(name)
        self._cols[name] = column

    def __len__(self):
        return len(self._cols[self.names[0]]) if self.names else 0

    @property
    def empty(self):
        return len(self) == 0

    def take(self, keep):
        """The rows selected by ``keep`` (a boolean mask or indices)."""

        return Table({name: self._cols[name][keep] for name in self.names},
                     self.names)

    def row(self, i):
        """Row ``i`` as a dict."""

        return {name: self._cols[name][i] for name in self.names}

    def rows(self):
        return [self.row(i) for i in range(len(self))]

    def __str__(self):
        """The columns as right-aligned text, a header line and a line a
        row, as a DataFrame prints without its index."""

        fields = [[name] + column_text(self._cols[name])
                  for name in self.names]
        widths = [max(len(f) for f in column) for column in fields]
        return "\n".join(
            " ".join(column[i].rjust(w) for column, w in zip(fields, widths))
            for i in range(len(self) + 1))

    def to_csv(self, path, names=None):
        """Write ``names`` (default every column) as CSV text, as pandas'
        ``to_csv(index=False)`` writes the same frame."""

        names = self.names if names is None else list(names)
        fields = [column_text(self._cols[name]) for name in names]
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(names)
            writer.writerows(zip(*fields))


def read_csv(path):
    """(header, rows of string fields) of a CSV file."""

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def parse_number(text):
    """A CSV field as pandas would read it in a numeric column: float
    (:func:`pandas_float`), NaN for an empty field; raises ValueError
    otherwise."""

    return np.nan if text == "" else pandas_float(text)


# The fields pandas' read_csv reads as missing by default
NA_FIELDS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_INT = re.compile(r"[+-]?\d+")
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}
_INT64 = np.iinfo(np.int64)
_FLOAT = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*")
# The powers of ten of pandas' parser, each the double nearest its literal
_TENS = [float(f"1e{i}") for i in range(309)]


def pandas_float(text):
    """
    A decimal field as pandas' ``read_csv`` reads it into a float64
    column: its C parser's default converter (``precise_xstrtod``), which
    gathers up to 17 significant digits into a double, then multiplies
    or divides by a power of ten from a table. That is not always the
    double nearest the text (one unit in the last place off, as for
    4.020051259416064e-08), so ``float(text)`` would not give the JAX
    package's values. Raises ValueError on a field that is no number.

    """

    match = _FLOAT.fullmatch(text)
    if match is None or not (match.group(2) or match.group(3)):
        raise ValueError(f"not a number: {text!r}")
    sign, whole, frac, exp = match.groups()
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in (frac or "")[:max(17 - digits, 0)]:
        number = number * 10.0 + (ord(ch) - 48)
        exponent -= 1
    if sign == "-":
        number = -number
    if exp:
        exponent += int(exp[:18] if exp[0] in "+-" else exp[:17])
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _TENS[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _TENS[-308 - exponent] / _TENS[308]
    return number / _TENS[-exponent]


def parse_column(fields):
    """
    One CSV column's string fields typed as pandas' ``read_csv`` types
    them: int64 where every field is an integer; else bool where every
    field is a boolean word; else float64 where every field that is not
    missing (:data:`NA_FIELDS`) is a number, missing ones NaN; else the
    strings (dtype object), missing ones float NaN. A boolean column with
    a missing field is an object column of bools and NaN. Numbers are
    read as pandas reads them (:func:`pandas_float`).

    """

    present = [f for f in fields if f not in NA_FIELDS]
    if (len(present) == len(fields) and fields
            and all(_INT.fullmatch(f) for f in fields)):
        values = [int(f) for f in fields]
        if _INT64.min <= min(values) and max(values) <= _INT64.max:
            return np.array(values, dtype=np.int64)
    if present and all(f in _BOOLS for f in present):
        if len(present) == len(fields):
            return np.array([_BOOLS[f] for f in fields])
        column = np.empty(len(fields), dtype=object)
        column[:] = [_BOOLS.get(f, np.nan) for f in fields]
        return column
    try:
        return np.array([np.nan if f in NA_FIELDS else pandas_float(f)
                         for f in fields], dtype=np.float64)
    except ValueError:
        column = np.empty(len(fields), dtype=object)
        column[:] = [np.nan if f in NA_FIELDS else f for f in fields]
        return column


def read_table(path):
    """A CSV file with a header row as a :class:`Table` whose columns are
    typed as pandas' ``read_csv`` types them (:func:`parse_column`). A
    file written with pandas' index (``.amps``) keeps that index as its
    first column."""

    header, rows = read_csv(path)
    rows = [row for row in rows if row]
    return Table({name: parse_column([row[i] for row in rows])
                  for i, name in enumerate(header)}, header)
