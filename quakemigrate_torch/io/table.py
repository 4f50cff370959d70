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
    """A CSV field as pandas would read it in a numeric column: float,
    NaN for an empty field; raises ValueError otherwise."""

    return np.nan if text == "" else float(text)
