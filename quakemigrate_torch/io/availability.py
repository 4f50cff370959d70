# -*- coding: utf-8 -*-
"""
StationAvailability.csv files of detect: per-timestep 0/1 flags for each
station/phase onset, written per Julian day and read back, the port of
the JAX package's ``write_availability`` and ``read_availability``
without pandas. The file is the one pandas' ``DataFrame.to_csv`` writes
there: a header ``DT,<station_phase>,...`` and one row per timestep, its
label the timestep's start time.

"""

import csv
import logging

import numpy as np

import quakemigrate_torch.util as util
from quakemigrate_torch.io.table import Table
from quakemigrate_torch.seis import UTCDateTime


def _day_file(run, when):
    stem = f"{when.year}_{when.julday:03d}_StationAvailability.csv"
    return run.path / "detect" / "availability" / stem


def _read_day(path):
    """(columns, {label: row}) of one day file written by this module or
    by the JAX package (index column first)."""

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    columns = rows[0][1:]
    return columns, {row[0]: [int(v) for v in row[1:]] for row in rows[1:]}


def _phase_suffix(name):
    """The phase of a new-format column ``{station}_{phase}``: the part
    after the last underscore where it is one uppercase letter, else
    None."""

    parts = str(name).rsplit("_", 1)
    if (len(parts) == 2 and len(parts[1]) == 1 and parts[1].isalpha()
            and parts[1].isupper()):
        return parts[1]
    return None


def _read_one_day(path):
    """(index name, labels, columns, [n_rows, n_columns] int flags) of one
    day file. An old-format file (a column per station, its unmarked
    index column, and not every column with a one-letter phase suffix)
    is expanded to ``{station}_P`` columns, then ``{station}_S``, as the
    reference converts it."""

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    index_name, columns = rows[0][0], rows[0][1:]
    labels = [row[0] for row in rows[1:]]
    flags = np.array([[int(float(v)) for v in row[1:]] for row in rows[1:]],
                     dtype=np.int64).reshape(len(labels), len(columns))
    if index_name == "DT" or (columns and all(
            _phase_suffix(c) is not None for c in columns)):
        return index_name, labels, columns, flags
    logging.info(
        "\t\tWarning: an availability file is in the old format - "
        "converting..."
    )
    return (index_name, labels,
            [f"{station}_{phase}" for phase in "PS" for station in columns],
            np.concatenate([flags, flags], axis=1))


def read_availability(run, starttime, endtime):
    """
    The availability tables of the Julian days covering ``[starttime,
    endtime]``, concatenated: a :class:`~quakemigrate_torch.io.table.
    Table` whose first column ``DT`` holds each row's label (the
    reference's index) and whose other columns are the int 0/1 flags.
    Days without a file are logged; raises
    NoStationAvailabilityDataException where no day has one.

    """

    logging.debug("\t    Reading in .StationAvailability...")
    starttime, endtime = UTCDateTime(starttime), UTCDateTime(endtime)
    days = []
    day = UTCDateTime(starttime.date)
    while day <= endtime:
        path = _day_file(run, day)
        if path.is_file():
            days.append(_read_one_day(path))
        else:
            logging.info(
                "\tNo .StationAvailability file found for "
                f"{day.year} - {day.julday:03d}"
            )
        day = day + 86400
    if not days:
        raise util.NoStationAvailabilityDataException
    columns = []
    for _, _, cols, _ in days:
        columns += [c for c in cols if c not in columns]
    table = {"DT": [label for _, labels, _, _ in days for label in labels]}
    for c in columns:
        # A day without the column holds NaN there, as pandas' concat
        parts = [flags[:, cols.index(c)].astype(float) if c in cols
                 else np.full(len(labels), np.nan)
                 for _, labels, cols, flags in days]
        merged = np.concatenate(parts)
        table[c] = (merged.astype(np.int64)
                    if not np.isnan(merged).any() else merged)
    return Table(table, ["DT", *columns])


def write_availability(run, availability, columns):
    """
    Write the availability table, split by Julian day.

    ``availability`` maps each timestep's label (its start time as a
    string) to ``{station_phase: 0/1}``; ``columns`` are the table's
    columns in order (a flag missing from a row is 0). Days that already
    have a table on disk (a resumed detect run) are merged, the new rows
    winning on duplicate labels, and sorted by label.

    """

    by_day = {}
    for label, flags in availability.items():
        date = UTCDateTime(label).date
        by_day.setdefault(date, {})[label] = [
            int(flags.get(col, 0)) for col in columns
        ]
    for date in sorted(by_day):
        target = _day_file(run, UTCDateTime(date))
        target.parent.mkdir(exist_ok=True, parents=True)
        rows = by_day[date]
        if target.is_file():
            prior_columns, prior = _read_day(target)
            if prior_columns != list(columns):
                raise ValueError(
                    f"{target} holds the columns {prior_columns}, not "
                    f"{list(columns)}"
                )
            kept = {k: v for k, v in prior.items() if k not in rows}
            if kept:
                rows = dict(sorted({**kept, **rows}.items()))
        with open(target, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(["DT", *columns])
            for label, flags in rows.items():
                writer.writerow([label, *flags])
