# -*- coding: utf-8 -*-
"""
StationAvailability.csv output of detect: per-timestep 0/1 flags for each
station/phase onset, written per Julian day, the port of the JAX
package's ``write_availability`` without pandas. The file is the one
pandas' ``DataFrame.to_csv`` writes there: a header ``DT,<station_phase>,
...`` and one row per timestep, its label the timestep's start time.

"""

import csv

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
