# -*- coding: utf-8 -*-
"""
TriggeredEvents.csv I/O — the day-keyed candidate tables handed from
trigger to locate, the port of the JAX package's
``io/triggered_events.py`` without pandas. An endtime falling exactly at
midnight belongs to the next day and is excluded.

The files are the text pandas' ``to_csv`` writes for the same table
(:mod:`quakemigrate_torch.io.table`), so a file written by either package
reads in the other: trigger with one, locate with the other.

"""

import logging
from datetime import time

import quakemigrate_torch.util as util
from quakemigrate_torch.seis import UTCDateTime
from .table import Table, parse_number, read_csv

OUTPUT_COLS = [
    "EventID", "CoaTime", "TRIG_COA",
    "COA_X", "COA_Y", "COA_Z",
    "COA", "COA_NORM",
]

# Columns read as text; every other column is numeric where each of its
# fields parses as a number, as pandas' reader infers
_TEXT_COLS = ("EventID", "MinTime", "MaxTime")


def _day_file(run, when):
    """Path of the TriggeredEvents csv for the day containing ``when``."""

    stem = f"{run.name}_{when.year}_{when.julday:03d}_TriggeredEvents.csv"
    return run.path / "trigger" / run.subname / "events" / stem


def _read_one(path):
    """(header, rows) of one TriggeredEvents file."""

    header, rows = read_csv(path)
    return header, [dict(zip(header, row)) for row in rows]


def _typed(header, rows):
    """A Table of the rows' string fields: CoaTime as UTCDateTime, the
    text columns as strings, numeric columns as floats."""

    columns = {}
    for name in header:
        fields = [row.get(name, "") for row in rows]
        if name == "CoaTime":
            columns[name] = [UTCDateTime(f) for f in fields]
        elif name in _TEXT_COLS:
            columns[name] = fields
        else:
            try:
                columns[name] = [parse_number(f) for f in fields]
            except ValueError:
                columns[name] = fields
    return Table(columns, header)


def read_triggered_events(run, **kwargs):
    """
    Load candidate events for a time span (``starttime``/``endtime``) or
    from one explicit ``trigger_file``. CoaTime is parsed to UTCDateTime
    and the table is span-filtered. Returns a
    :class:`~quakemigrate_torch.io.table.Table`.

    """

    starttime, endtime = kwargs.get("starttime"), kwargs.get("endtime")
    trigger_file = kwargs.get("trigger_file")

    if trigger_file is not None:
        header, rows = _read_one(trigger_file)
    else:
        header, rows = None, []
        found = False
        day = UTCDateTime(starttime.date)
        while day <= endtime:
            source = _day_file(run, day)
            if source.is_file():
                day_header, day_rows = _read_one(source)
                header = header or day_header
                header += [c for c in day_header if c not in header]
                rows += day_rows
                found = True
            else:
                logging.info(f"\n\t    Cannot find file: {source.stem[:-16]}")
            day = day + 86400
        if not found:
            raise util.NoTriggerFilesFound

    events = _typed(header, rows)
    if starttime is not None and endtime is not None:
        # Midnight endtime: the boundary sample belongs to the next day.
        end_exclusive = endtime.time == time(0, 0)
        events = events.take([
            i for i, t in enumerate(events["CoaTime"])
            if starttime <= t and (t < endtime if end_exclusive
                                   else t <= endtime)
        ])

    if events.empty:
        logging.info(
            "\n\t    No triggered events found! Check your trigger output "
            "files.\n"
        )
    return events


@util.timeit("info")
def write_triggered_events(run, events, starttime, write_event_time_windows):
    """Write one day's triggered events table."""

    target = _day_file(run, starttime)
    target.parent.mkdir(exist_ok=True, parents=True)

    columns = OUTPUT_COLS + (
        ["MinTime", "MaxTime"] if write_event_time_windows else []
    )
    events.to_csv(target, columns)
