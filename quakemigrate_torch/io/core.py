# -*- coding: utf-8 -*-
"""
Core I/O of the port: the Run directory/logging object, the station file
reader and the lookup-table reader (the port's npz+json format), after
the JAX package's ``io/core.py`` without pandas.

Station Elevations are positive-up in the file and flipped to positive-down
depths on read, as the reference does.

"""

import csv
import logging
from pathlib import Path

import numpy as np

import quakemigrate_torch.util as util
from quakemigrate_torch.lut import LUT, StationTable


class Run:
    """
    Identifies one processing run on disk: top-level path, run name,
    optional subname, and the active stage (detect/trigger/locate). Owns
    the per-stage logging setup.

    """

    def __init__(self, path, name, subname="", stage=None, loglevel="info"):
        if "." in f"{name}{subname}":
            print(
                "Warning: The character '.' is not allowed in run names/"
                "subnames - replacing with '_'."
            )
            name, subname = (s.replace(".", "_") for s in (name, subname))

        self.path = Path(path) / name
        self._name = name
        self.stage, self.subname, self.loglevel = stage, subname, loglevel

    def __str__(self):
        banner = f"{util.log_spacer}\n{util.log_spacer}\n"
        return (
            banner
            + f"\tquakemigrate_torch RUN - Path: {self.path} - Name: "
            f"{self.name}\n" + banner
        )

    def logger(self, log):
        """Point the root logger at this run's stage log directory."""

        stem = self.path / self.stage / self.subname / "logs" / self.name
        util.logger(stem, log, loglevel=self.loglevel)
        logging.info(self)

    @property
    def name(self):
        return f"{self._name}_{self.subname}" if self.subname else self._name


def read_lut(lut_file):
    """A LUT saved by :meth:`~quakemigrate_torch.lut.LUT.save`."""

    return LUT(lut_file=lut_file)


def read_stations(station_file, delimiter=","):
    """
    Station table from a CSV file with a header row. Required columns:
    Latitude, Longitude, Elevation (positive up; negated to depth on read),
    Name; other columns are ignored.

    """

    with open(station_file, newline="") as f:
        rows = list(csv.DictReader(f, delimiter=delimiter))
    header = set(rows[0]) if rows else set()
    if set(StationTable.COLUMNS) - header:
        raise util.StationFileHeaderException
    return StationTable({
        "Name": [row["Name"] for row in rows],
        "Latitude": np.array([float(row["Latitude"]) for row in rows]),
        "Longitude": np.array([float(row["Longitude"]) for row in rows]),
        "Elevation": -np.array([float(row["Elevation"]) for row in rows]),
    })
