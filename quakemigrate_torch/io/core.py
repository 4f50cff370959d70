# -*- coding: utf-8 -*-
"""
Core I/O of the port: the Run directory/logging object, the station and
1-D velocity model file readers, the lookup-table reader (the port's
npz+json format) and the instrument-response reader (StationXML, RESP,
SAC_PZ), after the JAX package's ``io/core.py`` without pandas.

Station Elevations are positive-up in the file and flipped to positive-down
depths on read, as the reference does.

"""

import csv
import logging
from pathlib import Path

import numpy as np

import quakemigrate_torch.util as util
from quakemigrate_torch.io.table import Table, parse_column
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


def _csv_delimiter(delimiter, kwargs):
    """The field delimiter of the CSV readers: ``delimiter``, or pandas'
    ``sep``, the one ``read_csv`` option the JAX readers' ``**kwargs``
    take here; any other option raises TypeError."""

    delimiter = kwargs.pop("sep", delimiter)
    if kwargs:
        raise TypeError(f"unsupported read_csv options {sorted(kwargs)}: "
                        "the port reads CSV without pandas")
    return delimiter


def read_stations(station_file, delimiter=",", **kwargs):
    """
    Station table from a CSV file with a header row. Required columns:
    Latitude, Longitude, Elevation (positive up; negated to depth on read),
    Name; other columns are ignored. ``sep`` is taken for ``delimiter``.

    """

    delimiter = _csv_delimiter(delimiter, kwargs)
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


def stations(station_file, **kwargs):
    """Deprecated alias for :func:`read_stations` (the reference's old
    name)."""

    print(
        "FutureWarning: function name has changed - continuing.\n"
        "To remove this message, change:\t'stations' -> 'read_stations'"
    )
    return read_stations(station_file, **kwargs)


def read_vmodel(vmodel_file, delimiter=",", **kwargs):
    """
    1-D velocity model from a CSV file with a header row: a "Depth"
    column (positive down) and one "V<phase>" column per phase (e.g. Vp,
    Vs). Returns an :class:`~quakemigrate_torch.io.table.Table` of the
    file's columns, in order. Raises InvalidVelocityModelHeader without a
    "Depth" column. ``sep`` is taken for ``delimiter``.

    """

    delimiter = _csv_delimiter(delimiter, kwargs)
    with open(vmodel_file, newline="") as f:
        rows = list(csv.reader(f, delimiter=delimiter))
    header, body = rows[0], [row for row in rows[1:] if row]
    if "Depth" not in header:
        raise util.InvalidVelocityModelHeader("Depth")
    return Table({name: parse_column([row[i] for row in body])
                  for i, name in enumerate(header)}, header)


def _looks_like_resp(path):
    """True for RESP (evalresp blockette) input: dir of RESP.* or non-XML."""

    if path.is_dir():
        return any(p.name.upper().startswith("RESP") for p in path.iterdir())
    with open(path) as f:
        for line in f:
            body = line.strip()
            if body:
                return not body.startswith("<")
    return False


def read_response_inv(response_file, sac_pz_format=False):
    """
    Build a :class:`~quakemigrate_torch.seis.response.Inventory` from
    StationXML, RESP (a file or a directory of RESP.* files), or (with
    ``sac_pz_format``) SAC poles-and-zeros files.

    """

    if sac_pz_format:
        from quakemigrate_torch.seis.sacpz import read_sac_pz

        return read_sac_pz(response_file)

    if _looks_like_resp(Path(response_file)):
        from quakemigrate_torch.seis.resp import read_resp

        return read_resp(response_file)

    from xml.etree.ElementTree import ParseError

    from quakemigrate_torch.seis import read_inventory

    try:
        return read_inventory(response_file)
    except (ParseError, ValueError, TypeError) as err:
        raise TypeError(f"Response file not readable as StationXML: {err}")
