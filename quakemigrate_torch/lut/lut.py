# -*- coding: utf-8 -*-
"""
Projection-aware 3-D grids and traveltime lookup tables, the port of the
JAX package's ``lut/lut.py`` without pandas and without plotting.

``Grid3D`` holds the corner/spacing grid definition with its
coordinate-space <-> grid-space projection pair; ``LUT`` adds the
per-station-per-phase traveltime tables and their serving as integer
sample offsets. The station table is a :class:`StationTable` of numpy
columns (Name, Latitude, Longitude, Elevation), not a DataFrame.

File format: the JAX LUT pickles its ``__dict__``, which holds pandas and
``quakemigrate_tpu.coords`` objects, so the port cannot read it. The port
saves one ``.npz`` file: the traveltime arrays, and a json document (the
grid spec, the station table, each projection by its definition, the
phases) stored as a string in the same archive. ``lut.create
.lut_from_reference`` carries a JAX LUT's state across.

"""

import copy
import json
import pathlib
from itertools import product

import numpy as np
from scipy.interpolate import RegularGridInterpolator

from quakemigrate_torch.coords import Proj, Transformer
from quakemigrate_torch.util import legacy_parameter, renamed_notice

LUT_FORMAT = "quakemigrate_torch.lut/1"


class StationTable:
    """
    Station metadata as numpy columns: Name (str), Latitude, Longitude and
    Elevation (float; Elevation is positive down, as ``read_stations``
    returns it). ``table["Name"]`` is a column; ``table[["Longitude",
    "Latitude", "Elevation"]]`` an [n_stations, 3] float array.

    """

    COLUMNS = ("Name", "Latitude", "Longitude", "Elevation")

    def __init__(self, columns=None):
        columns = {} if columns is None else columns
        n = len(columns["Name"]) if "Name" in columns else 0
        self._columns = {"Name": np.asarray(
            columns.get("Name", np.empty(0)), dtype=str).reshape(n)}
        for name in self.COLUMNS[1:]:
            self._columns[name] = np.asarray(
                columns.get(name, np.empty(n)), dtype=np.float64).reshape(n)

    @classmethod
    def of(cls, stations):
        """A StationTable from anything indexable by column name (a
        StationTable, a dict of sequences, a DataFrame)."""

        if isinstance(stations, cls):
            return stations
        return cls({name: np.asarray(stations[name]) for name in cls.COLUMNS})

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._columns[key]
        return np.column_stack([self._columns[k] for k in key])

    def __len__(self):
        return len(self._columns["Name"])

    def rows(self):
        """One dict a station, in table order."""

        for i in range(len(self)):
            yield {name: col[i] for name, col in self._columns.items()}

    def to_json(self):
        return {name: col.tolist() for name, col in self._columns.items()}

    def __eq__(self, other):
        return isinstance(other, StationTable) and all(
            np.array_equal(self[c], other[c]) for c in self.COLUMNS)

    def __repr__(self):
        return f"StationTable({len(self)} stations: {self['Name'].tolist()})"


class Grid3D:
    """
    Regular 3-D grid: lower-left / upper-right corners given in an input
    coordinate projection, transformed into a Cartesian grid projection, and
    discretised at a fixed node spacing.

    """

    def __init__(self, ll_corner, ur_corner, node_spacing, grid_proj,
                 coord_proj):
        self.grid_proj, self.coord_proj = grid_proj, coord_proj

        self.ll_corner, self.ur_corner = (
            self.coord2grid(corner)[0] for corner in (ll_corner, ur_corner)
        )
        self.node_spacing = node_spacing

        span = self.ur_corner - self.ll_corner
        self.node_count = 1 + np.ceil(span / self.node_spacing)

    # -- coordinate transforms ----------------------------------------------

    def coord2grid(self, value, inverse=False):
        """Input coordinate space <-> grid space (inverse: grid -> coords)."""

        route = (
            (self.grid_proj, self.coord_proj)
            if inverse
            else (self.coord_proj, self.grid_proj)
        )
        components = np.array(value, dtype=float).T
        transformed = Transformer.from_proj(*route).transform(*components)
        return np.column_stack(transformed)

    def index2grid(self, value, inverse=False, unravel=False):
        """Grid indices <-> grid space (inverse: positions -> indices)."""

        value = (
            np.column_stack(np.unravel_index(value, self.node_count))
            if unravel
            else np.array(value)
        )
        if inverse:
            fractional = (value - self.ll_corner) / self.node_spacing
            points = np.vstack(np.rint(fractional).astype(int))
        else:
            points = np.vstack(self.ll_corner + value * self.node_spacing)
        return points.T if points.shape[1] == 1 else points

    def index2coord(self, value, inverse=False, unravel=False):
        """Grid indices <-> input coordinate space (via grid space)."""

        if inverse:
            return self.index2grid(self.coord2grid(value), inverse=True)
        return self.coord2grid(self.index2grid(value, unravel=unravel),
                               inverse=True)

    # -- decimation -----------------------------------------------------------

    def decimate(self, df, inplace=False):
        """
        Thin the traveltime tables by integer factors ``df`` per axis,
        keeping the nodes ``offset + k * df`` with the offset that centres
        them in the original grid. Returns the decimated copy, or None
        with ``inplace``.

        The reference's quirk is kept: the grid corners are NOT moved, so
        where ``(node_count - 1) % df != 0`` (a nonzero offset)
        ``index2coord`` still maps index 0 to the original ``ll_corner``,
        and node coordinates shift by the offset times the old spacing.
        The decimated tables are contiguous copies, not strided views.

        """

        factors = np.array(df, dtype=int)
        kept = 1 + (self.node_count - 1) // factors
        offset = (self.node_count - factors * (kept - 1) - 1) // 2
        window = tuple(slice(o, None, f) for o, f in zip(offset, factors))

        target = self if inplace else copy.deepcopy(self)
        target.node_count = kept
        target.node_spacing = self.node_spacing * factors
        for tables in target.traveltimes.values():
            for phase in tables:
                tables[phase] = np.ascontiguousarray(tables[phase][window])

        if not inplace:
            return target

    # -- validated grid geometry ----------------------------------------------

    @property
    def node_count(self):
        """Nodes per axis (int32[3])."""

        return self._node_count

    @node_count.setter
    def node_count(self, value):
        counts = np.asarray(value).astype("int32")
        if not (counts > 0).all():
            raise AssertionError("Node count must be greater than [0]")
        self._node_count = counts

    @property
    def node_spacing(self):
        """Node spacing per axis (float64[3]; scalars broadcast)."""

        return self._node_spacing

    @node_spacing.setter
    def node_spacing(self, value):
        spacing = np.asarray(value, dtype="float64")
        if spacing.size == 1:
            spacing = np.full(3, float(spacing))
        if spacing.shape != (3,):
            raise AssertionError("Node spacing must be an nx3 array.")
        if not (spacing > 0).all():
            raise AssertionError("Node spacing must be greater than [0]")
        self._node_spacing = spacing

    @property
    def n_nodes(self):
        """Total node count."""

        return int(np.prod(self.node_count))

    cell_count = legacy_parameter("node_count",
                                  renamed_notice("cell_count", "node_count"))
    cell_size = legacy_parameter("node_spacing",
                                 renamed_notice("cell_size", "node_spacing"))

    # -- derived geometry -------------------------------------------------------

    @property
    def grid_corners(self):
        """The eight grid corner positions, in grid space."""

        extremes = [(0, top) for top in self.node_count - 1]
        return self.index2grid(list(product(*extremes)))

    def get_grid_extent(self, cells=False):
        """Geographic extent of the grid: [[lower corner], [upper
        corner]] in input coordinates, of the node centres, or with
        ``cells`` of the full cells."""

        lower, upper = self.grid_corners[0], self.grid_corners[-1]
        if cells is True:
            half = self.node_spacing / 2
            lower, upper = lower - half, upper + half
        return self.coord2grid([lower, upper], inverse=True)

    grid_extent = property(get_grid_extent)

    @property
    def grid_xyz(self):
        """Node positions as three (nx, ny, nz) mesh arrays."""

        shape = self.node_count
        flat_ijk = np.indices(shape).reshape(3, -1).T
        xyz = self.index2grid(flat_ijk)
        return [xyz[:, axis].reshape(shape) for axis in range(3)]

    @property
    def precision(self):
        """Decimal places per axis that resolve one node spacing."""

        zero, one = self.index2coord([[0, 0, 0], [1, 1, 1]])
        return [
            -int(np.format_float_scientific(step).split("e")[1])
            for step in zero - one
        ]

    @property
    def _grid_axis_info(self):
        return self.grid_proj.crs.axis_info[0]

    @property
    def unit_conversion_factor(self):
        """Grid units -> metres multiplier (1 for m, 1000 for km)."""

        return self._grid_axis_info.unit_conversion_factor

    @property
    def unit_name(self):
        """Short unit label of the grid projection."""

        return "km" if self._grid_axis_info.unit_name == "kilometre" else "m"


def _definition_json(proj):
    """A projection's definition with plain json scalars."""

    return {k: (v if isinstance(v, str) else
                bool(v) if isinstance(v, (bool, np.bool_)) else float(v))
            for k, v in proj.definition().items()}


def _velocity_model_json(vmodel):
    """A LUT's velocity model as json: a table (``io.read_vmodel``'s, as
    the 1-D builders keep it) as its column names and values, anything
    else as its string."""

    from quakemigrate_torch.io.table import Table

    if isinstance(vmodel, Table):
        return {"names": list(vmodel.names),
                "columns": {name: np.asarray(vmodel[name]).tolist()
                            for name in vmodel.names}}
    return str(vmodel)


def _velocity_model_from_json(value):
    """Inverse of :func:`_velocity_model_json`."""

    from quakemigrate_torch.io.table import Table

    if isinstance(value, dict):
        return Table(value["columns"], value["names"])
    return value


class LUT(Grid3D):
    """
    A Grid3D carrying per-station-per-phase traveltime tables
    (``lut.traveltimes[station][phase]``, each (nx, ny, nz) seconds), plus
    the serving and interpolation the scan and the synthetics use.

    """

    def __init__(self, fraction_tt=0.1, lut_file=None, **grid_spec):
        self.station_data = StationTable()
        self.fraction_tt = fraction_tt
        if grid_spec:
            super().__init__(**grid_spec)
            self.traveltimes, self.phases, self.velocity_model = {}, [], ""
        else:
            self.phases = ["P", "S"]
            if lut_file is not None:
                self.load(lut_file)

    def __str__(self):
        corners = self.coord2grid(self.grid_corners, inverse=True)
        lower, upper = corners[0], corners[-1]
        unit = self.unit_name

        def corner_line(label, c):
            return (
                f"\n\t{label} : {c[1]:10.5f}°N {c[0]:10.5f}°E "
                f"{c[2]:10.3f} {unit}"
            )

        vmodel = str(self.velocity_model).replace("\n", "\n\t")
        return (
            "quakemigrate_torch traveltime lookup table\nGrid parameters"
            + corner_line("Lower-left corner ", lower)
            + corner_line("Upper-right corner", upper)
            + f"\n\tNumber of nodes    : {self.node_count}"
            + f"\n\tNode spacing       : {self.node_spacing} {unit}"
            + "\n\n"
            + f"\tVelocity model:\n\t{vmodel}"
        )

    # -- serving ---------------------------------------------------------------

    def serve_traveltimes(self, sampling_rate, availability=None):
        """
        Traveltimes as int32 sample offsets, (nx, ny, nz, n_onsets). With an
        availability dict ("station_phase" -> 0/1) only available onsets are
        stacked, in dict order.

        """

        if availability is None:
            stacked = self._stack_tables(self.phases)
        else:
            # rsplit: station names may themselves contain underscores
            live = [
                key.rsplit("_", 1)
                for key, up in availability.items() if up == 1
            ]
            stacked = np.stack(
                [self[station][phase] for station, phase in live], axis=-1
            )
        return np.rint(stacked * sampling_rate).astype(np.int32)

    def _stack_tables(self, phases, stations=None):
        """Stack (phase-major, then station) tables along a new last axis."""

        if stations is None:
            stations = self.station_data["Name"]
        return np.stack(
            [self[station][phase] for phase in phases for station in stations],
            axis=-1,
        )

    def traveltime_to(self, phase, ijk, station=None):
        """Traveltime(s) to a fractional grid-index position, interpolated."""

        if station is None:
            tables = self._stack_tables([phase])
        else:
            names = [station] if isinstance(station, str) else station
            tables = self._stack_tables([phase], names)

        axes = tuple(np.arange(n) for n in self.node_count)
        sampler = RegularGridInterpolator(
            axes, tables, bounds_error=False, fill_value=None
        )
        return sampler(ijk)[0]

    @property
    def max_traveltime(self):
        """Largest traveltime in any served table."""

        return np.max(self._stack_tables(self.phases))

    # -- persistence -------------------------------------------------------------

    def save(self, filename):
        """
        Save this LUT as one ``.npz`` archive: the traveltime arrays
        (``tt_<i>``) and a json document (``meta``) naming the (station,
        phase) of each, the grid spec, the station table and each
        projection by its definition. Reads back with :meth:`load`
        without pickle.

        """

        tables = [(station, phase)
                  for station, per_phase in self.traveltimes.items()
                  for phase in per_phase]
        meta = {
            "format": LUT_FORMAT,
            "ll_corner": np.asarray(self.ll_corner, float).tolist(),
            "ur_corner": np.asarray(self.ur_corner, float).tolist(),
            "node_spacing": self.node_spacing.tolist(),
            "node_count": self.node_count.tolist(),
            "grid_proj": _definition_json(self.grid_proj),
            "coord_proj": _definition_json(self.coord_proj),
            "phases": list(self.phases),
            "fraction_tt": float(self.fraction_tt),
            "velocity_model": _velocity_model_json(self.velocity_model),
            "stations": self.station_data.to_json(),
            "tables": tables,
        }
        arrays = {f"tt_{i}": np.asarray(self.traveltimes[st][ph])
                  for i, (st, ph) in enumerate(tables)}
        path = pathlib.Path(filename)
        path.parent.mkdir(parents=True, exist_ok=True)
        # Through an open handle: np.savez would append ".npz" to the name
        with path.open("wb") as f:
            np.savez(f, meta=np.array(json.dumps(meta)), **arrays)

    def load(self, filename):
        """Restore state saved by :meth:`save`."""

        with np.load(filename, allow_pickle=False) as archive:
            meta = json.loads(str(archive["meta"]))
            if meta.get("format") != LUT_FORMAT:
                raise ValueError(
                    f"{filename} is not a {LUT_FORMAT} lookup table")
            traveltimes = {}
            for i, (station, phase) in enumerate(meta["tables"]):
                traveltimes.setdefault(station, {})[phase] = archive[f"tt_{i}"]
        self.grid_proj = Proj(**meta["grid_proj"])
        self.coord_proj = Proj(**meta["coord_proj"])
        self.ll_corner = np.asarray(meta["ll_corner"], float)
        self.ur_corner = np.asarray(meta["ur_corner"], float)
        self.node_spacing = meta["node_spacing"]
        self.node_count = meta["node_count"]
        self.phases = list(meta["phases"])
        self.fraction_tt = meta["fraction_tt"]
        self.velocity_model = _velocity_model_from_json(
            meta["velocity_model"])
        self.station_data = StationTable(meta["stations"])
        self.traveltimes = traveltimes

    # -- network geometry -----------------------------------------------------------

    @property
    def station_extent(self):
        """[[min lon, lat, elev], [max lon, lat, elev]] over the network."""

        positions = self.station_data[["Longitude", "Latitude", "Elevation"]]
        return [list(positions.min(axis=0)), list(positions.max(axis=0))]

    @property
    def stations_xyz(self):
        """Station positions in grid space."""

        return self.coord2grid(
            self.station_data[["Longitude", "Latitude", "Elevation"]]
        )

    @property
    def max_extent(self):
        """Union of the station and (cell-padded) grid extents, padded by
        5 % of its span on each side."""

        corners = np.array([self.station_extent,
                            self.get_grid_extent(cells=True)])
        lower = corners[:, 0].min(axis=0)
        upper = corners[:, 1].max(axis=0)
        margin = 0.05 * np.abs(upper - lower)
        return np.array([lower - margin, upper + margin])

    # -- misc ---------------------------------------------------------------------

    def plot(self, fig, gs, slices=None, hypocentre=None, station_clr="k",
             station_list=None):
        """Grid cross-section figure with stations (see plot.lut)."""

        from quakemigrate_torch.plot.lut import lut_plot

        lut_plot(self, fig, gs, slices, hypocentre, station_clr, station_list)

    def __add__(self, other):
        """Merge the traveltime tables of a LUT on the same grid into this
        one (in place; returns it). Prints and returns None where the
        grids differ, and prints and returns this LUT unchanged for a
        non-LUT, as the reference does."""

        if not isinstance(other, LUT):
            print("Addition not defined for non-LUT object.")
        elif self == other:
            self.traveltimes.update(other.traveltimes)
        else:
            print("Grid definitions do not match - cannot combine.")
            return None
        return self

    def __eq__(self, other):
        """Grid-definition equality (corners, spacing, projections)."""

        if not isinstance(other, LUT):
            return False
        same_geometry = (
            (self.grid_corners == other.grid_corners).all()
            and (self.node_spacing == other.node_spacing).all()
        )
        same_projections = (
            self.grid_proj == other.grid_proj
            and self.coord_proj == other.coord_proj
        )
        return bool(same_geometry and same_projections)

    __hash__ = None

    def __getitem__(self, key):
        """``lut[station]`` -> that station's phase-keyed traveltime tables."""

        return self.traveltimes.get(key)
