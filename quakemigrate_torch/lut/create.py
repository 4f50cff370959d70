# -*- coding: utf-8 -*-
"""
Traveltime lookup table builders of the port: the homogeneous
(straight-ray) builder of the JAX package's ``lut/create.py``, and
:func:`lut_from_reference`, which carries a lookup table's state across
from the JAX package (the system's analogue of carrying weights across).

"""

import logging

import numpy as np

from quakemigrate_torch.coords import Proj
from .lut import LUT, StationTable


def compute_traveltimes(grid_spec, stations, method="homogeneous",
                        phases=None, fraction_tt=0.1, save_file=None,
                        **kwargs):
    """
    Build a traveltime lookup table.

    Parameters
    ----------
    grid_spec : dict
        Keyword arguments for :class:`~quakemigrate_torch.lut.lut.Grid3D`:
        ll_corner, ur_corner, node_spacing, grid_proj, coord_proj.
    stations : StationTable (or anything indexable by column name)
        Columns Name, Latitude, Longitude, Elevation (positive down, as
        ``io.read_stations`` returns it).
    method : "homogeneous"
        Straight-ray distance over a constant velocity per phase; the
        other builders of the JAX package are not ported.
    phases : list of str
        Seismic phases to compute traveltimes for (default ["P", "S"]).
    fraction_tt : float
        Estimated velocity-model uncertainty as a fraction of traveltime.
    save_file : str, optional
        Where to save the LUT (:meth:`LUT.save`).
    kwargs
        ``v<phase>``: the velocity of each phase (e.g. vp, vs), in grid
        units per second.

    """

    if method != "homogeneous":
        raise ValueError(f"'{method}' is not a valid method: the port builds "
                         "'homogeneous' lookup tables only.")
    phases = ["P", "S"] if phases is None else list(phases)

    lut = LUT(**grid_spec, fraction_tt=fraction_tt)
    lut.station_data = StationTable.of(stations)
    lut.phases = phases
    lut.velocity_model = "Homogeneous velocity model:"
    speeds = {}
    for phase in phases:
        speeds[phase] = kwargs.get(f"v{phase.lower()}")
        if speeds[phase] is None:
            raise TypeError(f"Missing argument: 'v{phase.lower()}'")
        lut.velocity_model += f"\n\tV{phase.lower()} = {speeds[phase]:5.2f}"

    logging.info("Computing homogeneous traveltimes for...")
    for phase in phases:
        logging.info(f"\t...phase: {phase}...")
        _compute_homogeneous(lut, phase, speeds[phase])

    if save_file is not None:
        lut.save(save_file)
    return lut


def _compute_homogeneous(lut, phase, velocity):
    """Straight-line traveltimes at a constant velocity."""

    grid_xyz = lut.grid_xyz
    stations_xyz = lut.stations_xyz
    for i, station in enumerate(lut.station_data["Name"]):
        logging.info(f"\t\t...station: {station} - {i + 1} of "
                     f"{len(stations_xyz)}")
        dx, dy, dz = [grid_xyz[j] - stations_xyz[i, j] for j in range(3)]
        dist = np.sqrt(dx**2 + dy**2 + dz**2)
        lut.traveltimes.setdefault(station, {}).update({phase: dist / velocity})


def lut_from_reference(state):
    """
    A :class:`LUT` from a plain description of another lookup table's
    state, e.g. one read with the JAX package:

    ``state`` is a dict of numpy arrays and strings:

    - ``ll_corner``, ``ur_corner``: the corners in grid space (as the
      lookup table holds them, after projection);
    - ``node_spacing``, ``node_count``;
    - ``grid_proj``, ``coord_proj``: each projection's definition (the
      dict ``Projection.definition()`` returns);
    - ``stations``: columns Name, Latitude, Longitude, Elevation;
    - ``traveltimes``: ``{station: {phase: (nx, ny, nz) seconds}}``;
    - optional ``phases`` (default ["P", "S"]), ``fraction_tt`` (0.1)
      and ``velocity_model`` (a string).

    """

    lut = LUT(fraction_tt=float(state.get("fraction_tt", 0.1)))
    lut.grid_proj = Proj(**dict(state["grid_proj"]))
    lut.coord_proj = Proj(**dict(state["coord_proj"]))
    lut.ll_corner = np.asarray(state["ll_corner"], dtype=float)
    lut.ur_corner = np.asarray(state["ur_corner"], dtype=float)
    lut.node_spacing = state["node_spacing"]
    lut.node_count = state["node_count"]
    lut.phases = list(state.get("phases", ["P", "S"]))
    lut.velocity_model = str(state.get("velocity_model", ""))
    lut.station_data = StationTable.of(state["stations"])
    lut.traveltimes = {
        station: {phase: np.asarray(table, dtype=np.float64)
                  for phase, table in per_phase.items()}
        for station, per_phase in state["traveltimes"].items()
    }
    return lut
