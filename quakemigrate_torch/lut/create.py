# -*- coding: utf-8 -*-
"""
Traveltime lookup table builders of the port, after the JAX package's
``lut/create.py`` without pandas, and :func:`lut_from_reference`, which
carries a lookup table's state across from the JAX package (the system's
analogue of carrying weights across).

Methods:

- "homogeneous": straight-ray distance / velocity.
- "1dfmm": full 3-D fast-marching solve of a 1-D velocity model with the
  port's C solver (:func:`quakemigrate_torch.core.fast_marching`).
  Stations must lie inside the grid.
- "1dsweep": 2-D (offset, depth) fast-marching solve swept to 3-D by
  bilinear interpolation; handles stations outside the grid. The native
  equivalent of "1dnlloc".
- "3dfmm": full 3-D fast-marching solve of a 3-D velocity grid.
- "1dnlloc": runs the external NonLinLoc binaries (Vel2Grid, Grid2Time)
  where they are on PATH, and otherwise raises with a pointer to
  "1dsweep".

Also :func:`read_nlloc`, which imports NonLinLoc .hdr/.buf grids.

A velocity model is the :class:`~quakemigrate_torch.io.table.Table` that
``io.read_vmodel`` returns (anything indexable by column name serves): a
"Depth" column and one "V<phase>" column per phase.

"""

import logging
import pathlib

import numpy as np
from scipy.interpolate import interp1d

import quakemigrate_torch.util as util
from quakemigrate_torch.coords import Proj, Transformer
from quakemigrate_torch.core import fast_marching
from quakemigrate_torch.io.table import Table
from .lut import LUT, StationTable


def compute_traveltimes(
    grid_spec,
    stations,
    method,
    phases=None,
    fraction_tt=0.1,
    save_file=None,
    log=False,
    **kwargs,
):
    """
    Build a traveltime lookup table. See the module docstring for the
    methods.

    Parameters
    ----------
    grid_spec : dict
        Keyword arguments for :class:`~quakemigrate_torch.lut.lut.Grid3D`:
        ll_corner, ur_corner, node_spacing, grid_proj, coord_proj.
    stations : StationTable (or anything indexable by column name)
        Columns Name, Latitude, Longitude, Elevation (positive down, as
        ``io.read_stations`` returns it).
    method : {"homogeneous", "1dfmm", "1dsweep", "3dfmm", "1dnlloc"}
    phases : list of str
        Seismic phases to compute traveltimes for (default ["P", "S"]).
    fraction_tt : float
        Estimated velocity-model uncertainty as a fraction of traveltime.
    save_file : str, optional
        Where to save the LUT (:meth:`LUT.save`).
    log : bool
        Also log to a file under ``logs/lut`` in the working directory.
    kwargs
        Method-specific options: ``v<phase>`` (homogeneous: the velocity
        of each phase, e.g. vp, vs, in grid units per second), ``vmod``
        (1dfmm, 1dsweep, 1dnlloc: a 1-D velocity model), ``vmod_3d``
        (3dfmm: dict of phase -> 3-D velocity array on the LUT grid),
        ``sweep_dx`` or ``nlloc_dx`` (1dsweep, 1dnlloc: the 2-D grid
        spacing), ``block_model`` (1dsweep, 1dnlloc: constant velocity
        within each layer), ``nlloc_path`` and ``retain_nll_grids``
        (1dnlloc).

    """

    phases = ["P", "S"] if phases is None else list(phases)
    util.logger(pathlib.Path.cwd() / "logs" / "lut", log)

    lut = LUT(**grid_spec, fraction_tt=fraction_tt)
    lut.station_data = StationTable.of(stations)
    lut.phases = phases

    try:
        banner, setup = _BUILDERS[method]
    except KeyError:
        raise ValueError(
            f"'{method}' is not a valid method. Valid options are "
            "'homogeneous', '1dfmm', '1dsweep', '3dfmm', and '1dnlloc'."
        ) from None

    logging.info(banner)
    per_phase = setup(lut, phases, kwargs)
    for phase in phases:
        logging.info(f"\t...phase: {phase}...")
        per_phase(phase)

    if save_file is not None:
        lut.save(save_file)

    return lut


def _require(options, key):
    value = options.get(key)
    if value is None:
        raise TypeError(f"Missing argument: '{key}'")
    return value


def _setup_homogeneous(lut, phases, options):
    lut.velocity_model = "Homogeneous velocity model:"
    speeds = {}
    for phase in phases:
        speeds[phase] = _require(options, f"v{phase.lower()}")
        lut.velocity_model += f"\n\tV{phase.lower()} = {speeds[phase]:5.2f}"
    return lambda phase: _compute_homogeneous(lut, phase, speeds[phase])


def _setup_1d_fmm(lut, phases, options):
    lut.velocity_model = vmodel = _require(options, "vmod")
    return lambda phase: _compute_1d_fmm(lut, phase, vmodel)


def _setup_1d_sweep(lut, phases, options):
    lut.velocity_model = vmodel = _require(options, "vmod")
    return lambda phase: _compute_1d_sweep(lut, phase, vmodel, **options)


def _setup_3d_fmm(lut, phases, options):
    vmod_3d = options.get("vmod_3d")
    if vmod_3d is None:
        raise TypeError(
            "Missing argument: 'vmod_3d' (dict of phase -> 3-D velocity "
            "array on the LUT grid)"
        )
    lut.velocity_model = "3-D velocity model (user-supplied grids)"
    return lambda phase: _compute_3d_fmm(
        lut, phase, np.asarray(vmod_3d[phase])
    )


def _setup_1d_nlloc(lut, phases, options):
    lut.velocity_model = vmodel = _require(options, "vmod")
    return lambda phase: _compute_1d_nlloc(lut, phase, vmodel, **options)


# method -> (log banner, setup returning the per-phase compute closure)
_BUILDERS = {
    "homogeneous": (
        "Computing homogeneous traveltimes for...", _setup_homogeneous,
    ),
    "1dfmm": (
        "Computing 1-D fast-marching traveltimes for...", _setup_1d_fmm,
    ),
    "1dsweep": (
        "Computing 1-D swept 2-D fast-marching traveltimes for...",
        _setup_1d_sweep,
    ),
    "3dfmm": (
        "Computing 3-D fast-marching traveltimes for...", _setup_3d_fmm,
    ),
    "1dnlloc": (
        "Computing 1-D NonLinLoc traveltimes for...", _setup_1d_nlloc,
    ),
}


def _log_station(i, station, n_stations):
    logging.info(f"\t\t...station: {station} - {i + 1} of {n_stations}")


def _compute_homogeneous(lut, phase, velocity):
    """Straight-line traveltimes at a constant velocity."""

    grid_xyz = lut.grid_xyz
    stations_xyz = lut.stations_xyz
    for i, station in enumerate(lut.station_data["Name"]):
        _log_station(i, station, len(stations_xyz))
        dx, dy, dz = [grid_xyz[j] - stations_xyz[i, j] for j in range(3)]
        dist = np.sqrt(dx**2 + dy**2 + dz**2)
        lut.traveltimes.setdefault(station, {}).update({phase: dist / velocity})


def _vmodel_columns(vmodel, phase):
    """(depths, velocities) of ``phase`` in a velocity model; raises
    InvalidVelocityModelHeader without its "V<phase>" column."""

    try:
        return (np.asarray(vmodel["Depth"], dtype=np.float64),
                np.asarray(vmodel[f"V{phase.lower()}"], dtype=np.float64))
    except KeyError:
        raise util.InvalidVelocityModelHeader(f"V{phase.lower()}")


def _interp_vmodel(vmodel, phase):
    """1-D velocity profile as a constant-extrapolated linear interpolant."""

    depths, velocities = _vmodel_columns(vmodel, phase)
    big = np.finfo(np.float64).max
    depths = np.insert(np.append(depths, big), 0, -big)
    velocities = np.insert(np.append(velocities, velocities[-1]), 0,
                           velocities[0])
    return interp1d(depths, velocities)


def _outside_grid(lut, stations_xyz):
    return ((stations_xyz < lut.ll_corner).any()
            or (stations_xyz > lut.ur_corner).any())


def _compute_1d_fmm(lut, phase, vmodel):
    """Full 3-D fast-marching solve of a 1-D model (in-grid stations)."""

    grid_xyz = lut.grid_xyz
    stations_xyz = lut.stations_xyz
    if _outside_grid(lut, stations_xyz):
        raise ValueError(
            "Cannot calculate traveltimes with method '1dfmm' unless all "
            "stations are contained within the grid! Use method '1dsweep' "
            "or increase the grid extent."
        )

    velocity_grid = _interp_vmodel(vmodel, phase)(grid_xyz[2])
    for i, station in enumerate(lut.station_data["Name"]):
        _log_station(i, station, len(stations_xyz))
        source_index = (stations_xyz[i] - lut.ll_corner) / lut.node_spacing
        tt = fast_marching(
            velocity_grid, lut.node_spacing, source_index, order=2
        )
        lut.traveltimes.setdefault(station, {}).update({phase: tt})


def _compute_3d_fmm(lut, phase, velocity_grid):
    """Full 3-D fast-marching solve of a user-supplied 3-D velocity grid."""

    if tuple(velocity_grid.shape) != tuple(lut.node_count):
        raise ValueError(
            f"3-D velocity grid shape {velocity_grid.shape} does not match "
            f"LUT node count {tuple(lut.node_count)}."
        )
    stations_xyz = lut.stations_xyz
    if _outside_grid(lut, stations_xyz):
        raise ValueError(
            "Cannot calculate traveltimes with method '3dfmm' unless all "
            "stations are contained within the grid!"
        )

    for i, station in enumerate(lut.station_data["Name"]):
        _log_station(i, station, len(stations_xyz))
        source_index = (stations_xyz[i] - lut.ll_corner) / lut.node_spacing
        tt = fast_marching(
            velocity_grid, lut.node_spacing, source_index, order=2
        )
        lut.traveltimes.setdefault(station, {}).update({phase: tt})


def _compute_1d_sweep(lut, phase, vmodel, **kwargs):
    """
    2-D (offset, depth) eikonal solve per station, swept to the 3-D grid by
    bilinear interpolation: handles out-of-grid stations, with the geometry
    of NonLinLoc's Grid2Time path ("1dnlloc") on the port's solver.

    """

    sweep_dx = kwargs.get("sweep_dx", kwargs.get("nlloc_dx"))
    block_model = kwargs.get("block_model", False)

    grid_xyz = lut.grid_xyz
    stations_xyz = lut.stations_xyz
    ll, ur = lut.ll_corner, lut.ur_corner

    if sweep_dx is None:
        sweep_dx = float(np.min(lut.node_spacing))

    interp = _interp_vmodel(vmodel, phase)

    for i, station in enumerate(lut.station_data["Name"]):
        _log_station(i, station, len(stations_xyz))

        dx, dy = [grid_xyz[j] - stations_xyz[i, j] for j in range(2)]
        distances = np.sqrt(dx**2 + dy**2).flatten()
        depths = grid_xyz[2].flatten()
        max_dist = np.max(distances)

        # The 2-D grid spans the full offset range and the union of the
        # grid's and the station's depth extents, with a small buffer.
        z_min = min(ll[2], stations_xyz[i, 2])
        z_max = max(ur[2], stations_xyz[i, 2])
        nr = int(np.ceil(max_dist / sweep_dx)) + 5
        nz = int(np.ceil((z_max - z_min) / sweep_dx)) + 5

        z_axis = z_min + np.arange(nz) * sweep_dx

        if block_model:
            depths_m, vels_m = _vmodel_columns(vmodel, phase)
            v_of_z = vels_m[
                np.clip(
                    np.searchsorted(depths_m, z_axis, side="right") - 1,
                    0,
                    len(vels_m) - 1,
                )
            ]
        else:
            v_of_z = interp(z_axis)
        velocity_2d = np.broadcast_to(v_of_z, (nr, nz)).copy()

        src_z = (stations_xyz[i, 2] - z_min) / sweep_dx
        tt_2d = fast_marching(
            velocity_2d, (sweep_dx, sweep_dx), (0.0, src_z), order=2
        )

        tt = _bilinear_interpolate(
            np.c_[distances, depths],
            np.array([0.0, z_min]),
            np.array([sweep_dx, sweep_dx]),
            tt_2d,
        ).reshape(lut.node_count)
        lut.traveltimes.setdefault(station, {}).update({phase: tt})


def _bilinear_interpolate(xz, xz_origin, xz_dimensions, table):
    """Bilinear interpolation of a 2-D table at arbitrary (x, z) points."""

    i, k = np.floor((xz - xz_origin) / xz_dimensions).astype(int).T
    i = np.clip(i, 0, table.shape[0] - 2)
    k = np.clip(k, 0, table.shape[1] - 2)

    x_d, z_d = ((xz - xz_origin) / xz_dimensions - np.c_[i, k]).T

    c00 = table[i, k]
    c10 = table[i + 1, k]
    c11 = table[i + 1, k + 1]
    c01 = table[i, k + 1]

    c0 = c00 * (1 - x_d) + c10 * x_d
    c1 = c01 * (1 - x_d) + c11 * x_d

    return c0 * (1 - z_d) + c1 * z_d


def _scale_vmodel(vmodel, phase, factor):
    """The Depth and V<phase> columns of a velocity model divided by
    ``factor`` (grid units -> km), as a Table."""

    depths, velocities = _vmodel_columns(vmodel, phase)
    return Table({"Depth": depths / factor,
                  f"V{phase.lower()}": velocities / factor})


def _compute_1d_nlloc(lut, phase, vmodel, **kwargs):
    """
    NonLinLoc Vel2Grid + Grid2Time run as subprocesses, as the reference
    does. Requires the NonLinLoc binaries; where they are not found, raises
    with a pointer to the native "1dsweep" method.

    """

    import shutil

    nlloc_path = pathlib.Path(kwargs.get("nlloc_path", ""))
    vel2grid = (str(nlloc_path / "Vel2Grid") if str(nlloc_path) != "."
                else "Vel2Grid")
    if (shutil.which(vel2grid) is None
            and not (nlloc_path / "Vel2Grid").exists()):
        raise FileNotFoundError(
            "NonLinLoc executables (Vel2Grid/Grid2Time) not found. Use the "
            "native method='1dsweep' instead -- it implements the same "
            "2-D solve + azimuthal sweep without external binaries."
        )

    from subprocess import STDOUT, check_output

    nlloc_dx = kwargs.get("nlloc_dx", 0.1)
    block_model = kwargs.get("block_model", False)
    retain_nll_grids = kwargs.get("retain_nll_grids", False)

    km_cf = 1000 / lut.unit_conversion_factor
    grid_xyz = [g / km_cf for g in lut.grid_xyz]
    stations_xyz = lut.stations_xyz / km_cf
    ll, *_, ur = lut.grid_corners / km_cf
    vmodel = _scale_vmodel(vmodel, phase, km_cf)

    cwd = pathlib.Path.cwd()
    (cwd / "time").mkdir(exist_ok=True)
    (cwd / "model").mkdir(exist_ok=True)

    def run_tool(tool):
        out = check_output([str(nlloc_path / tool), "control.in"],
                           stderr=STDOUT)
        if b"ERROR" in out:
            raise Exception(f"{tool} Error", out)

    flat_depths = grid_xyz[2].flatten()
    station_names = lut.station_data["Name"]
    for i, station in enumerate(station_names):
        logging.info(
            f"\t\t...running Grid2Time - station: {station:5s} - {i + 1} of "
            f"{len(stations_xyz)}"
        )
        offsets = np.hypot(
            grid_xyz[0] - stations_xyz[i, 0],
            grid_xyz[1] - stations_xyz[i, 1],
        ).flatten()
        z_span = [
            min(ll[2], stations_xyz[i, 2]), max(ur[2], stations_xyz[i, 2])
        ]
        _write_control_file(
            stations_xyz[i], station, offsets.max(), vmodel, z_span, phase,
            nlloc_dx, block_model,
        )
        run_tool("Vel2Grid")
        run_tool("Grid2Time")

        spec, _, table_2d = _read_nlloc(
            cwd / "time" / f"layer.{phase}.{station}.time", ignore_proj=True
        )
        swept = _bilinear_interpolate(
            np.c_[offsets, flat_depths], spec[1, 1:], spec[2, 1:],
            table_2d[0],
        )
        lut.traveltimes.setdefault(station, {})[phase] = (
            swept.reshape(lut.node_count)
        )

        (cwd / "control.in").unlink(missing_ok=True)
        if not retain_nll_grids:
            # Grid2Time writes under time/, Vel2Grid under model/
            for subdir, pattern in (
                ("time", f"layer.{phase}.{station}.time*"),
                ("model", f"layer.{phase}.mod.*"),
            ):
                for file in (cwd / subdir).glob(pattern):
                    file.unlink()


def _write_control_file(
    station_xyz, station, max_dist, vmodel, depth_span, phase, dx, block_model
):
    """Write a NonLinLoc control file for Vel2Grid/Grid2Time."""

    max_x = int(np.ceil(max_dist / dx)) + 5
    max_z = int(np.ceil((depth_span[1] - depth_span[0]) / dx)) + 5
    grid = (f"2 {max_x:d} {max_z:d} 0.0 0.0 {depth_span[0]:f} {dx:f} {dx:f} "
            f"{dx:f}")

    layers = []
    depths, vels = _vmodel_columns(vmodel, phase)
    for i in range(len(depths)):
        if not block_model and i + 1 < len(depths):
            dvdx = (vels[i + 1] - vels[i]) / (depths[i + 1] - depths[i])
        else:
            dvdx = 0.0
        layers.append(
            f"LAYER  {depths[i]:f} {vels[i]:f} {dvdx:f} {vels[i]:f} {dvdx:f} "
            "0.0 0.0"
        )

    cwd = pathlib.Path.cwd()
    out = (
        "CONTROL 0 54321\n"
        "TRANS NONE\n\n"
        f"VGOUT {cwd / 'model' / 'layer'}\n"
        f"VGTYPE {phase}\n\n"
        f"VGGRID {grid} SLOW_LEN\n\n"
        + "\n".join(layers)
        + "\n\n"
        f"GTFILES {cwd / 'model' / 'layer'} {cwd / 'time' / 'layer'} {phase}\n"
        "GTMODE GRID2D ANGLES_NO\n\n"
        f"GTSRCE {station} XYZ {station_xyz[0]:f} {station_xyz[1]:f} "
        f"{station_xyz[2]:f} 0.0\n\n"
        "GT_PLFD 1.0E-3 0"
    )

    with open(cwd / "control.in", "w") as f:
        f.write(out)


_NLL_ELLIPSOIDS = {
    "WGS-84": "WGS84",
    "GRS-80": "GRS80",
    "WGS-72": "WGS72",
    "Australian": "aust_SA",
    "Krasovsky": "krass",
    "International": "intl",
    "Hayford-1909": "intl",
    "Clarke-1880": "clrk80",
    "Clarke-1866": "clrk66",
    "Airy": "airy",
    "Bessel": "bessel",
    "Hayford-1830": "evrst30",
    "Sphere": "sphere",
}


def read_nlloc(path, stations, phases=None, fraction_tt=0.1, save_file=None,
               log=False):
    """
    Import a set of NonLinLoc-format traveltime grids (.hdr/.buf pairs
    named layer.<phase>.<station>.time) into a LUT.

    """

    phases = ["P", "S"] if phases is None else list(phases)
    path = pathlib.Path(path)
    stations = StationTable.of(stations)
    util.logger(pathlib.Path.cwd() / "logs" / "lut", log)

    logging.info("Loading NonLinLoc traveltime lookup tables for...")
    lut = None
    for i, phase in enumerate(phases):
        logging.info(f"\t...phase: {phase}...")
        for j, station in enumerate(stations["Name"]):
            logging.info(f"\t\t...station: {station}")
            file = path / f"layer.{phase}.{station}.time"

            if i == 0 and j == 0:
                gridspec, transform, traveltimes = _read_nlloc(file)
                node_count = np.array(gridspec[0], dtype=int)
                grid_origin = np.array(gridspec[1])
                node_spacing = np.array(gridspec[2])

                gproj, cproj, gproj_string = transform
                if gproj is None:
                    raise NotImplementedError(
                        f"Projection type {gproj_string} not supported."
                    )

                to_coords = Transformer.from_proj(gproj, cproj)
                ll_corner = to_coords.transform(*grid_origin)
                ur_corner = to_coords.transform(
                    *(grid_origin + (node_count - 1) * node_spacing))

                lut = LUT(
                    ll_corner=ll_corner,
                    ur_corner=ur_corner,
                    node_spacing=node_spacing,
                    grid_proj=gproj,
                    coord_proj=cproj,
                    fraction_tt=fraction_tt,
                )
                # The corner round-trip through cproj can land ~1e-13
                # above an exact spacing multiple, and the grid's
                # 1 + ceil(span/spacing) then overcounts by one; the
                # .hdr's node count is authoritative and must match the
                # traveltime array shapes.
                lut.node_count = node_count
            else:
                _, _, traveltimes = _read_nlloc(file)

            lut.traveltimes.setdefault(station, {}).update(
                {phase: traveltimes})

    lut.station_data = stations
    lut.phases = phases

    if save_file is not None:
        lut.save(save_file)

    return lut


def _read_nlloc(fname, ignore_proj=False):
    """Parse a NonLinLoc .hdr/.buf grid pair."""

    header = pathlib.Path(f"{fname}.hdr").read_text().splitlines()
    geometry = header[0].split()
    shape = [int(v) for v in geometry[:3]]
    origin = [float(v) for v in geometry[3:6]]
    steps = [float(v) for v in geometry[6:9]]

    # header[1] is the source (station) line; header[2] the projection
    proj_fields = header[2].split()
    kind = proj_fields[1]
    cproj = Proj(proj="longlat", ellps="WGS84")
    gproj = None
    if kind == "NONE":
        if not ignore_proj:
            logging.info("\tNo projection selected.")
    elif kind == "SIMPLE":
        gproj = Proj(
            proj="eqc", lat_0=float(proj_fields[3]),
            lon_0=float(proj_fields[5]), units="km",
        )
    elif kind == "LAMBERT":
        ellps = _NLL_ELLIPSOIDS.get(proj_fields[3])
        if ellps is None:
            logging.info(
                f"Projection Ellipsoid {proj_fields[3]} not supported! "
                "WGS-84 used instead..."
            )
            ellps = "WGS84"
        gproj = Proj(
            proj="lcc", lon_0=float(proj_fields[7]),
            lat_0=float(proj_fields[5]), lat_1=float(proj_fields[9]),
            lat_2=float(proj_fields[11]), units="km", ellps=ellps,
        )
    elif kind == "TRANS_MERC":
        gproj = Proj(
            proj="tmerc", lon_0=float(proj_fields[7]),
            lat_0=float(proj_fields[5]), units="km",
        )

    tables = np.fromfile(
        f"{fname}.buf", dtype=np.float32, count=int(np.prod(shape))
    ).astype(np.float64).reshape(tuple(shape))
    gridspec = np.array([shape, origin, steps])

    return gridspec, [gproj, cproj, kind], tables


def _velocity_model_of(value):
    """A velocity model carried across: a pandas DataFrame (duck-typed by
    its ``columns``) becomes a :class:`Table`; a Table or a string stays
    as it is."""

    if isinstance(value, (str, Table)):
        return value
    if hasattr(value, "columns"):
        names = [str(name) for name in value.columns]
        return Table({name: np.asarray(value[name]) for name in names}, names)
    return str(value)


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
      and ``velocity_model``: a string, or the velocity model of a table
      built from one (a :class:`~quakemigrate_torch.io.table.Table`, or a
      DataFrame, kept as a Table).

    """

    lut = LUT(fraction_tt=float(state.get("fraction_tt", 0.1)))
    lut.grid_proj = Proj(**dict(state["grid_proj"]))
    lut.coord_proj = Proj(**dict(state["coord_proj"]))
    lut.ll_corner = np.asarray(state["ll_corner"], dtype=float)
    lut.ur_corner = np.asarray(state["ur_corner"], dtype=float)
    lut.node_spacing = state["node_spacing"]
    lut.node_count = state["node_count"]
    lut.phases = list(state.get("phases", ["P", "S"]))
    lut.velocity_model = _velocity_model_of(state.get("velocity_model", ""))
    lut.station_data = StationTable.of(state["stations"])
    lut.traveltimes = {
        station: {phase: np.asarray(table, dtype=np.float64)
                  for phase, table in per_phase.items()}
        for station, per_phase in state["traveltimes"].items()
    }
    return lut
