# -*- coding: utf-8 -*-
"""
The port's traveltime builders (``quakemigrate_torch.lut.create``) and its
fast-marching solver (``quakemigrate_torch.core.fast_marching``, the
port's own build of ``csrc/host/fmmlib.c``) against the JAX package's, on
seeded inputs and the Volcanotectonic_Iceland example's velocity model on
a coarse copy of its grid:

- fast_marching bit for bit JAX's on 1-D, 2-D and 3-D grids at orders 1
  and 2 (the same C source, compiled with the same flags);
- the 1dfmm, 3dfmm and 1dsweep tables bit for bit JAX's (the same numpy
  and scipy code around the same solver), with in-grid stations for
  1dfmm and 3dfmm and the example's stations, some outside the grid, for
  1dsweep;
- the refusals and their texts; _write_control_file's text; 1dnlloc
  raising without the NonLinLoc binaries, and with stand-in binaries
  (a Grid2Time of straight rays) equal to JAX's;
- read_nlloc on .hdr/.buf pairs the test writes, equal to JAX's;
- lut_from_reference of a 1dsweep LUT, and LUT.save / read_lut of it.

"""

import logging
import pathlib

import numpy as np
import pandas as pd
import pytest
import torch

import quakemigrate_tpu.io as j_io
import quakemigrate_tpu.lut as j_lut
import quakemigrate_tpu.util as j_util
from quakemigrate_tpu.coords import Proj as JProj
from quakemigrate_tpu.core import fast_marching as j_fast_marching
from quakemigrate_tpu.lut import create as j_create
import quakemigrate_torch.io as t_io
import quakemigrate_torch.lut as t_lut
import quakemigrate_torch.util as t_util
from quakemigrate_torch.coords import Proj as TProj
from quakemigrate_torch.core import fast_marching
from quakemigrate_torch.io.table import Table
from quakemigrate_torch.lut import create as t_create

torch.set_num_threads(1)

VT_INPUTS = (pathlib.Path(__file__).resolve().parents[1] / "examples"
             / "Volcanotectonic_Iceland" / "inputs")
VMODEL = VT_INPUTS / "iceland_vmodel.txt"
STATIONS = VT_INPUTS / "iceland_stations.txt"


def _grid_spec(proj, spacing=2.0):
    """The example's grid (dike_intrusion_lut.py) at a coarse spacing."""

    return dict(
        ll_corner=[-17.2, 64.7, -2.0], ur_corner=[-16.6, 64.95, 16.0],
        node_spacing=[spacing] * 3,
        grid_proj=proj(proj="lcc", units="km", lon_0=-16.9, lat_0=64.8,
                       lat_1=64.7, lat_2=64.9, datum="WGS84", ellps="WGS84",
                       no_defs=True),
        coord_proj=proj(proj="longlat", datum="WGS84", ellps="WGS84",
                        no_defs=True),
    )


# Four stations inside the grid (Elevation positive down, as read)
IN_GRID = {"Name": ["IN1", "IN2", "IN3", "IN4"],
           "Latitude": [64.75, 64.8, 64.9, 64.85],
           "Longitude": [-17.1, -16.9, -16.7, -17.0],
           "Elevation": [-0.5, -0.2, 0.3, 1.5]}


def _both_stations(columns):
    return pd.DataFrame(columns), t_lut.StationTable(columns)


def _jax_build(stations, method, **kwargs):
    return j_lut.compute_traveltimes(_grid_spec(JProj), stations, method,
                                     phases=["P", "S"], **kwargs)


def _port_build(stations, method, **kwargs):
    return t_lut.compute_traveltimes(_grid_spec(TProj), stations, method,
                                     phases=["P", "S"], **kwargs)


def _assert_tables_equal(port, jax):
    assert list(port.traveltimes) == list(jax.traveltimes)
    assert np.array_equal(port.node_count, jax.node_count)
    for station, phases in jax.traveltimes.items():
        assert list(port.traveltimes[station]) == list(phases)
        for phase, table in phases.items():
            assert port.traveltimes[station][phase].shape == table.shape
            assert np.array_equal(port.traveltimes[station][phase], table), (
                station, phase)


# -- the solver ---------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("shape,spacing,source", [
    ((40,), (0.5,), (7.3,)),
    ((25, 18), (0.5, 0.25), (3.2, 11.0)),
    ((14, 11, 9), (1.0, 0.5, 0.75), (6.6, 0.0, 4.4)),
])
def test_fast_marching_bit_equal(shape, spacing, source, order):
    velocity = np.random.default_rng(len(shape)).uniform(1.5, 7.0, shape)
    got = fast_marching(velocity, spacing, source, order=order)
    want = j_fast_marching(velocity, spacing, source, order=order)
    assert got.shape == shape and got.dtype == np.float64
    assert np.array_equal(got, want)


def test_fast_marching_needs_the_host_library(monkeypatch):
    from quakemigrate_torch import _build
    from quakemigrate_torch import core

    monkeypatch.setattr(_build, "BUILD_DIR", pathlib.Path("/nonexistent"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    core._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="fmmlib.c"):
            fast_marching(np.ones(5), [1.0], [0.0])
    finally:
        core._lib.cache_clear()


# -- the builders ----------------------------------------------------------------

def test_1dfmm_equals_jax():
    j_st, t_st = _both_stations(IN_GRID)
    jax = _jax_build(j_st, "1dfmm", vmod=j_io.read_vmodel(VMODEL))
    port = _port_build(t_st, "1dfmm", vmod=t_io.read_vmodel(VMODEL))
    _assert_tables_equal(port, jax)
    assert isinstance(port.velocity_model, Table)


def test_3dfmm_equals_jax():
    j_st, t_st = _both_stations(IN_GRID)
    probe = _port_build(t_st, "homogeneous", vp=5.0, vs=3.0)
    rng = np.random.default_rng(3)
    depth = probe.grid_xyz[2]
    vmod_3d = {"P": 4.0 + 0.2 * depth + rng.uniform(0, 0.3, depth.shape)}
    vmod_3d["S"] = vmod_3d["P"] / 1.76
    jax = _jax_build(j_st, "3dfmm", vmod_3d=vmod_3d)
    port = _port_build(t_st, "3dfmm", vmod_3d=vmod_3d)
    _assert_tables_equal(port, jax)
    assert port.velocity_model == jax.velocity_model


@pytest.mark.parametrize("options", [
    {"sweep_dx": 0.5}, {"nlloc_dx": 0.4, "block_model": True}, {}])
def test_1dsweep_equals_jax(options):
    j_st, t_st = j_io.read_stations(STATIONS), t_io.read_stations(STATIONS)
    jax = _jax_build(j_st, "1dsweep", vmod=j_io.read_vmodel(VMODEL),
                     **options)
    port = _port_build(t_st, "1dsweep", vmod=t_io.read_vmodel(VMODEL),
                       **options)
    outside = ((port.stations_xyz < port.ll_corner)
               | (port.stations_xyz > port.ur_corner)).any(axis=1)
    assert outside.any() and not outside.all()
    _assert_tables_equal(port, jax)


def test_homogeneous_still_equals_jax():
    j_st, t_st = j_io.read_stations(STATIONS), t_io.read_stations(STATIONS)
    jax = _jax_build(j_st, "homogeneous", vp=5.2, vs=2.921)
    port = _port_build(t_st, "homogeneous", vp=5.2, vs=2.921)
    _assert_tables_equal(port, jax)
    assert port.velocity_model == jax.velocity_model


def _error(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001 -- the error is the result
        return type(err).__name__, str(err)
    raise AssertionError("no error raised")


@pytest.mark.parametrize("method,stations,kwargs", [
    ("2dfmm", IN_GRID, {}),
    ("1dfmm", "example", {"vmod": True}),
    ("1dfmm", IN_GRID, {}),
    ("1dsweep", IN_GRID, {}),
    ("1dnlloc", IN_GRID, {}),
    ("3dfmm", IN_GRID, {}),
    ("3dfmm", IN_GRID, {"vmod_3d": {"P": np.ones((3, 3, 3)),
                                    "S": np.ones((3, 3, 3))}}),
    ("homogeneous", IN_GRID, {"vp": 5.0}),
    ("1dnlloc", IN_GRID, {"vmod": True}),
])
def test_refusals_match_jax(monkeypatch, method, stations, kwargs):
    monkeypatch.setattr("shutil.which", lambda name: None)
    if stations == "example":
        j_st, t_st = (j_io.read_stations(STATIONS),
                      t_io.read_stations(STATIONS))
    else:
        j_st, t_st = _both_stations(stations)
    j_kwargs, t_kwargs = dict(kwargs), dict(kwargs)
    if kwargs.get("vmod"):
        j_kwargs["vmod"] = j_io.read_vmodel(VMODEL)
        t_kwargs["vmod"] = t_io.read_vmodel(VMODEL)
    want = _error(lambda: _jax_build(j_st, method, **j_kwargs))
    got = _error(lambda: _port_build(t_st, method, **t_kwargs))
    assert got == want


def test_vmodel_without_the_phase_column(tmp_path):
    path = tmp_path / "vp_only.txt"
    path.write_text("Depth,Vp\n0.0,4.0\n10.0,6.0\n")
    j_st, t_st = _both_stations(IN_GRID)
    with pytest.raises(j_util.InvalidVelocityModelHeader) as want:
        _jax_build(j_st, "1dfmm", vmod=j_io.read_vmodel(path))
    with pytest.raises(t_util.InvalidVelocityModelHeader) as got:
        _port_build(t_st, "1dfmm", vmod=t_io.read_vmodel(path))
    assert str(got.value) == str(want.value)


def test_log_writes_a_lut_log(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, t_st = _both_stations(IN_GRID)
    _port_build(t_st, "homogeneous", vp=5.0, vs=3.0, log=True)
    logging.shutdown()
    assert list((tmp_path / "logs").glob("lut_*.log"))


def test_write_control_file_equals_jax(tmp_path, monkeypatch):
    texts = []
    for create, read_vmodel in ((j_create, j_io.read_vmodel),
                                (t_create, t_io.read_vmodel)):
        for block_model in (False, True):
            monkeypatch.chdir(tmp_path)
            create._write_control_file(
                np.array([1.25, -3.5, -0.75]), "ST01", 42.123,
                read_vmodel(VMODEL), [-2.0, 16.0], "S", 0.1, block_model)
            texts.append((tmp_path / "control.in").read_text())
    assert texts[:2] == texts[2:]
    assert texts[0] != texts[1]
    assert "GTSRCE ST01 XYZ 1.250000 -3.500000 -0.750000 0.0" in texts[2]


_GRID2TIME = r"""#!{python}
# A stand-in for NonLinLoc's Grid2Time: the 2-D (offset, depth) table of
# the control file's VGGRID at the first layer's velocity, straight rays
import pathlib
import numpy as np

lines = pathlib.Path("control.in").read_text().splitlines()
fields = dict((ln.split()[0], ln.split()[1:]) for ln in lines if ln.strip())
_, nx, nz, _, _, z0, dx, _, _ = fields["VGGRID"][:9]
nx, nz, z0, dx = int(nx), int(nz), float(z0), float(dx)
station, _, _, _, zs = fields["GTSRCE"][:5]
velocity = float(next(ln.split()[2] for ln in lines
                      if ln.startswith("LAYER")))
r = np.arange(nx)[:, None] * dx
z = z0 + np.arange(nz)[None, :] * dx
table = np.hypot(r, z - float(zs)) / velocity
stem = pathlib.Path(fields["GTFILES"][1]).with_name(
    f"layer.{{fields['GTFILES'][2]}}.{{station}}.time")
stem.with_name(stem.name + ".hdr").write_text(
    f"1 {{nx}} {{nz}} 0.0 0.0 {{z0}} {{dx}} {{dx}} {{dx}} TIME\n"
    f"{{station}} 0.0 0.0 {{zs}}\nTRANSFORM  NONE\n")
table.astype(np.float32)[None].tofile(str(stem) + ".buf")
"""


def test_1dnlloc_with_stand_in_binaries_equals_jax(tmp_path, monkeypatch):
    import stat
    import sys

    tools = tmp_path / "nlloc"
    tools.mkdir()
    (tools / "Vel2Grid").write_text(f"#!{sys.executable}\n")
    (tools / "Grid2Time").write_text(_GRID2TIME.format(
        python=sys.executable))
    for tool in ("Vel2Grid", "Grid2Time"):
        (tools / tool).chmod(stat.S_IRWXU)
    j_st, t_st = _both_stations(IN_GRID)
    luts = []
    for build, read_vmodel, st in ((_jax_build, j_io.read_vmodel, j_st),
                                   (_port_build, t_io.read_vmodel, t_st)):
        work = tmp_path / f"run{len(luts)}"
        work.mkdir()
        monkeypatch.chdir(work)
        luts.append(build(st, "1dnlloc", vmod=read_vmodel(VMODEL),
                          nlloc_path=str(tools), nlloc_dx=0.5))
        assert not list((work / "time").iterdir())
        assert not (work / "control.in").exists()
    _assert_tables_equal(luts[1], luts[0])


# -- read_nlloc -----------------------------------------------------------------

_PROJECTIONS = {
    "LAMBERT": "TRANSFORM  LAMBERT RefEllipsoid WGS-84  LatOrig 64.800000  "
               "LongOrig -16.900000  FirstStdParal 64.700000  "
               "SecondStdParal 64.900000  RotCW 0.000000",
    "SIMPLE": "TRANSFORM  SIMPLE LatOrig 64.800000  LongOrig -16.900000  "
              "RotCW 0.000000",
    "TRANS_MERC": "TRANSFORM  TRANS_MERC RefEllipsoid WGS-84  LatOrig "
                  "64.800000  LongOrig -16.900000  RotCW 0.000000",
    "NONE": "TRANSFORM  NONE",
}


def _write_nlloc(root, kind, shape=(6, 5, 4)):
    rng = np.random.default_rng(7)
    for phase in ("P", "S"):
        for station in IN_GRID["Name"]:
            stem = root / f"layer.{phase}.{station}.time"
            stem.with_name(stem.name + ".hdr").write_text(
                f"{shape[0]} {shape[1]} {shape[2]}  -10.000000 -8.000000 "
                "-1.000000  2.000000 2.000000 1.500000 TIME\n"
                f"{station} 0.000000 0.000000 0.000000\n"
                f"{_PROJECTIONS[kind]}\n")
            rng.uniform(0, 9, shape).astype(np.float32).tofile(
                str(stem) + ".buf")


@pytest.mark.parametrize("kind", ["LAMBERT", "SIMPLE", "TRANS_MERC"])
def test_read_nlloc_equals_jax(tmp_path, kind):
    _write_nlloc(tmp_path, kind)
    j_st, t_st = _both_stations(IN_GRID)
    jax = j_lut.read_nlloc(tmp_path, j_st)
    port = t_lut.read_nlloc(tmp_path, t_st, save_file=tmp_path / "n.LUT")
    _assert_tables_equal(port, jax)
    assert port.node_count.tolist() == [6, 5, 4]
    np.testing.assert_array_equal(port.ll_corner, jax.ll_corner)
    np.testing.assert_array_equal(port.ur_corner, jax.ur_corner)
    np.testing.assert_array_equal(port.node_spacing, jax.node_spacing)
    assert port.grid_proj.definition() == jax.grid_proj.definition()
    assert port.station_data == t_st and port.phases == ["P", "S"]
    _assert_tables_equal(t_io.read_lut(tmp_path / "n.LUT"), jax)


def test_read_nlloc_refuses_no_projection(tmp_path):
    _write_nlloc(tmp_path, "NONE")
    j_st, t_st = _both_stations(IN_GRID)
    want = _error(lambda: j_lut.read_nlloc(tmp_path, j_st))
    assert _error(lambda: t_lut.read_nlloc(tmp_path, t_st)) == want


# -- carrying a 1dsweep LUT across, and the port's file -----------------------------

@pytest.fixture(scope="module")
def sweep_luts():
    jax = _jax_build(j_io.read_stations(STATIONS), "1dsweep",
                     vmod=j_io.read_vmodel(VMODEL), sweep_dx=0.5)
    port = _port_build(t_io.read_stations(STATIONS), "1dsweep",
                       vmod=t_io.read_vmodel(VMODEL), sweep_dx=0.5)
    return jax, port


def _assert_vmodel_equal(table, frame):
    assert isinstance(table, Table)
    assert table.names == list(frame.columns)
    for name in table.names:
        np.testing.assert_array_equal(table[name], frame[name].to_numpy())


def test_lut_from_reference_of_a_1dsweep_lut(sweep_luts):
    jax, port = sweep_luts
    state = {
        "ll_corner": np.asarray(jax.ll_corner),
        "ur_corner": np.asarray(jax.ur_corner),
        "node_spacing": np.asarray(jax.node_spacing),
        "node_count": np.asarray(jax.node_count),
        "grid_proj": jax.grid_proj.definition(),
        "coord_proj": jax.coord_proj.definition(),
        "stations": {c: jax.station_data[c].to_numpy()
                     for c in ("Name", "Latitude", "Longitude", "Elevation")},
        "traveltimes": jax.traveltimes, "phases": list(jax.phases),
        "fraction_tt": jax.fraction_tt,
        "velocity_model": jax.velocity_model,
    }
    carried = t_lut.lut_from_reference(state)
    _assert_tables_equal(carried, jax)
    _assert_vmodel_equal(carried.velocity_model, jax.velocity_model)
    np.testing.assert_array_equal(carried.max_traveltime, port.max_traveltime)
    assert carried == port


def test_save_and_read_lut_of_a_1dsweep_lut(sweep_luts, tmp_path):
    jax, port = sweep_luts
    port.save(tmp_path / "sweep.LUT")
    back = t_io.read_lut(tmp_path / "sweep.LUT")
    _assert_tables_equal(back, jax)
    _assert_vmodel_equal(back.velocity_model, jax.velocity_model)
    assert back.velocity_model["Depth"].dtype == np.float64
    assert str(back) == str(port)
    assert "Depth" in str(back) and "7.133" in str(back)
