# -*- coding: utf-8 -*-
"""
The port's coordinates, grid and lookup tables (quakemigrate_torch.coords,
quakemigrate_torch.lut, quakemigrate_torch.io.read_stations) against the
JAX package's:

- the LongLat, TransverseMercator and LambertConformalConic projections,
  forward and inverse, and the geodesic, at 1e-9;
- homogeneous compute_traveltimes equal at 1e-12, on the synthetic grid
  and on the Icequake example's lcc grid (cut to a coarser spacing);
- serve_traveltimes and the port's traveltime_table int32-equal;
- index2coord (forward and inverse) at 1e-9;
- the npz+json LUT file: save and load round-trip;
- lut_from_reference of a JAX .LUT (read with quakemigrate_tpu.io.read_lut)
  equal to the LUT the port builds itself;
- read_stations equal to the JAX reader's table;
- LUT.decimate (copy and in place, with factors that leave the corners
  unmoved), the grid and station extents, the renamed cell_count and
  cell_size, LUT.__add__, io.read_vmodel, the io.core.stations alias and
  the package-level exports, each against the JAX package's.

"""

import pathlib

import numpy as np
import pytest

from quakemigrate_tpu import coords as j_coords
from quakemigrate_tpu.io import read_lut as j_read_lut
from quakemigrate_tpu.io import read_stations as j_read_stations
from quakemigrate_tpu.lut import compute_traveltimes as j_compute_traveltimes
from quakemigrate_torch import coords
from quakemigrate_torch.io import read_lut, read_stations
from quakemigrate_torch.lut import (
    LUT,
    StationTable,
    compute_traveltimes,
    lut_from_reference,
    traveltime_table,
)

import torch_synthetic as ws

REPO = pathlib.Path(__file__).resolve().parents[1]
ICEQUAKE_STATIONS = (REPO / "examples" / "Icequake_Iceland" / "inputs"
                     / "iceland_stations.txt")

# (lon, lat) about which each projection's points are drawn
CENTRES = {"longlat": (-17.222, 64.329), "tmerc": (0.0, 0.0),
           "utm": (-15.0, 64.0), "lcc": (-17.222, 64.329),
           "lcc_1sp": (10.0, 45.0)}
PROJECTIONS = {
    "longlat": dict(proj="longlat", ellps="WGS84"),
    "tmerc": dict(proj="tmerc", units="km", lon_0=0.0, lat_0=0.0,
                  ellps="WGS84"),
    "utm": dict(proj="utm", zone=28, units="m"),
    # the Icequake example's grid projection (iceland_lut.py)
    "lcc": dict(proj="lcc", units="km", lon_0=-17.222, lat_0=64.329,
                lat_1=64.323, lat_2=64.335, datum="WGS84", ellps="WGS84",
                no_defs=True),
    "lcc_1sp": dict(proj="lcc", units="m", lon_0=10.0, lat_0=45.0),
}


@pytest.mark.parametrize("name", sorted(PROJECTIONS))
def test_projection_forward_inverse(name):
    got = coords.Proj(**PROJECTIONS[name])
    ref = j_coords.Proj(**PROJECTIONS[name])
    assert got.definition() == ref.definition()
    rng = np.random.default_rng(1)
    lon = CENTRES[name][0] + rng.uniform(-0.5, 0.5, 200)
    lat = CENTRES[name][1] + rng.uniform(-0.5, 0.5, 200)
    x, y = got.forward(lon, lat)
    xr, yr = ref.forward(lon, lat)
    np.testing.assert_allclose(x, xr, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(y, yr, rtol=1e-9, atol=1e-9)
    lo, la = got.inverse(x, y)
    lor, lar = ref.inverse(xr, yr)
    np.testing.assert_allclose(lo, lor, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(la, lar, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(lo, lon, atol=1e-7)
    np.testing.assert_allclose(la, lat, atol=1e-7)


def test_transformer_and_geodesic():
    p = coords.Proj(**PROJECTIONS["lcc"])
    q = coords.Proj(**PROJECTIONS["longlat"])
    pr = j_coords.Proj(**PROJECTIONS["lcc"])
    qr = j_coords.Proj(**PROJECTIONS["longlat"])
    pts = ([-17.24, -17.21], [64.322, 64.336], [-1.4, 0.0])
    got = coords.Transformer.from_proj(q, p).transform(*pts)
    ref = j_coords.Transformer.from_proj(qr, pr).transform(*pts)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
    for args in [(64.3, -17.2, 64.33, -17.25), (0.0, 0.0, 0.045, 0.03),
                 (10.0, 20.0, -10.0, -160.0)]:
        np.testing.assert_allclose(coords.gps2dist_azimuth(*args),
                                   j_coords.gps2dist_azimuth(*args),
                                   rtol=1e-9, atol=1e-9)


def _icequake_spec(module, spacing):
    """The Icequake example's grid (iceland_lut.py), at ``spacing`` km."""

    return dict(
        ll_corner=[-17.24, 64.322, -1.4], ur_corner=[-17.204, 64.336, 0.0],
        node_spacing=[spacing] * 3,
        grid_proj=module.Proj(**PROJECTIONS["lcc"]),
        coord_proj=module.Proj(proj="longlat", datum="WGS84",
                               ellps="WGS84", no_defs=True),
    )


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    """(port LUT, JAX LUT, JAX .LUT path) on the synthetic grid, and the
    same pair on the Icequake grid at 0.1 km."""

    root = tmp_path_factory.mktemp("torch_lut")
    stations = ws.stations_frame()
    lut_file = root / "synthetic.LUT"
    ref = j_compute_traveltimes(ws.grid_spec(j_coords), stations,
                                method="homogeneous", phases=["P", "S"],
                                vp=ws.VP, vs=ws.VS, save_file=str(lut_file))
    got = compute_traveltimes(ws.grid_spec(coords), StationTable.of(stations),
                              method="homogeneous", phases=["P", "S"],
                              vp=ws.VP, vs=ws.VS)
    ice_ref = j_compute_traveltimes(
        _icequake_spec(j_coords, 0.1), j_read_stations(ICEQUAKE_STATIONS),
        method="homogeneous", phases=["P", "S"], vp=3.630, vs=1.833)
    ice = compute_traveltimes(
        _icequake_spec(coords, 0.1), read_stations(ICEQUAKE_STATIONS),
        method="homogeneous", phases=["P", "S"], vp=3.630, vs=1.833)
    return {"synthetic": (got, ref, lut_file), "icequake": (ice, ice_ref,
                                                          None)}


@pytest.mark.parametrize("case", ["synthetic", "icequake"])
def test_homogeneous_traveltimes_match(luts, case):
    got, ref, _ = luts[case]
    np.testing.assert_array_equal(got.node_count, ref.node_count)
    np.testing.assert_allclose(got.ll_corner, ref.ll_corner, rtol=1e-12)
    np.testing.assert_allclose(got.ur_corner, ref.ur_corner, rtol=1e-12)
    assert list(got.traveltimes) == list(ref.traveltimes)
    for station, per_phase in ref.traveltimes.items():
        for phase, table in per_phase.items():
            np.testing.assert_allclose(got[station][phase], table,
                                       rtol=1e-12, atol=0)
    assert got.max_traveltime == pytest.approx(ref.max_traveltime,
                                               rel=1e-12)
    assert got.velocity_model == ref.velocity_model


@pytest.mark.parametrize("case", ["synthetic", "icequake"])
@pytest.mark.parametrize("rate", [100, 250])
def test_serve_traveltimes_and_table_int32_equal(luts, case, rate):
    got, ref, _ = luts[case]
    served = got.serve_traveltimes(rate)
    np.testing.assert_array_equal(served, ref.serve_traveltimes(rate))
    assert served.dtype == np.int32
    names = ref.station_data["Name"].values
    tables = [got[st][ph] for ph in ("P", "S") for st in names]
    np.testing.assert_array_equal(traveltime_table(tables, rate),
                                  served.reshape(-1, served.shape[-1]))
    avail = {f"{st}_{ph}": int(i % 3 != 0) for i, (st, ph) in
             enumerate((st, ph) for ph in ("P", "S") for st in names)}
    np.testing.assert_array_equal(got.serve_traveltimes(rate, avail),
                                  ref.serve_traveltimes(rate, avail))


@pytest.mark.parametrize("case", ["synthetic", "icequake"])
def test_index2coord_matches(luts, case):
    got, ref, _ = luts[case]
    rng = np.random.default_rng(2)
    idx = rng.integers(0, got.n_nodes, 64)
    np.testing.assert_allclose(got.index2coord(idx, unravel=True),
                               ref.index2coord(idx, unravel=True),
                               rtol=1e-9, atol=1e-9)
    ijk = np.column_stack(np.unravel_index(idx, got.node_count))
    xyz = got.index2coord(ijk)
    np.testing.assert_allclose(xyz, ref.index2coord(ijk), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_array_equal(got.index2coord(xyz, inverse=True),
                                  ref.index2coord(xyz, inverse=True))
    np.testing.assert_array_equal(got.index2coord(xyz, inverse=True), ijk)
    np.testing.assert_allclose(got.stations_xyz, ref.stations_xyz,
                               rtol=1e-9, atol=1e-9)
    assert got.unit_conversion_factor == ref.unit_conversion_factor


def _assert_luts_equal(a, b):
    assert a == b
    np.testing.assert_array_equal(a.node_count, b.node_count)
    np.testing.assert_array_equal(a.node_spacing, b.node_spacing)
    np.testing.assert_array_equal(a.ll_corner, b.ll_corner)
    np.testing.assert_array_equal(a.ur_corner, b.ur_corner)
    assert a.phases == b.phases and a.fraction_tt == b.fraction_tt
    assert a.station_data == b.station_data
    assert list(a.traveltimes) == list(b.traveltimes)
    for station, per_phase in a.traveltimes.items():
        assert list(per_phase) == list(b.traveltimes[station])
        for phase, table in per_phase.items():
            np.testing.assert_array_equal(table, b[station][phase])


@pytest.mark.parametrize("case", ["synthetic", "icequake"])
def test_lut_file_round_trip(luts, case, tmp_path):
    got, _, _ = luts[case]
    path = tmp_path / "sub" / "port.LUT"
    got.save(path)
    assert path.is_file()
    back = read_lut(path)
    _assert_luts_equal(back, got)
    assert back.velocity_model == got.velocity_model
    assert back.grid_proj.definition() == got.grid_proj.definition()
    assert str(back) == str(got)
    np.testing.assert_array_equal(LUT(lut_file=path).serve_traveltimes(250),
                                  got.serve_traveltimes(250))


def test_lut_file_refuses_other_formats(tmp_path):
    path = tmp_path / "other.npz"
    np.savez(path, meta=np.array('{"format": "something else"}'))
    with pytest.raises(ValueError, match="is not a"):
        read_lut(path)


def test_lut_from_reference_equals_port_lut(luts):
    got, _, lut_file = luts["synthetic"]
    carried = lut_from_reference(ws.reference_state(j_read_lut(lut_file)))
    _assert_luts_equal(carried, got)
    np.testing.assert_array_equal(carried.index2coord([[1, 2, 3]]),
                                  got.index2coord([[1, 2, 3]]))


def test_read_stations_matches():
    got = read_stations(ICEQUAKE_STATIONS)
    ref = j_read_stations(ICEQUAKE_STATIONS)
    assert len(got) == len(ref) == 13
    for col in StationTable.COLUMNS:
        np.testing.assert_array_equal(got[col], ref[col].to_numpy())


def test_read_stations_refuses_bad_header(tmp_path):
    path = tmp_path / "stations.txt"
    path.write_text("Lat,Lon,Elevation,Name\n1,2,3,AB\n")
    from quakemigrate_torch.util import StationFileHeaderException

    with pytest.raises(StationFileHeaderException):
        read_stations(path)


# -- host leftovers the example scripts call: decimate, extents, aliases,
# __add__, read_vmodel, the package exports ---------------------------------

@pytest.mark.parametrize("case", ["synthetic", "icequake"])
@pytest.mark.parametrize("df", [[2, 2, 2], [3, 2, 4], [1, 5, 3]])
def test_decimate_matches_jax(luts, case, df):
    """Against the JAX LUT.decimate: the node counts, spacings, tables and
    node coordinates, including factors where (count - 1) % df != 0,
    whose corners the reference does not move (index 0 stays at the
    original lower-left corner); the tables contiguous; the original
    untouched."""

    got, ref, _ = luts[case]
    before = {st: {ph: t.copy() for ph, t in per.items()}
              for st, per in got.traveltimes.items()}
    small, ref_small = got.decimate(df), ref.decimate(df)
    np.testing.assert_array_equal(small.node_count, ref_small.node_count)
    np.testing.assert_array_equal(small.node_spacing, ref_small.node_spacing)
    np.testing.assert_array_equal(small.ll_corner, got.ll_corner)
    np.testing.assert_array_equal(small.ll_corner, ref_small.ll_corner)
    for station, per_phase in ref_small.traveltimes.items():
        for phase, table in per_phase.items():
            assert small[station][phase].flags.c_contiguous
            np.testing.assert_array_equal(small[station][phase], table)
            np.testing.assert_array_equal(got[station][phase],
                                          before[station][phase])
    idx = np.arange(0, small.n_nodes, 7)
    np.testing.assert_allclose(small.index2coord(idx, unravel=True),
                               ref_small.index2coord(idx, unravel=True),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(small.index2coord([[0, 0, 0]]),
                               got.index2coord([[0, 0, 0]]), rtol=1e-12)
    np.testing.assert_array_equal(small.serve_traveltimes(100),
                                  ref_small.serve_traveltimes(100))
    assert small.max_traveltime == pytest.approx(ref_small.max_traveltime,
                                                 rel=1e-12)


def test_decimate_quirk_offset_shifts_nodes(luts):
    """A count with (count - 1) % df != 0: the kept nodes start one node
    in, yet index 0 still maps to the original corner, so the decimated
    node 0's traveltimes are those of original node (1, 1, 1)."""

    got, ref, _ = luts["synthetic"]
    counts, df = got.node_count, [3, 3, 3]
    offsets = (counts - np.array(df) * ((counts - 1) // df) - 1) // 2
    assert (offsets > 0).any()
    small = got.decimate(df)
    station = got.station_data["Name"][0]
    np.testing.assert_array_equal(small[station]["P"][0, 0, 0],
                                  got[station]["P"][tuple(offsets)])
    np.testing.assert_array_equal(
        small[station]["P"], ref.decimate(df)[station]["P"])


def test_decimate_inplace_matches_jax(luts):
    """In place, as the Askja example's detect script calls it: on copies
    of the module's LUTs (decimate by 1 copies)."""

    got, ref = (lut.decimate([1, 1, 1]) for lut in luts["icequake"][:2])
    assert got.decimate([2, 2, 2], inplace=True) is None
    assert ref.decimate([2, 2, 2], inplace=True) is None
    np.testing.assert_array_equal(got.node_count, ref.node_count)
    for station, per_phase in ref.traveltimes.items():
        for phase, table in per_phase.items():
            np.testing.assert_array_equal(got[station][phase], table)


@pytest.mark.parametrize("case", ["synthetic", "icequake"])
def test_extents_match_jax(luts, case):
    got, ref, _ = luts[case]
    for cells in (False, True):
        np.testing.assert_allclose(got.get_grid_extent(cells=cells),
                                   ref.get_grid_extent(cells=cells),
                                   rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.grid_extent, ref.grid_extent, rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(got.station_extent, ref.station_extent,
                               rtol=1e-12)
    np.testing.assert_allclose(got.max_extent, ref.max_extent, rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("alias, attr, value", [
    ("cell_count", "node_count", [5, 6, 7]),
    ("cell_size", "node_spacing", [0.5, 0.5, 0.25]),
    ("cell_size", "node_spacing", None),
])
def test_renamed_grid_parameters_match_jax(luts, capsys, alias, attr,
                                           value):
    got, ref, _ = luts["synthetic"]
    got, ref = got.decimate([1, 1, 1]), ref.decimate([1, 1, 1])
    setattr(ref, alias, value)
    want = capsys.readouterr().out
    setattr(got, alias, value)
    assert capsys.readouterr().out == want
    np.testing.assert_array_equal(getattr(got, attr), getattr(ref, attr))
    np.testing.assert_array_equal(getattr(got, alias), getattr(ref, alias))


def test_add_matches_jax(luts, capsys):
    """Merging the tables of a LUT on the same grid; other grids and
    non-LUTs refused with the reference's messages and return values."""

    got, ref, _ = luts["synthetic"]
    a, b = got.decimate([1, 1, 1]), got.decimate([1, 1, 1])
    ja, jb = ref.decimate([1, 1, 1]), ref.decimate([1, 1, 1])
    for lut in (b, jb):
        lut.traveltimes = {"NEW": lut.traveltimes["ST00"]}
    merged, j_merged = a + b, ja + jb
    assert merged is a and j_merged is ja
    assert list(merged.traveltimes) == list(j_merged.traveltimes)
    assert "NEW" in merged.traveltimes
    capsys.readouterr()
    j_other = ja + ref.decimate([2, 2, 2])
    j_out = capsys.readouterr().out
    assert (a + got.decimate([2, 2, 2])) is None and j_other is None
    assert capsys.readouterr().out == j_out
    assert (a + 3) is a and (ja + 3) is ja
    assert "Addition not defined" in capsys.readouterr().out


def test_read_vmodel_matches_jax(tmp_path):
    from quakemigrate_tpu.io import read_vmodel as j_read_vmodel
    from quakemigrate_tpu.util import (
        InvalidVelocityModelHeader as JInvalidVelocityModelHeader,
    )
    from quakemigrate_torch.io import read_vmodel
    from quakemigrate_torch.util import InvalidVelocityModelHeader

    path = tmp_path / "vmodel.txt"
    path.write_text("Depth,Vp,Vs,Name\n-2,3.5,2.0,top\n0,4.25,2.4,a\n"
                    "3,5.8,3.36,b\n10,6.5,3.75,c\n")
    got, ref = read_vmodel(path), j_read_vmodel(path)
    assert got.names == list(ref.columns)
    for name in ref.columns:
        want = ref[name].to_numpy()
        assert got[name].dtype.kind == want.dtype.kind or (
            want.dtype == object), name
        np.testing.assert_array_equal(got[name], want)
    bad = tmp_path / "bad.txt"
    bad.write_text("Z,Vp\n0,4\n")
    with pytest.raises(JInvalidVelocityModelHeader) as j_err:
        j_read_vmodel(bad)
    with pytest.raises(InvalidVelocityModelHeader) as err:
        read_vmodel(bad)
    assert str(err.value) == str(j_err.value)


def test_stations_alias_matches_jax(capsys):
    from quakemigrate_tpu.io.core import stations as j_stations
    from quakemigrate_torch.io.core import stations

    ref = j_stations(ICEQUAKE_STATIONS)
    want = capsys.readouterr().out
    got = stations(ICEQUAKE_STATIONS)
    assert capsys.readouterr().out == want and "read_stations" in want
    for col in StationTable.COLUMNS:
        np.testing.assert_array_equal(got[col], ref[col].to_numpy())


def test_package_exports_match_jax():
    import quakemigrate_tpu
    import quakemigrate_torch
    from quakemigrate_torch import io, lut

    for name, where in (("Archive", io), ("read_lut", io),
                        ("read_stations", io), ("LUT", lut),
                        ("compute_traveltimes", lut)):
        assert hasattr(quakemigrate_tpu, name)
        assert getattr(quakemigrate_torch, name) is getattr(where, name)
