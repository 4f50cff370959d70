# -*- coding: utf-8 -*-
"""
The port's QuakeScan(mesh=...) on a mesh of 8 CPU devices
(``parallel.make_mesh([torch.device("cpu")] * 8)``), on the setup of
tests/test_scan_mesh.py (8 stations, a 2 km grid, tile 64), against the
port's run with no mesh and against the JAX package's run on its 8
virtual CPU devices (tests/conftest.py):

- detect on the standard path, on the fused STA/LTA window, on the 2-D
  ("batch", "grid") mesh with batched fused windows, and on the fused
  kurtosis window: COA, X, Y and Z equal, COA_N within 1 count on under
  5 % of the samples (the cross-slab sum rounds in its own order), as
  tests/test_scan_mesh.py holds the JAX mesh to its single device;
- the cache of a QuakeScan rebuilt on a change of window geometry;
- locate: the .event's DT, X, Y, Z, Gaussian and covariance columns as
  tests/test_scan_mesh.py holds them;
- a mesh of an absent CUDA device, and ``device`` and ``mesh``
  disagreeing, raise.

"""

import csv

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from quakemigrate_tpu import QuakeScan as JQuakeScan
from quakemigrate_tpu import compute_traveltimes
from quakemigrate_tpu.coords import Proj
from quakemigrate_tpu.io import Archive as JArchive
from quakemigrate_tpu.parallel import make_mesh as j_make_mesh
from quakemigrate_tpu.signal import onsets as j_onsets
from quakemigrate_tpu.synthetics import (
    GaussianDerivativeWavelet,
    simulate_waveforms,
)
from quakemigrate_torch.io import Archive, Run
from quakemigrate_torch.lut import StationTable, lut_from_reference
from quakemigrate_torch.parallel import Mesh, make_mesh
from quakemigrate_torch.signal import QuakeScan
from quakemigrate_torch.signal import onsets

import torch_synthetic as ws

torch.set_num_threads(1)

SPS = 100
SPAN = ("2021-02-18T12:00:20.0", "2021-02-18T12:00:40.0")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """tests/test_scan_mesh.py's setup; the port's LUT carried across
    from the JAX one."""

    root = tmp_path_factory.mktemp("torch_meshscan")
    grid_spec = dict(
        ll_corner=[-0.06, -0.06, 0.0], ur_corner=[0.06, 0.06, 20.0],
        node_spacing=[2.0, 2.0, 2.0],
        grid_proj=Proj(proj="tmerc", units="km", lon_0=0.0, lat_0=0.0),
        coord_proj=Proj(proj="longlat"),
    )
    angles = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    stations = pd.DataFrame({
        "Name": [f"ST{i:02d}" for i in range(8)],
        "Longitude": 0.045 * np.cos(angles),
        "Latitude": 0.045 * np.sin(angles),
        "Elevation": np.zeros(8),
    })
    lut = compute_traveltimes(grid_spec, stations, method="homogeneous",
                              phases=["P", "S"], vp=5.0, vs=3.0)
    stream = simulate_waveforms(
        GaussianDerivativeWavelet(4.0, SPS, 30.0), [0.0, 0.0, 12.0], lut,
        magnitude=2.0, angle_of_incidence=80, rng=np.random.default_rng(7))
    day_dir = root / "mSEED" / "2021" / "049"
    day_dir.mkdir(parents=True)
    for tr in stream:
        tr.write(str(day_dir / f"{tr.stats.station}_{tr.stats.channel[-1]}.m"),
                 format="MSEED")
    return {"root": root, "stations": stations, "lut": lut,
            "port_lut": lut_from_reference(ws.reference_state(lut))}


def _onset(module, kind="classic"):
    if kind == "kurtosis":
        onset = module.KurtosisOnset(sampling_rate=SPS)
        onset.phases = ["P", "S"]
        onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
        return onset
    onset = module.STALTAOnset(position=kind, sampling_rate=SPS)
    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
    onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
    return onset


def _port_scan(setup, name, mesh, kind="classic", **options):
    archive = Archive(setup["root"] / "mSEED",
                      StationTable.of(setup["stations"]),
                      archive_format="YEAR/JD/STATION")
    if mesh is None:
        options["device"] = "cpu"
    return QuakeScan(archive, setup["port_lut"], _onset(onsets, kind),
                     str(setup["root"] / "runs"), name, mesh=mesh,
                     marginal_window=1.0, tile=64, **options)


def _jax_scan(setup, name, mesh, kind="classic", **options):
    archive = JArchive(archive_path=setup["root"] / "mSEED",
                       stations=setup["stations"],
                       archive_format="YEAR/JD/STATION")
    return JQuakeScan(archive, setup["lut"], onset=_onset(j_onsets, kind),
                      run_path=str(setup["root"] / "runs"), run_name=name,
                      marginal_window=1.0, mesh=mesh, tile=64,
                      compilation_cache=False, **options)


def _cpu_mesh(shape=None):
    if shape is None:
        return make_mesh([CPU] * 8)
    return make_mesh([CPU] * 8, axis_names=("batch", "grid"), shape=shape)


def _jax_mesh(shape=None):
    if shape is None:
        return j_make_mesh(jax.devices())
    return j_make_mesh(jax.devices(), axis_names=("batch", "grid"),
                       shape=shape)


def _counts(setup, name):
    return ws.scanmseed_counts(setup["root"] / "runs" / name)


def _assert_mesh_close(got, want, coa_counts=0):
    """X, Y and Z equal; COA_N within 1 count, on under 5 % of the
    samples (tests/test_scan_mesh.py:101-105); COA equal, or with
    ``coa_counts`` 1 within 1 count on under 1 % of the samples."""

    assert sorted(got) == sorted(want)
    for name in ("X", "Y", "Z"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name, counts, share in (("COA", coa_counts, 0.01),
                                ("COA_N", 1, 0.05)):
        diff = np.abs(got[name] - want[name])
        assert diff.max() <= counts, name
        assert (diff != 0).mean() < share, name


def _assert_runs(runs):
    """The mesh run against the port's single device run (COA, X, Y, Z
    equal) and against the JAX package's mesh run: there the front ends
    of the two packages round a window's onsets apart now and then, which
    moves COA by 1 count at a few samples, as between the unsharded runs
    (the standard path's parity tests allow a count or 1e-5)."""

    _assert_mesh_close(runs["mesh"], runs["single"])
    _assert_mesh_close(runs["mesh"], runs["jax"], coa_counts=1)


def _detect_three(setup, tag, kind="classic", span=SPAN, shape=None,
                  **options):
    """The port's detect with the mesh and without, and the JAX
    package's with its mesh; returns their .scanmseed counts."""

    _port_scan(setup, f"{tag}_single", None, kind, timestep=5.0,
               **options).detect(*span)
    scan = _port_scan(setup, f"{tag}_mesh", _cpu_mesh(shape), kind,
                      timestep=5.0, **options)
    scan.detect(*span)
    _jax_scan(setup, f"{tag}_jax", _jax_mesh(shape), kind, timestep=5.0,
              **options).detect(*span)
    return scan, {k: _counts(setup, f"{tag}_{k}")
                  for k in ("single", "mesh", "jax")}


@pytest.mark.parametrize("fused", [False, True])
def test_mesh_detect_matches_single_and_jax(setup, fused):
    scan, runs = _detect_three(setup, f"std{int(fused)}",
                               fused_detect=fused)
    assert scan.detect_scan.mesh is scan.mesh
    assert len(scan.detect_scan.mesh_detect().slabs) == 8
    _assert_runs(runs)


def test_batched_mesh_detect_matches_single_and_jax(setup):
    """A 2 x 4 ("batch", "grid") mesh with detect_batch=3, rounded up to
    4 windows a dispatch; the 5-window span leaves a short last batch,
    filled with inert windows."""

    scan, runs = _detect_three(
        setup, "bmesh", span=(SPAN[0], "2021-02-18T12:00:45.0"),
        shape=(2, 4), fused_detect=True, detect_batch=3)
    assert scan._mesh_batch_size() == scan._detect_batch_size() == 4
    assert scan.detect_scan.batch == 4
    assert len(scan.detect_scan.mesh_detect().rows) == 2
    # two dispatches: a full batch and one of one window and three inert
    assert len(scan.detect_scan.dispatch_s) == 5
    _assert_runs(runs)


def test_kurtosis_mesh_detect_matches_single_and_jax(setup):
    _, runs = _detect_three(setup, "kurt", kind="kurtosis",
                            fused_detect=True)
    _assert_runs(runs)


@pytest.mark.parametrize("fused", [False, True])
def test_mesh_cache_rekeys_on_geometry_change(setup, fused):
    """A new timestep on the same QuakeScan rebuilds the sharded windows
    for the new geometry: its .scanmseed equals a fresh scan's."""

    tag = f"rekey{int(fused)}"
    span = (SPAN[0], "2021-02-18T12:00:30.0")
    scan = _port_scan(setup, f"{tag}_a", _cpu_mesh(), timestep=5.0,
                      fused_detect=fused)
    scan.detect(*span)
    first = scan.detect_scan
    scan.run = Run(str(setup["root"] / "runs"), f"{tag}_b", "")
    scan.timestep = 2.5
    scan.detect(*span)
    assert scan.detect_scan is not first
    _port_scan(setup, f"{tag}_c", _cpu_mesh(), timestep=2.5,
               fused_detect=fused).detect(*span)
    got = (setup["root"] / "runs" / f"{tag}_b" / "detect" / "scanmseed"
           / "2021_049.scanmseed")
    want = (setup["root"] / "runs" / f"{tag}_c" / "detect" / "scanmseed"
            / "2021_049.scanmseed")
    assert got.read_bytes() == want.read_bytes()


def _event(run_dir):
    files = sorted((run_dir / "locate" / "events").glob("*.event"))
    assert len(files) == 1, files
    return pd.read_csv(files[0]).iloc[0]


def test_mesh_locate_matches_single_and_jax(setup, tmp_path):
    """Locate's pass 1 and pass 2 on the mesh's slabs: the .event columns
    that tests/test_scan_mesh.py:682-690 holds, against the port's run
    with no mesh and the JAX package's mesh run."""

    trigger = tmp_path / "trig.csv"
    with open(trigger, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["EventID", "CoaTime", "TRIG_COA", "COA_X", "COA_Y",
                         "COA_Z", "COA", "COA_NORM"])
        writer.writerow(["20210218120030000", "2021-02-18T12:00:30.0", 2.0,
                         0.0, 0.0, 12.0, 2.0, 2.0])
    runs = setup["root"] / "runs"
    scans = {
        "loc_single": _port_scan(setup, "loc_single", None, "centred",
                                 plot_event_summary=False),
        "loc_mesh": _port_scan(setup, "loc_mesh", _cpu_mesh(), "centred",
                               plot_event_summary=False),
        "loc_jax": _jax_scan(setup, "loc_jax", _jax_mesh(), "centred",
                             plot_event_summary=False),
    }
    for scan in scans.values():
        scan.locate(trigger_file=str(trigger))
    assert scans["loc_mesh"]._mesh_locate is not None
    mesh = _event(runs / "loc_mesh")
    for ref in (_event(runs / "loc_single"), _event(runs / "loc_jax")):
        assert mesh["DT"] == ref["DT"]
        for col in ("X", "Y", "Z", "GAU_X", "GAU_Y", "GAU_Z", "COV_ErrX",
                    "COV_ErrY", "COV_ErrZ"):
            assert mesh[col] == pytest.approx(ref[col], abs=1e-6), col
        assert mesh["COA"] == pytest.approx(ref["COA"], rel=1e-4)


def test_absent_cuda_mesh_raises(setup):
    """A mesh of a CUDA device that is not there raises; make_mesh with
    no devices takes the visible CUDA devices, and raises without any;
    it never gives a CPU mesh unasked."""

    if torch.cuda.is_available():
        absent = torch.device("cuda", torch.cuda.device_count())
    else:
        absent = torch.device("cuda", 0)
        with pytest.raises(RuntimeError):
            make_mesh()
    with pytest.raises(RuntimeError):
        make_mesh([absent])
    with pytest.raises(RuntimeError):
        _port_scan(setup, "absent", Mesh(np.array([CPU, absent]), ("grid",)))


def test_device_and_mesh_disagreeing_raises(setup):
    mesh = _cpu_mesh()
    scan = _port_scan(setup, "agree", mesh, device="cpu")
    assert scan.device == CPU
    with pytest.raises((ValueError, RuntimeError)):
        _port_scan(setup, "disagree", mesh, device="cuda")
    with pytest.raises(TypeError, match="parallel.Mesh"):
        _port_scan(setup, "not_a_mesh", _jax_mesh())
