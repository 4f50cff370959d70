# -*- coding: utf-8 -*-
"""
The synthetic detect workspace the port's host-layer tests share, built
as tests/test_e2e_synthetic.py builds it: 10 stations on a ring, a 1 km
tmerc grid, homogeneous P/S traveltimes, one planted source and 60 s of
100 Hz three-component waveforms, written by the JAX package as a
YEAR/JD/STATION miniSEED archive. Also the conversion of a JAX LUT into
the plain state that ``quakemigrate_torch.lut.lut_from_reference``
takes.

"""

import numpy as np
import pandas as pd

SOURCE = [0.0, 0.0, 15.0]  # lon, lat, depth (km)
VP, VS = 5.0, 3.0
SPS = 100
TIMESTEP = 5.0
START = "2021-02-18T12:00:20.0"
END = "2021-02-18T12:00:45.0"
N_STATIONS = 10


def stations_frame():
    angles = np.linspace(0, 2 * np.pi, N_STATIONS, endpoint=False)
    return pd.DataFrame({
        "Name": [f"ST{i:02d}" for i in range(N_STATIONS)],
        "Longitude": 0.045 * np.cos(angles),
        "Latitude": 0.045 * np.sin(angles),
        "Elevation": np.zeros(N_STATIONS),
    })


def grid_spec(proj_module):
    """The grid of the workspace, with projections from ``proj_module``
    (the JAX package's coords or the port's)."""

    return dict(
        ll_corner=[-0.06, -0.06, 0.0], ur_corner=[0.06, 0.06, 20.0],
        node_spacing=[1.0, 1.0, 1.0],
        grid_proj=proj_module.Proj(proj="tmerc", units="km", lon_0=0.0,
                                   lat_0=0.0, ellps="WGS84"),
        coord_proj=proj_module.Proj(proj="longlat", ellps="WGS84"),
    )


def build_workspace(root):
    """JAX LUT (saved as ``root/lut/synthetic.LUT``), waveforms and the
    archive under ``root/mSEED``. Returns a dict of what it made."""

    from quakemigrate_tpu import compute_traveltimes, coords
    from quakemigrate_tpu.synthetics import (
        GaussianDerivativeWavelet,
        simulate_waveforms,
    )

    stations = stations_frame()
    lut_file = root / "lut" / "synthetic.LUT"
    lut = compute_traveltimes(
        grid_spec(coords), stations, method="homogeneous",
        phases=["P", "S"], vp=VP, vs=VS, save_file=str(lut_file),
    )
    wavelet = GaussianDerivativeWavelet(4.0, SPS, 30.0)
    stream = simulate_waveforms(
        wavelet, SOURCE, lut, magnitude=2.0, angle_of_incidence=80,
        rng=np.random.default_rng(4),
    )
    archive = root / "mSEED"
    day_dir = archive / "2021" / "049"
    day_dir.mkdir(parents=True)
    for tr in stream:
        tr.write(str(day_dir / f"{tr.stats.station}_{tr.stats.channel[-1]}.m"),
                 format="MSEED")
    return {"root": root, "stations": stations, "lut": lut,
            "lut_file": lut_file, "archive": archive, "stream": stream}


def reference_state(jax_lut):
    """The plain state of a JAX LUT that ``lut_from_reference`` takes."""

    return {
        "ll_corner": np.asarray(jax_lut.ll_corner),
        "ur_corner": np.asarray(jax_lut.ur_corner),
        "node_spacing": np.asarray(jax_lut.node_spacing),
        "node_count": np.asarray(jax_lut.node_count),
        "grid_proj": jax_lut.grid_proj.definition(),
        "coord_proj": jax_lut.coord_proj.definition(),
        "stations": {col: jax_lut.station_data[col].to_numpy()
                     for col in ("Name", "Latitude", "Longitude",
                                 "Elevation")},
        "traveltimes": jax_lut.traveltimes,
        "phases": list(jax_lut.phases),
        "fraction_tt": jax_lut.fraction_tt,
        "velocity_model": str(jax_lut.velocity_model),
    }


def onset_settings(onset):
    """The workspace's STA/LTA settings, on a JAX or a port onset."""

    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
    onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
    return onset


def kurtosis_settings(onset):
    """The workspace's kurtosis settings, on a JAX or a port onset: the
    STA/LTA run's bandpass, 1 s kurtosis windows and 0.05 s smoothing."""

    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
    onset.kurtosis_windows = {"P": 1.0, "S": 1.0}
    onset.smoothing_window = 0.05
    return onset


def make_onset(onsets_module, kurtosis=False):
    """The workspace's onset from ``onsets_module`` (the JAX package's
    ``signal.onsets`` or the port's): classic STA/LTA, or kurtosis."""

    if kurtosis:
        return kurtosis_settings(onsets_module.KurtosisOnset(
            sampling_rate=SPS))
    return onset_settings(onsets_module.STALTAOnset(position="classic",
                                                    sampling_rate=SPS))


# Trigger and locate settings of the workspace's run (those of
# tests/test_e2e_synthetic.py), shared by both packages
TRIGGER = dict(marginal_window=1.0, min_event_interval=2.0,
               normalise_coalescence=True, static_threshold=1.8,
               threshold_method="static", pad=30.0)
MARGINAL_WINDOW = 1.0


def jax_pipeline(workspace, run_name, locate=True, kurtosis=False,
                 onset=None, **locate_options):
    """The JAX package's detect -> trigger -> locate over the workspace's
    span, no figures, into ``root/runs/run_name`` (with ``kurtosis``, the
    kurtosis onset; ``onset``, a JAX onset, takes the place of either).
    Returns the run dir."""

    from quakemigrate_tpu import QuakeScan, Trigger
    from quakemigrate_tpu.io import Archive
    from quakemigrate_tpu.signal import onsets

    runs = workspace["root"] / "runs"
    archive = Archive(archive_path=workspace["archive"],
                      stations=workspace["stations"],
                      archive_format="YEAR/JD/STATION")
    onset = make_onset(onsets, kurtosis) if onset is None else onset
    scan = QuakeScan(archive, workspace["lut"], onset=onset,
                     run_path=str(runs), run_name=run_name,
                     timestep=TIMESTEP, marginal_window=MARGINAL_WINDOW,
                     plot_event_summary=False, compilation_cache=False,
                     **locate_options)
    scan.detect(START, END)
    Trigger(workspace["lut"], run_path=str(runs), run_name=run_name,
            plot_trigger_summary=False, **TRIGGER).trigger(START, END)
    if locate:
        scan.locate(START, END)
    return runs / run_name


def port_scan(workspace, run_name, kurtosis=False, onset=None, **options):
    """The port's QuakeScan on the CPU over the workspace, with the
    settings of :func:`jax_pipeline` (``onset``, a port onset, takes the
    place of the workspace's)."""

    from quakemigrate_torch.io import Archive
    from quakemigrate_torch.lut import StationTable, lut_from_reference
    from quakemigrate_torch.signal import QuakeScan
    from quakemigrate_torch.signal import onsets

    archive = Archive(workspace["archive"],
                      StationTable.of(workspace["stations"]),
                      archive_format="YEAR/JD/STATION")
    lut = lut_from_reference(reference_state(workspace["lut"]))
    onset = make_onset(onsets, kurtosis) if onset is None else onset
    return QuakeScan(archive, lut, onset, str(workspace["root"] / "runs"),
                     run_name, device="cpu", timestep=TIMESTEP,
                     marginal_window=MARGINAL_WINDOW,
                     plot_event_summary=False, **options)


def port_pipeline(workspace, run_name, locate=True, kurtosis=False,
                  onset=None, **locate_options):
    """The port's detect -> trigger -> locate on the CPU, as
    :func:`jax_pipeline`. Returns (run dir, scan)."""

    from quakemigrate_torch.signal import Trigger

    scan = port_scan(workspace, run_name, kurtosis=kurtosis, onset=onset,
                     **locate_options)
    scan.detect(START, END)
    Trigger(scan.lut, run_path=str(workspace["root"] / "runs"),
            run_name=run_name, plot_trigger_summary=False,
            **TRIGGER).trigger(START, END)
    if locate:
        scan.locate(START, END)
    return workspace["root"] / "runs" / run_name, scan


COUNTS_SCALE = 1e6


def counts_workspace(workspace, root, file_format):
    """The workspace with its archive rewritten under ``root`` as int32
    counts (the samples times COUNTS_SCALE, rounded) in ``file_format``
    (MSEED as STEIM2, SAC, GSE2 or SEGY) by the port's writers, one file
    a channel with the archive's names. Returns a copy of the workspace
    dict with ``archive`` and ``root`` replaced."""

    from quakemigrate_torch.seis import read

    archive = root / "archive"
    day_dir = archive / "2021" / "049"
    day_dir.mkdir(parents=True)
    options = {"encoding": "STEIM2"} if file_format == "MSEED" else {}
    for path in sorted((workspace["archive"] / "2021" / "049").iterdir()):
        st = read(path)
        for tr in st:
            tr.data = np.round(tr.data * COUNTS_SCALE).astype(np.int32)
        st.write(str(day_dir / path.name), format=file_format, **options)
    return dict(workspace, archive=archive, root=root)


def scanmseed_counts(run_dir):
    """{channel: int64 counts} of a run's .scanmseed over the workspace's
    day, read with the JAX package's reader."""

    from quakemigrate_tpu.seis import read

    st = read(str(run_dir / "detect" / "scanmseed" / "2021_049.scanmseed"))
    return {tr.stats.station: tr.data.astype(np.int64) for tr in st}


def assert_scanmseed_close(got, want, rtol):
    """COA and COA_N within max(1 count, ``rtol`` of the value) of the
    reference's (the integer scaling of the written traces), X, Y and Z
    equal."""

    assert sorted(got) == sorted(want)
    for name in ("COA", "COA_N"):
        bound = np.maximum(1, rtol * np.abs(want[name]))
        assert (np.abs(got[name] - want[name]) <= bound).all(), name
    for name in ("X", "Y", "Z"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def event_rows(run_dir):
    """The header and rows of a run's one .event file."""

    import csv

    files = sorted((run_dir / "locate" / "events").glob("*.event"))
    assert len(files) == 1, files
    with open(files[0], newline="") as f:
        return list(csv.reader(f))


def _digit_unit(text):
    mantissa, _, exponent = text.lower().partition("e")
    decimals = len(mantissa.partition(".")[2])
    return 10.0 ** (-decimals + (int(exponent) if exponent else 0))


def assert_event_close(got_dir, want_dir):
    """The two runs' .event files: the same header, text fields equal,
    each number within one unit of the reference's last written digit
    (float32 sums round the location a digit apart now and then)."""

    got, want = event_rows(got_dir), event_rows(want_dir)
    assert got[0] == want[0] and len(got) == len(want) == 2
    for name, a, b in zip(want[0], got[1], want[1]):
        try:
            x, y = float(a), float(b)
        except ValueError:
            assert a == b, name
        else:
            assert abs(x - y) <= _digit_unit(b) * (1 + 1e-9), (name, a, b)
