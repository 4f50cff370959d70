# -*- coding: utf-8 -*-
"""
The port's QuakeScan.detect (quakemigrate_torch.signal.scan.QuakeScan on
the CPU) against the JAX QuakeScan.detect on the synthetic workspace
(tests/torch_synthetic.py: 10 stations, P and S, 100 Hz, 5 windows of
5 s, a planted source), from the archive to the run's files:

- .scanmseed COA and COA_N within max(1 count, 1e-5 x value); X/Y/Z equal
  wherever the argmax node agrees, and elsewhere tie-consistent: the
  coalescence at the port's node, computed from the window's block,
  equals the reference's maximum within the same tolerance;
- the event peak at the same sample and node, near the planted source;
- the StationAvailability csv equal, read through pandas;
- the port's .scanmseed read back through the JAX reader;
- windows past the end of the archive written as empty, as JAX does;
- ScanmSEED across midnight byte-equal to the JAX writer on the same
  arrays;
- DetectScan.stream yields in window order, None for windows without a
  live slot;
- QuakeScan(device="cuda") raises where CUDA is absent;
- io.read_availability against the JAX reader (the run's files, an
  old-format file, a span without files);
- an in-place LUT.decimate after the QuakeScan was built: the scan's
  tables are built anew; detect on the decimated LUT against the JAX
  package's on its decimated LUT.

"""

import numpy as np
import pandas as pd
import pytest
import torch

from quakemigrate_tpu import QuakeScan as JQuakeScan
from quakemigrate_tpu.io import Archive as JArchive
from quakemigrate_tpu.io import Run as JRun
from quakemigrate_tpu.io import ScanmSEED as JScanmSEED
from quakemigrate_tpu.io import read_scanmseed as j_read_scanmseed
from quakemigrate_tpu.seis import UTCDateTime as JUTCDateTime
from quakemigrate_tpu.seis import read as j_read
from quakemigrate_tpu.signal.onsets import STALTAOnset as JSTALTAOnset
from quakemigrate_torch.io import Archive, Run, ScanmSEED
from quakemigrate_torch.lut import StationTable, lut_from_reference
from quakemigrate_torch.ops.migrate import _prepare_onsets
from quakemigrate_torch.ops.scan_window import fused_onsets
from quakemigrate_torch.seis import UTCDateTime
from quakemigrate_torch.signal.onsets import STALTAOnset
from quakemigrate_torch.signal.scan import DetectScan, QuakeScan

import torch_synthetic as ws

torch.set_num_threads(1)

CHANNELS = ("COA", "COA_N", "X", "Y", "Z")


def _port_scan(workspace, run_name, archive=None):
    archive = archive or Archive(workspace["archive"],
                                 StationTable.of(workspace["stations"]),
                                 archive_format="YEAR/JD/STATION")
    lut = lut_from_reference(ws.reference_state(workspace["lut"]))
    onset = ws.onset_settings(STALTAOnset(position="classic",
                                          sampling_rate=ws.SPS))
    return QuakeScan(archive, lut, onset, str(workspace["root"] / "runs"),
                     run_name, device="cpu", timestep=ws.TIMESTEP)


def _jax_scan(workspace, run_name):
    archive = JArchive(archive_path=workspace["archive"],
                       stations=workspace["stations"],
                       archive_format="YEAR/JD/STATION")
    onset = ws.onset_settings(JSTALTAOnset(position="classic",
                                           sampling_rate=ws.SPS))
    return JQuakeScan(archive, workspace["lut"], onset=onset,
                      run_path=str(workspace["root"] / "runs"),
                      run_name=run_name, timestep=ws.TIMESTEP,
                      compilation_cache=False)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return ws.build_workspace(tmp_path_factory.mktemp("torch_quakescan"))


@pytest.fixture(scope="module")
def runs(workspace):
    """Both detects over the synthetic span; the port's windows (block,
    result) through its on_window hook."""

    port = _port_scan(workspace, "port")
    windows = {}
    port.on_window = lambda i, block, result: windows.update(
        {i: (block, result)})
    port.detect(ws.START, ws.END)
    _jax_scan(workspace, "jax").detect(ws.START, ws.END)
    runs = workspace["root"] / "runs"
    return {"port": runs / "port", "jax": runs / "jax", "scan": port,
            "windows": windows}


def _scanmseed(run_dir):
    st = j_read(str(run_dir / "detect" / "scanmseed" / "2021_049.scanmseed"))
    return {tr.stats.station: tr for tr in st}


def test_scanmseed_coalescence_within_one_count(runs):
    got, want = _scanmseed(runs["port"]), _scanmseed(runs["jax"])
    assert sorted(got) == sorted(want) == sorted(CHANNELS)
    for name in CHANNELS:
        a, b = got[name], want[name]
        assert a.stats.starttime.ns == b.stats.starttime.ns
        assert a.stats.npts == b.stats.npts == 5 * 5 * ws.SPS
        assert a.stats.sampling_rate == b.stats.sampling_rate
    for name in ("COA", "COA_N"):
        a = got[name].data.astype(np.int64)
        b = want[name].data.astype(np.int64)
        assert (np.abs(a - b) <= np.maximum(1, 1e-5 * np.abs(b))).all(), name


def _coalescence_at(block, traveltimes, fsmp, idx, scan):
    """The window's coalescence at node idx[t] for each sample t, from its
    channel block (float64 sum over the float32 log-onsets)."""

    tensors = [torch.from_numpy(np.asarray(a)) for a in block]
    combined, available = fused_onsets(
        *tensors, scan.onset.position, scan.onset.signal_transform,
        scan.onset.min_onset_value)
    logged = _prepare_onsets(combined, tensors[2]).numpy()
    t = np.arange(len(idx))
    cols = fsmp + traveltimes[idx].T + t
    return np.exp(np.take_along_axis(logged.astype(np.float64), cols,
                                     axis=1).sum(0) / float(available))


def test_scanmseed_nodes_equal_or_tie_consistent(runs):
    got, want = _scanmseed(runs["port"]), _scanmseed(runs["jax"])
    same = np.ones(got["X"].stats.npts, bool)
    for name in ("X", "Y", "Z"):
        same &= got[name].data == want[name].data
    assert same.mean() >= 0.99
    scan = runs["scan"]
    detect = scan.detect_scan
    n = int(ws.TIMESTEP * ws.SPS)
    coa_ref = want["COA"].data.astype(np.float64)
    for i, (block, result) in sorted(runs["windows"].items()):
        rows = slice(i * n, (i + 1) * n)
        if same[rows].all():
            continue
        at_port = _coalescence_at(block, detect.traveltimes, detect.fsmp,
                                  result[2], scan)
        counts = np.round(np.minimum(at_port, 21474.0) * 1e5)
        ref = coa_ref[rows]
        assert (np.abs(counts - ref) <= np.maximum(1, 1e-5 * ref)).all()


def test_event_peak_node_matches(runs, workspace):
    got, want = _scanmseed(runs["port"]), _scanmseed(runs["jax"])
    peak = int(np.argmax(got["COA"].data))
    assert peak == int(np.argmax(want["COA"].data))
    for name in ("X", "Y", "Z"):
        assert got[name].data[peak] == want[name].data[peak]
    lut = workspace["lut"]
    xyz = np.array([[got["X"].data[peak] / 1e6, got["Y"].data[peak] / 1e6,
                     got["Z"].data[peak] / 1e3 / lut.unit_conversion_factor]])
    node = lut.index2coord(xyz, inverse=True)[0]
    source = lut.index2coord([ws.SOURCE], inverse=True)[0]
    assert np.abs(node - source).max() <= 1


def _availability(run_dir):
    return run_dir / "detect" / "availability" / (
        "2021_049_StationAvailability.csv")


def test_availability_csv_equal(runs):
    got = pd.read_csv(_availability(runs["port"]), index_col=0)
    want = pd.read_csv(_availability(runs["jax"]), index_col=0)
    assert got.index.name == "DT"
    pd.testing.assert_frame_equal(got, want)
    assert _availability(runs["port"]).read_text() == (
        _availability(runs["jax"]).read_text())


def test_port_scanmseed_reads_through_jax_reader(runs):
    start, end = JUTCDateTime(ws.START), JUTCDateTime(ws.END)
    got, stats = j_read_scanmseed(JRun(runs["port"].parent, "port"), start,
                                  end, 0.0, 1000.0)
    want, _ = j_read_scanmseed(JRun(runs["jax"].parent, "jax"), start, end,
                               0.0, 1000.0)
    assert len(got) == len(want) == 5 * 5 * ws.SPS
    pd.testing.assert_series_equal(got["DT"], want["DT"])
    for name in ("X", "Y", "Z"):
        assert (got[name] == want[name]).mean() >= 0.99
    np.testing.assert_allclose(got["COA"], want["COA"], rtol=1e-5,
                               atol=1e-5)


def test_detect_attrib_and_route(runs):
    scan = runs["scan"]
    assert scan.detect_scan.route == "plain"
    assert len(scan.detect_batch_attrib) == 5
    for row in scan.detect_batch_attrib:
        assert set(row) == {"n", "read_wait", "prepare", "dispatch", "drain"}
        assert min(row.values()) >= 0
    assert len(scan.detect_scan.fetch_s) == 5


def test_windows_past_the_archive_written_empty(workspace):
    """The archive ends at 12:01:00: the later windows fail the
    availability checks or find no data, and are written zero-filled."""

    start, end = "2021-02-18T12:00:45.0", "2021-02-18T12:01:05.0"
    port = _port_scan(workspace, "port_gap")
    port.detect(start, end)
    _jax_scan(workspace, "jax_gap").detect(start, end)
    runs = workspace["root"] / "runs"
    got, want = _scanmseed(runs / "port_gap"), _scanmseed(runs / "jax_gap")
    for name in CHANNELS:
        a = got[name].data.astype(np.int64)
        b = want[name].data.astype(np.int64)
        assert a.shape == b.shape == (4 * 5 * ws.SPS,)
        assert (np.abs(a - b) <= np.maximum(1, 1e-5 * np.abs(b))).all()
    assert not got["COA"].data[-5 * ws.SPS:].any()
    pd.testing.assert_frame_equal(
        pd.read_csv(_availability(runs / "port_gap"), index_col=0),
        pd.read_csv(_availability(runs / "jax_gap"), index_col=0))


def test_scanmseed_across_midnight_matches_jax_writer(tmp_path):
    rng = np.random.default_rng(11)
    rate, timestep, n_steps = 20, 30.0, 6
    n = int(rate * timestep)
    port = ScanmSEED(Run(tmp_path, "port"), False, rate)
    ref = JScanmSEED(JRun(tmp_path, "jax"), False, rate)
    start = "2021-02-18T23:58:30.0"
    for i in range(n_steps):
        coa = rng.uniform(0.5, 3.0, n)
        coa[0] = 3e4  # above the ceiling
        coord = np.column_stack([rng.uniform(-17.3, -17.2, n),
                                 rng.uniform(64.3, 64.4, n),
                                 rng.uniform(-1.0, 0.0, n)])
        for writer, utc in ((port, UTCDateTime), (ref, JUTCDateTime)):
            writer.append(utc(start) + timestep * i, coa, coa / 2, coord,
                          1000.0)
    port.write()
    ref.write()
    for day in ("2021_049", "2021_050"):
        a = tmp_path / "port" / "detect" / "scanmseed" / f"{day}.scanmseed"
        b = tmp_path / "jax" / "detect" / "scanmseed" / f"{day}.scanmseed"
        assert a.read_bytes() == b.read_bytes()
    port.empty(UTCDateTime("2021-02-19T00:01:30.0"), timestep, 0, "", 1000.0)
    ref.empty(JUTCDateTime("2021-02-19T00:01:30.0"), timestep, 0, "", 1000.0)
    port.write()
    ref.write()
    a = tmp_path / "port" / "detect" / "scanmseed" / "2021_050.scanmseed"
    b = tmp_path / "jax" / "detect" / "scanmseed" / "2021_050.scanmseed"
    assert a.read_bytes() == b.read_bytes()


def test_detect_scan_stream_yields_in_order(runs):
    scan = runs["scan"]
    blocks = [block for _, (block, _) in sorted(runs["windows"].items())]
    detect = DetectScan(scan.detect_scan.traveltimes,
                        scan.detect_scan.node_count, scan.detect_scan.fsmp,
                        scan.detect_scan.lsmp, device="cpu", drain_depth=2)
    dead = tuple(np.zeros_like(a) if k < 3 else a
                 for k, a in enumerate(blocks[0]))
    order = [blocks[0], None, blocks[1], dead, blocks[2], blocks[3]]
    results = list(detect.stream(iter(order)))
    assert len(results) == len(order)
    assert results[1] is None and results[3] is None
    for k, w in ((0, 0), (2, 1), (4, 2), (5, 3)):
        np.testing.assert_array_equal(results[k][0],
                                      runs["windows"][w][1][0])
        np.testing.assert_array_equal(results[k][2],
                                      runs["windows"][w][1][2])
    assert len(detect.dispatch_s) == len(detect.fetch_s) == 4


def test_quakescan_defaults_to_the_card(workspace):
    """Without a device QuakeScan targets the card: here, where CUDA is
    absent, it raises rather than run on the CPU."""

    archive = Archive(workspace["archive"],
                      StationTable.of(workspace["stations"]),
                      archive_format="YEAR/JD/STATION")
    lut = lut_from_reference(ws.reference_state(workspace["lut"]))
    onset = ws.onset_settings(STALTAOnset(sampling_rate=ws.SPS))
    root = str(workspace["root"] / "runs")
    if torch.cuda.is_available():
        assert QuakeScan(archive, lut, onset, root, "card").device.type == (
            "cuda")
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            QuakeScan(archive, lut, onset, root, "card")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            QuakeScan(archive, lut, onset, root, "card", device="cuda")
    assert QuakeScan(archive, lut, onset, root, "cpu",
                     device="cpu").device == torch.device("cpu")


# -- host leftovers: read_availability, and detect on a decimated LUT --------

def test_read_availability_matches_jax(runs):
    """The port's reader on the port's files against the JAX reader on
    the JAX files: the row labels (the reference's index), the columns
    and the int flags."""

    from quakemigrate_tpu.io import read_availability as j_read_availability
    from quakemigrate_torch.io import read_availability

    start, end = UTCDateTime(ws.START), UTCDateTime(ws.END)
    got = read_availability(Run(runs["port"].parent, "port"), start, end)
    want = j_read_availability(JRun(runs["jax"].parent, "jax"),
                               JUTCDateTime(ws.START), JUTCDateTime(ws.END))
    assert got.names == ["DT", *want.columns]
    assert list(got["DT"]) == list(want.index)
    for name in want.columns:
        assert got[name].dtype == np.int64
        np.testing.assert_array_equal(got[name], want[name].to_numpy())


def test_read_availability_old_format_and_missing(tmp_path):
    """An old-format file (a column per station) is expanded to
    {station}_P then {station}_S columns, as the JAX reader expands it; a
    span without files raises the reference's exception."""

    from quakemigrate_tpu.io import read_availability as j_read_availability
    from quakemigrate_tpu.util import (
        NoStationAvailabilityDataException as JNoData,
    )
    from quakemigrate_torch.io import read_availability
    from quakemigrate_torch.util import NoStationAvailabilityDataException

    day = tmp_path / "run" / "detect" / "availability"
    day.mkdir(parents=True)
    (day / "2021_049_StationAvailability.csv").write_text(
        ",ST_A,ST_B\n2021-02-18T12:00:20.000000Z,1,0\n"
        "2021-02-18T12:00:25.000000Z,0,1\n")
    start, end = "2021-02-18T12:00:00.0", "2021-02-18T13:00:00.0"
    got = read_availability(Run(tmp_path, "run"), start, end)
    want = j_read_availability(JRun(tmp_path, "run"), JUTCDateTime(start),
                               JUTCDateTime(end))
    assert got.names == ["DT", *want.columns]
    for name in want.columns:
        np.testing.assert_array_equal(got[name], want[name].to_numpy())
    with pytest.raises(JNoData):
        j_read_availability(JRun(tmp_path, "none"), JUTCDateTime(start),
                            JUTCDateTime(end))
    with pytest.raises(NoStationAvailabilityDataException) as err:
        read_availability(Run(tmp_path, "none"), start, end)
    assert "StationAvailability" in str(err.value)


def test_inplace_decimate_rebuilds_the_scan_tables(workspace):
    """A QuakeScan built before an in-place LUT.decimate migrates on the
    decimated grid: the flat table, the route and the DetectScan are
    built anew, not kept stale."""

    scan = _port_scan(workspace, "decimated_cache")
    full = scan._traveltime_table()
    assert full.shape[0] == scan.lut.n_nodes
    scan._detect_scan(10, 10)
    scan.lut.decimate([2, 2, 2], inplace=True)
    small = scan._traveltime_table()
    assert small.shape == (scan.lut.n_nodes, full.shape[1])
    assert small.shape[0] < full.shape[0]
    assert scan.detect_scan is None
    assert scan._detect_scan(10, 10).n_nodes == scan.lut.n_nodes


def test_decimated_detect_matches_jax(workspace):
    """Both packages' detect on their LUT decimated in place by [2, 2, 2],
    as the Askja example's detect script does: .scanmseed COA within
    max(1 count, 1e-5 of the value), X/Y/Z equal where the nodes agree,
    the peak within one decimated node of the planted source."""

    port = _port_scan(workspace, "port_decimated")
    port.lut.decimate([2, 2, 2], inplace=True)
    port.detect(ws.START, ws.END)
    jax = _jax_scan(workspace, "jax_decimated")
    jax.lut = jax.lut.decimate([2, 2, 2])
    jax.onset.post_pad = jax.lut.max_traveltime
    jax.detect(ws.START, ws.END)
    runs_dir = workspace["root"] / "runs"
    got = _scanmseed(runs_dir / "port_decimated")
    want = _scanmseed(runs_dir / "jax_decimated")
    for name in ("COA", "COA_N"):
        a = got[name].data.astype(np.int64)
        b = want[name].data.astype(np.int64)
        assert (np.abs(a - b) <= np.maximum(1, 1e-5 * np.abs(b))).all()
    same = np.ones_like(got["X"].data, dtype=bool)
    for name in ("X", "Y", "Z"):
        same &= got[name].data == want[name].data
    assert same.mean() >= 0.99
    peak = int(np.argmax(got["COA"].data))
    lut = port.lut
    node = lut.index2coord([[
        got["X"].data[peak] / 1e6, got["Y"].data[peak] / 1e6,
        got["Z"].data[peak] / 1e3 / lut.unit_conversion_factor]],
        inverse=True)[0]
    source = lut.index2coord([ws.SOURCE], inverse=True)[0]
    assert np.abs(node - source).max() <= 1
