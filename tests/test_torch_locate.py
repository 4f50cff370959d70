# -*- coding: utf-8 -*-
"""
The port's locate stage (QuakeScan.locate on the CPU: the onsets, pass 1,
pass 2, the location math, GaussianPicker and the output files) against
the JAX package on the synthetic workspace (tests/torch_synthetic.py):
both packages run detect -> trigger -> locate over it once (module
fixture), with cut waveforms.

- calculate_onsets, classic and centred, with and without the picker's
  timespan, against JAX's within 1e-6 relative;
- each location function against JAX's on the same marginal map within
  1e-9 (the same float64 numpy and scipy code);
- the .event rows: the same header, each value within one unit of its last
  written digit; the .picks rows: pick and modelled times within 1e-3 of
  a sample period, the other numbers within 1e-6 relative;
- the cut waveforms equal to JAX's, sample for sample;
- pass 2's window [first, last) of trim_bounds (end-exclusive, the
  reference's quirk) and the per-event split;
- locate_workers=0 and 4 giving the same files; a dataless event skipped;
- plot_event_video keeping the 4-D map for the event video;
- cut waveforms in each format (MSEED, SAC, GSE2, SEG-Y) from an archive
  of int32 counts, read back by both packages equal to the MSEED ones.

"""

import csv
import shutil

import numpy as np
import pytest
import torch

from quakemigrate_tpu import QuakeScan as JQuakeScan
from quakemigrate_tpu.io import Archive as JArchive
from quakemigrate_tpu.io import Event as JEvent
from quakemigrate_tpu.seis import read as j_read
from quakemigrate_tpu.signal.onsets import STALTAOnset as JSTALTAOnset
from quakemigrate_torch.io import Event
from quakemigrate_torch.ops.migrate import migrate_marginalise
from quakemigrate_torch.seis import UTCDateTime
from quakemigrate_torch.signal.onsets import STALTAOnset

import torch_synthetic as ws

torch.set_num_threads(1)

EVENT_WINDOW = ("2021-02-18T12:00:24.0", "2021-02-18T12:00:40.0")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return ws.build_workspace(tmp_path_factory.mktemp("torch_locate"))


@pytest.fixture(scope="module")
def runs(workspace):
    jax_dir = ws.jax_pipeline(workspace, "jax", write_cut_waveforms=True)
    seen = []
    port_dir, scan = ws.port_pipeline(workspace, "port", locate=False,
                                      write_cut_waveforms=True)
    scan.on_event = lambda event, pass1, handle: seen.append(
        (event, pass1, handle))
    scan.locate(ws.START, ws.END)
    return {"jax": jax_dir, "port": port_dir, "scan": scan, "seen": seen}


def _only(run_dir, kind, suffix):
    files = sorted((run_dir / "locate" / kind).glob(f"*{suffix}"))
    assert len(files) == 1, files
    return files[0]


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


# -- onsets -----------------------------------------------------------------

def _data_both(workspace):
    from quakemigrate_torch.io import Archive
    from quakemigrate_torch.lut import StationTable

    start, end = EVENT_WINDOW
    port = Archive(workspace["archive"],
                   StationTable.of(workspace["stations"]),
                   archive_format="YEAR/JD/STATION")
    jax = JArchive(archive_path=workspace["archive"],
                   stations=workspace["stations"],
                   archive_format="YEAR/JD/STATION")
    from quakemigrate_tpu.seis import UTCDateTime as JUTCDateTime

    return (port.read_waveform_data(UTCDateTime(start), UTCDateTime(end)),
            jax.read_waveform_data(JUTCDateTime(start), JUTCDateTime(end)))


@pytest.mark.parametrize("position", ["classic", "centred"])
@pytest.mark.parametrize("timespan", [None, 4.0])
def test_calculate_onsets_equals_jax(workspace, position, timespan):
    port_data, jax_data = _data_both(workspace)
    port = ws.onset_settings(STALTAOnset(position=position,
                                         sampling_rate=ws.SPS))
    jax = ws.onset_settings(JSTALTAOnset(position=position,
                                         sampling_rate=ws.SPS))
    for onset in (port, jax):
        onset.sta_lta_windows = {"P": [0.1, 1.0], "S": [0.3, 1.5]}
    got, got_data = port.calculate_onsets(port_data, timespan=timespan,
                                          device="cpu")
    want, want_data = jax.calculate_onsets(jax_data, timespan=timespan)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert got.shape == want.shape == (2 * ws.N_STATIONS, 16 * ws.SPS + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert list(got_data.onsets) == list(want_data.onsets)
    for station, phases in want_data.onsets.items():
        for phase, row in phases.items():
            np.testing.assert_allclose(got_data.onsets[station][phase], row,
                                       rtol=1e-6, atol=0)
            assert got_data.rows[f"{station}_{phase}"] is not None
    assert got_data.availability == want_data.availability
    for phase in ("P", "S"):
        assert port.gaussian_halfwidth(phase) == jax.gaussian_halfwidth(
            phase)


# -- location math ------------------------------------------------------------

def _scans(workspace):
    """The port's QuakeScan and a JAX one on the workspace's LUT."""

    jax_archive = JArchive(archive_path=workspace["archive"],
                           stations=workspace["stations"],
                           archive_format="YEAR/JD/STATION")
    jax = JQuakeScan(jax_archive, workspace["lut"],
                     onset=JSTALTAOnset(sampling_rate=ws.SPS),
                     run_path=str(workspace["root"] / "runs"),
                     run_name="math", compilation_cache=False)
    return ws.port_scan(workspace, "math"), jax


def _marginal_map(workspace, seed):
    """A peaked, noisy marginal map on the workspace grid, normalised."""

    rng = np.random.default_rng(seed)
    shape = tuple(workspace["lut"].node_count)
    centre = rng.uniform(3.0, np.asarray(shape) - 4.0)
    ijk = np.indices(shape).astype(float)
    d2 = sum((ijk[a] - centre[a]) ** 2 / (1.5 + a) for a in range(3))
    coa = np.exp(-0.5 * d2) + 0.02 * rng.random(shape)
    return coa / coa.max()


@pytest.mark.parametrize("name", ["_splineloc", "_gaufilt3d", "_covfit3d"])
@pytest.mark.parametrize("seed", [5, 6])
def test_location_function_equals_jax(workspace, name, seed):
    port, jax = _scans(workspace)
    coa_map = _marginal_map(workspace, seed)
    got = getattr(port, name)(np.copy(coa_map))
    want = getattr(jax, name)(np.copy(coa_map))
    pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
    for a, b in pairs:
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("seed", [5, 6])
def test_gaufit3d_and_calculate_location_equal_jax(workspace, seed):
    port, jax = _scans(workspace)
    coa_map = _marginal_map(workspace, seed)
    smoothed = port._gaufilt3d(np.copy(coa_map))
    for a, b in zip(port._gaufit3d(np.copy(smoothed)),
                    jax._gaufit3d(np.copy(smoothed))):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    row = {"EventID": "1", "CoaTime": UTCDateTime(ws.START),
           "TRIG_COA": 2.0, "COA": 2.0, "COA_NORM": 2.0}
    event, j_event = Event(1.0, row), JEvent(1.0, row)
    scale = np.float32(3.5)  # an unnormalised map, as pass 2 gives it
    port._calculate_location(event, (coa_map * scale).ravel())
    jax._calculate_location(j_event, (coa_map * scale).ravel())
    for method, entry in j_event.locations.items():
        for key, value in entry.items():
            np.testing.assert_allclose(event.locations[method][key], value,
                                       rtol=1e-9, atol=1e-12)
    assert port._mask3d((5, 6, 7), (1, 2, 3), 3).sum() == (
        jax._mask3d((5, 6, 7), (1, 2, 3), 3).sum())


# -- the synthetic run's files ------------------------------------------------

def _digit_unit(text):
    """One unit of the last written digit of a number's text."""

    mantissa, _, exponent = text.lower().partition("e")
    decimals = len(mantissa.partition(".")[2])
    return 10.0 ** (-decimals + (int(exponent) if exponent else 0))


def test_event_file_equals_jax(runs):
    got = _csv(_only(runs["port"], "events", ".event"))
    want = _csv(_only(runs["jax"], "events", ".event"))
    assert got[0] == want[0] and len(got[0]) == 20
    assert len(got) == len(want) == 2
    for name, a, b in zip(want[0], got[1], want[1]):
        try:
            x, y = float(a), float(b)
        except ValueError:
            assert a == b, name
        else:
            assert abs(x - y) <= _digit_unit(b) * (1 + 1e-9), (name, a, b)


def test_event_located_at_planted_source(runs, workspace):
    got = _csv(_only(runs["port"], "events", ".event"))
    row = dict(zip(got[0], got[1]))
    lut = workspace["lut"]
    node = lut.index2coord([[float(row["X"]), float(row["Y"]),
                             float(row["Z"])]], inverse=True)[0]
    source = lut.index2coord([ws.SOURCE], inverse=True)[0]
    assert np.abs(node - source).max() <= 1


def test_picks_file_equals_jax(runs):
    got = _csv(_only(runs["port"], "picks", ".picks"))
    want = _csv(_only(runs["jax"], "picks", ".picks"))
    assert got[0] == want[0]
    assert len(got) == len(want) == 1 + 2 * ws.N_STATIONS
    period = 1.0 / ws.SPS
    for a, b in zip(got[1:], want[1:]):
        row_a, row_b = dict(zip(got[0], a)), dict(zip(want[0], b))
        assert (row_a["Station"], row_a["Phase"]) == (row_b["Station"],
                                                      row_b["Phase"])
        for name in ("ModelledTime", "PickTime"):
            if row_b[name] == "-1":
                assert row_a[name] == "-1"
            else:
                dt = UTCDateTime(row_a[name]) - UTCDateTime(row_b[name])
                assert abs(dt) <= 1e-3 * period, name
        for name in ("PickError", "SNR"):
            np.testing.assert_allclose(float(row_a[name]),
                                       float(row_b[name]), rtol=1e-6)
        assert abs(float(row_a["Residual"])
                   - float(row_b["Residual"])) <= 1e-3 * period
    made = [r for r in got[1:] if r[3] != "-1"]
    assert len(made) > ws.N_STATIONS


def test_cut_waveforms_equal_jax(runs):
    got = j_read(str(_only(runs["port"], "raw_cut_waveforms", ".m")))
    want = j_read(str(_only(runs["jax"], "raw_cut_waveforms", ".m")))
    assert len(got) == len(want) == 3 * ws.N_STATIONS
    for a, b in zip(sorted(got, key=lambda tr: tr.id),
                    sorted(want, key=lambda tr: tr.id)):
        assert a.id == b.id
        assert a.stats.starttime == b.stats.starttime
        assert a.stats.sampling_rate == b.stats.sampling_rate
        np.testing.assert_array_equal(a.data, b.data)


def test_pass2_window_is_end_exclusive(runs):
    """Pass 2 sums the scan samples [first, last) of trim_bounds, while
    coa_data keeps row last: the reference's quirk, kept."""

    scan = runs["scan"]
    assert scan.locate_route == "plain"
    (event, pass1, handle), = runs["seen"]
    first, last = event.trim_bounds
    assert len(event.coa_data) == last - first + 1
    marginal, copied = handle
    assert copied is None
    inputs = event._marginalise_inputs
    tt = torch.from_numpy(scan._traveltime_table())

    def marginalise(length):
        return migrate_marginalise(
            inputs["block"], tt, inputs["mask"], inputs["available"],
            inputs["fsmp"], inputs["nsamples"], first, length).numpy()

    np.testing.assert_array_equal(marginal.numpy(), marginalise(last - first))
    assert not np.array_equal(marginal.numpy(), marginalise(last - first + 1))
    max_coa, _, max_idx = pass1
    assert max_coa.shape == max_idx.shape == (inputs["nsamples"],)


def test_locate_event_attrib(runs):
    scan = runs["scan"]
    assert len(scan.locate_event_attrib) == len(scan.locate_event_marks) == 1
    row, = scan.locate_event_attrib
    assert set(row) == {"read_wait", "onsets", "pass1", "pass2",
                        "pass2_wait", "location", "picks", "writes"}
    assert min(row.values()) >= 0


def _trigger_file(runs):
    return (runs["port"] / "trigger" / "events"
            / "port_2021_049_TriggeredEvents.csv")


def _locate_files(workspace, trigger_file, run_name, **options):
    scan = ws.port_scan(workspace, run_name, **options)
    scan.locate(trigger_file=str(trigger_file))
    out = workspace["root"] / "runs" / run_name / "locate"
    return {f.relative_to(out): f.read_bytes()
            for f in out.rglob("*") if f.is_file() and f.suffix != ".log"}


def test_serial_locate_matches_pipelined(runs, workspace):
    serial = _locate_files(workspace, _trigger_file(runs), "serial",
                           locate_workers=0, write_cut_waveforms=True)
    piped = _locate_files(workspace, _trigger_file(runs), "piped",
                          locate_workers=4, write_cut_waveforms=True)
    assert len(serial) == 3  # .event, .picks, cut waveforms
    assert serial == piped


def test_dataless_event_skipped(runs, workspace, tmp_path):
    rows = _csv(_trigger_file(runs))
    header, (real,) = rows[0], rows[1:]
    bad = dict(zip(header, real), EventID="20210219040000000",
               CoaTime="2021-02-19T04:00:00.000000Z")
    mixed = tmp_path / "with_gap.csv"
    shutil.copy(_trigger_file(runs), mixed)
    with open(mixed, "a", newline="") as f:
        csv.writer(f, lineterminator="\n").writerow(
            [bad[name] for name in header])
    files = _locate_files(workspace, mixed, "withgap", locate_workers=4)
    names = {p.stem for p in files}
    assert names == {real[0]}


@pytest.mark.parametrize("options", [
    {"write_coalescence": True, "plot_event_video": True},
    {"plot_event_video": True},
])
def test_options_not_covered_raise(runs, workspace, monkeypatch, options):
    """plot_event_video, once refused, keeps the 4-D map (the map path:
    no pass 2) and draws the event video from it, the map trimmed to the
    marginal window (the drawing itself: tests/test_torch_plot.py)."""

    import quakemigrate_torch.plot.video as video

    drawn = []
    monkeypatch.setattr(video, "event_video",
                        lambda run, event, lut: drawn.append(
                            (run.name, np.array(event.map4d))))
    name = "video_map" if options.get("write_coalescence") else "video"
    scan = ws.port_scan(workspace, name, **options)
    seen = []
    scan.on_event = lambda event, pass1, handle: seen.append((event, handle))
    scan.locate(trigger_file=str(_trigger_file(runs)))
    (event, handle), = seen
    assert handle is None and event.map4d is not None
    (run_name, map4d), = drawn
    first, last = event.trim_bounds
    assert run_name == name and map4d.shape == (
        tuple(scan.lut.node_count) + (last - first,))
    np.testing.assert_array_equal(map4d, event.map4d)
    assert _only(workspace["root"] / "runs" / name, "events", ".event")
    if options.get("write_coalescence"):
        written = np.load(_only(workspace["root"] / "runs" / name,
                                "coalescence_maps", ".npy"))
        np.testing.assert_array_equal(written[..., first:last], map4d)


@pytest.fixture(scope="module")
def counts_run(workspace, tmp_path_factory):
    """The workspace's archive as int32 counts (GSE2 holds integers only),
    detect -> trigger on it, and its event located with MSEED cut
    waveforms: (workspace, trigger file, the cut waveforms)."""

    counts = ws.counts_workspace(
        workspace, tmp_path_factory.mktemp("torch_locate_counts"), "MSEED")
    run_dir, _ = ws.port_pipeline(counts, "counts", locate=False)
    (trigger_file,) = sorted((run_dir / "trigger" / "events").glob("*.csv"))
    files = _locate_files(counts, trigger_file, "cut_ref",
                          write_cut_waveforms=True)
    (cut,) = [p for p in files if p.parent.name == "raw_cut_waveforms"]
    ref = j_read(str(counts["root"] / "runs" / "cut_ref" / "locate" / cut))
    return counts, trigger_file, ref


_CUT_SUFFIXES = {"MSEED": ".m", "SAC": ".sac", "GSE2": ".gse2",
                 "SEGY": ".segy"}


@pytest.mark.parametrize("file_format", ["MSEED", "SAC", "GSE2", "SEGY"])
def test_locate_writes_cut_waveforms_in_each_format(counts_run, file_format):
    from quakemigrate_torch.seis import read

    counts, trigger_file, ref = counts_run
    name = f"cut_{file_format.lower()}"
    files = _locate_files(counts, trigger_file, name,
                          write_cut_waveforms=True,
                          cut_waveform_format=file_format)
    cuts = sorted(counts["root"] / "runs" / name / "locate" / p
                  for p in files if p.parent.name == "raw_cut_waveforms")
    assert {p.suffix for p in files} >= {".event", ".picks"}
    # SAC holds one trace a file: <uid>.sac.00, .01, ...
    if file_format == "SAC":
        assert len(cuts) == len(ref) and all(
            p.name.split(".")[-2] == "sac" for p in cuts)
    else:
        assert [p.suffix for p in cuts] == [_CUT_SUFFIXES[file_format]]
    for reader in (read, j_read):
        back = [tr for p in cuts for tr in reader(str(p))]
        assert len(back) == len(ref) == 3 * ws.N_STATIONS
        for got, want in zip(back, ref):
            if reader is read or file_format != "SEGY":
                assert (got.stats.station, got.stats.channel) == (
                    want.stats.station, want.stats.channel)
            assert str(got.stats.starttime) == str(want.stats.starttime)
            np.testing.assert_allclose(got.stats.sampling_rate,
                                       want.stats.sampling_rate, rtol=1e-7)
            np.testing.assert_array_equal(np.asarray(got.data, np.int64),
                                          want.data)


def test_write_marginal_coalescence(runs, workspace):
    files = _locate_files(workspace, _trigger_file(runs), "maps",
                          locate_workers=0, write_marginal_coalescence=True)
    (path,) = [p for p in files if p.suffix == ".npy"]
    out = workspace["root"] / "runs" / "maps" / "locate" / path
    coa_map = np.load(out)
    assert coa_map.shape == tuple(workspace["lut"].node_count)
    assert coa_map.max() == 1.0
