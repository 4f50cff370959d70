# -*- coding: utf-8 -*-
"""
The port's trigger stage (quakemigrate_torch.signal.trigger.Trigger,
io.read_scanmseed and io.triggered_events) and its detect resume, against
the JAX package on the synthetic workspace (tests/torch_synthetic.py):
both packages run detect -> trigger over it once (module fixture).

- read_scanmseed of the JAX .scanmseed equal to JAX's read;
- the static, MAD and median-ratio thresholds and the smoothing equal to
  JAX's on the same trace (1e-12 relative), and chunks2trace;
- the candidates and the refined events row for row, at thresholds that
  make several candidates, and the region filter;
- the TriggeredEvents file of the synthetic run: the same header and the
  same rows (text equal, numbers within 1e-9 relative);
- each package reading the other's TriggeredEvents file;
- detect(resume=True) in the four cases of tests/test_detect_resume.py.

"""

import csv

import numpy as np
import pandas as pd
import pytest
import torch

from quakemigrate_tpu.io import Run as JRun
from quakemigrate_tpu.io import read_scanmseed as j_read_scanmseed
from quakemigrate_tpu.io import read_triggered_events as j_read_triggered
from quakemigrate_tpu.seis import UTCDateTime as JUTCDateTime
from quakemigrate_tpu.seis import read as j_read
from quakemigrate_tpu.signal import Trigger as JTrigger
from quakemigrate_tpu.signal.trigger import chunks2trace as j_chunks2trace
from quakemigrate_torch import util
from quakemigrate_torch.io import Run, read_scanmseed, read_triggered_events
from quakemigrate_torch.seis import UTCDateTime
from quakemigrate_torch.signal import Trigger
from quakemigrate_torch.signal.trigger import chunks2trace

import torch_synthetic as ws

torch.set_num_threads(1)

MID = "2021-02-18T12:00:35.0"
PAD = 30.0


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return ws.build_workspace(tmp_path_factory.mktemp("torch_trigger"))


@pytest.fixture(scope="module")
def runs(workspace):
    jax_dir = ws.jax_pipeline(workspace, "jax", locate=False)
    port_dir, scan = ws.port_pipeline(workspace, "port", locate=False)
    return {"jax": jax_dir, "port": port_dir, "scan": scan}


def _read_both(runs, run="jax"):
    """(port's read, JAX's read) of one run's .scanmseed."""

    start, end = UTCDateTime(ws.START), UTCDateTime(ws.END)
    port = read_scanmseed(Run(runs[run].parent, run), start, end, PAD,
                          1000.0)
    jax = j_read_scanmseed(JRun(runs[run].parent, run), JUTCDateTime(ws.START),
                           JUTCDateTime(ws.END), PAD, 1000.0)
    return port, jax


def _triggers(lut=None, **options):
    """A port Trigger and a JAX one with the same options."""

    settings = {**ws.TRIGGER, "plot_trigger_summary": False, **options}
    port = Trigger(lut, run_path="unused", run_name="unused", **settings)
    jax = JTrigger(lut, run_path="unused", run_name="unused", **settings)
    return port, jax


def test_read_scanmseed_equals_jax(runs):
    (table, stats), (frame, j_stats) = _read_both(runs)
    assert table.names == list(frame.columns)
    assert len(table) == len(frame) == 5 * 5 * ws.SPS
    np.testing.assert_array_equal(table["DT"], frame["DT"].to_numpy())
    for name in ("COA", "COA_N", "X", "Y", "Z"):
        np.testing.assert_array_equal(table[name], frame[name].to_numpy())
    assert str(stats.starttime) == str(j_stats.starttime)
    assert stats.npts == j_stats.npts


def test_read_scanmseed_without_files_raises(tmp_path):
    with pytest.raises(util.NoScanMseedDataException):
        read_scanmseed(Run(tmp_path, "none"), UTCDateTime(ws.START),
                       UTCDateTime(ws.END), 0.0, 1000.0)


@pytest.mark.parametrize("method, options", [
    ("static", {"static_threshold": 1.3}),
    ("mad", {"mad_window_length": 7.0, "mad_multiplier": 3.0}),
    ("median_ratio", {"median_window_length": 6.0,
                      "median_multiplier": 1.5}),
])
def test_threshold_equals_jax(runs, method, options):
    (table, _), (frame, _) = _read_both(runs)
    port, jax = _triggers(threshold_method=method, **options)
    got = port._get_threshold(table["COA_N"], ws.SPS)
    want = jax._get_threshold(frame["COA_N"], ws.SPS)
    assert got.shape == want.shape == (len(table),)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_smoothing_equals_jax(runs):
    (table, _), (frame, _) = _read_both(runs)
    port, jax = _triggers(smooth_coa=True, smoothing_kernel_sigma=0.15,
                          smoothing_kernel_width=3.0)
    got = port._smooth_coa(table, ws.SPS)
    want = jax._smooth_coa(frame.copy(), ws.SPS)
    for name in ("COA", "COA_N"):
        np.testing.assert_allclose(got[name], want[name].to_numpy(),
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("values, shape", [
    ([1.0, 2.0, 3.0], (3, 4)), ([0.5], (1, 7)), ([4, 5], (2, 1)),
])
def test_chunks2trace_equals_jax(values, shape):
    np.testing.assert_array_equal(chunks2trace(values, shape),
                                  j_chunks2trace(values, shape))


def _assert_rows_equal(got, want):
    """A port Table and a JAX DataFrame with the same rows: times as
    text, numbers equal."""

    assert got.names == list(want.columns)
    assert len(got) == len(want)
    for name in got.names:
        for a, b in zip(got[name], want[name]):
            if isinstance(a, (float, np.floating)):
                assert a == b, name
            else:
                assert str(a) == str(b), name


# Below the event's peak (4.7) the normalised trace crosses these
# thresholds in noise too: 52, 16 and 12 candidates
LOW_TRIGGER = dict(marginal_window=0.1, min_event_interval=0.2)


@pytest.mark.parametrize("threshold", [1.45, 1.5, 2.0])
def test_candidates_and_refined_events_equal_jax(runs, threshold):
    (table, _), (frame, _) = _read_both(runs)
    port, jax = _triggers(static_threshold=threshold, **LOW_TRIGGER)
    got = port._identify_candidates(
        table, "COA_N", port._get_threshold(table["COA_N"], ws.SPS))
    want = jax._identify_candidates(
        frame, "COA_N", jax._get_threshold(frame["COA_N"], ws.SPS))
    assert len(got) > 10
    _assert_rows_equal(got, want)
    refined = port._refine_candidates(got)
    assert 1 < len(refined) < len(got)  # some merged
    _assert_rows_equal(refined, jax._refine_candidates(want))


def _low_threshold_events(runs):
    """Each package's refined events at threshold 1.45 (14 events)."""

    (table, _), (frame, _) = _read_both(runs)
    port, jax = _triggers(static_threshold=1.45, **LOW_TRIGGER)
    got = port._refine_candidates(port._identify_candidates(
        table, "COA_N", np.full(len(table), 1.45)))
    want = jax._refine_candidates(jax._identify_candidates(
        frame, "COA_N", np.full(len(frame), 1.45)))
    return (port, got), (jax, want)


@pytest.mark.parametrize("region", [
    None, [-0.01, -0.01, 0.0, 0.01, 0.01, 20.0],
    [-0.06, -0.06, 10.0, 0.06, 0.06, 20.0],
])
def test_region_filter_equals_jax(runs, region):
    (port, events), (jax, frame) = _low_threshold_events(runs)
    got = port._filter_events(events, UTCDateTime(ws.START),
                              UTCDateTime(ws.END), region)
    want = jax._filter_events(frame, JUTCDateTime(ws.START),
                              JUTCDateTime(ws.END), region)
    _assert_rows_equal(got, want.reset_index(drop=True))
    if region is None:
        assert len(got) == len(events) > 1
    else:
        assert 0 < len(got) < len(events)


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _trigger_file(run_dir, name):
    return run_dir / "trigger" / "events" / (
        f"{name}_2021_049_TriggeredEvents.csv")


def test_triggered_events_file_equals_jax(runs):
    got = _csv_rows(_trigger_file(runs["port"], "port"))
    want = _csv_rows(_trigger_file(runs["jax"], "jax"))
    assert got[0] == want[0] == ["EventID", "CoaTime", "TRIG_COA", "COA_X",
                                 "COA_Y", "COA_Z", "COA", "COA_NORM"]
    assert len(got) == len(want) == 2  # the one planted event
    for a, b in zip(got[1], want[1]):
        try:
            x, y = float(a), float(b)
        except ValueError:
            assert a == b
        else:
            assert abs(x - y) <= 1e-9 * abs(y)


def test_time_window_columns_written_as_jax(runs, tmp_path):
    """write_event_time_windows: the same text as the JAX writer, for the
    same refined events (several, at a low threshold)."""

    from quakemigrate_tpu.io import write_triggered_events as j_write
    from quakemigrate_torch.io import write_triggered_events

    (_, got), (_, want) = _low_threshold_events(runs)
    assert len(got) > 1
    start = UTCDateTime(ws.START)
    write_triggered_events(Run(tmp_path, "port"), got, start, True)
    j_write(JRun(tmp_path, "jax"), want, JUTCDateTime(ws.START), True)
    got_rows = _csv_rows(_trigger_file(tmp_path / "port", "port"))
    want_rows = _csv_rows(_trigger_file(tmp_path / "jax", "jax"))
    assert got_rows == want_rows
    assert got_rows[0][-2:] == ["MinTime", "MaxTime"]


def test_each_package_reads_the_others_file(runs, tmp_path):
    port_file = _trigger_file(runs["port"], "port")
    jax_file = _trigger_file(runs["jax"], "jax")
    # The JAX reader on the port's file, against its own file
    got = j_read_triggered(None, trigger_file=port_file)
    want = j_read_triggered(None, trigger_file=jax_file)
    assert list(got.columns) == list(want.columns)
    for name in want.columns:
        if name == "CoaTime":
            assert [str(t) for t in got[name]] == [str(t) for t in want[name]]
        else:
            np.testing.assert_allclose(got[name].astype(float),
                                       want[name].astype(float), rtol=1e-9)
    # The port's reader on the JAX file, by span as locate reads it
    run = Run(runs["jax"].parent, "jax")
    events = read_triggered_events(run, starttime=UTCDateTime(ws.START),
                                   endtime=UTCDateTime(ws.END))
    assert events.names == list(want.columns)[1:]  # JAX adds "index"
    assert [str(e) for e in events["EventID"]] == [
        str(e) for e in want["EventID"]]
    assert [str(t) for t in events["CoaTime"]] == [
        str(t) for t in want["CoaTime"]]
    for name in ("TRIG_COA", "COA_X", "COA_Y", "COA_Z", "COA", "COA_NORM"):
        np.testing.assert_array_equal(events[name], want[name].to_numpy())
    # A span past the events reads none
    assert read_triggered_events(
        run, starttime=UTCDateTime(ws.START),
        endtime=UTCDateTime("2021-02-18T12:00:25.0")).empty
    with pytest.raises(util.NoTriggerFilesFound):
        read_triggered_events(Run(tmp_path, "none"),
                              starttime=UTCDateTime(ws.START),
                              endtime=UTCDateTime(ws.END))


def test_trigger_options_validated(runs, tmp_path, monkeypatch):
    """The options' checks; and interactive_plot, once refused, shows the
    trigger summary after it is saved."""

    import shutil

    import matplotlib.pyplot as plt

    with pytest.raises(util.InvalidTriggerThresholdMethodException):
        _triggers()[0].threshold_method = "peak"
    port = _triggers()[0]
    with pytest.raises(ValueError, match="marginal window"):
        port.min_event_interval = 1.5
    shutil.copytree(runs["port"] / "detect", tmp_path / "shown" / "detect")
    saved, shown = [], []
    monkeypatch.setattr(plt, "savefig", lambda fname, *a, **k: saved.append(
        (str(fname), plt.gcf())))
    monkeypatch.setattr(plt, "show", lambda: shown.append(plt.gcf()))
    Trigger(runs["scan"].lut, run_path=str(tmp_path), run_name="shown",
            **ws.TRIGGER).trigger(ws.START, ws.END, interactive_plot=True)
    summary = (tmp_path / "shown" / "trigger" / "summaries"
               / "shown_2021_049_Trigger.pdf")
    assert [path for path, _ in saved] == [str(summary)]
    assert shown == [saved[0][1]]


# -- detect(resume=True), the cases of tests/test_detect_resume.py ----------

def _scanmseed_file(workspace, name):
    return (workspace["root"] / "runs" / name / "detect" / "scanmseed"
            / "2021_049.scanmseed")


def _availability(workspace, name):
    return pd.read_csv(workspace["root"] / "runs" / name / "detect"
                       / "availability" / "2021_049_StationAvailability.csv",
                       index_col=0)


def test_resumed_detect_matches_uninterrupted(workspace, runs):
    ws.port_scan(workspace, "pieces").detect(ws.START, MID)
    ws.port_scan(workspace, "pieces").detect(ws.START, ws.END, resume=True)
    whole = j_read(str(_scanmseed_file(workspace, "port")))
    pieces = j_read(str(_scanmseed_file(workspace, "pieces")))
    for channel in ("COA", "COA_N", "X", "Y", "Z"):
        a = whole.select(station=channel)[0]
        b = pieces.select(station=channel)[0]
        assert a.stats.starttime == b.stats.starttime
        assert a.stats.npts == b.stats.npts, channel
        np.testing.assert_array_equal(a.data, b.data, err_msg=channel)
    pd.testing.assert_frame_equal(_availability(workspace, "port"),
                                  _availability(workspace, "pieces"))


def test_resume_noop_when_complete(workspace, runs):
    before = _scanmseed_file(workspace, "port").read_bytes()
    ws.port_scan(workspace, "port").detect(ws.START, ws.END, resume=True)
    assert _scanmseed_file(workspace, "port").read_bytes() == before


def test_resume_tolerates_corrupt_partial_file(workspace):
    target = _scanmseed_file(workspace, "crashy")
    target.parent.mkdir(parents=True)
    target.write_bytes(b"")  # a zero-byte file left by a crash
    ws.port_scan(workspace, "crashy").detect(ws.START, ws.END, resume=True)
    st = j_read(str(target))
    assert st.select(station="COA")[0].stats.npts == 25 * ws.SPS


def test_resume_ignores_unrelated_day_file(workspace):
    ws.port_scan(workspace, "gap").detect(MID, ws.END)
    assert _scanmseed_file(workspace, "gap").read_bytes()
    ws.port_scan(workspace, "gap").detect(ws.START, ws.END, resume=True)
    coa = j_read(str(_scanmseed_file(workspace, "gap"))).select(
        station="COA")[0]
    assert coa.stats.starttime == JUTCDateTime(ws.START)
    assert coa.stats.npts == 25 * ws.SPS
    assert (coa.data[: 5 * ws.SPS] != 0).any()  # the early span was scanned
