# -*- coding: utf-8 -*-
"""
The port's figures (quakemigrate_torch.plot) against the JAX package's,
pixel for pixel: each port function and its JAX counterpart are fed equal
inputs and drawn on Agg at a low dpi (captured at ``savefig``, or from
the figure they return), and the RGBA arrays must be equal, tolerance 0;
the event video's decoded GIF frames likewise.

The inputs come from one JAX detect -> trigger -> locate over the
synthetic workspace (tests/torch_synthetic.py) with every figure option
on, its figure functions replaced by captures (module fixture): the
trigger summary's arguments, the located event and its marginalised map,
and the pick figures' arguments. The LUT is carried across
(``lut_from_reference``), and the port's Event and tables are filled with
the JAX objects' numbers (tests/torch_figures.py). The amplitude figure
takes a seeded amplitude table.

"""

import numpy as np
import pytest
import torch

import matplotlib.pyplot as plt

import torch_figures as tf
import torch_synthetic as ws

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX pipeline with every figure option on, each figure function
    replaced by a capture of its arguments."""

    import quakemigrate_tpu.plot.trigger as jtrigger
    from quakemigrate_tpu import QuakeScan, Trigger
    from quakemigrate_tpu.io import Archive
    from quakemigrate_tpu.signal import onsets
    from quakemigrate_tpu.signal.pickers import GaussianPicker

    workspace = ws.build_workspace(tmp_path_factory.mktemp("torch_plot"))
    captured = {"picks": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrigger, "trigger_summary",
                   lambda *a, **k: captured.update(trigger=(a, k)))
        mp.setattr(QuakeScan, "_write_event_figures",
                   lambda self, event, coa_map: captured.update(
                       event=event, coa_map=coa_map))
        mp.setattr(GaussianPicker, "plot",
                   lambda self, *a: captured["picks"].append(a))
        runs = workspace["root"] / "runs"
        archive = Archive(archive_path=workspace["archive"],
                          stations=workspace["stations"],
                          archive_format="YEAR/JD/STATION")
        onset = ws.make_onset(onsets)
        scan = QuakeScan(archive, workspace["lut"], onset=onset,
                         run_path=str(runs), run_name="jax",
                         timestep=ws.TIMESTEP,
                         marginal_window=ws.MARGINAL_WINDOW,
                         picker=GaussianPicker(onset=onset, plot_picks=True),
                         plot_event_summary=True, plot_event_video=True,
                         compilation_cache=False)
        scan.detect(ws.START, ws.END)
        Trigger(workspace["lut"], run_path=str(runs), run_name="jax",
                **ws.TRIGGER).trigger(ws.START, ws.END)
        scan.locate(ws.START, ws.END)
    assert {"trigger", "event"} <= set(captured) and captured["picks"]
    captured["workspace"] = workspace
    captured["lut"] = tf.port_lut(workspace["lut"])
    captured["port_event"] = tf.port_event(captured["event"])
    return captured


def _equal_pixels(got, want):
    assert got.shape == want.shape
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _one_figure(capture):
    (figure,) = capture.figures.values()
    capture.figures.clear()
    return figure


# -- plot/lut.py and LUT.plot -------------------------------------------------

@pytest.mark.parametrize("case", ["bare", "slices", "stations", "method"])
def test_lut_plot_equals_jax(jax_run, case):
    from quakemigrate_torch.plot.lut import lut_plot
    from quakemigrate_tpu.plot.lut import lut_plot as j_lut_plot

    from quakemigrate_torch.plot.event import _map_slices

    jlut, lut = jax_run["workspace"]["lut"], jax_run["lut"]
    event = jax_run["event"]
    kwargs = {}
    if case in ("slices", "method"):
        ijk = jlut.index2coord(event.hypocentre, inverse=True)[0]
        kwargs = dict(slices=_map_slices(jax_run["coa_map"], ijk),
                      hypocentre=event.hypocentre)
    if case == "stations":
        kwargs = dict(station_list=["ST01", "ST04", "ST07"], station_clr="r")
    drawn = []
    for draw, table in ((j_lut_plot, jlut), (lut_plot, lut)):
        fig = plt.figure(figsize=(10, 8))
        if case == "method":
            table.plot(fig, (9, 15), **kwargs)
        else:
            draw(table, fig, (9, 15), **kwargs)
        drawn.append(tf.pixels(fig))
        plt.close(fig)
    _equal_pixels(drawn[1], drawn[0])


# -- plot/xy.py ------------------------------------------------------------------

def test_plot_xy_files_equals_jax(tmp_path):
    from quakemigrate_torch.plot.xy import plot_xy_files
    from quakemigrate_tpu.plot.xy import plot_xy_files as j_plot_xy_files

    rng = np.random.default_rng(7)
    coast = tmp_path / "coast.csv"
    np.savetxt(coast, np.cumsum(rng.normal(size=(40, 2)), axis=0),
               delimiter=",", header="lon,lat")
    outline = tmp_path / "outline.csv"
    np.savetxt(outline, rng.uniform(-1, 1, size=(12, 2)), delimiter=",")
    spec = tmp_path / "xy.csv"
    spec.write_text(f"# File,Color,Linewidth,Linestyle\n{coast},k,1.5,-\n"
                    "missing.csv,r,1,--\nbad,row\n"
                    f"{outline.name},#238b45,0.8,:\n")
    drawn = []
    for draw in (j_plot_xy_files, plot_xy_files):
        fig, ax = plt.subplots(figsize=(6, 5))
        draw(spec, ax)
        drawn.append(tf.pixels(fig, dpi=40))
        plt.close(fig)
    _equal_pixels(drawn[1], drawn[0])


# -- plot/event.py ------------------------------------------------------------

@pytest.mark.parametrize("plot_all_stns, xy", [(True, False), (False, True)])
def test_event_summary_equals_jax(jax_run, monkeypatch, tmp_path,
                                  plot_all_stns, xy):
    from quakemigrate_torch.plot.event import event_summary
    from quakemigrate_tpu.io import Run as JRun
    from quakemigrate_tpu.plot.event import event_summary as j_event_summary

    xy_files = None
    if xy:
        coast = tmp_path / "coast.csv"
        coast.write_text("-0.05,-0.05\n0.0,0.02\n0.05,-0.01\n")
        xy_files = tmp_path / "xy.csv"
        xy_files.write_text(f"{coast},b,1.0,-\n")
    jax_event = jax_run["event"]
    availability = jax_event.onset_data.availability
    saved = dict(availability)
    # One station out, which plot_all_stns=False leaves off the map
    availability[sorted(availability)[0]] = 0
    try:
        port_event = tf.port_event(jax_event)
        run = JRun(tmp_path, "figs")
        capture = tf.SavefigCapture(monkeypatch)
        j_event_summary(run, jax_event, jax_run["coa_map"],
                        jax_run["workspace"]["lut"], xy_files=xy_files,
                        plot_all_stns=plot_all_stns)
    finally:
        availability.update(saved)
    want = _one_figure(capture)
    event_summary(tf.port_run(run), port_event, jax_run["coa_map"],
                  jax_run["lut"], xy_files=xy_files,
                  plot_all_stns=plot_all_stns)
    (path, got), = capture.figures.items()
    assert path == str(tmp_path / "figs" / "locate" / "summaries"
                       / f"figs_{jax_event.uid}_EventSummary.pdf")
    _equal_pixels(got, want)


def test_event_summary_with_magnitude_equals_jax(jax_run, monkeypatch,
                                                 tmp_path):
    from quakemigrate_torch.plot.event import event_summary
    from quakemigrate_tpu.io import Run as JRun
    from quakemigrate_tpu.plot.event import event_summary as j_event_summary

    jax_event = jax_run["event"]
    port_event = tf.port_event(jax_event)
    for event in (jax_event, port_event):
        event.add_local_magnitude(1.234, 0.125, 0.875)
    run = JRun(tmp_path, "mags")
    capture = tf.SavefigCapture(monkeypatch)
    try:
        j_event_summary(run, jax_event, jax_run["coa_map"],
                        jax_run["workspace"]["lut"])
    finally:
        jax_event.localmag = {}
    want = _one_figure(capture)
    event_summary(tf.port_run(run), port_event, jax_run["coa_map"],
                  jax_run["lut"])
    _equal_pixels(_one_figure(capture), want)


# -- plot/video.py -----------------------------------------------------------

def test_event_video_equals_jax(jax_run, tmp_path):
    from quakemigrate_torch.plot.video import event_video
    from quakemigrate_tpu.io import Run as JRun
    from quakemigrate_tpu.plot.video import event_video as j_event_video

    jax_event = jax_run["event"]
    assert jax_event.map4d is not None
    files = [
        j_event_video(JRun(tmp_path / "jax", "video"), jax_event,
                      jax_run["workspace"]["lut"], max_frames=3),
        event_video(tf.port_run(JRun(tmp_path / "port", "video")),
                    jax_run["port_event"], jax_run["lut"], max_frames=3),
    ]
    assert [f.relative_to(tmp_path / k) for f, k in
            zip(files, ("jax", "port"))] == [
        files[0].relative_to(tmp_path / "jax")] * 2
    want, got = (tf.gif_frames(f) for f in files)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _equal_pixels(a, b)


# -- plot/trigger.py -----------------------------------------------------------

def _trigger_args(jax_run, case):
    """The captured trigger_summary arguments, for ``case``: as the JAX
    trigger drew them, with the event discarded by a region that holds
    none of it, or without the availability files."""

    args, kwargs = jax_run["trigger"]
    args, kwargs = list(args), dict(kwargs)
    events = args[0]
    if case == "region":
        args[11] = [0.03, 0.03, 0.0, 0.06, 0.06, 5.0]
        args[0], args[12] = events.iloc[0:0], events
    if case == "stations":
        kwargs["plot_all_stns"] = False
    return args, kwargs


def _port_trigger_args(args, kwargs, run):
    args = list(args)
    args[0] = tf.port_table(args[0])
    args[1], args[2] = tf.port_time(args[1]), tf.port_time(args[2])
    args[3] = tf.port_run(run)
    args[9] = None  # set by the caller
    args[10] = tf.port_table(args[10])
    args[12] = tf.port_table(args[12])
    return args, kwargs


@pytest.mark.parametrize("case", ["triggered", "region", "stations",
                                  "no_availability"])
def test_trigger_summary_equals_jax(jax_run, monkeypatch, tmp_path, case):
    import shutil

    from quakemigrate_torch.plot.trigger import trigger_summary
    from quakemigrate_tpu.io import Run as JRun
    from quakemigrate_tpu.plot.trigger import (
        trigger_summary as j_trigger_summary,
    )

    args, kwargs = _trigger_args(jax_run, case)
    run = JRun(tmp_path, "trig", stage="trigger")
    if case != "no_availability":
        shutil.copytree(args[3].path / "detect", run.path / "detect")
    args[3] = run
    capture = tf.SavefigCapture(monkeypatch)
    j_trigger_summary(*args, **kwargs)
    want = _one_figure(capture)
    port_args, port_kwargs = _port_trigger_args(args, kwargs, run)
    port_args[9] = jax_run["lut"]
    trigger_summary(*port_args, **port_kwargs)
    (path, got), = capture.figures.items()
    assert path == str(tmp_path / "trig" / "trigger" / "summaries"
                       / "trig_2021_049_Trigger.pdf")
    _equal_pixels(got, want)


def test_trigger_summary_interactive_shows(jax_run, monkeypatch, tmp_path):
    from quakemigrate_torch.plot.trigger import trigger_summary
    from quakemigrate_tpu.io import Run as JRun

    args, kwargs = _trigger_args(jax_run, "triggered")
    port_args, port_kwargs = _port_trigger_args(args, kwargs,
                                                JRun(tmp_path, "show"))
    port_args[9], port_args[13] = jax_run["lut"], True
    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(plt.gcf()))
    capture = tf.SavefigCapture(monkeypatch)
    trigger_summary(*port_args, **port_kwargs)
    assert len(capture.figures) == 1 and len(shown) == 1


# -- plot/phase_picks.py --------------------------------------------------------

@pytest.mark.parametrize("which", [0, -1])
def test_pick_summary_equals_jax(jax_run, which):
    from quakemigrate_torch.plot.phase_picks import pick_summary
    from quakemigrate_tpu.plot.phase_picks import (
        pick_summary as j_pick_summary,
    )

    event, station, onset_data, picks, ttimes, _ = jax_run["picks"][which]
    port_event = jax_run["port_event"]
    rows = picks[picks["Station"] == station].reset_index(drop=True)
    fig = j_pick_summary(
        event, station, onset_data.filtered_waveforms.select(station=station),
        rows, onset_data.onsets[station], onset_data.channel_maps, ttimes,
        event.picks["pick_windows"][station])
    want = tf.pixels(fig)
    plt.close(fig)
    port_data = tf.port_onset_data(onset_data)
    fig = pick_summary(
        port_event, station,
        port_data.filtered_waveforms.select(station=station),
        tf.port_table(rows), port_data.onsets[station],
        port_data.channel_maps, ttimes,
        port_event.picks["pick_windows"][station])
    got = tf.pixels(fig)
    plt.close(fig)
    _equal_pixels(got, want)


def test_gaussian_picker_plot_writes_the_jax_path(jax_run, monkeypatch,
                                                  tmp_path):
    from quakemigrate_torch.signal.pickers import GaussianPicker
    from quakemigrate_tpu.io import Run as JRun
    from quakemigrate_tpu.signal.pickers import (
        GaussianPicker as JGaussianPicker,
    )

    event, station, onset_data, picks, ttimes, _ = jax_run["picks"][0]
    run = JRun(tmp_path, "picks")
    capture = tf.SavefigCapture(monkeypatch)
    JGaussianPicker.plot.__wrapped__(None, event, station, onset_data, picks,
                                     ttimes, run)
    want = capture.figures.copy()
    capture.figures.clear()
    port_event = jax_run["port_event"]
    GaussianPicker().plot(port_event, station,
                          tf.port_onset_data(onset_data),
                          tf.port_table(picks), ttimes, tf.port_run(run))
    assert list(capture.figures) == list(want)
    _equal_pixels(*capture.figures.values(), *want.values())


# -- plot/amplitudes.py ------------------------------------------------------------

def _amplitude_frame(seed):
    """A seeded amplitude table as the JAX package's frame (trace IDs as
    the index) and the port's Table (the IDs in its ``id`` column)."""

    import pandas as pd

    rng = np.random.default_rng(seed)
    ids = [f"SC.ST{s:02d}..HH{c}" for s in range(6) for c in "EN"]
    dist = np.repeat(rng.uniform(2.0, 40.0, 6), 2)
    frame = pd.DataFrame({
        "S_amp": 10 ** rng.uniform(-3, -1, len(ids)),
        "Noise_amp": 10 ** rng.uniform(-4.5, -3.5, len(ids)),
        "Station_Correction": rng.normal(0, 0.1, len(ids)),
        "Dist": dist,
        "Used": rng.uniform(size=len(ids)) > 0.3,
    }, index=ids)
    return frame, tf.port_table(frame, index="id")


@pytest.mark.parametrize("use_hyp_dist, dist_filter", [(False, False),
                                                       (True, 30.0)])
def test_plot_amplitudes_vs_distance_equals_jax(jax_run, monkeypatch,
                                                tmp_path, use_hyp_dist,
                                                dist_filter):
    from quakemigrate_torch.plot.amplitudes import plot_amplitudes_vs_distance
    from quakemigrate_torch.signal.local_mag import Magnitude
    from quakemigrate_tpu.io import Run as JRun
    from quakemigrate_tpu.plot.amplitudes import (
        plot_amplitudes_vs_distance as j_plot,
    )
    from quakemigrate_tpu.signal.local_mag import Magnitude as JMagnitude

    params = {"A0": "Hutton-Boore", "amp_feature": "S_amp",
              "use_hyp_dist": use_hyp_dist, "dist_filter": dist_filter}
    frame, table = _amplitude_frame(5)
    jax_event = jax_run["event"]
    port_event = tf.port_event(jax_event)
    run = JRun(tmp_path, "amps")
    capture = tf.SavefigCapture(monkeypatch)
    jax_event.add_local_magnitude(1.4, 0.2, 0.81)
    try:
        j_plot(JMagnitude(params), frame, jax_event, run, 1000.0)
    finally:
        jax_event.localmag = {}
    want = _one_figure(capture)
    port_event.add_local_magnitude(1.4, 0.2, 0.81)
    plot_amplitudes_vs_distance(Magnitude(params), table, port_event,
                                tf.port_run(run), 1000.0)
    (path, got), = capture.figures.items()
    assert path == str(tmp_path / "amps" / "locate" / "amplitude_plots"
                       / f"amps_{jax_event.uid}_AmpVsDistance.pdf")
    _equal_pixels(got, want)
