# -*- coding: utf-8 -*-
"""
The figures of the port's pipeline against the JAX package's: both
packages run detect -> trigger -> locate over the synthetic workspace
(tests/torch_synthetic.py) with every figure option on (the trigger
summary, GaussianPicker's pick figures, the event summary and the event
video), each into a run of the same name under its own root (module
fixture). Each figure is captured at ``savefig`` (its texts, the arrays
of its map panels and the data of its lines) and written; each frame of
the video at ``grab_frame`` (its map images and title).

- the same files at the same paths;
- the texts of each figure equal as strings; the map panels' arrays and
  the lines' data within 1e-5 of each array's largest magnitude (float32
  sums in another order); the video's frames likewise;
- the .event within one unit of its last written digit;
- locate_workers=0 and 4 writing the same files (the video left out);
- in a subprocess that refuses matplotlib, locate with the default
  options logging one warning and writing the .event, and with
  plot_event_video keeping the 4-D map.

Locate's marginal window is 0.25 s in this file (the trigger's is
1 s), which keeps the video to ~50 frames.

"""

import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_figures as tf
import torch_synthetic as ws

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
LOCATE_MARGINAL_WINDOW = 0.25
FIGURE_RTOL = 1e-5
RUN = "figs"


def _frame_data(fig):
    """A video frame's title and map images (no redraw)."""

    from matplotlib.image import AxesImage

    return {"texts": [fig._suptitle.get_text()],
            "arrays": [np.asarray(im.get_array(), dtype=float)
                       for im in fig.findobj(AxesImage)],
            "lines": []}


def _capture(mp, root):
    """Record each figure under its path relative to ``root``, and each
    video frame under ``frames``; the files are written too."""

    from matplotlib.animation import PillowWriter

    capture = tf.SavefigCapture(mp, what=tf.figure_data, write=True)
    frames = []
    grab = PillowWriter.grab_frame

    def grab_frame(self, **kwargs):
        frames.append(_frame_data(self.fig))
        return grab(self, **kwargs)

    mp.setattr(PillowWriter, "grab_frame", grab_frame)
    return capture, frames


def _relative(figures, root):
    return {str(pathlib.Path(path).relative_to(root)): data
            for path, data in figures.items()}


def _jax_run(workspace, root):
    from quakemigrate_tpu import QuakeScan, Trigger
    from quakemigrate_tpu.io import Archive
    from quakemigrate_tpu.signal import onsets
    from quakemigrate_tpu.signal.pickers import GaussianPicker

    archive = Archive(archive_path=workspace["archive"],
                      stations=workspace["stations"],
                      archive_format="YEAR/JD/STATION")
    onset = ws.make_onset(onsets)
    scan = QuakeScan(archive, workspace["lut"], onset=onset,
                     run_path=str(root), run_name=RUN, timestep=ws.TIMESTEP,
                     marginal_window=LOCATE_MARGINAL_WINDOW,
                     picker=GaussianPicker(onset=onset, plot_picks=True),
                     plot_event_summary=True, plot_event_video=True,
                     compilation_cache=False)
    scan.detect(ws.START, ws.END)
    Trigger(workspace["lut"], run_path=str(root), run_name=RUN,
            **ws.TRIGGER).trigger(ws.START, ws.END)
    scan.locate(ws.START, ws.END)


def _port_scan(workspace, root, **options):
    from quakemigrate_torch.io import Archive
    from quakemigrate_torch.lut import StationTable
    from quakemigrate_torch.signal import QuakeScan, onsets
    from quakemigrate_torch.signal.pickers import GaussianPicker

    archive = Archive(workspace["archive"],
                      StationTable.of(workspace["stations"]),
                      archive_format="YEAR/JD/STATION")
    onset = ws.make_onset(onsets)
    return QuakeScan(archive, tf.port_lut(workspace["lut"]), onset,
                     str(root), RUN, device="cpu", timestep=ws.TIMESTEP,
                     marginal_window=LOCATE_MARGINAL_WINDOW,
                     picker=GaussianPicker(onset=onset, plot_picks=True),
                     plot_event_summary=True, plot_event_video=True,
                     **options)


def _port_run(workspace, root):
    from quakemigrate_torch.signal import Trigger

    scan = _port_scan(workspace, root)
    scan.detect(ws.START, ws.END)
    Trigger(scan.lut, run_path=str(root), run_name=RUN,
            **ws.TRIGGER).trigger(ws.START, ws.END)
    scan.locate(ws.START, ws.END)
    return scan


@pytest.fixture(scope="module")
def figures(tmp_path_factory):
    workspace = ws.build_workspace(tmp_path_factory.mktemp("plot_locate"))
    out = {"workspace": workspace}
    for name, run in (("jax", _jax_run), ("port", _port_run)):
        root = workspace["root"] / f"{name}_runs"
        with pytest.MonkeyPatch.context() as mp:
            capture, frames = _capture(mp, root)
            run(workspace, root)
        run_dir = root / RUN
        out[name] = {
            "dir": run_dir,
            "files": sorted(str(p.relative_to(run_dir))
                            for p in run_dir.rglob("*")
                            if p.is_file() and p.suffix != ".log"),
            "figures": _relative(capture.figures, run_dir),
            "frames": frames,
        }
    return out


def test_same_files_at_the_same_paths(figures):
    got, want = figures["port"]["files"], figures["jax"]["files"]
    assert got == want
    for kind in ("trigger/summaries", "locate/summaries", "locate/videos",
                 "locate/pick_plots"):
        assert any(f.startswith(kind) for f in got), kind
    assert sorted(figures["port"]["figures"]) == sorted(
        figures["jax"]["figures"])


def _close(got, want, label):
    assert len(got) == len(want), label
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (label, i)
        scale = np.nanmax(np.abs(b)) if b.size else 0.0
        np.testing.assert_allclose(a, b, rtol=0, atol=FIGURE_RTOL * scale,
                                   equal_nan=True, err_msg=f"{label} {i}")


@pytest.mark.parametrize("kind", ["trigger", "event", "picks"])
def test_figures_equal_jax(figures, kind):
    prefix = {"trigger": "trigger/summaries", "event": "locate/summaries",
              "picks": "locate/pick_plots"}[kind]
    want = {k: v for k, v in figures["jax"]["figures"].items()
            if k.startswith(prefix)}
    assert want
    for path, data in want.items():
        got = figures["port"]["figures"][path]
        assert got["texts"] == data["texts"], path
        _close(got["arrays"], data["arrays"], f"{path} arrays")
        _close(got["lines"], data["lines"], f"{path} lines")


def test_video_frames_equal_jax(figures):
    got, want = figures["port"]["frames"], figures["jax"]["frames"]
    assert len(got) == len(want) > 10
    for i, (a, b) in enumerate(zip(got, want)):
        assert a["texts"] == b["texts"], i
        _close(a["arrays"], b["arrays"], f"frame {i}")
    (gif,) = figures["port"]["dir"].glob("locate/videos/*.gif")
    assert len(tf.gif_frames(gif)) == len(got)


def test_event_within_a_digit(figures):
    ws.assert_event_close(figures["port"]["dir"], figures["jax"]["dir"])


def test_locate_workers_write_the_same_files(figures, tmp_path):
    workspace = figures["workspace"]
    trigger_file = next((figures["port"]["dir"] / "trigger"
                         / "events").glob("*.csv"))
    written = []
    for workers in (0, 4):
        scan = _port_scan(workspace, tmp_path / f"w{workers}",
                          locate_workers=workers)
        scan.plot_event_video = False  # its frames: the fixture's run
        scan.locate(trigger_file=str(trigger_file))
        out = scan.run.path / "locate"
        written.append({str(p.relative_to(out)): p.stat().st_size > 0
                        for p in out.rglob("*")
                        if p.is_file() and p.suffix != ".log"})
    assert written[0] == written[1]
    want = {f[len("locate/"):] for f in figures["jax"]["files"]
            if f.startswith("locate/") and not f.endswith(".gif")}
    assert set(written[0]) == want and all(written[0].values())


_NO_MATPLOTLIB = r"""
import json, pathlib, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(1)
from quakemigrate_torch.io import Archive, read_lut
from quakemigrate_torch.lut import StationTable
from quakemigrate_torch.signal import QuakeScan, Trigger
from quakemigrate_torch.signal.onsets import STALTAOnset

root, archive_path, start, end = sys.argv[1:5]
root = pathlib.Path(root)
lut = read_lut(str(root / "lut"))
seen = {}
archive = Archive(archive_path, StationTable.of(lut.station_data),
                  archive_format="YEAR/JD/STATION")
onset = STALTAOnset(position="classic", sampling_rate=100)
onset.phases = ["P", "S"]
onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
print("== trigger", flush=True)
Trigger(lut, str(root), "run", marginal_window=1.0, min_event_interval=2.0,
        normalise_coalescence=True, static_threshold=1.8, pad=30.0
        ).trigger(start, end)
(trigger_file,) = (root / "run" / "trigger" / "events").glob("*.csv")
for name, video in (("default", False), ("video", True)):
    print(f"== {name}", flush=True)
    kept = []
    scan = QuakeScan(archive, lut, onset, str(root), name, device="cpu",
                     timestep=5.0, marginal_window=0.25,
                     plot_event_video=video)
    scan.on_event = lambda event, pass1, handle: kept.append(
        event.map4d is not None)
    scan.locate(trigger_file=str(trigger_file))
    seen[name] = kept
assert not [m for m in sys.modules if m.startswith("matplotlib")]
print(json.dumps(seen))
"""


def test_without_matplotlib(figures, tmp_path):
    """One warning a stage, the files but the figures written, and the
    4-D map kept for the video as with matplotlib."""

    workspace = figures["workspace"]
    root = tmp_path / "runs"
    shutil.copytree(figures["port"]["dir"] / "detect",
                    root / "run" / "detect")
    tf.port_lut(workspace["lut"]).save(str(root / "lut"))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_MATPLOTLIB, str(root),
         str(workspace["archive"]), ws.START, ws.END],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    seen = json.loads(lines[-1])
    warned, stage = {}, None
    for line in lines[:-1]:
        if line.startswith("== "):
            stage = line[3:]
        elif "matplotlib cannot be imported" in line:
            warned.setdefault(stage, []).append(line)
    assert sorted(warned) == ["default", "trigger", "video"] and all(
        len(w) == 1 for w in warned.values()), warned
    (trigger,) = warned["trigger"]
    assert "cannot be imported" in trigger and "plot_trigger_summary" in trigger
    (default,) = warned["default"]
    assert "cannot be imported" in default and "plot_event_summary" in default
    (video,) = warned["video"]
    assert "plot_event_summary, plot_event_video" in video
    assert seen == {"default": [False], "video": [True]}
    for name in ("default", "video"):
        locate = root / name / "locate"
        assert len(list((locate / "events").glob("*.event"))) == 1
        assert not list(locate.rglob("*.pdf")) + list(locate.rglob("*.gif"))
    assert not list((root / "run" / "trigger").rglob("*.pdf"))
