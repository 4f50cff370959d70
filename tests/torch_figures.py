# -*- coding: utf-8 -*-
"""
What the port's figure tests share: the JAX package's pipeline objects
carried into the port's types (times, streams, tables, events, runs), a
capture of each figure at ``savefig`` (its pixels on Agg at a low dpi, or
its text and data), and the decoded frames of a GIF.

Both packages draw with the one ``matplotlib.pyplot`` of the process, so
one patch of ``plt.savefig`` catches the figures of either.

"""

import io

import numpy as np

LOW_DPI = 20


def port_time(t):
    """A JAX UTCDateTime (or anything else, unchanged) as the port's."""

    from quakemigrate_torch.seis import UTCDateTime
    from quakemigrate_tpu.seis import UTCDateTime as JaxUTCDateTime

    return UTCDateTime(ns=t._ns) if isinstance(t, JaxUTCDateTime) else t


def port_table(frame, index=None):
    """A pandas DataFrame as the port's Table, each UTCDateTime carried
    across (with ``index``, the frame's index first, under that name)."""

    from quakemigrate_torch.io.table import Table

    columns = {}
    if index is not None:
        columns[index] = list(frame.index)
    for name in frame.columns:
        values = frame[name].to_numpy()
        if values.dtype == object:
            values = [port_time(v) for v in values]
        columns[name] = values
    return Table(columns, list(columns))


def port_stream(stream):
    """A JAX Stream as the port's (data and header copied)."""

    from quakemigrate_torch.seis import Stream, Trace

    traces = []
    for tr in stream:
        header = {key: port_time(tr.stats[key]) for key in tr.stats.keys()}
        traces.append(Trace(data=np.array(tr.data, copy=True),
                            header=header))
    return Stream(traces)


def port_run(run):
    from quakemigrate_torch.io import Run

    return Run(run.path.parent, run.name, run.subname)


def port_onset_data(data):
    """A JAX OnsetData as the port's."""

    from quakemigrate_torch.signal.onsets.base import OnsetData

    return OnsetData(
        onsets={s: {p: np.array(o, copy=True) for p, o in v.items()}
                for s, v in data.onsets.items()},
        phases=list(data.phases), channel_maps=dict(data.channel_maps),
        filtered_waveforms=port_stream(data.filtered_waveforms),
        availability=dict(data.availability),
        starttime=port_time(data.starttime), endtime=port_time(data.endtime),
        sampling_rate=data.sampling_rate)


def port_event(event):
    """A located JAX Event as the port's, with the JAX event's numbers."""

    from quakemigrate_torch.io import Event

    out = Event(event.marginal_window)
    out.uid = event.uid
    out.trigger_time = port_time(event.trigger_time)
    out.trigger_info = dict(event.trigger_info)
    out.coa_data = port_table(event.coa_data.reset_index(drop=True))
    out.map4d = None if event.map4d is None else np.array(event.map4d)
    out.onset_data = (None if event.onset_data is None
                      else port_onset_data(event.onset_data))
    out.otime = port_time(event.otime)
    out.locations = {k: dict(v) for k, v in event.locations.items()}
    out.localmag = dict(event.localmag)
    if event.picks:
        out.picks = dict(event.picks, df=port_table(event.picks["df"]))
        out.picks["pick_windows"] = {
            s: {p: list(w) for p, w in v.items()}
            for s, v in event.picks["pick_windows"].items()}
    return out


def port_lut(jax_lut):
    from quakemigrate_torch.lut import lut_from_reference
    from torch_synthetic import reference_state

    return lut_from_reference(reference_state(jax_lut))


def pixels(fig, dpi=LOW_DPI):
    """The figure drawn on Agg at ``dpi``, as an RGBA array."""

    from PIL import Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=dpi)
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGBA"))


def figure_data(fig):
    """What a figure shows: its texts (every Text artist with a string,
    in drawing order), the arrays of its meshes and images, and the data
    of its lines."""

    from matplotlib.collections import QuadMesh
    from matplotlib.image import AxesImage
    from matplotlib.lines import Line2D
    from matplotlib.text import Text

    fig.canvas.draw()
    texts = [t.get_text() for t in fig.findobj(Text) if t.get_text()]
    arrays = [np.ma.filled(np.asarray(a.get_array(), dtype=float), np.nan)
              for a in fig.findobj(lambda a: isinstance(a, (QuadMesh,
                                                            AxesImage)))]
    lines = [np.asarray(line.get_xydata(), dtype=float)
             for line in fig.findobj(Line2D)]
    return {"texts": texts, "arrays": arrays, "lines": lines}


class SavefigCapture:
    """Patches ``matplotlib.pyplot.savefig`` (through ``monkeypatch``):
    each call records ``what(current figure)`` under the file's path and
    writes nothing (with ``write``, writes the file too)."""

    def __init__(self, monkeypatch, what=pixels, write=False):
        import matplotlib.pyplot as plt

        self.figures = {}
        real = plt.savefig

        def savefig(fname, *args, **kwargs):
            self.figures[str(fname)] = what(plt.gcf())
            if write:
                real(fname, *args, **kwargs)

        monkeypatch.setattr(plt, "savefig", savefig)


def gif_frames(path):
    """The decoded RGBA frames of a GIF."""

    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return [np.asarray(frame.convert("RGBA"))
                for frame in ImageSequence.Iterator(im)]
