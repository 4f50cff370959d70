# -*- coding: utf-8 -*-
"""
Per-station pick summary figure: filtered waveforms per component, the
P/S onset functions with pick windows, thresholds, Gaussian fits and pick
times (reference: plot/phase_picks.py:21-321).

"""

import numpy as np

import quakemigrate_torch.util as util
from . import pyplot


def pick_summary(event, station, waveforms, picks, onsets, channel_maps,
                 ttimes, windows):
    """Build the pick summary figure; returns the figure. ``ttimes`` is
    the list of modelled traveltimes (seconds, one per phase in ``onsets``
    order) used for the modelled-arrival markers; pass None to fall back
    to the window midpoints. ``picks`` is the station's rows of the
    picks :class:`~quakemigrate_torch.io.table.Table`."""

    plt = pyplot()
    phases = list(onsets.keys())
    n_onsets = len(phases)

    p_str, s_str_1, s_str_2 = util.get_phase_component_strings(channel_maps)

    fig, axes = plt.subplots(
        3 + n_onsets, 1, figsize=(16, 12), sharex=True
    )
    fig.subplots_adjust(hspace=0.15)

    comp_selectors = [p_str, s_str_1, s_str_2]
    sampling_rate = starttime = None

    # --- Waveform panels ---
    for ax, comp in zip(axes[:3], comp_selectors):
        st = waveforms.select(channel=f"*{comp}")
        for tr in st:
            sampling_rate = tr.stats.sampling_rate
            starttime = tr.stats.starttime
            data = np.asarray(tr.data, dtype=float)
            peak = np.max(np.abs(data)) or 1.0
            ax.plot(
                tr.times(type="matplotlib"), data / peak, lw=0.5,
                label=tr.id,
            )
        ax.set_ylabel(f"{comp}")
        if len(st):
            ax.legend(fontsize=7, loc="upper right")

    # --- Onset panels with windows, fits and picks ---
    # All panels share one x-axis (sharex=True), so onset samples must be
    # placed on the same matplotlib-datenum scale as the waveforms: the
    # onsets start at the filtered waveforms' starttime.
    base = starttime.matplotlib_date if starttime is not None else 0.0
    per_day = (sampling_rate or 1.0) * 86400.0

    for i, (ax, phase) in enumerate(zip(axes[3:], phases)):
        onset = np.asarray(onsets[phase])
        n = len(onset)
        window = windows.get(phase)
        ax.plot(base + np.arange(n) / per_day, onset, c="k", lw=0.6,
                label=f"{phase} onset")
        if window:
            ax.axvspan(base + window[0] / per_day, base + window[2] / per_day,
                       alpha=0.15, color="orange")
        if (ttimes is not None and event.otime is not None
                and i < len(ttimes)):
            arrival = (event.otime + ttimes[i]).matplotlib_date
            ax.axvline(arrival, c="grey", ls="--", lw=1,
                       label="Modelled arrival")
        elif window:
            ax.axvline(base + window[1] / per_day, c="grey", ls="--", lw=1,
                       label="Modelled arrival")
        fits = event.picks.get("gaussfits", {}).get(station, {}).get(phase)
        if fits and not np.isscalar(fits.get("xdata", 0)):
            if sampling_rate:
                # The x_data is in seconds from the onset start
                xs = base + np.asarray(fits["xdata"]) / 86400.0
                ax.plot(
                    xs, util.gaussian_1d(np.asarray(fits["xdata"]),
                                         *fits["popt"]),
                    c="r", lw=1.2, label="Gaussian fit",
                )
            thresh = fits.get("PickThreshold")
            if thresh is not None and np.isfinite(thresh):
                ax.axhline(thresh, c="b", ls=":", lw=1, label="Threshold")
        ax.set_ylabel(f"{phase} onset")
        ax.legend(fontsize=7, loc="upper right")

    # --- Pick times on all panels (one shared datenum axis) ---
    colours = {"P": "r", "S": "b"}
    for pick in picks.rows():
        if pick["PickTime"] == -1:
            continue
        for ax in axes:
            ax.axvline(
                pick["PickTime"].matplotlib_date,
                c=colours.get(pick["Phase"], "g"), lw=1.0,
            )

    fig.suptitle(f"Pick summary: {event.uid} | {station}", fontsize=14)
    axes[-1].set_xlabel("DateTime")
    axes[-1].xaxis.set_major_formatter(util.DateFormatter("%H:%M:%S.{ms}", 2))

    return fig
