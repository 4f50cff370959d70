# -*- coding: utf-8 -*-
"""
Trigger summary figure, at visual parity with the reference's
plot/trigger.py:24-585: coalescence + normalised-coalescence traces with
marginal-window / minimum-event-interval shading and the detection
threshold, a per-phase station-availability step panel, a text summary
block, and the triggered events scattered (coloured by trigger
coalescence) over the LUT's three grid cross-sections, with the trigger
region outlined on all three views. The scan data, events and
availability are the port's :class:`~quakemigrate_torch.io.table.Table`s.

"""

import logging
import re

import numpy as np

import quakemigrate_torch.util as util
from quakemigrate_torch.io import read_availability
from quakemigrate_torch.seis import UTCDateTime
from . import pyplot

# Phase colours shared by the availability panel and event windows
_P_CLR = "#F03B20"
_S_CLR = "#3182BD"
_REGION_CLR = "#238b45"


@util.timeit()
def trigger_summary(
    events,
    starttime,
    endtime,
    run,
    marginal_window,
    min_event_interval,
    detection_threshold,
    threshold_string,
    normalise_coalescence,
    lut,
    data,
    region,
    discarded_events,
    interactive,
    xy_files=None,
    plot_all_stns=True,
):
    """
    Create and save the trigger summary figure (reference signature,
    plot/trigger.py:25-42).

    """

    plt = pyplot()
    times = util.date2num(data["DT"])

    fig = plt.figure(figsize=(30, 15))
    gs = (9, 18)

    # --- Right column: COA / COA_N / availability time panels ---
    ax_coa = plt.subplot2grid(gs, (0, 8), colspan=10, rowspan=3, fig=fig)
    ax_coan = plt.subplot2grid(gs, (3, 8), colspan=10, rowspan=3, fig=fig)
    ax_avail = plt.subplot2grid(gs, (6, 8), colspan=10, rowspan=3, fig=fig)
    for ax in (ax_coa, ax_coan):
        ax.sharex(ax_avail)
    for ax in (ax_coa, ax_coan, ax_avail):
        ax.set_xlim([starttime.matplotlib_date, endtime.matplotlib_date])
        ax.xaxis.set_major_formatter(
            util.DateFormatter("%H:%M:%S.{ms}", 2)
        )

    for ax, column, label in (
        (ax_coa, "COA", "Maximum coalescence"),
        (ax_coan, "COA_N", "Normalised maximum coalescence"),
    ):
        ax.plot(times, data[column], c="k", lw=0.3, alpha=0.8, zorder=10,
                label="Coalescence value")
        ax.set_ylabel(label, fontsize=14)

    # --- Station availability: per-phase station counts ---
    availability = None
    try:
        availability = read_availability(run, starttime, endtime)
    except Exception as e:  # util.NoStationAvailabilityDataException et al.
        logging.info(f"No station availability data found: {e}")
    if availability is not None:
        _availability_panel(ax_avail, availability, endtime)
    else:
        ax_avail.set_axis_off()
    ax_avail.set_xlabel("DateTime", fontsize=14)

    # --- Left column: LUT cross-sections (XY / XZ / YZ) ---
    from .lut import lut_plot

    station_list = None
    if availability is not None:
        columns = availability.names[1:]
        names = {col.rsplit("_", 1)[0] for col in columns}
        if not plot_all_stns:
            names = {
                col.rsplit("_", 1)[0]
                for col in columns
                if np.any(np.asarray(availability[col]) == 1)
            }
        station_list = sorted(names)
    lut_plot(lut, fig, gs, station_list=station_list)
    ax_xy, ax_xz, ax_yz = fig.axes[3], fig.axes[4], fig.axes[5]

    if xy_files is not None:
        from .xy import plot_xy_files

        plot_xy_files(xy_files, ax_xy)

    # --- Trigger region outline + discarded events ---
    if region is not None:
        _region_outline((ax_xy, ax_xz, ax_yz), region)
        _event_windows((ax_coa, ax_coan), discarded_events,
                       marginal_window, discarded=True)
        _event_scatter(fig, (ax_xy, ax_xz, ax_yz), discarded_events,
                       discarded=True)

    # --- Triggered events: trace windows + cross-section scatter ---
    if events is not None and len(events):
        _event_windows((ax_coa, ax_coan), events, marginal_window)
        _event_scatter(fig, (ax_xy, ax_xz, ax_yz), events)

    # --- Detection threshold on the triggering trace ---
    threshold_ax = ax_coan if normalise_coalescence else ax_coa
    threshold_ax.step(times, detection_threshold, where="mid", c="g",
                      label="Detection threshold")
    # The per-event spans re-add their labels each iteration; dedup.
    handles, labels = threshold_ax.get_legend_handles_labels()
    unique = dict(zip(labels, handles))
    threshold_ax.legend(unique.values(), unique.keys(), loc=1, fontsize=14,
                        framealpha=0.85).set_zorder(20)

    # --- Text summary block ---
    ax_text = plt.subplot2grid(gs, (0, 0), colspan=8, rowspan=2, fig=fig)
    window = f"{starttime.strftime('%Y-%m-%d %H:%M:%S')}  -  " \
             f"{endtime.strftime('%Y-%m-%d %H:%M:%S')}"
    ax_text.text(0.42, 0.8, window, fontsize=20, fontweight="bold",
                 ha="center")
    _text_summary(ax_text, events, threshold_string, marginal_window,
                  min_event_interval, normalise_coalescence)

    fig.tight_layout(pad=1, h_pad=0)
    plt.subplots_adjust(wspace=0.3, hspace=0.3)
    _align_cross_sections(fig, ax_xy, ax_xz, ax_yz)

    fpath = run.path / "trigger" / run.subname / "summaries"
    fpath.mkdir(exist_ok=True, parents=True)
    fstem = f"{run.name}_{starttime.year}_{starttime.julday:03d}_Trigger"
    file = (fpath / fstem).with_suffix(".pdf")
    plt.savefig(file)
    if interactive:
        plt.show()
    plt.close(fig)


def _flags(availability, regex=None):
    """[n_rows, n_columns] float flags of the availability columns whose
    names match ``regex`` (every column with None), as pandas' ``filter``
    selects them."""

    columns = [c for c in availability.names[1:]
               if regex is None or re.search(regex, c)]
    flags = np.empty((len(availability), len(columns)))
    for j, c in enumerate(columns):
        flags[:, j] = np.asarray(availability[c], dtype=float)
    return flags


def _availability_panel(ax, availability, endtime):
    """Step-plot the number of available stations per phase (collapsed to
    a single by-station trace when the phases never differ)."""

    columns = availability.names[1:]
    phases = sorted({col.rsplit("_", 1)[1] for col in columns})
    colours = {"P": _P_CLR, "S": _S_CLR}

    if len(phases) > 2 or any(ph not in colours for ph in phases):
        merged = [("*", "green", _flags(availability))]
    elif len(phases) == 2 and np.array_equal(
        _flags(availability, f"_{phases[0]}$"),
        _flags(availability, f"_{phases[1]}$"),
    ):
        # Identical for both phases: one by-station trace
        merged = [("*", "green", _flags(availability, f"_{phases[0]}$"))]
    else:
        merged = [
            (ph, colours[ph], _flags(availability, f"_{ph}$"))
            for ph in phases
        ]

    lo, hi = [], []
    step_dates = [UTCDateTime(t).matplotlib_date for t in availability["DT"]]
    for phase, colour, flags in merged:
        # pandas' row sum skips NaN (a day without the column)
        counts = np.nansum(flags, axis=1).astype(int)
        step_t = list(step_dates)
        # Hold the last value to the end of the trigger window
        step_t.append(endtime.matplotlib_date)
        counts = np.append(counts, counts[-1])
        ax.step(step_t, counts, c=colour, where="post", label=phase)
        lo.append(counts.min())
        hi.append(counts.max())

    y0, y1 = int(min(lo) * 0.8), int(np.ceil(max(hi) * 1.1))
    ax.set_ylim([y0, y1])
    ax.set_yticks(range(y0, y1 + 1))
    ax.set_ylabel("Available stations", fontsize=14)
    ax.text(0.01, 0.925, "Station availability", ha="left", va="center",
            transform=ax.transAxes, fontsize=14,
            bbox=dict(boxstyle="round", fc="w", alpha=0.8), zorder=20)
    if merged[0][0] != "*":
        ax.legend(loc=1, fontsize=14, framealpha=0.85).set_zorder(20)


def _event_windows(axes, events, marginal_window, discarded=False):
    """Shade each event's marginal window (blue) and the flanking
    minimum-event-interval guard (red); discarded events in grey."""

    if events is None or len(events) == 0:
        return
    for event in events.rows():
        t_min = event["MinTime"].matplotlib_date
        t_max = event["MaxTime"].matplotlib_date
        t_coa = event["CoaTime"].matplotlib_date
        mw_beg = (event["CoaTime"] - marginal_window).matplotlib_date
        mw_end = (event["CoaTime"] + marginal_window).matplotlib_date
        for ax in axes:
            if discarded:
                ax.axvspan(t_min, t_max, alpha=0.2, color="grey")
                ax.axvline(t_coa, lw=0.01, alpha=0.4, color="grey")
            else:
                ax.axvspan(t_min, mw_beg, label="Minimum event interval",
                           alpha=0.2, color=_P_CLR)
                ax.axvspan(mw_end, t_max, alpha=0.2, color=_P_CLR)
                ax.axvspan(mw_beg, mw_end, label="Marginal window",
                           alpha=0.2, color=_S_CLR)
                ax.axvline(t_coa, label="Triggered event", lw=0.01,
                           alpha=0.4, color="#1F77B4")


def _event_scatter(fig, axes, events, discarded=False):
    """Scatter events on the XY/XZ/YZ cross-sections, coloured by trigger
    coalescence (grey for discarded), with a horizontal colourbar."""

    if events is None or len(events) == 0:
        return
    ax_xy, ax_xz, ax_yz = axes
    x = np.asarray(events["COA_X"], dtype=float)
    y = np.asarray(events["COA_Y"], dtype=float)
    z = np.asarray(events["COA_Z"], dtype=float)
    if discarded:
        ax_xy.scatter(x, y, s=50, c="grey")
        ax_xz.scatter(x, z, s=50, c="grey")
        ax_yz.scatter(z, y, s=50, c="grey")
        return
    c = np.asarray(events["TRIG_COA"], dtype=float)
    # Pad the colour range so a single event (min == max) still gets a
    # consistent in-range colour and a non-degenerate colorbar.
    vmin, vmax = c.min() * 0.999, c.max() * 1.001
    sc = ax_xy.scatter(x, y, s=50, c=c, vmin=vmin, vmax=vmax)
    ax_xz.scatter(x, z, s=50, c=c, vmin=vmin, vmax=vmax)
    ax_yz.scatter(z, y, s=50, c=c, vmin=vmin, vmax=vmax)

    cax = pyplot().subplot2grid((9, 18), (7, 5), colspan=2, rowspan=2,
                                fig=fig)
    cax.set_axis_off()
    cb = fig.colorbar(sc, ax=cax, orientation="horizontal", fraction=0.8,
                      aspect=8)
    cb.ax.set_xlabel("Peak coalescence value", rotation=0, fontsize=14)


def _text_summary(ax, events, threshold_string, marginal_window,
                  min_event_interval, normalise_coalescence):
    trace = ("normalised coalescence" if normalise_coalescence
             else "coalescence")
    count = 0 if events is None else len(events)
    with pyplot().rc_context({"font.size": 18}):
        for height, name, value in (
            (0.65, "Trigger threshold:", threshold_string),
            (0.5, "Marginal window:", f"{marginal_window} s"),
            (0.35, "Minimum event interval:", f"{min_event_interval} s"),
        ):
            ax.text(0.45, height, name, ha="right", va="center")
            ax.text(0.47, height, value, ha="left", va="center")
        ax.text(0.42, 0.15,
                f"Triggered {count} event(s) on the {trace} trace.",
                ha="center", va="center")
    ax.set_axis_off()


def _region_outline(axes, region):
    """Dashed outline of the trigger region on all three cross-sections."""

    min_x, min_y, min_z, max_x, max_y, max_z = region
    ax_xy, ax_xz, ax_yz = axes
    style = dict(linestyle="--", color=_REGION_CLR, linewidth=1.5)
    ax_xy.plot([min_x, min_x, max_x, max_x, min_x],
               [min_y, max_y, max_y, min_y, min_y], **style)
    ax_xz.plot([min_x, min_x, max_x, max_x, min_x],
               [min_z, max_z, max_z, min_z, min_z], **style)
    ax_yz.plot([min_z, max_z, max_z, min_z, min_z],
               [min_y, min_y, max_y, max_y, min_y], **style)


def _align_cross_sections(fig, ax_xy, ax_xz, ax_yz):
    """Pin the XZ/YZ sections flush against the (aspect-constrained) map:
    tight_layout leaves gaps when the map shrinks to preserve aspect."""

    xy_l, xy_b, xy_w, xy_h = ax_xy.get_position().bounds
    xz_l, xz_b, xz_w, xz_h = ax_xz.get_position().bounds
    yz_l, yz_b, _, _ = ax_yz.get_position().bounds
    h_gap = yz_b - (xz_b + xz_h)
    w_gap = yz_l - (xz_l + xz_w)
    ax_xz.set_position([xy_l, xy_b - h_gap - xz_h, xy_w, xz_h])
    fig_w, fig_h = fig.get_size_inches()
    ax_yz.set_position(
        [xy_l + xy_w + w_gap, xy_b, xz_h * (fig_h / fig_w), xy_h]
    )
