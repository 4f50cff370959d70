# -*- coding: utf-8 -*-
"""
Event summary figure: cross-sections through the marginalised coalescence
map with location estimates and uncertainty ellipses, the waveform gather
with modelled arrival times, the coalescence trace through the marginal
window, and a text panel of the event solution (the same panels as the
reference's plot/event.py:24-467).

"""

import logging

import numpy as np

import quakemigrate_torch.util as util
from . import pyplot
from .lut import lut_plot


def _map_slices(coa_map, ijk):
    """
    XY/XZ/YZ cross-sections through the hypocentre in lut_plot's
    orientation: pcolormesh maps the slice's axis 0 to the panel's x
    coordinate (grid1 in plot.lut varies along axis 0), so the xy/xz
    panels take the slices un-transposed and yz transposed (z on its
    x-axis) -- same convention as ref plot/event.py:71-75.

    """

    return [
        coa_map[:, :, ijk[2]],
        coa_map[:, ijk[1], :],
        coa_map[ijk[0], :, :].T,
    ]


@util.timeit()
def event_summary(run, event, marginalised_coa_map, lut, xy_files=None,
                  plot_all_stns=True):
    """Create and save the event summary figure: the PDF
    ``summaries/{run}_{uid}_EventSummary.pdf`` of the run's locate
    directory, from the marginalised map (nx, ny, nz) locate computed."""

    from matplotlib.patches import Ellipse

    plt = pyplot()
    coa_map = marginalised_coa_map

    logging.info("\tPlotting event summary figure...")

    fig = plt.figure(figsize=(25, 15))
    gs = (9, 15)

    # --- Waveform gather (right-hand panels) ---
    ax_gather = plt.subplot2grid(gs, (0, 8), colspan=7, rowspan=5, fig=fig)
    ax_coa = plt.subplot2grid(gs, (6, 8), colspan=7, rowspan=2, fig=fig)

    _plot_waveform_gather(ax_gather, event, lut)
    _plot_coalescence_trace(ax_coa, event)

    # --- Map slices through the marginalised coalescence map ---
    hypocentre = event.hypocentre
    ijk = lut.index2coord(hypocentre, inverse=True)[0]
    slices = _map_slices(coa_map, ijk)
    station_list = None
    if not plot_all_stns and event.onset_data is not None:
        # rsplit: station names may themselves contain underscores
        station_list = sorted(
            {k.rsplit("_", 1)[0] for k, v in
             event.onset_data.availability.items() if v == 1}
        )
    lut_plot(
        lut, fig, gs, slices=slices, hypocentre=hypocentre,
        station_list=station_list,
    )
    ax_xy = fig.axes[2] if len(fig.axes) > 2 else None

    if ax_xy is not None:
        # --- Coordinate overlays (coastlines, outlines, ...) ---
        if xy_files is not None:
            from .xy import plot_xy_files

            plot_xy_files(xy_files, ax_xy)

        # --- Uncertainty ellipse ---
        try:
            gau = event.locations["gaussian"]
            unc = event.get_loc_uncertainty("gaussian")
            km_cf = 1000 / lut.unit_conversion_factor
            # Convert km uncertainties to degrees (approximate local scaling)
            lat_unc = unc[1] / km_cf / 111.195
            lon_unc = (
                unc[0] / km_cf / (111.195 * np.cos(np.deg2rad(gau["Y"])))
            )
            ax_xy.add_patch(
                Ellipse(
                    (gau["X"], gau["Y"]), width=lon_unc * 2,
                    height=lat_unc * 2, fill=False, ls="--", lw=1.5,
                    edgecolor="k",
                )
            )
        except (KeyError, IndexError):
            pass

    # --- Text panel ---
    ax_text = plt.subplot2grid(gs, (0, 0), colspan=7, rowspan=2, fig=fig)
    ax_text.set_axis_off()
    hypo = event.hypocentre
    unc = event.get_loc_uncertainty("gaussian")
    text = (
        f"Event: {event.uid}\n"
        f"Origin time: {event.otime}\n"
        f"Hypocentre (spline): {hypo[0]:.5f}$^\\circ$E, "
        f"{hypo[1]:.5f}$^\\circ$N, {hypo[2]:.3f} {lut.unit_name}\n"
        f"Gaussian uncertainty: $\\pm$ {unc[0]:.3g} / {unc[1]:.3g} / "
        f"{unc[2]:.3g} {lut.unit_name}\n"
        f"Max coalescence: {event.max_coalescence['COA']:.4g}"
    )
    if event.localmag.get("ML") is not None and not np.isnan(
        event.localmag.get("ML", np.nan)
    ):
        text += (
            f"\nLocal magnitude: {event.localmag['ML']:.3g} "
            f"$\\pm$ {event.localmag['ML_Err']:.3g} "
            f"(r$^2$ = {event.localmag['ML_r2']:.3g})"
        )
    ax_text.text(
        0.02, 0.95, text, fontsize=14, va="top", family="monospace"
    )

    fpath = run.path / "locate" / run.subname / "summaries"
    fpath.mkdir(exist_ok=True, parents=True)
    file = (fpath / f"{run.name}_{event.uid}_EventSummary").with_suffix(".pdf")
    plt.savefig(file, dpi=400)
    plt.close(fig)


def _plot_waveform_gather(ax, event, lut):
    """Distance-sorted waveform gather with modelled P/S arrival times."""

    if event.onset_data is None:
        return
    waveforms = event.onset_data.filtered_waveforms
    if not bool(waveforms):
        return

    hypocentre = event.hypocentre
    e_ijk = lut.index2coord(hypocentre, inverse=True)[0]

    stations = sorted({tr.stats.station for tr in waveforms})
    # Order stations by P traveltime
    try:
        order = {
            stn: float(np.ravel(lut.traveltime_to("P", e_ijk, station=stn))[0])
            for stn in stations
        }
        stations.sort(key=lambda s: order[s])
    except Exception:
        order = {stn: 0.0 for stn in stations}

    for i, station in enumerate(stations):
        st = waveforms.select(station=station)
        for tr in st[:1]:
            data = np.asarray(tr.data, dtype=float)
            peak = np.max(np.abs(data)) or 1.0
            times = tr.times(type="matplotlib")
            ax.plot(times, data / peak * 0.4 + i, c="k", lw=0.5)
        ax.text(
            ax.get_xlim()[0], i + 0.3, station, fontsize=8, va="bottom"
        )
        for phase, colour in zip(event.onset_data.phases, ("r", "b")):
            try:
                tt = float(np.ravel(lut.traveltime_to(phase, e_ijk, station=station))[0])
                arrival = (event.otime + tt).matplotlib_date
                ax.plot(
                    [arrival, arrival], [i - 0.4, i + 0.4], c=colour, lw=1.2
                )
            except Exception:
                continue

    ax.set_yticks([])
    ax.set_xlabel("DateTime")
    ax.set_title("Waveform gather (modelled arrivals: P red, S blue)")


def _plot_coalescence_trace(ax, event):
    """Coalescence value through the marginal window."""

    times = [t.matplotlib_date for t in event.coa_data["DT"]]
    ax.plot(times, event.coa_data["COA"], c="k", lw=0.8, label="COA")
    ax.axvline(event.otime.matplotlib_date, c="r", ls="--", lw=1,
               label="Origin time")
    ax.set_ylabel("Coalescence")
    ax.legend(fontsize=8)
    # Sub-second tick labels: the marginal window is only seconds long
    # (ref plot/event.py:283)
    ax.xaxis.set_major_formatter(util.DateFormatter("%H:%M:%S.{ms}", 2))
