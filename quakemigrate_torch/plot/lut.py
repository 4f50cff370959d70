# -*- coding: utf-8 -*-
"""
Cross-section plotting of a LUT grid (XY / XZ / YZ panels) with station
locations and optional coalescence-map slices and hypocentre crosshairs.

"""

import numpy as np

from . import pyplot


def lut_plot(lut, fig, gs, slices=None, hypocentre=None, station_clr="k",
             station_list=None):
    """Plot the three grid cross-sections onto an existing figure. The
    stations are the rows of the LUT's station table (of
    ``station_list`` where given)."""

    plt = pyplot()
    xy = plt.subplot2grid(gs, (2, 0), colspan=5, rowspan=5, fig=fig)
    xz = plt.subplot2grid(gs, (7, 0), colspan=5, rowspan=2, fig=fig)
    yz = plt.subplot2grid(gs, (2, 5), colspan=2, rowspan=5, fig=fig)

    xz.sharex(xy)
    yz.sharey(xy)

    cells_extent = lut.get_grid_extent(cells=True)
    extent = abs(cells_extent[1] - cells_extent[0])
    grid_size = lut.node_spacing * lut.node_count
    aspect = (extent[0] * grid_size[1]) / (extent[1] * grid_size[0])
    xy.set_aspect(aspect=aspect)

    bounds = np.stack(cells_extent, axis=-1)
    for i, j, ax in [(0, 1, xy), (0, 2, xz), (2, 1, yz)]:
        gminx, gmaxx = bounds[i]
        gminy, gmaxy = bounds[j]

        ax.set_xlim([gminx, gmaxx])
        ax.set_ylim([gminy, gmaxy])

        if hypocentre is not None:
            ax.axvline(x=hypocentre[i], ls="--", lw=1.5, c="white")
            ax.axhline(y=hypocentre[j], ls="--", lw=1.5, c="white")

        if slices is None:
            continue

        slice_ = slices[i + j - 1]
        nx, ny = [dim + 1 for dim in slice_.shape]
        grid1, grid2 = np.mgrid[
            gminx: gmaxx: nx * 1j, gminy: gmaxy: ny * 1j
        ]
        sc = ax.pcolormesh(grid1, grid2, slice_, edgecolors="face")

        if i + j - 1 == 0:
            cax = plt.subplot2grid(gs, (7, 5), colspan=2, rowspan=2, fig=fig)
            cax.set_axis_off()
            cb = fig.colorbar(
                sc, ax=cax, orientation="horizontal", fraction=0.8, aspect=8
            )
            cb.ax.set_xlabel(
                "Normalised coalescence\nvalue", rotation=0, fontsize=14
            )

    stations = lut.station_data
    keep = (np.ones(len(stations), dtype=bool) if station_list is None
            else np.isin(stations["Name"], list(station_list)))
    names = stations["Name"][keep]
    lon = stations["Longitude"][keep]
    lat = stations["Latitude"][keep]
    elev = stations["Elevation"][keep]
    xy.scatter(lon, lat, s=15, marker="^", zorder=20, c=station_clr)
    xz.scatter(lon, elev, s=15, marker="^", zorder=20, c=station_clr)
    yz.scatter(elev, lat, s=15, marker="<", zorder=20, c=station_clr)
    for name, x, y in zip(names, lon, lat):
        xy.annotate(str(name), [x, y], zorder=20, c=station_clr,
                    clip_on=True)

    # --- Scale bar (along-longitude length of ~1/10 of the grid) ---
    from mpl_toolkits.axes_grid1.anchored_artists import AnchoredSizeBar

    length = np.ceil(lut.node_count[0] / 10) * lut.node_spacing[0]
    xy.add_artist(AnchoredSizeBar(
        xy.transData,
        size=extent[0] * length / grid_size[0],
        label=f"{length:.3g} {lut.unit_name}",
        loc="lower right", pad=0.5, sep=5, frameon=False, color=station_clr,
    ))

    # --- Tick/label layout: map labelled on top+left, sections outward ---
    ticks = dict(which="both", left=True, right=True, top=True, bottom=True)
    xy.tick_params(labelleft=True, labeltop=True, labelright=False,
                   labelbottom=False, **ticks)
    xy.set_ylabel("Latitude (deg)", fontsize=14)
    xy.yaxis.set_label_position("left")

    xz.invert_yaxis()
    xz.tick_params(labelleft=True, labeltop=False, labelright=False,
                   labelbottom=True, **ticks)
    xz.set_xlabel("Longitude (deg)", fontsize=14)
    xz.set_ylabel(f"Depth ({lut.unit_name})", fontsize=14)
    xz.yaxis.set_label_position("left")

    yz.tick_params(labelleft=False, labeltop=True, labelright=True,
                   labelbottom=True, **ticks)
    yz.set_xlabel(f"Depth ({lut.unit_name})", fontsize=14)
    yz.xaxis.set_label_position("bottom")
