# -*- coding: utf-8 -*-
"""
Coalescence video: animate the evolution of the 4-D coalescence volume
through the marginal window for a located event (XY/XZ/YZ slices through
the instantaneous maximum, plus the coalescence trace cursor). The
reference only stubs this feature ("Support for event videos coming soon",
quakemigrate/signal/scan.py:558-559); this is a working implementation,
written as an animated GIF.

"""

import logging

import numpy as np

import quakemigrate_torch.util as util
from . import pyplot


@util.timeit("info")
def event_video(run, event, lut, fps=10, max_frames=200):
    """
    Render the event's 4-D coalescence map as an animated GIF.

    Parameters
    ----------
    run, event, lut : pipeline objects (event must retain ``map4d``).
    fps : int
        Output frame rate.
    max_frames : int
        Downsample the time axis to at most this many frames.

    """

    from matplotlib.animation import PillowWriter

    plt = pyplot()
    map4d = np.asarray(event.map4d)
    if map4d.ndim == 2:
        map4d = map4d.reshape(tuple(lut.node_count) + (-1,))
    n_frames_raw = map4d.shape[-1]
    stride = max(1, int(np.ceil(n_frames_raw / max_frames)))
    frames = range(0, n_frames_raw, stride)

    vmax = np.max(map4d)
    extent = lut.get_grid_extent(cells=True)
    times = event.coa_data["DT"].tolist()

    fig, axes = plt.subplots(2, 2, figsize=(12, 10))
    ax_xy, ax_yz = axes[0]
    ax_xz, ax_coa = axes[1]

    # Static panel setup
    for ax, (i, j), labels in (
        (ax_xy, (0, 1), ("Longitude", "Latitude")),
        (ax_xz, (0, 2), ("Longitude", f"Depth ({lut.unit_name})")),
        (ax_yz, (2, 1), (f"Depth ({lut.unit_name})", "Latitude")),
    ):
        ax.set_xlim(extent[0][i], extent[1][i])
        ax.set_ylim(extent[0][j], extent[1][j])
        ax.set_xlabel(labels[0])
        ax.set_ylabel(labels[1])
    ax_xz.invert_yaxis()

    coa_times = [t.matplotlib_date for t in times]
    ax_coa.plot(coa_times, event.coa_data["COA"], c="k", lw=0.8)
    ax_coa.set_ylabel("Max coalescence")
    cursor = ax_coa.axvline(coa_times[0], c="r", lw=1.0)

    stations = lut.station_data
    ax_xy.scatter(stations["Longitude"], stations["Latitude"], marker="^",
                  c="k", s=15, zorder=10)

    ims = []
    fpath = run.path / "locate" / run.subname / "videos"
    fpath.mkdir(exist_ok=True, parents=True)
    file = (fpath / f"{run.name}_{event.uid}_Coalescence").with_suffix(".gif")

    writer = PillowWriter(fps=fps)
    nx, ny, nz = map4d.shape[:3]
    with writer.saving(fig, str(file), dpi=80):
        for frame in frames:
            vol = map4d[..., frame]
            mi, mj, mk = np.unravel_index(np.argmax(vol), vol.shape)

            for im in ims:
                im.remove()
            ims = [
                ax_xy.imshow(
                    vol[:, :, mk].T, origin="lower", aspect="auto",
                    extent=(extent[0][0], extent[1][0], extent[0][1],
                            extent[1][1]),
                    vmin=0, vmax=vmax, cmap="viridis", zorder=1,
                ),
                ax_xz.imshow(
                    vol[:, mj, :].T, origin="lower", aspect="auto",
                    extent=(extent[0][0], extent[1][0], extent[0][2],
                            extent[1][2]),
                    vmin=0, vmax=vmax, cmap="viridis", zorder=1,
                ),
                ax_yz.imshow(
                    vol[mi, :, :], origin="lower", aspect="auto",
                    extent=(extent[0][2], extent[1][2], extent[0][1],
                            extent[1][1]),
                    vmin=0, vmax=vmax, cmap="viridis", zorder=1,
                ),
            ]
            cursor.set_xdata([coa_times[min(frame, len(coa_times) - 1)]] * 2)
            fig.suptitle(
                f"{event.uid} | {times[min(frame, len(times) - 1)]}",
                fontsize=12,
            )
            writer.grab_frame()

    plt.close(fig)
    logging.info(f"\tCoalescence video written to {file}")
    return file
