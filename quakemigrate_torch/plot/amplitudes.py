# -*- coding: utf-8 -*-
"""
Amplitude-vs-distance summary plotting for the local magnitude stage
(reference: plot/amplitudes.py:19-284). The magnitudes are the port's
:class:`~quakemigrate_torch.io.table.Table`, its ``id`` column the trace
IDs (the JAX frame's index).

"""

import numpy as np

from . import pyplot


def _floats(values):
    """A column as float64 values, None as NaN."""

    return np.array([np.nan if v is None else v for v in values],
                    dtype=np.float64)


def amplitudes_summary(magnitudes, amp_feature, amp_multiplier, dist_err,
                       r_squared, noise_measure="RMS"):
    """
    Base amplitude-vs-distance axes: observed signal amplitudes (with noise
    error bars) and noise amplitudes, on log-log axes. Returns (fig, ax).

    """

    fig, ax = pyplot().subplots(figsize=(14, 9))

    used_rows = np.asarray(magnitudes["Used"], dtype=bool)
    used = magnitudes.take(used_rows)
    unused = magnitudes.take(~used_rows)

    for df, colour, label in (
        (used, "k", "Signal amplitudes (used)"),
        (unused, "grey", "Signal amplitudes (excluded)"),
    ):
        if not len(df):
            continue
        amps = (
            _floats(df[amp_feature])
            * amp_multiplier
            * np.power(10, _floats(df["Station_Correction"]))
        )
        noise_amps = (
            _floats(df["Noise_amp"])
            * amp_multiplier
            * np.power(10, _floats(df["Station_Correction"]))
        )
        ax.errorbar(
            _floats(df["Dist"]), amps, yerr=noise_amps, xerr=dist_err,
            fmt="o", c=colour, ms=4, lw=0.7, label=label,
        )
        ax.scatter(
            _floats(df["Dist"]), noise_amps, marker="v", s=12, c="b",
            label=f"Noise amplitudes ({noise_measure})"
            if colour == "k" else None,
        )

    ax.set_xscale("log")
    ax.set_yscale("log")

    # One label per station above its highest amplitude; rejected-only
    # stations labelled in grey (ref plot/amplitudes.py:114-160).
    def _corrected(df):
        return (_floats(df[amp_feature]) * amp_multiplier
                * np.power(10, _floats(df["Station_Correction"])))

    stns = []
    if len(used):
        _, stns = label_stations(
            ax, list(used["id"]), _corrected(used), _floats(used["Dist"])
        )
    if len(unused):
        fresh = [i for i, tr_id in enumerate(unused["id"])
                 if tr_id[:-1] not in stns]
        if fresh:
            sel = unused.take(np.array(fresh))
            label_stations(
                ax, list(sel["id"]), _corrected(sel), _floats(sel["Dist"]),
                rejected=True,
            )

    # Goodness-of-fit annotation (ref plot/amplitudes.py:163-172)
    ax.text(
        0.98, 0.02, f"r-squared: {r_squared:.2f}", transform=ax.transAxes,
        bbox=dict(boxstyle="round", fc="w", alpha=0.8),
        va="bottom", ha="right", fontsize=16,
    )

    return fig, ax


def label_stations(ax, tr_ids, amps, dists, rejected=False):
    """
    Annotate one label per station, above that station's highest observed
    amplitude (reference plot/amplitudes.py:177-284). Consecutive trace IDs
    sharing a station prefix form one group; the label lists the group's
    component codes, e.g. ``STN[Z,N]``.

    Parameters
    ----------
    ax : matplotlib Axes to annotate.
    tr_ids : sequence of str, trace IDs ordered so same-station IDs are
        adjacent (the ``.amps`` file ordering).
    amps : array-like, amplitude (y) values per trace ID.
    dists : array-like, distance (x) values per trace ID.
    rejected : bool, plot the labels in grey (excluded measurements).

    Returns
    -------
    (ax, stns) : the axes and the list of labelled station names.

    """

    amps = np.asarray(amps)
    dist_arr = np.asarray(dists)

    # Consecutive runs of the same station prefix.
    groups = []
    for i, tr_id in enumerate(tr_ids):
        stn, comp = tr_id[:-1], tr_id[-1]
        if groups and groups[-1][0] == stn:
            groups[-1][1].append(comp)
            groups[-1][2] = i
        else:
            groups.append([stn, [comp], i])

    stns = []
    for stn, comps, last in groups:
        first = last - len(comps) + 1
        label = f"{stn}[{','.join(comps)}]"
        ax.annotate(
            label, (dist_arr[last], np.max(amps[first:last + 1])),
            ha="center", va="bottom", fontsize=8,
            color="gray" if rejected else "black",
        )
        stns.append(stn)
    return ax, stns


def plot_amplitudes_vs_distance(magnitude, magnitudes, event, run,
                                unit_conversion_factor, noise_measure="RMS"):
    """
    Full amplitude-vs-distance figure including the predicted amplitude
    curve for the network-mean magnitude; saved under amplitude_plots/.

    """

    mag = event.localmag["ML"]
    mag_err = event.localmag["ML_Err"]
    mag_r2 = event.localmag["ML_r2"]

    km_cf = 1000 / unit_conversion_factor

    x_err, y_err, z_err = event.get_loc_uncertainty("gaussian") / km_cf
    epi_err = np.sqrt(x_err**2 + y_err**2)
    dist_err = (
        np.sqrt(epi_err**2 + z_err**2)
        if magnitude.use_hyp_dist
        else epi_err
    )

    all_amps = (
        _floats(magnitudes[magnitude.amp_feature])
        * magnitude.amp_multiplier
        * np.power(10, _floats(magnitudes["Station_Correction"]))
    )
    noise_amps = (
        _floats(magnitudes["Noise_amp"])
        * magnitude.amp_multiplier
        * np.power(10, _floats(magnitudes["Station_Correction"]))
    )

    dist = _floats(magnitudes["Dist"])

    amps_max = np.nanmax(all_amps) * 5
    amps_min = np.nanmin(noise_amps) / 10
    dist_min = np.nanmin(dist) / 2
    dist_max = np.nanmax(dist) * 1.5

    _, ax = amplitudes_summary(
        magnitudes, magnitude.amp_feature, magnitude.amp_multiplier,
        dist_err, mag_r2, noise_measure,
    )

    mag_upper = mag + mag_err
    mag_lower = mag - mag_err

    distances = np.linspace(dist_min, dist_max, 10000)
    att = magnitude._attenuation(distances)

    predicted_amp = np.power(10, (mag - att))
    predicted_amp_upper = np.power(10, (mag_upper - att))
    predicted_amp_lower = np.power(10, (mag_lower - att))

    label = (
        f"Predicted amplitude for ML = {mag:.2f} ± {mag_err:.2f}"
        f'\nusing attenuation curve "{magnitude.A0}"'
    )
    ax.plot(distances, predicted_amp, linestyle="-", c="r", label=label)
    ax.plot(distances, predicted_amp_upper, linestyle="--", c="r")
    ax.plot(distances, predicted_amp_lower, linestyle="--", c="r")

    if magnitude.dist_filter:
        ax.axvline(
            magnitude.dist_filter, linestyle="--", color="k",
            label="Distance filter",
        )

    ax.set_xlim(dist_min, dist_max)
    ax.set_ylim(amps_min, max(np.nanmax(predicted_amp), amps_max))

    ax.set_title(
        f'Amplitude vs distance plot for event: "{event.uid}"', fontsize=18
    )
    ax.set_ylabel("Amplitude / mm", fontsize=16)
    if magnitude.use_hyp_dist:
        ax.set_xlabel("Hypocentral Distance / km", fontsize=16)
    else:
        ax.set_xlabel("Epicentral Distance / km", fontsize=16)

    ax.legend(fontsize=16, loc="upper right")
    plt = pyplot()
    plt.tight_layout()

    fpath = run.path / "locate" / run.subname / "amplitude_plots"
    fpath.mkdir(exist_ok=True, parents=True)
    fstem = f"{run.name}_{event.uid}_AmpVsDistance"
    file = (fpath / fstem).with_suffix(".pdf")
    plt.savefig(file, dpi=400)
    plt.close("all")
