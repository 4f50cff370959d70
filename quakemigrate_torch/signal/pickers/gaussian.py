# -*- coding: utf-8 -*-
"""
Gaussian phase picker: refine arrival times by fitting a 1-D Gaussian to the
onset function near the modelled arrival, the port of the JAX package's
``signal/pickers/gaussian.py`` without pandas and without its figure.

Onsets are recomputed over a 4x marginal-window event span, on the host
(``calculate_onsets`` on the CPU: the picker runs on locate's post
pool, which issues no work on the card); each phase's pick window is the
modelled arrival ± (traveltime·fraction_tt + marginal_window) with
overlapping windows split at the arrival midpoint; the pick threshold
comes from onset noise outside all windows (MAD x8 or a percentile); the
Gaussian is fitted to the above-threshold excursion that contains the
window maximum; every failure mode degrades to -1 sentinels.

"""

import logging

import numpy as np
from scipy.optimize import curve_fit

import quakemigrate_torch.plot as plot
import quakemigrate_torch.util as util
from quakemigrate_torch.io.table import Table
from .base import PhasePicker

_FAILED_FIT = {"popt": 0, "xdata": 0, "xdata_dt": 0, "PickValue": -1}

_PICK_COLUMNS = [
    "Station", "Phase", "ModelledTime", "PickTime", "PickError", "SNR",
    "Residual",
]


class GaussianPicker(PhasePicker):
    """Phase picker based on Gaussian fits to the onset function. With
    ``plot_picks``, a pick summary figure a station (``plot.phase_picks``)
    where matplotlib imports."""

    DEFAULT_GAUSSIAN_FIT = _FAILED_FIT

    def __init__(self, onset=None, **kwargs):
        super().__init__(**kwargs)

        self.onset = onset

        threshold_params = {
            "percentile": ("percentile_pick_threshold", 1.0),
            "MAD": ("mad_pick_threshold", 8.0),
        }
        self.threshold_method = kwargs.get("threshold_method", "MAD")
        if self.threshold_method not in threshold_params:
            raise util.InvalidPickThresholdMethodException
        attr, default = threshold_params[self.threshold_method]
        setattr(self, attr, kwargs.get(attr, default))

        if kwargs.get("pick_threshold"):
            self.pick_threshold = kwargs["pick_threshold"]

        self.plot_picks = kwargs.get("plot_picks", False)
        self.write_seed_ids = kwargs.get("write_seed_ids", False)
        self._fraction_tt = kwargs.get("fraction_tt")

    def __str__(self):
        lines = ["\tPhase picking by fitting a 1-D Gaussian to onsets"]
        if self.threshold_method == "percentile":
            lines.append(
                f"\t\tPercentile threshold  = {self.percentile_pick_threshold}"
            )
        elif self.threshold_method == "MAD":
            lines.append(f"\t\tMAD multiplier  = {self.mad_pick_threshold}")
        if self._fraction_tt is not None:
            lines.append(
                f"\t\tSearch window   = {self._fraction_tt * 100}% of "
                "traveltime"
            )
        return "\n".join(lines) + "\n"

    # -- main entry -----------------------------------------------------------

    @util.timeit("info")
    def pick_phases(self, event, lut, run):
        """Pick P/S arrivals for one located event; returns (event, picks)."""

        event_span = 4 * event.marginal_window
        _, onset_data = self.onset.calculate_onsets(
            event.data, timespan=event_span, device="cpu")
        fraction_tt = (
            lut.fraction_tt if self._fraction_tt is None else self._fraction_tt
        )
        hypo_ijk = lut.index2coord(event.hypocentre, inverse=True)[0]

        def modelled_tt(phase, station):
            return float(
                np.ravel(lut.traveltime_to(phase, hypo_ijk, station))[0]
            )

        records = []
        gaussfits, pick_windows, ttimes_all = {}, {}, {}
        for station, station_onsets in onset_data.onsets.items():
            phases = list(station_onsets)
            traveltimes = {
                phase: modelled_tt(phase, station) for phase in phases
            }
            ttimes_all[station] = [traveltimes[phase] for phase in phases]
            windows = {
                phase: self._pick_window(
                    event, onset_data, traveltimes[phase], fraction_tt
                )
                for phase in phases
            }
            n_samples = len(station_onsets[phases[-1]])
            self._resolve_window_overlaps(windows, phases, n_samples)
            pick_windows[station] = windows

            for phase, onset in station_onsets.items():
                threshold = self._noise_threshold(onset, windows)
                logging.debug(f"\t\tPicking {phase} at {station}...")
                fit, pick_time, pick_error, snr = self._fit_gaussian(
                    onset, onset_data, self.onset.gaussian_halfwidth(phase),
                    threshold, windows[phase],
                )
                gaussfits.setdefault(station, {})[phase] = fit

                modelled = event.otime + traveltimes[phase]
                residual = -1 if pick_time == -1 else pick_time - modelled

                record = {
                    "Station": station,
                    "Phase": phase,
                    "ModelledTime": modelled,
                    "PickTime": pick_time,
                    "PickError": pick_error,
                    "SNR": snr,
                    "Residual": residual,
                }
                if self.write_seed_ids:
                    matching = onset_data.filtered_waveforms.select(
                        station=station, channel=self.onset.channel_maps[phase]
                    )
                    record["SEED_ids"] = sorted({tr.id for tr in matching})
                records.append(record)

        columns = list(_PICK_COLUMNS)
        if self.write_seed_ids:
            columns.insert(1, "SEED_ids")
        picks = Table.from_rows(records, columns)

        event.add_picks(picks, gaussfits=gaussfits, pick_windows=pick_windows)
        self.write(run, event.uid, picks)

        if self.plot_picks and plot.available():
            logging.info("\t\tPlotting picks...")
            for station in onset_data.onsets:
                self.plot(event, station, onset_data, picks,
                          ttimes_all.get(station), run)

        return event, picks

    # -- window construction -----------------------------------------------------

    def _pick_window(self, event, onset_data, tt, fraction_tt):
        """[low, modelled-arrival, high] sample indices of the pick window."""

        def to_samples(seconds):
            return util.time2sample(seconds, onset_data.sampling_rate)

        centre = to_samples(event.otime + tt - onset_data.starttime)
        halfwidth = to_samples(tt * fraction_tt + event.marginal_window)
        return [centre - halfwidth, centre, centre + halfwidth]

    @staticmethod
    def _resolve_window_overlaps(windows, phases, n_samples):
        """Clamp windows to the data and split overlaps at arrival midpoints."""

        windows[phases[0]][0] = max(0, windows[phases[0]][0])
        for earlier, later in util.pairwise(phases):
            mid = int((windows[earlier][1] + windows[later][1]) / 2)
            windows[earlier][2] = min(mid, windows[earlier][2])
            windows[later][0] = max(mid, windows[later][0])
        windows[phases[-1]][2] = min(n_samples, windows[phases[-1]][2])

    # -- thresholding ---------------------------------------------------------------

    def _noise_threshold(self, onset, windows):
        """Pick threshold from the onset samples outside every pick window."""

        keep = np.ones(len(onset), dtype=bool)
        for low, _, high in windows.values():
            keep[max(0, low): high] = False
        noise = onset[keep]
        noise = noise[noise > 1]

        if noise.size == 0:
            return np.inf
        if self.threshold_method == "percentile":
            return np.percentile(noise, self.percentile_pick_threshold * 100)
        return np.median(noise) + (
            util.calculate_mad(noise) * self.mad_pick_threshold
        )

    # -- fitting -----------------------------------------------------------------------

    def _fit_gaussian(self, onset, onset_data, halfwidth, threshold, window):
        """(fit dict, pick time, error, SNR) — or -1 sentinels throughout."""

        sampling_rate = onset_data.sampling_rate
        starttime = onset_data.starttime
        low, _, high = window
        try:
            first, last = self._bracket_peak(onset[low:high], threshold)
        except util.NoOnsetPeak as err:
            logging.debug(err.msg)
            return self._sentinels(threshold)

        # Clamp: an excursion starting at sample 0 of a window already
        # clamped to index 0 would give lo_idx -1 and an empty slice;
        # degrade to the -1 sentinels like every other failure mode.
        lo_idx = max(low + first - 1, 0)
        hi_idx = min(low + last + 1, len(onset))
        x_data = np.arange(lo_idx, hi_idx) / sampling_rate
        y_data = onset[lo_idx:hi_idx]
        if y_data.size == 0:
            return self._sentinels(threshold)

        initial = [
            max(y_data),
            (lo_idx + np.argmax(y_data)) / sampling_rate,
            halfwidth / sampling_rate,
        ]
        try:
            popt, _ = curve_fit(util.gaussian_1d, x_data, y_data, initial)
        except (ValueError, RuntimeError) as err:
            logging.debug(
                f"\t\t    Failed curve_fit:\n{err}\n\t\t    Continuing..."
            )
            return self._sentinels(threshold)
        except TypeError as err:
            logging.debug(f"\t\t    Failed curve_fit - too few input data? "
                          f"{err}")
            return self._sentinels(threshold)

        height, centre_s, width = popt
        if not low < centre_s * sampling_rate < high:
            logging.debug("\t\t    Pick mean out of bounds - continuing.")
            return self._sentinels(threshold)

        fit = dict(
            popt=popt,
            xdata=x_data,
            xdata_dt=np.array([starttime + x for x in x_data]),
            PickValue=height,
            PickThreshold=threshold,
        )
        return fit, starttime + float(centre_s), np.absolute(width), height

    def _sentinels(self, threshold):
        """The universal pick-failure return: -1 everywhere."""

        fit = dict(self.DEFAULT_GAUSSIAN_FIT, PickThreshold=threshold)
        return fit, -1, -1, -1

    @staticmethod
    def _bracket_peak(values, threshold):
        """
        (first, one-past-last) indices of the above-threshold excursion that
        contains the maximum of ``values``; NoOnsetPeak if the onset never
        exceeds the threshold or the excursion is a single sample.

        """

        hot = np.flatnonzero(values > threshold)
        if hot.size == 0:
            raise util.NoOnsetPeak(threshold)

        excursions = np.split(hot, np.flatnonzero(np.diff(hot) != 1) + 1)
        apex = np.argmax(values)
        containing = next(
            (run for run in excursions if run[0] <= apex <= run[-1]),
            excursions[-1],
        )
        if containing.size < 2:
            raise util.NoOnsetPeak(threshold)
        return containing[0], containing[-1] + 1

    # -- plotting --------------------------------------------------------------------

    @util.timeit()
    def plot(self, event, station, onset_data, picks_df, traveltimes, run):
        """Write the per-station pick summary figure. ``traveltimes`` is
        the list of modelled traveltimes, one per phase (reference
        pickers/gaussian.py:562-612)."""

        from quakemigrate_torch.plot.phase_picks import pick_summary

        outdir = run.path / f"locate/{run.subname}/pick_plots/{event.uid}"
        outdir.mkdir(exist_ok=True, parents=True)

        waveforms = onset_data.filtered_waveforms.select(station=station)
        if not bool(waveforms):
            return
        fig = pick_summary(
            event,
            station,
            waveforms,
            picks_df.take(picks_df["Station"] == station),
            onset_data.onsets[station],
            onset_data.channel_maps,
            traveltimes,
            event.picks["pick_windows"][station],
        )
        plt = plot.pyplot()
        plt.savefig((outdir / f"{event.uid}_{station}").with_suffix(".pdf"))
        plt.close(fig)

    # -- options ------------------------------------------------------------------------

    fraction_tt = property(
        lambda self: self._fraction_tt,
        lambda self, value: setattr(self, "_fraction_tt", value),
    )

    @property
    def pick_threshold(self):
        """Deprecated: select a threshold_method of 'percentile' or 'MAD'
        instead."""

    @pick_threshold.setter
    def pick_threshold(self, value):
        raise AttributeError(
            "The 'pick_threshold' attribute has been deprecated. Select a "
            "threshold method from 'percentile' or 'MAD', and see the docs "
            "for the syntax for the appropriate threshold."
        )
