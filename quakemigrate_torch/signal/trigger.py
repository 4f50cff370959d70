# -*- coding: utf-8 -*-
"""
Trigger stage: threshold the continuous coalescence stream written by
detect() into a catalogue of candidate events for locate(), the port of
the JAX package's ``signal/trigger.py`` without pandas.

Day-batched processing; static / MAD / median-ratio thresholds over
fixed-length chunks; optional Gaussian smoothing; above-threshold runs
collapsed to candidates with the peak always read from the raw COA
trace; overlap-merging of marginal windows; pad/region filtering;
17-character event IDs minted from the peak time. Tables are numpy
columns (:class:`~quakemigrate_torch.io.table.Table`). Trigger runs on
the host: it has no device work.

"""

import logging
from datetime import time

import numpy as np
from scipy.ndimage import gaussian_filter1d

import quakemigrate_torch.plot as plot
import quakemigrate_torch.util as util
from quakemigrate_torch.io import Run, read_scanmseed, write_triggered_events
from quakemigrate_torch.io.table import Table
from quakemigrate_torch.seis import UTCDateTime

_SECONDS_PER_DAY = 86400

# Output schemas: candidates carry a group number, refined events an ID.
_EVENT_FIELDS = [
    "CoaTime", "TRIG_COA", "COA_X", "COA_Y", "COA_Z",
    "MinTime", "MaxTime", "COA", "COA_NORM",
]
CANDIDATES_COLS = ["EventNum"] + _EVENT_FIELDS
REFINED_EVENTS_COLS = ["EventID"] + _EVENT_FIELDS


def chunks2trace(a, new_shape):
    """Tile per-chunk statistics out to a sample-by-sample trace."""

    n_chunks, chunk_len = new_shape
    return np.repeat(np.asarray(a), chunk_len)[: n_chunks * chunk_len]


def _mint_uid(coa_time):
    """17-digit event ID from a coalescence peak time (digits only)."""

    digits = "".join(ch for ch in str(coa_time) if ch.isdigit())
    return digits[:17].ljust(17, "0")


class Trigger:
    """
    Threshold-based candidate-event detection on the .scanmseed stream.

    Key options (reference-compatible names): threshold_method with its
    static/mad/median_ratio parameters, marginal_window,
    min_event_interval (validated >= 2x marginal window),
    normalise_coalescence, pad, COA smoothing, plotting toggles. With
    ``plot_trigger_summary`` each day's trigger summary figure is drawn
    (``plot.trigger``) where matplotlib imports; where it does not, the
    trigger logs one warning and writes its events all the same.

    """

    _OPTION_DEFAULTS = {
        "threshold_method": "static",
        "static_threshold": 1.5,
        "mad_window_length": 3600.0,
        "mad_multiplier": 8.0,
        "median_window_length": 3600.0,
        "median_multiplier": 1.2,
        "marginal_window": 2.0,
        "min_event_interval": 4.0,
        "normalise_coalescence": False,
        "pad": 120.0,
        "smooth_coa": False,
        "smoothing_kernel_sigma": 0.2,
        "smoothing_kernel_width": 4.0,
        "plot_trigger_summary": True,
        "xy_files": None,
        "plot_all_stns": True,
        "write_event_time_windows": False,
    }

    def __init__(self, lut, run_path, run_name, **kwargs):
        self.lut = lut

        self.run = Run(run_path, run_name, kwargs.get("trigger_name", ""),
                       "trigger", loglevel=kwargs.get("loglevel", "info"))
        self.run.logger(kwargs.get("log", False))

        for option, default in self._OPTION_DEFAULTS.items():
            setattr(self, option, kwargs.get(option, default))
        if kwargs.get("minimum_repeat"):
            self.minimum_repeat = kwargs["minimum_repeat"]

    def __str__(self):
        lines = [
            "\tTrigger parameters:",
            f"\t\tPre/post pad = {self.pad} s",
            f"\t\tMarginal window = {self.marginal_window} s",
            f"\t\tMinimum event interval  = {self.min_event_interval} s\n",
            "\t\tTriggering from the "
            + ("normalised " if self.normalise_coalescence else "")
            + "maximum coalescence trace.\n",
            f"\t\tTrigger threshold method: {self.threshold_method}",
        ]
        if self.threshold_method == "static":
            lines.append(f"\t\tStatic threshold = {self.static_threshold}\n")
        elif self.threshold_method == "mad":
            lines += [
                f"\t\tMAD Window     = {self.mad_window_length}",
                f"\t\tMAD Multiplier = {self.mad_multiplier}\n",
            ]
        else:
            lines += [
                f"\t\tMedian Window     = {self.median_window_length}",
                f"\t\tMedian Multiplier = {self.median_multiplier}\n",
            ]
        if self.smooth_coa:
            lines += [
                "\t\tApplying gaussian smoothing to the coalescence trace.",
                f"\t\tGaussian kernel sigma = {self.smoothing_kernel_sigma} s",
                "\t\tGaussian kernel truncated at "
                f"{self.smoothing_kernel_width} standard deviations.",
            ]
        return "\n".join(lines) + "\n"

    # -- entry point ----------------------------------------------------------

    def trigger(self, starttime, endtime, region=None, interactive_plot=False):
        """Run triggering over [starttime, endtime], one day at a time.
        ``region`` is [lo_x, lo_y, lo_z, hi_x, hi_y, hi_z] in input
        coordinates; with ``interactive_plot`` each summary figure is also
        shown (``plt.show()``) after it is saved."""

        starttime, endtime = UTCDateTime(starttime), UTCDateTime(endtime)
        if starttime > endtime:
            raise util.TimeSpanException

        for line in (
            util.log_spacer,
            "\tTRIGGER - Triggering events from .scanmseed",
            util.log_spacer,
            f"\n\tTriggering events from {starttime} to {endtime}\n",
            str(self),
            util.log_spacer,
        ):
            logging.info(line)

        draw = self.plot_trigger_summary and plot.available()
        if self.plot_trigger_summary and not draw:
            plot.missing_warning("trigger", ["plot_trigger_summary"])
        cursor = starttime
        while cursor < endtime:
            day_after = UTCDateTime(cursor.date) + _SECONDS_PER_DAY
            self._trigger_batch(cursor, min(day_after, endtime), region,
                                draw, interactive_plot)
            cursor = day_after

        logging.info(util.log_spacer)

    def _trigger_batch(self, batchstart, batchend, region, draw=False,
                       interactive_plot=False):
        """Read, threshold, refine, filter and write one day's batch, and
        with ``draw`` its summary figure."""

        logging.info("\tReading in .scanmseed...")
        data, stats = read_scanmseed(
            self.run, batchstart, batchend, self.pad,
            self.lut.unit_conversion_factor,
        )

        if batchend.time == time(0, 0):
            batchend = batchend - stats.delta

        if self.smooth_coa:
            data = self._smooth_coa(data, stats.sampling_rate)

        logging.info("\n\tTriggering events...")
        trigger_on = "COA_N" if self.normalise_coalescence else "COA"
        threshold = self._get_threshold(data[trigger_on], stats.sampling_rate)
        candidates = self._identify_candidates(data, trigger_on, threshold)

        if candidates.empty:
            logging.info(
                "\tNo events triggered at this threshold - try a lower "
                "detection threshold."
            )
            events = discarded = candidates
        else:
            refined = self._refine_candidates(candidates)
            keep = self._filter_mask(refined, batchstart, batchend, region)
            events = refined.take(keep)
            discarded = self._dropna(refined.take(~keep))
            logging.info(
                f"\n\t\t{len(events)} event(s) triggered within the "
                f"specified region between {batchstart} \n\t\tand {batchend}"
            )
            logging.info("\n\tWriting triggered events to file...")
            write_triggered_events(
                self.run, events, batchstart, self.write_event_time_windows
            )

        if draw:
            logging.info("\n\tPlotting trigger summary...")
            from quakemigrate_torch.plot.trigger import trigger_summary

            trigger_summary(
                events, batchstart, batchend, self.run,
                self.marginal_window, self.min_event_interval, threshold,
                self._threshold_method_string(),
                self.normalise_coalescence, self.lut, data, region,
                discarded, interactive_plot, xy_files=self.xy_files,
                plot_all_stns=self.plot_all_stns,
            )

    def _threshold_method_string(self):
        return {
            "static": f"{self.static_threshold} (static)",
            "mad": f"MAD ({self.mad_window_length} s / {self.mad_multiplier}x)",
            "median_ratio": (
                f"Median Ratio ({self.median_window_length} s / "
                f"{self.median_multiplier}x)"
            ),
        }[self.threshold_method]

    # -- thresholding ------------------------------------------------------------

    def _smooth_coa(self, data, sampling_rate):
        """Gaussian-smooth both coalescence traces in place."""

        logging.info("\n\tApplying smoothing...")
        sigma_samples = self.smoothing_kernel_sigma * sampling_rate
        for column in ("COA", "COA_N"):
            data[column] = gaussian_filter1d(
                np.asarray(data[column], dtype=float),
                sigma_samples,
                truncate=self.smoothing_kernel_width,
            )
        return data

    @util.timeit()
    def _get_threshold(self, scandata, sampling_rate):
        """Per-sample trigger threshold from the configured method."""

        values = np.asarray(scandata, dtype=float)
        method = self.threshold_method
        if method == "static":
            return np.full(len(values), float(self.static_threshold))

        window = (
            self.mad_window_length if method == "mad"
            else self.median_window_length
        )
        per_chunk = int(window * sampling_rate)
        chunks = [values[i: i + per_chunk]
                  for i in range(0, len(values), per_chunk)]

        def tiled(stat):
            per = [stat(chunk) for chunk in chunks]
            return chunks2trace(
                per, (len(chunks), len(chunks[0]))
            )[: len(values)]

        if method == "mad":
            return (tiled(np.median)
                    + self.mad_multiplier * tiled(util.calculate_mad))
        return tiled(np.median) * self.median_multiplier

    # -- candidate identification ---------------------------------------------------

    @util.timeit()
    def _identify_candidates(self, scandata, trigger_on, threshold):
        """One candidate row per contiguous above-threshold run."""

        slack = self.min_event_interval - self.marginal_window

        above = np.asarray(scandata[trigger_on], dtype=float) >= threshold
        hits = np.flatnonzero(above)
        runs = np.split(hits, np.flatnonzero(np.diff(hits) != 1) + 1)

        rows = []
        for n, run in enumerate(r for r in runs if r.size):
            # The peak is always read from the raw COA trace, matching the
            # origin-time determination in locate.
            peak = run[np.argmax(scandata["COA"][run])]
            t_first, t_last, t_peak = (
                UTCDateTime(ns=int(scandata["DT"][i].astype(np.int64)))
                for i in (run[0], run[-1], peak)
            )

            if t_peak - t_first < self.marginal_window:
                earliest = t_peak - self.min_event_interval
            else:
                earliest = t_first - slack
            if t_last - t_peak < self.marginal_window:
                latest = t_peak + self.min_event_interval
            else:
                latest = t_last + slack

            rows.append({
                "EventNum": n,
                "CoaTime": t_peak,
                "TRIG_COA": scandata[trigger_on][peak],
                "COA_X": scandata["X"][peak],
                "COA_Y": scandata["Y"][peak],
                "COA_Z": scandata["Z"][peak],
                "MinTime": earliest,
                "MaxTime": latest,
                "COA": scandata["COA"][peak],
                "COA_NORM": scandata["COA_N"][peak],
            })

        return Table.from_rows(rows, CANDIDATES_COLS)

    @util.timeit()
    def _refine_candidates(self, candidates):
        """
        Merge candidates whose marginal windows interlock. Two consecutive
        candidates stay separate only when the first's window ends before
        the second's peak (less a marginal window) AND the second's window
        starts after the first's peak (plus a marginal window).

        """

        ends, starts = candidates["MaxTime"], candidates["MinTime"]
        peaks = candidates["CoaTime"]
        separate = [
            ends[i] < peaks[i + 1] - self.marginal_window
            and starts[i + 1] > peaks[i] + self.marginal_window
            for i in range(len(candidates) - 1)
        ]
        group_ids = np.concatenate([[0], np.cumsum(separate)]).astype(int)

        rows = []
        n_groups = int(group_ids[-1]) + 1
        trig = np.asarray(candidates["TRIG_COA"], dtype=float)
        for n in range(n_groups):
            logging.debug(f"\t    Triggered event {n + 1} of {n_groups}")
            members = np.flatnonzero(group_ids == n)
            best = candidates.row(members[np.argmax(trig[members])])
            record = {field: best[field] for field in _EVENT_FIELDS}
            record["MinTime"] = min(starts[members])
            record["MaxTime"] = max(ends[members])
            record["EventID"] = _mint_uid(best["CoaTime"])
            rows.append(record)

        return Table.from_rows(rows, REFINED_EVENTS_COLS)

    @util.timeit()
    def _filter_events(self, events, starttime, endtime, region):
        """Keep events inside the batch time span and optional region box."""

        return events.take(self._filter_mask(events, starttime, endtime,
                                             region))

    @staticmethod
    def _filter_mask(events, starttime, endtime, region):
        """The rows of ``events`` inside the batch time span and optional
        region box."""

        keep = np.array([starttime <= t <= endtime
                         for t in events["CoaTime"]], dtype=bool)
        if region is not None:
            lo_x, lo_y, lo_z, hi_x, hi_y, hi_z = region
            for axis, lo, hi in (("COA_X", lo_x, hi_x), ("COA_Y", lo_y, hi_y),
                                 ("COA_Z", lo_z, hi_z)):
                values = np.asarray(events[axis], dtype=float)
                keep &= (values >= lo) & (values <= hi)
        return keep

    @staticmethod
    def _dropna(table):
        """The rows of ``table`` that hold no missing value (pandas'
        ``dropna``)."""

        return table.take(np.array(
            [not any(v is None or (isinstance(v, float) and v != v)
                     for v in row.values()) for row in table.rows()],
            dtype=bool))

    # -- validated options -----------------------------------------------------

    def _interval_property(label, rename_notice=None):
        """Validated view of _min_event_interval (>= 2x marginal window)."""

        def read(self):
            return self._min_event_interval

        def write(self, value):
            if value < 2 * self.marginal_window:
                raise ValueError(f"\t{label} must be >= 2 * marginal window.")
            if rename_notice:
                print(rename_notice)
            self._min_event_interval = value

        return property(read, write)

    min_event_interval = _interval_property("Minimum event interval")
    # Deprecated alias from older reference scripts.
    minimum_repeat = _interval_property(
        "Minimum repeat",
        "FutureWarning: Parameter name has changed - continuing.\n"
        "To remove this message, change:\n"
        "\t'minimum_repeat' -> 'min_event_interval'",
    )

    del _interval_property

    @property
    def threshold_method(self):
        return self._threshold_method

    @threshold_method.setter
    def threshold_method(self, value):
        if value == "dynamic":
            # Deprecated name from older reference scripts
            print(
                "FutureWarning: This threshold method has been renamed - "
                "continuing.\nTo remove this message, change:\n"
                "\t'dynamic' -> 'mad'"
            )
            value = "mad"
        if value not in ("static", "mad", "median_ratio"):
            raise util.InvalidTriggerThresholdMethodException
        self._threshold_method = value
