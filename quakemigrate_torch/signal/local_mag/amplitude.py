# -*- coding: utf-8 -*-
"""
Wood-Anderson amplitude measurement for local magnitudes, the port of the
JAX package's ``signal/local_mag/amplitude.py`` without pandas: the
observations are a :class:`~quakemigrate_torch.io.table.Table` whose
first column, ``id``, holds the trace ids (the index of the JAX
package's frame), then the columns of ``AMPS_COLS`` in order.

Reproduces the reference measurement semantics
(quakemigrate/signal/local_mag/amplitude.py:174-1051): per component, the
maximum half peak-to-trough amplitude (millimetres) inside P and S windows
built from picked-or-modelled arrival times ± marginal window ± a traveltime
fraction; an average (RMS/STD/ENV) signal amplitude; a pre-P noise
amplitude; and, when a measurement filter is applied, a gain correction read
off the filter's frequency response at the observed frequency.

"""

import logging

import numpy as np
from scipy.signal import find_peaks, hilbert, iirfilter, sosfreqz

import quakemigrate_torch.util as util
from quakemigrate_torch.coords import gps2dist_azimuth
from quakemigrate_torch.io.table import Table
from quakemigrate_torch.seis import UTCDateTime

AMPS_COLS = [
    "id",
    "epi_dist",
    "z_dist",
    "P_amp",
    "P_freq",
    "P_time",
    "P_avg_amp",
    "P_filter_gain",
    "S_amp",
    "S_freq",
    "S_time",
    "S_avg_amp",
    "S_filter_gain",
    "Noise_amp",
    "is_picked",
]

# Sentinels for pick resolution: a phase with no row in the picks table vs a
# pick attempt that failed (recorded as -1 by the picker).
_NO_ONSET = "absent"
_PICK_FAILED = "failed"

# Component selectors, in the row order of the .amps file.
_COMPONENT_ORDER = ("[E,2]", "[N,1]", "Z")


def _mean_amplitude_mm(data, method):
    """Average amplitude of a data vector, converted to millimetres."""

    if method == "RMS":
        level = np.sqrt(np.mean(data * data))
    elif method == "STD":
        level = np.std(data)
    elif method == "ENV":
        level = np.mean(np.abs(hilbert(data)))
    else:
        raise NotImplementedError(
            "Only 'RMS', 'STD' and 'ENV' are available currently."
        )
    return 1000.0 * level


class Amplitude:
    """
    Measures Wood-Anderson corrected amplitudes for every component of every
    station in the lookup table, for one located event.

    ``amplitude_params`` keys: signal_window, noise_window, noise_measure
    ("RMS"/"STD"/"ENV"), loc_method, prominence_multiplier, and either
    highpass_filter+highpass_freq or bandpass_filter+bandpass_lowcut+
    bandpass_highcut, with filter_corners.

    """

    def __init__(self, amplitude_params=None):
        params = dict(amplitude_params or {})

        # Response-removal settings live on the Archive; silently
        # ignoring them here would measure amplitudes with the wrong
        # deconvolution settings (ref amplitude.py:132-143 errors too)
        moved = [
            p for p in ("water_level", "pre_filt", "remove_full_response")
            if p in params
        ]
        if moved:
            raise AttributeError(
                "The response removal parameters ('water_level', "
                "'pre_filt', 'remove_full_response') have been moved to "
                "the Archive object. Please specify them there, e.g. as "
                "a response_removal dictionary."
            )

        if "signal_window" not in params:
            logging.warning(
                "Warning: 'signal_window' not specified. Set to default: 0"
            )
        self.signal_window = params.get("signal_window", 0.0)
        self.noise_window = params.get("noise_window", 5.0)
        self.noise_measure = params.get("noise_measure", "RMS")
        self.prominence_multiplier = params.get("prominence_multiplier", 0.0)
        self.loc_method = params.get("loc_method", "spline")
        self.filter_corners = params.get("filter_corners", 4)

        self.highpass_filter = params.get("highpass_filter", False)
        self.bandpass_filter = params.get("bandpass_filter", False)
        if self.highpass_filter and self.bandpass_filter:
            raise AttributeError(
                "Both bandpass filter *and* highpass filter selected! "
                "Please choose one or the other."
            )
        if self.highpass_filter:
            if "highpass_freq" not in params:
                raise AttributeError(
                    "Highpass filter frequency not specified! 'highpass_freq'"
                )
            self.highpass_freq = params["highpass_freq"]
        if self.bandpass_filter:
            self.bandpass_lowcut = params.get("bandpass_lowcut")
            self.bandpass_highcut = params.get("bandpass_highcut")
            if None in (self.bandpass_lowcut, self.bandpass_highcut):
                raise AttributeError("Bandpass filter frequencies not specified!")

    def __str__(self):
        lines = [
            "\t    Amplitude parameters:",
            f"\t\tSignal window    = {self.signal_window} s",
            f"\t\tNoise window     = {self.noise_window} s",
            f"\t\tNoise measure    = {self.noise_measure}",
            f"\t\tLocation used    = {self.loc_method}",
        ]
        if self.prominence_multiplier != 0.0:
            lines.append(
                f"\t\tProminence multiplier = {self.prominence_multiplier}"
            )
        if self.highpass_filter:
            lines += [
                "\t\tHighpass filter: ",
                f"\t\t    Filter frequency = {self.highpass_freq} Hz",
                f"\t\t    Filter corners   = {self.filter_corners}",
            ]
        elif self.bandpass_filter:
            lines += [
                "\t\tBandpass filter: ",
                f"\t\t    Lowcut frequency  = {self.bandpass_lowcut} Hz",
                f"\t\t    Highcut frequency = {self.bandpass_highcut} Hz",
                f"\t\t    Filter corners    = {self.filter_corners}",
            ]
        return "\n".join(lines) + "\n"

    @property
    def _filtering(self):
        return self.bandpass_filter or self.highpass_filter

    def pad(self, marginal_window, max_tt, fraction_tt):
        """Pre/post pads (s) for the amplitude read, with 6% taper headroom."""

        before = self.noise_window + marginal_window
        after = self.signal_window + max_tt * (1 + fraction_tt) + marginal_window
        taper = np.ceil((before + after) * 0.06)
        return before + taper, after + taper

    # -- the main measurement loop ----------------------------------------

    @util.timeit()
    def get_amplitudes(self, event, lut):
        """
        Build the amplitude observation table (one row per component, its
        trace id in the ``id`` column; schema = AMPS_COLS) for a located
        event.

        """

        hypocentre = event.get_hypocentre(self.loc_method)
        ijk = lut.index2coord(hypocentre, inverse=True)[0]
        try:
            tt_p = lut.traveltime_to("P", ijk)
            tt_s = lut.traveltime_to("S", ijk)
        except (KeyError, TypeError):
            raise util.LUTPhasesException(
                "Both P and S traveltimes are required to measure phase "
                "amplitudes for local magnitude calculation. Please create "
                "a new lookup table with phases=['P', 'S']"
            )

        before, after = self.pad(
            event.marginal_window, lut.max_traveltime, lut.fraction_tt
        )
        read_start, read_end = event.otime - before, event.otime + after

        records = []
        for idx, station_row in enumerate(lut.station_data.rows()):
            station = station_row["Name"]
            epi, dz = self._distances(
                hypocentre, station_row, lut.unit_conversion_factor
            )

            gather = event.data.raw_waveforms.select(station=station).copy()
            gather.trim(starttime=read_start, endtime=read_end)

            for selector in _COMPONENT_ORDER:
                record = dict.fromkeys(AMPS_COLS, np.nan)
                record.update(epi_dist=epi, z_dist=dz, is_picked=False)

                trace = self._usable_trace(
                    gather.select(component=selector), read_start, read_end
                )
                if trace is None:
                    record["id"] = f".{station}..{selector}"
                    records.append(record)
                    continue
                record["id"] = trace.id

                try:
                    trace = event.data.get_wa_waveform(trace, velocity=False)
                except (util.ResponseNotFoundError, util.ResponseRemovalError) as err:
                    logging.warning(str(err))
                    records.append(record)
                    continue

                sos = self._condition_trace(trace) if self._filtering else None

                try:
                    windows, record["is_picked"] = self._amplitude_windows(
                        station, idx, event, tt_p, tt_s, lut.fraction_tt
                    )
                except util.PickOrderException as err:
                    logging.warning(f"{err}")
                    records.append(record)
                    continue

                self._observe_phases(record, trace, windows, sos)
                record["Noise_amp"] = self._noise_level(trace, windows)
                records.append(record)

        return Table.from_rows(records, AMPS_COLS)

    @staticmethod
    def _usable_trace(candidates, read_start, read_end):
        """The single trace covering the full read window, else None."""

        if len(candidates) != 1:
            return None
        trace = candidates[0]
        tick = trace.stats.delta
        covers = (
            trace.stats.starttime < read_start + tick
            and trace.stats.endtime > read_end - tick
        )
        return trace if covers else None

    @staticmethod
    def _distances(hypocentre, station_row, unit_conversion_factor):
        """(epicentral, vertical) source-station distances in km."""

        lon, lat, depth = hypocentre
        epi_m, *_ = gps2dist_azimuth(
            lat, lon, station_row["Latitude"], station_row["Longitude"]
        )
        # Station elevations are stored positive-down (depth convention).
        per_km = 1000 / unit_conversion_factor
        return epi_m / 1000, (depth - station_row["Elevation"]) / per_km

    # -- filtering ---------------------------------------------------------

    def _condition_trace(self, trace):
        """
        Detrend/taper/filter the trace in place with the configured filter and
        return the filter's SOS (for later gain correction). A bandpass whose
        highcut reaches Nyquist degrades to a highpass at the lowcut.

        """

        nyquist = 0.5 * trace.stats.sampling_rate
        trace.detrend("linear")
        trace.taper(0.05, "cosine")

        if self.bandpass_filter:
            low, high = self.bandpass_lowcut, self.bandpass_highcut
            if high / nyquist - 1.0 > -1e-6:
                logging.warning(
                    f"\t{util.NyquistException(high, nyquist, trace.id)} "
                    "Applying a high-pass filter instead.."
                )
            else:
                trace.filter(
                    "bandpass", freqmin=low, freqmax=high,
                    corners=self.filter_corners, zerophase=False,
                )
                return iirfilter(
                    N=self.filter_corners, Wn=[low / nyquist, high / nyquist],
                    btype="bandpass", ftype="butter", output="sos",
                )
            corner = low
        else:
            corner = self.highpass_freq

        trace.filter(
            "highpass", freq=corner, corners=self.filter_corners, zerophase=False
        )
        return iirfilter(
            N=self.filter_corners, Wn=corner / nyquist, btype="highpass",
            ftype="butter", output="sos",
        )

    # -- window construction -----------------------------------------------

    def _amplitude_windows(self, station, idx, event, tt_p, tt_s, fraction_tt):
        """
        ((P_start, P_end), (S_start, S_end)) measurement windows and the
        is_picked flag. Overlapping windows are split at the midpoint; when
        the inter-phase gap is shorter than the signal window the P window
        ends at the S window start.

        """

        p_time, s_time, picked = self._arrival_times(station, idx, event, tt_p, tt_s)
        if not p_time < s_time:
            raise util.PickOrderException(event.uid, station, p_time, s_time)

        p_slack = event.marginal_window + tt_p[idx] * fraction_tt
        s_slack = event.marginal_window + tt_s[idx] * fraction_tt
        p_lo, p_hi = p_time - p_slack, p_time + p_slack
        s_lo = s_time - s_slack
        s_hi = s_time + s_slack + self.signal_window

        if s_lo < p_hi:
            midpoint = p_hi + (s_lo - p_hi) / 2
            windows = ((p_lo, midpoint), (midpoint, s_hi))
        elif s_lo - p_hi < self.signal_window:
            windows = ((p_lo, s_lo), (s_lo, s_hi))
        else:
            windows = ((p_lo, p_hi + self.signal_window), (s_lo, s_hi))
        return windows, picked

    def _arrival_times(self, station, idx, event, tt_p, tt_s):
        """
        Picked arrival times where available, modelled otherwise. A phase
        entirely absent from the picks table forces *both* phases onto
        modelled times; a failed pick (-1) falls back individually.

        """

        p_state = self._lookup_pick(event, station, "P")
        s_state = self._lookup_pick(event, station, "S")
        picked = isinstance(p_state, UTCDateTime) or isinstance(s_state, UTCDateTime)

        modelled_p = event.otime + tt_p[idx]
        modelled_s = event.otime + tt_s[idx]

        if _NO_ONSET in (p_state, s_state):
            logging.debug(
                f"Missing onset when picking on {station}. Using modelled "
                "arrival times."
            )
            return modelled_p, modelled_s, picked

        p_time = modelled_p if p_state is _PICK_FAILED else p_state
        s_time = modelled_s if s_state is _PICK_FAILED else s_state
        return p_time, s_time, picked

    @staticmethod
    def _lookup_pick(event, station, phase):
        """A UTCDateTime pick, _PICK_FAILED (-1 sentinel), or _NO_ONSET."""

        picks = event.picks["df"]
        rows = [row for row in picks.rows() if row["Station"] == station]
        if not rows:
            return _PICK_FAILED
        column = [row["PickTime"] for row in rows if row["Phase"] == phase]
        if not column:
            return _NO_ONSET
        try:
            return UTCDateTime(str(column[0]))
        except ValueError:
            return _PICK_FAILED

    # -- measurement --------------------------------------------------------

    def _observe_phases(self, record, trace, windows, sos):
        """Fill the P_*/S_* fields of ``record`` from the two windows."""

        for phase, (w_start, w_end) in zip("PS", windows):
            segment = trace.slice(w_start, w_end)
            if not bool(segment) or segment.data.max() == segment.data.min():
                logging.warning(
                    f"{phase} signal window doesn't contain any data for "
                    f"trace {segment.id}"
                )
                continue
            segment.detrend("linear")

            try:
                half_amp, freq, when = self._peak_to_trough(segment)
            except util.PeakToTroughError as err:
                logging.warning(
                    f"Amplitude measurement failed in {phase} signal window "
                    f"for trace {segment.id}: {err.msg}"
                )
                continue

            avg_amp = _mean_amplitude_mm(segment.data, self.noise_measure)

            gain = None
            if self._filtering:
                _, response = sosfreqz(
                    sos, worN=[freq], fs=trace.stats.sampling_rate
                )
                gain = np.abs(response[0])
                if not gain:
                    logging.info(
                        f"\t    Warning: Invalid frequency ({freq:.5g}"
                        f" Hz) for {phase}_amp measurement on:\n\t\t{trace}"
                    )
                    continue
                half_amp /= gain
                avg_amp /= gain

            record[f"{phase}_amp"] = half_amp
            record[f"{phase}_freq"] = freq
            record[f"{phase}_time"] = when
            record[f"{phase}_avg_amp"] = avg_amp
            record[f"{phase}_filter_gain"] = gain

    def _noise_level(self, trace, windows):
        """Average amplitude (mm) in the noise window ending at P onset."""

        p_window_start = windows[0][0]
        segment = trace.slice(p_window_start - self.noise_window, p_window_start)
        if not bool(segment) or segment.data.max() == segment.data.min():
            logging.warning(
                f"Noise window doesn't contain any data for trace {segment.id}"
            )
            return np.nan
        segment.detrend("linear")
        return _mean_amplitude_mm(segment.data, self.noise_measure)

    def _peak_to_trough(self, trace):
        """
        (half peak-to-trough amplitude in mm, approximate frequency, centre
        time) of the largest adjacent peak-trough swing.

        Peaks and troughs are paired by index alignment; depending on which
        extremum comes first and the count difference, one or two candidate
        pairings exist (see table below) and the swing is maximised over
        both. Pathological sequences raise PeakToTroughError.

        """

        floor = self.prominence_multiplier * np.max(np.abs(trace.data))
        peaks, _ = find_peaks(trace.data, prominence=floor)
        troughs, _ = find_peaks(-trace.data, prominence=floor)
        n_p, n_t = len(peaks), len(troughs)

        if n_p == 0 or n_t == 0:
            raise util.PeakToTroughError("No peaks or troughs found!")

        # Candidate (peak_indices, trough_indices) alignments.
        if n_p == 1 and n_t == 1:
            pairings = [(peaks, troughs)]
        elif n_p == n_t:
            if peaks[0] < troughs[0]:
                pairings = [(peaks, troughs), (peaks[1:], troughs[:-1])]
            else:
                pairings = [(peaks, troughs), (peaks[:-1], troughs[1:])]
        elif abs(n_p - n_t) != 1:
            raise util.PeakToTroughError("Consecutive peaks/troughs!")
        elif n_p > n_t:
            if peaks[0] >= troughs[0]:
                raise util.PeakToTroughError("Consecutive peaks/troughs!")
            pairings = [(peaks[:-1], troughs), (peaks[1:], troughs)]
        else:
            if peaks[0] <= troughs[0]:
                raise util.PeakToTroughError("Consecutive peaks/troughs!")
            pairings = [(peaks, troughs[1:]), (peaks, troughs[:-1])]

        best = None
        for pk, tr_ in pairings:
            swings = np.abs(trace.data[pk] - trace.data[tr_])
            top = int(np.argmax(swings))
            if best is None or swings[top] > best[0]:
                best = (swings[top], pk[top], tr_[top])

        full_amp, peak_idx, trough_idx = best
        t_axis = trace.times()
        t_peak, t_trough = t_axis[peak_idx], t_axis[trough_idx]
        centre = trace.stats.starttime + t_peak + (t_trough - t_peak) / 2
        frequency = 0.5 / np.abs(t_peak - t_trough)

        # ML uses zero-to-peak amplitude, reported in millimetres.
        return full_amp * 1000 / 2, frequency, centre
