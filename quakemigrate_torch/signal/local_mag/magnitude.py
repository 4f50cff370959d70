# -*- coding: utf-8 -*-
"""
Local magnitude estimation from Wood-Anderson amplitude observations, the
port of the JAX package's ``signal/local_mag/magnitude.py`` without
pandas: each table is a :class:`~quakemigrate_torch.io.table.Table`
whose ``id`` column holds the trace ids (the JAX frames' index), and
each pandas step (copy, new column, ``dropna``, boolean selection) is
the same operation on numpy columns.

Implements ``ML = log10(amp) + logA0(dist) + station_correction`` with the
same eight published attenuation curves as the reference
(quakemigrate/signal/local_mag/magnitude.py:645-706), expressed here as a
coefficient table over the common functional form
``a*log10(d/d0) + b*(d-d0) + c``; plus the observation filters, the
(optionally weighted) network mean, and the amplitude-vs-distance r² quality
metric (ref magnitude.py:403-424, 708-928).

"""

import logging
import re

import numpy as np

import quakemigrate_torch.plot as plot
from quakemigrate_torch.io.table import Table

# logA0 curves of the form a*log10(dist/d0) + b*(dist-d0) + c,
# keyed by the published-curve name: (a, d0, b, c).
_HINGE_CURVES = {
    "keir2006": (1.196997, 17.0, 0.001066, 2.0),
    "Danakil2017": (1.274336, 17.0, -0.000273, 2.0),
    "Greenfield2018_askja": (1.4406, 17.0, 0.003, 2.0),
    "Greenfield2018_bardarbunga": (1.2534, 17.0, 0.0032, 2.0),
    "Greenfield2018_comb": (1.1999, 17.0, 0.0016, 2.0),
    "Hutton-Boore": (1.11, 100.0, 0.00189, 3.0),
    "Langston1998": (0.776, 17.0, 0.000902, 2.0),
}

# Curves that do not fit the hinge form.
_OTHER_CURVES = {
    "UK": lambda d: (
        1.11 * np.log10(d) + 0.00189 * d - 1.16 * np.exp(-0.2 * d) - 2.09
    ),
}


def _isnull(values):
    """pandas' ``isnull`` of a column: None or a float NaN."""

    return np.array([v is None or (isinstance(v, (float, np.floating))
                                   and np.isnan(v)) for v in values],
                    dtype=bool)


def _floats(values):
    """A column as float64 values, None as NaN."""

    return np.array([np.nan if v is None else v for v in values],
                    dtype=np.float64)


def _copy(table):
    """A copy of a Table (its columns copied)."""

    return Table({name: np.array(table[name], copy=True)
                  for name in table.names}, table.names)


def _evaluate_logA0(curve, dist):
    """Evaluate a named attenuation curve (or raise for unknown names)."""

    if curve in _HINGE_CURVES:
        a, d0, b, c = _HINGE_CURVES[curve]
        return a * np.log10(dist / d0) + b * (dist - d0) + c
    if curve in _OTHER_CURVES:
        return _OTHER_CURVES[curve](dist)
    raise ValueError(f"{curve} is not a valid A0 attenuation function.")


class Magnitude:
    """
    Turns a table of amplitude observations into per-trace local magnitudes
    and a network-averaged estimate.

    Parameters arrive as a single dict; recognised keys (with defaults):
    A0 (required), use_hyp_dist (False), amp_feature ("S_amp"),
    station_corrections ({}), amp_multiplier (1.0), weighted_mean (False),
    trace_filter (None), noise_filter (1.0), station_filter (None),
    dist_filter (False), pick_filter (False), r2_only_used (True).

    """

    _DEFAULTS = {
        "use_hyp_dist": False,
        "amp_feature": "S_amp",
        "station_corrections": {},
        "amp_multiplier": 1.0,
        "weighted_mean": False,
        "trace_filter": None,
        "noise_filter": 1.0,
        "station_filter": None,
        "dist_filter": False,
        "pick_filter": False,
        "r2_only_used": True,
    }

    def __init__(self, magnitude_params=None):
        params = dict(magnitude_params or {})
        self.A0 = params.get("A0")
        if not self.A0:
            raise TypeError("A0 attenuation correction not specified in params!")
        for key, default in self._DEFAULTS.items():
            # copy mutable defaults so instances never share them
            value = params.get(key, dict(default) if isinstance(default, dict)
                               else default)
            setattr(self, key, value)

    def __str__(self):
        lines = [
            "\t    Magnitude parameters:",
            f"\t\tA0 attenuation function = {self.A0}",
            f"\t\tUse hyp distance        = {self.use_hyp_dist}",
            f"\t\tAmplitude feature       = {self.amp_feature}",
        ]
        if self.station_corrections:
            lines.append("\t\tStation corrections supplied")
        lines += [
            f"\t\tAmplitude multiplier    = {self.amp_multiplier}",
            f"\t\tUse weighted mean       = {self.weighted_mean}",
        ]
        if self.trace_filter is not None:
            lines.append(f"\t\tTrace filter            = {self.trace_filter}")
        lines.append(f"\t\tNoise filter            = {self.noise_filter} x")
        if self.station_filter is not None:
            lines.append(f"\t\tStation filter          = {self.station_filter}")
        if self.dist_filter:
            lines.append(f"\t\tDistance filter         = {self.dist_filter} km")
        if self.pick_filter:
            lines.append("\t\tUsing picked observations only")
        return "\n".join(lines) + "\n"

    # -- helpers ---------------------------------------------------------

    def _attenuation(self, dist):
        """logA0 term: user callable or a named built-in curve."""

        return self.A0(dist) if callable(self.A0) else _evaluate_logA0(self.A0, dist)

    def _source_distances(self, frame):
        """Hypocentral or epicentral distance per observation (km)."""

        epi = _floats(frame["epi_dist"])
        if self.use_hyp_dist:
            return np.hypot(epi, _floats(frame["z_dist"]))
        return epi.copy()

    def _corrections_for(self, trace_ids):
        """Per-trace station correction terms (0 where none supplied)."""

        return np.array([self.station_corrections.get(t, 0.0) for t in trace_ids])

    def _gain_corrected_noise(self, frame, noise):
        """Divide noise amps by the signal filter gain when gains exist."""

        gains = frame[f"{self.amp_feature[0]}_filter_gain"]
        if _isnull(gains).all():
            return noise, False
        return noise / _floats(gains), True

    # -- per-trace magnitudes --------------------------------------------

    def calculate_magnitudes(self, amplitudes):
        """
        Append ML / ML_Err columns (on a copy of the amplitudes table). The
        magnitude error spans log10(amp ± noise); observations below the
        noise amplitude, or with zero amplitude/distance, become NaN.

        """

        amps = _floats(amplitudes[self.amp_feature]) * self.amp_multiplier
        noise = _floats(amplitudes["Noise_amp"]) * self.amp_multiplier
        noise, _ = self._gain_corrected_noise(amplitudes, noise)

        with np.errstate(invalid="ignore"):
            amps = np.where((amps < noise) | (amps == 0.0), np.nan, amps)

        dist = self._source_distances(amplitudes)
        dist[dist == 0.0] = np.nan

        att = self._attenuation(dist)
        corr = self._corrections_for(amplitudes["id"])
        with np.errstate(invalid="ignore", divide="ignore"):
            ml = np.log10(amps) + att + corr
            span = np.log10(amps + noise) - np.log10(amps - noise)

        out = _copy(amplitudes)
        out["ML"] = ml
        out["ML_Err"] = span
        return out

    # -- network mean -----------------------------------------------------

    def mean_magnitude(self, magnitudes):
        """
        Combine per-trace magnitudes into a network mean.

        Returns ``(mean, err, r_squared, table)`` where ``table`` gains
        Station_Correction, the active filter flags, Dist and Used columns.
        With ``weighted_mean``, observations are weighted by 1/ML_Err².

        """

        table = _copy(magnitudes)
        table["Station_Correction"] = self._corrections_for(table["id"])

        noise, corrected = self._gain_corrected_noise(
            table, _floats(table["Noise_amp"]))
        if corrected:
            table["Noise_amp"] = noise

        table = self._apply_filters(table)
        kept = table.take(table["Used"])
        if kept.empty:
            logging.warning(
                "\t    No magnitude observations match the filtering "
                "criteria! Skipping."
            )
            return np.nan, np.nan, np.nan, table

        values = _floats(kept["ML"])
        errors = _floats(kept["ML_Err"])
        weights = errors**-2.0 if self.weighted_mean else np.ones_like(values)

        mean = np.average(values, weights=weights)
        if values.size > 1:
            err = np.sqrt(np.sum(((values - mean) * weights) ** 2) / weights.sum())
        else:
            err = errors[0]

        r2 = self._r_squared(table, mean, only_used=self.r2_only_used)
        return mean, err, r2, table

    def _apply_filters(self, table):
        """
        Add a flag column per active filter and combine them into ``Used``.
        Rows lacking an amplitude or noise measurement are dropped first.
        Also adds the Dist column (zero distances masked to NaN).

        """

        table = _copy(table.take(~(_isnull(table[self.amp_feature])
                                   | _isnull(table["Noise_amp"]))))
        ids = [str(i) for i in table["id"]]

        flags = []
        if self.noise_filter != 0.0:
            with np.errstate(invalid="ignore"):
                table["Noise_Filter"] = (
                    _floats(table[self.amp_feature])
                    > _floats(table["Noise_amp"]) * self.noise_filter
                )
            flags.append("Noise_Filter")

        if self.trace_filter is not None:
            # pandas' str.contains: a regular expression, searched
            table["Trace_Filter"] = np.array(
                [re.search(self.trace_filter, i) is not None for i in ids],
                dtype=bool)
            flags.append("Trace_Filter")

        if self.station_filter is not None:
            excluded = np.zeros(len(table), dtype=bool)
            for station in list(self.station_filter):
                excluded |= np.array([f".{station}." in i for i in ids],
                                     dtype=bool)
            table["Station_Filter"] = ~excluded
            flags.append("Station_Filter")

        dist = self._source_distances(table)
        if self.dist_filter:
            table["Dist_Filter"] = dist <= self.dist_filter
            flags.append("Dist_Filter")

        dist[dist == 0.0] = np.nan
        table["Dist"] = dist

        if self.pick_filter:
            flags.append("is_picked")

        used = np.ones(len(table), dtype=bool)
        for flag in flags:
            used &= np.asarray(table[flag]).astype(bool)
        table["Used"] = used
        return table

    # -- quality of fit ---------------------------------------------------

    def _r_squared(self, table, mean_mag, only_used=True):
        """
        r² between observed log-amplitudes (corrected) and those predicted
        by the mean magnitude through the attenuation curve.

        With ``only_used=False``, rows are kept if they pass the structural
        filters, and noise-dominated rows are kept only where the predicted
        amplitude is at least 5x their noise amplitude (requires an active
        noise filter).

        """

        if only_used:
            table = table.take(table["Used"])
        else:
            for flag in ("Trace_Filter", "Station_Filter", "Dist_Filter"):
                if flag in table.names:
                    table = table.take(np.asarray(table[flag], dtype=bool))
            if self.noise_filter <= 0.0:
                raise AttributeError(
                    "Noise filter must be greater than 1 to use custom mag "
                    "r-squared filtering. Change 'only_used' to True, or set "
                    f"a noise filter (current = {self.noise_filter})"
                )
            # Reference-parity note: the reference INTENDS to drop
            # noise-dominated rows whose predicted amplitude is < 5x
            # their noise amplitude, but its `magnitudes.drop(labels=...)`
            # discards the result (ref magnitude.py:891 -- not inplace),
            # so the filter is a no-op and ALL structurally-passing rows
            # enter the r² there. We reproduce that actual behaviour so
            # ML_r2 matches the reference output; implementing the
            # documented intent would drop
            # weak.index[predicted_amp / corrected_noise_amp < 5] rows
            # over table[~table["Noise_Filter"]].

        observed = (
            _floats(table[self.amp_feature])
            * self.amp_multiplier
            * 10.0 ** _floats(table["Station_Correction"])
        )
        if observed.size < 2 or observed.min() == observed.max():
            logging.info(
                "\t    Insufficient amplitude measurements to make an r2 "
                "estimate - skipping."
            )
            return np.nan

        log_obs = np.log10(observed)
        modelled = mean_mag - self._attenuation(_floats(table["Dist"]))
        residual_ss = np.sum((log_obs - modelled) ** 2)
        total_ss = np.sum((log_obs - log_obs.mean()) ** 2)
        return (total_ss - residual_ss) / total_ss

    # -- plotting ----------------------------------------------------------

    def plot_amplitudes(
        self, magnitudes, event, run, unit_conversion_factor, noise_measure="RMS"
    ):
        """Write the amplitude-vs-distance summary figure for this event
        (where matplotlib imports)."""

        if not plot.available():
            return
        from quakemigrate_torch.plot.amplitudes import (
            plot_amplitudes_vs_distance,
        )

        plot_amplitudes_vs_distance(
            self, magnitudes, event, run, unit_conversion_factor, noise_measure
        )
