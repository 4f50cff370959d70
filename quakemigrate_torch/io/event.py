# -*- coding: utf-8 -*-
"""
The Event object: a single candidate earthquake's accumulated state
through the locate stage — waveforms, coalescence series, 4-D map,
origin time, the three location estimates, picks and local magnitude —
plus the ``.event`` CSV writer
with the reference's 20-column schema and precision contract, the port
of the JAX package's ``io/event.py`` without pandas. The coalescence
series is a :class:`~quakemigrate_torch.io.table.Table` of numpy
columns, and the ``.event`` file is the text pandas' ``to_csv`` writes
for the JAX package's one-row frame.

"""

import logging
import re

import numpy as np

import quakemigrate_torch.util as util
from .table import Table

_AXES = ("X", "Y", "Z")
_UNC_KEYS = ("ErrX", "ErrY", "ErrZ")

# The 20-column .event schema, in file order.
EVENT_FILE_COLS = (
    ["EventID", "DT", *_AXES, "COA", "COA_NORM"]
    + [f"GAU_{key}" for key in _AXES + _UNC_KEYS]
    + [f"COV_{key}" for key in (*_UNC_KEYS, "Err_XYZ")]
    + ["TRIG_COA", "DEC_COA", "DEC_COA_NORM"]
)


def _missing(x):
    return isinstance(x, (float, np.floating)) and np.isnan(x)


class Event:
    """State accumulator for one triggered/located event."""

    def __init__(self, marginal_window, triggered_event=None):
        self.marginal_window = marginal_window

        if triggered_event is not None:
            self.uid = triggered_event["EventID"]
            self.trigger_time = triggered_event["CoaTime"]
            self.trigger_info = self._trigger_fields(triggered_event)

        self.data = self.coa_data = self.map4d = None
        self.trim_bounds = self._marginalise_inputs = None
        # pass 1's (max_coa, max_coa_n, max_idx) over the locate window
        self._pass1 = None
        self.onset_data = self.otime = None
        self.locations, self.picks, self.localmag = {}, {}, {}

    @staticmethod
    def _trigger_fields(row):
        """
        TRIG/DEC coalescence values carried over from the trigger stage.
        Old-format trigger files name the peak-coalescence column COA_V.

        """

        for trig_key in ("TRIG_COA", "COA_V"):
            if trig_key in row:
                return {
                    "TRIG_COA": row[trig_key],
                    "DEC_COA": row.get("COA", np.nan),
                    "DEC_COA_NORM": row.get("COA_NORM", np.nan),
                }
        return dict.fromkeys(("TRIG_COA", "DEC_COA", "DEC_COA_NORM"), np.nan)

    # -- accumulation -------------------------------------------------------

    def add_waveform_data(self, data):
        self.data = data

    def add_compute_output(self, times, max_coa, max_coa_n, coord, map4d,
                           onset_data):
        """
        Record the locate-stage migration outputs: coalescence time series,
        the retained 4-D map ([nx, ny, nz, nsamples], or None on the
        two-pass path) and the onset data. The origin time is the time of
        peak coalescence.

        """

        columns = {
            "DT": times,
            "COA": np.asarray(max_coa, dtype=np.float64),
            "COA_NORM": np.asarray(max_coa_n, dtype=np.float64),
        }
        columns.update(zip(_AXES, np.asarray(coord).T))
        self.coa_data = Table(columns)
        self.map4d = map4d
        self.onset_data = onset_data
        self.otime = self._peak_row()["DT"]

    def _peak_row(self):
        """The coa_data row at maximum coalescence (first on ties)."""

        return self.coa_data.row(
            int(np.argmax(np.asarray(self.coa_data["COA"], dtype=float))))

    def _store_location(self, name, coords, uncertainties=None,
                        geometric_error=False):
        entry = dict(zip(_AXES, coords))
        if uncertainties is not None:
            entry.update(zip(_UNC_KEYS, uncertainties))
            if geometric_error:
                entry["Err_XYZ"] = float(np.prod(uncertainties)) ** (1 / 3)
        self.locations[name] = entry

    def add_covariance_location(self, xyz, xyz_unc):
        self._store_location("covariance", xyz, xyz_unc, geometric_error=True)

    def add_gaussian_location(self, xyz, xyz_unc):
        self._store_location("gaussian", xyz, xyz_unc)

    def add_spline_location(self, xyz):
        self._store_location("spline", xyz)

    def add_picks(self, pick_df, **extras):
        self.picks = {"df": pick_df, **extras}

    def add_local_magnitude(self, mag, mag_err, mag_r2):
        self.localmag = {"ML": mag, "ML_Err": mag_err, "ML_r2": mag_r2}

    # -- window logic --------------------------------------------------------

    def in_marginal_window(self):
        """Whether the trigger time falls inside otime ± marginal_window."""

        inside = abs(self.trigger_time - self.otime) < self.marginal_window
        if not inside:
            for line in (
                f"\tEvent {self.uid} is outside marginal window.",
                "\tDefine more realistic error - the marginal window should "
                "be an estimate of overall uncertainty.",
                util.log_spacer,
            ):
                logging.info(line)
        return inside

    def mw_times(self, sampling_rate, count=None):
        """
        Sample timestamps spanning trigger_time ± 2·marginal_window.

        Pass ``count`` (the migration window's actual sample count) to
        guarantee the timestamps line up 1:1 with the computed
        coalescence — nearest-sample rounding of ``4·mw·rate`` can
        otherwise disagree with the scan window's own rounding by one.

        """

        if count is None:
            count = int(round(4 * self.marginal_window * sampling_rate)) + 1
        first = self.trigger_time - 2 * self.marginal_window
        return np.array(
            [first + i / sampling_rate for i in range(count)], dtype=object
        )

    def trim2window(self):
        """
        Restrict coa_data (and map4d where kept) to otime ±
        marginal_window, remembering the sample bounds (``trim_bounds``,
        the first and last kept sample) for the map-free marginalisation,
        then re-derive the origin time. The marginalised window, and the
        kept map, is ``[first, last)``, end-exclusive while coa_data keeps
        row ``last``: a reference quirk that its golden .event files pin,
        kept here.

        """

        lo = self.otime - self.marginal_window
        hi = self.otime + self.marginal_window
        kept = np.flatnonzero([lo <= t <= hi for t in self.coa_data["DT"]])
        self.coa_data = self.coa_data.take(kept)
        self.trim_bounds = (int(kept[0]), int(kept[-1]))
        if self.map4d is not None:
            first, last = self.trim_bounds
            self.map4d = self.map4d[..., first:last]
        self.otime = self._peak_row()["DT"]

    # -- output --------------------------------------------------------------

    def write(self, run, lut):
        """Write the ``.event`` file, honouring the LUT precision contract."""

        outdir = run.path / "locate" / run.subname / "events"
        outdir.mkdir(exist_ok=True, parents=True)

        record = {
            "EventID": self.uid,
            **self.trigger_info,
            **self.localmag,
            **self.max_coalescence,
            **self.locations["spline"],
        }
        record.update(
            (f"GAU_{key}", val)
            for key, val in self.locations["gaussian"].items()
        )
        record.update(
            (f"COV_{key}", self.locations["covariance"][key])
            for key in (*_UNC_KEYS, "Err_XYZ")
        )

        columns = list(EVENT_FILE_COLS)
        has_ml = self.localmag.get("ML") is not None
        if has_ml:
            columns += ["ML", "ML_Err", "ML_r2"]

        frame = Table({name: [record[name]] for name in columns}, columns)
        self._format_sig_figs(frame, like="COA", spec=".4g")
        self._round_position_columns(frame, lut)
        if has_ml:
            self._format_sig_figs(frame, like="ML", spec=".3g")

        frame.to_csv((outdir / str(self.uid)).with_suffix(".event"))

    @staticmethod
    def _format_sig_figs(frame, like, spec):
        """Render matching columns as fixed-significant-figure strings."""

        for col in [c for c in frame.names if like in c]:
            frame[col] = [x if _missing(x) else format(x, spec)
                          for x in frame[col]]

    @staticmethod
    def _round_position_columns(frame, lut):
        """
        Round location columns to match the LUT's spatial precision: X/Y to
        at least 6 decimals, Z (and all uncertainty columns) to the depth
        precision — whole units when the grid is in metres.

        """

        for precision, axis in zip(lut.precision, _AXES):
            targets = [axis, f"GAU_{axis}"]
            if axis == "Z":
                decimals = max(precision + 2, 3 if lut.unit_name == "km" else 0)
                targets += [c for c in frame.names
                            if re.search("Err[X,Y,Z]", c)]
                targets.append("COV_Err_XYZ")
            else:
                decimals = max(precision + 2, 6)
            for col in targets:
                rounded = np.round(np.asarray(frame[col], dtype=float),
                                   decimals=decimals)
                if decimals <= 0:
                    # Per value: a degenerate uncertainty fit can leave
                    # NaN, which stays NaN
                    frame[col] = [x if np.isnan(x) else int(x)
                                  for x in rounded]
                else:
                    frame[col] = rounded

    # -- views ----------------------------------------------------------------

    def get_hypocentre(self, method="spline"):
        """[X, Y, Z] of the chosen location estimate."""

        return np.array([self.locations[method][axis] for axis in _AXES])

    hypocentre = property(get_hypocentre)

    def get_loc_uncertainty(self, method="gaussian"):
        return np.array([self.locations[method][key] for key in _UNC_KEYS])

    loc_uncertainty = property(get_loc_uncertainty)

    @property
    def local_magnitude(self):
        if not self.localmag:
            return None
        return iter(self.localmag.values())

    @property
    def max_coalescence(self):
        peak = self._peak_row()
        return {key: peak[key] for key in ("DT", "COA", "COA_NORM")}
