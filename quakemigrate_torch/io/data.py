# -*- coding: utf-8 -*-
"""
Waveform archive access and data-quality checking, the port of the JAX
package's ``io/data.py``.

``Archive`` resolves time windows onto a day-structured waveform archive
(the same seven named layouts as the reference, quakemigrate/io/data.py:
181-219, plus custom format strings) and returns a :class:`WaveformData`.
``WaveformData`` owns the query result: availability checks, instrument
response removal, and Wood-Anderson simulation (``seis.response``).

"""

import logging
import pathlib

import numpy as np

import quakemigrate_torch.util as util
from quakemigrate_torch.seis import Stream, UTCDateTime, read
from quakemigrate_torch.seis.response import paz_for_output, simulate_seismometer

# Named archive layouts -> glob templates. "{station}" survives the first
# .format() pass (day fields) and is filled per station in the second.
_ARCHIVE_LAYOUTS = {
    "SeisComp3": (
        "{year}/*/{station}/<CH>/*.{station}.*.*.D.{year}.{jday:03d}"
    ),
    "YEAR/JD/*_STATION_*": "{year}/{jday:03d}/*_{station}_*",
    "YEAR/JD/STATION": "{year}/{jday:03d}/{station}*",
    "STATION.YEAR.JULIANDAY": "*{station}.*.{year}.{jday:03d}",
    "/STATION/STATION.YearMonthDay": (
        "{station}/{station}.{year}{month:02d}{day:02d}"
    ),
    "YEAR_JD/STATION*": "{year}_{jday:03d}/{station}*",
    "YEAR_JD/STATION_*": "{year}_{jday:03d}/{station}_*",
}

_SECONDS_PER_DAY = 86400

# Configuration shared between an Archive and the WaveformData it produces.
_SHARED_CONFIG = (
    "stations",
    "read_all_stations",
    "resample",
    "upfactor",
    "response_inv",
    "water_level",
    "pre_filt",
    "remove_full_response",
)


class Archive:
    """
    Reads archived continuous waveform data between two timestamps, returning
    a :class:`WaveformData`. Configure the directory layout with
    ``archive_format`` (a named layout) or ``format`` (a custom template).

    """

    def __init__(self, archive_path, stations, archive_format=None, **kwargs):
        self.archive_path = pathlib.Path(archive_path)
        self.stations = np.asarray(stations["Name"], dtype=str)
        if archive_format:
            self.path_structure(archive_format, kwargs.get("channels", "*"))
        else:
            self.format = kwargs.get("format")

        toggles = {
            "read_all_stations": False,
            "resample": False,
            "upfactor": None,
            "interpolate": False,
            "response_inv": None,
        }
        for key, default in toggles.items():
            setattr(self, key, kwargs.get(key, default))

        removal = kwargs.get("response_removal_params", {})
        if self.response_inv and "water_level" not in removal:
            logging.warning(
                "'water level' for instrument correction not "
                "specified. Set to default: 60"
            )
        self.water_level = removal.get("water_level", 60.0)
        self.pre_filt = removal.get("pre_filt")
        self.remove_full_response = removal.get("remove_full_response", False)

    def __str__(self, response_only=False):
        if self.response_inv:
            response_lines = [
                "\tResponse removal parameters:",
                f"\t\tWater level  = {self.water_level}",
            ]
            if self.pre_filt is not None:
                response_lines.append(f"\t\tPre-filter   = {self.pre_filt} Hz")
            response_lines.append(
                "\t\tRemove full response (inc. FIR stages) = "
                f"{self.remove_full_response}"
            )
            response_str = "\n".join(response_lines) + "\n"
        else:
            response_str = "\tNo instrument response inventory provided!\n"

        if response_only:
            return response_str

        lines = [
            "quakemigrate_torch Archive object",
            f"\tArchive path\t:\t{self.archive_path}",
            f"\tPath structure\t:\t{self.format}",
            f"\tResampling\t:\t{self.resample}",
        ]
        if self.upfactor:
            lines.append(f"\tUpfactor\t:\t{self.upfactor}")
        lines.append("\tStations:")
        lines.extend(f"\t\t{station}" for station in self.stations)
        return "\n".join(lines) + f"\n{response_str}"

    def path_structure(self, archive_format="YEAR/JD/STATION", channels="*"):
        """Select one of the named archive layouts (see _ARCHIVE_LAYOUTS)."""

        try:
            template = _ARCHIVE_LAYOUTS[archive_format]
        except KeyError:
            raise util.ArchivePathStructureError(archive_format)
        self.format = template.replace("<CH>", channels)

    def read_waveform_data(self, starttime, endtime, pre_pad=0.0, post_pad=0.0):
        """
        Read all waveform data overlapping [starttime - pre_pad,
        endtime + post_pad]. The pads survive only in ``raw_waveforms``;
        ``waveforms`` is trimmed back to the requested window.

        """

        pre_pad, post_pad = max(0.0, pre_pad), max(0.0, post_pad)
        read_start = starttime - pre_pad
        read_end = endtime + post_pad

        inherited = {key: getattr(self, key) for key in _SHARED_CONFIG}
        data = WaveformData(
            starttime, endtime, pre_pad=pre_pad, post_pad=post_pad, **inherited
        )

        paths = self._candidate_files(read_start, read_end)
        if not paths:
            raise util.ArchiveEmptyException

        gathered = Stream()
        for path in paths:
            try:
                gathered += read(str(path), starttime=read_start,
                                 endtime=read_end, nearest_sample=True)
            except (TypeError, OSError, ValueError, NotImplementedError,
                    StopIteration):
                # TypeError: not a recognised waveform format; OSError
                # covers directories matched by the archive glob and
                # permission/IO failures; ValueError/NotImplementedError/
                # StopIteration: corrupt or unsupported-subformat files
                # (e.g. GSE2 checksum mismatches, truncated headers) --
                # skip, don't kill the scan
                logging.info(f"File not readable as waveform data - {path}")

        gathered = util.merge_stream(gathered)
        data.raw_waveforms = gathered.copy()

        usable = util.shift_to_sample(gathered, interpolate=self.interpolate)
        if self.read_all_stations:
            wanted = Stream()
            for station in self.stations:
                wanted += usable.select(station=station)
            # shift_to_sample already returned private copies; select()
            # only re-groups those traces, so no further copy is needed.
            usable = wanted

        if pre_pad or post_pad:
            trimmed = Stream()
            for trace in usable:
                trace.trim(starttime=starttime, endtime=endtime,
                           nearest_sample=True)
                if bool(trace):
                    trimmed += trace
            usable = trimmed

        if not bool(usable):
            raise util.DataGapException

        data.waveforms = usable
        return data

    def _candidate_files(self, window_start, window_end):
        """All archive paths whose day/station patterns overlap the window."""

        if self.format is None:
            raise util.ArchiveFormatException

        wildcards = ["*"] if self.read_all_stations else list(self.stations)
        paths = []
        day = UTCDateTime(window_start.date)
        while day <= window_end:
            day_pattern = self.format.format(
                year=day.year,
                month=day.month,
                day=day.day,
                jday=day.julday,
                station="{station}",
                dtime=day,
            )
            for name in wildcards:
                glob_pattern = day_pattern.format(station=name)
                if name == "*":
                    glob_pattern = glob_pattern.replace("**", "*")
                paths.extend(self.archive_path.glob(glob_pattern))
            day = UTCDateTime(day.date) + _SECONDS_PER_DAY
        return paths


class WaveformData:
    """
    One archive query's worth of waveform data, plus the quality checks and
    response-removal utilities that operate on it.

    """

    _DEFAULTS = {
        "stations": None,
        "response_inv": None,
        "water_level": 60.0,
        "pre_filt": None,
        "remove_full_response": False,
        "read_all_stations": False,
        "resample": False,
        "upfactor": None,
        "pre_pad": 0.0,
        "post_pad": 0.0,
    }

    def __init__(self, starttime, endtime, **kwargs):
        self.starttime, self.endtime = starttime, endtime
        for key, default in self._DEFAULTS.items():
            setattr(self, key, kwargs.get(key, default))

        self.raw_waveforms = self.wa_waveforms = self.real_waveforms = None
        self.waveforms = Stream()

    # -- data quality -------------------------------------------------------

    def check_availability(self, st, **criteria):
        """
        Evaluate each channel of ``st`` against the data-quality criteria and
        combine into an overall flag.

        Criteria kwargs: allow_gaps, full_timespan (default True),
        check_sampling_rate + sampling_rate, check_start_end_times,
        all_channels + n_channels. Returns ``(available, {tr_id: 0/1})``.

        """

        per_channel = {}
        for tr_id in sorted({tr.id for tr in st}):
            ok = self._channel_passes(st.select(id=tr_id), criteria)
            per_channel[tr_id] = int(ok)

        flags = list(per_channel.values())
        available = 0
        if flags and min(flags) == 1:
            if criteria.get("all_channels", False):
                n_channels = criteria.get("n_channels")
                if not n_channels:
                    raise TypeError(
                        "Please specify n_channels if you wish to check "
                        "all channels meet the availability criteria."
                    )
                if len(per_channel) == n_channels:
                    available = 1
            else:
                available = 1
        elif flags and max(flags) == 1 and not criteria.get("all_channels", False):
            available = 1

        return available, per_channel

    def _channel_passes(self, channel, criteria):
        """True if one channel's traces satisfy every active criterion."""

        # Flatlined segments are never usable.
        if any(len(tr.data) and tr.data.max() == tr.data.min() for tr in channel):
            return False

        # Overlaps always disqualify; gaps only when not allowed. One
        # get_gaps() pass serves both checks (delta is row[6]; negative
        # marks an overlap).
        gap_rows = channel.get_gaps()
        if any(row[6] <= -0.000001 for row in gap_rows):
            return False
        if not criteria.get("allow_gaps", False) and gap_rows:
            return False

        if criteria.get("check_sampling_rate", False):
            rate = criteria.get("sampling_rate")
            if not rate:
                raise TypeError(
                    "Please specify sampling_rate if you wish to "
                    "check all channels are at the correct sampling "
                    "rate."
                )
            if any(tr.stats.sampling_rate != rate for tr in channel):
                return False

        if criteria.get("full_timespan", True):
            if len(channel) > 1:
                return False
            span_samples = (
                round((self.endtime - self.starttime)
                      * channel[0].stats.sampling_rate) + 1
            )
            if channel[0].stats.npts < span_samples:
                logging.debug("Trace has too few samples.")
                return False

        if criteria.get("check_start_end_times", False):
            if len(channel) > 1:
                return False
            stats = channel[0].stats
            if stats.starttime != self.starttime or stats.endtime != self.endtime:
                return False

        return True

    # -- response removal ----------------------------------------------------

    def get_real_waveform(self, tr, velocity=True):
        """Deconvolve the instrument response from a trace (VEL or DISP)."""

        if not self.response_inv:
            raise AttributeError("No response inventory provided!")

        tr = tr.copy()
        tr.detrend("linear")

        try:
            response = self.response_inv.get_response(tr.id, tr.stats.starttime)
        except (util.ResponseNotFoundError, KeyError, ValueError) as err:
            raise util.ResponseNotFoundError(str(err), tr.id)

        try:
            paz = paz_for_output(response, "VEL" if velocity else "DISP")
            tr.simulate(
                paz_remove=paz,
                pre_filt=self.pre_filt,
                water_level=self.water_level,
                taper=True,
                stages_remove=(
                    response.digital_stages if self.remove_full_response else None
                ),
            )
        except ValueError as err:
            raise util.ResponseRemovalError(err, tr.id)

        self.real_waveforms = self._stash(self.real_waveforms, tr)
        return tr

    def get_wa_waveform(self, tr, velocity=False):
        """Simulate the Wood-Anderson record of a trace (displacement)."""

        tr = self.get_real_waveform(tr.copy(), velocity)
        tr.data = simulate_seismometer(
            tr.data,
            tr.stats.sampling_rate,
            paz_simulate=util.wa_response(obspy_def=True),
            # pre_filt applies in both the deconvolution and this WA step
            pre_filt=self.pre_filt,
            water_level=self.water_level,
            taper=True,
        )
        self.wa_waveforms = self._stash(self.wa_waveforms, tr)
        return tr

    @staticmethod
    def _stash(store, tr):
        """Append a copy of ``tr`` to a lazily created Stream."""

        if store is None:
            store = Stream()
        store.append(tr.copy())
        return store
