# -*- coding: utf-8 -*-
"""
Small pure helpers shared by the port's modules: time and sample
arithmetic, the resampling chain of the pre-processing, the per-channel
merge, the numeric helpers of trigger, picking and location, the
Wood-Anderson response of local magnitudes, the timing decorator, the
figure helpers that need no plotting library, and the exceptions that
detect, trigger, locate and the FDSN client raise or catch. Copied from
the JAX package's ``util.py`` (which the port does not import).

"""

import logging
import sys
from datetime import datetime, timedelta, timezone
from functools import wraps
from itertools import tee
from time import perf_counter

import numpy as np

log_spacer = "=" * 110


class AttribDict(dict):
    """Dictionary whose keys double as attributes (``d.x`` == ``d["x"]``)."""

    def __getattr__(self, key):
        if key in self:
            return self[key]
        raise AttributeError(key)

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        if key not in self:
            raise AttributeError(key)
        del self[key]

    def copy(self):
        return AttribDict(self)


def renamed_notice(old, new):
    """The reference's notice for a parameter it renamed."""

    return ("FutureWarning: Parameter name has changed - continuing.\n"
            "To remove this message, change:\n"
            f"\t'{old}' -> '{new}'")


def legacy_parameter(new, notice, assign=True):
    """
    Accept-and-warn property for a parameter name the reference retired:
    reading it reads ``new``; setting it prints ``notice`` (a string, or a
    function of the instance that gives one) and, where ``assign``, sets
    ``new``. None is ignored, so constructors may pass every keyword on.

    """

    def read(self):
        return getattr(self, new)

    def write(self, value):
        if value is None:
            return
        print(notice(self) if callable(notice) else notice)
        if assign:
            setattr(self, new, value)

    return property(read, write)


def make_directories(run, subdir=None):
    """Create the run directory tree (and optional subdirectory) on disk."""

    target = run / subdir if subdir else run
    target.mkdir(exist_ok=True, parents=True)


def time2sample(time, sampling_rate):
    """Seconds -> nearest whole sample count at ``sampling_rate``."""

    return int(round(time * int(sampling_rate)))


def trim2sample(time, sampling_rate):
    """
    Shortest duration >= ``time`` that is both a whole number of samples at
    ``sampling_rate`` and a whole number of milliseconds.

    """

    whole_samples = np.ceil(time * sampling_rate) / sampling_rate
    return int(whole_samples * 1000) / 1000


def round_up(x, m):
    """Smallest multiple of ``m`` that is >= ``x``."""

    return -(-x // m) * m


def pairwise(iterable):
    """Yield consecutive overlapping pairs: s -> (s0,s1), (s1,s2), ..."""

    left, right = tee(iterable)
    next(right, None)
    return zip(left, right)


def gaussian_1d(x, a, b, c):
    """Evaluate ``a * exp(-(x-b)^2 / (2 c^2))`` — used by the pick fitter."""

    z = (x - b) / c
    return a * np.exp(-0.5 * z * z)


def gaussian_profiles(shape, sgm):
    """Per-axis centred Gaussian profiles for a separable kernel on a
    grid of ``shape``, with per-axis (or scalar) sigma."""

    sigmas = np.broadcast_to(
        np.asarray(sgm, dtype=float), (len(shape),)
    )
    profiles = []
    for n, s in zip(shape, sigmas):
        ax = np.linspace(-(n - 1) / 2, (n - 1) / 2, n)
        profiles.append(np.exp(-(ax * ax) / (2.0 * s * s)))
    return profiles


def gaussian_3d(nx, ny, nz, sgm):
    """
    Separable 3-D Gaussian kernel on an ``(nx, ny, nz)`` grid, centred, with
    per-axis (or scalar) sigma: the smoothing kernel for marginalised
    coalescence maps.

    """

    gx, gy, gz = gaussian_profiles((nx, ny, nz), sgm)
    return gx[:, None, None] * gy[None, :, None] * gz[None, None, :]


def calculate_mad(x, scale=1.4826):
    """
    Median absolute deviation of ``x`` scaled so that, for normal data, it
    estimates the standard deviation (scale = 1.4826). NaN-contaminated or
    empty input yields NaN.

    """

    x = np.asarray(x)
    if x.size == 0 or np.isnan(x.astype(float).sum()):
        return np.nan
    centred = np.abs(x - np.median(x, axis=0, keepdims=True))
    return scale * np.median(centred, axis=0)


def timeit(*decorator_args, **_ignored):
    """
    Decorator factory that reports a function's wall-clock duration. Pass
    ``"info"`` to log at info level; the default logs at debug level.

    """

    emit = logging.info if "info" in decorator_args else logging.debug

    def decorate(func):
        @wraps(func)
        def timed(*args, **kwargs):
            tick = perf_counter()
            result = func(*args, **kwargs)
            emit(" " * 21 + f"Elapsed time: {perf_counter() - tick:6f} "
                 "seconds.")
            return result

        return timed

    return decorate


def logger(logstem, log, loglevel="info"):
    """
    (Re)configure root logging: message-only records to stdout, plus a
    timestamped ``.log`` file beside ``logstem`` when ``log`` is truthy.

    """

    sinks = [logging.StreamHandler(sys.stdout)]
    if log:
        logstem.parent.mkdir(exist_ok=True, parents=True)
        stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        sinks.insert(0, logging.FileHandler(f"{logstem}_{stamp}.log"))

    logging.basicConfig(
        level=logging.DEBUG if loglevel == "debug" else logging.INFO,
        format="%(message)s",
        handlers=sinks,
        force=True,
    )


# --- instrument responses ----------------------------------------------------

# Wood-Anderson torsion seismograph PAZ. Two conventions exist in the
# literature for the pole positions; the "obspy" one is the standard set.
_WOODANDERSON_POLES = {
    True: [-6.283185 - 4.712j, -6.283185 + 4.712j],
    False: [-5.49779 + 5.60886j, -5.49779 - 5.60886j],
}


def wa_response(convert="DIS2DIS", obspy_def=True):
    """
    Wood-Anderson response as a poles-and-zeros dict. ``convert`` selects the
    number of zeros so that applying the response maps correctly between the
    displacement/velocity domains (same-domain conversions need the extra
    zero at the origin).

    """

    n_zeros = 2 if convert in ("DIS2DIS", "VEL2VEL") else 1
    return {
        "poles": list(_WOODANDERSON_POLES[obspy_def]),
        "zeros": [0j] * n_zeros,
        "sensitivity": 2080,
        "gain": 1.0,
    }


# --- the resampling chain ----------------------------------------------------


def _subsample_offset(trace):
    """Seconds to add to snap ``trace``'s start onto the sample grid."""

    rate = trace.stats.sampling_rate
    micros_per_sample = 1e6 / rate
    remainder = trace.stats.starttime.microsecond % micros_per_sample
    if remainder == 0:
        return None
    return round(remainder / 1e6 * rate) / rate - remainder / 1e6


def shift_to_sample(stream, interpolate=False):
    """
    Snap every trace onto the "on-sample" time grid (start an integer number
    of samples after midnight). ``interpolate=False`` just nudges the
    metadata; ``interpolate=True`` resamples the data onto the corrected grid
    with a Lanczos kernel, preserving the sample count.

    """

    stream = stream.copy()
    for trace in stream:
        nudge = _subsample_offset(trace)
        if nudge is None:
            if trace.stats.sampling_rate < 1.0:
                logging.warning(
                    f"Trace\n\t{trace}\nhas a sampling rate less than 1 Hz, so "
                    "off-sample data might not be corrected!"
                )
            continue

        verb = "Interpolating to apply a" if interpolate else "Applying"
        logging.info(
            f"Trace\n\t{trace}\nhas off-sample data. {verb} {nudge:+f} s "
            "shift to timing."
        )
        if not interpolate:
            trace.stats.starttime = trace.stats.starttime + nudge
            continue

        # Resample onto the snapped grid. A negative nudge would put the
        # first grid point before the data, so interpolate from the next
        # sample instead, then restore the length with an edge replicate.
        grid_start = trace.stats.starttime + nudge
        if nudge < 0.0:
            grid_start = grid_start + trace.stats.delta
        trace.interpolate(
            sampling_rate=trace.stats.sampling_rate,
            method="lanczos",
            a=20,
            starttime=grid_start,
        )
        if nudge > 0.0:
            trace.data = np.append(trace.data, trace.data[-1])
        else:
            trace.data = np.insert(trace.data, 0, trace.data[0])
            trace.stats.starttime = trace.stats.starttime - trace.stats.delta

    return stream


def decimate(trace, sampling_rate):
    """
    Reduce a trace to ``sampling_rate`` by integer decimation, preceded by
    linear+mean detrend, a 5% cosine taper, and a zero-phase 2-corner
    Butterworth anti-alias lowpass placed fractionally below the new Nyquist.

    """

    out = trace.copy()
    out.detrend("linear")
    out.detrend("demean")
    out.taper(type="cosine", max_percentage=0.05)
    out.filter(
        "lowpass", freq=float(sampling_rate) / 2.000001, corners=2,
        zerophase=True,
    )
    out.decimate(factor=int(out.stats.sampling_rate / sampling_rate),
                 no_filter=True)
    return out


def upsample(trace, upfactor, starttime, endtime):
    """
    Linearly interpolate a trace by an integer factor (original samples are
    preserved as fenceposts). If the trace starts late / ends early relative
    to the requested window by less than one *original* sample interval, the
    gap is filled by replicating the edge value so a subsequent decimate sees
    a full window.

    """

    data = np.asarray(trace.data, dtype=float)
    fine_rate = trace.stats.sampling_rate * upfactor
    coarse_idx = np.arange(data.size, dtype=float)
    fine_idx = np.arange((data.size - 1) * upfactor + 1, dtype=float) / upfactor
    fine = np.interp(fine_idx, coarse_idx, data)

    fine_start = trace.stats.starttime
    lead = trace.stats.starttime - starttime
    if 0.0 < lead < trace.stats.delta:
        n_lead = int(np.round(lead * fine_rate))
        fine = np.concatenate([np.full(n_lead, data[0]), fine])
        fine_start = trace.stats.starttime - n_lead / fine_rate

    lag = endtime - trace.stats.endtime
    if 0.0 < lag < trace.stats.delta:
        n_lag = int(np.round(lag * fine_rate))
        fine = np.concatenate([fine, np.full(n_lag, data[-1])])

    out = trace.copy()
    out.data = fine
    out.stats.sampling_rate = int(fine_rate)
    out.stats.starttime = fine_start
    out.trim(
        starttime=starttime - 0.00001, endtime=endtime + 0.00001,
        nearest_sample=False,
    )
    return out


def resample(stream, sampling_rate, resample, upfactor, starttime, endtime):
    """
    Bring every trace in ``stream`` to ``sampling_rate``. Rates that divide
    evenly are decimated directly; with ``resample=True`` and an integer
    ``upfactor``, incompatible rates go through upsample-then-decimate.
    Traces that cannot be conformed are left at their native rate (logged):
    the downstream availability check rejects them.

    """

    conformed = type(stream)()
    for trace in stream:
        native = trace.stats.sampling_rate
        if native == sampling_rate:
            conformed += trace.copy()
        elif native % sampling_rate == 0:
            conformed += decimate(trace, sampling_rate)
        elif resample and upfactor is not None:
            if int(native * upfactor) % sampling_rate != 0:
                raise BadUpfactorException(trace)
            fine = upsample(trace, upfactor, starttime, endtime)
            # Always decimate after upsampling, even when the upsampled
            # rate already equals the target (factor 1): decimate is
            # where the detrend / taper / zero-phase lowpass conditioning
            # happens
            conformed += decimate(fine, sampling_rate)
        else:
            logging.info(
                "Mismatched sampling rates - cannot decimate data from\n\t"
                f"{trace}\n...to resample data, set resample = True and "
                "choose a suitable upfactor"
            )
            conformed += trace.copy()

    conformed.trim(
        starttime=starttime - 0.00001, endtime=endtime + 0.00001,
        nearest_sample=False,
    )
    return conformed


def merge_stream(stream):
    """
    Merge contiguous / identically-overlapping segments channel by channel
    (no-clobber). A channel whose segments genuinely conflict is dropped with
    a log line rather than failing the whole stream.

    """

    merged = type(stream)()
    for seed_id in sorted({trace.id for trace in stream}):
        channel = stream.select(id=seed_id)
        try:
            merged += channel.copy().merge(method=-1)
        except MergeError as err:
            logging.info(f"\t\t{err}")
            logging.info(f"\t\t{channel}")
            logging.info("\t\tThis channel will not be used for onset "
                         "calculation.")
    return merged


# --- figure helpers -----------------------------------------------------------

# matplotlib's date numbers count days from this epoch (since its 3.3)
_DATE_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)


class DateFormatter:
    """
    Tick formatter producing sub-second datetime labels from matplotlib
    date numbers (days since 1970-01-01 UTC). The format string marks the
    fractional-seconds field as ``{ms}``, e.g.
    ``DateFormatter("%H:%M:%S.{ms}", precision=2)``. A plain callable: it
    converts the date number itself, as ``matplotlib.dates.num2date``
    does, so no plotting library is needed.

    """

    def __init__(self, fmt, precision=3):
        self.fmt = fmt
        self.precision = precision

    def __call__(self, x, pos=0):
        when = _DATE_EPOCH + timedelta(
            microseconds=int(np.round(x * 86400e6)))
        if abs(x) > 70 * 365:
            # num2date's fix of the float's round-off on large date
            # numbers: the nearest 20 microseconds
            ms = round(when.microsecond / 20) * 20
            when = (when.replace(microsecond=0) + timedelta(seconds=1)
                    if ms == 1000000 else when.replace(microsecond=ms))
        fractional = f"{when.microsecond:06d}"[: self.precision]
        return when.strftime(self.fmt).format(ms=fractional)


def date2num(values):
    """
    matplotlib date numbers (days since 1970-01-01 UTC, float64) of an
    array of datetime64 values, with ``matplotlib.dates.date2num``'s
    arithmetic (whole seconds, then the rest in nanoseconds), so the two
    agree bit for bit; NaT gives NaN.

    """

    d = np.asarray(values)
    seconds = d.astype("datetime64[s]")
    extra = (d - seconds).astype("timedelta64[ns]")
    days = (seconds - np.datetime64("1970-01-01T00:00:00", "s")).astype(
        np.float64)
    days += extra.astype(np.float64) / 1.0e9
    days = days / 86400.0
    days[d.astype(np.int64) == np.datetime64("NaT").astype(np.int64)] = np.nan
    return days


def get_phase_component_strings(channel_maps):
    """
    Component-selector strings for the pick-summary figure from the
    per-phase channel maps. P components share one panel; S components are
    split over (up to) two panels, pairing alphabetic with numeric codes
    (e.g. N with 1, E with 2) when both conventions appear.

    """

    def components(phase):
        # "*[N,E]" -> "N,E" -> every other char skips the commas.
        bare = channel_maps[phase].strip("*").strip("[").strip("]")
        return list(bare)[::2]

    def bracketed(codes):
        return "[" + ",".join(codes) + "]"

    p_codes = components("P")
    s_codes = components("S")
    letters = [c for c in s_codes if not c.isnumeric()]
    digits = [c for c in s_codes if c.isnumeric()]

    panel_1, panel_2 = [], []
    if letters and digits:
        if max(len(letters), len(digits)) > 2:
            logging.info(
                "More than two pairs of S-phase components found in channel "
                "maps. Only using first two for plotting!"
            )
        pairs = list(zip(letters, digits))
        if pairs:
            panel_1 = list(pairs[0])
        if len(pairs) > 1:
            panel_2 = list(pairs[1])
    else:
        for group in (letters, digits):
            if group:
                panel_1.append(group[0])
                if len(group) > 1:
                    panel_2.append(group[1])
            if len(group) > 2:
                logging.info(
                    "More than two alphabetical or numeric S-phase components"
                    " found in channel maps. Only using first two for "
                    "plotting!"
                )

    return bracketed(p_codes), bracketed(panel_1), bracketed(panel_2)


# --- the exceptions of detect, trigger and locate ----------------------------
#
# Detect windows that raise the archive, gap or availability errors become
# zero-filled .scanmseed steps; locate skips the event. ``msg``, where
# present, is the indented variant used in the progress log.


class QMError(Exception):
    """Base class: ``detail`` is a class-level template filled from args."""

    detail = ""

    def __init__(self, *args):
        super().__init__(self.detail.format(*args) if self.detail else
                         (args[0] if args else ""))


class MergeError(QMError):
    detail = "{0}"

    def __init__(self, reason="Traces could not be merged without clobbering."):
        super().__init__(reason)


class StationFileHeaderException(QMError):
    detail = ("Incorrect station file header - use:\n"
              "Latitude, Longitude, Elevation, Name")

    def __init__(self):
        super().__init__()


class InvalidVelocityModelHeader(QMError):
    detail = "Must include at least '{0}' in header."


class NoStationAvailabilityDataException(QMError):
    detail = "No .StationAvailability files found."

    def __init__(self):
        super().__init__()


class ArchiveFormatException(QMError):
    detail = (
        "Archive format has not been set. Set when making the Archive "
        "object with the kwarg 'archive_format=<path_structure>', or "
        "afterwards with the command "
        "'Archive.path_structure(<path_structure>)'."
    )

    def __init__(self):
        super().__init__()


class ArchivePathStructureError(QMError):
    detail = (
        "The archive path structure you have selected: '{0}' "
        "is not a valid option! See the documentation for "
        "'Archive.path_structure' for a complete list, or specify a custom "
        "format."
    )


class ArchiveEmptyException(QMError):
    detail = "No data was available for this timestep."
    msg = "\t\tNo files found in archive for this time period."

    def __init__(self):
        super().__init__()


class DataAvailabilityException(QMError):
    detail = (
        "All data for this timestep did not pass the specified data "
        "quality criteria."
    )
    msg = (
        "\t\tAll data for this timestep failed to pass the"
        "\n\t\tspecified data quality criteria. This includes the"
        "\n\t\tpresence of gaps or overlaps, or the data not"
        "\n\t\tspanning the full time window."
    )

    def __init__(self):
        super().__init__()


class DataGapException(QMError):
    detail = (
        "No data present in the archive for the selected stations for "
        "this time window."
    )
    msg = (
        "\t\tNo data for the selected stations was found in the"
        "\n\t\tarchive for this time window."
    )

    def __init__(self):
        super().__init__()


class BadUpfactorException(QMError):
    detail = (
        "Chosen upfactor cannot be decimated to\ntarget sampling rate."
        "\n    Working on trace: {0}"
    )


class OnsetTypeError(QMError):
    detail = (
        "The Onset object you have created does not inherit from the "
        "required base class - see manual."
    )

    def __init__(self):
        super().__init__()


class LUTPhasesException(QMError):
    detail = "{0}"


class PickOrderException(QMError):
    detail = (
        "The P-phase arrival-time pick is later than the S-phase arrival "
        "pick! Something has gone wrong.\nEvent: {0}, station: "
        "{1}, p_pick: {2}, s_pick: {3}."
    )


class MagsTypeError(QMError):
    detail = (
        "The Mags object you have specified is not supported: currently "
        "only `quakemigrate_torch.signal.local_mag.LocalMag` - see manual."
    )

    def __init__(self):
        super().__init__()


class ResponseNotFoundError(QMError):
    detail = "{0} -- skipping {1}"


class ResponseRemovalError(QMError):
    detail = "{0} -- skipping {1}"


class PeakToTroughError(QMError):
    detail = "{0}"

    def __init__(self, err):
        super().__init__(err)
        self.msg = err


class NyquistException(QMError):
    detail = (
        "    Selected bandpass_highcut {0} Hz is at or above the "
        "Nyquist frequency ({1} Hz) for trace {2}. "
    )


class TimeSpanException(QMError):
    detail = "The start time specified is after the end time."

    def __init__(self):
        super().__init__()


class ArchiveFDSNException(QMError):
    """Raised when an FDSN web-service request fails (HTTP or transport
    error; "no matching data" responses return empty results instead)."""

    def __init__(self, msg):
        super().__init__(msg)


class ChannelNameException(QMError):
    detail = (
        "Channel name header does not conform to\nthe IRIS SEED standard "
        "- 3 characters; ending in 'Z' for\nvertical and ending either "
        "'E' & 'N' or '1' & '2' for\nhorizontal components.\n"
        "    Working on trace: {0}"
    )


class NoScanMseedDataException(QMError):
    detail = "No .scanmseed data found."

    def __init__(self):
        super().__init__()


class NoOnsetPeak(QMError):
    detail = (
        "\t\t    No onset signal exceeding pick threshold "
        "({0:5.3f}) - continuing."
    )

    def __init__(self, pick_threshold):
        super().__init__(pick_threshold)
        self.msg = str(self)


class PickerTypeError(QMError):
    detail = (
        "The PhasePicker object you have created does not inherit from "
        "the required base class - see manual."
    )

    def __init__(self):
        super().__init__()


class NoTriggerFilesFound(QMError):
    detail = (
        "Double check you have supplied a valid run name and a time "
        "period for which you have run detect."
    )

    def __init__(self):
        super().__init__()


class InvalidTriggerThresholdMethodException(QMError):
    detail = "Only 'static', 'mad' or 'median_ratio' thresholds are supported."

    def __init__(self):
        super().__init__()


class InvalidPickThresholdMethodException(QMError):
    detail = "Only 'percentile' or 'MAD' thresholds are supported."

    def __init__(self):
        super().__init__()
