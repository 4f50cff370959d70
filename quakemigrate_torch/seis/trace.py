# -*- coding: utf-8 -*-
"""
Lightweight seismic waveform data model: Stats, Trace and Stream, a copy
of the JAX package's ``seis/trace.py`` with the methods the detect path,
the miniSEED writer, the synthetics and local magnitudes call: no-clobber
merging, on-sample trimming with nearest-sample semantics, zero-phase
Butterworth filtering, cosine tapering, decimation/interpolation/
resampling, component rotation, differentiation and integration, and
instrument response removal and simulation (``seis.response``).

All time-series processing is host-side numpy/scipy; the per-sample
compute of detect (onsets, migration) runs in PyTorch on the device.

"""

from __future__ import annotations

import fnmatch
from copy import deepcopy
from functools import lru_cache

import numpy as np
from scipy.signal import iirfilter, sosfilt

from .utcdatetime import UTCDateTime


@lru_cache(maxsize=128)
def _design_sos(corners, wn, btype):
    """Cached Butterworth SOS design (wn is a float or tuple of floats)."""

    return iirfilter(corners, wn, btype=btype, ftype="butter", output="sos")


class Stats:
    """Container for trace metadata with attribute access."""

    _defaults = {
        "network": "",
        "station": "",
        "location": "",
        "channel": "",
        "sampling_rate": 1.0,
        "calib": 1.0,
    }

    def __init__(self, header=None):
        self.__dict__["_data"] = dict(self._defaults)
        self._data["starttime"] = UTCDateTime(0)
        self._data["npts"] = 0
        if header:
            for key, value in dict(header).items():
                setattr(self, key, value)

    def __getattr__(self, name):
        data = self.__dict__["_data"]
        if name == "endtime":
            if data["npts"] == 0:
                return data["starttime"]
            return data["starttime"] + (data["npts"] - 1) / data["sampling_rate"]
        if name == "delta":
            return 1.0 / data["sampling_rate"]
        if name == "component":
            return data["channel"][-1:] if data["channel"] else ""
        try:
            return data[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        data = self.__dict__["_data"]
        if name == "starttime":
            value = UTCDateTime(value)
        elif name == "sampling_rate":
            value = float(value)
        elif name == "delta":
            data["sampling_rate"] = 1.0 / float(value)
            return
        elif name == "npts":
            value = int(value)
        data[name] = value

    def __getitem__(self, name):
        return getattr(self, name)

    def __setitem__(self, name, value):
        setattr(self, name, value)

    def __contains__(self, name):
        return name in self.__dict__["_data"]

    def get(self, name, default=None):
        try:
            return getattr(self, name)
        except AttributeError:
            return default

    def keys(self):
        return self.__dict__["_data"].keys()

    def copy(self):
        new = Stats()
        new.__dict__["_data"] = deepcopy(self.__dict__["_data"])
        return new

    def __repr__(self):
        parts = [f"{k}: {v}" for k, v in self.__dict__["_data"].items()]
        return "Stats({})".format(", ".join(parts))


def _cosine_taper(npts, p):
    """
    Symmetric cosine (Hann-ramp) taper over the first/last ``p/2`` fraction
    of an ``npts``-long window.

    """

    frac = int(npts * p / 2.0 + 0.5)
    win = np.ones(npts)
    if frac > 1:
        idx = np.arange(frac)
        ramp = 0.5 * (1.0 - np.cos(np.pi * idx / (frac - 1)))
        win[:frac] = ramp
        win[npts - frac :] = ramp[::-1]
    elif frac == 1:
        win[0] = 0.0
        win[-1] = 0.0
    return win


class Trace:
    """A single continuous waveform segment plus its metadata."""

    def __init__(self, data=None, header=None):
        # Copy a passed Stats (as ObsPy deepcopies the header): adopting
        # it by reference would let two traces built from one template
        # corrupt each other's npts/endtime
        self.stats = header.copy() if isinstance(header, Stats) else Stats(header)
        self.data = np.array([]) if data is None else np.asarray(data)

    # --- basic protocol ---

    @property
    def data(self):
        return self._data

    @data.setter
    def data(self, value):
        self._data = np.asarray(value)
        self.stats.npts = len(self._data)

    @property
    def id(self):
        s = self.stats
        return f"{s.network}.{s.station}.{s.location}.{s.channel}"

    def __len__(self):
        return len(self._data)

    def __bool__(self):
        return len(self._data) > 0

    def __str__(self):
        s = self.stats
        return (
            f"{self.id} | {s.starttime} - {s.endtime} | "
            f"{s.sampling_rate:.1f} Hz, {s.npts} samples"
        )

    __repr__ = __str__

    def copy(self):
        new = Trace()
        new.stats = self.stats.copy()
        new.data = self._data.copy()
        return new

    def times(self, type="relative"):
        """Sample times: relative seconds, UTCDateTime, timestamp or mpl."""

        offsets = np.arange(self.stats.npts) * self.stats.delta
        if type == "relative":
            return offsets
        if type == "timestamp":
            return self.stats.starttime.timestamp + offsets
        if type == "utcdatetime":
            start = self.stats.starttime
            return np.array([start + o for o in offsets], dtype=object)
        if type == "matplotlib":
            return self.stats.starttime.matplotlib_date + offsets / 86400.0
        raise ValueError(f"Unknown times type: {type}")

    def max(self):
        if not len(self._data):
            return 0.0
        return self._data[np.argmax(np.abs(self._data))]

    # --- windowing ---

    def slice(self, starttime=None, endtime=None, nearest_sample=True):
        """Return a new Trace cut to the given window (data is copied)."""

        tr = self.copy()
        tr.trim(starttime=starttime, endtime=endtime, nearest_sample=nearest_sample)
        return tr

    def trim(
        self,
        starttime=None,
        endtime=None,
        pad=False,
        fill_value=None,
        nearest_sample=True,
    ):
        """
        Cut the trace to the given window in place. With ``pad=True``, extend
        with ``fill_value`` to exactly cover the window.

        With ``nearest_sample=True`` the window bounds snap to the nearest
        sample of the trace's time grid; otherwise only samples strictly
        inside the window are kept.

        """

        sr = self.stats.sampling_rate
        t0 = self.stats.starttime

        if starttime is not None:
            starttime = UTCDateTime(starttime)
            offset = (starttime - t0) * sr
            i0 = int(round(offset)) if nearest_sample else int(np.ceil(offset - 1e-9))
        else:
            i0 = 0
        if endtime is not None:
            endtime = UTCDateTime(endtime)
            offset = (endtime - t0) * sr
            i1 = int(round(offset)) if nearest_sample else int(np.floor(offset + 1e-9))
        else:
            i1 = self.stats.npts - 1

        if i1 < i0:
            self.data = self._data[:0]
            if starttime is not None:
                self.stats.starttime = starttime
            return self

        lo, hi = max(i0, 0), min(i1, self.stats.npts - 1)
        if hi < lo:
            # Window lies entirely before/after the data: empty result
            # (or all-fill with pad=True) -- a negative `hi` must never
            # reach the slice, where it would keep out-of-window data
            if pad:
                fv = 0 if fill_value is None else fill_value
                self.data = np.full(
                    i1 - i0 + 1, fv,
                    dtype=self._data.dtype if self._data.size else float,
                )
                self.stats.starttime = t0 + i0 / sr
            else:
                self.data = self._data[:0]
                if starttime is not None:
                    self.stats.starttime = starttime
            return self
        data = self._data[lo : hi + 1]
        new_start = t0 + lo / sr

        if pad and (i0 < 0 or i1 > self.stats.npts - 1):
            fv = 0 if fill_value is None else fill_value
            pre = max(0, -i0)
            post = max(0, i1 - (self.stats.npts - 1))
            data = np.concatenate(
                [
                    np.full(pre, fv, dtype=data.dtype if data.size else float),
                    data,
                    np.full(post, fv, dtype=data.dtype if data.size else float),
                ]
            )
            new_start = t0 + i0 / sr

        self.data = data
        self.stats.starttime = new_start
        return self

    # --- processing ---

    def detrend(self, type="linear"):
        data = np.asarray(self._data, dtype=np.float64)
        if type in ("constant", "demean"):
            self.data = data - data.mean() if data.size else data
        elif type == "linear":
            if data.size > 1:
                # Closed-form least-squares line (for equally spaced x,
                # slope = cov(x, y) / var(x)): identical fit to
                # np.polyfit(x, data, 1) but O(n) with two dot products
                # instead of an lstsq -- detrend is the hottest step of
                # the per-window preprocessing.
                n = data.size
                x = np.arange(n, dtype=np.float64)
                x_mean = (n - 1) / 2.0
                y_mean = data.mean()
                x_var = (n * n - 1) / 12.0  # var of 0..n-1
                slope = (np.dot(x, data) / n - x_mean * y_mean) / x_var
                self.data = data - (y_mean + slope * (x - x_mean))
            else:
                self.data = data
        elif type == "simple":
            if data.size > 1:
                x = np.arange(data.size)
                slope = (data[-1] - data[0]) / (data.size - 1)
                self.data = data - (data[0] + slope * x)
            else:
                self.data = data
        else:
            raise ValueError(f"Unknown detrend type: {type}")
        return self

    def taper(self, max_percentage=0.05, type="cosine", max_length=None, side="both"):
        npts = self.stats.npts
        if npts == 0:
            return self
        wlen = int(npts * max_percentage) if max_percentage is not None else npts // 2
        if max_length is not None:
            wlen = min(wlen, int(max_length * self.stats.sampling_rate))
        wlen = min(wlen, (npts - 1) // 2)
        if wlen <= 0:
            return self

        if type in ("cosine", "hann"):
            sides = _cosine_taper(2 * wlen + 1, p=1.0)
        else:
            raise ValueError(f"Unsupported taper type: {type}")

        taper = np.ones(npts)
        if side in ("both", "left"):
            taper[:wlen] = sides[:wlen]
        if side in ("both", "right"):
            taper[npts - wlen :] = sides[len(sides) - wlen :]

        self.data = np.asarray(self._data, dtype=np.float64) * taper
        return self

    def filter(self, type, **options):
        """
        Butterworth filtering: "bandpass" (freqmin/freqmax), "lowpass" or
        "highpass" (freq), with ``corners`` poles. ``zerophase=True`` runs
        the filter forwards then backwards (squaring the magnitude response
        and cancelling the phase).

        """

        sr = self.stats.sampling_rate
        nyq = 0.5 * sr
        corners = options.get("corners", 4)
        zerophase = options.get("zerophase", False)

        if type == "bandpass":
            freqmin, freqmax = options["freqmin"], options["freqmax"]
            if freqmax >= nyq:
                # ObsPy warns and degrades to a highpass rather than
                # erroring (callers may not know each trace's rate)
                import logging

                logging.warning(
                    f"Selected high corner frequency ({freqmax}) of "
                    f"bandpass is at or above Nyquist ({nyq}). Applying "
                    "a high-pass instead."
                )
                sos = _design_sos(corners, freqmin / nyq, "highpass")
            else:
                sos = _design_sos(
                    corners, (freqmin / nyq, freqmax / nyq), "band"
                )
        elif type == "lowpass":
            freq = options["freq"]
            if freq >= nyq:
                import logging

                logging.warning(
                    f"Selected corner frequency ({freq}) is at or above "
                    f"Nyquist ({nyq}). Setting Nyquist as high corner."
                )
                # scipy requires Wn < 1 strictly
                freq = nyq * (1.0 - 1e-6)
            sos = _design_sos(corners, freq / nyq, "lowpass")
        elif type == "highpass":
            sos = _design_sos(corners, options["freq"] / nyq, "highpass")
        else:
            raise ValueError(f"Unsupported filter type: {type}")

        data = np.asarray(self._data, dtype=np.float64)
        if zerophase:
            firstpass = sosfilt(sos, data)
            self.data = sosfilt(sos, firstpass[::-1])[::-1]
        else:
            self.data = sosfilt(sos, data)
        return self

    def decimate(self, factor, no_filter=False, strict_length=False):
        """Downsample by an integer factor (optionally anti-alias filter)."""

        factor = int(factor)
        if factor == 1:
            return self
        if not no_filter:
            self.filter(
                "lowpass",
                freq=self.stats.sampling_rate * 0.5 / float(factor),
                corners=2,
                zerophase=True,
            )
        self.data = self._data[::factor]
        self.stats.sampling_rate = self.stats.sampling_rate / float(factor)
        return self

    def interpolate(
        self, sampling_rate, method="lanczos", a=20, starttime=None, npts=None
    ):
        """
        Interpolate onto a new time grid. "lanczos" uses a windowed-sinc
        kernel of half-width ``a`` samples; "linear" is also available.

        """

        old_sr = self.stats.sampling_rate
        old_start = self.stats.starttime
        if starttime is None:
            starttime = old_start
        else:
            starttime = UTCDateTime(starttime)
        if npts is None:
            duration = self.stats.endtime - starttime
            npts = int(np.floor(duration * sampling_rate)) + 1

        # New sample positions expressed on the old sample grid
        offset = (starttime - old_start) * old_sr
        positions = offset + np.arange(npts) * (old_sr / sampling_rate)
        if positions[0] < -1e-9 or positions[-1] > self.stats.npts - 1 + 1e-9:
            raise ValueError("Interpolation window extends outside trace.")
        positions = np.clip(positions, 0, self.stats.npts - 1)

        data = np.asarray(self._data, dtype=np.float64)
        if method == "linear":
            new_data = np.interp(positions, np.arange(data.size), data)
        elif method == "lanczos":
            new_data = _lanczos_interpolate(data, positions, a)
        else:
            raise ValueError(f"Unsupported interpolation method: {method}")

        self.data = new_data
        self.stats.starttime = starttime
        self.stats.sampling_rate = sampling_rate
        return self

    def resample(self, sampling_rate):
        """Fourier-domain resampling to an arbitrary new rate."""

        from scipy.signal import resample as _sp_resample

        factor = self.stats.sampling_rate / float(sampling_rate)
        npts_new = int(self.stats.npts / factor)
        # Hann window applied to the spectrum, as ObsPy's resample does
        # by default (plain Fourier resampling leaves un-tapered energy
        # at Nyquist and different edge ringing)
        self.data = _sp_resample(
            np.asarray(self._data, dtype=np.float64), npts_new, window="hann"
        )
        self.stats.sampling_rate = float(sampling_rate)
        return self

    def differentiate(self):
        self.data = np.gradient(
            np.asarray(self._data, dtype=np.float64), self.stats.delta
        )
        return self

    def integrate(self):
        from scipy.integrate import cumulative_trapezoid

        self.data = cumulative_trapezoid(
            np.asarray(self._data, dtype=np.float64), dx=self.stats.delta, initial=0.0
        )
        return self

    def simulate(self, paz_remove=None, paz_simulate=None, **kwargs):
        """Deconvolve/convolve poles-and-zeros responses (spectral division)."""

        from .response import simulate_seismometer

        self.data = simulate_seismometer(
            np.asarray(self._data, dtype=np.float64),
            self.stats.sampling_rate,
            paz_remove=paz_remove,
            paz_simulate=paz_simulate,
            **kwargs,
        )
        return self

    def remove_response(
        self, inventory, output="VEL", pre_filt=None, water_level=60.0, taper=True
    ):
        """Remove the instrument response recorded in a station inventory."""

        from .response import remove_trace_response

        remove_trace_response(
            self,
            inventory,
            output=output,
            pre_filt=pre_filt,
            water_level=water_level,
            taper=taper,
        )
        return self

    def write(self, filename, format="MSEED", **kwargs):
        Stream([self]).write(filename, format=format, **kwargs)


def _lanczos_interpolate(data, positions, a):
    """
    Windowed-sinc (Lanczos) interpolation of ``data`` at ``positions``.
    Interior samples are computed as one (m, 2a) gather + einsum (a
    per-sample Python loop here would dominate whole-day reads with
    interpolate=True); only the few edge samples fall back to a loop.

    """

    n = data.size
    positions = np.asarray(positions, dtype=np.float64)
    floor = np.floor(positions).astype(int)
    out = np.empty(positions.size)

    interior = (floor - a + 1 >= 0) & (floor + a + 1 <= n)
    if interior.any():
        f0 = floor[interior]
        offsets = np.arange(-a + 1, a + 1)
        idx = f0[:, None] + offsets[None, :]
        x = positions[interior][:, None] - idx
        kernel = np.sinc(x) * np.sinc(x / a)
        out[interior] = (
            np.einsum("ij,ij->i", data[idx], kernel) / kernel.sum(axis=1)
        )

    for j in np.flatnonzero(~interior):
        pos, f0 = positions[j], floor[j]
        i0 = max(0, f0 - a + 1)
        i1 = min(n, f0 + a + 1)
        idx = np.arange(i0, i1)
        x = pos - idx
        kernel = np.sinc(x) * np.sinc(x / a)
        out[j] = np.dot(data[idx], kernel) / np.sum(kernel)
    return out


class Stream:
    """An ordered collection of Traces with bulk operations."""

    def __init__(self, traces=None):
        if traces is None:
            self.traces = []
        elif isinstance(traces, Trace):
            self.traces = [traces]
        else:
            self.traces = list(traces)

    # --- container protocol ---

    def __iter__(self):
        return iter(self.traces)

    def __len__(self):
        return len(self.traces)

    def __bool__(self):
        return any(bool(tr) for tr in self.traces)

    def __getitem__(self, index):
        if isinstance(index, slice):
            return Stream(self.traces[index])
        return self.traces[index]

    def __add__(self, other):
        new = Stream(list(self.traces))
        new += other
        return new

    def __iadd__(self, other):
        if isinstance(other, Trace):
            self.traces.append(other)
        elif isinstance(other, Stream):
            self.traces.extend(other.traces)
        else:
            self.traces.extend(list(other))
        return self

    def __str__(self, extended=False):
        out = f"{len(self.traces)} Trace(s) in Stream:"
        traces = self.traces if (extended or len(self.traces) <= 20) else []
        for tr in traces:
            out += f"\n{tr}"
        if not traces and self.traces:
            out += f"\n{self.traces[0]}\n...\n{self.traces[-1]}"
        return out

    __repr__ = __str__

    def append(self, trace):
        self.traces.append(trace)
        return self

    def extend(self, traces):
        self.traces.extend(traces)
        return self

    def remove(self, trace):
        self.traces.remove(trace)
        return self

    def copy(self):
        return Stream([tr.copy() for tr in self.traces])

    def clear(self):
        self.traces = []
        return self

    # --- selection ---

    def select(
        self,
        network=None,
        station=None,
        location=None,
        channel=None,
        id=None,
        component=None,
        sampling_rate=None,
    ):
        """Select traces by (wildcard-capable) metadata fields."""

        out = []
        for tr in self.traces:
            s = tr.stats
            if id is not None and not fnmatch.fnmatch(tr.id.upper(), id.upper()):
                continue
            if network is not None and not fnmatch.fnmatch(
                s.network.upper(), network.upper()
            ):
                continue
            if station is not None and not fnmatch.fnmatch(
                s.station.upper(), station.upper()
            ):
                continue
            if location is not None and not fnmatch.fnmatch(
                s.location.upper(), location.upper()
            ):
                continue
            if channel is not None and not fnmatch.fnmatch(
                s.channel.upper(), channel.upper()
            ):
                continue
            if component is not None:
                if not s.channel or not fnmatch.fnmatch(
                    s.channel[-1].upper(), component.upper()
                ):
                    continue
            if sampling_rate is not None and s.sampling_rate != sampling_rate:
                continue
            out.append(tr)
        return Stream(out)

    def sort(self, keys=("network", "station", "location", "channel", "starttime")):
        def keyfunc(tr):
            vals = []
            for k in keys:
                v = getattr(tr.stats, k)
                vals.append(v.ns if isinstance(v, UTCDateTime) else v)
            return tuple(vals)

        self.traces.sort(key=keyfunc)
        return self

    # --- gaps and merging ---

    def get_gaps(self, min_gap=None, max_gap=None):
        """
        List gaps/overlaps between consecutive traces on the same channel.
        Returns rows [net, sta, loc, cha, t_end_prev, t_start_next, delta,
        n_samples]; negative delta marks an overlap.

        """

        gaps = []
        copied = Stream(list(self.traces)).sort()
        ids = sorted(set(tr.id for tr in copied))
        for tid in ids:
            traces = [tr for tr in copied if tr.id == tid]
            for tr1, tr2 in zip(traces[:-1], traces[1:]):
                sr = tr1.stats.sampling_rate
                delta = tr2.stats.starttime - tr1.stats.endtime - 1.0 / sr
                if min_gap is not None and delta < min_gap:
                    continue
                if max_gap is not None and delta > max_gap:
                    continue
                if abs(delta) < 0.5 / sr:
                    continue
                nsamples = int(round(abs(delta) * sr))
                s = tr1.stats
                gaps.append(
                    [
                        s.network,
                        s.station,
                        s.location,
                        s.channel,
                        tr1.stats.endtime,
                        tr2.stats.starttime,
                        delta,
                        nsamples,
                    ]
                )
        return gaps

    def merge(self, method=-1, fill_value=None):
        """
        Merge traces with matching SEED id and sampling rate.

        method=-1: "cleanup" merge - join traces that are exactly contiguous
        or whose overlapping samples agree exactly; conflicting overlaps
        raise MergeError.
        method=0/1: join traces, filling gaps with ``fill_value`` (or leaving
        gap samples as fill_value=0 when None); overlaps resolved by taking
        the later trace's samples (method=1) or raising (method=0) when they
        conflict and no fill_value is given.

        """

        from quakemigrate_torch.util import MergeError

        ids = sorted(set(tr.id for tr in self.traces))
        merged = []
        for tid in ids:
            group = sorted(
                [tr for tr in self.traces if tr.id == tid],
                key=lambda tr: tr.stats.starttime.ns,
            )
            srs = set(tr.stats.sampling_rate for tr in group)
            if len(srs) > 1:
                raise MergeError(
                    f"Can't merge traces with differing sampling rates {srs}!"
                )
            dtypes = set(tr.data.dtype for tr in group)
            if method == -1 and len(dtypes) > 1:
                raise MergeError(
                    f"Can't merge traces with differing dtypes {dtypes}!"
                )
            sr = group[0].stats.sampling_rate
            t0 = group[0].stats.starttime
            # Place every trace on a common integer sample grid
            offsets = [int(round((tr.stats.starttime - t0) * sr)) for tr in group]
            total = max(o + tr.stats.npts for o, tr in zip(offsets, group))
            dtype = np.result_type(*[tr.data.dtype for tr in group])
            if method != -1 and fill_value is not None:
                dtype = np.result_type(dtype, np.asarray(fill_value).dtype)
            fv = 0 if fill_value is None else fill_value
            buffer = np.full(total, fv, dtype=dtype)
            have = np.zeros(total, dtype=bool)
            contiguous = True
            for off, tr in zip(offsets, group):
                seg = slice(off, off + tr.stats.npts)
                overlap = have[seg]
                if overlap.any():
                    if method == -1 or (method == 0 and fill_value is None):
                        if not np.array_equal(
                            buffer[seg][overlap], tr.data[overlap]
                        ):
                            raise MergeError(
                                f"Can't merge overlapping traces with "
                                f"conflicting data: {tid}!"
                            )
                buffer[seg] = tr.data
                have[seg] = True
            if not have.all():
                if method == -1 or fill_value is None:
                    # No fill_value: leave separate contiguous segments
                    # rather than fabricating zero samples in the gaps
                    # (ObsPy would return masked arrays here)
                    contiguous = False
                # else: gaps stay filled with fill_value
            if contiguous or (method != -1 and fill_value is not None):
                stats = group[0].stats.copy()
                stats.starttime = t0
                new = Trace(buffer, stats)
                new.data = buffer
                merged.append(new)
            else:
                # Split into contiguous runs
                edges = np.flatnonzero(np.diff(have.astype(int)))
                bounds = np.concatenate([[0], edges + 1, [total]])
                for lo, hi in zip(bounds[:-1], bounds[1:]):
                    if not have[lo]:
                        continue
                    stats = group[0].stats.copy()
                    stats.starttime = t0 + lo / sr
                    merged.append(Trace(buffer[lo:hi].copy(), stats))
        self.traces = merged
        return self

    # --- bulk operations ---

    def trim(
        self,
        starttime=None,
        endtime=None,
        pad=False,
        fill_value=None,
        nearest_sample=True,
    ):
        for tr in list(self.traces):
            tr.trim(
                starttime=starttime,
                endtime=endtime,
                pad=pad,
                fill_value=fill_value,
                nearest_sample=nearest_sample,
            )
            if not bool(tr):
                self.traces.remove(tr)
        return self

    def slice(self, starttime=None, endtime=None, nearest_sample=True):
        out = Stream()
        for tr in self.traces:
            sliced = tr.slice(starttime, endtime, nearest_sample=nearest_sample)
            if bool(sliced):
                out += sliced
        return out

    def detrend(self, type="linear"):
        for tr in self.traces:
            tr.detrend(type)
        return self

    def taper(self, max_percentage=0.05, type="cosine", **kwargs):
        for tr in self.traces:
            tr.taper(max_percentage=max_percentage, type=type, **kwargs)
        return self

    def filter(self, type, **options):
        for tr in self.traces:
            tr.filter(type, **options)
        return self

    def decimate(self, factor, **kwargs):
        for tr in self.traces:
            tr.decimate(factor, **kwargs)
        return self

    def resample(self, sampling_rate):
        for tr in self.traces:
            tr.resample(sampling_rate)
        return self

    def rotate(self, method, back_azimuth=None, inclination=None):
        """
        Rotate three-component station data between coordinate frames.
        Supported: "LQT->ZNE", "ZNE->LQT", "NE->RT", "RT->NE".

        """

        src_comps = {"LQT->ZNE": "LQT", "ZNE->LQT": "ZNE",
                     "NE->RT": "NE", "RT->NE": "RT"}.get(method)
        if src_comps is None:
            raise ValueError(f"Unsupported rotation method: {method}")

        stations = sorted(set(tr.stats.station for tr in self.traces))
        out = Stream()
        for station in stations:
            st = self.select(station=station)
            participating = Stream(
                [tr for tr in st if tr.stats.channel[-1:] in src_comps]
            )
            # Keep non-participating components (e.g. Z for "NE->RT")
            # rather than dropping them, as ObsPy does
            for tr in st:
                if tr.stats.channel[-1:] not in src_comps:
                    out += tr
            out += _rotate_station(
                participating, method, back_azimuth, inclination
            )
        self.traces = out.traces
        return self

    def write(self, filename, format="MSEED", **kwargs):
        """Write the stream as MSEED, SAC (one file a trace), GSE2 or
        SEGY; ``kwargs`` go to the format's writer. Another format raises
        ValueError."""

        if format.upper() == "MSEED":
            from .mseed import write_mseed

            write_mseed(self, filename, **kwargs)
        elif format.upper() == "SAC":
            from .sac import write_sac

            write_sac(self, filename, **kwargs)
        elif format.upper() == "GSE2":
            from .gse2 import write_gse2

            write_gse2(self, filename, **kwargs)
        elif format.upper() == "SEGY":
            from .segy import write_segy

            write_segy(self, filename, **kwargs)
        else:
            raise ValueError(f"Unsupported output format: {format}")
        return self


def _rotate_station(stream, method, back_azimuth, inclination):
    """Rotate one station's three-component data between frames."""

    if back_azimuth is None:
        raise TypeError("Missing required argument: back_azimuth")
    ba = np.deg2rad(back_azimuth)

    if method in ("LQT->ZNE", "ZNE->LQT"):
        if inclination is None:
            raise TypeError("Missing required argument: inclination")
        inc = np.deg2rad(inclination)
        # Rows map (L, Q, T) onto (Z, N, E)
        m = np.array(
            [
                [np.cos(inc), -np.sin(inc), 0.0],
                [-np.sin(inc) * np.cos(ba), -np.cos(inc) * np.cos(ba), np.sin(ba)],
                [-np.sin(inc) * np.sin(ba), -np.cos(inc) * np.sin(ba), -np.cos(ba)],
            ]
        )
        src, dst = ("LQT", "ZNE") if method == "LQT->ZNE" else ("ZNE", "LQT")
        if method == "ZNE->LQT":
            m = m.T
    elif method in ("NE->RT", "RT->NE"):
        m = np.array(
            [
                [-np.cos(ba), -np.sin(ba)],
                [np.sin(ba), -np.cos(ba)],
            ]
        )
        src, dst = ("NE", "RT") if method == "NE->RT" else ("RT", "NE")
        if method == "RT->NE":
            m = m.T
    else:
        raise ValueError(f"Unsupported rotation method: {method}")

    comps = []
    for c in src:
        sel = stream.select(component=c)
        if len(sel) != 1:
            raise ValueError(
                f"Expected exactly one '{c}' component trace, found {len(sel)}"
            )
        comps.append(sel[0])

    # Components must be simultaneous: rotating misaligned samples
    # would silently combine different times (ObsPy errors here too)
    t0s = {tr.stats.starttime.ns for tr in comps}
    srs = {tr.stats.sampling_rate for tr in comps}
    ns = {tr.stats.npts for tr in comps}
    if len(t0s) > 1 or len(srs) > 1 or len(ns) > 1:
        raise ValueError(
            "All components need to share starttime, sampling rate and "
            f"length to rotate: {[str(tr) for tr in comps]}"
        )
    data = np.stack([np.asarray(tr.data, dtype=np.float64) for tr in comps])
    rotated = m @ data

    out = Stream()
    for c_out, row in zip(dst, rotated):
        tr = comps[0].copy()
        tr.data = row
        tr.stats.channel = tr.stats.channel[:-1] + c_out
        out += tr
    return out
