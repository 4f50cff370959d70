# -*- coding: utf-8 -*-
"""
Kurtosis onset of the port, after the JAX package's
``signal/onsets/kurtosis.py``: the positive gradient of a rolling-kurtosis
characteristic function (Baillard et al., 2014), plugged into QuakeScan
as :class:`~quakemigrate_torch.signal.onsets.STALTAOnset` is.

Pre-processing runs host-side as for the STA/LTA onset. For detect,
:meth:`KurtosisOnset.prepare_device_inputs` builds the channel block of
the fused kurtosis window (``ops.scan_window.fused_kurtosis_onsets``) and
:meth:`KurtosisOnset.fused_static_args` its settings. For locate, the
standard detect path and the picker, :meth:`KurtosisOnset.calculate_onsets`
computes the onsets in float64 on the device it is given, one
``ops.kurtosis.station_kurtosis_onset`` call a phase (on the card one ON2
v2 launch).

"""

import logging

import numpy as np
import torch

import quakemigrate_torch.util as util
from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.ops.kurtosis import station_kurtosis_onset
from quakemigrate_torch.seis import Stream
from .base import Onset, OnsetData, gather_phase_waveforms, slice_edges
from .stalta import pre_process


class KurtosisOnset(Onset):
    """
    Onset functions from the rectified gradient of rolling kurtosis.

    Attributes
    ----------
    phases, bandpass_filters, channel_maps, channel_counts : as STALTAOnset.
    kurtosis_windows : dict of float
        Trailing kurtosis window length per phase, in seconds.
    smoothing_window : float
        Smoothing applied to the characteristic function, in seconds.
    min_onset_value : float
        Clip floor for the combined onset (>= 0.01).
    all_channels, allow_gaps, full_timespan : bool
        Data-quality toggles, as STALTAOnset.

    """

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

        self.min_onset_value = kwargs.get("min_onset_value", 0.4)
        if self.min_onset_value < 0.01:
            raise ValueError("The `min_onset_value` must be greater than 0.01")

        self.phases = kwargs.get("phases", ["P", "S"])
        self.bandpass_filters = kwargs.get(
            "bandpass_filters", {"P": [2.0, 16.0, 2], "S": [2.0, 16.0, 2]}
        )
        self.kurtosis_windows = kwargs.get(
            "kurtosis_windows", {"P": 1.0, "S": 1.0}
        )
        self.smoothing_window = kwargs.get("smoothing_window", 0.05)
        self.channel_maps = kwargs.get(
            "channel_maps", {"P": "*Z", "S": "*[N,E,1,2]"}
        )
        self.channel_counts = kwargs.get("channel_counts", {"P": 1, "S": 2})

        self.all_channels = kwargs.get("all_channels", False)
        self.allow_gaps = kwargs.get("allow_gaps", False)
        self.full_timespan = kwargs.get("full_timespan", True)

    def __str__(self):
        out = (
            "\tOnset parameters - using the kurtosis onset"
            f"\n\t\tOnset function sampling rate = {self.sampling_rate} Hz"
            f"\n\t\tPhase(s) = {self.phases}\n"
        )
        for phase, filt in self.bandpass_filters.items():
            out += f"\n\t\t{phase} bandpass filter = {filt} (Hz, Hz, -)"
        out += "\n"
        for phase, win in self.kurtosis_windows.items():
            out += f"\n\t\t{phase} kurtosis window = {win} (s)"
        out += "\n"
        return out

    def _nkurt(self, phase):
        """The kurtosis window of ``phase`` in samples."""

        return util.time2sample(self.kurtosis_windows[phase],
                                self.sampling_rate) + 1

    @property
    def nsmooth(self):
        """The smoothing window in samples (at least 1)."""

        return max(1, util.time2sample(self.smoothing_window,
                                       self.sampling_rate))

    def _gather_phase_waveforms(self, data, phase):
        """Pre-process one phase's waveforms and run the availability
        checks: (per-station kept streams, per-(station, phase)
        availability)."""

        filtered = pre_process(
            data.waveforms.select(channel=self.channel_maps[phase]),
            self.sampling_rate, data.resample, data.upfactor,
            self.bandpass_filters[phase], data.starttime, data.endtime,
        )
        return gather_phase_waveforms(self, data, phase, filtered)

    def calculate_onsets(self, data, timespan=None, device="cuda"):
        """
        Calculate kurtosis onsets for all requested stations and phases,
        on ``device`` (float64; the card unless the caller asks for the
        CPU, and raises where CUDA is absent): the phases' traces go to the
        device in one copy, each phase's onsets, edges and per-station
        combine is one call of ``ops.kurtosis.station_kurtosis_onset`` (one
        ON2 v2 launch on the card), and the onsets come back in one copy.

        Returns (onsets [n_onsets, nsamples] float64 tensor on ``device``,
        stacked in phase-major order over available station/phase pairs,
        OnsetData whose ``onsets`` are the same rows as numpy arrays).

        """

        device = resolve_device(device)
        traces, keys, calls = [], [], []
        filtered_waveforms = Stream()
        availability = {}

        for phase in self.phases:
            kept, phase_avail = self._gather_phase_waveforms(data, phase)
            availability.update(phase_avail)

            first, offsets = len(traces), [0]
            for station, waveforms in kept.items():
                traces.extend(
                    np.asarray(tr.data, dtype=np.float64) for tr in waveforms
                )
                offsets.append(len(traces) - first)
                keys.append((station, phase))
                filtered_waveforms += waveforms
            if len(offsets) > 1:
                calls.append((first, offsets, self._nkurt(phase)))

        if sum(availability.values()) == 0:
            raise util.DataAvailabilityException

        # The whole batch to the device in one copy; a launch a phase, each
        # writing its stations' rows
        batch = torch.from_numpy(np.stack(traces)).to(device)
        n_samples = batch.shape[-1]
        onsets = torch.empty((len(keys), n_samples), dtype=batch.dtype,
                             device=device)
        done = 0
        for first, offsets, nkurt in calls:
            stations = len(offsets) - 1
            station_kurtosis_onset(
                batch[first:first + offsets[-1]], offsets, nkurt,
                self.nsmooth, self._edges(n_samples, nkurt, timespan),
                self.min_onset_value, out=onsets[done:done + stations])
            done += stations

        host = onsets.cpu().numpy()
        onsets_dict = {}
        for (station, phase), row in zip(keys, host):
            onsets_dict.setdefault(station, {})[phase] = row
        logging.debug(filtered_waveforms.__str__(extended=True))

        onset_data = OnsetData(
            onsets=onsets_dict,
            phases=self.phases,
            channel_maps=self.channel_maps,
            filtered_waveforms=filtered_waveforms,
            availability=availability,
            starttime=data.starttime,
            endtime=data.endtime,
            sampling_rate=self.sampling_rate,
            rows={f"{station}_{phase}": i
                  for i, (station, phase) in enumerate(keys)},
        )
        return onsets, onset_data

    def prepare_device_inputs(self, data, slots, c_max=None, dtype=None):
        """
        Build the fixed-shape channel block of the fused kurtosis window
        (``ops.scan_window.detect_window_fused_kurtosis``; on the card
        ``detect_window_cuda``). Returns (channels [n_slots, C_max, T], chan_mask,
        slot_mask, nkurt, availability dict).

        """

        if c_max is None:
            c_max = max(3, max(self.channel_counts.values()))
        dtype = np.float32 if dtype is None else dtype

        t_len = util.time2sample(
            data.endtime - data.starttime, self.sampling_rate
        ) + 1

        n_slots = len(slots)
        channels = np.zeros((n_slots, c_max, t_len), dtype=dtype)
        chan_mask = np.zeros((n_slots, c_max), dtype=dtype)
        slot_mask = np.zeros(n_slots, dtype=dtype)
        nkurt = np.full(n_slots, 2, dtype=np.int32)
        availability = {}

        kept_by_phase = {}
        for phase in self.phases:
            kept, phase_avail = self._gather_phase_waveforms(data, phase)
            availability.update(phase_avail)
            kept_by_phase[phase] = kept

        for s, (phase, station) in enumerate(slots):
            nkurt[s] = self._nkurt(phase)
            waveforms = kept_by_phase[phase].get(station)
            if waveforms is None:
                continue
            for c, tr in enumerate(list(waveforms)[:c_max]):
                row = np.asarray(tr.data, dtype=dtype)
                channels[s, c, : len(row)] = row[:t_len]
                chan_mask[s, c] = 1.0
            slot_mask[s] = 1.0

        return channels, chan_mask, slot_mask, nkurt, availability

    def _taper_pad(self, timespan):
        """Samples of the taper allowance before the onset's own pre-pad
        in a window of ``timespan`` seconds."""

        pre_pad, _ = self.pad(timespan)
        return util.time2sample(pre_pad - self.pre_pad, self.sampling_rate)

    def fused_static_args(self, timespan):
        """Settings of the fused kurtosis window: (nsmooth, taper_pad,
        min_onset_value)."""

        return (self.nsmooth, self._taper_pad(timespan),
                float(self.min_onset_value))

    def _edges(self, n_samples, nkurt, timespan):
        """The tapered edges set to the baseline 1 before the combine, the
        reference's ``onsets[:, :taper_pad + nkurt - 1]`` and
        ``onsets[:, -max(taper_pad, 1):]``, as (lo, hi): the samples
        before lo and from hi; None without a timespan."""

        if not timespan:
            return None
        taper_pad = self._taper_pad(timespan)
        return slice_edges(n_samples, taper_pad + nkurt - 1,
                           -max(taper_pad, 1))

    def gaussian_halfwidth(self, phase):
        """Half the kurtosis window, in samples."""

        return self.kurtosis_windows[phase] * self.sampling_rate / 2

    @property
    def pre_pad(self):
        """3x the longest kurtosis window."""

        return 3 * max(self.kurtosis_windows.values())

    @pre_pad.setter
    def pre_pad(self, value):
        self._pre_pad = value

    @property
    def post_pad(self):
        return self._post_pad

    @post_pad.setter
    def post_pad(self, ttmax):
        """ceil(max traveltime + 2 * the longest kurtosis window)."""

        longest = max(self.kurtosis_windows.values())
        self._post_pad = np.ceil(ttmax + 2 * longest)
