# -*- coding: utf-8 -*-
"""
STA/LTA onset of the port, after the JAX package's
``signal/onsets/stalta.py``: the host side of the fused detect window.

Pre-processing (resample -> detrend -> cosine taper -> zero-phase
Butterworth bandpass) runs host-side on the port's Stream objects. For
detect, :meth:`STALTAOnset.prepare_device_inputs` places the waveforms
into the fixed-shape channel block that ``DetectScan`` takes; the
transform, STA/LTA, RMS combination and clipping run on the device inside
the fused window (``ops.scan_window``). For locate, the standard
detect path and the picker, :meth:`STALTAOnset.calculate_onsets` computes
the onsets of the available station/phase pairs in float64 on the device
it is given, one ``ops.stalta.station_sta_lta`` call a phase (on the card
one ON1 v2 launch). Window lengths, pads and the availability rules follow
the reference: they set the scan geometry that output parity depends on.

"""

import copy
import logging

import numpy as np
import torch

import quakemigrate_torch.util as util
from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.ops import stalta as stalta_ops
from quakemigrate_torch.seis import Stream
from .base import Onset, OnsetData, gather_phase_waveforms, slice_edges


def pre_process(stream, sampling_rate, resample, upfactor, filter_,
                starttime, endtime):
    """
    Resample to the scan rate, detrend (linear + constant), apply a 5%
    cosine taper and a zero-phase Butterworth bandpass.

    """

    logging.debug(stream.__str__(extended=True))
    logging.debug(f"Resample={resample}, Upfactor={upfactor}")

    lowcut, highcut, order = filter_
    nyquist = 0.5 * sampling_rate
    if highcut >= nyquist:
        raise util.NyquistException(highcut, nyquist, "")

    conditioned = util.resample(
        stream, sampling_rate, resample, upfactor, starttime, endtime
    ).copy()
    for detrend_kind in ("linear", "constant"):
        conditioned.detrend(detrend_kind)
    conditioned.taper(type="cosine", max_percentage=0.05)
    conditioned.filter("bandpass", freqmin=lowcut, freqmax=highcut,
                       corners=order, zerophase=True)
    return conditioned


class STALTAOnset(Onset):
    """
    Short-term / long-term average ratio onset functions, with per-phase
    bandpass filters, channel maps and STA/LTA window lengths.

    Attributes follow the reference API: phases, bandpass_filters,
    sta_lta_windows, channel_maps, channel_counts, position
    ("classic"/"centred"), signal_transform ("energy"/"abs"/"env"/
    "env_squared"), min_onset_value, all_channels / allow_gaps /
    full_timespan data-quality toggles.

    """

    _DEFAULTS = {
        "position": "classic",
        "signal_transform": "energy",
        "min_onset_value": 0.4,
        "phases": ["P", "S"],
        "bandpass_filters": {"P": [2.0, 16.0, 2], "S": [2.0, 16.0, 2]},
        "sta_lta_windows": {"P": [0.2, 1.0], "S": [0.2, 1.0]},
        "channel_maps": {"P": "*Z", "S": "*[N,E,1,2]"},
        "channel_counts": {"P": 1, "S": 2},
        "all_channels": False,
        "allow_gaps": False,
        "full_timespan": True,
    }

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

        # deepcopy: several defaults are dicts/lists, and instances must not
        # share (or mutate) the class-level table.
        for option, default in self._DEFAULTS.items():
            setattr(self, option, kwargs.get(option, copy.deepcopy(default)))
        if self.min_onset_value < 0.01:
            raise ValueError("The `min_onset_value` must be greater than 0.01")

        # The reference's deprecated kwargs: the property setters below
        # translate them onto position / bandpass_filters /
        # sta_lta_windows and print the reference's FutureWarning.
        self.onset_centred = kwargs.get("onset_centred")
        self.p_bp_filter = kwargs.get("p_bp_filter")
        self.s_bp_filter = kwargs.get("s_bp_filter")
        self.p_onset_win = kwargs.get("p_onset_win")
        self.s_onset_win = kwargs.get("s_onset_win")

    def __str__(self):
        parts = [
            f"\tOnset parameters - using the {self.position} STA/LTA onset",
            f"\n\t\tOnset function sampling rate = {self.sampling_rate} Hz",
            f"\n\t\tPhase(s) = {self.phases}\n",
        ]
        parts += [
            f"\n\t\t{phase} bandpass filter  = {filt} (Hz, Hz, -)"
            for phase, filt in self.bandpass_filters.items()
        ]
        parts.append("\n")
        parts += [
            f"\n\t\t{phase} onset [STA, LTA] = {windows} (s, s)"
            for phase, windows in self.sta_lta_windows.items()
        ]
        parts.append("\n")
        return "".join(parts)

    def _gather_phase_waveforms(self, data, phase):
        """
        Pre-process one phase's waveforms and run the availability checks:
        returns the per-station kept streams, the per-(station, phase)
        availability, and the STA/LTA window sample counts.

        """

        stw, ltw = (
            util.time2sample(w, self.sampling_rate) + 1
            for w in self.sta_lta_windows[phase]
        )

        conditioned = pre_process(
            data.waveforms.select(channel=self.channel_maps[phase]),
            self.sampling_rate, data.resample, data.upfactor,
            self.bandpass_filters[phase], data.starttime, data.endtime,
        )

        kept, availability = gather_phase_waveforms(
            self, data, phase, conditioned
        )
        return kept, availability, stw, ltw

    def calculate_onsets(self, data, timespan=None, device="cuda"):
        """
        Calculate onset functions for all requested stations and phases,
        on ``device`` (float64; the card unless the caller asks for the
        CPU, and raises where CUDA is absent): the phases' traces go to the
        device in one copy, each phase's transform, STA/LTA, taper-pad
        nulling and per-station combine is one call of
        ``ops.stalta.station_sta_lta`` (one ON1 v2 launch on the card), and
        the onsets come back in one copy.

        Returns (onsets [n_onsets, nsamples] float64 tensor on ``device``,
        stacked in phase-major order over available station/phase pairs,
        OnsetData whose ``onsets`` are the same rows as numpy arrays).

        """

        device = resolve_device(device)
        traces, keys, calls = [], [], []
        filtered_waveforms = Stream()
        availability = {}

        for phase in self.phases:
            kept, phase_avail, stw, ltw = self._gather_phase_waveforms(
                data, phase
            )
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
                calls.append((first, offsets, stw, ltw))

        logging.debug(filtered_waveforms.__str__(extended=True))

        if not any(availability.values()):
            raise util.DataAvailabilityException

        # The whole batch to the device in one copy; a launch a phase, each
        # writing its stations' rows
        batch = torch.from_numpy(np.stack(traces)).to(device)
        n_samples = batch.shape[-1]
        onsets = torch.empty((len(keys), n_samples), dtype=batch.dtype,
                             device=device)
        done = 0
        for first, offsets, stw, ltw in calls:
            stations = len(offsets) - 1
            stalta_ops.station_sta_lta(
                batch[first:first + offsets[-1]], offsets, stw, ltw,
                self.position, self.signal_transform,
                self._taper_edges(n_samples, stw, ltw, timespan),
                self.min_onset_value, out=onsets[done:done + stations])
            done += stations

        host = onsets.cpu().numpy()
        onsets_dict = {}
        for (station, phase), row in zip(keys, host):
            onsets_dict.setdefault(station, {})[phase] = row

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

    def _taper_edges(self, n_samples, stw, ltw, timespan):
        """The samples nulled (set to 1) at the array edges of a window of
        ``timespan`` seconds, the reference's ``onsets[:, :taper_pad + ltw
        - 1]`` and ``onsets[:, -(stw + taper_pad):]``, as (lo, hi): the
        samples before lo and from hi; None without a timespan."""

        if not timespan:
            return None
        pre_pad, _ = self.pad(timespan)
        taper_pad = util.time2sample(pre_pad - self.pre_pad,
                                     self.sampling_rate)
        return slice_edges(n_samples, taper_pad + ltw - 1,
                           -(stw + taper_pad))

    def gaussian_halfwidth(self, phase):
        """Phase-appropriate Gaussian half-width (samples) for the picker."""

        return self.sta_lta_windows[phase][0] * self.sampling_rate / 2

    def prepare_device_inputs(self, data, slots, c_max=None, dtype=None):
        """
        Build the fixed-shape channel block consumed by the fused detect
        window (``ops.scan_window.detect_window_fused``; on the card
        ``detect_window_cuda``): waveforms are pre-processed and
        availability-checked host-side, then placed into canonical
        (phase, station) slots with channel/slot masks and per-slot
        STA/LTA window lengths.

        Returns (channels [n_slots, C_max, T], chan_mask, slot_mask,
        nsta, nlta, availability dict).

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
        nsta = np.ones(n_slots, dtype=np.int32)
        nlta = np.full(n_slots, 2, dtype=np.int32)
        availability = {}

        kept_by_phase = {}
        for phase in self.phases:
            kept_by_phase[phase] = self._gather_phase_waveforms(data, phase)
            availability.update(kept_by_phase[phase][1])

        for s, (phase, station) in enumerate(slots):
            kept, _, stw, ltw = kept_by_phase[phase]
            nsta[s], nlta[s] = stw, ltw
            waveforms = kept.get(station)
            if waveforms is None:
                continue
            traces = list(waveforms)
            if len(traces) > c_max:
                logging.warning(
                    f"{station}/{phase}: {len(traces)} live channels exceed "
                    f"the fused channel capacity ({c_max}); using the first "
                    f"{c_max}."
                )
                traces = traces[:c_max]
            for c, tr in enumerate(traces):
                row = np.asarray(tr.data, dtype=dtype)
                channels[s, c, : len(row)] = row[:t_len]
                chan_mask[s, c] = 1.0
            slot_mask[s] = 1.0

        return channels, chan_mask, slot_mask, nsta, nlta, availability

    def _longest(self, which):
        """Longest STA (which=0) or LTA (which=1) window over all phases."""

        return max(win[which] for win in self.sta_lta_windows.values())

    @property
    def pre_pad(self):
        """max LTA + 3 * max STA, over all phases."""

        return self._longest(1) + 3 * self._longest(0)

    @pre_pad.setter
    def pre_pad(self, value):
        self._pre_pad = value

    @property
    def post_pad(self):
        return self._post_pad

    @post_pad.setter
    def post_pad(self, ttmax):
        """ceil(max traveltime + 2 * max LTA)."""

        self._post_pad = np.ceil(ttmax + 2 * self._longest(1))

    # --- The reference's deprecated attribute names ---

    @property
    def onset_centred(self):
        """Deprecated: use ``position``."""
        return self.position

    @onset_centred.setter
    def onset_centred(self, value):
        if value is None:
            return
        print(
            "FutureWarning: Parameter name has changed - continuing.\n"
            "To remove this message, change:\n\t'onset_centred' -> 'position'"
        )
        self.position = "centred" if value else "classic"

    def _deprecated_phase_dict(name, table, phase):  # noqa: N805
        def getter(self):
            return getattr(self, table)[phase]

        def setter(self, value):
            if value is None:
                return
            print(
                "FutureWarning: Parameter name has changed - continuing.\n"
                "To remove this message, refer to the documentation."
            )
            getattr(self, table)[phase] = value

        return property(getter, setter, doc=f"Deprecated: use "
                        f"``{table}['{phase}']`` instead of ``{name}``.")

    p_bp_filter = _deprecated_phase_dict("p_bp_filter", "bandpass_filters", "P")
    s_bp_filter = _deprecated_phase_dict("s_bp_filter", "bandpass_filters", "S")
    p_onset_win = _deprecated_phase_dict("p_onset_win", "sta_lta_windows", "P")
    s_onset_win = _deprecated_phase_dict("s_onset_win", "sta_lta_windows", "S")
    del _deprecated_phase_dict


def _deprecated_position_class(old_name, position):
    """The reference's deprecated aliases of STALTAOnset with a fixed
    ``position``."""

    def __init__(self, **kwargs):
        STALTAOnset.__init__(self, **kwargs)
        print(
            "FutureWarning: This class has been deprecated - continuing.\n"
            f"To remove this message:\n\t{old_name} -> STALTAOnset\n"
            f"\tAnd add keyword argument 'position={position}'\n"
        )
        self.position = position

    return type(old_name, (STALTAOnset,), {
        "__init__": __init__,
        "__doc__": f"Deprecated alias for STALTAOnset(position='{position}').",
    })


CentredSTALTAOnset = _deprecated_position_class("CentredSTALTAOnset", "centred")
ClassicSTALTAOnset = _deprecated_position_class("ClassicSTALTAOnset", "classic")


def overlapping_sta_lta_py(signal, nsta, nlta, device="cuda"):
    """
    Classic (overlapping-window) STA/LTA, the reference-shaped standalone
    form: numpy float64 in and out, computed in float32 by the batched
    tensor op on ``device`` (:func:`quakemigrate_torch.core.compat
    .overlapping_sta_lta`).

    """

    from quakemigrate_torch.core import compat

    return compat.overlapping_sta_lta(signal, nsta, nlta, device=device)


def centred_sta_lta_py(signal, nsta, nlta, device="cuda"):
    """
    Centred STA/LTA, the reference-shaped standalone form: numpy float64
    in and out, computed in float32 by the batched tensor op on
    ``device`` (:func:`quakemigrate_torch.core.compat.centred_sta_lta`).

    """

    from quakemigrate_torch.core import compat

    return compat.centred_sta_lta(signal, nsta, nlta, device=device)
