# -*- coding: utf-8 -*-
"""
Abstract interface for onset (characteristic) function generators, plus the
OnsetData result container and the shared availability gathering, the
port of the JAX package's ``signal/onsets/base.py``.

The window-padding arithmetic reproduces the reference semantics
(quakemigrate/signal/onsets/base.py:64-93) — pads set the scan-window
geometry that output parity depends on — with the taper allowance computed
once and shared by both pads.

"""

import abc
import logging
from dataclasses import dataclass
from math import ceil

import numpy as np

from quakemigrate_torch.util import trim2sample


def fill_gaps(waveforms, data):
    """Taper, merge and pad gappy channels with a tiny fill value."""

    tiny = np.sqrt(np.finfo(float).tiny)
    waveforms.taper(type="cosine", max_percentage=0.05)
    waveforms.merge(method=1, fill_value=tiny)
    waveforms.trim(
        starttime=data.starttime - 0.00001, endtime=data.endtime + 0.00001,
        pad=True, fill_value=tiny, nearest_sample=False,
    )


def gather_phase_waveforms(onset, data, phase, conditioned):
    """
    Availability-check one phase's pre-processed waveforms per station:
    drop channels that failed QC, gap-fill when gaps / partial data are
    tolerated (so downstream device batches keep a fixed shape), and
    return ``({station: Stream}, {f"{station}_{phase}": 0/1})``.

    Shared by every onset implementation — the availability semantics
    (ref signal/onsets/stalta.py:353-489) must not drift between them.

    """

    criteria = dict(
        all_channels=onset.all_channels,
        n_channels=onset.channel_counts[phase],
        allow_gaps=onset.allow_gaps,
        full_timespan=onset.full_timespan,
        check_sampling_rate=True,
        sampling_rate=onset.sampling_rate,
    )

    availability, kept = {}, {}
    for station in data.stations:
        waveforms = conditioned.select(station=station)
        available, per_channel = data.check_availability(
            waveforms, **criteria
        )
        availability[f"{station}_{phase}"] = available
        if not available:
            logging.info(f"\t\tNo {phase} onset for {station}.")
            continue

        for tr_id, ok in per_channel.items():
            if not ok:
                for tr in list(waveforms.select(id=tr_id)):
                    waveforms.remove(tr)
        if onset.allow_gaps or not onset.full_timespan:
            fill_gaps(waveforms, data)

        kept[station] = waveforms

    return kept, availability


def slice_edges(n_samples, head, tail):
    """The samples of a row of ``n_samples`` that ``row[:head] = 1`` and
    ``row[tail:] = 1`` set, as Python slices them (negative bounds count
    from the end), as (lo, hi): the samples before lo and from hi."""

    samples = range(n_samples)
    return len(samples[:head]), n_samples - len(samples[tail:])


class Onset(metaclass=abc.ABCMeta):
    """
    Base class for onset generators. Subclasses implement
    :meth:`calculate_onsets`, the one abstract method (as in the
    reference), and normally override the ``pre_pad`` / ``post_pad``
    properties with values derived from their window lengths; the base
    exposes them as plain read/write views of ``_pre_pad`` /
    ``_post_pad``. The onsets detect's fused window covers
    (``STALTAOnset``, ``KurtosisOnset``) also implement
    :meth:`prepare_device_inputs`; ``QuakeScan`` runs any other onset on
    the reference's standard path, from ``calculate_onsets``.

    """

    def __init__(self, **kwargs):
        try:
            self.sampling_rate = kwargs["sampling_rate"]
        except KeyError:
            raise ValueError("Must specify 'sampling_rate' for any Onset.")
        if self.sampling_rate is None:
            raise ValueError("Must specify 'sampling_rate' for any Onset.")
        self._pre_pad, self._post_pad = 0, 0

    def __str__(self):
        return f"{type(self).__name__} onset (no __str__ provided)"

    pre_pad = property(
        lambda self: self._pre_pad,
        lambda self, value: setattr(self, "_pre_pad", value),
    )
    post_pad = property(
        lambda self: self._post_pad,
        lambda self, value: setattr(self, "_post_pad", value),
    )

    def pad(self, timespan):
        """
        Taper-aware (pre, post) pads in seconds for a scan window of length
        ``timespan``: each pad is the onset's own requirement plus 6%
        (rounded up) of the fully padded window, trimmed onto the sample/ms
        grid.

        """

        taper_allowance = ceil((timespan + self.pre_pad + self.post_pad) * 0.06)
        return tuple(
            trim2sample(base + taper_allowance, self.sampling_rate)
            for base in (self.pre_pad, self.post_pad)
        )

    def gaussian_halfwidth(self, phase):
        """Gaussian half-width hint for the picker; custom onsets must
        provide it."""

        raise AttributeError(
            "GaussianPicker needs a 'gaussian_halfwidth' method on the Onset; "
            "custom Onset classes must implement one to be pickable."
        )

    @abc.abstractmethod
    def calculate_onsets(self, data, timespan=None, device="cuda"):
        """Compute onset functions on ``device`` (the card unless the
        caller asks for the CPU); returns ``(onsets, OnsetData)``:
        ``onsets`` [n, T] (a tensor, or a numpy array), and the record
        whose ``onsets[station][phase]`` holds each available pair's row
        (numpy or a tensor; its ``rows``, where given, maps
        "{station}_{phase}" to that row's index in ``onsets``)."""

    def prepare_device_inputs(self, data, slots, c_max=None, dtype=None):
        """The fixed-shape channel block of one detect window's fused
        front end; returns ``(channels, chan_mask, slot_mask, *per-slot
        arguments, availability)`` (STA/LTA: ``nsta, nlta``; kurtosis:
        ``nkurt``). Only the onsets the fused window covers implement it;
        any other onset takes the standard path."""

        raise NotImplementedError(
            f"{type(self).__name__} has no fused detect window; QuakeScan "
            "runs it on the standard path (calculate_onsets)")


@dataclass
class OnsetData:
    """
    Result of one onset calculation: per-station/phase onset functions, the
    pre-processed waveforms they came from, and the availability record.

    """

    onsets: dict
    phases: list
    channel_maps: dict
    filtered_waveforms: object
    availability: dict
    starttime: object
    endtime: object
    sampling_rate: float
    # "{station}_{phase}" -> its row of the onsets tensor that
    # calculate_onsets returns beside this record
    rows: dict = None
