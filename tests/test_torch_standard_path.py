# -*- coding: utf-8 -*-
"""
The reference's standard detect path in the port (quakemigrate_torch.
signal.scan), against the JAX package on the CPU over the synthetic
workspace (tests/torch_synthetic.py):

- a user's ``Onset`` subclass that implements only ``calculate_onsets``,
  defined in both packages on the same numpy math (a classic STA/LTA of
  the energy of the package's own pre-processed traces, numpy onsets),
  through detect, trigger and locate: the .scanmseed COA and COA_N within
  max(1 count, 1e-5 of the value), X/Y/Z equal; the .event within one
  unit of its last written digit (the float32 migration rounds as JAX's
  does, in another summation order);
- ``fused_detect=False`` with ``STALTAOnset`` through detect, trigger and
  locate at those tolerances, and its detect never building the fused
  channel block (F4);
- the deprecated ``ClassicSTALTAOnset`` and ``CentredSTALTAOnset`` on the
  standard path (F5), their detect's .scanmseed at those tolerances;
- the standard window's block and front end (``onset_front_end``) and
  ``_device_inputs`` from an onset that gives only ``OnsetData.onsets``
  (numpy rows), in the reference's slot layout and type.

The CUDA route of these windows is the detect route's kernels
(chip_smoke.py's standard_path runs them on the card).

"""

import numpy as np
import pytest
import torch

import quakemigrate_tpu.signal.onsets as j_onsets
from quakemigrate_tpu.signal.onsets.stalta import (
    pre_process as j_pre_process)
from quakemigrate_torch.ops.scan_window import onset_front_end
from quakemigrate_torch.signal import onsets as port_onsets
from quakemigrate_torch.signal.onsets import pre_process

import torch_synthetic as ws

torch.set_num_threads(1)

RTOL = 1e-5


def custom_onset_class(base, onset_data, pre):
    """A user's onset on ``base`` (the JAX package's ``Onset`` or the
    port's), with only ``calculate_onsets``: per phase, the package's
    pre-processing (``pre``) of the phase's channels, then in numpy a
    classic STA/LTA of each trace's energy (0.2 / 1.0 s), the RMS of a
    station's channels, clipped at 0.4; a station/phase is available
    where all its channels are there at the full length. Returns
    (onsets float64 numpy [n, T], OnsetData without ``rows``)."""

    class EnergyRatioOnset(base):
        phases = ["P", "S"]
        channel_maps = {"P": "*Z", "S": "*[N,E]"}
        channel_counts = {"P": 1, "S": 2}
        bandpass = [1, 12, 2]
        sta, lta = 0.2, 1.0

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self._post = 0.0

        @property
        def pre_pad(self):
            return self.lta + 3 * self.sta

        @pre_pad.setter
        def pre_pad(self, value):
            pass

        @property
        def post_pad(self):
            return self._post

        @post_pad.setter
        def post_pad(self, ttmax):
            self._post = np.ceil(ttmax + 2 * self.lta)

        def gaussian_halfwidth(self, phase):
            return self.sta * self.sampling_rate / 2

        def calculate_onsets(self, data, timespan=None, **kwargs):
            rate = self.sampling_rate
            nsta, nlta = int(self.sta * rate) + 1, int(self.lta * rate) + 1
            t_len = int(round((data.endtime - data.starttime) * rate)) + 1
            rows, onsets, availability = [], {}, {}
            filtered = None
            for phase in self.phases:
                conditioned = pre(
                    data.waveforms.select(channel=self.channel_maps[phase]),
                    rate, data.resample, data.upfactor, self.bandpass,
                    data.starttime, data.endtime)
                filtered = (conditioned if filtered is None
                            else filtered + conditioned)
                for station in data.stations:
                    traces = [np.asarray(tr.data, np.float64) for tr in
                              conditioned.select(station=station)]
                    ok = (len(traces) == self.channel_counts[phase]
                          and all(len(x) == t_len for x in traces))
                    availability[f"{station}_{phase}"] = int(ok)
                    if not ok:
                        continue
                    energy = np.stack(traces) ** 2
                    csum = np.concatenate(
                        [np.zeros((len(traces), 1)),
                         np.cumsum(energy, axis=1)], axis=1)
                    sta = (csum[:, nsta:] - csum[:, :-nsta]) / nsta
                    lta = (csum[:, nlta:] - csum[:, :-nlta]) / nlta
                    ratio = np.ones((len(traces), t_len))
                    ratio[:, nlta - 1:] = (sta[:, nlta - nsta:]
                                           / np.maximum(lta, 1e-300))
                    row = np.maximum(np.sqrt((ratio ** 2).mean(axis=0)), 0.4)
                    rows.append(row)
                    onsets.setdefault(station, {})[phase] = row
            return np.stack(rows), onset_data(
                onsets, self.phases, self.channel_maps, filtered,
                availability, data.starttime, data.endtime, rate)

    return EnergyRatioOnset


def port_custom():
    return custom_onset_class(port_onsets.Onset, port_onsets.OnsetData,
                              pre_process)(sampling_rate=ws.SPS)


def jax_custom():
    return custom_onset_class(j_onsets.Onset, j_onsets.OnsetData,
                              j_pre_process)(sampling_rate=ws.SPS)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return ws.build_workspace(tmp_path_factory.mktemp("torch_standard"))


@pytest.fixture(scope="module")
def custom_runs(workspace):
    jax_dir = ws.jax_pipeline(workspace, "jax_custom", onset=jax_custom())
    port_dir, scan = ws.port_pipeline(workspace, "port_custom",
                                      onset=port_custom())
    return {"jax": jax_dir, "port": port_dir, "scan": scan}


def test_custom_onset_scanmseed_matches_jax(custom_runs):
    """F6: an onset with only calculate_onsets runs detect."""

    ws.assert_scanmseed_close(ws.scanmseed_counts(custom_runs["port"]),
                              ws.scanmseed_counts(custom_runs["jax"]), RTOL)
    scan = custom_runs["scan"]
    assert not scan._fused_active and scan.detect_scan.route == "plain"


def test_custom_onset_event_matches_jax(custom_runs, workspace):
    ws.assert_event_close(custom_runs["port"], custom_runs["jax"])
    row = dict(zip(*ws.event_rows(custom_runs["port"])))
    lut = workspace["lut"]
    node = lut.index2coord([[float(row["X"]), float(row["Y"]),
                             float(row["Z"])]], inverse=True)[0]
    source = lut.index2coord([ws.SOURCE], inverse=True)[0]
    assert np.abs(node - source).max() <= 1


@pytest.fixture(scope="module")
def unfused_runs(workspace):
    jax_dir = ws.jax_pipeline(workspace, "jax_unfused", fused_detect=False)
    calls = []
    onset = ws.make_onset(port_onsets)
    real = onset.prepare_device_inputs
    onset.prepare_device_inputs = lambda *a, **k: calls.append(a) or real(
        *a, **k)
    port_dir, scan = ws.port_pipeline(workspace, "port_unfused",
                                      onset=onset, fused_detect=False)
    return {"jax": jax_dir, "port": port_dir, "scan": scan, "calls": calls}


def test_fused_detect_false_takes_the_standard_path(unfused_runs):
    """F4: fused_detect=False is no longer without effect: the windows
    come from calculate_onsets, and the fused block is never built."""

    scan = unfused_runs["scan"]
    assert not scan._fused_active
    assert scan.detect_scan.front_end.__qualname__.startswith(
        "onset_front_end")
    assert unfused_runs["calls"] == []


def test_fused_detect_false_matches_jax(unfused_runs):
    ws.assert_scanmseed_close(ws.scanmseed_counts(unfused_runs["port"]),
                              ws.scanmseed_counts(unfused_runs["jax"]), RTOL)
    ws.assert_event_close(unfused_runs["port"], unfused_runs["jax"])


@pytest.mark.parametrize("name", ["ClassicSTALTAOnset",
                                  "CentredSTALTAOnset"])
def test_deprecated_classes_take_the_standard_path(workspace, name):
    """F5: the deprecated classes are subclasses, which the fused window
    does not cover (the reference tests the onset's type): their detect
    runs calculate_onsets, as the JAX package's does."""

    j_onset = ws.onset_settings(getattr(j_onsets, name)(sampling_rate=ws.SPS))
    onset = ws.onset_settings(getattr(port_onsets, name)(
        sampling_rate=ws.SPS))
    jax_dir = ws.jax_pipeline(workspace, f"jax_{name}", locate=False,
                              onset=j_onset)
    port_dir, scan = ws.port_pipeline(workspace, f"port_{name}",
                                      locate=False, onset=onset)
    assert not scan._fused_active
    ws.assert_scanmseed_close(ws.scanmseed_counts(port_dir),
                              ws.scanmseed_counts(jax_dir), RTOL)


def test_standard_window_block_from_numpy_onsets(workspace):
    """The standard window of an onset that gives its rows only in
    OnsetData.onsets (numpy): the block in the reference's canonical slot
    layout and the scan's type (ones for a missing pair), available the
    live slots, the slot mask; the front end hands the onsets and
    available on. In double, float64."""

    from quakemigrate_torch.seis import UTCDateTime

    for precision, dtype in (("single", np.float32), ("double", np.float64)):
        scan = ws.port_scan(workspace, f"block_{precision}",
                            onset=port_custom(), precision=precision)
        start = UTCDateTime(ws.START)
        data = scan.archive.read_waveform_data(start, start + 8.0)
        slots = scan._canonical_slots()
        (block, available, mask), availability = scan._prepare_window(data)
        onsets, onset_data = scan.onset.calculate_onsets(data)
        assert availability == onset_data.availability
        assert block.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        assert available.dtype == mask.dtype == dtype
        assert block.shape == (len(slots), onsets.shape[-1])
        # a pair the onset did not give keeps the slot's ones, mask 0
        onset_data.onsets["ST03"].pop("S")
        want = np.ones(block.shape, dtype)
        want_mask = np.zeros(len(slots), dtype)
        for s, (phase, station) in enumerate(slots):
            row = onset_data.onsets.get(station, {}).get(phase)
            if row is not None:
                want[s], want_mask[s] = row, 1.0
        got, got_mask, got_available = scan._device_inputs(onsets,
                                                           onset_data)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got_mask, want_mask)
        assert got_available == want_mask.sum() == float(available) - 1
        front = onset_front_end()
        out, avail = front(block, available, mask)
        assert out is block and avail is available
