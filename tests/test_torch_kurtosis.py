# -*- coding: utf-8 -*-
"""
The port's kurtosis onset (quakemigrate_torch.ops.kurtosis,
signal.onsets.KurtosisOnset and the fused kurtosis window of
ops.scan_window) against the JAX package on the CPU:

- ``rolling_kurtosis``, ``kurtosis_onset`` (``nsmooth`` 1, even and
  odd) and ``kurtosis_cf_rows`` on the same numpy-seeded rows: float64
  within 1e-9 relative; float32 within 1e-5 relative of the onset (its
  baseline is 1) and, for the kurtosis itself, within 1e-5 of the rows'
  largest kurtosis (the moments' differences cancel in float32, in the
  same order on both sides: the port's CPU running sum takes XLA's
  order);
- the degenerate-window gate on a row whose middle is the gap fill
  sqrt(tiny): the same zeros, no overflow;
- the fused kurtosis front end and the plain fused kurtosis window
  against JAX's ``fused_kurtosis_onsets`` and
  ``detect_window_fused_kurtosis`` (float32): onsets within 1e-5,
  max_coa and max_coa_n within 2e-6 relative, argmax equal or
  tie-consistent; the ``_cuda`` twin of the window on K3's and K2 v2's
  detectors (their plain versions on CPU tensors);
- ``KurtosisOnset``: onsets (with and without the picker's timespan)
  within 1e-6 relative, the channel block, its pads, its static
  arguments and Gaussian half-widths equal to JAX's;
- detect -> trigger -> locate with ``KurtosisOnset`` on the synthetic
  workspace (tests/torch_synthetic.py), the port on the CPU against the
  JAX pipeline: .scanmseed COA and COA_N within max(1 count, 1e-5 of the
  value), X/Y/Z equal; the same event triggered; the .event's values
  within one unit of their last written digit, at the planted source.

"""

import csv

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops import kurtosis as j_kurtosis
from quakemigrate_tpu.ops import scan_window as j_scan_window
from quakemigrate_tpu.seis import read as j_read
from quakemigrate_tpu.signal.onsets import KurtosisOnset as JKurtosisOnset
from quakemigrate_torch.lut import lut_from_reference
from quakemigrate_torch.ops import kurtosis
from quakemigrate_torch.ops.scan_window import (
    detect_window_fused_kurtosis,
    fused_kurtosis_onsets,
)
from quakemigrate_torch.signal.onsets import KurtosisOnset, Onset
from quakemigrate_torch.signal.scan import QuakeScan
from quakemigrate_torch.util import OnsetTypeError

import torch_synthetic as ws

torch.set_num_threads(1)

RTOL64 = 1e-9
RTOL32 = 1e-5
WINDOW_RTOL = 2e-6
# The workspace's event window (as tests/test_torch_locate.py reads it)
EVENT_WINDOW = ("2021-02-18T12:00:24.0", "2021-02-18T12:00:40.0")


def _rows(dtype, n_rows=3, t_len=1500, seed=11):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n_rows, t_len))
    rows[:, 700:760] += 8.0 * rng.normal(size=(n_rows, 60))  # an arrival
    return rows.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nkurt", [26, 101, 251])
def test_rolling_kurtosis_matches_jax(dtype, nkurt):
    rows = _rows(dtype)
    got = kurtosis.rolling_kurtosis(torch.from_numpy(rows), nkurt).numpy()
    want = np.asarray(j_kurtosis.rolling_kurtosis(rows, nkurt))
    assert got.dtype == want.dtype == dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=RTOL64,
                                   atol=RTOL64 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL32 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nsmooth", [1, 12, 13])
def test_kurtosis_onset_matches_jax(dtype, nsmooth):
    """nsmooth 12 and 13 are 0.05 s at 250 Hz rounded either way: numpy's
    convolve centres an even box one sample early."""

    rows = _rows(dtype)
    got = kurtosis.kurtosis_onset(torch.from_numpy(rows), 51, nsmooth).numpy()
    want = np.asarray(j_kurtosis.kurtosis_onset(rows, 51, nsmooth))
    np.testing.assert_allclose(
        got, want, rtol=RTOL64 if dtype == np.float64 else RTOL32)
    assert (got >= 1.0).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nsmooth", [1, 12, 13])
def test_kurtosis_cf_rows_matches_jax(dtype, nsmooth):
    rows = _rows(dtype, n_rows=4)
    nkurt = np.array([26, 26, 51, 51], np.int32)
    got = kurtosis.kurtosis_cf_rows(torch.from_numpy(rows),
                                    torch.from_numpy(nkurt), nsmooth).numpy()
    want = np.asarray(j_kurtosis.kurtosis_cf_rows(rows, nkurt, nsmooth))
    np.testing.assert_allclose(
        got, want, rtol=RTOL64 if dtype == np.float64 else RTOL32)
    # Row by row, the per-row form is kurtosis_onset
    for r, n in enumerate(nkurt):
        np.testing.assert_allclose(
            got[r], kurtosis.kurtosis_onset(torch.from_numpy(rows[r]), int(n),
                                            nsmooth).numpy(),
            rtol=RTOL64 if dtype == np.float64 else RTOL32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_degenerate_window_gate_on_a_gap_filled_row(dtype):
    """The gap fill of onsets.base.fill_gaps (sqrt of the float64 tiny)
    makes windows with no variance: the gate flattens them to 0 on both
    sides, and nothing overflows."""

    rows = _rows(np.float64, n_rows=2)
    rows[:, 400:900] = np.sqrt(np.finfo(float).tiny)
    rows = rows.astype(dtype)
    got = kurtosis.rolling_kurtosis(torch.from_numpy(rows), 51).numpy()
    want = np.asarray(j_kurtosis.rolling_kurtosis(rows, 51))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, 460:900] == 0, want[:, 460:900] == 0)
    assert (got[:, 460:900] == 0).all()
    np.testing.assert_allclose(
        kurtosis.kurtosis_onset(torch.from_numpy(rows), 51, 12).numpy(),
        np.asarray(j_kurtosis.kurtosis_onset(rows, 51, 12)),
        rtol=RTOL64 if dtype == np.float64 else RTOL32)


def test_kurtosis_sums_take_the_reference_order_on_every_device(
        monkeypatch):
    """The moments' running sums ask for the reference's order of
    additions (ops.rolling), so a CUDA tensor takes the CPU's blocked
    order instead of torch.cumsum: the card's front end then equals the
    CPU's. Every running sum of rolling_kurtosis, kurtosis_onset and
    kurtosis_cf_rows asks for it, one call for the four powers."""

    from quakemigrate_torch.ops import rolling

    asked = []
    padded_cumsum = rolling.padded_cumsum

    def recording(x, reference_order=False):
        asked.append((tuple(x.shape), reference_order))
        return padded_cumsum(x, reference_order)

    monkeypatch.setattr(rolling, "padded_cumsum", recording)
    rows = torch.from_numpy(_rows(np.float32, n_rows=3))
    kurtosis.rolling_kurtosis(rows, 26)
    kurtosis.kurtosis_onset(rows, 26, 12)
    kurtosis.kurtosis_cf_rows(rows, torch.tensor([26, 51, 51]), 12)
    t = rows.shape[-1]
    assert asked == [((4, 3, t), True), ((4, 3, t), True), ((12, t), True)]


def _block(n_slots=8, c_max=3, t_len=400, seed=12):
    """A numpy-seeded float32 channel block with a dead slot and a dead
    channel, P slots then S slots (nkurt 26 and 51)."""

    rng = np.random.default_rng(seed)
    channels = rng.normal(size=(n_slots, c_max, t_len)).astype(np.float32)
    channels[:, :, 200:230] *= 6.0
    chan_mask = np.ones((n_slots, c_max), np.float32)
    slot_mask = np.ones(n_slots, np.float32)
    chan_mask[2, 2] = 0.0
    channels[2, 2] = 0.0
    slot_mask[5] = chan_mask[5] = 0.0
    channels[5] = 0.0
    nkurt = np.repeat(np.array([26, 51], np.int32), n_slots // 2)
    return channels, chan_mask, slot_mask, nkurt


@pytest.mark.parametrize("nsmooth, taper_pad", [(1, 0), (12, 7), (13, 30)])
def test_fused_kurtosis_onsets_match_jax(nsmooth, taper_pad):
    block = _block()
    got, got_avail = fused_kurtosis_onsets(
        *(torch.from_numpy(a) for a in block), nsmooth, taper_pad, 0.4)
    want, want_avail = j_scan_window.fused_kurtosis_onsets(
        *block, nsmooth, taper_pad, 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL32)
    assert float(got_avail) == float(want_avail) == 7.0


def test_fused_kurtosis_window_matches_jax():
    block = _block()
    n_slots, t_len = block[0].shape[0], block[0].shape[-1]
    node_count, fsmp, nsamples = (6, 5, 4), 120, 180
    rng = np.random.default_rng(13)
    tt = rng.integers(0, t_len - fsmp - nsamples,
                      size=(int(np.prod(node_count)), n_slots)).astype(
                          np.int32)
    args = (12, 20, 0.4, fsmp, nsamples)
    got = [x.numpy() for x in detect_window_fused_kurtosis(
        *(torch.from_numpy(a) for a in block), torch.from_numpy(tt), *args)]
    want = [np.asarray(x) for x in j_scan_window.detect_window_fused_kurtosis(
        *block, tt, *args)]
    np.testing.assert_allclose(got[0], want[0], rtol=WINDOW_RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=WINDOW_RTOL)
    differ = got[2] != want[2]
    if differ.any():
        onsets, available = j_scan_window.fused_kurtosis_onsets(
            *block, 12, 20, 0.4)
        logged = np.log(np.clip(np.asarray(onsets, np.float64), 0.01, None))
        logged *= block[2][:, None]
        cols = fsmp + tt[got[2]].T + np.arange(nsamples)
        at = np.exp(np.take_along_axis(logged, cols, axis=1).sum(0)
                    / float(available))
        np.testing.assert_allclose(at[differ], want[0][differ],
                                   rtol=WINDOW_RTOL)


def test_kurtosis_window_on_a_detector_route():
    """``detect_window_cuda`` feeds the kurtosis front end to a
    detector's reduce: on CPU tensors K3's detector runs the plain
    reduction, so it equals the plain window bit for bit; K2 v2's plain
    version holds it within WINDOW_RTOL."""

    from quakemigrate_torch.ops import cuda_migrate
    from quakemigrate_torch.ops.scan_window import (
        detect_window_cuda,
        kurtosis_front_end,
    )

    block = _block()
    tensors = [torch.from_numpy(a) for a in block]
    node_count, fsmp, nsamples = (6, 5, 4), 120, 180
    rng = np.random.default_rng(14)
    tt = rng.integers(0, 90, size=(int(np.prod(node_count)),
                                   block[0].shape[0])).astype(np.int32)
    args = (12, 20, 0.4)
    plain = detect_window_fused_kurtosis(*tensors, torch.from_numpy(tt),
                                         *args, fsmp, nsamples)
    for kind, exact in ((cuda_migrate.CudaDetectGlobal, True),
                        (cuda_migrate.CudaDetectVPU, False)):
        detector = kind(tt, node_count, fsmp, nsamples, "cpu")
        got = detect_window_cuda(kurtosis_front_end(*args), tensors,
                                 detector, int(np.prod(node_count)))
        if exact:
            for a, b in zip(got, plain):
                assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(got[0].numpy(), plain[0].numpy(),
                                       rtol=WINDOW_RTOL)
            np.testing.assert_allclose(got[1].numpy(), plain[1].numpy(),
                                       rtol=WINDOW_RTOL)
        assert detector.launches == 0


# -- the onset class and the pipeline -----------------------------------------

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return ws.build_workspace(tmp_path_factory.mktemp("torch_kurtosis"))


def _data_both(workspace):
    from quakemigrate_tpu.io import Archive as JArchive
    from quakemigrate_tpu.seis import UTCDateTime as JUTCDateTime
    from quakemigrate_torch.io import Archive
    from quakemigrate_torch.lut import StationTable
    from quakemigrate_torch.seis import UTCDateTime

    start, end = EVENT_WINDOW
    port = Archive(workspace["archive"],
                   StationTable.of(workspace["stations"]),
                   archive_format="YEAR/JD/STATION")
    jax = JArchive(archive_path=workspace["archive"],
                   stations=workspace["stations"],
                   archive_format="YEAR/JD/STATION")
    return (port.read_waveform_data(UTCDateTime(start), UTCDateTime(end)),
            jax.read_waveform_data(JUTCDateTime(start), JUTCDateTime(end)))


def _onsets():
    port = ws.kurtosis_settings(KurtosisOnset(sampling_rate=ws.SPS))
    jax = ws.kurtosis_settings(JKurtosisOnset(sampling_rate=ws.SPS))
    for onset in (port, jax):
        onset.kurtosis_windows = {"P": 0.5, "S": 1.0}
    return port, jax


@pytest.mark.parametrize("timespan", [None, 4.0])
def test_calculate_onsets_equals_jax(workspace, timespan):
    port_data, jax_data = _data_both(workspace)
    port, jax = _onsets()
    got, got_data = port.calculate_onsets(port_data, timespan=timespan,
                                          device="cpu")
    want, want_data = jax.calculate_onsets(jax_data, timespan=timespan)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert got.shape == want.shape == (2 * ws.N_STATIONS, 16 * ws.SPS + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert list(got_data.onsets) == list(want_data.onsets)
    for station, phases in want_data.onsets.items():
        for phase, row in phases.items():
            np.testing.assert_allclose(got_data.onsets[station][phase], row,
                                       rtol=1e-6, atol=0)
            assert got.numpy()[got_data.rows[f"{station}_{phase}"]] is not None
    assert got_data.availability == want_data.availability


def test_device_inputs_and_pads_equal_jax(workspace):
    port_data, jax_data = _data_both(workspace)
    port, jax = _onsets()
    slots = [(phase, f"ST{i:02d}") for phase in ("P", "S")
             for i in range(ws.N_STATIONS)]
    got = port.prepare_device_inputs(port_data, slots)
    want = jax.prepare_device_inputs(jax_data, slots)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(
            b).max())
    assert got[4] == want[4]
    port.post_pad = jax.post_pad = 7.25
    assert (port.pre_pad, port.post_pad) == (jax.pre_pad, jax.post_pad)
    for timespan in (5.0, 1.0, 120.0):
        assert port.pad(timespan) == jax.pad(timespan)
        assert port.fused_static_args(timespan) == jax.fused_static_args(
            timespan)
    for phase in ("P", "S"):
        assert port.gaussian_halfwidth(phase) == jax.gaussian_halfwidth(
            phase)
    assert str(port) == str(jax)


def test_quakescan_refuses_other_onsets(workspace):
    """QuakeScan refuses an onset that is not an Onset (as the reference
    does); any Onset subclass is taken (the next test)."""

    class NotAnOnset:
        sampling_rate = ws.SPS

        def calculate_onsets(self, data, timespan=None, device="cuda"):
            raise NotImplementedError

    with pytest.raises(OnsetTypeError):
        QuakeScan(None, None, NotAnOnset(), "runs", "x", device="cpu")


def test_quakescan_accepts_a_custom_onset(workspace):
    """An Onset subclass that implements only calculate_onsets (the
    reference's one abstract method) is instantiated and taken by
    QuakeScan, on the standard path; prepare_device_inputs raises
    NotImplementedError on it."""

    class Custom(Onset):
        def calculate_onsets(self, data, timespan=None, device="cuda"):
            raise NotImplementedError

    onset = Custom(sampling_rate=ws.SPS)
    with pytest.raises(NotImplementedError):
        onset.prepare_device_inputs(None, [])
    lut = lut_from_reference(ws.reference_state(workspace["lut"]))
    scan = QuakeScan(None, lut, onset, "runs", "x", device="cpu")
    assert scan.onset is onset and not scan._fused_active


@pytest.fixture(scope="module")
def runs(workspace):
    jax_dir = ws.jax_pipeline(workspace, "jax", kurtosis=True)
    port_dir, scan = ws.port_pipeline(workspace, "port", kurtosis=True)
    return {"jax": jax_dir, "port": port_dir, "scan": scan}


def test_pipeline_scanmseed_matches_jax(runs):
    def scanmseed(run_dir):
        st = j_read(str(run_dir / "detect" / "scanmseed"
                        / "2021_049.scanmseed"))
        return {tr.stats.station: tr.data.astype(np.int64) for tr in st}

    got, want = scanmseed(runs["port"]), scanmseed(runs["jax"])
    assert sorted(got) == sorted(want)
    for name in ("COA", "COA_N"):
        bound = np.maximum(1, 1e-5 * np.abs(want[name]))
        assert (np.abs(got[name] - want[name]) <= bound).all(), name
    for name in ("X", "Y", "Z"):
        np.testing.assert_array_equal(got[name], want[name])
    assert runs["scan"].detect_scan.route == "plain"


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _digit_unit(text):
    mantissa, _, exponent = text.lower().partition("e")
    decimals = len(mantissa.partition(".")[2])
    return 10.0 ** (-decimals + (int(exponent) if exponent else 0))


def test_pipeline_event_matches_jax(runs, workspace):
    events = {}
    for name in ("port", "jax"):
        files = sorted((runs[name] / "locate" / "events").glob("*.event"))
        assert len(files) == 1, files
        events[name] = _csv(files[0])
    got, want = events["port"], events["jax"]
    assert got[0] == want[0] and len(got) == len(want) == 2
    for name, a, b in zip(want[0], got[1], want[1]):
        try:
            x, y = float(a), float(b)
        except ValueError:
            assert a == b, name
        else:
            assert abs(x - y) <= _digit_unit(b) * (1 + 1e-9), (name, a, b)
    row = dict(zip(got[0], got[1]))
    lut = workspace["lut"]
    node = lut.index2coord([[float(row["X"]), float(row["Y"]),
                             float(row["Z"])]], inverse=True)[0]
    source = lut.index2coord([ws.SOURCE], inverse=True)[0]
    assert np.abs(node - source).max() <= 1
