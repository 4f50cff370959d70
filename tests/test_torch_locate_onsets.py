# -*- coding: utf-8 -*-
"""
Locate's onsets and core.compat's STA/LTA on the CPU: the plain versions
of ON1 and ON2 (``ops.stalta``'s ``overlapping_sta_lta_plain``,
``centred_sta_lta_plain``, ``station_sta_lta_plain``; ``ops.kurtosis``'
``kurtosis_onset_plain``, ``station_kurtosis_onset_plain``) against the
JAX package, ON1's and ON2's source (``csrc/locate_onsets.cu``) compiled
for the CPU against those plain versions, and the wrappers' routing and
refusals.

- The static STA/LTAs against JAX's ``overlapping_sta_lta`` and
  ``centred_sta_lta`` on numpy-seeded rows (quiet noise, then a burst
  10^4.7 times louder, then quiet): rows shorter than ``nlta``, of 16 and
  17 samples (one block of the blocked scan, two), 257, and past 4,096;
  float32 within 1e-6 and float64 within 1e-12 relative (both add in
  ``blocked_cumsum``'s order, XLA's on the CPU: every sample was equal
  when these tests were written). ``kurtosis_onset`` (``nsmooth`` 1, odd
  and even) against JAX's: float32 within 1e-5, float64 within 1e-12
  relative (the moments' arithmetic: XLA forms ``mean**2`` and the
  divisions its own way; 5.3e-6 and 1.1e-14 seen).
- The source compiled for the CPU (tests/torch_front_end_host.py) against
  the plain versions bit for bit, in rows mode (every row's onset) and in
  stations mode (the transform, the edges set to 1, each station's rows
  combined: stations of 1, 2 and 3 rows), float32 and float64, classic
  and centred, the four transforms, ``nsmooth`` 1, 5 and 6, rows of 13 to
  65,537 samples (one to three levels of the blocked scan), windows
  longer than the row, at 32 threads a block and at the card's 256. The
  combine's root is torch's, whose CPU form (MKL's) is not correctly
  rounded, so these holds take numpy's ``sqrt``, as the card's is.
- The wrappers end to end on CPU tensors, their launches sent to the
  source compiled for the CPU: equal to the plain versions bit for bit,
  one launch a call; ``calculate_onsets`` of both onsets through them,
  one launch a phase, equal bit for bit to its CPU path.
- ``calculate_onsets`` of both onsets on the CPU (the stations mode's
  plain version, one call a phase) against the JAX package's within
  1e-6 relative (the transforms and timespans that
  tests/test_torch_locate.py and tests/test_torch_kurtosis.py do not
  take); the combine equal bit for bit to the per-station formula it
  replaced (``torch.sum`` of the squares over a station's rows, which
  adds in row order for up to four rows); ``slice_edges`` as Python
  slices.
- The wrappers refuse a CPU tensor, another dtype, empty rows, window
  lengths below 1, bad offsets, edges, positions, transforms and outputs
  before anything launches; CPU tensors never reach them.

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops import kurtosis as j_kurtosis
from quakemigrate_tpu.ops import stalta as j_stalta
from quakemigrate_tpu.signal.onsets import KurtosisOnset as JKurtosisOnset
from quakemigrate_tpu.signal.onsets import STALTAOnset as JSTALTAOnset
from quakemigrate_torch.core import compat
from quakemigrate_torch.ops import cuda_onsets, kurtosis, stalta
from quakemigrate_torch.ops.stalta import _envelope
from quakemigrate_torch.seis import UTCDateTime
from quakemigrate_torch.signal.onsets import KurtosisOnset, STALTAOnset
from quakemigrate_torch.signal.onsets import kurtosis as onsets_kurtosis
from quakemigrate_torch.signal.onsets.base import slice_edges

import torch_front_end_host as host
import torch_synthetic as ws

torch.set_num_threads(1)

STALTA_RTOL = {np.float32: 1e-6, np.float64: 1e-12}
KURTOSIS_RTOL = {np.float32: 1e-5, np.float64: 1e-12}
ONSETS_RTOL = 1e-6
MIN_ONSET = 0.4
# Threads of a block in the source tests' shim (the kernels stride every
# loop by the block's size; the card runs 256)
THREADS = 32
# Stations of 1, 2 and 3 rows
OFFSETS = [0, 1, 3, 6]
EVENT_WINDOW = ("2021-02-18T12:00:24.0", "2021-02-18T12:00:40.0")


def _burst(dtype, t_len, n_rows=3, seed=0):
    """Rows of quiet noise with a burst 50,000 times louder in the middle
    (the running sums hold the burst's square when the quiet returns)."""

    rng = np.random.default_rng(seed + t_len)
    rows = 1e-3 * rng.normal(size=(n_rows, t_len))
    start = t_len // 2
    end = start + max(t_len // 20, 3)
    rows[:, start:end] += 50.0 * rng.normal(size=(n_rows, end - start))
    return rows.astype(dtype)


def _id(case):
    return "-".join(getattr(x, "__name__", str(x)) for x in case)


def _assert_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def exact_sqrt(monkeypatch):
    """torch.sqrt correctly rounded on the CPU (numpy's), as on the
    card."""

    monkeypatch.setattr(torch, "sqrt", lambda x: torch.from_numpy(
        np.sqrt(x.numpy())))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host.build_onsets(tmp_path_factory.mktemp("locate_onsets_host"))


# -- the plain versions against the JAX package ---------------------------------

# (t, nsta, nlta): a row shorter than nlta, one block, two, a segment and
# one, past 4,096
STALTA_SHAPES = [(40, 5, 60), (16, 3, 8), (17, 3, 8), (257, 7, 100),
                 (4100, 50, 1000), (5000, 25, 300)]
STALTA_CASES = [(dtype, *shape, position)
                for dtype in (np.float32, np.float64)
                for shape in STALTA_SHAPES
                for position in ("classic", "centred")]
_PLAIN = {"classic": stalta.overlapping_sta_lta_plain,
          "centred": stalta.centred_sta_lta_plain}
_JAX = {"classic": j_stalta.overlapping_sta_lta,
        "centred": j_stalta.centred_sta_lta}


@pytest.mark.parametrize("case", STALTA_CASES, ids=_id)
def test_sta_lta_plain_matches_jax(case):
    dtype, t_len, nsta, nlta, position = case
    x = _burst(dtype, t_len) ** 2
    got = _PLAIN[position](torch.from_numpy(x), nsta, nlta).numpy()
    want = np.asarray(_JAX[position](x, nsta, nlta))
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=STALTA_RTOL[dtype], atol=0)
    # the leading ones, and the routed function is the plain one on the CPU
    np.testing.assert_array_equal(got[:, :min(nlta - 1, t_len)], 1.0)
    routed = getattr(stalta, {"classic": "overlapping_sta_lta",
                              "centred": "centred_sta_lta"}[position])
    _assert_equal(routed(torch.from_numpy(x), nsta, nlta).numpy(), got)


KURTOSIS_CASES = [(dtype, t_len, nkurt, nsmooth)
                  for dtype in (np.float32, np.float64)
                  for t_len, nkurt in ((40, 60), (257, 26), (5000, 101))
                  for nsmooth in (1, 5, 6)]


@pytest.mark.parametrize("case", KURTOSIS_CASES, ids=_id)
def test_kurtosis_onset_plain_matches_jax(case):
    dtype, t_len, nkurt, nsmooth = case
    x = _burst(dtype, t_len)
    got = kurtosis.kurtosis_onset_plain(torch.from_numpy(x), nkurt,
                                        nsmooth).numpy()
    want = np.asarray(j_kurtosis.kurtosis_onset(x, nkurt, nsmooth))
    # JAX's smoothing kernel is float64 under x64, so its float32 smoothed
    # onset comes back in float64; the port's stays in the row's type
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=KURTOSIS_RTOL[dtype], atol=0)
    _assert_equal(kurtosis.kurtosis_onset(torch.from_numpy(x), nkurt,
                                          nsmooth).numpy(), got)


# -- ON1 and ON2's source, compiled for the CPU, against the plain versions ----

# Rows mode: (dtype, t, nsta, nlta): one block of the blocked scan, two, a
# tile of 4,096 and one, three levels; an LTA longer than the row
ROW_CASES = [(np.float32, 13, 3, 40), (np.float64, 16, 1, 16),
             (np.float32, 17, 2, 17), (np.float64, 257, 7, 300),
             (np.float32, 4100, 50, 1000), (np.float64, 4097, 600, 1000),
             (np.float32, 65537, 25, 9000)]


@pytest.mark.parametrize("case", ROW_CASES, ids=_id)
def test_on1_source_rows_equal_plain(host_lib, case):
    dtype, t_len, nsta, nlta = case
    x = _burst(dtype, t_len, seed=1) ** 2
    for position in ("classic", "centred"):
        want = _PLAIN[position](torch.from_numpy(x), nsta, nlta).numpy()
        got = host.on1(host_lib, x, nsta, nlta, position, "env",
                       threads=THREADS)
        _assert_equal(got, want)


@pytest.mark.parametrize("case", [(np.float32, 13, 40, 3),
                                  (np.float64, 257, 26, 6),
                                  (np.float32, 4100, 101, 5),
                                  (np.float64, 4097, 300, 12),
                                  (np.float32, 40_000, 250, 13)], ids=_id)
def test_on2_source_rows_equal_plain(host_lib, case):
    dtype, t_len, nkurt, nsmooth = case
    x = _burst(dtype, t_len, seed=2)
    for smooth in (1, nsmooth):
        want = kurtosis.kurtosis_onset_plain(torch.from_numpy(x), nkurt,
                                             smooth).numpy()
        got = host.on2(host_lib, x, nkurt, smooth, threads=THREADS)
        _assert_equal(got, want)


STATION_CASES = [(dtype, position, transform)
                 for dtype in (np.float32, np.float64)
                 for position in ("classic", "centred")
                 for transform in ("energy", "abs", "env", "env_squared")]


def _host_station_on1(lib, x, nsta, nlta, position, transform, edges,
                      threads=THREADS):
    """ON1's stations mode as its wrapper calls it: the envelope taken
    before the kernel for "env" and "env_squared" (then the identity or
    the square)."""

    mode = transform
    if transform in ("env", "env_squared"):
        x = _envelope(torch.from_numpy(x)).numpy()
        mode = "env" if transform == "env" else "energy"
    return host.on1(lib, x, nsta, nlta, position, mode, offsets=OFFSETS,
                    edges=edges, min_onset_value=MIN_ONSET, threads=threads)


@pytest.mark.parametrize("case", STATION_CASES, ids=_id)
def test_on1_source_stations_equal_plain(host_lib, exact_sqrt, case):
    dtype, position, transform = case
    x = _burst(dtype, 301, n_rows=6, seed=3)
    for edges in (None, (10, 290), (400, 0)):
        want = stalta.station_sta_lta_plain(
            torch.from_numpy(x), OFFSETS, 5, 60, position, transform, edges,
            MIN_ONSET).numpy()
        got = _host_station_on1(host_lib, x, 5, 60, position, transform,
                                edges)
        _assert_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nsmooth", [1, 5, 6])
def test_on2_source_stations_equal_plain(host_lib, exact_sqrt, dtype,
                                         nsmooth):
    x = _burst(dtype, 301, n_rows=6, seed=4)
    for edges in (None, (30, 300), (0, 150)):
        want = kurtosis.station_kurtosis_onset_plain(
            torch.from_numpy(x), OFFSETS, 26, nsmooth, edges,
            MIN_ONSET).numpy()
        got = host.on2(host_lib, x, 26, nsmooth, offsets=OFFSETS,
                       edges=edges, min_onset_value=MIN_ONSET,
                       threads=THREADS)
        _assert_equal(got, want)


def test_source_at_a_block_of_256_threads(host_lib, exact_sqrt):
    """The card's block size (ON_THREADS): the other cases run 32 threads
    a block to keep the shim quick."""

    x = _burst(np.float64, 5000, n_rows=6, seed=5)
    want = stalta.station_sta_lta_plain(torch.from_numpy(x), OFFSETS, 25,
                                        300, "centred", "energy", (40, 4900),
                                        MIN_ONSET).numpy()
    got = _host_station_on1(host_lib, x, 25, 300, "centred", "energy",
                            (40, 4900), threads=0)
    _assert_equal(got, want)
    want = kurtosis.station_kurtosis_onset_plain(
        torch.from_numpy(x), OFFSETS, 101, 12, (130, 4999), MIN_ONSET).numpy()
    got = host.on2(host_lib, x, 101, 12, offsets=OFFSETS, edges=(130, 4999),
                   min_onset_value=MIN_ONSET, threads=0)
    _assert_equal(got, want)


# -- the wrappers end to end, their launches sent to the compiled source --------

@pytest.fixture
def on_host(monkeypatch, host_lib, exact_sqrt):
    """The wrappers on CPU tensors: the device check passed and each
    launch run by the source compiled for the CPU (the tensors' pointers
    are host memory); the launch counts from 0."""

    def launch(name, device, *args):
        assert device.type == "cpu"
        host_lib.emu_set_threads(THREADS)
        assert getattr(host_lib, name)(*args, None) == 0, name

    monkeypatch.setattr(cuda_onsets, "_on_card", lambda *a: None)
    monkeypatch.setattr(cuda_onsets, "launch_kernel", launch)
    cuda_onsets.reset_launches()
    yield
    cuda_onsets.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrappers_equal_plain(on_host, dtype):
    x = torch.from_numpy(_burst(np.float64, 700, n_rows=6, seed=6)).to(dtype)
    energy = x * x
    for position in ("classic", "centred"):
        _assert_equal(cuda_onsets.sta_lta_cuda(energy, 7, 90, position),
                      _PLAIN[position](energy, 7, 90))
        # any leading shape, as the plain version
        _assert_equal(cuda_onsets.sta_lta_cuda(energy.reshape(2, 3, 700), 7,
                                               90, position),
                      _PLAIN[position](energy.reshape(2, 3, 700), 7, 90))
    _assert_equal(cuda_onsets.kurtosis_onset_cuda(x, 51, 6),
                  kurtosis.kurtosis_onset_plain(x, 51, 6))
    out = torch.full((5, 700), -5.0, dtype=dtype)
    for transform in ("energy", "env_squared"):
        got = cuda_onsets.station_sta_lta_cuda(
            x, OFFSETS, 7, 90, "centred", transform, (20, 680), MIN_ONSET,
            out=out[1:4])
        _assert_equal(got, stalta.station_sta_lta_plain(
            x, OFFSETS, 7, 90, "centred", transform, (20, 680), MIN_ONSET))
    got = cuda_onsets.station_kurtosis_onset_cuda(x, OFFSETS, 51, 5, None,
                                                  MIN_ONSET)
    _assert_equal(got, kurtosis.station_kurtosis_onset_plain(
        x, OFFSETS, 51, 5, None, MIN_ONSET))
    assert (out[0] == -5.0).all() and (out[4] == -5.0).all()
    assert cuda_onsets.launches == {"onset_stalta": 6, "onset_kurtosis": 2,
                                    "onset_stalta_v2": 0,
                                    "onset_kurtosis_v2": 0}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return ws.build_workspace(tmp_path_factory.mktemp("locate_onsets"))


def _data_both(workspace):
    from quakemigrate_tpu.io import Archive as JArchive
    from quakemigrate_tpu.seis import UTCDateTime as JUTCDateTime
    from quakemigrate_torch.io import Archive
    from quakemigrate_torch.lut import StationTable

    start, end = EVENT_WINDOW
    port = Archive(workspace["archive"],
                   StationTable.of(workspace["stations"]),
                   archive_format="YEAR/JD/STATION")
    jax = JArchive(archive_path=workspace["archive"],
                   stations=workspace["stations"],
                   archive_format="YEAR/JD/STATION")
    return (port.read_waveform_data(UTCDateTime(start), UTCDateTime(end)),
            jax.read_waveform_data(JUTCDateTime(start), JUTCDateTime(end)))


def _stalta_onsets(position, transform):
    port = ws.onset_settings(STALTAOnset(position=position,
                                         sampling_rate=ws.SPS))
    jax = ws.onset_settings(JSTALTAOnset(position=position,
                                         sampling_rate=ws.SPS))
    for onset in (port, jax):
        onset.signal_transform = transform
        onset.sta_lta_windows = {"P": [0.1, 1.0], "S": [0.3, 1.5]}
    return port, jax


def _kurtosis_onsets(smoothing):
    port = ws.kurtosis_settings(KurtosisOnset(sampling_rate=ws.SPS))
    jax = ws.kurtosis_settings(JKurtosisOnset(sampling_rate=ws.SPS))
    for onset in (port, jax):
        onset.kurtosis_windows = {"P": 0.5, "S": 1.0}
        onset.smoothing_window = smoothing
    return port, jax


ONSET_CASES = [("stalta", "classic", "abs", 4.0),
               ("stalta", "centred", "env", 4.0),
               ("stalta", "classic", "env_squared", None),
               ("kurtosis", None, 0.06, 4.0),
               ("kurtosis", None, 0.01, None)]


def _onsets_for(case):
    kind, position, setting, _ = case
    if kind == "stalta":
        return _stalta_onsets(position, setting)
    return _kurtosis_onsets(setting)


@pytest.mark.parametrize("case", ONSET_CASES, ids=_id)
def test_calculate_onsets_through_the_wrappers(workspace, on_host, case):
    """``calculate_onsets`` on CPU tensors routed to the wrappers (whose
    launches the compiled source runs): one launch a phase, every row
    equal bit for bit to the CPU path's."""

    port, _ = _onsets_for(case)
    timespan = case[3]
    data, _ = _data_both(workspace)
    want, _ = port.calculate_onsets(data, timespan=timespan, device="cpu")
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(stalta, "station_sta_lta",
                      cuda_onsets.station_sta_lta_cuda)
        patch.setattr(onsets_kurtosis, "station_kurtosis_onset",
                      cuda_onsets.station_kurtosis_onset_cuda)
        cuda_onsets.reset_launches()
        got, _ = port.calculate_onsets(data, timespan=timespan, device="cpu")
    _assert_equal(got.numpy(), want.numpy())
    key = "onset_stalta" if case[0] == "stalta" else "onset_kurtosis"
    assert cuda_onsets.launches[key] == 2 and sum(
        cuda_onsets.launches.values()) == 2


@pytest.mark.parametrize("case", ONSET_CASES, ids=_id)
def test_calculate_onsets_equal_jax(workspace, monkeypatch, case):
    """The CPU path: the stations mode's plain version, one call a phase,
    against the JAX package's ``calculate_onsets``."""

    port, jax = _onsets_for(case)
    timespan = case[3]
    port_data, jax_data = _data_both(workspace)
    module, name = ((stalta, "station_sta_lta_plain") if case[0] == "stalta"
                    else (kurtosis, "station_kurtosis_onset_plain"))
    calls = []
    plain = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(a[2])
                        or plain(*a, **k))
    got, got_data = port.calculate_onsets(port_data, timespan=timespan,
                                          device="cpu")
    want, want_data = jax.calculate_onsets(jax_data, timespan=timespan)
    assert len(calls) == 2
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=ONSETS_RTOL, atol=0)
    assert list(got_data.onsets) == list(want_data.onsets)
    for station, phases in want_data.onsets.items():
        for phase, row in phases.items():
            _assert_equal(got_data.onsets[station][phase],
                          got.numpy()[got_data.rows[f"{station}_{phase}"]])
    assert got_data.availability == want_data.availability


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("edges", [None, (25, 470)])
def test_combine_equals_the_per_station_formula(dtype, edges):
    """The combine adds each station's squares in row order and divides
    by a tensor: on the CPU the per-station formula it replaced
    (``torch.sqrt(torch.sum(rows ** 2, dim=0) / n)``, clamped) bit for
    bit, for stations of one to four rows."""

    onsets = torch.from_numpy(_burst(np.float64, 500, n_rows=10,
                                     seed=7)).to(dtype).abs() + 0.5
    offsets = [0, 1, 3, 6, 10]
    got = stalta.combine_stations(onsets, offsets, edges, MIN_ONSET)
    trimmed = onsets.clone()
    if edges is not None:
        trimmed[:, :edges[0]] = 1.0
        trimmed[:, edges[1]:] = 1.0
    for s, (a, b) in enumerate(zip(offsets[:-1], offsets[1:])):
        want = torch.clamp(torch.sqrt(torch.sum(trimmed[a:b] ** 2, dim=0)
                                      / (b - a)), min=MIN_ONSET)
        _assert_equal(got[s], want)


@pytest.mark.parametrize("n_samples", [0, 1, 5, 40])
def test_slice_edges_are_python_slices(n_samples):
    for head in range(-45, 46, 3):
        for tail in range(-45, 46, 3):
            row = np.zeros(n_samples)
            row[:head] = 1.0
            row[tail:] = 1.0
            lo, hi = slice_edges(n_samples, head, tail)
            idx = np.arange(n_samples)
            np.testing.assert_array_equal(row, (idx < lo) | (idx >= hi))


# -- refusals and routing -----------------------------------------------------

def _stalta_args(**change):
    args = dict(traces=torch.zeros(6, 301), offsets=OFFSETS, nsta=5, nlta=60,
                position="classic", transform="energy", edges=None,
                min_onset_value=MIN_ONSET)
    args.update(change)
    return args


def _kurtosis_args(**change):
    args = dict(traces=torch.zeros(6, 301), offsets=OFFSETS, nkurt=26,
                nsmooth=5, edges=None, min_onset_value=MIN_ONSET)
    args.update(change)
    return args


REFUSALS = [
    ("stalta", "cpu tensor", {}, ValueError, "CUDA tensors"),
    ("kurtosis", "cpu tensor", {}, ValueError, "CUDA tensors"),
    ("stalta", "float16", dict(traces=torch.zeros(6, 301,
                                                  dtype=torch.float16)),
     TypeError, "float32 or float64"),
    ("kurtosis", "int32", dict(traces=torch.zeros(6, 301,
                                                  dtype=torch.int32)),
     TypeError, "float32 or float64"),
    ("stalta", "empty rows", dict(traces=torch.zeros(6, 0)), ValueError,
     "at least one sample"),
    ("kurtosis", "1-d traces", dict(traces=torch.zeros(301)), ValueError,
     r"\[rows, T\]"),
    ("stalta", "nsta 0", dict(nsta=0), ValueError, "must be >= 1"),
    ("kurtosis", "nkurt 0", dict(nkurt=0), ValueError, "must be >= 1"),
    ("stalta", "position", dict(position="trailing"), ValueError,
     "position"),
    ("stalta", "transform", dict(transform="square"), ValueError,
     "transform"),
    ("stalta", "offsets short", dict(offsets=[0, 1, 3, 5]), ValueError,
     "offsets"),
    ("kurtosis", "empty station", dict(offsets=[0, 1, 1, 6]), ValueError,
     "offsets"),
    ("kurtosis", "one offset", dict(offsets=[0]), ValueError, "offsets"),
    ("stalta", "edges past the row", dict(edges=(0, 302)), ValueError,
     "edges"),
    ("kurtosis", "negative edge", dict(edges=(-1, 301)), ValueError,
     "edges"),
]


@pytest.mark.parametrize("refusal", REFUSALS, ids=lambda r: f"{r[0]}-{r[1]}")
def test_station_wrappers_refuse(monkeypatch, refusal):
    which, _, change, error, match = refusal
    monkeypatch.setattr(cuda_onsets, "launch_kernel",
                        lambda *a: pytest.fail("launched"))
    if which == "stalta":
        call, args = cuda_onsets.station_sta_lta_cuda, _stalta_args(**change)
    else:
        call = cuda_onsets.station_kurtosis_onset_cuda
        args = _kurtosis_args(**change)
    with pytest.raises(error, match=match):
        call(**args)


@pytest.mark.parametrize("change,match", [
    (dict(out=torch.zeros(3, 300)), "out must be"),
    (dict(out=torch.zeros(3, 301, dtype=torch.float64)), "out must be"),
    (dict(out=torch.zeros(301, 3).T), "out must be")])
def test_station_wrappers_refuse_an_output(monkeypatch, change, match):
    """Past the device check (patched here), the output is checked before
    anything launches."""

    monkeypatch.setattr(cuda_onsets, "_on_card", lambda *a: None)
    monkeypatch.setattr(cuda_onsets, "launch_kernel",
                        lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match=match):
        cuda_onsets.station_sta_lta_cuda(**_stalta_args(**change))
    with pytest.raises(ValueError, match=match):
        cuda_onsets.station_kurtosis_onset_cuda(**_kurtosis_args(**change))


@pytest.mark.parametrize("call,error,match", [
    (lambda: cuda_onsets.sta_lta_cuda(torch.zeros(3, 50), 5, 10, "classic"),
     ValueError, "CUDA tensors"),
    (lambda: cuda_onsets.sta_lta_cuda(torch.zeros(3, 50), 5, 0, "classic"),
     ValueError, "must be >= 1"),
    (lambda: cuda_onsets.sta_lta_cuda(torch.zeros(()), 5, 10, "centred"),
     ValueError, "at least one sample"),
    (lambda: cuda_onsets.sta_lta_cuda(torch.zeros(3, 50), 5, 10, "lead"),
     ValueError, "position"),
    (lambda: cuda_onsets.kurtosis_onset_cuda(torch.zeros(3, 50), 26),
     ValueError, "CUDA tensors"),
    (lambda: cuda_onsets.kurtosis_onset_cuda(
        torch.zeros(3, 50, dtype=torch.bfloat16), 26), TypeError,
     "float32 or float64"),
    (lambda: cuda_onsets.kurtosis_onset_cuda(torch.zeros(3, 50), -2),
     ValueError, "must be >= 1")])
def test_row_wrappers_refuse(monkeypatch, call, error, match):
    monkeypatch.setattr(cuda_onsets, "launch_kernel",
                        lambda *a: pytest.fail("launched"))
    with pytest.raises(error, match=match):
        call()


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """The routed functions, core.compat with device="cpu" and
    calculate_onsets' entries take the plain versions on CPU tensors:
    neither a wrapper (v1's or v2's) nor the launcher runs, and no launch
    is counted."""

    def refuse(*args, **kwargs):
        pytest.fail("a CPU tensor reached ops.cuda_onsets")

    for name in ("sta_lta_cuda", "station_sta_lta_cuda",
                 "kurtosis_onset_cuda", "station_kurtosis_onset_cuda",
                 "sta_lta_cuda_v2", "station_sta_lta_cuda_v2",
                 "kurtosis_onset_cuda_v2", "station_kurtosis_onset_cuda_v2",
                 "launch_kernel"):
        monkeypatch.setattr(cuda_onsets, name, refuse)
    cuda_onsets.reset_launches()
    x = torch.from_numpy(_burst(np.float64, 300, n_rows=6, seed=8))
    stalta.overlapping_sta_lta(x * x, 5, 50)
    stalta.centred_sta_lta(x * x, 5, 50)
    kurtosis.kurtosis_onset(x, 26, 5)
    stalta.station_sta_lta(x, OFFSETS, 5, 50, "classic", "abs", None,
                           MIN_ONSET)
    kurtosis.station_kurtosis_onset(x, OFFSETS, 26, 5, (3, 290), MIN_ONSET)
    signal = x.numpy()[0] ** 2
    for name, position in (("overlapping_sta_lta", "classic"),
                           ("centred_sta_lta", "centred")):
        got = getattr(compat, name)(signal, 5, 50, device="cpu")
        want = _PLAIN[position](torch.from_numpy(signal.astype(np.float32)),
                                5, 50).numpy()
        _assert_equal(got, want.astype(np.float64))
    assert set(cuda_onsets.launches.values()) == {0}


@pytest.mark.parametrize("t_len,kurtosis_", [(13, False), (16, True),
                                             (4100, False), (70_000, True)])
def test_unit_values_follow_the_levels(t_len, kurtosis_):
    """A unit's workspace: the running sums of each power at every sample
    and every level of the blocked scan (the source refuses less)."""

    levels, n = 0, t_len
    while True:
        n = -(-n // 16)
        levels += n
        if n <= 16:
            break
    powers = 4 if kurtosis_ else 1
    assert cuda_onsets.unit_values(t_len, kurtosis_) == (
        powers * (t_len + levels) + (t_len if kurtosis_ else 0))
