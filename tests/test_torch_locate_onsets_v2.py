# -*- coding: utf-8 -*-
"""
ON1 v2 and ON2 v2 (``csrc/locate_onsets_v2.cu``) on the CPU: the source
compiled for the CPU (``tests/torch_front_end_host.py``: a block's
threads as host threads, the grid's blocks in order, so long rows' tiles
take the launch's counter in order and a wait on a flag no earlier tile
set fails the launch) held bit for bit to the plain versions of
``ops.stalta`` and ``ops.kurtosis``, its wrappers' routing and refusals.

- Rows mode, float32 and float64, classic and centred, ``nsmooth`` 1, 5,
  6 and 12: rows shorter than every window (40), 255 / 256 / 257 (one
  level-1 group, two), 4,095 / 4,096 / 4,097 (the largest short row, the
  smallest long one), and 70,000 samples (more than 16 tiles: the scan
  publishes levels 3 and 4 across tiles). The short rows take no
  workspace (its size is 0), the long ones one filled with a byte pattern.
- Stations mode at locate's shape (13 stations, 1,474 samples; P one row
  a station, S two) and at stations of 1, 2 and 3 rows of 40 and of
  5,000 samples: the four transforms, the edges, classic and centred.
- The card's block of 256 threads (the other cases run 32 to keep the
  shim quick), and windows and smoothing longer than a pass or the row.
- One case per function against the JAX package directly, at the
  tolerances of ``tests/test_torch_locate_onsets.py``.
- The wrappers end to end on CPU tensors, their launches sent to the
  compiled source: equal to the plain versions, one launch a call;
  ``calculate_onsets`` through them, one launch a phase. No call ON1's or
  ON2's wrappers take is refused by v2's (rows past 2**29 samples on the
  meta device included, which ON2's workspace cannot index), and both
  refuse the same bad arguments. Tensors on the card reach the v2
  wrappers from every routed function and nothing else.

The combine's root is torch's, whose CPU form (MKL's) is not correctly
rounded, so these holds take numpy's ``sqrt``, as the card's is.

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops import kurtosis as j_kurtosis
from quakemigrate_tpu.ops import stalta as j_stalta
from quakemigrate_torch.ops import cuda_onsets, kurtosis, stalta
from quakemigrate_torch.ops.stalta import _envelope
from quakemigrate_torch.signal.onsets import kurtosis as onsets_kurtosis

import torch_front_end_host as host
from test_torch_locate_onsets import (
    KURTOSIS_RTOL,
    MIN_ONSET,
    OFFSETS,
    ONSET_CASES,
    REFUSALS,
    STALTA_RTOL,
    _burst,
    _data_both,
    _id,
    _kurtosis_args,
    _onsets_for,
    _stalta_args,
    exact_sqrt,  # noqa: F401 (a fixture)
    workspace,  # noqa: F401 (a fixture)
)

torch.set_num_threads(1)

THREADS = 32
_PLAIN = {"classic": stalta.overlapping_sta_lta_plain,
          "centred": stalta.centred_sta_lta_plain}


def _assert_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return host.build_onsets_v2(tmp_path_factory.mktemp("onsets_v2_host"))


# -- the compiled source against the plain versions ---------------------------

# (t, nsta, nlta, nkurt): shorter than every window; one group of level 1
# and two; the largest short row and the smallest long ones; 18 tiles
ROW_SHAPES = [(40, 5, 60, 60), (255, 7, 100, 26), (256, 7, 100, 26),
              (257, 7, 300, 26), (4095, 50, 1000, 101),
              (4096, 600, 1000, 101), (4097, 50, 1000, 300),
              (70_000, 25, 9000, 250)]
ROW_CASES = [(dtype, *shape) for dtype in (np.float32, np.float64)
             for shape in ROW_SHAPES]


@pytest.mark.parametrize("case", ROW_CASES, ids=_id)
def test_on1_v2_rows_equal_plain(lib, case):
    dtype, t_len, nsta, nlta, _ = case
    x = _burst(dtype, t_len, seed=11) ** 2
    need = lib.qm_onset_v2_workspace_bytes(0, 3, 3, t_len, x.itemsize)
    assert (need == 0) == (t_len <= 4096)
    for position in ("classic", "centred"):
        want = _PLAIN[position](torch.from_numpy(x), nsta, nlta).numpy()
        got = host.on1_v2(lib, x, nsta, nlta, position, "env",
                          threads=THREADS)
        _assert_equal(got, want)


@pytest.mark.parametrize("case", ROW_CASES, ids=_id)
def test_on2_v2_rows_equal_plain(lib, case):
    dtype, t_len, _, _, nkurt = case
    x = _burst(dtype, t_len, seed=12)
    for nsmooth in (1, 5, 6, 12):
        want = kurtosis.kurtosis_onset_plain(torch.from_numpy(x), nkurt,
                                             nsmooth).numpy()
        got = host.on2_v2(lib, x, nkurt, nsmooth, threads=THREADS)
        _assert_equal(got, want)


def _host_station_on1(lib, x, offsets, nsta, nlta, position, transform,
                      edges, threads=THREADS):
    """ON1 v2's stations mode as its wrapper calls it: the envelope taken
    before the kernel for "env" and "env_squared" (then the identity or
    the square)."""

    mode = transform
    if transform in ("env", "env_squared"):
        x = _envelope(torch.from_numpy(x)).numpy()
        mode = "env" if transform == "env" else "energy"
    return host.on1_v2(lib, x, nsta, nlta, position, mode, offsets=offsets,
                       edges=edges, min_onset_value=MIN_ONSET,
                       threads=threads)


# Locate's phases at Icequake: 13 stations of 1,474 samples, P one row a
# station and S two (archive_locate's windows at 250 Hz: STA 4 / 14, LTA
# 63 / 126 samples; kurtosis_detect's 126 / 251)
LOCATE = {"P": (1, 4, 63, 126), "S": (2, 14, 126, 251)}
LOCATE_CASES = [(dtype, phase) for dtype in (np.float32, np.float64)
                for phase in ("P", "S")]


@pytest.mark.parametrize("case", LOCATE_CASES, ids=_id)
def test_v2_locate_phases_equal_plain(lib, exact_sqrt, case):
    dtype, phase = case
    per, nsta, nlta, nkurt = LOCATE[phase]
    offsets = [s * per for s in range(14)]
    x = _burst(dtype, 1474, n_rows=13 * per, seed=13)
    for position in ("classic", "centred"):
        for transform in ("energy", "abs", "env", "env_squared"):
            want = stalta.station_sta_lta_plain(
                torch.from_numpy(x), offsets, nsta, nlta, position,
                transform, (20, 1450), MIN_ONSET).numpy()
            got = _host_station_on1(lib, x, offsets, nsta, nlta, position,
                                    transform, (20, 1450))
            _assert_equal(got, want)
    for nsmooth in (1, 12):
        want = kurtosis.station_kurtosis_onset_plain(
            torch.from_numpy(x), offsets, nkurt, nsmooth, (nkurt + 20, 1473),
            MIN_ONSET).numpy()
        got = host.on2_v2(lib, x, nkurt, nsmooth, offsets=offsets,
                          edges=(nkurt + 20, 1473),
                          min_onset_value=MIN_ONSET, threads=THREADS)
        _assert_equal(got, want)


STATION_CASES = [(dtype, t_len, position)
                 for dtype in (np.float32, np.float64)
                 for t_len in (40, 5000)
                 for position in ("classic", "centred")]


@pytest.mark.parametrize("case", STATION_CASES, ids=_id)
def test_v2_stations_equal_plain(lib, exact_sqrt, case):
    """Stations of 1, 2 and 3 rows, short (shorter than every window) and
    long (two tiles), every transform and edges."""

    dtype, t_len, position = case
    x = _burst(dtype, t_len, n_rows=6, seed=14)
    for transform in ("energy", "abs", "env", "env_squared"):
        for edges in (None, (10, t_len - 11), (t_len + 5, 0)):
            want = stalta.station_sta_lta_plain(
                torch.from_numpy(x), OFFSETS, 25, 300, position, transform,
                edges, MIN_ONSET).numpy()
            got = _host_station_on1(lib, x, OFFSETS, 25, 300, position,
                                    transform, edges)
            _assert_equal(got, want)
    for nsmooth in (1, 5, 6, 12):
        edges = (30, t_len - 1) if nsmooth % 2 else None
        want = kurtosis.station_kurtosis_onset_plain(
            torch.from_numpy(x), OFFSETS, 101, nsmooth, edges,
            MIN_ONSET).numpy()
        got = host.on2_v2(lib, x, 101, nsmooth, offsets=OFFSETS, edges=edges,
                          min_onset_value=MIN_ONSET, threads=THREADS)
        _assert_equal(got, want)


def test_v2_at_a_block_of_256_threads(lib, exact_sqrt):
    """The card's block size (OV_THREADS), a short and a long row."""

    for t_len in (1474, 9000):
        x = _burst(np.float64, t_len, n_rows=6, seed=15)
        want = stalta.station_sta_lta_plain(
            torch.from_numpy(x), OFFSETS, 25, 300, "centred", "energy",
            (40, t_len - 100), MIN_ONSET).numpy()
        got = _host_station_on1(lib, x, OFFSETS, 25, 300, "centred",
                                "energy", (40, t_len - 100), threads=0)
        _assert_equal(got, want)
        want = kurtosis.station_kurtosis_onset_plain(
            torch.from_numpy(x), OFFSETS, 101, 12, (130, t_len - 1),
            MIN_ONSET).numpy()
        got = host.on2_v2(lib, x, 101, 12, offsets=OFFSETS,
                          edges=(130, t_len - 1), min_onset_value=MIN_ONSET,
                          threads=0)
        _assert_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("t_len", [17, 1000, 9001])
def test_v2_windows_past_a_pass_or_the_row(lib, dtype, t_len):
    """Windows and smoothing longer than the row, than a tile (a long
    row's outputs lag: the centred STA and the taps read two tiles ahead)
    or than a pass of taps (64), and negative zeros in the samples as
    they are (the rule's added zeros make them positive)."""

    rng = np.random.default_rng(16 + t_len)
    x = rng.normal(size=(2, t_len)).astype(dtype)
    x[:, :t_len // 3] = -0.0
    for nsta, nlta in ((1, 1), (t_len + 5, 3), (2, t_len + 9), (700, 5000)):
        for position in ("classic", "centred"):
            want = _PLAIN[position](torch.from_numpy(x), nsta, nlta).numpy()
            got = host.on1_v2(lib, x, nsta, nlta, position, "env",
                              threads=THREADS)
            _assert_equal(got, want)
            assert np.array_equal(np.signbit(got), np.signbit(want))
    for nkurt, nsmooth in ((2, 2), (t_len + 3, 3), (9, 129), (30, 5000)):
        want = kurtosis.kurtosis_onset_plain(torch.from_numpy(x), nkurt,
                                             nsmooth).numpy()
        got = host.on2_v2(lib, x, nkurt, nsmooth, threads=THREADS)
        _assert_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_v2_source_against_jax(lib, dtype):
    """The compiled source against the JAX functions directly, a short and
    a long row (tolerances as the plain versions' against JAX)."""

    for t_len in (1474, 9000):
        x = _burst(dtype, t_len, seed=17)
        energy = x ** 2
        for position, fn in (("classic", j_stalta.overlapping_sta_lta),
                             ("centred", j_stalta.centred_sta_lta)):
            got = host.on1_v2(lib, energy, 25, 300, position, "env",
                              threads=THREADS)
            np.testing.assert_allclose(got, np.asarray(fn(energy, 25, 300)),
                                       rtol=STALTA_RTOL[dtype], atol=0)
        got = host.on2_v2(lib, x, 101, 6, threads=THREADS)
        np.testing.assert_allclose(
            got, np.asarray(j_kurtosis.kurtosis_onset(x, 101, 6)),
            rtol=KURTOSIS_RTOL[dtype], atol=0)


# -- the wrappers end to end, their launches sent to the compiled source ------

@pytest.fixture
def on_host(monkeypatch, lib, exact_sqrt):
    """The v2 wrappers on CPU tensors: the device check passed, the
    workspace sized and each launch run by the source compiled for the CPU
    (the tensors' pointers are host memory); the launch counts from 0."""

    def launch(name, device, *args):
        assert device.type == "cpu"
        lib.emu_set_threads(THREADS)
        assert getattr(lib, name)(*args, None) == 0, name

    monkeypatch.setattr(cuda_onsets, "_on_card", lambda *a: None)
    monkeypatch.setattr(cuda_onsets, "launch_kernel", launch)
    monkeypatch.setattr(cuda_onsets, "_workspace_bytes_v2",
                        lambda *a: lib.qm_onset_v2_workspace_bytes(*a))
    cuda_onsets.reset_launches()
    yield
    cuda_onsets.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t_len", [700, 5000])
def test_v2_wrappers_equal_plain(on_host, dtype, t_len):
    x = torch.from_numpy(_burst(np.float64, t_len, n_rows=6,
                                seed=18)).to(dtype)
    energy = x * x
    for position in ("classic", "centred"):
        _assert_equal(cuda_onsets.sta_lta_cuda_v2(energy, 7, 90, position),
                      _PLAIN[position](energy, 7, 90))
        # any leading shape, as the plain version
        _assert_equal(cuda_onsets.sta_lta_cuda_v2(
            energy.reshape(2, 3, t_len), 7, 90, position),
            _PLAIN[position](energy.reshape(2, 3, t_len), 7, 90))
    _assert_equal(cuda_onsets.kurtosis_onset_cuda_v2(x, 51, 6),
                  kurtosis.kurtosis_onset_plain(x, 51, 6))
    out = torch.full((5, t_len), -5.0, dtype=dtype)
    edges = (20, t_len - 20)
    for transform in ("energy", "env_squared"):
        got = cuda_onsets.station_sta_lta_cuda_v2(
            x, OFFSETS, 7, 90, "centred", transform, edges, MIN_ONSET,
            out=out[1:4])
        _assert_equal(got, stalta.station_sta_lta_plain(
            x, OFFSETS, 7, 90, "centred", transform, edges, MIN_ONSET))
    got = cuda_onsets.station_kurtosis_onset_cuda_v2(x, OFFSETS, 51, 5, None,
                                                     MIN_ONSET)
    _assert_equal(got, kurtosis.station_kurtosis_onset_plain(
        x, OFFSETS, 51, 5, None, MIN_ONSET))
    assert (out[0] == -5.0).all() and (out[4] == -5.0).all()
    assert cuda_onsets.launches == {"onset_stalta": 0, "onset_kurtosis": 0,
                                    "onset_stalta_v2": 6,
                                    "onset_kurtosis_v2": 2}


@pytest.mark.parametrize("case", ONSET_CASES, ids=_id)
def test_calculate_onsets_through_the_v2_wrappers(workspace, on_host, case):
    """``calculate_onsets`` on CPU tensors routed to the v2 wrappers
    (whose launches the compiled source runs): one launch a phase, every
    row equal bit for bit to the CPU path's."""

    port, _ = _onsets_for(case)
    timespan = case[3]
    data, _ = _data_both(workspace)
    want, _ = port.calculate_onsets(data, timespan=timespan, device="cpu")
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(stalta, "station_sta_lta",
                      cuda_onsets.station_sta_lta_cuda_v2)
        patch.setattr(onsets_kurtosis, "station_kurtosis_onset",
                      cuda_onsets.station_kurtosis_onset_cuda_v2)
        cuda_onsets.reset_launches()
        got, _ = port.calculate_onsets(data, timespan=timespan, device="cpu")
    _assert_equal(got.numpy(), want.numpy())
    key = ("onset_stalta_v2" if case[0] == "stalta"
           else "onset_kurtosis_v2")
    assert cuda_onsets.launches[key] == 2 and sum(
        cuda_onsets.launches.values()) == 2


# -- refusals and routing -----------------------------------------------------

@pytest.mark.parametrize("refusal", REFUSALS, ids=lambda r: f"{r[0]}-{r[1]}")
def test_v2_station_wrappers_refuse_as_v1(monkeypatch, refusal):
    """The v2 wrappers refuse what ON1's and ON2's refuse, with the same
    message, before anything launches."""

    which, _, change, error, match = refusal
    monkeypatch.setattr(cuda_onsets, "launch_kernel",
                        lambda *a: pytest.fail("launched"))
    if which == "stalta":
        call = cuda_onsets.station_sta_lta_cuda_v2
        args = _stalta_args(**change)
    else:
        call = cuda_onsets.station_kurtosis_onset_cuda_v2
        args = _kurtosis_args(**change)
    with pytest.raises(error, match=match):
        call(**args)


def _meta(rows, t_len, dtype=torch.float32):
    return torch.empty(rows, t_len, dtype=dtype, device="meta")


# Calls of the four wrapper pairs, each on meta tensors (no memory) past
# the device check: rows of 1 to 2**29 + 1 samples, windows longer than the
# row, stations of several rows
PARITY_CALLS = [
    ("sta_lta", (_meta(3, 40), 5, 60, "classic")),
    ("sta_lta", (_meta(2, 4097), 4097, 1, "centred")),
    ("sta_lta", (_meta(1, 2**29 + 1), 2**20, 2**28, "centred")),
    ("sta_lta", (_meta(1, 1), 1, 1, "classic")),
    ("kurtosis_onset", (_meta(3, 70_000, torch.float64), 250, 12)),
    ("kurtosis_onset", (_meta(1, 2**29 + 1), 300, 2**20)),
    ("kurtosis_onset", (_meta(2, 16), 40, 0)),
    ("station_sta_lta", (_meta(6, 1474), OFFSETS, 14, 126, "centred",
                         "abs", (20, 1450), 0.4)),
    ("station_sta_lta", (_meta(3, 2**28), [0, 3], 250, 2500, "classic",
                         "energy", None, 0.4)),
    ("station_kurtosis_onset", (_meta(6, 1474, torch.float64), OFFSETS,
                                251, 12, (270, 1473), 0.4)),
    ("station_kurtosis_onset", (_meta(2, 2**29 + 1), [0, 1, 2], 100, 7,
                                None, 0.4)),
]


@pytest.mark.parametrize("call", PARITY_CALLS,
                         ids=lambda c: f"{c[0]}-{tuple(c[1][0].shape)}")
def test_v2_wrappers_take_what_v1_takes(monkeypatch, lib, call):
    """No call that ON1's or ON2's wrapper takes is refused by v2's: each
    launches once (the launch recorded, the workspace sized by the
    source's own layout); where v1 refuses (a workspace past 2**31
    values a unit), v2 takes it all the same."""

    name, args = call
    launched = []
    monkeypatch.setattr(cuda_onsets, "_on_card", lambda *a: None)
    monkeypatch.setattr(cuda_onsets, "launch_kernel",
                        lambda entry, device, *a: launched.append(entry))
    monkeypatch.setattr(cuda_onsets, "_workspace_bytes_v2",
                        lambda *a: lib.qm_onset_v2_workspace_bytes(*a))
    try:
        getattr(cuda_onsets, f"{name}_cuda")(*args)
        v1_took = True
    except ValueError as err:
        assert "workspace values a unit" in str(err)
        v1_took = False
    getattr(cuda_onsets, f"{name}_cuda_v2")(*args)
    assert launched[-1].endswith(("_v2_f32", "_v2_f64"))
    assert len(launched) == 1 + v1_took
    assert v1_took or name.endswith("kurtosis_onset")


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as lying on the card."""

    @property
    def is_cuda(self):
        return True


def test_tensors_on_the_card_reach_the_v2_wrappers(monkeypatch):
    """Every routed function sends a tensor on the card to its v2 wrapper,
    one call, and to neither v1's wrapper nor the plain version."""

    calls = []

    def record(name):
        return lambda *a, **k: calls.append(name) or "v2"

    def refuse(*a, **k):
        pytest.fail("a tensor on the card reached v1 or the plain chain")

    for name in ("sta_lta_cuda_v2", "station_sta_lta_cuda_v2",
                 "kurtosis_onset_cuda_v2", "station_kurtosis_onset_cuda_v2"):
        monkeypatch.setattr(cuda_onsets, name, record(name))
    for name in ("sta_lta_cuda", "station_sta_lta_cuda",
                 "kurtosis_onset_cuda", "station_kurtosis_onset_cuda",
                 "launch_kernel"):
        monkeypatch.setattr(cuda_onsets, name, refuse)
    for module, name in ((stalta, "overlapping_sta_lta_plain"),
                         (stalta, "centred_sta_lta_plain"),
                         (stalta, "station_sta_lta_plain"),
                         (kurtosis, "kurtosis_onset_plain"),
                         (kurtosis, "station_kurtosis_onset_plain")):
        monkeypatch.setattr(module, name, refuse)
    x = torch.zeros(6, 300).as_subclass(_OnCard)
    assert stalta.overlapping_sta_lta(x, 5, 50) == "v2"
    assert stalta.centred_sta_lta(x, 5, 50) == "v2"
    assert kurtosis.kurtosis_onset(x, 26, 5) == "v2"
    assert stalta.station_sta_lta(x, OFFSETS, 5, 50, "classic", "abs", None,
                                  MIN_ONSET) == "v2"
    assert kurtosis.station_kurtosis_onset(x, OFFSETS, 26, 5, (3, 290),
                                           MIN_ONSET) == "v2"
    assert calls == ["sta_lta_cuda_v2", "sta_lta_cuda_v2",
                     "kurtosis_onset_cuda_v2", "station_sta_lta_cuda_v2",
                     "station_kurtosis_onset_cuda_v2"]


def test_short_rows_need_no_workspace(lib):
    """Rows of at most 4,096 samples launch without a workspace (no
    memset); longer rows take one that grows with the rows' level-1
    values."""

    for kurtosis_ in (0, 1):
        for t_len in (1, 1474, 4096):
            assert lib.qm_onset_v2_workspace_bytes(kurtosis_, 13, 26, t_len,
                                                   8) == 0
        small = lib.qm_onset_v2_workspace_bytes(kurtosis_, 2, 3, 4097, 4)
        large = lib.qm_onset_v2_workspace_bytes(kurtosis_, 2, 3, 70_000, 4)
        assert 0 < small < large
        assert lib.qm_onset_v2_workspace_bytes(kurtosis_, 2, 1, 500, 4) == -1
