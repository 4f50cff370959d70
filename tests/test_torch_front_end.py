# -*- coding: utf-8 -*-
"""
The onset front ends of detect's fused window on the CPU: the plain
versions of ops.scan_window (the kernels' contracts) against the JAX
package, the kernels' own sources against those plain versions, and the
wrappers' refusals and routing.

- ``fused_onsets`` (classic and centred; energy, abs, env, env_squared)
  and ``fused_kurtosis_onsets`` (``nsmooth`` 1 and 5) against JAX's on
  the same numpy-seeded blocks: float32 within 1e-5 relative, float64
  within 1e-9; per-slot windows that differ by phase, a dead channel and
  a dead slot, T = 2,038 and T = 301 (neither a multiple of 16); and
  through ``kurtosis_front_end`` at 80,000 samples, longer than FE2 could
  stage.
- The window through ``detect_window`` with the front ends' factories
  against JAX's ``detect_window_fused`` and
  ``detect_window_fused_kurtosis`` at a small grid.
- ``csrc/front_end.cu`` (FE1, FE2) and ``csrc/front_end_v2.cu`` (FE1 v2,
  FE2 v2) compiled for the CPU (tests/torch_front_end_host.py) against
  the plain versions, bit for bit, on the same cases and on rows of 13,
  16, 17, 257 and 4,100 samples (one to three levels of the blocked
  scan), window lengths longer than the row and 30,000 samples; FE1 v2
  and FE2 v2 also across their 256-sample segments (rows of 16^k +- 1
  samples, windows longer than a segment, a centred STA reaching the
  segments ahead, a smoothing longer than a segment), at a block of 256
  threads as on the card, and on long rows (FE2 v2 at 100,000 samples in
  float32 and 40,000 in float64, FE1 v2 at 150,000 in float64). torch's
  CPU ``sqrt`` (MKL's) is not correctly rounded (1 ulp off in about 0.3 %
  of the samples) and the card's is, so these comparisons take the plain
  version with numpy's ``sqrt``, which is.
- The wrappers' refusals (a CPU tensor, another dtype, bad shapes,
  window lengths below 1; for FE1 and FE2 a row too long to stage) and
  the routing: a CPU block never reaches ``ops.cuda_front_end``'s
  launcher.

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops import scan_window as j_scan_window
from quakemigrate_tpu.ops import stalta as j_stalta
from quakemigrate_torch.ops import cuda_front_end, cuda_migrate
from quakemigrate_torch.ops import scan_window, stalta
from quakemigrate_torch.ops.scan_window import (
    detect_window,
    fused_kurtosis_onsets,
    fused_onsets,
    kurtosis_front_end,
    stalta_front_end,
)
from quakemigrate_torch.ops.stalta import _envelope

import torch_front_end_host as host

torch.set_num_threads(1)

RTOL = {np.float32: 1e-5, np.float64: 1e-9}
WINDOW_RTOL = {np.float32: 2e-6, np.float64: 1e-9}
N_STATIONS = 3
C_MAX = 3
MIN_ONSET = 0.4
# Per-slot window lengths, P slots then S slots
NSTA = (5, 12)
NLTA = (60, 130)
NKURT = (26, 51)
# Threads of a block in the v2 source tests' shim (the kernels stride every
# loop by the block's size; the card runs 256)
V2_THREADS = 32


def make_block(dtype, t_len, seed=7, lengths=(NSTA, NLTA)):
    """A block of N_STATIONS x P/S slots of C_MAX channels, made from a
    numpy seed: noise with an arrival in the middle, channel 2 of slot 1
    dead, slot 4 dead; then a window-length array a pair of ``lengths``
    (P's, S's), per slot."""

    rng = np.random.default_rng(seed)
    n_slots = 2 * N_STATIONS
    channels = rng.normal(size=(n_slots, C_MAX, t_len))
    mid = t_len // 2
    channels[:, :, mid:mid + 40] *= 12.0
    channels = channels.astype(dtype)
    chan_mask = np.ones((n_slots, C_MAX), dtype)
    slot_mask = np.ones(n_slots, dtype)
    chan_mask[1, 2] = 0.0
    channels[1, 2] = 0.0
    slot_mask[4] = 0.0
    chan_mask[4] = 0.0
    channels[4] = 0.0
    per_slot = [np.repeat(np.array(pair, np.int32), N_STATIONS)
                for pair in lengths]
    return (channels, chan_mask, slot_mask, *per_slot)


def _torch(block):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in block]


def _assert_close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


STALTA_CASES = [
    (dtype, t_len, position, transform)
    for dtype in (np.float32, np.float64)
    for t_len in (2038, 301)
    for position in ("classic", "centred")
    for transform in ("energy", "abs", "env", "env_squared")
]
KURTOSIS_CASES = [
    (dtype, t_len, nsmooth, taper_pad)
    for dtype in (np.float32, np.float64)
    for t_len in (2038, 301)
    for nsmooth, taper_pad in ((1, 0), (5, 20))
]


def _id(case):
    return "-".join(getattr(x, "__name__", str(x)) for x in case)


# -- the plain front ends against the JAX package -----------------------------

@pytest.mark.parametrize("case", STALTA_CASES, ids=_id)
def test_fused_onsets_match_jax(monkeypatch, case):
    """In float32 the two packages' FFTs (torch's and XLA's) give
    envelopes that differ by ~3e-7 of the row's largest value, which the
    STA/LTA of small envelope values magnifies to ~2e-4; so for "env" and
    "env_squared" in float32 the envelopes are held to each other within
    1e-6 of the row's largest, and the front end is held to JAX's within
    RTOL from JAX's envelope."""

    dtype, t_len, position, transform = case
    block = make_block(dtype, t_len)
    if dtype == np.float32 and transform.startswith("env"):
        rows = block[0].reshape(-1, t_len)
        got = _envelope(torch.from_numpy(rows)).numpy()
        want = np.asarray(j_stalta._envelope(rows))
        scale = np.maximum(np.abs(want).max(axis=1, keepdims=True),
                           np.finfo(dtype).tiny)
        assert (np.abs(got - want) / scale).max() <= 1e-6
        monkeypatch.setattr(stalta, "_envelope", lambda data: torch.from_numpy(
            np.asarray(j_stalta._envelope(data.numpy()))))
    got, got_avail = fused_onsets(*_torch(block), position, transform,
                                  MIN_ONSET)
    want, want_avail = j_scan_window.fused_onsets(*block, position,
                                                  transform, MIN_ONSET)
    assert got.dtype == getattr(torch, np.dtype(dtype).name)
    _assert_close(got.numpy(), want, RTOL[dtype])
    assert float(got_avail) == float(want_avail) == 5.0
    assert (got.numpy()[4] == 1.0).all()


@pytest.mark.parametrize("case", KURTOSIS_CASES, ids=_id)
def test_fused_kurtosis_onsets_match_jax(case):
    dtype, t_len, nsmooth, taper_pad = case
    block = make_block(dtype, t_len, lengths=(NKURT,))
    got, got_avail = fused_kurtosis_onsets(*_torch(block), nsmooth,
                                           taper_pad, MIN_ONSET)
    want, want_avail = j_scan_window.fused_kurtosis_onsets(
        *block, nsmooth, taper_pad, MIN_ONSET)
    _assert_close(got.numpy(), want, RTOL[dtype])
    assert float(got_avail) == float(want_avail) == 5.0
    assert (got.numpy()[4] == 1.0).all()


def _grid(block, seed):
    n_slots, t_len = block[0].shape[0], block[0].shape[-1]
    node_count, fsmp, nsamples = (5, 4, 3), t_len // 8, t_len // 2
    rng = np.random.default_rng(seed)
    tt = rng.integers(0, t_len - fsmp - nsamples,
                      size=(int(np.prod(node_count)), n_slots)).astype(
                          np.int32)
    return tt, fsmp, nsamples


@pytest.mark.parametrize("kind", ["stalta", "kurtosis"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_window_through_the_factories_matches_jax(kind, dtype):
    """``detect_window`` with the factories' front end on a CPU block
    (the plain versions) against JAX's fused windows."""

    if kind == "stalta":
        block = make_block(dtype, 2038)
        settings = ("centred", "energy", MIN_ONSET)
        front_end = stalta_front_end(*settings)
        j_window = j_scan_window.detect_window_fused
    else:
        block = make_block(dtype, 2038, lengths=(NKURT,))
        settings = (5, 20, MIN_ONSET)
        front_end = kurtosis_front_end(*settings)
        j_window = j_scan_window.detect_window_fused_kurtosis
    tt, fsmp, nsamples = _grid(block, 3)
    got = [x.numpy() for x in detect_window(
        front_end, _torch(block), torch.from_numpy(tt), fsmp, nsamples)]
    want = [np.asarray(x) for x in j_window(*block, tt, *settings, fsmp,
                                            nsamples)]
    _assert_close(got[0], want[0], WINDOW_RTOL[dtype])
    _assert_close(got[1], want[1], WINDOW_RTOL[dtype])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("dtype,t_len", [(np.float32, 80_000),
                                         (np.float64, 40_000)])
def test_kurtosis_front_end_beyond_fe2s_stage_matches_jax(dtype, t_len):
    """``kurtosis_front_end`` on windows longer than FE2 could stage with
    three channels (72,608 float32 samples, 36,320 float64), which FE2 v2
    takes: on a CPU block the plain version, which the v2 source tests
    hold FE2 v2 to bit for bit, against JAX's ``fused_kurtosis_onsets``
    on two slots."""

    block = _long_block(dtype, t_len, 250, 2500, 11)
    kurt = block[:3] + (block[4],)
    got, got_avail = kurtosis_front_end(12, 20, MIN_ONSET)(*_torch(kurt))
    want, want_avail = j_scan_window.fused_kurtosis_onsets(*kurt, 12, 20,
                                                           MIN_ONSET)
    _assert_close(got.numpy(), want, RTOL[dtype])
    assert float(got_avail) == float(want_avail) == 2.0


# -- FE1 and FE2's source, compiled for the CPU, against the plain versions ---

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host.build(tmp_path_factory.mktemp("front_end_host"))


@pytest.fixture(scope="module")
def host_lib_v2(tmp_path_factory):
    return host.build_v2(tmp_path_factory.mktemp("front_end_v2_host"))


@pytest.fixture
def exact_sqrt(monkeypatch):
    """torch.sqrt correctly rounded on the CPU (numpy's), as on the
    card."""

    monkeypatch.setattr(torch, "sqrt", lambda x: torch.from_numpy(
        np.sqrt(x.numpy())))


def _host_fe1(lib, block, position, transform, fe1=host.fe1, **kwargs):
    x = block[0]
    if transform in ("env", "env_squared"):
        n_slots, c_max, t_len = x.shape
        x = _envelope(torch.from_numpy(x.reshape(-1, t_len))).numpy().reshape(
            x.shape)
    return fe1(lib, x, *block[1:], position, transform, MIN_ONSET, **kwargs)


def _assert_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", STALTA_CASES, ids=_id)
def test_fe1_source_equals_plain(host_lib, exact_sqrt, case):
    dtype, t_len, position, transform = case
    block = make_block(dtype, t_len)
    want, want_avail = fused_onsets(*_torch(block), position, transform,
                                    MIN_ONSET)
    got, got_avail = _host_fe1(host_lib, block, position, transform)
    _assert_equal(got, want.numpy())
    assert got_avail == float(want_avail)


@pytest.mark.parametrize("case", KURTOSIS_CASES, ids=_id)
def test_fe2_source_equals_plain(host_lib, exact_sqrt, case):
    dtype, t_len, nsmooth, taper_pad = case
    block = make_block(dtype, t_len, lengths=(NKURT,))
    want, want_avail = fused_kurtosis_onsets(*_torch(block), nsmooth,
                                             taper_pad, MIN_ONSET)
    got, got_avail = host.fe2(host_lib, *block, nsmooth, taper_pad,
                              MIN_ONSET)
    _assert_equal(got, want.numpy())
    assert got_avail == float(want_avail)


# Rows of one block (T <= 16: no outer sum), one level, two, three; window
# lengths of 1 and longer than the row; even smoothing
EDGE_CASES = [
    (np.float32, 13, (1, 2), (3, 40), 4),
    (np.float32, 16, (1, 16), (16, 17), 2),
    (np.float64, 17, (2, 3), (17, 9), 3),
    (np.float32, 257, (7, 300), (256, 400), 6),
    (np.float64, 4100, (50, 9), (1000, 5000), 5),
    (np.float32, 30000, (25, 50), (250, 500), 13),
]


@pytest.mark.parametrize("case", EDGE_CASES, ids=_id)
def test_front_end_source_edges(host_lib, exact_sqrt, case):
    dtype, t_len, nsta, nlta, nsmooth = case
    block = make_block(dtype, t_len, seed=t_len, lengths=(nsta, nlta))
    for position in ("classic", "centred"):
        want, _ = fused_onsets(*_torch(block), position, "energy", MIN_ONSET)
        got, _ = _host_fe1(host_lib, block, position, "energy")
        _assert_equal(got, want.numpy())
    kurt_block = block[:3] + (block[4],)
    want, _ = fused_kurtosis_onsets(*_torch(kurt_block), nsmooth, 3,
                                    MIN_ONSET)
    got, _ = host.fe2(host_lib, *kurt_block, nsmooth, 3, MIN_ONSET)
    _assert_equal(got, want.numpy())


def test_front_end_source_gives_nan_for_a_length_below_one(host_lib):
    """Window lengths on the card are not read back: a live slot whose
    length is below 1 gets NaN (nothing of its row read), a dead slot 1."""

    block = list(make_block(np.float32, 301))
    block[3] = block[3].copy()
    block[3][[0, 4]] = 0
    got, available = _host_fe1(host_lib, block, "classic", "energy")
    assert np.isnan(got[0]).all() and (got[4] == 1.0).all()
    assert np.isfinite(got[[1, 2, 3, 5]]).all() and available == 5.0
    kurt = [*block[:3], np.array([-3, 26, 26, 51, 0, 51], np.int32)]
    got, _ = host.fe2(host_lib, *kurt, 5, 0, MIN_ONSET)
    assert np.isnan(got[0]).all() and (got[4] == 1.0).all()
    assert np.isfinite(got[[1, 2, 3, 5]]).all()


@pytest.mark.parametrize("case", STALTA_CASES, ids=_id)
def test_fe1_v2_source_equals_plain(host_lib_v2, exact_sqrt, case):
    dtype, t_len, position, transform = case
    block = make_block(dtype, t_len)
    want, want_avail = fused_onsets(*_torch(block), position, transform,
                                    MIN_ONSET)
    got, got_avail = _host_fe1(host_lib_v2, block, position, transform,
                               fe1=host.fe1_v2, threads=V2_THREADS)
    _assert_equal(got, want.numpy())
    assert got_avail == float(want_avail)


@pytest.mark.parametrize("case", KURTOSIS_CASES, ids=_id)
def test_fe2_v2_source_equals_plain(host_lib_v2, exact_sqrt, case):
    dtype, t_len, nsmooth, taper_pad = case
    block = make_block(dtype, t_len, lengths=(NKURT,))
    want, want_avail = fused_kurtosis_onsets(*_torch(block), nsmooth,
                                             taper_pad, MIN_ONSET)
    got, got_avail = host.fe2_v2(host_lib_v2, *block, nsmooth, taper_pad,
                                 MIN_ONSET, threads=V2_THREADS)
    _assert_equal(got, want.numpy())
    assert got_avail == float(want_avail)


def _hold_v2(lib, block, nsmooth, taper_pad=3, threads=None, kinds=(
        "classic", "centred", "kurtosis")):
    """FE1 v2 (each position in ``kinds``, energy) and FE2 v2 (where
    "kurtosis" is in ``kinds``, with nkurt the block's nlta) against the
    plain versions, bit for bit."""

    threads = V2_THREADS if threads is None else threads
    for position in kinds:
        if position == "kurtosis":
            kurt_block = block[:3] + (block[4],)
            want, want_avail = fused_kurtosis_onsets(
                *_torch(kurt_block), nsmooth, taper_pad, MIN_ONSET)
            got, got_avail = host.fe2_v2(lib, *kurt_block, nsmooth,
                                         taper_pad, MIN_ONSET,
                                         threads=threads)
        else:
            want, want_avail = fused_onsets(*_torch(block), position,
                                            "energy", MIN_ONSET)
            got, got_avail = _host_fe1(lib, block, position, "energy",
                                       fe1=host.fe1_v2, threads=threads)
        _assert_equal(got, want.numpy())
        assert got_avail == float(want_avail)


@pytest.mark.parametrize("case", EDGE_CASES, ids=_id)
def test_front_end_v2_source_edges(host_lib_v2, exact_sqrt, case):
    dtype, t_len, nsta, nlta, nsmooth = case
    block = make_block(dtype, t_len, seed=t_len, lengths=(nsta, nlta))
    _hold_v2(host_lib_v2, block, nsmooth)


# FE1 v2 and FE2 v2 across their 256-sample segments: rows of 16^k +- 1
# samples (the levels of the blocked scan appear and go), (nsta, nlta)
# pairs for P and S slots where the LTA and the kurtosis window (nlta)
# are longer than a segment, the centred STA reaches one or three
# segments ahead, and a smoothing longer than a segment reads across it
# (at 5,000 samples too long for FE2 v2 to stage a channel's taps in
# float64)
SEGMENT_CASES = [
    (np.float32, 15, (1, 4), (2, 15), 3),
    (np.float64, 255, (200, 16), (254, 255), 300),
    (np.float32, 257, (256, 300), (256, 257), 600),
    (np.float32, 4095, (257, 700), (300, 4000), 7),
    (np.float64, 4097, (600, 17), (1000, 256), 258),
    (np.float64, 6000, (25, 300), (700, 2000), 5000),
    (np.float32, 65537, (25, 513), (9000, 300), 13),
]


@pytest.mark.parametrize("case", SEGMENT_CASES, ids=_id)
def test_front_end_v2_source_across_segments(host_lib_v2, exact_sqrt, case):
    dtype, t_len, nsta, nlta, nsmooth = case
    block = make_block(dtype, t_len, seed=t_len + 1, lengths=(nsta, nlta))
    _hold_v2(host_lib_v2, block, nsmooth, taper_pad=5)


def test_front_end_v2_source_at_a_block_of_256_threads(host_lib_v2,
                                                        exact_sqrt):
    """The card's block size (FV_THREADS, a thread an output sample):
    the other cases run 32 threads a block to keep the shim quick."""

    block = make_block(np.float32, 1000, seed=3, lengths=((40, 300),
                                                          (400, 90)))
    _hold_v2(host_lib_v2, block, 12, threads=0)


def _long_block(dtype, t_len, nsta, nlta, seed):
    """Two slots of C_MAX channels (the second's channel 1 dead) with an
    arrival in the middle: few slots keep the shim quick at long rows."""

    rng = np.random.default_rng(seed)
    channels = rng.normal(size=(2, C_MAX, t_len))
    channels[:, :, t_len // 2:t_len // 2 + 40] *= 12.0
    channels[1, 1] = 0.0
    chan_mask = np.ones((2, C_MAX))
    chan_mask[1, 1] = 0.0
    return (channels.astype(dtype), chan_mask.astype(dtype),
            np.ones(2, dtype), np.array([nsta, 2 * nsta], np.int32),
            np.array([nlta, nlta + 77], np.int32))


# Rows longer than FE1 and FE2 can stage (FE2 at 72,608 float32 and
# 36,320 float64 samples with three channels, FE1 at 145,248 float64)
LONG_CASES = [
    (np.float32, 100_000, ("kurtosis",)),
    (np.float64, 40_000, ("kurtosis",)),
    (np.float64, 150_000, ("classic", "centred")),
]


@pytest.mark.parametrize("case", LONG_CASES, ids=_id)
def test_front_end_v2_source_long_rows(host_lib_v2, exact_sqrt, case):
    dtype, t_len, kinds = case
    _hold_v2(host_lib_v2, _long_block(dtype, t_len, 250, 2500, t_len), 12,
             kinds=kinds)


def test_front_end_v2_source_gives_nan_for_a_length_below_one(host_lib_v2):
    block = list(make_block(np.float32, 301))
    block[3] = block[3].copy()
    block[3][[0, 4]] = 0
    got, available = _host_fe1(host_lib_v2, block, "classic", "energy",
                               fe1=host.fe1_v2, threads=V2_THREADS)
    assert np.isnan(got[0]).all() and (got[4] == 1.0).all()
    assert np.isfinite(got[[1, 2, 3, 5]]).all() and available == 5.0
    kurt = [*block[:3], np.array([-3, 26, 26, 51, 0, 51], np.int32)]
    got, _ = host.fe2_v2(host_lib_v2, *kurt, 5, 0, MIN_ONSET,
                         threads=V2_THREADS)
    assert np.isnan(got[0]).all() and (got[4] == 1.0).all()
    assert np.isfinite(got[[1, 2, 3, 5]]).all()


# -- the wrappers ---------------------------------------------------------------

def _fe1_args(block, **change):
    args = dict(zip(("channels", "chan_mask", "slot_mask", "nsta", "nlta"),
                    _torch(block)))
    args.update(position="classic", transform="energy",
                min_onset_value=MIN_ONSET)
    args.update(change)
    return args


def _fe2_args(block, **change):
    args = dict(zip(("channels", "chan_mask", "slot_mask", "nkurt"),
                    _torch(block[:3] + (block[3],))))
    args.update(nsmooth=5, taper_pad=0, min_onset_value=MIN_ONSET)
    args.update(change)
    return args


_BLOCK = make_block(np.float32, 301)
REFUSALS = [
    ("fe1", "cpu tensor", {}, ValueError, "CUDA tensors"),
    ("fe2", "cpu tensor", {}, ValueError, "CUDA tensors"),
    ("fe1", "float16", dict(channels=torch.zeros(6, 3, 301,
                                                 dtype=torch.float16)),
     TypeError, "float32 or float64"),
    ("fe2", "int32", dict(channels=torch.zeros(6, 3, 301, dtype=torch.int32)),
     TypeError, "float32 or float64"),
    ("fe1", "2-d channels", dict(channels=torch.zeros(6, 301)), ValueError,
     "n_slots, C_max, T"),
    ("fe2", "empty row", dict(channels=torch.zeros(6, 3, 0)), ValueError,
     "n_slots, C_max, T"),
    ("fe1", "chan_mask shape", dict(chan_mask=torch.ones(6, 2)), ValueError,
     "chan_mask"),
    ("fe2", "slot_mask dtype", dict(slot_mask=torch.ones(6,
                                                         dtype=torch.float64)),
     ValueError, "slot_mask"),
    ("fe1", "nsta below 1", dict(nsta=torch.tensor([5, 0, 5, 12, 12, 12],
                                                   dtype=torch.int32)),
     ValueError, "nsta must be >= 1"),
    ("fe1", "nlta shape", dict(nlta=torch.ones(5, dtype=torch.int32)),
     ValueError, "nlta must be integers"),
    ("fe2", "nkurt below 1", dict(nkurt=np.array([26, 26, 26, 51, 51, -1])),
     ValueError, "nkurt must be >= 1"),
    ("fe2", "nsmooth 0", dict(nsmooth=0), ValueError, "nsmooth"),
    ("fe1", "position", dict(position="trailing"), ValueError, "position"),
    ("fe1", "transform", dict(transform="square"), ValueError, "transform"),
]
# FE1 and FE2's own limit: a row whose scan levels do not fit a block's
# shared memory (FE1 v2 and FE2 v2 take it)
TOO_LONG_TO_STAGE = ("fe2", "too long to stage", dict(
    channels=torch.zeros(6, 3, 100_000), chan_mask=torch.ones(6, 3)),
    ValueError, "shared memory")


@pytest.mark.parametrize("refusal", REFUSALS, ids=lambda r: f"{r[0]}-{r[1]}")
def test_wrappers_refuse(monkeypatch, refusal):
    """FE1 v2's and FE2 v2's wrappers (the detect paths'): each refusal
    raises before anything launches (a launcher that fails the test
    stands in for the kernel library)."""

    _refuses(monkeypatch, refusal, "_v2")


@pytest.mark.parametrize("refusal", REFUSALS + [TOO_LONG_TO_STAGE],
                         ids=lambda r: f"{r[0]}-{r[1]}")
def test_v1_wrappers_refuse(monkeypatch, refusal):
    """FE1's and FE2's wrappers (the yardstick) make the same refusals,
    and refuse a row whose scan levels they cannot stage."""

    _refuses(monkeypatch, refusal, "")


def _refuses(monkeypatch, refusal, version):
    which, _, change, error, match = refusal
    monkeypatch.setattr(cuda_front_end, "launch_kernel",
                        lambda *a: pytest.fail("launched"))
    if which == "fe1":
        call = getattr(cuda_front_end, "fused_onsets_cuda" + version)
        args = _fe1_args(_BLOCK, **change)
    else:
        call = getattr(cuda_front_end, "fused_kurtosis_onsets_cuda" + version)
        args = _fe2_args(_BLOCK, **change)
    with pytest.raises(error, match=match):
        call(**args)


@pytest.mark.parametrize("dtype,t_len", [(torch.float32, 120_000),
                                         (torch.float64, 40_000)])
def test_v2_wrappers_take_rows_too_long_to_stage(dtype, t_len):
    """FE1 v2 and FE2 v2 check such a block as any other: on CPU tensors
    they get as far as refusing the device."""

    change = dict(channels=torch.zeros(6, 3, t_len, dtype=dtype),
                  chan_mask=torch.ones(6, 3, dtype=dtype),
                  slot_mask=torch.ones(6, dtype=dtype))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_front_end.fused_kurtosis_onsets_cuda(**_fe2_args(_BLOCK,
                                                              **change))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_front_end.fused_kurtosis_onsets_cuda_v2(**_fe2_args(_BLOCK,
                                                                 **change))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_front_end.fused_onsets_cuda_v2(**_fe1_args(_BLOCK, **change))


def test_stage_bytes_follows_the_levels():
    # 2,038 samples: 128 block totals, 8 totals of those
    assert cuda_front_end.stage_bytes(2038, 3, 4) == (128 + 8) * 3 * 4
    # 30,000: 1,875, 118, 8
    assert cuda_front_end.stage_bytes(30000, 12, 8) == 2001 * 12 * 8
    assert cuda_front_end.stage_bytes(16, 1, 4) == 4
    assert cuda_front_end.stage_bytes(30000, 12, 8) < (
        cuda_front_end.MAX_STAGE_BYTES)


@pytest.mark.parametrize("kind", ["stalta", "kurtosis"])
def test_cpu_blocks_never_reach_the_kernels(monkeypatch, kind):
    """The factories' front ends take the plain version on a CPU block:
    neither the wrappers nor the kernel library's launcher runs, and no
    launch is counted."""

    def refuse(*args, **kwargs):
        pytest.fail("a CPU block reached ops.cuda_front_end")

    for name in ("fused_onsets_cuda", "fused_kurtosis_onsets_cuda",
                 "fused_onsets_cuda_v2", "fused_kurtosis_onsets_cuda_v2",
                 "launch_kernel"):
        monkeypatch.setattr(cuda_front_end, name, refuse)
    monkeypatch.setattr(cuda_migrate, "launch_kernel", refuse)
    cuda_front_end.reset_launches()
    if kind == "stalta":
        block = make_block(np.float32, 301)
        front_end = stalta_front_end("classic", "energy", MIN_ONSET)
        want = fused_onsets(*_torch(block), "classic", "energy", MIN_ONSET)
    else:
        block = make_block(np.float32, 301, lengths=(NKURT,))
        front_end = kurtosis_front_end(5, 20, MIN_ONSET)
        want = fused_kurtosis_onsets(*_torch(block), 5, 20, MIN_ONSET)
    got = front_end(*_torch(block))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert set(cuda_front_end.launches.values()) == {0}


def test_plain_windows_keep_the_plain_front_end(monkeypatch):
    """``detect_window_fused`` and ``detect_window_fused_kurtosis`` are
    the plain windows: they call the plain front ends, whatever the
    block's device."""

    calls = []
    for name in ("fused_onsets", "fused_kurtosis_onsets"):
        fn = getattr(scan_window, name)
        monkeypatch.setattr(scan_window, name,
                            lambda *a, _fn=fn, _n=name: calls.append(_n)
                            or _fn(*a))
    block = make_block(np.float32, 301)
    tt, fsmp, nsamples = _grid(block, 5)
    scan_window.detect_window_fused(
        *_torch(block), torch.from_numpy(tt), "classic", "energy", MIN_ONSET,
        fsmp, nsamples)
    kurt = make_block(np.float32, 301, lengths=(NKURT,))
    scan_window.detect_window_fused_kurtosis(
        *_torch(kurt), torch.from_numpy(tt), 5, 20, MIN_ONSET, fsmp,
        nsamples)
    assert calls == ["fused_onsets", "fused_kurtosis_onsets"]
