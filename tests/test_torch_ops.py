# -*- coding: utf-8 -*-
"""
Onset front end of quakemigrate_torch against the JAX reference ops:
rolling sums, STA/LTA (both positions), signal transforms, the per-row
STA/LTA and the fused onset front end, in float64. The cumulative sums
are taken in another order by the two frameworks, hence rtol 1e-9 and
atol 1e-12 rather than bit equality. Also the pack/unpack round trip of
a detect window, which must be bit-exact.

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops import rolling as j_rolling
from quakemigrate_tpu.ops import scan_window as j_scan_window
from quakemigrate_tpu.ops import stalta as j_stalta
from quakemigrate_torch.ops import rolling, scan_window, stalta

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-12
T = 120


def _rows(seed, n_rows=4, t=T, zero_row=True):
    """Non-negative f64 rows (a transformed signal); one all-zero row."""

    rows = np.random.default_rng(seed).gamma(2.0, 1.0, size=(n_rows, t))
    if zero_row:
        rows[1] = 0.0
    return rows


def _close(got, ref):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), rtol=RTOL, atol=ATOL
    )


def test_padded_cumsum_matches_jax():
    x = _rows(0)
    _close(rolling.padded_cumsum(torch.from_numpy(x)),
           j_rolling.padded_cumsum(x))


@pytest.mark.parametrize("n", [1, 5, 40, T, 3 * T])
def test_trailing_window_sums_static_n(n):
    x = _rows(1)
    _close(rolling.trailing_window_sums(torch.from_numpy(x), n),
           j_rolling.trailing_window_sums(x, n))


def test_trailing_window_sums_per_row_n():
    x = _rows(2)
    n = np.array([1, 7, T + 5, 50], dtype=np.int32)
    _close(rolling.trailing_window_sums(torch.from_numpy(x),
                                        torch.from_numpy(n)),
           j_rolling.trailing_window_sums(x, n))


@pytest.mark.parametrize("nsta,nlta", [(3, 10), (5, 50), (4, T), (6, 2 * T)])
@pytest.mark.parametrize("name", ["overlapping_sta_lta", "centred_sta_lta"])
def test_sta_lta_matches_jax(name, nsta, nlta):
    x = _rows(3)
    got = getattr(stalta, name)(torch.from_numpy(x), nsta, nlta)
    ref = getattr(j_stalta, name)(x, nsta, nlta)
    _close(got, ref)
    # edge rules: leading ones, and the all-zero row is all ones
    np.testing.assert_array_equal(got.numpy()[:, : min(nlta - 1, T)], 1.0)
    np.testing.assert_array_equal(got.numpy()[1], 1.0)


@pytest.mark.parametrize("t", [T, T + 1])
@pytest.mark.parametrize("transform", ["energy", "abs", "env", "env_squared"])
def test_signal_transform_matches_jax(transform, t):
    x = np.random.default_rng(4).normal(size=(3, t))
    _close(stalta.signal_transform(torch.from_numpy(x), transform),
           j_stalta.signal_transform(x, transform))


def test_unknown_transform_and_position_raise():
    x = torch.zeros((2, 8), dtype=torch.float64)
    with pytest.raises(ValueError):
        stalta.signal_transform(x, "square")
    n = torch.tensor([2, 2])
    with pytest.raises(ValueError):
        scan_window._sta_lta_dynamic(x, n, n, "leading")


@pytest.mark.parametrize("position", ["classic", "centred"])
def test_sta_lta_dynamic_matches_jax(position):
    x = _rows(5, n_rows=5)
    nsta = np.array([2, 3, 5, 4, 7], dtype=np.int32)
    nlta = np.array([9, 12, 30, T, 2 * T], dtype=np.int32)
    got = scan_window._sta_lta_dynamic(
        torch.from_numpy(x), torch.from_numpy(nsta), torch.from_numpy(nlta),
        position,
    )
    ref = j_scan_window._sta_lta_dynamic(x, nsta, nlta, position)
    _close(got, ref)


def _channel_block(seed, n_slots=6, c_max=3, t=T):
    rng = np.random.default_rng(seed)
    channels = rng.normal(size=(n_slots, c_max, t))
    chan_mask = np.ones((n_slots, c_max))
    chan_mask[1, 2] = 0.0
    channels[1, 2] = 0.0
    slot_mask = np.ones(n_slots)
    slot_mask[4] = 0.0
    chan_mask[4] = 0.0
    channels[4] = 0.0
    channels[5, 0] = 0.0  # a live but silent channel
    nsta = np.array([2, 2, 2, 5, 5, 5], dtype=np.int32)[:n_slots]
    nlta = np.array([9, 9, 9, 30, 30, T], dtype=np.int32)[:n_slots]
    return channels, chan_mask, slot_mask, nsta, nlta


@pytest.mark.parametrize("transform", ["energy", "abs", "env", "env_squared"])
@pytest.mark.parametrize("position", ["classic", "centred"])
def test_fused_onsets_matches_jax(position, transform):
    block = _channel_block(6)
    combined, available = scan_window.fused_onsets(
        *(torch.from_numpy(a) for a in block), position, transform, 0.4
    )
    ref_combined, ref_available = j_scan_window.fused_onsets(
        *block, position, transform, 0.4
    )
    _close(combined, ref_combined)
    assert float(available) == float(ref_available) == 5.0
    np.testing.assert_array_equal(combined.numpy()[4], 1.0)  # dead slot


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_unpack_round_trip_bit_exact(dtype):
    rng = np.random.default_rng(8)
    max_coa = rng.gamma(2.0, 1.0, size=50).astype(dtype)
    # bit patterns a float path could disturb: subnormal, inf, nan, -0
    max_coa[:4] = [np.finfo(dtype).smallest_subnormal, np.inf, np.nan, -0.0]
    max_norm = rng.gamma(3.0, 1.0, size=50).astype(dtype)
    max_idx = rng.integers(0, 2**23, size=50).astype(np.int32)

    packed = scan_window.pack_detect_window(
        torch.from_numpy(max_coa), torch.from_numpy(max_norm),
        torch.from_numpy(max_idx),
    )
    assert packed.dtype == (torch.int64 if dtype == np.float64
                            else torch.int32)
    coa, norm, idx = scan_window.unpack_detect_window(packed.numpy())
    int_view = np.int64 if dtype == np.float64 else np.int32
    np.testing.assert_array_equal(coa.view(int_view), max_coa.view(int_view))
    np.testing.assert_array_equal(norm.view(int_view),
                                  max_norm.view(int_view))
    np.testing.assert_array_equal(idx, max_idx)

    # same packed layout as the JAX package
    j_packed = np.asarray(j_scan_window.pack_detect_window(
        max_coa, max_norm, max_idx
    ))
    np.testing.assert_array_equal(packed.numpy(), j_packed)
