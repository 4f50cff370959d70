# -*- coding: utf-8 -*-
"""
The port's reference-shaped bindings (``quakemigrate_torch.core.compat``,
re-exported from ``quakemigrate_torch.core``) against the JAX package's
``quakemigrate_tpu.core.compat`` on seeded numpy inputs, with
``device="cpu"`` (the card's route, M2 on the detector of the detect
route, is held to this CPU run by chip_smoke.py):

- migrate within 1e-5 relative of JAX's (float32 maps, the same clip of
  the traveltimes to the scan's block), on grids whose traveltimes reach
  past the block;
- find_max_coa: the max bit for bit JAX's, the normalised max within
  1e-6 relative (a float32 sum over the nodes, in another order), the
  argmax the first flat index attaining the max;
- the three STA/LTAs within 1e-6 relative (float32, as JAX's);
- the size and count validations, and ``threads`` accepted and ignored;
- the card as the default device (refused here, where there is none).

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.core import compat as j_compat
from quakemigrate_torch import core
from quakemigrate_torch.core import compat

torch.set_num_threads(1)


def _inputs(seed, grid=(5, 4, 3), n_onsets=6, t_samples=120, max_tt=30):
    rng = np.random.default_rng(seed)
    onsets = rng.uniform(0.3, 4.0, (n_onsets, t_samples))
    tt = rng.integers(-2, max_tt, grid + (n_onsets,))
    return onsets, tt


@pytest.mark.parametrize("seed,grid,first,last,max_tt", [
    (0, (5, 4, 3), 10, 30, 25), (1, (7, 3, 4), 0, 40, 60),
    (2, (4, 4, 4), 25, 5, 12)])
def test_migrate_within_1e5_of_jax(seed, grid, first, last, max_tt):
    onsets, tt = _inputs(seed, grid, max_tt=max_tt)
    want = j_compat.migrate(onsets, tt, first, last, 6)
    got = core.migrate(onsets, tt, first, last, 6, threads=8, device="cpu")
    assert got.dtype == np.float64
    assert got.shape == want.shape == grid + (120 - first - last,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_migrate_available_divides_the_stack():
    onsets, tt = _inputs(3)
    got = compat.migrate(onsets, tt, 5, 30, 4, device="cpu")
    want = j_compat.migrate(onsets, tt, 5, 30, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_find_max_coa_equals_jax():
    onsets, tt = _inputs(4, (6, 5, 4))
    map4d = j_compat.migrate(onsets, tt, 10, 30, 6)
    map4d[1, 2, 3, 7] = map4d[..., 7].max()  # a tie at sample 7
    want = j_compat.find_max_coa(map4d)
    got = core.find_max_coa(map4d, threads=4, device="cpu")
    assert [a.dtype for a in got] == [np.float64, np.float64, np.int64]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
    flat = map4d.astype(np.float32).reshape(-1, map4d.shape[-1])
    np.testing.assert_array_equal(got[2], np.argmax(flat, axis=0))
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2][7] == min(np.flatnonzero(flat[:, 7] == flat[:, 7].max()))


@pytest.mark.parametrize("kind", ["overlapping_sta_lta", "centred_sta_lta",
                                  "recursive_sta_lta"])
@pytest.mark.parametrize("nsta,nlta,n", [(10, 100, 500), (3, 40, 40),
                                         (5, 60, 50)])
def test_stalta_equals_jax(kind, nsta, nlta, n):
    rng = np.random.default_rng(n + nsta)
    signal = rng.standard_normal(n) ** 2 + 1e-3
    want = getattr(j_compat, kind)(signal, nsta, nlta)
    got = getattr(core, kind)(signal, nsta, nlta, device="cpu")
    assert got.dtype == np.float64 and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_stalta_on_rows():
    signal = np.random.default_rng(9).standard_normal((3, 200)) ** 2
    got = compat.recursive_sta_lta(signal, 5, 50, device="cpu")
    assert got.shape == (3, 200)
    np.testing.assert_array_equal(
        got[1], compat.recursive_sta_lta(signal[1], 5, 50, device="cpu"))


@pytest.mark.parametrize("onsets_shape,tt_shape,first,last,match", [
    ((6, 120), (5, 4, 3, 7), 10, 30, "Mismatch between number of stations"),
    ((1, 40), (2, 2, 2, 1), 30, -80, "Data array smaller"),
])
def test_migrate_validations_match_jax(onsets_shape, tt_shape, first, last,
                                       match):
    onsets = np.ones(onsets_shape)
    tt = np.zeros(tt_shape, dtype=np.int64)
    with pytest.raises(ValueError, match=match) as want:
        j_compat.migrate(onsets, tt, first, last, 1)
    with pytest.raises(ValueError, match=match) as got:
        compat.migrate(onsets, tt, first, last, 1, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("call", [
    lambda: compat.migrate(np.ones((2, 30)), np.zeros((2, 2, 2, 2), int),
                           0, 10, 2),
    lambda: compat.find_max_coa(np.ones((2, 2, 2, 5))),
    lambda: compat.recursive_sta_lta(np.ones(30), 2, 5),
])
def test_default_device_is_the_card(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
