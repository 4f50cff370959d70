# -*- coding: utf-8 -*-
"""
The recursive STA/LTA of the port (``quakemigrate_torch.ops.stalta
.recursive_sta_lta``; on the CPU its plain version, the affine-pair scan
that R1, ``csrc/recursive_stalta.cu``, is held to on the card by
chip_smoke.py) against the JAX package's XLA associative scan on seeded
inputs:

- float64 within 1e-12 relative of JAX's (both are scans of the same
  affine maps, in other orders);
- float32 no further from a float64 sequential recurrence of the same
  contract than twice JAX's float32 error on the same input (scan order
  sets the float32 error);
- the edges: onset[0] = 0, the first nlta samples 1 only when nlta < n;
- R1's wrapper: refusals, the launch arguments it hands the C entry, and
  the dispatch of a CPU tensor to the plain version with no launch.

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.stalta import recursive_sta_lta as j_recursive
from quakemigrate_torch import ops
from quakemigrate_torch.ops import cuda_stalta
from quakemigrate_torch.ops.stalta import (
    recursive_sta_lta,
    recursive_sta_lta_plain,
)

torch.set_num_threads(1)

# (nsta, nlta, n): short and long rows, nlta >= n, nlta == n - 1, nsta = 1
CASES = [(20, 200, 2038), (50, 1000, 6000), (3, 40, 40), (3, 39, 40),
         (5, 300, 100), (1, 7, 64), (4, 16, 1)]


def _signal(n, rows=3, seed=0):
    rng = np.random.default_rng(seed + n)
    return rng.standard_normal((rows, n)) ** 2


def _sequential(x, nsta, nlta):
    """The contract as a float64 sequential recurrence."""

    n = x.shape[-1]
    out = np.zeros(x.shape, dtype=np.float64)
    tiny = np.finfo(np.float64).tiny
    cs, cl = 1.0 / nsta, 1.0 / nlta
    for r in range(x.shape[0]):
        sta = lta = 0.0
        for i in range(1, n):
            sta = cs * x[r, i] + (1 - cs) * sta
            lta = cl * x[r, i] + (1 - cl) * lta
            out[r, i] = sta / max(lta, tiny)
    if nlta < n:
        out[:, :nlta] = 1.0
    return out


def _rel(got, want):
    return np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300))


@pytest.mark.parametrize("nsta,nlta,n", CASES)
def test_float64_matches_jax(nsta, nlta, n):
    x = _signal(n)
    got = recursive_sta_lta(torch.from_numpy(x), nsta, nlta)
    want = np.asarray(j_recursive(x, nsta, nlta))
    assert got.dtype == torch.float64 and got.shape == x.shape
    assert _rel(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("nsta,nlta,n", CASES)
def test_float32_error_within_twice_jax(nsta, nlta, n):
    x = _signal(n, seed=1)
    x32 = x.astype(np.float32)
    ref = _sequential(x32.astype(np.float64), nsta, nlta)
    got = recursive_sta_lta(torch.from_numpy(x32), nsta, nlta)
    want = np.asarray(j_recursive(x32, nsta, nlta))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    jax_err = _rel(want.astype(np.float64), ref)
    assert _rel(got.numpy().astype(np.float64), ref) <= max(
        2 * jax_err, np.finfo(np.float32).eps)


@pytest.mark.parametrize("nsta,nlta,n", [(2, 5, 20), (2, 20, 20),
                                         (2, 25, 20)])
def test_edges(nsta, nlta, n):
    x = torch.from_numpy(_signal(n, rows=2) + 0.5)
    onset = recursive_sta_lta(x, nsta, nlta).numpy()
    if nlta < n:
        assert (onset[:, :nlta] == 1.0).all()
        assert (onset[:, nlta:] != 1.0).all()
    else:
        assert (onset[:, 0] == 0.0).all() and (onset[:, 1:] > 0).all()


def test_batched_over_leading_dims():
    x = torch.from_numpy(_signal(300, rows=6).reshape(2, 3, 300))
    got = recursive_sta_lta(x, 10, 100)
    want = torch.stack([recursive_sta_lta(x[i], 10, 100) for i in range(2)])
    assert got.shape == (2, 3, 300)
    assert torch.equal(got, want)


def test_zero_signal_divides_by_no_zero():
    onset = recursive_sta_lta(torch.zeros(2, 50), 3, 10)
    assert torch.isfinite(onset).all()
    assert (onset[:, :10] == 1).all() and (onset[:, 10:] == 0).all()


def test_ops_exports_the_three_stalta():
    assert ops.recursive_sta_lta is recursive_sta_lta
    assert callable(ops.overlapping_sta_lta) and callable(
        ops.centred_sta_lta)


def test_cpu_tensor_takes_the_plain_version_with_no_launch():
    cuda_stalta.reset_launches()
    x = torch.from_numpy(_signal(100))
    assert torch.equal(recursive_sta_lta(x, 5, 20),
                       recursive_sta_lta_plain(x, 5, 20))
    assert cuda_stalta.launches["recursive_stalta"] == 0


def test_wrapper_refuses_cpu_tensors_and_other_dtypes():
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_stalta.recursive_sta_lta_cuda(torch.zeros(2, 10), 2, 5)


class _FakeCuda:
    """What the wrapper reads of a CUDA tensor, on the CPU."""

    is_cuda = True

    def __init__(self, shape, dtype):
        self.shape, self.dtype = shape, dtype
        self.device = torch.device("cpu")

    def numel(self):
        return int(np.prod(self.shape))

    def contiguous(self):
        return self

    def data_ptr(self):
        return 4096


@pytest.mark.parametrize("dtype,entry", [
    (torch.float32, "qm_recursive_stalta_f32"),
    (torch.float64, "qm_recursive_stalta_f64")])
def test_wrapper_launch_arguments(monkeypatch, dtype, entry):
    calls = []
    monkeypatch.setattr(cuda_stalta, "launch_kernel",
                        lambda *args: calls.append(args))
    monkeypatch.setattr(torch, "empty_like",
                        lambda x: _FakeCuda(x.shape, x.dtype))
    cuda_stalta.reset_launches()
    cuda_stalta.recursive_sta_lta_cuda(_FakeCuda((2, 3, 500), dtype), 7, 70)
    ((name, _, x_ptr, out_ptr, rows, n, nsta, nlta),) = calls
    assert (name, rows, n, nsta, nlta) == (entry, 6, 500, 7, 70)
    assert cuda_stalta.launches["recursive_stalta"] == 1
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_stalta.recursive_sta_lta_cuda(_FakeCuda((2, 5), torch.float16),
                                           2, 4)
    with pytest.raises(ValueError, match="must be >= 1"):
        cuda_stalta.recursive_sta_lta_cuda(_FakeCuda((2, 5), dtype), 0, 4)
    assert cuda_stalta.launches["recursive_stalta"] == 1


def test_signatures_declared():
    from quakemigrate_torch import _build

    for name in ("qm_recursive_stalta_f32", "qm_recursive_stalta_f64"):
        assert len(_build.SIGNATURES[name]) == 7
    src = (_build.CSRC_DIR / "recursive_stalta.cu").read_text()
    assert 'extern "C" int qm_recursive_stalta_f32' in src
    assert 'extern "C" int qm_recursive_stalta_f64' in src
