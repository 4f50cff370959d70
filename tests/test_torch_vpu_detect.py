# -*- coding: utf-8 -*-
"""
The VPU-plan detect of quakemigrate_torch (``CudaDetectVPU``, the
counterpart of the JAX ``PallasDetect``) against the JAX reference: the
plan against ``PallasDetectPlan(vpu_fine=True)``, and the plain path that
CPU tensors take against ``PallasDetect`` in interpret mode (the kernel
``_detect_kernel`` run by the Pallas interpreter), which ties in the same
brick order. Float32; values at rtol 2e-6 (as tests/test_pallas.py),
argmax tie-consistent: where the two pick different nodes, the float64
coalescence at the port's node is within 2e-6 of the maximum. The CUDA
kernel itself runs only on the card (chip_smoke.py).

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.pallas_migrate import PallasDetect, PallasDetectPlan
from quakemigrate_torch.ops import cuda_migrate

from test_torch_migrate import RTOL, _assert_tie_consistent, _torch, _workload

torch.set_num_threads(1)


@pytest.mark.parametrize("node_count,tile,brick", [
    ((17, 9, 10), 512, (8, 8, 8)),
    ((10, 9, 8), 64, (4, 4, 4)),
    ((12, 8, 9), 64, (8, 8, 8)),
    ((9, 9, 5), 512, (4, 4, 4)),
])
def test_detect_plan_equals_vpu_plan(node_count, tile, brick):
    rng = np.random.default_rng(11)
    n_nodes = int(np.prod(node_count))
    tt = rng.integers(-3, 70, size=(n_nodes, 4)).astype(np.int32)
    plan = cuda_migrate.DetectPlan(tt, node_count, tile=tile,
                                   brick_shape=brick)
    ref = PallasDetectPlan(tt, node_count, tile=tile, brick_shape=brick,
                           vpu_fine=True)
    assert plan.n_tiles == ref.n_tiles and plan.tile == ref.tile
    np.testing.assert_array_equal(plan.perm, ref.perm)
    np.testing.assert_array_equal(plan.base, ref.base)
    np.testing.assert_array_equal(plan.fine, ref.fine[..., 0])
    np.testing.assert_array_equal(plan.valid, ref.valid[..., 0])
    assert plan.bits == ref.bits
    assert plan.r_pow2 == ref.r_pow2
    assert plan.r_span <= plan.r_pow2


def test_plan_bits_of_a_flat_table():
    """All traveltimes equal: no residual, one bit (as the TPU plan)."""

    tt = np.full((64, 3), 7, np.int32)
    plan = cuda_migrate.DetectPlan(tt, (4, 4, 4), tile=64,
                                   brick_shape=(4, 4, 4))
    ref = PallasDetectPlan(tt, (4, 4, 4), tile=64, brick_shape=(4, 4, 4))
    assert plan.r_span == 1
    assert plan.bits == ref.bits == 1 and plan.r_pow2 == ref.r_pow2 == 2


@pytest.mark.parametrize("seed,tile,brick", [
    (0, 64, (4, 4, 4)),
    (7, 64, (4, 4, 4)),
    (3, 512, (8, 8, 8)),
])
def test_cuda_detect_vpu_matches_pallas_detect(seed, tile, brick):
    """CudaDetectVPU on CPU tensors (its plain version) against the JAX
    VPU kernel in interpret mode: max_coa, max_coa_n and max_idx."""

    fsmp, nsamples, node_count = 16, 100, (10, 9, 8)
    work = _workload(seed)
    onsets, tt, mask, available = work
    pallas = PallasDetect(tt, node_count, fsmp, nsamples, tile=tile,
                          brick_shape=brick, interpret=True)
    ref = [np.asarray(x) for x in pallas(onsets, mask, available)]

    detect = cuda_migrate.CudaDetectVPU(tt, node_count, fsmp, nsamples,
                                        "cpu", tile=tile, brick_shape=brick)
    got = [x.numpy() for x in detect(*_torch(onsets, mask), available)]
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL)
    assert got[2].dtype == np.int32
    assert (got[2] == ref[2]).mean() > 0.99
    _assert_tie_consistent(got[2], ref[0], work, fsmp)
    assert detect.launches == 0  # the CPU path launches no kernel


def test_cuda_detect_vpu_defaults_are_the_vpu_plan():
    tt = np.zeros((8 * 8 * 8, 2), np.int32)
    detect = cuda_migrate.CudaDetectVPU(tt, (8, 8, 8), 0, 10, "cpu")
    assert detect.tile == 512
    assert detect.kernel is cuda_migrate.migrate_detect_vpu_cuda
    with pytest.raises(ValueError, match="tile"):
        cuda_migrate.CudaDetectVPU(tt, (8, 8, 8), 0, 10, "cpu", tile=96,
                                   brick_shape=(4, 4, 4))


def test_cuda_detect_vpu_rejects_short_onset_block():
    """As tests/test_pallas.py:525 for the TPU kernels: an onset block
    shorter than the plan's largest shift raises instead of reading past
    the row."""

    rng = np.random.default_rng(22)
    n_onsets, fsmp, nsamples, lsmp = 4, 8, 40, 30
    tt = rng.integers(0, lsmp, size=(512, n_onsets)).astype(np.int32)
    mask = np.ones(n_onsets, dtype=np.float32)
    detect = cuda_migrate.CudaDetectVPU(tt, (8, 8, 8), fsmp, nsamples, "cpu")
    max_shift = int(tt.max())
    short = rng.gamma(2.0, 1.5, size=(n_onsets, fsmp + nsamples + max_shift
                                      - 1)).astype(np.float32)
    with pytest.raises(ValueError, match="too short"):
        detect(*_torch(short, mask), float(n_onsets))
    enough = np.pad(short, ((0, 0), (0, 1)), constant_values=1.0)
    detect(*_torch(enough, mask), float(n_onsets))


def test_vpu_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version in its place."""

    plan = cuda_migrate.DetectPlan(
        np.zeros((64, 2), np.int32), (4, 4, 4), tile=64,
        brick_shape=(4, 4, 4),
    )
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_migrate.migrate_detect_vpu_cuda(
            torch.zeros((2, 50)), *_torch(plan.base, plan.fine, plan.valid),
            torch.ones(1), 0, 10, plan.r_span,
        )
