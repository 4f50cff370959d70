# -*- coding: utf-8 -*-
"""
K1 v2 of quakemigrate_torch (``csrc/migrate_detect_v2.cu``, the production
detect kernel redesigned for the card's shared-memory pipe) on the CPU:
its plan tables (the node-major int16 residuals ``fine16`` and the
per-onset window offsets ``span_off``) on a small and an Icequake-shaped
plan, the int16 limit, the host-side shared-memory sizing, its wrappers
refusing what the kernel does not take, the plain version of its
ablations, and ``CudaDetect`` (whose kernel it is) against the JAX
``PallasDetect`` in interpret mode and the flat ``migrate_detect`` at a
plan with many padding nodes. The kernel runs only on the card, where
chip_smoke.py holds it against its plain version and bit for bit against
K1. Float32; values at rtol 2e-6, argmax tie-consistent.

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops import migrate as j_migrate
from quakemigrate_tpu.ops.pallas_migrate import PallasDetect
from quakemigrate_torch.lut import traveltime_table
from quakemigrate_torch.ops import cuda_breakdown as cb
from quakemigrate_torch.ops import cuda_migrate

from test_torch_breakdown import _small_plan
from test_torch_migrate import RTOL, _assert_tie_consistent, _torch, _workload

torch.set_num_threads(1)

ICEQUAKE_NODES = (71, 64, 57)


def _icequake_traveltimes(seed=3):
    """Homogeneous-moveout tables of 12 surface stations over the
    Icequake grid (25 m spacing, P 3.63 and S 1.833 km/s, 250 Hz)."""

    rng = np.random.default_rng(seed)
    axes = [np.arange(n) * 0.025 for n in ICEQUAKE_NODES]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    stations = rng.uniform([0, 0], [axes[0][-1], axes[1][-1]], size=(12, 2))
    dist = [np.sqrt((x - sx) ** 2 + (y - sy) ** 2 + z**2)
            for sx, sy in stations]
    return traveltime_table([d / v for v in (3.63, 1.833) for d in dist],
                            250)


def _plans():
    rng = np.random.default_rng(5)
    small = cuda_migrate.DetectPlan(
        rng.integers(0, 40, size=(720, 6)).astype(np.int32), (10, 9, 8),
        tile=64, brick_shape=(4, 4, 4))
    icequake = cuda_migrate.DetectPlan(_icequake_traveltimes(),
                                       ICEQUAKE_NODES)
    return {"small": small, "icequake": icequake}


@pytest.fixture(scope="module")
def plans():
    return _plans()


@pytest.mark.parametrize("name", ["small", "icequake"])
def test_fine16_is_fine_node_major(plans, name):
    plan = plans[name]
    assert plan.fine16.dtype == np.int16 and plan.fine16.flags.c_contiguous
    assert plan.fine16.shape == (plan.n_tiles, plan.tile, plan.n_onsets)
    np.testing.assert_array_equal(plan.fine16,
                                  plan.fine.transpose(0, 2, 1))


@pytest.mark.parametrize("name", ["small", "icequake"])
def test_span_offsets_fit_the_kernel(plans, name):
    """Onset o's window holds its residuals and a sample block; the
    offsets and every residual added to one fit the uint16 slab; the
    block fits the card's shared memory."""

    plan = plans[name]
    off = plan.span_off
    assert off.dtype == np.int32 and off.shape == (plan.n_onsets + 1,)
    assert off[0] == 0 and plan.win_floats == off[-1]
    np.testing.assert_array_equal(np.diff(off),
                                  np.array(plan.r_spans) + cuda_migrate.SBLK)
    # the largest slab entry, off[o] + fine, stays inside the windows
    assert ((off[:-1] + plan.fine16.max(axis=(0, 1)))
            < off[1:] - cuda_migrate.SBLK + 1).all()
    assert plan.win_floats < 2**16
    smem = cuda_migrate.v2_smem(plan.n_onsets, plan.tile, plan.win_floats)
    assert smem <= cuda_migrate.SMEM_LIMIT
    if name == "icequake":
        # 24 onsets, r_span 37: P windows narrower than S ones
        assert plan.n_onsets == 24 and min(plan.r_spans) < plan.r_span
        assert plan.win_floats < plan.n_onsets * (plan.r_span
                                                  + cuda_migrate.SBLK)
        assert smem == 4 * (28 + 256) + 2 * 256 * 24 + 4 * plan.win_floats


def test_v2_smem_sizing():
    # 24 onsets at tile 256: offsets 28 ints, valid 256 floats, slab
    # 256 x 24 uint16, and at least the block reduction's 3 x 8 x 128
    # floats after them
    assert cuda_migrate.v2_smem(24, 256, 3744) == 4 * 284 + 12288 + 4 * 3744
    assert cuda_migrate.v2_smem(5, 64, 700) == 4 * (8 + 64) + 4 * 3072
    # O is padded to 8 entries a slab row: O = 6 and 8 differ only by
    # the offset table's 8 and 12 ints
    assert cuda_migrate.v2_smem(6, 256, 1000) == cuda_migrate.v2_smem(
        8, 256, 1000) - 4 * 4
    assert cuda_migrate.v2_smem(9, 256, 9000) == cuda_migrate.v2_smem(
        8, 256, 9000) + 2 * 256 * 8
    with pytest.raises(ValueError, match="shared memory"):
        cuda_migrate.v2_smem(24, 256, 55_000)


def test_plan_above_int16_span_raises():
    """A plan whose residual span exceeds int16 builds without K1 v2's
    table; K1 v2 refuses it (v2_refusal names the limit) and its wrapper
    raises on it."""

    tt = np.zeros((4 * 4 * 4, 2), np.int32)
    tt[1, 1] = cuda_migrate.FINE16_MAX_SPAN + 1  # one node of the tile
    plan = cuda_migrate.DetectPlan(tt, (4, 4, 4), tile=64,
                                   brick_shape=(4, 4, 4))
    assert plan.fine16 is None
    assert "int16" in cuda_migrate.v2_refusal(
        plan.n_onsets, plan.tile, plan.win_floats, plan.r_span)
    with pytest.raises(ValueError, match="int16"):
        cuda_migrate.migrate_detect_v2_cuda(
            torch.zeros((2, 50)), *_torch(plan.base), None,
            *_torch(plan.valid), torch.ones(1), 0, 10,
            *_torch(plan.span_off), plan.win_floats)
    tt[1, 1] = cuda_migrate.FINE16_MAX_SPAN - 1  # r_span at the limit
    plan = cuda_migrate.DetectPlan(tt, (4, 4, 4), tile=64,
                                   brick_shape=(4, 4, 4))
    assert plan.r_span == cuda_migrate.FINE16_MAX_SPAN
    assert plan.fine16.max() == cuda_migrate.FINE16_MAX_SPAN - 1
    assert cuda_migrate.v2_refusal(plan.n_onsets, plan.tile, 100,
                                   plan.r_span) is None


def _v2_args(tile=32):
    plan, args, _ = _small_plan(tile=tile)
    fine16, span_off = _torch(plan.fine16, plan.span_off)
    return plan, (args[0], args[1], fine16, *args[3:], span_off,
                  plan.win_floats)


def test_v2_wrappers_refuse_what_the_kernel_does_not_take():
    """No plain version runs in the kernel's place, and no launch is
    counted that was not made."""

    plan, args = _v2_args()
    cuda_migrate.reset_launches()
    cb.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_migrate.migrate_detect_v2_cuda(*args)
    for variant in cb.V2_ABLATIONS:
        with pytest.raises(ValueError, match="CUDA tensors"):
            cb.migrate_detect_v2_ablate_cuda(*args, variant)
    with pytest.raises(ValueError, match="unknown variant"):
        cb.migrate_detect_v2_ablate_cuda(*args, "noexp")
    # the int32 [tiles, O, tile] table in place of fine16
    wrong = list(args)
    wrong[2] = torch.from_numpy(plan.fine)
    with pytest.raises(ValueError, match="int16"):
        cuda_migrate.migrate_detect_v2_cuda(*wrong)
    wrong[2] = args[2].to(torch.int32)
    with pytest.raises(ValueError, match="int16"):
        cuda_migrate.migrate_detect_v2_cuda(*wrong)
    wrong[2] = args[2].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_migrate.migrate_detect_v2_cuda(*wrong)
    wrong[2] = args[2].transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="inconsistent plan shapes"):
        cuda_migrate.migrate_detect_v2_cuda(*wrong)
    wrong = list(args)
    wrong[0] = args[0].double()
    with pytest.raises(ValueError, match="float32"):
        cuda_migrate.migrate_detect_v2_cuda(*wrong)
    assert cuda_migrate.launches == {"migrate_detect": 0,
                                     "migrate_detect_v2": 0,
                                     "migrate_detect_vpu": 0,
                                     "migrate_detect_vpu_v2": 0,
                                     "migrate_detect_global": 0,
                                     "migrate_detect_global_v2": 0,
                                     "migrate_marginalise": 0,
                                     "migrate_marginalise_v2": 0,
                                     "migrate_map": 0,
                                     "migrate_map_v2": 0,
                                     "migrate_detect_global_f64": 0,
                                     "migrate_detect_global_v2_f64": 0,
                                     "migrate_detect_global_v3_f64": 0,
                                     "migrate_marginalise_f64": 0,
                                     "migrate_map_f64": 0,
                                     "migrate_marginalise_ring": 0,
                                     "migrate_map_ring": 0,
                                     "migrate_marginalise_ring_f64": 0,
                                     "migrate_map_ring_f64": 0}
    assert set(cb.launches.values()) == {0}


def test_cuda_detect_launches_v2():
    """The main path's kernel is K1 v2, fed the plan's node-major
    residuals and window offsets; on CPU onsets the plain version runs
    and nothing is launched."""

    fsmp, nsamples = 16, 100
    onsets, tt, mask, available = _workload(2)
    detect = cuda_migrate.CudaDetect(tt, (10, 9, 8), fsmp, nsamples, "cpu",
                                     tile=64, brick_shape=(4, 4, 4))
    assert detect.kernel is cuda_migrate.migrate_detect_v2_cuda
    assert detect.fine16.dtype == torch.int16
    assert detect.span_off.dtype == torch.int32
    assert detect.win_floats == int(detect.span_off[-1])
    torch.testing.assert_close(detect.fine16.transpose(1, 2), detect.fine,
                               check_dtype=False, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        detect.launch(torch.zeros((6, 200)), torch.ones(1))
    cuda_migrate.reset_launches()
    detect(*_torch(onsets, mask), available)
    assert detect.launches == 0
    assert cuda_migrate.launches["migrate_detect_v2"] == 0


@pytest.mark.parametrize("variant", cb.V2_ABLATIONS)
def test_v2_ablate_reference(variant):
    """K1's ablation contracts, with noreduce's sums of padding nodes at
    0: this plan's local node 1 is padding in the tiles of the last brick
    layer (nz = 5 = 4 + 1)."""

    node_count, fsmp, nsamples = (5, 6, 5), 5, 30
    plan, args, _ = _small_plan(node_count=node_count, fsmp=fsmp,
                                nsamples=nsamples, tile=64, brick=(4, 4, 4))
    got = cb.v2_ablate_reference(*args, variant)
    ref = cb.detect_reduce_ablate_reference(*args, variant)
    valid = args[3]
    assert (valid[:, 1] == 0).any() and (valid[:, 0] != 0).all()
    if variant == "noreduce":
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
        want = torch.where(valid[:, 1:2] != 0, ref[2], 0.0)
        torch.testing.assert_close(got[2], want, rtol=0, atol=0)
        assert (got[2][valid[:, 1] == 0] == 0).all()
        assert (got[2][valid[:, 1] != 0] != 0).any()
    else:
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown variant"):
        cb.v2_ablate_reference(*args, "noexp")


@pytest.mark.parametrize("seed", [1, 4])
def test_cuda_detect_with_padding_matches_jax(seed):
    """CudaDetect on the CPU (the plain version of its kernel and the
    tile combine) against the JAX VPU Pallas kernel (interpret mode),
    which ties in the same brick order, and the flat migrate_detect, at
    a grid whose bricks overhang it in every axis: 315 real nodes of
    768, one tile with a single real brick column."""

    fsmp, nsamples, node_count = 16, 100, (9, 7, 5)
    work = _workload(seed, node_count=node_count)
    onsets, tt, mask, available = work
    detect = cuda_migrate.CudaDetect(tt, node_count, fsmp, nsamples, "cpu",
                                     tile=128, brick_shape=(4, 4, 4))
    assert detect.valid.numel() == 768
    assert int(detect.valid.sum()) == 315
    max_coa, max_idx, coa_sum = detect(*_torch(onsets, mask),
                                       torch.tensor(available))
    norm = max_coa * detect.n_nodes / coa_sum

    pallas = PallasDetect(tt, node_count, fsmp, nsamples, tile=128,
                          brick_shape=(4, 4, 4), interpret=True)
    ref = [np.asarray(x) for x in pallas(onsets, mask, available)]
    np.testing.assert_allclose(max_coa.numpy(), ref[0], rtol=RTOL)
    np.testing.assert_allclose(norm.numpy(), ref[1], rtol=RTOL)
    assert (max_idx.numpy() == ref[2]).mean() > 0.99
    _assert_tie_consistent(max_idx.numpy(), ref[0], work, fsmp)

    flat = [np.asarray(x) for x in j_migrate.migrate_detect(
        onsets, tt, mask, available, fsmp, nsamples, tile=64)]
    np.testing.assert_allclose(max_coa.numpy(), flat[0], rtol=RTOL)
    np.testing.assert_allclose(norm.numpy(), flat[1], rtol=RTOL)
    _assert_tie_consistent(max_idx.numpy(), flat[0], work, fsmp)
    assert detect.launches == 0
