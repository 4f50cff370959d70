# -*- coding: utf-8 -*-
"""
Migration of quakemigrate_torch against the JAX reference: the brick
plan, the flat-order plain migration, and the plain version of the CUDA
kernel (with the cross-tile combine) against the JAX Pallas detect in
interpret mode, which uses the same brick order. Float32 throughout;
values at rtol 2e-6 (as tests/test_pallas.py), argmax tie-consistent:
where two paths pick different nodes, the float64 coalescence at the
port's node is within 2e-6 of the maximum.

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops import migrate as j_migrate
from quakemigrate_tpu.ops.pallas_migrate import (
    PallasDetect,
    PallasDetectPlan,
)
from quakemigrate_tpu.ops.pallas_migrate import (
    brick_permutation as j_brick_permutation,
)
from quakemigrate_torch.ops import cuda_migrate, migrate

torch.set_num_threads(1)

RTOL = 2e-6


def _workload(seed, node_count=(10, 9, 8), n_onsets=6, fsmp=16, lsmp=40,
              nsamples=100):
    """The tests/test_pallas.py workload: gamma onsets, random
    traveltimes, the last onset masked."""

    rng = np.random.default_rng(seed)
    n_nodes = int(np.prod(node_count))
    t_len = fsmp + nsamples + lsmp
    onsets = rng.gamma(2.0, 1.5, size=(n_onsets, t_len)).astype(np.float32)
    tt = rng.integers(0, lsmp, size=(n_nodes, n_onsets)).astype(np.int32)
    mask = np.ones(n_onsets, dtype=np.float32)
    mask[-1] = 0.0
    return onsets, tt, mask, float(mask.sum())


def _coa_at(onsets, tt, mask, available, fsmp, idx):
    """Float64 coalescence of node idx[t] at sample t."""

    logged = np.log(np.clip(onsets.astype(np.float64), 0.01, None))
    logged *= mask[:, None]
    t = np.arange(len(idx))
    cols = fsmp + tt[idx].T + t  # [O, S]
    return np.exp(np.take_along_axis(logged, cols, axis=1).sum(0) / available)


def _assert_tie_consistent(got_idx, ref_max, workload, fsmp):
    onsets, tt, mask, available = workload
    at_got = _coa_at(onsets, tt, mask, available, fsmp, got_idx)
    np.testing.assert_allclose(at_got, ref_max, rtol=RTOL)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("node_count,brick", [
    ((7, 6, 5), (4, 4, 4)), ((10, 9, 8), (4, 4, 4)), ((12, 8, 6), (8, 8, 4)),
])
def test_brick_permutation_matches_jax(node_count, brick):
    perm, n_padded = cuda_migrate.brick_permutation(node_count, brick)
    ref_perm, ref_n = j_brick_permutation(node_count, brick)
    assert n_padded == ref_n
    np.testing.assert_array_equal(perm, ref_perm)
    live = perm[perm >= 0]
    assert sorted(live) == list(range(int(np.prod(node_count))))


@pytest.mark.parametrize("node_count,tile,brick", [
    ((10, 9, 8), 64, (4, 4, 4)),
    ((9, 7, 6), 128, (4, 4, 8)),
    ((17, 9, 5), 256, (8, 8, 4)),
])
def test_detect_plan_equals_pallas_plan(node_count, tile, brick):
    rng = np.random.default_rng(3)
    n_nodes = int(np.prod(node_count))
    tt = rng.integers(-3, 60, size=(n_nodes, 5)).astype(np.int32)
    plan = cuda_migrate.DetectPlan(tt, node_count, tile=tile,
                                   brick_shape=brick)
    ref = PallasDetectPlan(tt, node_count, tile=tile, brick_shape=brick,
                           vpu_fine=False)
    np.testing.assert_array_equal(plan.perm, ref.perm)
    np.testing.assert_array_equal(plan.base, ref.base)
    np.testing.assert_array_equal(plan.fine,
                                  ref._fine_raw.transpose(0, 2, 1))
    np.testing.assert_array_equal(plan.valid, ref.valid[..., 0])
    assert plan.fine.dtype == plan.base.dtype == plan.perm.dtype == np.int32
    assert plan.r_spans == tuple(
        int(plan.fine[:, o].max()) + 1 for o in range(5)
    )
    assert plan.r_span == max(plan.r_spans)


@pytest.mark.parametrize("seed", [0, 7])
def test_migrate_detect_matches_jax(seed):
    fsmp, nsamples = 16, 100
    work = _workload(seed)
    onsets, tt, mask, available = work
    ref = [np.asarray(x) for x in j_migrate.migrate_detect(
        onsets, tt, mask, available, fsmp, nsamples, tile=64)]
    got = [x.numpy() for x in migrate.migrate_detect(
        *_torch(onsets, tt, mask), available, fsmp, nsamples, tile=64)]
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL)
    assert got[2].dtype == np.int32
    # flat-order ties on both sides: equal nodes wherever the max is unique
    assert (got[2] == ref[2]).mean() > 0.99
    _assert_tie_consistent(got[2], ref[0], work, fsmp)


@pytest.mark.parametrize("seed", [0, 7])
def test_plan_reference_matches_pallas_detect(seed):
    """The kernel's plain version + combine_tiles against the JAX VPU
    Pallas kernel (interpret mode): both tie in brick order."""

    fsmp, nsamples, node_count = 16, 100, (10, 9, 8)
    work = _workload(seed)
    onsets, tt, mask, available = work
    pallas = PallasDetect(tt, node_count, fsmp, nsamples, tile=64,
                          brick_shape=(4, 4, 4), interpret=True)
    ref = [np.asarray(x) for x in pallas(onsets, mask, available)]

    detect = cuda_migrate.CudaDetect(tt, node_count, fsmp, nsamples, "cpu",
                                     tile=64, brick_shape=(4, 4, 4))
    max_coa, max_idx, coa_sum = detect(
        *_torch(onsets, mask), torch.tensor(available)
    )
    norm = max_coa * detect.n_nodes / coa_sum
    np.testing.assert_allclose(max_coa.numpy(), ref[0], rtol=RTOL)
    np.testing.assert_allclose(norm.numpy(), ref[1], rtol=RTOL)
    assert (max_idx.numpy() == ref[2]).mean() > 0.99
    _assert_tie_consistent(max_idx.numpy(), ref[0], work, fsmp)
    assert detect.launches == 0  # the CPU path launches no kernel


def test_plan_reference_contract():
    """Per tile: max, FIRST local argmax (brick order) and sum, checked
    against a float64 brute force over the plan."""

    fsmp, nsamples, node_count = 5, 30, (6, 5, 4)
    onsets, tt, mask, available = _workload(
        1, node_count=node_count, n_onsets=4, fsmp=fsmp, lsmp=20,
        nsamples=nsamples,
    )
    # a tie inside every tile: two nodes share their traveltimes
    tt[1] = tt[0]
    plan = cuda_migrate.DetectPlan(tt, node_count, tile=32,
                                   brick_shape=(4, 4, 2))
    logged = migrate._prepare_onsets(*_torch(onsets, mask))
    tmax, targ, tsum = cuda_migrate.detect_reduce_plan_reference(
        logged, *_torch(plan.base, plan.fine, plan.valid),
        torch.tensor([1.0 / available], dtype=torch.float32), fsmp, nsamples,
    )
    assert tmax.shape == targ.shape == tsum.shape == (plan.n_tiles, nsamples)

    ref_log = logged.numpy().astype(np.float64)
    t = np.arange(nsamples)
    for i in range(plan.n_tiles):
        cols = (fsmp + plan.base[i][:, None, None] + plan.fine[i][:, :, None]
                + t)  # [O, tile, S]
        acc = np.take_along_axis(
            ref_log[:, None, :].repeat(plan.tile, 1), cols, axis=2
        ).sum(0)
        coa = np.exp(acc / available) * plan.valid[i][:, None]
        np.testing.assert_allclose(tmax[i].numpy(), coa.max(0), rtol=RTOL)
        np.testing.assert_allclose(tsum[i].numpy(), coa.sum(0), rtol=RTOL)
        at_arg = coa[targ[i].numpy(), t]
        np.testing.assert_allclose(at_arg, coa.max(0), rtol=RTOL)
    # the tied pair: the earlier node in brick order wins
    pos = {int(old): new for new, old in enumerate(plan.perm)
           if plan.valid.ravel()[new]}
    first, second = sorted((pos[0], pos[1]))
    tile_i = first // plan.tile
    assert (targ[tile_i].numpy() != second % plan.tile).all()


def test_combine_tiles_first_tile_wins_ties():
    tmax = torch.tensor([[1.0, 3.0, 2.0], [1.0, 5.0, 2.0], [0.5, 5.0, 2.0]])
    targ = torch.tensor([[1, 0, 3], [2, 1, 0], [3, 2, 1]], dtype=torch.int32)
    tsum = torch.ones((3, 3))
    perm = torch.arange(100, 112, dtype=torch.int32)  # tile 4
    max_coa, max_idx, coa_sum = cuda_migrate.combine_tiles(
        tmax, targ, tsum, perm, 4
    )
    np.testing.assert_array_equal(max_coa.numpy(), [1.0, 5.0, 2.0])
    np.testing.assert_array_equal(max_idx.numpy(), [101, 105, 103])
    np.testing.assert_array_equal(coa_sum.numpy(), [3.0, 3.0, 3.0])
    assert max_idx.dtype == torch.int32


@pytest.mark.parametrize("n_total,n_nodes_real,node_offset", [
    (150, 130, 0),    # trailing padding rows in a single slab
    (150, 200, 100),  # mid-grid slab: its own tile padding is invalid
    (150, 180, 100),  # slab straddling the end of the real grid
])
def test_detect_reduce_padded_nodes_match_jax(n_total, n_nodes_real,
                                              node_offset):
    fsmp, nsamples = 16, 100
    onsets, _, mask, available = _workload(2)
    tt = np.random.default_rng(5).integers(
        0, 40, size=(n_total, onsets.shape[0])).astype(np.int32)
    ref = [np.asarray(x) for x in j_migrate.detect_reduce(
        onsets, tt, mask, available, fsmp, nsamples, n_nodes_real,
        tile=64, node_offset=node_offset)]
    got = [x.numpy() for x in migrate.detect_reduce(
        *_torch(onsets, tt, mask), available, fsmp, nsamples, n_nodes_real,
        tile=64, node_offset=node_offset)]
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=RTOL)
    assert got[1].max() < n_nodes_real and got[1].min() >= node_offset


def test_find_max_coa_matches_jax():
    data = np.random.default_rng(9).gamma(2.0, 1.0, size=(70, 30))
    data = data.astype(np.float32)
    data[12, 4] = data[40, 4] = data[:, 4].max() + 1.0  # a tie: first wins
    ref = [np.asarray(x) for x in j_migrate.find_max_coa(
        data, n_nodes_real=60, node_offset=5)]
    got = [x.numpy() for x in migrate.find_max_coa(
        torch.from_numpy(data), n_nodes_real=60, node_offset=5)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=RTOL)
    assert got[2][4] == 12 + 5


def test_short_onset_block_raises():
    fsmp, nsamples = 16, 100
    onsets, tt, mask, available = _workload(4)
    detect = cuda_migrate.CudaDetect(tt, (10, 9, 8), fsmp, nsamples, "cpu",
                                     tile=64, brick_shape=(4, 4, 4))
    max_shift = int(tt.max())
    short = onsets[:, : fsmp + nsamples + max_shift - 1]
    with pytest.raises(ValueError, match="too short"):
        detect(*_torch(short, mask), available)
    # exactly long enough is accepted
    enough = onsets[:, : fsmp + nsamples + max_shift]
    detect(*_torch(np.ascontiguousarray(enough), mask), available)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version in its place."""

    plan = cuda_migrate.DetectPlan(
        np.zeros((64, 2), np.int32), (4, 4, 4), tile=64,
        brick_shape=(4, 4, 4),
    )
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_migrate.migrate_detect_cuda(
            torch.zeros((2, 50)), *_torch(plan.base, plan.fine, plan.valid),
            torch.ones(1), 0, 10, plan.r_span,
        )


def test_plan_rejects_wrong_node_count():
    with pytest.raises(ValueError, match="node_count"):
        cuda_migrate.DetectPlan(np.zeros((10, 2), np.int32), (2, 2, 2))
