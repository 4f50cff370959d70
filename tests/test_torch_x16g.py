# -*- coding: utf-8 -*-
"""
The stride-16 table detect kernel on the tensor cores ("X16G") of
quakemigrate_torch (ops.x16g, ops.cuda_x16g, experiments/exp_x16g.py) on
the CPU: the 16-aligned plan against ``PallasDetectMXU``'s; the hi/lo
split against ``jax.lax.reduce_precision`` bit for bit; the table
geometry and coarse-select targets against ``run_x16g``'s host formulas;
the plain version with the tile combine against the JAX experiment
kernel ``_x16g_kernel`` (experiments/exp_x16g.py) in a test-local
``pl.pallas_call`` in interpret mode that copies ``run_x16g``'s prologue,
in the forms (fuse, aligned) the TPU ran, and against
``PallasDetectMXU(precision="bf16")`` in interpret mode; ``noreduce``
against the JAX kernel's; the shared-memory sizing; the wrapper refusing
CPU tensors; and the entry point exiting without CUDA.

Float32 with bf16 hi/lo tables on both sides: values at rtol 1e-6 (the
f32 sums run in other orders), argmax tie-consistent: where two paths
pick different nodes, the float64 coalescence through the hi/lo tables
at the port's node is within 2e-6 of the maximum. The CUDA kernel runs
only on the card (chip_smoke.py holds it against the plain version tested
here, and within the hi/lo bound against the production kernel).

"""

import os
import pathlib
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from quakemigrate_tpu.ops.migrate import _build_shift_table
from quakemigrate_tpu.ops.migrate import _prepare_onsets as j_prepare_onsets
from quakemigrate_tpu.ops.pallas_migrate import (
    LANE,
    PallasDetectMXU,
    _combine_tiles,
    _round_up,
)
from quakemigrate_torch.experiments import exp_x16g
from quakemigrate_torch.ops import cuda_migrate, cuda_x16g, migrate, x16g

from test_torch_breakdown import _small_plan
from test_torch_migrate import _torch, _workload

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from experiments import exp_x16g as j_exp  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-6
TIE_RTOL = 2e-6
FSMP, NSAMPLES, NODE_COUNT, TILE, BRICK = 16, 100, (10, 9, 8), 64, (4, 4, 4)


def _jax_x16g(onsets, mask, available, fine_t, base, valid, fsmp, nsamples,
              tile, r_spans, sblk, fuse=False, aligned=False, ablate="full"):
    """``run_x16g`` (exp_x16g.py:204-288) with ``interpret=True``,
    returning the kernel's per-tile (tmax, targ, tsum) in place of their
    sum. The prologue is copied line for line."""

    onsets_log = j_prepare_onsets(onsets, mask).astype(jnp.float32)
    n_tiles, n_onsets = base.shape
    s_pad = _round_up(nsamples, sblk)
    n_sblocks = s_pad // sblk
    a_counts = tuple(r // 16 for r in r_spans)
    a_sum = sum(a_counts)
    m_pad = _round_up(a_sum, 16)
    K = 16 * (m_pad if (fuse or aligned) else a_sum)
    W = sblk + 2 * LANE
    U = s_pad + 2 * LANE

    table, d_max = _build_shift_table(onsets_log, fsmp, nsamples)
    del table
    d_pad = _round_up(d_max + 1 + max(r_spans), 16)
    a_pad = _round_up(d_pad // 16, 16)

    t_need = fsmp + 16 * (a_pad - 1) + U
    x = jnp.pad(
        onsets_log, ((0, 0), (0, max(0, t_need - onsets_log.shape[-1])))
    )
    idx = 16 * jnp.arange(a_pad)[:, None] + jnp.arange(U)[None, :]
    x16 = x[:, fsmp + idx].reshape(n_onsets * a_pad, U)
    hi_exact = jax.lax.reduce_precision(x16, exponent_bits=8,
                                        mantissa_bits=7)
    hi = hi_exact.astype(jnp.bfloat16)
    lo = (x16 - hi_exact).astype(jnp.bfloat16)

    o_of_m = np.repeat(np.arange(n_onsets), a_counts)
    q_of_m = np.concatenate([np.arange(a) for a in a_counts])
    want = jnp.full((n_tiles, m_pad, 1), -1, jnp.int32)
    want = want.at[:, :a_sum, 0].set(
        o_of_m[None, :] * a_pad + (base // 16)[:, o_of_m] + q_of_m[None, :]
    )

    kern = partial(
        j_exp._x16g_kernel, a_counts=a_counts, a_pad=a_pad,
        n_onsets=n_onsets, tile=tile, n_tiles=n_tiles, sblk=sblk,
        n_sblocks=n_sblocks, fuse=fuse, aligned=aligned, ablate=ablate,
    )
    R = n_onsets * a_pad
    tmax, targ, tsum = pl.pallas_call(
        kern,
        grid=(n_sblocks, n_tiles),
        in_specs=[
            pl.BlockSpec((1, m_pad, 1), lambda j, i: (i, 0, 0)),
            pl.BlockSpec((1,), lambda j, i: (0,), memory_space=pltpu.SMEM),
            pl.BlockSpec((1, n_onsets, tile), lambda j, i: (i, 0, 0)),
            pl.BlockSpec((1, tile, 1), lambda j, i: (i, 0, 0)),
            pl.BlockSpec(memory_space=pltpu.HBM),
            pl.BlockSpec(memory_space=pltpu.HBM),
        ],
        out_specs=[
            pl.BlockSpec((1, 1, sblk), lambda j, i: (i, 0, j)),
            pl.BlockSpec((1, 1, sblk), lambda j, i: (i, 0, j)),
            pl.BlockSpec((1, 1, sblk), lambda j, i: (i, 0, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n_tiles, 1, s_pad), jnp.float32),
            jax.ShapeDtypeStruct((n_tiles, 1, s_pad), jnp.int32),
            jax.ShapeDtypeStruct((n_tiles, 1, s_pad), jnp.float32),
        ],
        scratch_shapes=[
            pltpu.VMEM((2, 2, R, W), jnp.bfloat16),
            pltpu.VMEM((m_pad, R), jnp.bfloat16),
            pltpu.VMEM((2, m_pad, W), jnp.bfloat16),
            pltpu.VMEM((1, 1, 1) if fuse else (2, K, sblk), jnp.bfloat16),
            pltpu.VMEM((K, tile), jnp.bfloat16),
            pltpu.SemaphoreType.DMA((2, 2)),
        ],
        interpret=True,
    )(
        want,
        jnp.asarray(1.0 / available, jnp.float32).reshape(1),
        fine_t, valid, hi, lo,
    )
    return tmax, targ, tsum


def _port(seed, ablate="full"):
    """The port's plain version on the tests/test_pallas.py workload:
    (per-tile outputs, plan, tables, workload)."""

    work = _workload(seed)
    onsets, tt, mask, available = work
    plan = cuda_migrate.DetectPlan(tt, NODE_COUNT, tile=TILE,
                                   brick_shape=BRICK)
    base16, fine16, r16 = x16g.align_plan16(plan)
    logged = migrate._prepare_onsets(*_torch(onsets, mask))
    hi, lo, a_pad = x16g.x16g_tables(logged, FSMP, NSAMPLES, r16,
                                     plan.max_shift)
    inv = torch.tensor([1.0 / available], dtype=torch.float32)
    parts = x16g.detect_reduce_x16g_reference(
        hi, lo, a_pad, *_torch(base16, fine16, plan.valid), inv, NSAMPLES,
        ablate=ablate)
    return parts, plan, (hi, lo, a_pad), work


def _hilo_coa_at(tables, work, idx):
    """Float64 coalescence through the hi/lo tables of flat node idx[t]."""

    hi, lo, a_pad = tables
    onsets, tt, mask, available = work
    x = (hi.double() + lo.double()).numpy().reshape(len(mask), a_pad, -1)
    t = np.arange(len(idx))
    shift = np.maximum(tt[idx], 0)  # [S, O]
    acc = sum(x[o, shift[:, o] // 16, shift[:, o] % 16 + t]
              for o in range(len(mask)))
    return np.exp(acc / available)


def _assert_matches(parts, plan, tables, work, ref_max, ref_idx, ref_norm):
    max_coa, max_idx, coa_sum = cuda_migrate.combine_tiles(
        *parts, torch.from_numpy(plan.perm), plan.tile)
    np.testing.assert_allclose(max_coa.numpy(), ref_max, rtol=RTOL)
    if ref_norm is not None:
        norm = max_coa * plan.n_nodes / coa_sum
        np.testing.assert_allclose(norm.numpy(), ref_norm, rtol=RTOL)
    assert (max_idx.numpy() == ref_idx).mean() > 0.99
    np.testing.assert_allclose(_hilo_coa_at(tables, work, max_idx.numpy()),
                               ref_max, rtol=TIE_RTOL)


@pytest.mark.parametrize("seed,node_count,tile,brick", [
    (1, (10, 9, 8), 64, (4, 4, 4)),
    (2, (12, 8, 6), 128, (8, 4, 4)),
    (3, (17, 9, 5), 256, (8, 8, 4)),
])
def test_align_plan16_equals_pallas_mxu(seed, node_count, tile, brick):
    rng = np.random.default_rng(seed)
    n_nodes = int(np.prod(node_count))
    tt = rng.integers(-3, 90, size=(n_nodes, 5)).astype(np.int32)
    plan = cuda_migrate.DetectPlan(tt, node_count, tile=tile,
                                   brick_shape=brick)
    base16, fine16, r16 = x16g.align_plan16(plan)
    mxu = PallasDetectMXU(tt, node_count, FSMP, NSAMPLES, tile=tile,
                          brick_shape=brick, precision="bf16",
                          interpret=True)
    np.testing.assert_array_equal(base16, np.asarray(mxu.plan.base))
    np.testing.assert_array_equal(fine16, np.asarray(mxu.fine_t))
    assert r16 == mxu.r_spans
    assert base16.dtype == fine16.dtype == np.int32
    assert (base16 % 16 == 0).all() and (plan.base % 16).any()
    assert (fine16 < np.array(r16)[None, :, None]).all()


def test_hilo_equals_reduce_precision():
    rng = np.random.default_rng(4)
    x = np.concatenate([
        rng.normal(scale=3.0, size=4000), rng.uniform(-1e-30, 1e-30, 100),
        np.log(np.clip(rng.gamma(2.0, 1.5, 1000), 0.01, None)),
        [0.0, -0.0, 1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, 65504.0, -4.60517],
    ]).astype(np.float32)
    hi_exact = jax.lax.reduce_precision(jnp.asarray(x), exponent_bits=8,
                                        mantissa_bits=7)
    want_hi = np.asarray(hi_exact.astype(jnp.bfloat16))
    want_lo = np.asarray((jnp.asarray(x) - hi_exact).astype(jnp.bfloat16))
    hi, lo = x16g.hilo(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(hi.view(torch.int16).numpy(),
                                  want_hi.view(np.int16))
    np.testing.assert_array_equal(lo.view(torch.int16).numpy(),
                                  want_lo.view(np.int16))
    # the pair's error bound: |x - hi - lo| <= |x| 2**-17, nearly attained
    err = np.abs(x.astype(np.float64) - hi.double().numpy()
                 - lo.double().numpy())
    assert (err <= np.abs(x) * 2.0**-17).all()
    assert (err > np.abs(x) * 2.0**-18).any()


@pytest.mark.parametrize("seed", [0, 3])
def test_geometry_and_targets_equal_run_x16g(seed):
    onsets, tt, mask, available = _workload(seed)
    plan = cuda_migrate.DetectPlan(tt, NODE_COUNT, tile=TILE,
                                   brick_shape=BRICK)
    base16, _, r16 = x16g.align_plan16(plan)
    onsets_log = j_prepare_onsets(onsets, mask).astype(jnp.float32)
    _, d_max = _build_shift_table(onsets_log, FSMP, NSAMPLES)
    d_pad = _round_up(d_max + 1 + max(r16), 16)
    a_pad = _round_up(d_pad // 16, 16)
    assert x16g.geometry(onsets.shape[1], FSMP, NSAMPLES, r16) == (
        d_max, d_pad, a_pad)

    counts = tuple(r // 16 for r in r16)
    a_sum, m_pad = sum(counts), _round_up(sum(counts), 16)
    o_of_m = np.repeat(np.arange(len(counts)), counts)
    q_of_m = np.concatenate([np.arange(a) for a in counts])
    want = jnp.full((plan.n_tiles, m_pad, 1), -1, jnp.int32)
    want = want.at[:, :a_sum, 0].set(
        o_of_m[None, :] * a_pad + (base16 // 16)[:, o_of_m] + q_of_m[None, :])
    got = x16g.coarse_targets(base16, r16, a_pad)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(x16g.a_offsets(r16),
                                  np.concatenate([[0], np.cumsum(counts)]))
    with pytest.raises(ValueError, match="past the table"):
        x16g.coarse_targets(base16, r16, int(got[..., 0].max() % a_pad))


@pytest.mark.parametrize("fuse,aligned", [
    (False, False), (False, True), (True, False),
])
def test_reference_matches_jax_x16g_kernel(fuse, aligned):
    parts, plan, tables, work = _port(0)
    onsets, tt, mask, available = work
    mxu = PallasDetectMXU(tt, NODE_COUNT, FSMP, NSAMPLES, tile=TILE,
                          brick_shape=BRICK, precision="bf16")
    p = mxu.plan
    ref = _jax_x16g(onsets, mask, available, mxu.fine_t, p.base, p.valid,
                    FSMP, NSAMPLES, p.tile, mxu.r_spans, 128, fuse=fuse,
                    aligned=aligned)
    max_coa, max_idx, coa_sum = _combine_tiles(*ref, p.perm, p.tile,
                                               NSAMPLES)
    norm = np.asarray(max_coa) * p.n_nodes / np.asarray(coa_sum)
    _assert_matches(parts, plan, tables, work, np.asarray(max_coa),
                    np.asarray(max_idx), norm)


@pytest.mark.parametrize("seed", [0, 5])
def test_reference_matches_pallas_mxu_bf16(seed):
    parts, plan, tables, work = _port(seed)
    onsets, tt, mask, available = work
    mxu = PallasDetectMXU(tt, NODE_COUNT, FSMP, NSAMPLES, tile=TILE,
                          brick_shape=BRICK, precision="bf16",
                          interpret=True)
    ref = [np.asarray(x) for x in mxu(onsets, mask, available)]
    _assert_matches(parts, plan, tables, work, ref[0], ref[2], ref[1])


def test_noreduce_matches_jax_x16g_kernel():
    parts, plan, tables, work = _port(0, ablate="noreduce")
    onsets, tt, mask, available = work
    mxu = PallasDetectMXU(tt, NODE_COUNT, FSMP, NSAMPLES, tile=TILE,
                          brick_shape=BRICK, precision="bf16")
    p = mxu.plan
    ref = _jax_x16g(onsets, mask, available, mxu.fine_t, p.base, p.valid,
                    FSMP, NSAMPLES, p.tile, mxu.r_spans, 128, aligned=True,
                    ablate="noreduce")
    ref = [np.asarray(x)[:, 0, :NSAMPLES] for x in ref]
    assert parts[1].dtype == torch.int32
    np.testing.assert_allclose(parts[0].numpy(), ref[0], rtol=RTOL)
    np.testing.assert_allclose(parts[2].numpy(), ref[2], rtol=RTOL)
    assert np.abs(parts[1].numpy() - ref[1]).max() <= 1


def test_reference_chunks_and_refusals():
    plan, args, _ = _small_plan(node_count=(9, 8, 6), tile=32)
    logged, _, _, valid, inv, fsmp, nsamples = args
    base16, fine16, r16 = x16g.align_plan16(plan)
    hi, lo, a_pad = x16g.x16g_tables(logged, fsmp, nsamples, r16,
                                     plan.max_shift)
    assert hi.shape == (plan.n_onsets * a_pad, x16g.table_width(nsamples))
    b16, f16 = _torch(base16, fine16)
    whole = x16g.detect_reduce_x16g_reference(hi, lo, a_pad, b16, f16, valid,
                                              inv, nsamples)
    chunked = x16g.detect_reduce_x16g_reference(
        hi, lo, a_pad, b16, f16, valid, inv, nsamples,
        max_elements=plan.tile * nsamples)
    for w, c in zip(whole, chunked):
        assert torch.equal(w, c)
    # the coalescence at the plain version's own argmax is its max
    at_arg = x16g.coa_at_nodes(hi, lo, a_pad, b16, f16, valid, inv, whole[1])
    assert torch.equal(at_arg, whole[0])
    # within the hi/lo bound of the float32 contract
    exact = cuda_migrate.detect_reduce_plan_reference(*args)
    bound = x16g.hilo_bound(logged, inv)
    assert 0 < bound < 1e-4
    rel = ((whole[0] - exact[0]).abs() / exact[0]).max().item()
    assert rel <= bound
    with pytest.raises(ValueError, match="plain version computes"):
        x16g.detect_reduce_x16g_reference(hi, lo, a_pad, b16, f16, valid,
                                          inv, nsamples, ablate="nomain")
    with pytest.raises(ValueError, match="too short"):
        x16g.x16g_tables(logged[:, :-8], fsmp, nsamples, r16, plan.max_shift)


def test_zero_acc_reference_is_the_contract_on_zero_tables():
    """The closed form of the ablations that zero an operand equals the
    plain version on tables of zeros (acc = 0), ties to the first node."""

    plan, args, _ = _small_plan(node_count=(9, 8, 6), tile=32)
    logged, _, _, valid, inv, fsmp, nsamples = args
    base16, fine16, r16 = x16g.align_plan16(plan)
    hi, lo, a_pad = x16g.x16g_tables(logged, fsmp, nsamples, r16,
                                     plan.max_shift)
    b16, f16 = _torch(base16, fine16)
    assert (valid == 0).any() and (valid == 1).any()
    zero = torch.zeros_like(hi)
    ref = x16g.detect_reduce_x16g_reference(zero, zero, a_pad, b16, f16,
                                            valid, inv, nsamples)
    closed = x16g.zero_acc_reference(valid, nsamples)
    for r, c in zip(ref, closed):
        assert c.dtype == r.dtype and torch.equal(c, r)


def test_x16g_shared_memory_sizing():
    """The staged rows (two copies for fuse) or the double-buffered Hankel
    blocks; the reduction scratch as a floor; refused past 227 KB."""

    # the day-scale plan at tile 512: 24 onsets, A = 84, A_o <= 4
    assert cuda_x16g.x16g_smem(24, 84, 4, False) == 48384 + 65536 + 100
    assert cuda_x16g.x16g_smem(24, 84, 4, True) == 48448 + 48384 + 100
    # two blocks fit an SM's 228 KB with 1 KB reserved each
    assert 2 * (cuda_x16g.x16g_smem(24, 84, 4, False) + 1024) <= 233472
    assert cuda_x16g.x16g_smem(1, 1, 1, True) == 12288 + 8
    with pytest.raises(ValueError, match="shared memory"):
        cuda_x16g.x16g_smem(24, 84, 12, False)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_x16g.x16g_smem(24, 210, 4, True)


def test_x16g_wrapper_refuses_cpu_tensors():
    plan, args, _ = _small_plan()
    logged, _, _, _, inv, fsmp, nsamples = args
    p = cuda_x16g.plan_on_device(plan, "cpu")
    hi, lo, want, _ = cuda_x16g.build_inputs(p, logged, fsmp, nsamples)
    assert want.shape == (plan.n_tiles, 16 * -(-p.a_sum // 16), 1)
    cuda_x16g.reset_launches()
    for fuse in (False, True):
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_x16g.migrate_detect_x16g_cuda(p, hi, lo, want, inv,
                                               nsamples, fuse=fuse)
    with pytest.raises(ValueError, match="unknown ablation"):
        cuda_x16g.migrate_detect_x16g_cuda(p, hi, lo, want, inv, nsamples,
                                           ablate="nodot")
    assert cuda_x16g.launches == {"migrate_detect_x16g": 0,
                                  "migrate_detect_x16g_v2": 0}


def test_x16g_entry_point_requires_cuda():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "quakemigrate_torch.experiments.exp_x16g"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert exp_x16g.NSAMPLES == 30_000
    assert (exp_x16g.TILE, exp_x16g.BRICK) == (512, (8, 8, 8))
    assert set(exp_x16g.CASES) == {"expand", "fuse", "onlymain", "nomain",
                                   "noreduce", "nosel", "noonehot", "noexp"}
    # every ablation of the kernel is launched, and every one but nomain
    # is held to a plain version or a closed form
    assert set(exp_x16g.ABLATION_CASES) == set(x16g.ABLATIONS) - {"full"}
    assert (set(x16g.ABLATIONS) - set(x16g.REFERENCE_ABLATIONS)
            - set(x16g.ZERO_ACC_ABLATIONS)) == {"nomain"}
