# -*- coding: utf-8 -*-
"""
The shifted-copy ("X16") detect kernel of quakemigrate_torch (ops.x16,
ops.cuda_x16, experiments/exp_x16.py) on the CPU: the stride table against
a numpy brute force, its detect contract against the plan reference
(exactly: the same values added in the same order) and, with the tile
combine, against the JAX MXU kernel in interpret mode; the plan's largest
shift; the host-side shared-memory sizing; the wrapper refusing CPU
tensors; the machine-code loop census (experiments/sass_loops.py) on a
SASS excerpt; and the entry point exiting without CUDA.

The JAX experiment's ``run_x16`` passes no ``interpret`` argument, so it
does not run on the CPU as it stands; the kernel body ``_x16_kernel``
(experiments/exp_x16.py) does, wrapped in a ``pl.pallas_call`` with
``interpret=True``: layout ``x16b`` gives the MXU bf16 result, while
``x16a`` reads uninitialised padding rows and gives NaN there. Its
contract is held here through the MXU kernel instead. The CUDA kernel
runs only on the card (chip_smoke.py holds it against the plain version
tested here, and bit for bit against the production kernel).
Float32; values at rtol 2e-6 against the JAX kernel, argmax
tie-consistent.

"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.pallas_migrate import PallasDetectMXU
from quakemigrate_torch.experiments import exp_x16, sass_loops
from quakemigrate_torch.ops import cuda_migrate, cuda_x16, migrate, x16

from test_torch_breakdown import _small_plan
from test_torch_migrate import RTOL, _assert_tie_consistent, _torch, _workload

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("stride,fsmp,n_rows,width", [
    (4, 3, 14, 20), (16, 5, 4, 40), (16, 0, 7, 31),
])
def test_stride_table_brute_force(stride, fsmp, n_rows, width):
    rng = np.random.default_rng(stride + width)
    onsets = rng.normal(size=(3, 70)).astype(np.float32)
    table = x16.stride_table(torch.from_numpy(onsets), fsmp, n_rows, width,
                             stride)
    assert table.shape == (3, n_rows, width) and table.dtype == torch.float32
    want = np.zeros((3, n_rows, width), np.float32)
    for o in range(3):
        for a in range(n_rows):
            for u in range(width):
                col = fsmp + stride * a + u
                if col < onsets.shape[1]:
                    want[o, a, u] = onsets[o, col]
    np.testing.assert_array_equal(table.numpy(), want)
    # the last rows run past the end of the onset row: zero there
    assert fsmp + stride * (n_rows - 1) + width > onsets.shape[1]


@pytest.mark.parametrize("seed,node_count,tile,brick,stride", [
    (1, (6, 5, 4), 32, (4, 4, 2), 16),
    (2, (9, 8, 6), 32, (4, 4, 2), 4),
    (3, (9, 8, 6), 64, (4, 4, 4), 16),
    (4, (7, 6, 5), 64, (4, 4, 4), 1),
])
def test_stride_reference_equals_plan_reference(seed, node_count, tile, brick,
                                                stride):
    plan, args, _ = _small_plan(seed=seed, node_count=node_count, tile=tile,
                                brick=brick)
    assert (plan.base % stride).any() or stride == 1  # bases unaligned
    want = cuda_migrate.detect_reduce_plan_reference(*args)
    got = x16.detect_reduce_stride_reference(*args, stride=stride)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    chunked = x16.detect_reduce_stride_reference(
        *args, stride=stride, max_elements=tile * args[-1])
    for g, w in zip(chunked, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", [0, 5])
def test_stride_reference_matches_pallas_mxu(seed):
    """The stride reference with the tile combine against the JAX MXU
    kernel in interpret mode (whose int8 table encodes each log onset to
    within 7.7e-7: RTOL)."""

    fsmp, nsamples, node_count = 16, 100, (10, 9, 8)
    work = _workload(seed)
    onsets, tt, mask, available = work
    mxu = PallasDetectMXU(tt, node_count, fsmp, nsamples, tile=64,
                          brick_shape=(4, 4, 4), interpret=True)
    ref = [np.asarray(x) for x in mxu(onsets, mask, available)]

    plan = cuda_migrate.DetectPlan(tt, node_count, tile=64,
                                   brick_shape=(4, 4, 4))
    logged = migrate._prepare_onsets(*_torch(onsets, mask))
    inv = torch.tensor([1.0 / available], dtype=torch.float32)
    parts = x16.detect_reduce_stride_reference(
        logged, *_torch(plan.base, plan.fine, plan.valid), inv, fsmp,
        nsamples)
    max_coa, max_idx, coa_sum = cuda_migrate.combine_tiles(
        *parts, torch.from_numpy(plan.perm), plan.tile)
    norm = max_coa * plan.n_nodes / coa_sum
    np.testing.assert_allclose(max_coa.numpy(), ref[0], rtol=RTOL)
    np.testing.assert_allclose(norm.numpy(), ref[1], rtol=RTOL)
    assert (max_idx.numpy() == ref[2]).mean() > 0.99
    _assert_tie_consistent(max_idx.numpy(), ref[0], work, fsmp)


def test_plan_max_shift():
    plan, _, _ = _small_plan(node_count=(9, 8, 6), tile=32)
    assert plan.max_shift == int((plan.base[:, :, None] + plan.fine).max())
    tt = np.array([[-3, 5], [7, 2], [0, 0], [1, 1]], np.int32)
    assert cuda_migrate.DetectPlan(tt, (2, 2, 1), tile=8).max_shift == 7


def test_x16_shared_memory_sizing():
    """Four copies of every window, each rounded to 4 floats, in either
    layout; the cross-warp reduction's scratch as a floor; refused past
    the 227 KB a block may use."""

    assert cuda_x16.x16_window_floats(43) == 172
    assert cuda_x16.x16_window_floats(44) == 172
    assert cuda_x16.x16_window_floats(45) == 176
    # the Icequake day-scale plan at tile 512: 24 onsets, r_span 43
    assert cuda_x16.x16_smem(24, 43) == 4 * 4 * 24 * 172 == 66048
    assert cuda_x16.x16_smem(1, 1) == 4 * 3 * cuda_migrate.NWARPS * 128
    assert cuda_x16.LAYOUTS == ("x16a", "x16b")
    largest = cuda_migrate.SMEM_LIMIT // (4 * 4 * 24) // 4 * 4 - 128
    cuda_x16.x16_smem(24, largest)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_x16.x16_smem(24, largest + 4)


def test_x16_wrapper_refuses_cpu_tensors():
    """No plain version runs in the kernel's place, and no launch is
    counted that was not made."""

    plan, args, _ = _small_plan()
    cuda_x16.reset_launches()
    for layout in cuda_x16.LAYOUTS:
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_x16.migrate_detect_x16_cuda(*args, plan.r_span,
                                             plan.max_shift, layout)
    with pytest.raises(ValueError, match="unknown layout"):
        cuda_x16.migrate_detect_x16_cuda(*args, plan.r_span, plan.max_shift,
                                         "x16c")
    assert cuda_x16.launches == {"migrate_detect_x16": 0,
                                 "migrate_detect_x16_v2": 0}


_SASS = """
        Function : _Z28qm_migrate_detect_x16_kernelILi0EEvPKf
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.CONSTANT R17, desc[UR6][R26.64] ;
        /*0020*/                   LDS.128 R16, [R16] ;          /* 0x0000000010107984 */
        /*0030*/                   FADD R16, R16, R20 ;
        /*0040*/              @!P1 LDS R2, [R3] ;
        /*0050*/                @P1 BRA 0x10 ;                    /* 0xfffffffc00007947 */
        /*0060*/                   BRA 0x60 ;
        Function : _Z24qm_migrate_detect_kernelILi0EEvPKf
        /*0000*/                   LDS.64 R2, [R4] ;
        /*0010*/                   EXIT ;
"""


def test_sass_loop_census():
    """The machine-code census that reads the x16 and K1 gather loops."""

    kernels = sass_loops.parse_sass(_SASS)
    assert list(kernels) == ["_Z28qm_migrate_detect_x16_kernelILi0EEvPKf",
                             "_Z24qm_migrate_detect_kernelILi0EEvPKf"]
    x16_ins = kernels["_Z28qm_migrate_detect_x16_kernelILi0EEvPKf"]
    assert x16_ins[2] == (0x20, "LDS.128 R16, [R16]")
    assert sass_loops.loops(x16_ins) == [{
        "start": 0x10, "end": 0x50, "n": 5, "lds32": 1, "lds64": 0,
        "lds128": 1, "ldg": 1, "fadd": 1, "per_node_onset": 20.0,
    }]
    assert sass_loops.loops(
        kernels["_Z24qm_migrate_detect_kernelILi0EEvPKf"]) == []


def test_x16_entry_point_requires_cuda():
    """With no card visible the entry point exits non-zero, before any
    work."""

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "quakemigrate_torch.experiments.exp_x16"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert exp_x16.NSAMPLES == 30_000
    assert (exp_x16.TILE, exp_x16.BRICK) == (512, (8, 8, 8))
    assert exp_x16.CASES == ("ref", "x16a", "x16b")
