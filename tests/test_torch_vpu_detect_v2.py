# -*- coding: utf-8 -*-
"""
K2 v2 of quakemigrate_torch (``csrc/migrate_detect_vpu_v2.cu``, the
VPU-plan detect kernel on an mbarrier ring) on the CPU: its residual
table (uint16, pass-major, the 0-3 floats of window alignment folded in,
padding nodes at residual 0) against ``DetectPlan.base``, ``fine`` and
``valid`` at several ``fsmp``, the window
layout, the onset-independent shared memory, its plain version against
the plan reference (bit for bit) and against the JAX ``PallasDetect`` in
interpret mode (rtol 2e-6, argmax tie-consistent), the shapes the kernel
is built for against the source, and the wrapper refusing what the
kernel does not take. The kernel runs only on the card, where
chip_smoke.py holds it bit for bit against K2 v1 and, in tmax and targ,
against K1.

"""

import re

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.pallas_migrate import PallasDetect
from quakemigrate_torch import _build
from quakemigrate_torch.ops import cuda_migrate as cm
from quakemigrate_torch.ops.migrate import _prepare_onsets

from test_torch_migrate import RTOL, _assert_tie_consistent, _torch, _workload

torch.set_num_threads(1)


def _plan(node_count=(17, 15, 9), n_onsets=7, tile=512, brick=(8, 8, 8),
          hi=60, seed=6):
    rng = np.random.default_rng(seed)
    tt = rng.integers(-2, hi, size=(int(np.prod(node_count)), n_onsets))
    return cm.DetectPlan(tt.astype(np.int32), node_count, tile=tile,
                         brick_shape=brick)


@pytest.mark.parametrize("fsmp", [0, 1, 2, 3, 475])
@pytest.mark.parametrize("tile,brick", [
    (64, (4, 4, 4)), (128, (8, 4, 4)), (256, (8, 8, 4)), (512, (8, 8, 8)),
])
def test_residual_table_against_the_plan(fsmp, tile, brick):
    """Entry [i, p, o, w npp + j] is node w (tile / 16) + p npp + j's
    residual at onset o plus the 0-3 floats between the window's first
    column fsmp + base[i, o] and the multiple of 4 below it."""

    plan = _plan(tile=tile, brick=brick)
    t = cm.vpu_v2_tables(plan, fsmp, "cpu")
    npp = cm.vpu_v2_npp(tile)
    assert t.npp == npp == (4 if tile == 64 else 8)
    res = t.res.numpy().astype(np.int64)
    npt, passes = tile // 16, tile // (16 * npp)
    assert t.res.dtype == torch.uint16 and t.res.is_contiguous()
    assert res.shape == (plan.n_tiles, passes, plan.n_onsets, 16 * npp)
    i, p, o, w, j = np.meshgrid(
        np.arange(plan.n_tiles), np.arange(passes),
        np.arange(plan.n_onsets), np.arange(16), np.arange(npp),
        indexing="ij")
    n = w * npt + p * npp + j
    want = (fsmp + plan.base[i, o]) % 4 + plan.fine[i, o, n]
    np.testing.assert_array_equal(res, want.reshape(res.shape))
    # every read of a 128-sample block stays inside the staged window
    stride, box, n_boxes = cm.vpu_v2_layout(plan.r_span)
    assert res.max() + cm.VPU_V2_SBLK <= box * n_boxes <= stride
    # padding nodes read at residual 0, as K2 v1 reads them
    pad = (plan.valid[i, n] == 0).reshape(res.shape)
    assert pad.any() and (~pad).any()
    np.testing.assert_array_equal(res[pad], (fsmp + plan.base[i, o]).reshape(
        res.shape)[pad] % 4)
    assert (t.stride, t.box, t.n_boxes) == (stride, box, n_boxes)


@pytest.mark.parametrize("r_span,want", [
    (1, (160, 132, 1)),     # 131 floats rounded up to 4
    (43, (192, 176, 1)),    # the Icequake VPU plan
    (125, (256, 256, 1)),   # the widest single box
    (126, (512, 256, 2)),
    (700, (1024, 256, 4)),
])
def test_window_layout(r_span, want):
    stride, box, n_boxes = cm.vpu_v2_layout(r_span)
    assert (stride, box, n_boxes) == want
    assert box % 4 == 0 and box <= cm.TMA_MAX_BOX and stride % 32 == 0
    assert box * n_boxes >= r_span + 3 + cm.VPU_V2_SBLK - 1
    assert n_boxes == 1 or box % 32 == 0


@pytest.mark.parametrize("n_onsets", [24, 256])
def test_smem_does_not_grow_with_onsets(n_onsets):
    """A K2 v2 block holds its ring and reduction scratch whatever the
    onset count: 57,536 bytes at r_span 43 (4 stages of 8 onsets' 192-float
    windows and 256-byte residual slices, 24 KB of scratch, 8
    mbarriers). At 256 onsets K1 v2 refuses the same geometry, and K2 v2
    takes it."""

    plan = _plan(node_count=(12, 12, 10), n_onsets=n_onsets, hi=40)
    smem = cm.vpu_v2_smem(plan.tile, plan.r_span, 4)
    stride, _, _ = cm.vpu_v2_layout(plan.r_span)
    assert smem == (128 + 4 * cm.VPU_V2_GROUP * (4 * stride + 256)
                    + 4 * 3 * 16 * 128 + 64)
    assert smem <= cm.SMEM_LIMIT
    assert cm.vpu_v2_smem(512, 43, 4) == 57536
    # tile 64: 4 nodes a pass, a 128-byte residual slice an onset
    assert cm.vpu_v2_smem(64, 43, 3) == 128 + 3 * 7168 + 24576 + 48
    k1 = cm.DetectPlan(plan_tt(plan, n_onsets), (12, 12, 10))
    refusal = cm.v2_refusal(k1.n_onsets, k1.tile, k1.win_floats, k1.r_span)
    assert (refusal is None) == (n_onsets == 24)
    assert cm.vpu_v2_refusal(k1.tile, k1.r_span) is None


def plan_tt(plan, n_onsets, seed=6):
    """The traveltimes :func:`_plan` drew for ``plan``."""

    rng = np.random.default_rng(seed)
    return rng.integers(-2, 40, size=(plan.n_nodes, n_onsets)).astype(
        np.int32)


@pytest.mark.parametrize("tile,brick,fsmp", [
    (64, (4, 4, 4), 16), (512, (8, 8, 8), 13), (512, (8, 8, 8), 2),
    (256, (8, 8, 4), 7),
])
def test_plain_version_equals_the_plan_reference(tile, brick, fsmp):
    """Through its table the plain version adds the same values in the
    same order as the plan reference: equal bit for bit."""

    plan = _plan(tile=tile, brick=brick)
    rng = np.random.default_rng(3)
    nsamples = 150
    t_len = fsmp + nsamples + plan.max_shift + 3
    onsets = torch.from_numpy(
        rng.gamma(2.0, 1.5, size=(plan.n_onsets, t_len)).astype(np.float32))
    mask = torch.ones(plan.n_onsets)
    mask[-1] = 0.0
    onsets_log = _prepare_onsets(onsets, mask)
    base, fine, valid = _torch(plan.base, plan.fine, plan.valid)
    inv = (1.0 / mask.sum()).reshape(1)
    want = cm.detect_reduce_plan_reference(onsets_log, base, fine, valid,
                                           inv, fsmp, nsamples)
    t = cm.vpu_v2_tables(plan, fsmp, "cpu")
    got = cm.vpu_v2_reference(onsets_log, base, valid, inv, fsmp, nsamples,
                              t)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="fsmp"):
        cm.vpu_v2_reference(onsets_log, base, valid, inv, fsmp + 1,
                            nsamples, t)


@pytest.mark.parametrize("seed,tile,brick", [
    (0, 64, (4, 4, 4)),
    (3, 512, (8, 8, 8)),
])
def test_cuda_detect_vpu_matches_pallas_detect(seed, tile, brick):
    """CudaDetectVPU on CPU tensors (K2 v2's plain version) against the
    JAX VPU kernel in interpret mode: max_coa, max_coa_n and max_idx."""

    fsmp, nsamples, node_count = 16, 100, (10, 9, 8)
    work = _workload(seed)
    onsets, tt, mask, available = work
    pallas = PallasDetect(tt, node_count, fsmp, nsamples, tile=tile,
                          brick_shape=brick, interpret=True)
    ref = [np.asarray(x) for x in pallas(onsets, mask, available)]
    detect = cm.CudaDetectVPU(tt, node_count, fsmp, nsamples, "cpu",
                              tile=tile, brick_shape=brick)
    assert detect.kernel is cm.migrate_detect_vpu_v2_cuda
    got = [x.numpy() for x in detect(*_torch(onsets, mask), available)]
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL)
    assert (got[2] == ref[2]).mean() > 0.99
    _assert_tie_consistent(got[2], ref[0], work, fsmp)
    assert detect.launches == 0


@pytest.mark.parametrize("fsmp", [16, 3])
def test_plain_version_matches_pallas_detect(fsmp):
    """K2 v2's plain version through its tables, at a window start on a
    multiple of 4 and off it, against the JAX VPU kernel in interpret
    mode (tmax per tile and sample, through the same brick plan)."""

    nsamples, node_count = 100, (10, 9, 8)
    work = _workload(5)
    onsets, tt, mask, available = work
    pallas = PallasDetect(tt, node_count, fsmp, nsamples, tile=512,
                          brick_shape=(8, 8, 8), interpret=True)
    ref = [np.asarray(x) for x in pallas(onsets, mask, available)]
    plan = cm.DetectPlan(tt, node_count, tile=512, brick_shape=(8, 8, 8))
    t = cm.vpu_v2_tables(plan, fsmp, "cpu")
    onsets_log = _prepare_onsets(*_torch(onsets, mask))
    base, valid = _torch(plan.base, plan.valid)
    parts = cm.vpu_v2_reference(onsets_log, base, valid,
                                torch.tensor([1.0 / available]), fsmp,
                                nsamples, t)
    max_coa, max_idx, _ = cm.combine_tiles(*parts, torch.from_numpy(
        plan.perm), plan.tile)
    np.testing.assert_allclose(max_coa.numpy(), ref[0], rtol=RTOL)
    _assert_tie_consistent(max_idx.numpy(), ref[0], work, fsmp)


def _wrapper_args(tile=64, brick=(4, 4, 4)):
    plan = _plan(node_count=(8, 8, 8), n_onsets=3, tile=tile, brick=brick)
    t = cm.vpu_v2_tables(plan, 5, "cpu")
    base, valid = _torch(plan.base, plan.valid)
    onsets_log = torch.zeros((3, 5 + 40 + plan.max_shift))
    return plan, t, (onsets_log, base, valid, torch.ones(1), 5, 40, t)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """No plain version runs in the kernel's place, and no launch is
    counted that was not made."""

    cm.reset_launches()
    plan, t, args = _wrapper_args()
    with pytest.raises(ValueError, match="CUDA tensors"):
        cm.migrate_detect_vpu_v2_cuda(*args)
    with pytest.raises(ValueError, match="fsmp"):
        cm.migrate_detect_vpu_v2_cuda(*args[:4], 6, *args[5:])
    with pytest.raises(ValueError, match="n_stages"):
        cm.migrate_detect_vpu_v2_cuda(*args, n_stages=5)
    bad = [
        (dict(res=t.res.to(torch.int32)), "uint16"),
        (dict(res=t.res[:, :, :2].contiguous()), "inconsistent"),
        (dict(res=t.res.transpose(2, 3)), "contiguous"),
        (dict(box=t.box + 4), "window layout"),
    ]
    for change, match in bad:
        wrong = (*args[:6], type(t)(**{**vars(t), **change}))
        with pytest.raises(ValueError, match=match):
            cm.migrate_detect_vpu_v2_cuda(*wrong)
    # a residual table that does not start on 16 bytes
    flat = torch.zeros(t.res.numel() + 1, dtype=torch.uint16)
    shifted = flat[1:].view(t.res.shape)
    wrong = (*args[:6], type(t)(**{**vars(t), "res": shifted}))
    with pytest.raises(ValueError, match="16-byte"):
        cm.migrate_detect_vpu_v2_cuda(*wrong)
    with pytest.raises(ValueError, match="tile"):
        cm.vpu_v2_tables(_plan(tile=32, brick=(4, 4, 2)), 0, "cpu")
    assert set(cm.launches.values()) == {0}


def test_cuda_detect_vpu_runs_k2_v2():
    """K2 v2 at tile 512: 8 nodes a warp a pass, 8 onsets a stage, the
    deepest ring that fits (4 stages here, 2 for a residual span so wide
    that 4 or 3 would not fit, none past that). K1 v2's int16 table is
    neither built nor put on the device."""

    tt = np.zeros((8 * 8 * 8, 2), np.int32)
    detect = cm.CudaDetectVPU(tt, (8, 8, 8), 3, 10, "cpu")
    assert detect.kernel is cm.migrate_detect_vpu_v2_cuda
    assert (detect.tables.npp, detect.n_stages) == (8, 4)
    assert detect.tables.fsmp == 3
    assert detect.fine.dtype == torch.int32  # K2 v1's table, its yardstick
    assert not hasattr(detect, "fine16")
    tt[1, 1] = 2200
    plan = cm.DetectPlan(tt, (8, 8, 8), tile=512, brick_shape=(8, 8, 8))
    wide = cm.CudaDetectVPU(tt, (8, 8, 8), 3, 10, "cpu", plan=plan)
    assert "fine16" not in vars(plan)  # the cached table was never built
    assert wide.r_span == 2201 and wide.n_stages == 2
    assert cm.vpu_v2_stages(512, 2201) == 2
    assert cm.vpu_v2_smem(512, 2201, 3) > cm.SMEM_LIMIT
    assert cm.vpu_v2_smem(512, 2201, 2) <= cm.SMEM_LIMIT
    assert cm.vpu_v2_stages(512, 3200) is None
    assert "shared memory" in cm.vpu_v2_refusal(512, 3200)
    assert "uint16" in cm.vpu_v2_refusal(512, 2**16 - 2)
    assert "tile" in cm.vpu_v2_refusal(32, 43)
    assert cm.vpu_v2_refusal(256, 2201) is None


def test_kernel_shapes_match_the_source():
    """The (tile, nodes a pass) that the host uses, one a tile, and the
    onsets a stage are the ones csrc/migrate_detect_vpu_v2.cu builds."""

    src = (_build.CSRC_DIR / "migrate_detect_vpu_v2.cu").read_text()
    line = src[src.index("#define QW_SHAPES(X)"):]
    line = line[:line.index("\n")]
    built = [(16 * int(a), int(b))
             for a, b in re.findall(r"X\((\d+), (\d+)\)", line)]
    assert sorted(built) == sorted(cm.VPU_V2_NPP.items())
    assert set(cm.VPU_V2_NPP) == set(cm.VPU_TILES)
    assert re.search(r"#define QW_SBLK (\d+)", src).group(1) == str(
        cm.VPU_V2_SBLK)
    assert re.search(r"#define QW_GRP (\d+)", src).group(1) == str(
        cm.VPU_V2_GROUP)
