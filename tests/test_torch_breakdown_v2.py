# -*- coding: utf-8 -*-
"""
E1c v2 and E1b v2 of quakemigrate_torch on the CPU: the pipelined and
resident detect kernels redesigned on K1 v2's gather core
(``csrc/migrate_detect_pipelined_v2.cu``,
``csrc/migrate_detect_resident_v2.cu``). Their host tables (the uint16
slabs of window offsets, the union layout ``uoff`` and the group) are
checked against brute-force loops; the 2**16 and window-bound errors, the
shared-memory sizing against the kernels' C formulas, and the wrappers'
refusals are checked; the plain versions, which gather through the same
slabs and window layouts, equal ``detect_reduce_plan_reference`` bit for
bit and match the JAX ``PallasDetectMXU`` in interpret mode (rtol 2e-6,
argmax tie-consistent). The JAX breakdown kernels ``_deep_kernel`` and
``_resident_kernel`` take no ``interpret`` argument, so the MXU kernel,
whose contract they share, is the JAX counterpart run here. The CUDA
kernels run only on the card (chip_smoke.py holds them bit for bit to K1
and to these plain versions).

"""

import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.pallas_migrate import PallasDetectMXU
from quakemigrate_torch.experiments import sass_loops
from quakemigrate_torch.ops import cuda_breakdown as cb
from quakemigrate_torch.ops import cuda_migrate, migrate

from test_torch_breakdown import _small_plan
from test_torch_migrate import RTOL, _assert_tie_consistent, _torch, _workload

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SBLK = cuda_migrate.SBLK


def _plans():
    """(plan, args) at three small plans: the breakdown tests' plan (a
    tie, tile 32), a plan with many padding nodes, and one of six tiles
    with tile 64."""

    return {
        "small": _small_plan()[:2],
        "padded": _small_plan(node_count=(5, 6, 5), tile=64,
                              brick=(4, 4, 4))[:2],
        "tiles": _small_plan(seed=3, node_count=(9, 8, 6), tile=32)[:2],
    }


PLANS = ("small", "padded", "tiles")


@pytest.fixture(scope="module")
def plans():
    return _plans()


def test_pipelined_v2_layout():
    # 24 onsets at the day-scale plan: r_span 37, a 165-float window, + 3
    # for a start rounded down to 4 floats, at a 128-byte (32-float)
    # stride
    assert cb.pipelined_v2_layout([19] * 12 + [37] * 12) == (192, 168)
    assert cb.pipelined_v2_layout([1]) == (160, 132)
    assert cb.pipelined_v2_layout([125]) == (256, 256)
    with pytest.raises(ValueError, match="256"):
        cb.pipelined_v2_layout([5, 126])


@pytest.mark.parametrize("name", PLANS)
@pytest.mark.parametrize("fsmp", [5, 6])
def test_pipelined_v2_slab_brute_force(plans, name, fsmp):
    plan, _ = plans[name]
    stride, box = cb.pipelined_v2_layout(plan.r_spans)
    slab = cb.pipelined_v2_slab(plan.fine16, plan.base, fsmp, stride, box)
    row = -(-plan.n_onsets // 8) * 8
    assert slab.dtype == np.uint16 and slab.flags.c_contiguous
    assert slab.shape == (plan.n_tiles, plan.tile, row)
    for i in range(plan.n_tiles):
        for o in range(row):
            # the window's first column lies a past a multiple of 4
            a = (fsmp + int(plan.base[i, o])) % 4 if o < plan.n_onsets else 0
            for n in range(plan.tile):
                want = (o * stride + a + int(plan.fine[i, o, n])
                        if o < plan.n_onsets else 0)
                assert int(slab[i, n, o]) == want
                if o < plan.n_onsets:
                    # every read of the node stays in onset o's box
                    assert o * stride <= want
                    assert want + SBLK <= o * stride + box
    tables = cb.pipelined_v2_tables(plan, fsmp, "cpu")
    assert (tables.stride, tables.box, tables.fsmp) == (stride, box, fsmp)
    assert tables.slab.dtype == torch.uint16
    np.testing.assert_array_equal(tables.slab.numpy(), slab)


def test_pipelined_v2_slab_errors():
    fine16 = np.zeros((2, 16, 3), np.int16)
    fine16[1, 5, 2] = 40
    base = np.zeros((2, 3), np.int32)
    # a read (residual + SBLK) past the box
    with pytest.raises(ValueError, match="window"):
        cb.pipelined_v2_slab(fine16, base, 0, 192, 164)
    assert cb.pipelined_v2_slab(fine16, base, 0, 192,
                                168)[1, 5, 2] == 2 * 192 + 40
    # ... or past it by the start's misalignment (fsmp 3: 3 floats)
    with pytest.raises(ValueError, match="window"):
        cb.pipelined_v2_slab(fine16, base, 3, 192, 168)
    assert cb.pipelined_v2_slab(fine16, base, 4, 192,
                                168)[1, 5, 2] == 2 * 192 + 40
    # an entry at 2**16: onset 342 at a 192-float stride
    with pytest.raises(ValueError, match="2\\*\\*16"):
        cb.pipelined_v2_slab(np.zeros((1, 16, 343), np.int16),
                             np.zeros((1, 343), np.int32), 0, 192, 168)
    assert cb.pipelined_v2_slab(np.zeros((1, 16, 342), np.int16),
                                np.zeros((1, 342), np.int32), 0, 192,
                                168).max() == 341 * 192


def _brute_groups(base, r_spans, group):
    """gbase and the per-onset union widths by loops."""

    n_tiles, n_onsets = base.shape
    n_groups = -(-n_tiles // group)
    gbase = np.zeros((n_groups, n_onsets), np.int64)
    spread = np.zeros(n_onsets, np.int64)
    for g in range(n_groups):
        rows = base[g * group:min(n_tiles, (g + 1) * group)]
        for o in range(n_onsets):
            gbase[g, o] = min(rows[:, o])
            spread[o] = max(spread[o], max(rows[:, o]) - gbase[g, o])
    widths = [-(-(spread[o] + 3 + r_spans[o] + SBLK) // 32) * 32
              for o in range(n_onsets)]
    return gbase, np.concatenate([[0], np.cumsum(widths)])


@pytest.mark.parametrize("name", PLANS)
@pytest.mark.parametrize("max_group", [1, 2, 4, 6])
def test_resident_v2_groups_brute_force(plans, name, max_group):
    plan, _ = plans[name]
    group, gbase, uoff = cb.resident_v2_groups(plan.base, plan.r_spans,
                                               plan.tile, max_group)
    # these plans are small: the largest power of two up to max_group
    # keeps 4 blocks to an SM
    assert group == {6: 4}.get(max_group, max_group)
    want_gbase, want_uoff = _brute_groups(plan.base, plan.r_spans, group)
    assert gbase.dtype == np.int32 and uoff.dtype == np.int32
    np.testing.assert_array_equal(gbase, want_gbase)
    np.testing.assert_array_equal(uoff, want_uoff)
    assert (uoff % cb.TMA_ALIGN == 0).all()
    assert cb.blocks_that_fit(cb.resident_v2_smem(
        plan.n_onsets, plan.tile, int(uoff[-1]))) >= 4


def test_resident_v2_groups_shrink_to_keep_four_blocks():
    """The day-scale shape: 24 onsets, tile 256, r_spans 19 and 37.
    Bases 191 apart in pairs of tiles give unions of 352 and 384 floats
    at group 2 and more: 3 blocks an SM. Group 1 keeps 5."""

    r_spans = [19] * 12 + [37] * 12
    base = np.zeros((8, 24), np.int32)
    base[1::2] = 191
    group, gbase, uoff = cb.resident_v2_groups(base, r_spans, 256,
                                               max_group=8)
    assert group == 1
    np.testing.assert_array_equal(gbase, base)
    assert uoff[-1] == 12 * 160 + 12 * 192
    smem = cb.resident_v2_smem(24, 256, int(uoff[-1]))
    assert cb.blocks_that_fit(smem) == 5
    # with pairs only 95 apart, every group up to 8 keeps 4 blocks
    base[1::2] = 95
    group, _, uoff = cb.resident_v2_groups(base, r_spans, 256, max_group=8)
    assert group == 8 and uoff[-1] == 12 * 256 + 12 * 288
    assert cb.blocks_that_fit(cb.resident_v2_smem(24, 256,
                                                  int(uoff[-1]))) == 4
    # even one tile a group cannot keep 4 blocks of 60 onsets
    with pytest.raises(ValueError, match="fewer than 4 blocks"):
        cb.resident_v2_groups(np.zeros((4, 60), np.int32), [37] * 60, 256)


@pytest.mark.parametrize("name", PLANS)
@pytest.mark.parametrize("fsmp", [5, 6])
def test_resident_v2_slab_brute_force(plans, name, fsmp):
    plan, _ = plans[name]
    group, gbase, uoff = cb.resident_v2_groups(plan.base, plan.r_spans,
                                               plan.tile, 2)
    slab, woff = cb.resident_v2_slab(plan.fine16, plan.base, gbase, uoff,
                                     group, fsmp)
    row = -(-plan.n_onsets // 8) * 8
    assert slab.dtype == np.uint16 and slab.shape == (plan.n_tiles,
                                                      plan.tile, row)
    assert woff.dtype == np.int32 and woff.shape == (plan.n_tiles,
                                                     plan.n_onsets)
    for i in range(plan.n_tiles):
        for o in range(plan.n_onsets):
            # the union starts at fsmp + gbase rounded down to 4 floats
            start = (fsmp + int(gbase[i // group, o])) // 4 * 4
            w = int(uoff[o]) + fsmp + int(plan.base[i, o]) - start
            assert woff[i, o] == w
            for n in range(plan.tile):
                entry = int(slab[i, n, o])
                assert entry == w + int(plan.fine[i, o, n])
                # the read stays inside onset o's union window
                assert uoff[o] <= entry and entry + SBLK <= uoff[o + 1]
        assert (slab[i, :, plan.n_onsets:] == 0).all()
    tables = cb.resident_v2_tables(plan, fsmp, "cpu", max_group=2)
    assert tables.group == group and tables.win_floats == int(uoff[-1])
    assert tables.fsmp == fsmp
    np.testing.assert_array_equal(tables.slab.numpy(), slab)
    np.testing.assert_array_equal(tables.woff.numpy(), woff)
    np.testing.assert_array_equal(tables.gbase.numpy(), gbase)
    np.testing.assert_array_equal(tables.uoff.numpy(), uoff)


def test_resident_v2_slab_errors():
    fine16 = np.zeros((2, 16, 2), np.int16)
    fine16[:, 3, 1] = 10
    base = np.array([[0, 0], [5, 7]], np.int32)
    gbase = np.array([[0, 0]], np.int32)
    # onset 1's union must hold base spread 7 + residual 10 + SBLK
    uoff = np.array([0, 160, 160 + 7 + 10 + SBLK], np.int32)
    slab, woff = cb.resident_v2_slab(fine16, base, gbase, uoff, 2, 0)
    assert slab[1, 3, 1] == 160 + 7 + 10 and woff[1, 0] == 5
    # fsmp 2: the union starts 2 floats early, every offset 2 later
    with pytest.raises(ValueError, match="union window"):
        cb.resident_v2_slab(fine16, base, gbase, uoff, 2, 2)
    uoff[2] += 2
    slab, woff = cb.resident_v2_slab(fine16, base, gbase, uoff, 2, 2)
    assert slab[1, 3, 1] == 2 + 160 + 7 + 10 and woff[1, 0] == 2 + 5
    uoff[2] -= 3
    with pytest.raises(ValueError, match="union window"):
        cb.resident_v2_slab(fine16, base, gbase, uoff, 2, 0)
    # a base below the group's: reads before the union
    with pytest.raises(ValueError, match="union window"):
        cb.resident_v2_slab(fine16, base, np.array([[4, 0]], np.int32),
                            np.array([0, 160, 320], np.int32), 2, 0)
    # an entry at 2**16
    big = np.array([0, 65530, 65536 + 160], np.int32)
    with pytest.raises(ValueError, match="2\\*\\*16"):
        cb.resident_v2_slab(fine16, base, gbase, big, 2, 0)


def test_v2_smem_sizing():
    """The C formulas (qp_smem_bytes, qr_smem_bytes): 128 bytes of
    alignment slack; E1c v2 NS slots of max(O x stride, 3 x 8 x 128)
    floats, the slab (tile x O rounded up to 8, uint16), valid and 2 NS
    + 1 mbarriers; E1b v2 the union windows, two buffers of max(slab,
    reduction scratch), two of valid and 3 mbarriers."""

    red = 4 * 3 * 8 * 128
    slab = 2 * 256 * 24
    for ns in (2, 3, 4):
        want = 128 + ns * 4 * 24 * 192 + slab + 4 * 256 + 8 * (2 * ns + 1)
        assert cb.pipelined_v2_smem(24, 256, 192, ns) == want
    assert cb.pipelined_v2_smem(24, 256, 192, 2) == 50344
    # few onsets: the slot holds the reduction scratch
    assert cb.pipelined_v2_smem(4, 32, 160, 2) == (
        128 + 2 * red + 2 * 32 * 8 + 4 * 32 + 40)
    assert [cb.blocks_that_fit(cb.pipelined_v2_smem(24, 256, 192, ns))
            for ns in (2, 3, 4)] == [4, 3, 2]
    assert cb.resident_v2_smem(24, 256, 7552) == (
        128 + 4 * 7552 + 2 * max(slab, red) + 8 * 256 + 24) == 56984
    assert cb.resident_v2_smem(4, 32, 640) == (
        128 + 4 * 640 + 2 * red + 8 * 32 + 24)
    assert cb.blocks_that_fit(56984) == 4
    assert cb.blocks_that_fit(cb.resident_v2_smem(24, 256, 7680)) == 3


def _v2_calls(plan, args):
    """Each v2 wrapper with a plan's tables, as a function of argument
    overrides (``tables`` fields under their own names)."""

    fsmp = args[5]
    tables_c = cb.pipelined_v2_tables(plan, fsmp, "cpu")
    tables_b = cb.resident_v2_tables(plan, fsmp, "cpu")

    def split(kw, tables):
        fields = {k: kw.pop(k) for k in list(kw) if hasattr(tables, k)}
        return SimpleNamespace(**{**vars(tables), **fields})

    def pipelined(**kw):
        tables = split(kw, tables_c)
        a = {"onsets_log": args[0], "base": args[1], "valid": args[3],
             "inv_available": args[4], "fsmp": fsmp, "nsamples": args[6],
             **kw}
        return cb.migrate_detect_pipelined_v2_cuda(tables=tables, **a)

    def resident(**kw):
        tables = split(kw, tables_b)
        a = {"onsets_log": args[0], "valid": args[3],
             "inv_available": args[4], "fsmp": fsmp, "nsamples": args[6],
             **kw}
        return cb.migrate_detect_resident_v2_cuda(tables=tables, **a)

    return pipelined, resident


@pytest.mark.parametrize("kernel", ["pipelined", "resident"])
def test_v2_wrappers_refuse_what_the_kernel_does_not_take(plans, kernel):
    """CPU tensors and wrong dtypes are refused; no plain version runs in
    the kernel's place and no launch is counted that was not made."""

    plan, args = plans["small"]
    pipelined, resident = _v2_calls(plan, args)
    call = pipelined if kernel == "pipelined" else resident
    slab = cb.pipelined_v2_tables(plan, args[5], "cpu").slab
    cb.reset_launches()
    for variant in cb.V2_ABLATIONS:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(variant=variant)
    with pytest.raises(ValueError, match="unknown variant"):
        call(variant="noexp")
    with pytest.raises(ValueError, match="uint16"):
        call(slab=slab.to(torch.int16))
    with pytest.raises(ValueError, match="float32"):
        call(onsets_log=args[0].double())
    with pytest.raises(ValueError, match="float32"):
        call(valid=args[3].double())
    with pytest.raises(ValueError, match="shape"):
        call(slab=slab[:, :, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        call(onsets_log=args[0].t().contiguous().t())
    # tables built for another scan start
    with pytest.raises(ValueError, match="fsmp"):
        call(fsmp=args[5] + 1)
    if kernel == "pipelined":
        with pytest.raises(ValueError, match="int32"):
            call(base=args[1].long())
        with pytest.raises(ValueError, match="n_stages"):
            call(n_stages=5)
        with pytest.raises(ValueError, match="n_stages"):
            call(n_stages=3, variant="nogather")
    else:
        with pytest.raises(ValueError, match="int32"):
            call(woff=torch.zeros((plan.n_tiles, plan.n_onsets)))
    assert set(cb.launches.values()) == {0}


@pytest.mark.parametrize("name", PLANS)
def test_v2_references_equal_the_plan_reference(plans, name):
    """Both plain versions, gathering through their slabs and window
    layouts, give the plan reference's outputs bit for bit."""

    plan, args = plans[name]
    fsmp = args[5]
    ref = cuda_migrate.detect_reduce_plan_reference(*args)
    tables = cb.pipelined_v2_tables(plan, fsmp, "cpu")
    got = cb.pipelined_v2_reference(args[0], args[1], *args[3:], tables)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    for max_group in (1, 2, 4):
        t = cb.resident_v2_tables(plan, fsmp, "cpu", max_group)
        got = cb.resident_v2_reference(args[0], *args[3:], t)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and torch.equal(g, r)
    # chunking the tiles changes nothing
    got = cb.pipelined_v2_reference(args[0], args[1], *args[3:], tables,
                                    max_elements=plan.tile * 30)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="fsmp"):
        cb.pipelined_v2_reference(args[0], args[1], *args[3:5], fsmp + 1,
                                  args[6], tables)


@pytest.mark.parametrize("kernel", ["pipelined", "resident"])
@pytest.mark.parametrize("seed", [0, 5])
def test_v2_references_match_pallas_mxu(kernel, seed):
    """Each plain version with the tile combine against the JAX MXU
    kernel in interpret mode, whose int8 3-word table encodes each log
    onset within 7.7e-7 (pallas_migrate.py:49-55): within RTOL."""

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
    base, valid = _torch(plan.base, plan.valid)
    if kernel == "pipelined":
        tables = cb.pipelined_v2_tables(plan, fsmp, "cpu")
        parts = cb.pipelined_v2_reference(logged, base, valid, inv, fsmp,
                                          nsamples, tables)
    else:
        tables = cb.resident_v2_tables(plan, fsmp, "cpu")
        assert tables.group > 1
        parts = cb.resident_v2_reference(logged, valid, inv, fsmp,
                                         nsamples, tables)
    max_coa, max_idx, coa_sum = cuda_migrate.combine_tiles(
        *parts, torch.from_numpy(plan.perm), plan.tile)
    norm = max_coa * plan.n_nodes / coa_sum
    np.testing.assert_allclose(max_coa.numpy(), ref[0], rtol=RTOL)
    np.testing.assert_allclose(norm.numpy(), ref[1], rtol=RTOL)
    assert (max_idx.numpy() == ref[2]).mean() > 0.99
    _assert_tie_consistent(max_idx.numpy(), ref[0], work, fsmp)


def test_sass_census_patterns_name_the_v2_kernels():
    """The census's optional patterns match the FULL instantiations of
    the two kernels (template <variant, stages> and <variant>)."""

    sources = {p.name: p.read_text() for p in
               (REPO / "quakemigrate_torch" / "csrc").glob("*_v2.cu")}
    pipelined, resident = sass_loops.E1_V2_PATTERNS
    assert pipelined == "qm_pipelined_v2_kernelILi0ELi2E"
    assert resident == "qm_resident_v2_kernelILi0E"
    assert "qm_pipelined_v2_kernel(" in sources[
        "migrate_detect_pipelined_v2.cu"]
    assert "qm_resident_v2_kernel(" in sources[
        "migrate_detect_resident_v2.cu"]


@pytest.mark.parametrize("part", ["--resident", "--deep"])
def test_breakdown_v2_parts_require_cuda(part):
    """With no card visible the parts that run v2 beside v1 exit
    non-zero, before any work."""

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m",
         "quakemigrate_torch.experiments.exp_kernel_breakdown", part],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
