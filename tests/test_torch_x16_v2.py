# -*- coding: utf-8 -*-
"""
E2 v2 of quakemigrate_torch on the CPU: the shifted-copy detect kernel
redesigned on K1 v2's slab (``csrc/migrate_detect_x16_v2.cu``). Its host
tables (the copy layout ``coff`` of each layout and the uint16 slab of
copy offsets) are checked against brute-force loops; the 2**16 and
window-bound errors, the shared-memory sizing against the kernel's C
formula, and the wrapper's refusals are checked; the plain version, which
gathers through the same slab and copy layout, equals
``detect_reduce_plan_reference`` bit for bit (tiles 32, 64 and 512) and
matches the JAX ``PallasDetectMXU`` in interpret mode (rtol 2e-6, argmax
tie-consistent). The JAX experiment's ``run_x16`` takes no ``interpret``
argument, so the MXU kernel, whose contract it shares, is the JAX
counterpart run here (as in tests/test_torch_x16.py). The machine-code
census (experiments/sass_loops.py) is checked on a SASS excerpt of E2
v2's loop. The CUDA kernel runs only on the card (chip_smoke.py holds it
bit for bit to K1 and to this plain version).

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.pallas_migrate import PallasDetectMXU
from quakemigrate_torch.experiments import exp_x16, sass_loops
from quakemigrate_torch.ops import cuda_breakdown as cb
from quakemigrate_torch.ops import cuda_migrate, cuda_x16, migrate, x16

from test_torch_breakdown import _small_plan
from test_torch_migrate import RTOL, _assert_tie_consistent, _torch, _workload

torch.set_num_threads(1)

SBLK = cuda_migrate.SBLK
LAYOUTS = cuda_x16.LAYOUTS
# the residual spans of the day-scale workload at tile 512, bricks 8^3
DAY_R_SPANS = [22] * 12 + [43] * 6 + [42] + [43] * 5


def _plans():
    """(plan, args) at four small plans: the breakdown tests' plan (a tie,
    tile 32), one with many padding nodes at tile 64, one of 11 onsets
    (a slab row of one whole chunk and 3 onsets more), and one at tile
    512."""

    return {
        "small": _small_plan()[:2],
        "padded": _small_plan(node_count=(5, 6, 5), tile=64,
                              brick=(4, 4, 4))[:2],
        "onsets11": _small_plan(seed=3, node_count=(9, 8, 6), n_onsets=11,
                                tile=32)[:2],
        "tile512": _small_plan(seed=4, node_count=(10, 9, 8), tile=512,
                               brick=(8, 8, 8))[:2],
    }


PLANS = ("small", "padded", "onsets11", "tile512")


@pytest.fixture(scope="module")
def plans():
    return _plans()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("r_spans", [DAY_R_SPANS, [1], [19, 37, 5, 125]])
def test_x16_v2_layout(layout, r_spans):
    """Every copy of every onset: its width, 16-byte alignment (copy 0 at
    128 bytes, with room for its width rounded up to 32 floats), no two
    copies overlapping, all inside copy_floats (a multiple of 32)."""

    coff, widths, copy_floats = cuda_x16.x16_v2_layout(r_spans, layout)
    n = len(r_spans)
    assert coff.shape == (4, n) and coff.dtype == np.int32
    assert widths.dtype == np.int32
    np.testing.assert_array_equal(
        widths, [-(-(r + 3 + SBLK) // 4) * 4 for r in r_spans])
    assert copy_floats % 32 == 0
    used = np.zeros(copy_floats, int)
    for o in range(n):
        room0 = -(-int(widths[o]) // 32) * 32
        assert coff[0, o] % 32 == 0
        used[coff[0, o]:coff[0, o] + room0] += 1
        for c in (1, 2, 3):
            assert coff[c, o] % 4 == 0 and coff[c, o] > coff[c - 1, o]
            used[coff[c, o]:coff[c, o] + widths[o]] += 1
    assert used.max() == 1
    assert coff.max() + widths.max() <= copy_floats
    if layout == "x16a":
        # copy-major: every copy 0, then every copy 1, 2 and 3
        assert coff[0].max() < coff[1].min()
        assert coff[1].max() < coff[2].min() < coff[3].min()
    else:
        # onset-major: onset o's four copies before onset o + 1's
        assert (coff[3, :-1] < coff[0, 1:]).all()


def test_x16_v2_layout_day_plan():
    """The day-scale plan at tile 512: 24 windows of 156 or 176 floats a
    copy, 16,192 floats in x16a and 16,512 in x16b; an unknown layout is
    refused."""

    coff, widths, floats_a = cuda_x16.x16_v2_layout(DAY_R_SPANS, "x16a")
    assert set(widths) == {156, 176}
    # copy 0 in 32-float rooms, copies 1-3 at their widths, rounded to 32
    assert floats_a == 12 * 160 + 12 * 192 + 3 * (12 * 156 + 12 * 176) + 16
    assert floats_a == 16192
    assert cuda_x16.x16_v2_layout(DAY_R_SPANS, "x16b")[2] == (
        12 * (160 + 3 * 156 + 12) + 12 * (192 + 3 * 176 + 16)) == 16512
    with pytest.raises(ValueError, match="unknown layout"):
        cuda_x16.x16_v2_layout(DAY_R_SPANS, "x16c")


@pytest.mark.parametrize("name", PLANS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("fsmp", [5, 6])
def test_x16_v2_slab_brute_force(plans, name, layout, fsmp):
    plan, _ = plans[name]
    coff, widths, copy_floats = cuda_x16.x16_v2_layout(plan.r_spans, layout)
    slab = cuda_x16.x16_v2_slab(plan.fine16, plan.base, fsmp, coff, widths)
    row = -(-plan.n_onsets // 8) * 8
    assert slab.dtype == np.uint16 and slab.flags.c_contiguous
    assert slab.shape == (plan.n_tiles, plan.tile, row)
    for i in range(plan.n_tiles):
        for o in range(plan.n_onsets):
            # the window's first column lies a past a multiple of 4
            a = (fsmp + int(plan.base[i, o])) % 4
            for n in range(plan.tile):
                u = a + int(plan.fine[i, o, n])
                c = u % 4
                entry = int(slab[i, n, o])
                assert entry == coff[c, o] + u - c
                # an aligned 16-byte read whose 128 samples stay inside
                # copy c's valid floats (copy_c[x] = copy_0[x + c])
                assert entry % 4 == 0
                assert entry - coff[c, o] + SBLK + c <= widths[o]
        assert (slab[i, :, plan.n_onsets:] == 0).all()
    tables = cuda_x16.x16_v2_tables(plan, fsmp, "cpu", layout)
    assert (tables.copy_floats, tables.layout, tables.fsmp) == (
        copy_floats, layout, fsmp)
    assert tables.slab.dtype == torch.uint16
    np.testing.assert_array_equal(tables.slab.numpy(), slab)
    assert tables.tab.dtype == torch.int32
    np.testing.assert_array_equal(tables.tab.numpy(),
                                  np.concatenate([coff, widths[None]]))


def test_x16_v2_slab_errors():
    fine16 = np.zeros((2, 16, 3), np.int16)
    fine16[1, 5, 2] = 40
    base = np.zeros((2, 3), np.int32)
    # residual 40 in a window laid out for spans of 33: 40 + 128 > 164
    coff, widths, _ = cuda_x16.x16_v2_layout([33, 33, 33], "x16a")
    assert widths[2] == 164
    with pytest.raises(ValueError, match="leaves its window"):
        cuda_x16.x16_v2_slab(fine16, base, 0, coff, widths)
    # spans of 41 hold it at fsmp 0 ...
    coff, widths, _ = cuda_x16.x16_v2_layout([41, 41, 41], "x16a")
    slab = cuda_x16.x16_v2_slab(fine16, base, 0, coff, widths)
    assert slab[1, 5, 2] == coff[0, 2] + 40
    # ... and at fsmp 3 the read moves 3 floats on, into copy 3
    slab = cuda_x16.x16_v2_slab(fine16, base, 3, coff, widths)
    assert slab[1, 5, 2] == coff[3, 2] + 40
    with pytest.raises(ValueError, match="leaves its window"):
        cuda_x16.x16_v2_slab(fine16, base, 3, coff, widths - 4)
    # an entry at 2**16: copy 3 of the last of 119 onsets of 132-float
    # copies (copy 0 in 160) starts at 556 x 119 - 132 = 66,032 floats
    for n, fits in ((119, False), (118, True)):
        coff, widths, _ = cuda_x16.x16_v2_layout([1] * n, "x16a")
        assert coff[3, n - 1] == 556 * n - 132
        fine, base = np.zeros((1, 16, n), np.int16), np.full((1, n), 3,
                                                              np.int32)
        if fits:
            assert cuda_x16.x16_v2_slab(fine, base, 0, coff,
                                        widths).max() == 65476
        else:
            with pytest.raises(ValueError, match="2\\*\\*16"):
                cuda_x16.x16_v2_slab(fine, base, 0, coff, widths)


def test_x16_v2_smem_sizing():
    """The C formula (qx2_smem_bytes): 128 bytes of alignment slack, the
    copies (at least the 3 x 8 x 128-float reduction scratch), valid
    (tile floats), the table (5 O ints, rounded up to 4) and one
    mbarrier; 3 blocks an SM at the day plan in either layout."""

    red = 3 * 8 * 128
    assert cuda_x16.x16_v2_smem(24, 512, 16192) == (
        128 + 4 * 16192 + 4 * 512 + 4 * 120 + 8) == 67432
    assert cuda_x16.x16_v2_smem(24, 512, 16512) == 68712
    assert cuda_x16.x16_v2_smem(1, 16, 544) == (
        128 + 4 * red + 4 * 16 + 4 * 8 + 8)
    for layout in LAYOUTS:
        copy_floats = cuda_x16.x16_v2_layout(DAY_R_SPANS, layout)[2]
        assert cb.blocks_that_fit(cuda_x16.x16_v2_smem(24, 512,
                                                       copy_floats)) == 3
    # the slab in shared memory too would have left 2
    assert cb.blocks_that_fit(67432 + 2 * 512 * 24) == 2


@pytest.mark.parametrize("name", PLANS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_x16_v2_reference_equals_the_plan_reference(plans, name, layout):
    """The plain version, gathering through the slab and copy layout,
    gives the plan reference's outputs bit for bit."""

    plan, args = plans[name]
    fsmp = args[5]
    ref = cuda_migrate.detect_reduce_plan_reference(*args)
    tables = cuda_x16.x16_v2_tables(plan, fsmp, "cpu", layout)
    got = x16.x16_v2_reference(args[0], args[1], *args[3:], tables)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    # chunking the tiles changes nothing
    got = x16.x16_v2_reference(args[0], args[1], *args[3:], tables,
                               max_elements=plan.tile * args[6])
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="fsmp"):
        x16.x16_v2_reference(args[0], args[1], *args[3:5], fsmp + 1,
                             args[6], tables)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("seed", [0, 5])
def test_x16_v2_reference_matches_pallas_mxu(layout, seed):
    """The plain version with the tile combine against the JAX MXU kernel
    in interpret mode, whose int8 3-word table encodes each log onset
    within 7.7e-7 (pallas_migrate.py:49-55): within RTOL."""

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
    tables = cuda_x16.x16_v2_tables(plan, fsmp, "cpu", layout)
    parts = x16.x16_v2_reference(logged, base, valid, inv, fsmp, nsamples,
                                 tables)
    max_coa, max_idx, coa_sum = cuda_migrate.combine_tiles(
        *parts, torch.from_numpy(plan.perm), plan.tile)
    norm = max_coa * plan.n_nodes / coa_sum
    np.testing.assert_allclose(max_coa.numpy(), ref[0], rtol=RTOL)
    np.testing.assert_allclose(norm.numpy(), ref[1], rtol=RTOL)
    assert (max_idx.numpy() == ref[2]).mean() > 0.99
    _assert_tie_consistent(max_idx.numpy(), ref[0], work, fsmp)


def test_x16_v2_wrapper_refuses_what_the_kernel_does_not_take(plans):
    """CPU tensors, wrong dtypes and shapes, an unknown variant and tables
    of another scan start are refused; no plain version runs in the
    kernel's place and no launch is counted that was not made."""

    plan, args = plans["small"]
    fsmp = args[5]
    tables = cuda_x16.x16_v2_tables(plan, fsmp, "cpu")

    def call(variant="full", **kw):
        t = tables
        if "slab" in kw or "tab" in kw:
            t = type(tables)(**{**vars(tables), **{
                k: kw.pop(k) for k in ("slab", "tab") if k in kw}})
        a = {"onsets_log": args[0], "base": args[1], "valid": args[3],
             "inv_available": args[4], "fsmp": fsmp, "nsamples": args[6],
             **kw}
        return cuda_x16.migrate_detect_x16_v2_cuda(tables=t, variant=variant,
                                                   **a)

    cuda_x16.reset_launches()
    for layout in LAYOUTS:
        t = cuda_x16.x16_v2_tables(plan, fsmp, "cpu", layout)
        for variant in cb.V2_ABLATIONS:
            with pytest.raises(ValueError, match="CUDA tensors"):
                cuda_x16.migrate_detect_x16_v2_cuda(
                    args[0], args[1], *args[3:], t, variant)
    with pytest.raises(ValueError, match="unknown variant"):
        call(variant="noexp")
    with pytest.raises(ValueError, match="uint16"):
        call(slab=tables.slab.to(torch.int16))
    with pytest.raises(ValueError, match="shape"):
        call(tab=tables.tab[:4].contiguous())
    with pytest.raises(ValueError, match="float32"):
        call(onsets_log=args[0].double())
    with pytest.raises(ValueError, match="int32"):
        call(base=args[1].long())
    with pytest.raises(ValueError, match="fsmp"):
        call(fsmp=fsmp + 1)
    assert cuda_x16.launches == {"migrate_detect_x16": 0,
                                 "migrate_detect_x16_v2": 0}


_SASS = """
        Function : _Z16qm_x16_v2_kernelILi0EEv14CUtensorMap_stPKiPKtPKfS2_S6_PfPiS7_iiiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.128.CONSTANT R20, desc[UR6][R2.64] ;
        /*0020*/                   LOP3.LUT R4, R20, 0xffff, RZ, 0xc0, !PT ;
        /*0030*/                   LEA R4, R4, R0, 0x2 ;
        /*0040*/                   LDS.128 R8, [R4] ;
        /*0050*/                   SHF.R.U32.HI R5, RZ, 0x10, R20 ;
        /*0060*/                   LEA R5, R5, R0, 0x2 ;
        /*0070*/                   LDS.128 R12, [R5] ;
        /*0080*/                   FADD R16, R16, R8 ;
        /*0090*/                   FADD R17, R17, R9 ;
        /*00a0*/                   FADD R18, R18, R10 ;
        /*00b0*/                   FADD R19, R19, R11 ;
        /*00c0*/                   FADD R16, R16, R12 ;
        /*00d0*/                   FADD R17, R17, R13 ;
        /*00e0*/                   FADD R18, R18, R14 ;
        /*00f0*/                   FADD R19, R19, R15 ;
        /*0100*/                @P0 BRA 0x10 ;
        /*0110*/                   EXIT ;
"""


def test_sass_census_of_the_x16_v2_loop():
    """The census reads E2 v2's gather loop: one LDS.128 and four FADDs a
    node-onset, the slab by LDG.128, and its instructions a node-onset
    (FADD / 4 node-onsets); E2 v2's FULL kernel is a default pattern."""

    kernels = sass_loops.parse_sass(_SASS)
    (name, instrs), = kernels.items()
    assert exp_x16.V2_KERNEL in name
    assert exp_x16.V2_KERNEL in sass_loops.DEFAULT_PATTERNS
    assert instrs[4] == (0x40, "LDS.128 R8, [R4]")
    assert sass_loops.loops(instrs) == [{
        "start": 0x10, "end": 0x100, "n": 16, "lds32": 0, "lds64": 0,
        "lds128": 2, "ldg": 1, "fadd": 8, "per_node_onset": 8.0,
    }]


def test_x16_entry_point_runs_v2_in_turns():
    """The experiment's v2 cases and the cases timed in turns with them."""

    assert exp_x16.V2_CASES == ("x16a_v2", "x16b_v2")
    assert exp_x16.TURNS == ("x16a_v2", "x16b_v2", "x16a", "x16b", "full",
                             "k1_v2")
    assert exp_x16.CASES == ("ref", "x16a", "x16b")
