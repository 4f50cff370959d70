# -*- coding: utf-8 -*-
"""
E3 v2, the stride-16 table detect kernel on ``wgmma``
(``csrc/migrate_detect_x16g_v2.cu``, wrapper ``ops.cuda_x16g``), on the
CPU. A numpy emulation of the kernel's blocking, built as the kernel
builds it: blocks of up to 512 nodes x 64 samples with a ragged last
block; the coarse rows staged per block; the Hankel tiles a warp builds
in the 128-byte swizzle, read back through wgmma's MN-major map; the
one-hot A fragments in the m64k16 register map; the k-steps in order,
hi then lo into one float32 accumulator; and the epilogue's order (a
thread's 8 nodes, shuffles over the groups, the 8 warps) with
the tie rule. The emulation is held to the plain version
(``x16g.detect_reduce_x16g_reference``) and to the JAX experiment kernel
``_x16g_kernel`` in interpret mode, at rtol 1e-6 with the argmax
tie-consistent (as tests/test_torch_x16g.py holds the plain version);
its ablations to their plain version and closed form. Also the swizzle
map, the shared-memory sizing, the wrapper refusing CPU tensors, the
compiler-report parser and the entry point's v2 cases. The kernel runs
only on the card (chip_smoke.py holds it to the plain version and to K1).

"""

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.pallas_migrate import PallasDetectMXU, _combine_tiles
from quakemigrate_torch import _build
from quakemigrate_torch.experiments import exp_x16g
from quakemigrate_torch.ops import cuda_migrate, cuda_x16g, migrate, x16g

from test_torch_breakdown import _small_plan
from test_torch_migrate import _torch, _workload
from test_torch_x16g import FSMP, NODE_COUNT, NSAMPLES, _assert_matches
from test_torch_x16g import _jax_x16g

torch.set_num_threads(1)

RTOL = 1e-6
N = cuda_x16g.V2_SBLK        # samples a block
PITCH = cuda_x16g.V2_PITCH   # staged columns a row
B_BYTES = 2048               # one Hankel tile: 16 k rows x 128 bytes
BF16_ONE = 0x3F80


def _swizzle(k, chunk):
    """Byte offset of 16-byte chunk ``chunk`` (8 samples) of k row ``k``
    in a Hankel tile: MN-major, 128-byte swizzle, 1024-byte atoms of 8
    rows."""

    return (k >> 3) * 1024 + (k & 7) * 128 + ((chunk ^ (k & 7)) << 4)


def _words(row16):
    """uint16 bf16 bits [..., 2 W] -> uint32 words [..., W], the element
    of the lower index in the low half."""

    row16 = row16.astype(np.uint32)
    return row16[..., 0::2] | (row16[..., 1::2] << 16)


def _built_stage(g_rows):
    """The ring stage the block builds for a k-step from the staged rows
    ``g_rows`` (uint16 [2, PITCH]: hi, lo): thread (half, b, j) reads the 5
    words of its row from word (b + 8 j) / 2 on and writes chunk j of row
    b, funnel-shifted by 16 bits where b + 8 j is odd. uint8 [2 B_BYTES]."""

    words = _words(g_rows).astype(np.uint64)
    stage = np.zeros(2 * B_BYTES, np.uint8)
    for tid in range(256):
        half, b, j = tid >> 7, (tid >> 3) & 15, tid & 7
        x0 = b + 8 * j
        w = words[half, (x0 >> 1):(x0 >> 1) + 5]
        shift = 16 * (x0 & 1)
        out = [((w[u + 1] << 32 | w[u]) >> shift) & 0xFFFFFFFF
               for u in range(4)]
        off = half * B_BYTES + _swizzle(b, j)
        stage[off:off + 16] = np.array(out, np.uint32).view(np.uint8)
    return stage


def _wgmma_b(tile_bytes):
    """What wgmma reads as B[k, n] (16 x 64 bf16 bits) from a Hankel tile
    through the MN-major 128-byte-swizzle descriptor."""

    k, n = np.meshgrid(np.arange(16), np.arange(N), indexing="ij")
    off = np.vectorize(_swizzle)(k, n >> 3) + 2 * (n & 7)
    return tile_bytes.view(np.uint16)[off // 2]


def _bits_to_f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _thread_nodes(tile):
    """Node of each thread's fragment rows, [cw, w, g, i, h]
    (warpgroup, warp, group, m64 tile, row half): rows g and g + 8 of the
    thread's warp in its warpgroup's tile i are nodes n0 + 2 i + h, n0 = 8
    (32 cw + 8 w + g); and the node being inside the tile."""

    cw, w, g, i, h = np.meshgrid(np.arange(2), np.arange(4), np.arange(8),
                                 np.arange(4), np.arange(2), indexing="ij")
    nodes = 8 * (32 * cw + 8 * w + g) + 2 * i + h
    return nodes, nodes < tile


def _one_hot_from_fragments(fine_o, q, tile):
    """A [512, 16] at coarse row q of one onset, assembled from every
    thread's registers a[i][0..3] (the m16k16 map of each warp:
    a0 row g cols 2c, 2c + 1; a1 row g + 8; a2 row g cols 2c + 8, 2c + 9;
    a3 row g + 8), each selected as the kernel selects it: a node's
    key 2 q + half and word (qw_hot_load), nodes past the tile at fine16
    -16 (coarse row -1)."""

    nodes, act = _thread_nodes(tile)
    a = np.zeros((512, 16), np.float32)
    for c in range(4):
        f = np.where(act, fine_o[np.where(act, nodes, 0)], -16)
        r = (f & 15) - 2 * c
        half = (r >= 8).astype(np.int64)
        x = r - 8 * half
        key = 2 * (f >> 4) + half
        word = np.where(x == 0, BF16_ONE,
                        np.where(x == 1, BF16_ONE << 16, 0)).astype(np.uint32)
        for reg_half, col in ((0, 2 * c), (1, 2 * c + 8)):
            sel = np.where(key == 2 * q + reg_half, word, 0).astype(np.uint32)
            for part in (0, 1):
                bits = (sel >> (16 * part)) & 0xFFFF
                a[nodes, col + part] = _bits_to_f32(bits)
    return a


def _epilogue(acc, valid, inv, tile):
    """Per column of a block: each thread's 8 nodes in order (strict >
    keeps the first), shuffles over the groups (xor 4, 8, 16 of the
    lane: g xor 1, 2, 4), then the 8 warps in order, with the
    tie rule (larger value, or equal value and smaller node)."""

    nodes, act = _thread_nodes(tile)
    v_all = (np.exp((acc * inv).astype(np.float32)).astype(np.float32)
             * valid[np.minimum(np.arange(512), tile - 1), None]
             ).astype(np.float32)
    best = np.full((2, 4, 8, N), -np.inf, np.float32)
    arg = np.zeros((2, 4, 8, N), np.int64)
    total = np.zeros((2, 4, 8, N), np.float32)
    for i in range(4):
        for h in range(2):
            n = nodes[..., i, h]
            on = act[..., i, h][..., None]
            x = v_all[n]
            take = on & (x > best)
            best = np.where(take, x, best)
            arg = np.where(take, n[..., None], arg)
            total = np.where(on, total + x, total).astype(np.float32)
    for x in (1, 2, 4):
        other = np.arange(8) ^ x
        ov, on = best[:, :, other], arg[:, :, other]
        total = (total + total[:, :, other]).astype(np.float32)
        take = (ov > best) | ((ov == best) & (on < arg))
        best, arg = np.where(take, ov, best), np.where(take, on, arg)
    best, arg, total = (y[:, :, 0].reshape(8, N) for y in (best, arg, total))
    m, a, s = best[0], arg[0], total[0]
    for wi in range(1, 8):
        take = (best[wi] > m) | ((best[wi] == m) & (arg[wi] < a))
        m, a = np.where(take, best[wi], m), np.where(take, arg[wi], a)
        s = (s + total[wi]).astype(np.float32)
    return m, a, s


def _emulate_v2(hi, lo, want, a_off, fine16, valid, inv, nsamples,
                ablate="full"):
    """The kernel's function computed block by block as the kernel
    computes it. Returns (tmax f32, targ int32, tsum f32) [n_tiles, S]."""

    hi16, lo16 = (t.view(torch.int16).numpy().view(np.uint16)
                  for t in (hi, lo))
    want, a_off, fine16, valid = (np.asarray(x) for x in (
        want, a_off, fine16, valid))
    inv = np.float32(np.asarray(inv).reshape(-1)[0])
    n_tiles, n_onsets, tile = fine16.shape
    a_sum = int(a_off[-1])
    onset_of = np.repeat(np.arange(n_onsets), np.diff(a_off))
    outs = [np.zeros((n_tiles, nsamples), dt)
            for dt in (np.float32, np.int32, np.float32)]
    for ti in range(n_tiles):
        rows = want[ti, :a_sum, 0]
        a_steps = [_one_hot_from_fragments(fine16[ti, onset_of[m]],
                                           m - a_off[onset_of[m]], tile)
                   for m in range(a_sum)]
        for s0 in range(0, nsamples, N):
            g_rows = np.stack([hi16[rows, s0:s0 + PITCH],
                               lo16[rows, s0:s0 + PITCH]], axis=1)
            acc = np.zeros((512, N), np.float32)
            for m in range(a_sum):
                stage = _built_stage(g_rows[m])
                if ablate == "nomain":
                    continue
                for half in (0, 1):
                    b = _bits_to_f32(_wgmma_b(
                        stage[half * B_BYTES:(half + 1) * B_BYTES]))
                    acc = (acc + a_steps[m] @ b).astype(np.float32)
            cols = slice(s0, min(s0 + N, nsamples))
            width = cols.stop - s0
            if ablate == "noreduce":
                outs[0][ti, cols] = acc[0, :width]
                outs[1][ti, cols] = acc[1, :width].astype(np.int32)
                outs[2][ti, cols] = acc[2, :width]
                continue
            res = _epilogue(acc, valid[ti], inv, tile)
            for out, r in zip(outs, res):
                out[ti, cols] = r[:width]
    return tuple(torch.from_numpy(o) for o in outs)


def _inputs(seed, tile, brick):
    """The tests/test_pallas.py workload at a plan: (kernel inputs,
    plain-version arguments, plan, tables, workload)."""

    work = _workload(seed)
    onsets, tt, mask, available = work
    plan = cuda_migrate.DetectPlan(tt, NODE_COUNT, tile=tile,
                                   brick_shape=brick)
    p = cuda_x16g.plan_on_device(plan, "cpu")
    logged = migrate._prepare_onsets(*_torch(onsets, mask))
    hi, lo, want, a_pad = cuda_x16g.build_inputs(p, logged, FSMP, NSAMPLES)
    inv = torch.tensor([1.0 / available], dtype=torch.float32)
    kernel = (hi, lo, want, p.a_off, p.fine16, p.valid, inv, NSAMPLES)
    plain = (hi, lo, a_pad, p.base16_dev, p.fine16, p.valid, inv, NSAMPLES)
    return kernel, plain, plan, (hi, lo, a_pad), work


PLANS = [(64, (4, 4, 4)), (512, (8, 8, 8))]


def test_swizzle_permutes_each_atom():
    """The 128-byte swizzle map sends the 8 rows x 8 chunks of each
    1024-byte atom onto its 64 16-byte slots, each once, and keeps a row
    in its own 128 bytes."""

    offs = np.array([[_swizzle(k, j) for j in range(8)] for k in range(16)])
    for atom in (0, 1):
        block = offs[8 * atom:8 * atom + 8]
        assert sorted(block.ravel()) == list(range(1024 * atom,
                                                   1024 * atom + 1024, 16))
        assert ((block // 128) == np.arange(8 * atom, 8 * atom + 8)[:, None]
                ).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_built_tiles_read_back_as_the_hankel_view(seed):
    """What wgmma reads from a built stage is B[b, t] = G[b + t] of the
    hi row and of the lo row."""

    rng = np.random.default_rng(seed)
    g_rows = rng.integers(0, 2**16, size=(2, PITCH)).astype(np.uint16)
    stage = _built_stage(g_rows)
    hankel = np.arange(16)[:, None] + np.arange(N)[None, :]
    for half in (0, 1):
        got = _wgmma_b(stage[half * B_BYTES:(half + 1) * B_BYTES])
        np.testing.assert_array_equal(got, g_rows[half][hankel])


@pytest.mark.parametrize("tile", [64, 192, 512])
def test_fragments_build_the_one_hot(tile):
    """The m64k16 register fragments of every thread assemble to
    A[n, b] = (fine16[n] == 16 q + b) at each coarse row q, zero past the
    tile's m64 tiles."""

    rng = np.random.default_rng(tile)
    fine_o = rng.integers(0, 64, size=tile).astype(np.int32)
    for q in range(4):
        a = _one_hot_from_fragments(fine_o, q, tile)
        want = np.zeros((512, 16), np.float32)
        hit = (fine_o >> 4) == q
        want[np.arange(tile)[hit], (fine_o & 15)[hit]] = 1.0
        np.testing.assert_array_equal(a, want)


@pytest.mark.parametrize("seed,tile,brick", [
    (0, 64, (4, 4, 4)), (3, 64, (4, 4, 4)), (0, 512, (8, 8, 8)),
])
def test_emulation_matches_reference(seed, tile, brick):
    """The emulation against the plain version, per tile: tmax and tsum
    at rtol 1e-6, the argmax tie-consistent. 100 samples are one full
    and one ragged block of 64."""

    kernel, plain, _, _, _ = _inputs(seed, tile, brick)
    assert NSAMPLES % N and NSAMPLES > N
    got = _emulate_v2(*kernel)
    ref = x16g.detect_reduce_x16g_reference(*plain)
    assert got[1].dtype == torch.int32
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=RTOL)
    np.testing.assert_allclose(got[2].numpy(), ref[2].numpy(), rtol=RTOL)
    at_arg = x16g.coa_at_nodes(*plain[:-1], got[1])
    np.testing.assert_allclose(at_arg.numpy(), ref[0].numpy(), rtol=RTOL)
    assert (got[1] == ref[1]).float().mean() > 0.99


@pytest.mark.parametrize("tile,brick", PLANS)
def test_emulation_matches_jax_x16g_kernel(tile, brick):
    """The emulation, combined over tiles, against the JAX experiment
    kernel in interpret mode at the same 16-aligned plan."""

    kernel, _, plan, tables, work = _inputs(0, tile, brick)
    onsets, tt, mask, available = work
    mxu = PallasDetectMXU(tt, NODE_COUNT, FSMP, NSAMPLES, tile=tile,
                          brick_shape=brick, precision="bf16")
    p = mxu.plan
    ref = _jax_x16g(onsets, mask, available, mxu.fine_t, p.base, p.valid,
                    FSMP, NSAMPLES, p.tile, mxu.r_spans, 128)
    max_coa, max_idx, coa_sum = _combine_tiles(*ref, p.perm, p.tile,
                                               NSAMPLES)
    norm = np.asarray(max_coa) * p.n_nodes / np.asarray(coa_sum)
    _assert_matches(_emulate_v2(*kernel), plan, tables, work,
                    np.asarray(max_coa), np.asarray(max_idx), norm)


@pytest.mark.parametrize("tile,brick", PLANS)
def test_emulated_ablations(tile, brick):
    """noreduce (acc of nodes 0, 1, 2) against the plain version at rtol
    1e-6, absolute below 1 (raw sums of 2 O terms of order 1, hi and lo
    interleaved per k-step against hi, then lo); nomain (acc = 0) exactly
    against the closed form."""

    kernel, plain, _, _, _ = _inputs(1, tile, brick)
    got = _emulate_v2(*kernel, ablate="noreduce")
    ref = x16g.detect_reduce_x16g_reference(*plain, ablate="noreduce")
    for k in (0, 2):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=RTOL,
                                   atol=RTOL)
    assert (got[1] - ref[1]).abs().max() <= 1
    got = _emulate_v2(*kernel, ablate="nomain")
    for g, r in zip(got, x16g.zero_acc_reference(plain[5], NSAMPLES)):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_v2_shared_memory_sizing():
    """The ring (8 stages x 4 KB), the fine16 buffers (16 KB), the staged
    rows, the reduction and barriers, and 1 KB of alignment; the 30k plan
    (a_sum 84, A_o <= 4) fits one block, and a plan whose rows do not is
    refused."""

    ring, fine, rows = 8 * 4096, 16384, 2 * 84 * 160
    assert cuda_x16g.x16g_v2_smem(84) == (
        ring + fine + rows + 6144 + 128 + 1024) == 83328
    assert cuda_x16g.x16g_v2_smem(84) <= cuda_migrate.SMEM_LIMIT
    # v1's expand form at the same plan for comparison: 113,920 bytes
    assert cuda_x16g.x16g_v2_smem(84) < cuda_x16g.x16g_smem(24, 84, 4, False)
    assert cuda_x16g.x16g_v2_smem(1) == (32768 + 16384 + 320 + 6144 + 128
                                         + 1024)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_x16g.x16g_v2_smem(700)


def test_v2_wrapper_refuses_cpu_tensors():
    plan, args, _ = _small_plan()
    logged, _, _, _, inv, fsmp, nsamples = args
    p = cuda_x16g.plan_on_device(plan, "cpu")
    hi, lo, want, _ = cuda_x16g.build_inputs(p, logged, fsmp, nsamples)
    cuda_x16g.reset_launches()
    for ablate in cuda_x16g.V2_ABLATIONS:
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_x16g.migrate_detect_x16g_v2_cuda(p, hi, lo, want, inv,
                                                  nsamples, ablate=ablate)
    with pytest.raises(ValueError, match="unknown ablation"):
        cuda_x16g.migrate_detect_x16g_v2_cuda(p, hi, lo, want, inv, nsamples,
                                              ablate="noexp")
    assert cuda_x16g.launches == {"migrate_detect_x16g": 0,
                                  "migrate_detect_x16g_v2": 0}


def test_ptxas_report_parses_registers_spills_and_serialization():
    log = """== migrate_detect_x16g_v2.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z32qm_migrate_detect_x16g_v2_kernelILi0EEvPKi' for 'sm_90a'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the wgmma pipeline in the function '_Z32qm_migrate_detect_x16g_v2_kernelILi0EEvPKi'
ptxas info    : Function properties for _Z32qm_migrate_detect_x16g_v2_kernelILi0EEvPKi
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 224 registers, used 2 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_Z32qm_migrate_detect_x16g_v2_kernelILi1EEvPKi' for 'sm_90a'
ptxas info    : Function properties for _Z32qm_migrate_detect_x16g_v2_kernelILi1EEvPKi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 448 bytes cmem[0]
== migrate_detect_x16g.cu
ptxas info    : Compiling entry function '_Z30qm_migrate_detect_x16g_kernelILb0ELi0EEvPKi' for 'sm_90a'
ptxas info    : Function properties for _Z30qm_migrate_detect_x16g_kernelILb0ELi0EEvPKi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 448 bytes cmem[0]
"""
    got = _build.ptxas_report(log, "qm_migrate_detect_x16g_v2_kernel")
    assert got == {
        "_Z32qm_migrate_detect_x16g_v2_kernelILi0EEvPKi": {
            "registers": 224, "spill_stores": 8, "spill_loads": 12,
            "wgmma_serialized": True},
        "_Z32qm_migrate_detect_x16g_v2_kernelILi1EEvPKi": {
            "registers": 168, "spill_stores": 0, "spill_loads": 0,
            "wgmma_serialized": False},
    }
    v1 = _build.ptxas_report(log, "qm_migrate_detect_x16g_kernel")
    assert list(v1.values()) == [{"registers": 128, "spill_stores": 0,
                                  "spill_loads": 0,
                                  "wgmma_serialized": False}]


def test_entry_point_v2_cases():
    """Every v2 ablation has its case; v2's turns include v1's full
    forms; v1's cases are unchanged."""

    assert set(exp_x16g.V2_CASES.values()) == set(cuda_x16g.V2_ABLATIONS)
    assert exp_x16g.V2_CASES["v2"] == "full"
    assert exp_x16g.TURNS == ("v2", "fuse", "expand")
    assert not set(exp_x16g.V2_CASES) & set(exp_x16g.CASES)
    assert exp_x16g.V2_KERNEL in (
        _build.CSRC_DIR / "migrate_detect_x16g_v2.cu").read_text()
