# -*- coding: utf-8 -*-
"""
M1 v2, locate's marginalisation on K1 v2's gather core
(``csrc/migrate_marginalise_v2.cu``), through a numpy emulation of the
kernel's arithmetic on the detect plan. The kernel itself runs only on
the card: chip_smoke.py holds it to the plain version and to M1 there.

- the emulation (per node tile and chunk of M1_V2_CHUNK samples: the
  window offsets K1 v2's span_off less o (M1_V2_CHUNK - width), the
  windows staged from the onset rows, zeros past them, the uint16 slab
  of off[o] + fine16[n, o]; each warp's nodes w, w + 8, ... gathered
  NIF at a time, lane j on samples j + 32 k of each of its SPN slots,
  onsets in order in float32; exp of the sum times 1 / available, the
  lane's slots in k order, the xor tree, lane i storing node i of the
  group through perm; the chunks' rows added in chunk order) against
  the plain ``migrate_marginalise`` within 1e-5 of the map's maximum,
  every real node written once and no read past the block's windows,
  at windows of 1, 30, 33, 64, 128 and 300 samples at the scan's start,
  middle and end;
- the same emulation against M1's (``test_torch_marginalise``) bit for
  bit up to one chunk (128 samples): the same onset order, lane-sample
  map and xor tree. Beyond, M1's chunks are 256 samples and M1 v2's 128,
  so each sums in another order: within 27 float32 roundings of each
  node's sum (the depth of the two sums: 8 + 5 + 2 and 4 + 5 + 3);
- the plain ``migrate_marginalise`` against the JAX function at one more
  window, of three M1 v2 chunks;
- the route: on the card ``CudaDetect.marginalise`` (DetectScan's and
  locate's k1_v2 route) launches M1 v2 and ``CudaDetectVPU.marginalise``
  (the k2_v2 route, where ``v2_refusal`` refuses the plan) M1; M1 v2
  takes every plan K1 v2 takes, its block never larger than K1 v2's;
- M1 v2's wrapper raising on CPU tensors, a plan without fine16, a
  tile off 16, a block over the shared memory, a window outside the
  scan and an onset block too short; the chunk table and offsets it
  hands the kernel;
- its entries in the C API table, and the shape the source builds for
  each slot count.

"""

import ctypes
import re

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.migrate import (
    migrate_marginalise as j_migrate_marginalise,
)
from quakemigrate_torch import _build
from quakemigrate_torch.ops import cuda_migrate as cm
from quakemigrate_torch.ops.cuda_migrate import (
    M1_V2_CHUNK,
    M1_V2_NODES_IN_FLIGHT,
    CudaDetect,
    DetectPlan,
    m1_v2_slots,
    m1_v2_win_floats,
    migrate_marginalise_v2_cuda,
)
from quakemigrate_torch.ops.migrate import _prepare_onsets, migrate_marginalise
from quakemigrate_torch.signal.scan import detect_route, route_detector

from test_torch_marginalise import _emulate_m1

torch.set_num_threads(1)

NODE_COUNT = (9, 8, 7)
N_ONSETS = 6
FSMP, NSAMPLES, LSMP = 20, 400, 40
TILE, BRICK = 64, (4, 4, 4)
RTOL_OF_MAX = 1e-5
# Float32 roundings on the longest path of each node's sum beyond one
# chunk: M1's lane slots, xor tree and chunks (8 + 5 + 2 at 300
# samples), and M1 v2's (4 + 5 + 3)
ROUNDINGS = 27
CUDA = torch.device("cuda")  # a device type; nothing here touches a card

LENGTHS = (1, 30, 33, 64, 128, 300)
WINDOWS = [(start, length) for length in LENGTHS
           for start in (0, (NSAMPLES - length) // 2, NSAMPLES - length)]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1414)
    n_nodes = int(np.prod(NODE_COUNT))
    t_len = FSMP + NSAMPLES + LSMP
    mask = np.ones(N_ONSETS)
    mask[2] = 0.0  # one dead onset row
    return {
        "onsets": rng.uniform(0.2, 6.0, size=(N_ONSETS, t_len)).astype(
            np.float32),
        "traveltimes": rng.integers(0, LSMP + 1, size=(n_nodes, N_ONSETS)
                                    ).astype(np.int32),
        "mask": mask, "available": float(mask.sum()), "nsamples": NSAMPLES,
    }


@pytest.fixture(scope="module")
def plan(inputs):
    return DetectPlan(inputs["traveltimes"], NODE_COUNT, tile=TILE,
                      brick_shape=BRICK)


def _plain(inputs, start, length):
    return migrate_marginalise(
        torch.from_numpy(inputs["onsets"]),
        torch.from_numpy(inputs["traveltimes"]),
        torch.from_numpy(inputs["mask"].astype(np.float32)),
        inputs["available"], FSMP, inputs["nsamples"], start, length,
    ).numpy()


def _emulate_m1_v2(inputs, plan, start, length):
    """M1 v2's arithmetic in numpy float32 on the plan: out[perm[n]] for
    each real node n, and the count of writes per flat node."""

    logged = _prepare_onsets(
        torch.from_numpy(inputs["onsets"]),
        torch.from_numpy(inputs["mask"].astype(np.float32)),
    ).numpy().astype(np.float32)
    t_len = logged.shape[1]
    inv = np.float32(1.0) / np.float32(inputs["available"])
    n_tiles, tile, n_onsets = plan.fine16.shape
    spn = m1_v2_slots(length)
    nif = M1_V2_NODES_IN_FLIGHT[spn]
    width = min(length, M1_V2_CHUNK)
    off = (plan.span_off.astype(np.int64)
           - np.arange(n_onsets + 1) * (M1_V2_CHUNK - width))
    win_floats = m1_v2_win_floats(n_onsets, plan.win_floats, length)
    assert win_floats == off[-1] + 32 * spn - width
    n_chunks = max(1, -(-length // M1_V2_CHUNK))
    partial = np.zeros((n_chunks, plan.n_nodes), np.float32)
    writes = np.zeros(plan.n_nodes, int)
    col0 = FSMP + start
    lanes = np.arange(32)
    slots = lanes[:, None] + 32 * np.arange(spn)  # [lane, k] samples
    for i in range(n_tiles):
        # The slab: off[o] + fine16[n, o], uint16
        slab = off[:-1] + plan.fine16[i].astype(np.int64)
        assert slab.max() < 2**16
        for c in range(n_chunks):
            t_begin = c * M1_V2_CHUNK
            t_count = min(M1_V2_CHUNK, length - t_begin)
            # Each onset's window, then the zeros the lanes past the
            # chunk width read
            win = np.zeros(win_floats, np.float32)
            for o in range(n_onsets):
                cols = col0 + plan.base[i, o] + t_begin + np.arange(
                    off[o + 1] - off[o])
                win[off[o]:off[o + 1]] = np.where(
                    cols < t_len, logged[o][np.minimum(cols, t_len - 1)], 0)
            for warp in range(cm.NWARPS):
                for n0 in range(warp, tile, cm.NWARPS * nif):
                    nodes = n0 + cm.NWARPS * np.arange(nif)
                    inside = nodes < tile
                    real = inside & (plan.valid[i, np.minimum(
                        nodes, tile - 1)] != 0)
                    if not real.any():
                        continue
                    rows = slab[np.where(inside, nodes, n0)]  # [nif, O]
                    reads = rows[:, :, None, None] + slots  # [nif, O, 32, k]
                    assert reads.max() < win_floats  # inside the block
                    acc = np.zeros((nif, 32, spn), np.float32)
                    for o in range(n_onsets):  # onsets in order, float32
                        acc += win[reads[:, o]]
                    coa = np.exp(acc * inv).astype(np.float32)
                    total = np.zeros((nif, 32), np.float32)
                    for k in range(spn):  # the lane's slots in k order
                        keep = lanes + 32 * k < t_count
                        total[:, keep] += coa[:, keep, k]
                    for d in (16, 8, 4, 2, 1):  # the xor tree
                        total = total + total[:, lanes ^ d]
                    # Lane q stores node q of the group
                    flat = plan.perm[i * tile + nodes[real]]
                    partial[c, flat] = total[real, 0]
                    if c == 0:
                        writes[flat] += 1
    if n_chunks == 1:
        return partial[0], writes
    out = np.zeros(plan.n_nodes, np.float32)
    for c in range(n_chunks):  # the chunks' rows in chunk order
        out += partial[c]
    return out, writes


@pytest.mark.parametrize("start, length", WINDOWS)
def test_m1_v2_emulation_equals_plain(inputs, plan, start, length):
    got, writes = _emulate_m1_v2(inputs, plan, start, length)
    assert (writes == 1).all()  # every real node once, padding never
    want = _plain(inputs, start, length)
    assert np.abs(got - want).max() <= RTOL_OF_MAX * np.abs(want).max()


@pytest.mark.parametrize("start, length", [
    w for w in WINDOWS if w[1] <= M1_V2_CHUNK])
def test_m1_v2_emulation_equals_m1_bit_for_bit(inputs, plan, start, length):
    got, _ = _emulate_m1_v2(inputs, plan, start, length)
    want, _ = _emulate_m1(inputs, plan, start, length)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start", [0, 50, NSAMPLES - 300])
def test_m1_v2_emulation_near_m1_beyond_one_chunk(inputs, plan, start):
    got, _ = _emulate_m1_v2(inputs, plan, start, 300)
    want, _ = _emulate_m1(inputs, plan, start, 300)
    assert not np.array_equal(got, want)  # the chunks differ
    rel = np.abs(got - want) / want
    assert rel.max() <= ROUNDINGS * 2.0**-24


@pytest.mark.parametrize("length", [1, 32, 33, 64, 65, 100])
def test_m1_v2_each_slot_count_equals_m1(inputs, plan, length):
    """The shape of each slot count, on both sides of its edges, gives
    M1's output: the shape only changes which nodes a warp gathers
    together."""

    got, writes = _emulate_m1_v2(inputs, plan, 17, length)
    want, _ = _emulate_m1(inputs, plan, 17, length)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want)


def test_plain_equals_jax_three_chunks(inputs):
    start, length = 50, 300
    got = _plain(inputs, start, length)
    want = np.asarray(j_migrate_marginalise(
        inputs["onsets"], inputs["traveltimes"],
        inputs["mask"].astype(np.float32), np.float32(inputs["available"]),
        FSMP, NSAMPLES, start, length, tile=128,
    ))
    assert got.shape == want.shape == (len(inputs["traveltimes"]),)
    assert np.abs(got - want).max() <= RTOL_OF_MAX * np.abs(want).max()


def _fake_card(monkeypatch, n_onsets, t_len, n_tiles, tile):
    """Make the wrappers take CPU tensors as if they were on the card
    (the device check passed) and catch the launch: returns the list of
    (entry, args) launched."""

    seen = []
    monkeypatch.setattr(cm, "check_kernel_args", lambda *a, **k: (
        n_onsets, t_len, n_tiles, tile))
    monkeypatch.setattr(cm, "launch_kernel",
                        lambda name, device, *args: seen.append((name, args)))
    return seen


def _prepared(detector, inputs):
    return detector.prepare(
        torch.from_numpy(inputs["onsets"]),
        torch.from_numpy(inputs["mask"].astype(np.float32)),
        inputs["available"])


def _icequake_like(n_onsets, seed=5):
    """Traveltimes on a (12, 12, 10) grid, every onset's residual span
    inside 40 samples."""

    rng = np.random.default_rng(seed)
    return rng.integers(0, 40, size=(12 * 12 * 10, n_onsets)).astype(
        np.int32)


@pytest.mark.parametrize("n_onsets, route, entry", [
    (26, "k1_v2", "qm_migrate_marginalise_v2"),
    (256, "k2_v2", "qm_migrate_marginalise"),
])
def test_route_picks_m1_v2_where_k1_v2_takes_the_plan(n_onsets, route, entry,
                                                      monkeypatch):
    """Locate's pass 2 follows pass 1's route, chosen from the plan's
    sizes before any launch: M1 v2 on K1 v2's route, M1 on K2 v2's (256
    onsets, whose slab and windows K1 v2 cannot stage)."""

    tt = _icequake_like(n_onsets)
    got_route, reason, plan = detect_route(tt, (12, 12, 10), CUDA)
    assert got_route == route
    assert (reason is None) == (cm.v2_refusal(
        plan.n_onsets, plan.tile, plan.win_floats, plan.r_span) is None)
    fsmp, nsamples = 10, 80
    detector = route_detector(route, plan, tt, (12, 12, 10), fsmp, nsamples,
                              "cpu")
    assert type(detector) is (CudaDetect if route == "k1_v2"
                              else cm.CudaDetectVPU)
    t_len = fsmp + nsamples + plan.max_shift
    onsets_log = torch.zeros((n_onsets, t_len))
    inv = torch.ones(1)
    seen = _fake_card(monkeypatch, n_onsets, t_len, plan.n_tiles, plan.tile)
    cm.reset_launches()
    detector.marginalise(onsets_log, inv, 20, 30)
    ((name, _),) = seen
    assert name == entry
    counted = "migrate_marginalise" + ("_v2" if route == "k1_v2" else "")
    assert {k: n for k, n in cm.launches.items() if n} == {counted: 1}
    cm.reset_launches()


@pytest.mark.parametrize("n_onsets, tile, r", [
    (6, 64, 5), (24, 256, 40), (26, 256, 60), (48, 256, 120),
    (64, 512, 90), (160, 256, 40), (256, 256, 40),
])
def test_m1_v2_takes_every_plan_k1_v2_takes(n_onsets, tile, r):
    """M1 v2's block (its windows cut to the chunk width, plus 32 slots -
    width zeros) never needs more shared memory than K1 v2's, at any
    window length, so it refuses no plan K1 v2 takes."""

    spans = np.full(n_onsets, r)
    win_floats = int(cm.span_offsets(spans)[-1])
    k1_v2 = cm.v2_smem_bytes(n_onsets, tile, win_floats)
    takes = cm.v2_refusal(n_onsets, tile, win_floats, r) is None
    for length in (0, 1, 31, 32, 33, 64, 65, 96, 127, 128, 129, 300, 2038):
        smem = cm.m1_v2_smem_bytes(n_onsets, tile, win_floats, length)
        assert smem <= k1_v2
        if takes:
            cm.check_smem(smem, "M1 v2")


def test_cuda_detect_marginalise_raises_on_cpu_tensors(inputs):
    detector = CudaDetect(inputs["traveltimes"], NODE_COUNT, FSMP, NSAMPLES,
                          "cpu", tile=TILE, brick_shape=BRICK)
    onsets_log, inv = _prepared(detector, inputs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        detector.marginalise(onsets_log, inv, 0, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        migrate_marginalise_v2_cuda(
            onsets_log, detector.base, detector.fine16, detector.valid,
            detector.perm, inv, detector.span_off, detector.win_floats, FSMP,
            NSAMPLES, 0, 10, detector.n_nodes, detector._max_shift)


def test_m1_v2_wrapper_raises_without_fine16(inputs):
    detector = CudaDetect(inputs["traveltimes"], NODE_COUNT, FSMP, NSAMPLES,
                          "cpu", tile=TILE, brick_shape=BRICK)
    onsets_log, inv = _prepared(detector, inputs)
    with pytest.raises(ValueError, match="fine16"):
        migrate_marginalise_v2_cuda(
            onsets_log, detector.base, None, detector.valid, detector.perm,
            inv, detector.span_off, detector.win_floats, FSMP, NSAMPLES, 0,
            10, detector.n_nodes, detector._max_shift)


@pytest.mark.parametrize("start, length, t_cut, match", [
    (NSAMPLES - 3, 4, 0, "inside"),
    (-1, 4, 0, "inside"),
    (5, -1, 0, "inside"),
    (NSAMPLES - 299, 300, 0, "inside"),
    (0, 10, 1, "too short"),
    (NSAMPLES - 300, 300, 1, "too short"),
])
def test_m1_v2_wrapper_checks_before_launch(inputs, start, length, t_cut,
                                            match, monkeypatch):
    detector = CudaDetect(inputs["traveltimes"], NODE_COUNT, FSMP, NSAMPLES,
                          "cpu", tile=TILE, brick_shape=BRICK)
    onsets_log, inv = _prepared(detector, inputs)
    onsets_log = onsets_log[:, :onsets_log.shape[1] - t_cut].contiguous()
    seen = _fake_card(monkeypatch, N_ONSETS, onsets_log.shape[1],
                      detector.base.shape[0], detector.tile)
    with pytest.raises(ValueError, match=match):
        migrate_marginalise_v2_cuda(
            onsets_log, detector.base, detector.fine16, detector.valid,
            detector.perm, inv, detector.span_off, detector.win_floats, FSMP,
            NSAMPLES, start, length, detector.n_nodes, detector._max_shift)
    assert not seen  # no launch past a failed check


def test_m1_v2_wrapper_refuses_tile_off_16(inputs, monkeypatch):
    """The slab's 16-byte residual loads need tile x O % 8 == 0: M1 v2
    takes K1 v2's tiles, multiples of 16."""

    detector = CudaDetect(inputs["traveltimes"], NODE_COUNT, FSMP, NSAMPLES,
                          "cpu", tile=TILE, brick_shape=BRICK)
    onsets_log, inv = _prepared(detector, inputs)
    seen = _fake_card(monkeypatch, N_ONSETS, onsets_log.shape[1],
                      detector.base.shape[0], 24)
    with pytest.raises(ValueError, match="multiple of 16"):
        detector.marginalise(onsets_log, inv, 0, 30)
    assert not seen


def test_m1_v2_wrapper_refuses_block_over_shared_memory(monkeypatch):
    """256 onsets on a tile of 256 at a window of one chunk: the slab and
    windows exceed a block's shared memory (the plan K2 v2's route
    takes)."""

    tt = _icequake_like(256)
    detector = CudaDetect(tt, (12, 12, 10), 10, 200, "cpu")
    t_len = 210 + detector._max_shift
    onsets_log = torch.zeros((256, t_len))
    seen = _fake_card(monkeypatch, 256, t_len, detector.base.shape[0],
                      detector.tile)
    with pytest.raises(ValueError, match="shared memory"):
        detector.marginalise(onsets_log, torch.ones(1), 0, M1_V2_CHUNK)
    assert not seen


@pytest.mark.parametrize("length, n_chunks", [
    (0, 1), (30, 1), (33, 1), (M1_V2_CHUNK, 1), (M1_V2_CHUNK + 1, 2),
    (300, 3),
])
def test_m1_v2_wrapper_passes_table_and_offsets(inputs, length, n_chunks,
                                                monkeypatch):
    """The wrapper hands the kernel a [chunks, n_nodes] table where the
    window spans more than one chunk and none where it is one, col0 =
    fsmp + start and K1 v2's win_floats (the launch is caught, as if the
    tensors were on the card)."""

    detector = CudaDetect(inputs["traveltimes"], NODE_COUNT, FSMP, NSAMPLES,
                          "cpu", tile=TILE, brick_shape=BRICK)
    onsets_log, inv = _prepared(detector, inputs)
    seen = _fake_card(monkeypatch, N_ONSETS, onsets_log.shape[1],
                      detector.base.shape[0], detector.tile)
    cm.reset_launches()
    detector.marginalise(onsets_log, inv, 5, length)
    ((name, args),) = seen
    assert name == "qm_migrate_marginalise_v2"
    partial, rows, n_nodes = args[9:12]
    assert (rows, n_nodes) == (n_chunks, detector.n_nodes)
    assert (partial is None) == (n_chunks == 1)
    assert args[12:] == (N_ONSETS, detector.base.shape[0], TILE, FSMP + 5,
                         length, detector.win_floats)
    assert cm.launches["migrate_marginalise_v2"] == 1
    cm.reset_launches()


def test_m1_v2_signature_entries():
    p, i = ctypes.c_void_p, ctypes.c_int
    assert _build.SIGNATURES["qm_migrate_marginalise_v2"] == (
        [p, i] + [p] * 8 + [i] * 8 + [p])
    assert _build.SIGNATURES["qm_migrate_marginalise_v2_blocks_per_sm"] == (
        [i] * 4)
    assert (_build.CSRC_DIR / "migrate_marginalise_v2.cu").is_file()


def test_m1_v2_shapes_match_the_source():
    """M1_V2_NODES_IN_FLIGHT gives, for each slot count, the nodes in
    flight of the one kernel the source instantiates for it."""

    src = (_build.CSRC_DIR / "migrate_marginalise_v2.cu").read_text()
    built = re.findall(r"qm_migrate_marginalise_v2_kernel<(\d+), (\d+)>",
                       src)
    assert {int(k): int(n) for n, k in built} == M1_V2_NODES_IN_FLIGHT
    assert len(built) == len(M1_V2_NODES_IN_FLIGHT)
    assert "#define QM2_CHUNK QM_SBLK" in src and M1_V2_CHUNK == cm.SBLK
