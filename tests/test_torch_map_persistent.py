# -*- coding: utf-8 -*-
"""
M2 v2 of quakemigrate_torch (``csrc/migrate_map_persistent.cu``: locate's
float32 map on K1 v2's route, redesigned as a persistent ring) on the
CPU, where no kernel runs:

- its plain version, ``migrate_map_persistent_reference`` (the kernel's
  staging emulated: windows from the 16-byte unit of the rows laid end to
  end, NaN past each copy, the items of tile parts and runs), against
  JAX's ``migrate_map`` within 1e-5 relative at 61 and 201 samples (and
  30 and 300: one slot, two runs), on plans with padding tiles and nodes
  and rows of each length mod 4; bit for bit M2's arithmetic on the plan
  (``test_torch_map._m2_on_plan``); its per-sample max bit for bit the
  detect kernels' plain tmax;
- the ring and tables: the slots and runs of a scan (64 of them a node
  at 61 samples, 224 at 201), the parts, the table's node order (on the
  CPU by the plain version of the tables' kernel), the items that skip
  parts of padding, the entries below the stage, the blocks' bytes, the
  shapes against the source;
- the tables' kernel: a numpy emulation of its partition (a block a
  tile, chunks of 256 threads) against its plain version
  ``map_persistent_tables_reference``, its wrapper's arguments with the
  launch caught, its refusals;
- the wrapper with the launch caught: its C entry and every argument, the
  item count and run split, a counter a launch, its launch count; its
  refusals (CPU tensors, a plan without fine16, a tile not a multiple of
  16, a ring over the shared memory, tables built for another scan or
  row length, an ablation not built);
- ``CudaDetect.map`` calling the route's kernel (M2 v2, or M2 where M2
  v2 refuses the plan), its tables kept for each row length mod 4.

The kernels run on the card in chip_smoke.py's map_case, archive_locate's
map path and plot_path, and in experiments/exp_map_v2.py, held there to
M2 bit for bit and to their plain versions.

"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.migrate import migrate_map as j_migrate_map
from quakemigrate_torch import _build
from quakemigrate_torch.ops import cuda_migrate as cm
from quakemigrate_torch.ops.cuda_migrate import (
    CudaDetect,
    DetectPlan,
    combine_tiles,
    map_persistent_layout,
    map_persistent_refusal,
    map_persistent_tables,
    migrate_map_persistent_cuda,
    migrate_map_persistent_reference,
    plan_acc_chunks,
    reduce_acc_chunks,
)
from quakemigrate_torch.ops.migrate import _prepare_onsets

from test_torch_map import _m2_on_plan

torch.set_num_threads(1)

N_ONSETS = 6
FSMP, LSMP = 20, 40
RTOL = 1e-5
# (node_count, tile, brick): padding nodes in tiles, and a padding tile
PLANS = {"small": ((9, 8, 7), 64, (4, 4, 4)),
         "bricks": ((11, 9, 6), 256, (8, 8, 4))}


def _inputs(nsamples, seed, plan="small", extra=0):
    """Seeded onsets (``extra`` more samples, so rows of each length mod
    4), traveltimes reaching the rows' end, a dead onset row, the plan,
    the prepared onsets and 1 / available."""

    node_count, tile, brick = PLANS[plan]
    rng = np.random.default_rng(seed)
    n_nodes = int(np.prod(node_count))
    t_len = FSMP + nsamples + LSMP + extra
    onsets = rng.uniform(0.2, 6.0, size=(N_ONSETS, t_len))
    tt = rng.integers(0, LSMP + extra + 1, size=(n_nodes, N_ONSETS))
    tt = tt.astype(np.int32)
    mask = np.ones(N_ONSETS)
    mask[3] = 0.0
    det_plan = DetectPlan(tt, node_count, tile=tile, brick_shape=brick)
    onsets_log = _prepare_onsets(
        torch.from_numpy(onsets.astype(np.float32)),
        torch.from_numpy(mask.astype(np.float32))).contiguous()
    inv = (1.0 / torch.tensor(float(mask.sum()),
                              dtype=torch.float32)).reshape(1)
    return dict(onsets=onsets, tt=tt, mask=mask, plan=det_plan,
                onsets_log=onsets_log, inv=inv, nsamples=nsamples,
                node_count=node_count)


def _tables(plan, lay, t_len):
    """M2 v2's tables of a plan's K1 v2 tables on the CPU."""

    return map_persistent_tables(
        *(torch.from_numpy(getattr(plan, k)) for k in (
            "fine16", "base", "valid", "perm")), lay, FSMP, t_len,
        cm.map_persistent_items(plan.valid, lay))


def _persistent(inp, **layout):
    plan = inp["plan"]
    lay = map_persistent_layout(plan.r_spans, plan.tile, inp["nsamples"],
                                **layout)
    tables = _tables(plan, lay, inp["onsets_log"].shape[1])
    got = migrate_map_persistent_reference(
        inp["onsets_log"], torch.from_numpy(plan.base), inp["inv"], FSMP,
        inp["nsamples"], plan.n_nodes, tables)
    return got, tables


@pytest.mark.parametrize("extra", [0, 1, 2, 3])
@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("nsamples", [61, 201])
def test_reference_equals_jax(nsamples, plan, extra):
    inp = _inputs(nsamples, 2600 + nsamples + extra, plan, extra)
    got, _ = _persistent(inp)
    assert not torch.isnan(got).any()  # no read outside a copy
    want = np.asarray(j_migrate_map(
        inp["onsets"], inp["tt"], inp["mask"], float(inp["mask"].sum()),
        FSMP, nsamples, tile=128))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (len(inp["tt"]), nsamples)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("layout", [
    {}, {"parts": 4}, {"parts": 1}, {"parts": 4, "shape": (4, 4, 2)},
    {"shape": (4, 7, 1)}, {"n_stages": 2}])
@pytest.mark.parametrize("nsamples", [30, 61, 201, 300])
def test_reference_is_m2_bit_for_bit(nsamples, layout):
    """Any parts, shape or depth of the ring gives M2's map: the
    same onsets summed in order at each node's traveltime."""

    inp = _inputs(nsamples, 2700 + nsamples, "bricks", extra=nsamples % 4)
    got, tables = _persistent(inp, **layout)
    want = _m2_on_plan(inp["plan"], inp["onsets_log"], inp["inv"], nsamples)
    assert torch.equal(got, want)
    assert tables.layout.runs == -(-nsamples // tables.layout.run)


@pytest.mark.parametrize("nsamples", [61, 201])
def test_max_is_the_detect_tmax(nsamples):
    inp = _inputs(nsamples, 2800 + nsamples, "small", extra=1)
    plan = inp["plan"]
    got, _ = _persistent(inp)
    tmax, targ, tsum = reduce_acc_chunks(
        plan_acc_chunks(inp["onsets_log"], torch.from_numpy(plan.base),
                        torch.from_numpy(plan.fine), FSMP, nsamples),
        torch.from_numpy(plan.valid), inp["inv"])
    max_coa, _, _ = combine_tiles(tmax, targ, tsum,
                                  torch.from_numpy(plan.perm), plan.tile)
    assert torch.equal(got.max(dim=0).values, max_coa)


# -- the ring and its tables -------------------------------------------------

@pytest.mark.parametrize("nsamples, slots, shape, runs, issued", [
    (30, 1, (8, 1, 2), 1, 32), (61, 2, (8, 2, 2), 1, 64),
    (100, 4, (4, 4, 2), 1, 128), (201, 7, (4, 7, 1), 1, 224),
    (250, 8, (4, 8, 2), 1, 256), (300, 8, (4, 8, 2), 2, 512)])
def test_slots_and_runs(nsamples, slots, shape, runs, issued):
    """The fewest slots a lane that cover a run: 64 slots a node-onset at
    61 samples (4.9 % past the scan) and 224 at 201 (10.3 %; M2 read
    256 there)."""

    assert cm.map_persistent_slots(nsamples) == slots
    lay = map_persistent_layout([5, 9], 256, nsamples)
    assert lay.shape == shape and lay.runs == runs
    assert lay.runs * lay.run == issued


def test_layout_windows_parts_and_ring():
    lay = map_persistent_layout([37, 3, 10], 256, 61)
    run = 64
    widths = np.diff(lay.woff)
    assert list(widths) == [cm.round_up(r + 2 + run, 4) for r in (37, 3, 10)]
    assert lay.stage_floats == lay.woff[-1] and not lay.stage_floats % 4
    # two parts a 256-node tile at 8 nodes a group: 16 groups an item,
    # one a warp; the deepest ring with two blocks an SM
    assert (lay.parts, lay.npi) == (2, 128)
    assert lay.n_stages == 4
    assert lay.smem == cm.map_persistent_smem(lay.stage_floats, 3, 128, 4)
    assert lay.smem == 4 * (cm.round_up(16 + 4 * lay.stage_floats
                                        + 2 * 3 * 128 + 4 * 128, 128) + 16)
    assert map_persistent_layout([37], 64, 61).parts == 1
    # a ring that fits one block an SM only, then none
    wide = map_persistent_layout([20_000], 256, 201)
    assert wide is not None and wide.n_stages >= 2
    assert wide.smem > cm.SMEM_PER_SM // 2 - cm.SMEM_BLOCK_RESERVE
    assert map_persistent_layout([30_000], 256, 201) is None
    with pytest.raises(ValueError, match="shape"):
        map_persistent_layout([5], 256, 61, shape=(3, 2, 2))
    with pytest.raises(ValueError, match="parts"):
        map_persistent_layout([5], 256, 61, parts=3)
    # a shape of the sweep that lost is not built
    with pytest.raises(ValueError, match="shape"):
        map_persistent_layout([5], 256, 61, shape=(4, 2, 2))


@pytest.mark.parametrize("parts, shape", [(4, (4, 4, 2)), (2, (8, 2, 2))])
def test_tables(parts, shape):
    """Entries below the stage's floats, the real nodes first in each
    tile (a group's first node real, or the whole group padding), flat
    -1 on padding only, items only of parts with a real node, and each
    entry the window's offset, the first sample's place in its 16-byte
    unit and the residual."""

    inp = _inputs(61, 2900, "bricks", extra=3)
    plan = inp["plan"]
    lay = map_persistent_layout(plan.r_spans, plan.tile, 61, parts=parts,
                                shape=shape)
    t_len = inp["onsets_log"].shape[1]
    tables = _tables(plan, lay, t_len)
    npi = plan.tile // parts
    assert tables.res.dtype == torch.uint16
    res = tables.res.long().numpy()
    flat = tables.flat.numpy()
    assert res.shape == (plan.n_tiles, parts, N_ONSETS, npi)
    assert flat.shape == (plan.n_tiles, parts, npi)
    assert res.max() < lay.stage_floats
    real = flat >= 0
    assert real.sum() == plan.n_nodes
    assert sorted(flat[real].tolist()) == list(range(plan.n_nodes))
    # the real nodes of each tile first, in brick order
    for i in range(plan.n_tiles):
        row = flat[i].reshape(-1)
        n_real = int((row >= 0).sum())
        assert (row[n_real:] < 0).all()
        bricks = np.flatnonzero(plan.valid[i] > 0)
        assert (row[:n_real] == plan.perm.reshape(plan.n_tiles, -1)[
            i, bricks]).all()
    groups = flat.reshape(plan.n_tiles, parts, -1, shape[0])
    first_pad = groups[..., 0] < 0
    assert (groups[first_pad] < 0).all()
    items = tables.items.numpy()
    assert tables.items.dtype == torch.int32
    assert (real.reshape(-1, npi).any(axis=1).nonzero()[0] == items).all()
    assert len(items) < plan.n_tiles * parts  # padding parts are no items
    # each entry from the plan's fine16 through the table's order
    perm = plan.perm.reshape(plan.n_tiles, plan.tile)
    node_of = {int(f): (i, n) for i in range(plan.n_tiles)
               for n in range(plan.tile) if plan.valid[i, n] > 0
               for f in [perm[i, n]]}
    for (i, p, q) in [(0, 0, 0), (3, 1, 5), (plan.n_tiles - 1, 0, 2)]:
        f = flat[i, p, q]
        if f < 0:
            continue
        ti, n = node_of[int(f)]
        assert ti == i
        for o in range(N_ONSETS):
            lead = (o * t_len + FSMP + plan.base[i, o]) & 3
            assert res[i, p, o, q] == (lay.woff[o] + lead
                                       + plan.fine16[i, n, o])


def _kernel_tables(fine16, base, valid, perm, woff, parts, npi, t_len):
    """A numpy emulation of the tables' kernel: each node's place from the
    real nodes before it (or n_real + the padding before it), then its
    flat index and entries there."""

    n_tiles, tile, n_onsets = fine16.shape
    res = np.full((n_tiles, parts, n_onsets, npi), -1, np.int64)
    flat = np.full((n_tiles, parts, npi), -2, np.int64)
    lead = (np.arange(n_onsets) * (t_len % 4) + FSMP + base) & 3
    for i in range(n_tiles):
        real = valid[i] > 0
        ahead = np.cumsum(real) - real
        n = np.arange(tile)
        place = np.where(real, ahead, real.sum() + n - ahead)
        part, q = place // npi, place % npi
        flat[i, part, q] = np.where(real, perm[i * tile + n], -1)
        for o in range(n_onsets):
            res[i, part, o, q] = woff[o] + lead[i, o] + fine16[i, n, o]
    return res, flat


@pytest.mark.parametrize("tile, parts", [(64, 1), (256, 2), (512, 4)])
def test_tables_reference_is_the_kernels_partition(tile, parts):
    """The plain version of the tables' kernel (a stable sort) places each
    node where the kernel's partition does, over chunks of 256 threads
    (tile 512: two), every entry and flat index written."""

    rng = np.random.default_rng(3100 + tile)
    n_tiles, n_onsets, npi = 5, 7, tile // parts
    fine16 = rng.integers(0, 300, (n_tiles, tile, n_onsets)).astype(np.int16)
    base = rng.integers(0, 1000, (n_tiles, n_onsets)).astype(np.int32)
    valid = (rng.random((n_tiles, tile)) < 0.7).astype(np.float32)
    valid[1] = 0.0  # a tile of padding
    perm = rng.permutation(n_tiles * tile).astype(np.int32)
    lay = SimpleNamespace(parts=parts, npi=npi,
                          woff=np.arange(n_onsets + 1, dtype=np.int32) * 400)
    woff = torch.from_numpy(lay.woff)
    t_len = 1001
    res, flat = cm.map_persistent_tables_reference(
        *(torch.from_numpy(a) for a in (fine16, base, valid, perm)), woff,
        lay, FSMP, t_len)
    want_res, want_flat = _kernel_tables(fine16, base, valid, perm,
                                         lay.woff, parts, npi, t_len)
    assert res.dtype == torch.uint16 and flat.dtype == torch.int32
    assert (res.long().numpy() == want_res).all()
    assert (flat.numpy() == want_flat).all()
    items = cm.map_persistent_items(valid, lay)
    assert set(items.tolist()) == {
        i * parts + p for i in range(n_tiles) for p in range(parts)
        if valid[i].sum() > p * npi}


def test_tables_wrapper_hands_the_kernel_its_arguments(caught):
    det, onsets_log, inv = _detector()
    t_len = onsets_log.shape[1]
    lay = map_persistent_layout(det.plan.r_spans, det.tile, 61)
    woff = torch.from_numpy(lay.woff)
    res, flat = cm.map_persistent_tables_cuda(
        det.fine16, det.base, det.valid, det.perm, woff, lay, FSMP, t_len)
    (args,) = caught
    assert args[0] == "qm_migrate_map_persistent_tables"
    assert len(args) - 2 == len(_build.SIGNATURES[args[0]]) - 1
    assert args[2:9] == tuple(t.data_ptr() for t in (
        det.fine16, det.base, det.valid, det.perm, woff, res, flat))
    n_tiles = det.plan.n_tiles
    assert args[9:] == (N_ONSETS, n_tiles, det.tile, lay.parts, lay.npi,
                        FSMP, t_len % 4)
    assert res.shape == (n_tiles, lay.parts, N_ONSETS, lay.npi)
    assert res.dtype == torch.uint16
    assert flat.shape == (n_tiles, lay.parts, lay.npi)
    assert cm.launches["migrate_map_persistent_tables"] == 1


def test_tables_wrapper_refusals():
    det, onsets_log, inv = _detector()
    lay = map_persistent_layout(det.plan.r_spans, det.tile, 61)
    woff = torch.from_numpy(lay.woff)
    args = (det.base, det.valid, det.perm, woff)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cm.map_persistent_tables_cuda(det.fine16, *args, lay, FSMP, 100)
    with pytest.raises(ValueError, match="int16"):
        cm.map_persistent_tables_cuda(det.fine16.int(), *args, lay, FSMP,
                                      100)
    with pytest.raises(ValueError, match="parts"):
        cm.map_persistent_tables_cuda(det.fine16, *args, SimpleNamespace(
            parts=3, npi=lay.npi, woff=lay.woff), FSMP, 100)


def test_shapes_and_ablations_match_the_source():
    src = (cm.__file__.rsplit("/ops/", 1)[0]
           + "/csrc/migrate_map_persistent.cu")
    text = open(src).read()

    def listed(macro):
        body = re.search(rf"#define {macro}\(X\)(.*?)\n(?!  )", text,
                         re.S).group(1)
        return tuple(tuple(int(n) for n in m) for m in
                     re.findall(r"X\((\d+), (\d+), (\d+)\)", body))

    assert listed("MP_SHAPES") == cm.MAP_PERSISTENT_SHAPES
    assert listed("MP_ABLATED") == cm.MAP_PERSISTENT_ABLATED
    assert f"#define MP_WARPS {cm.MAP_PERSISTENT_WARPS}" in text
    for name, code in cm.MAP_PERSISTENT_VARIANTS.items():
        macro = {"full": "MP_FULL", "nostore": "MP_NOSTORE",
                 "nogather": "MP_NOGATHER", "stage": "MP_STAGE"}[name]
        assert f"#define {macro} {code}" in text
    assert set(cm.MAP_PERSISTENT_SHAPE.values()) <= set(
        cm.MAP_PERSISTENT_SHAPES)
    # the items' counter zeroed on the launch's stream by the C entry, and
    # the fill's generic stores fenced from the async proxy's refill
    assert "cudaMemsetAsync(counter, 0, sizeof(int), stream)" in text
    assert "wg_fence_proxy_async();" in text
    assert "#define MPT_THREADS 256" in text


# -- the wrapper, the launch caught ------------------------------------------

def _detector(nsamples=61, extra=2, **kw):
    inp = _inputs(nsamples, 3000, "small", extra)
    det = CudaDetect(inp["tt"], inp["node_count"], FSMP, nsamples, "cpu",
                     tile=64, brick_shape=(4, 4, 4), **kw)
    onsets_log, inv = det.prepare(
        torch.from_numpy(inp["onsets"].astype(np.float32)),
        torch.from_numpy(inp["mask"].astype(np.float32)),
        float(inp["mask"].sum()))
    return det, onsets_log, inv


@pytest.fixture
def caught(monkeypatch):
    """The launches caught as if on the card: CPU tensors pass the
    wrappers' device check, nothing is launched."""

    seen = []
    monkeypatch.setattr(cm, "launch_kernel", lambda *a: seen.append(a))
    monkeypatch.setattr(cm, "launches", dict(cm.launches))
    monkeypatch.setattr(cm, "_check_cuda", lambda device: None)
    return seen


@pytest.mark.parametrize("nsamples", [61, 201, 300])
def test_wrapper_hands_the_kernel_its_arguments(nsamples, caught):
    det, onsets_log, inv = _detector(nsamples)
    tables = det.map_tables(onsets_log.shape[1])
    lay = tables.layout
    out = migrate_map_persistent_cuda(onsets_log, det.base, inv, FSMP,
                                      nsamples, det.n_nodes, tables,
                                      det._max_shift)
    (args,) = caught
    assert args[0] == "qm_migrate_map_persistent"
    assert len(args) - 2 == len(_build.SIGNATURES[args[0]]) - 1
    assert args[2:4] == (onsets_log.data_ptr(), onsets_log.shape[1])
    # the counter a launch's own, none of the tables
    assert args[11] not in {t.data_ptr() for t in (
        tables.res, tables.flat, tables.items, tables.woff)}
    assert not hasattr(tables, "counter")
    n_items = tables.items.numel() * lay.runs
    assert args[12:] == (N_ONSETS, n_items, lay.runs, lay.parts, lay.npi,
                         FSMP, nsamples, lay.stage_floats, lay.n_stages,
                         *lay.shape, 0)
    assert lay.runs == -(-nsamples // (32 * lay.shape[1]))
    assert out.shape == (det.n_nodes, nsamples)
    assert out.dtype == torch.float32
    assert cm.launches["migrate_map_persistent"] == 1
    migrate_map_persistent_cuda(onsets_log, det.base, inv, FSMP, nsamples,
                                det.n_nodes, tables, det._max_shift,
                                variant="stage" if lay.shape in
                                cm.MAP_PERSISTENT_ABLATED else "full")
    assert caught[1][-1] == (3 if lay.shape in cm.MAP_PERSISTENT_ABLATED
                             else 0)


def test_wrapper_copies_rows_off_a_16_byte_unit(caught):
    det, onsets_log, inv = _detector()
    tables = det.map_tables(onsets_log.shape[1])
    view = torch.cat([torch.zeros(1), onsets_log.reshape(-1)])[1:].view(
        onsets_log.shape)
    assert view.data_ptr() % 16
    migrate_map_persistent_cuda(view, det.base, inv, FSMP, 61, det.n_nodes,
                                tables, det._max_shift)
    assert caught[0][2] % 16 == 0 and caught[0][2] != view.data_ptr()


def test_wrapper_refusals(caught):
    det, onsets_log, inv = _detector()
    t_len = onsets_log.shape[1]
    tables = det.map_tables(t_len)
    args = (det.base, inv, FSMP, 61, det.n_nodes, tables, det._max_shift)
    with pytest.raises(ValueError, match="row"):
        migrate_map_persistent_cuda(onsets_log[:, :-1].contiguous(), *args)
    with pytest.raises(ValueError, match="fsmp"):
        migrate_map_persistent_cuda(onsets_log, det.base, inv, FSMP + 1, 61,
                                    det.n_nodes, tables, det._max_shift)
    with pytest.raises(ValueError, match="too short"):
        migrate_map_persistent_cuda(onsets_log[:, :-4].contiguous(), *args)
    with pytest.raises(ValueError, match="float32"):
        migrate_map_persistent_cuda(onsets_log.double(), *args)
    lay = map_persistent_layout(det.plan.r_spans, det.tile, 61,
                                shape=(8, 1, 2))
    one_slot = map_persistent_tables(
        det.fine16, det.base, det.valid, det.perm, lay, FSMP, t_len,
        cm.map_persistent_items(det.plan.valid, lay))
    with pytest.raises(ValueError, match="no 'nostore' form"):
        migrate_map_persistent_cuda(onsets_log, det.base, inv, FSMP, 61,
                                    det.n_nodes, one_slot, det._max_shift,
                                    variant="nostore")
    assert caught == []


def test_wrapper_raises_on_cpu_tensors():
    det, onsets_log, inv = _detector()
    with pytest.raises(ValueError, match="CUDA tensors"):
        migrate_map_persistent_cuda(onsets_log, det.base, inv, FSMP, 61,
                                    det.n_nodes,
                                    det.map_tables(onsets_log.shape[1]),
                                    det._max_shift)
    with pytest.raises(ValueError, match="CUDA tensors"):
        det.map(onsets_log, inv)


def test_refusals_of_the_plan():
    det, onsets_log, inv = _detector()
    plan = det.plan
    assert map_persistent_refusal(plan, 61) is None
    no16 = DetectPlan(np.full((64, 2), 40_000, np.int32), (4, 4, 4),
                      tile=64, brick_shape=(4, 4, 4))
    no16.r_spans = (40_000, 2)
    no16.r_span = 40_000
    assert "fine16" in map_persistent_refusal(no16, 61)
    with pytest.raises(ValueError, match="fine16"):
        map_persistent_tables(None, None, None, None,
                              map_persistent_layout([5, 5], 64, 61), FSMP,
                              100, [])
    odd = DetectPlan(np.zeros((8 * 8 * 4, 2), np.int32), (8, 8, 4), tile=8,
                     brick_shape=(2, 2, 2))
    assert "multiple of 16" in map_persistent_refusal(odd, 61)
    wide = DetectPlan(np.zeros((256, 2), np.int32), (8, 8, 4))
    wide.r_spans = (30_000, 5)
    wide.r_span = 30_000
    assert "shared memory" in map_persistent_refusal(wide, 201)


@pytest.mark.parametrize("refused, extra, key, n_tables", [
    (False, 0, "migrate_map_persistent", 1),
    (False, 1, "migrate_map_persistent", 2),
    (True, 0, "migrate_map_v2", 0)])
def test_cuda_detect_map_takes_the_routes_kernel(refused, extra, key,
                                                 n_tables, monkeypatch,
                                                 caught):
    """CudaDetect.map (K1 v2's route: locate's map path, the event
    video) launches M2 v2 where it takes the plan, else M2; its tables
    built once for each row length mod 4 (``extra``: a second call on
    rows one sample longer)."""

    monkeypatch.setattr(cm, "check_kernel_args", lambda *a, **k: (
        N_ONSETS, onsets_log.shape[1], det.base.shape[0], det.tile))
    det, onsets_log, inv = _detector()
    if refused:
        det.__dict__["map_refusal"] = "refused"
    out = det.map(onsets_log, inv)
    longer = torch.cat([onsets_log, onsets_log[:, -1:]], 1) if extra else \
        onsets_log
    det.map(longer, inv)
    assert out.shape == (det.n_nodes, 61)
    assert [a[0] for a in caught] == [f"qm_{key}"] * 2
    assert {k: n for k, n in cm.launches.items() if n} == {key: 2}
    assert len(det._map_tables) == n_tables
    if n_tables == 2:
        assert caught[1][3] == onsets_log.shape[1] + 1
        assert caught[1][5] != caught[0][5]  # the other table's entries


# -- the experiment on the CPU ------------------------------------------------

def test_experiment_bound_and_slots_on_the_cpu():
    """experiments/exp_map_v2.py's plans and bounds without a card: the
    Icequake workload plan's gather floor (259,008 nodes x 26 onsets x
    61 samples at 33.5 TB/s) and the 64 slots M2 v2 reads a node-onset
    there, 224 at the VT-sized plan's 201 samples."""

    from quakemigrate_torch.experiments import exp_map_v2

    s = exp_map_v2.setup("icequake", "cpu")
    b = exp_map_v2.bound(s)
    assert s.detector.n_nodes == 259_008 and s.n_onsets == 26
    assert b["gather_floor_ms"] == pytest.approx(
        4 * 259_008 * 26 * 61 / 33.5e12 * 1e3)
    assert b["slots"] == 64
    assert b["issued_floor_ms"] > b["gather_floor_ms"]
    vt = exp_map_v2.setup("vt", "cpu")
    assert exp_map_v2.bound(vt)["slots"] == 224
    assert vt.detector.map_tables(vt.t_len).layout.shape == (4, 7, 1)


def test_experiment_requires_cuda(monkeypatch):
    from quakemigrate_torch.experiments import exp_map_v2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        exp_map_v2.main([])
