# -*- coding: utf-8 -*-
"""
M1 ring and M2 ring of quakemigrate_torch
(``csrc/migrate_marginalise_ring.cu``: locate's pass 2 and map on K3 v2's
ring of onset windows, for the routes whose plans K1 v2 does not stage)
on the CPU:

- their plain versions, ``marginalise_ring_reference`` and
  ``map_ring_reference`` (the kernels' tables, entry shift, lane and
  chunk order), against the JAX ``migrate_marginalise`` and
  ``migrate_map`` within 1e-5 of the maximum, on a K3-route plan (tile
  256, residual spans of ~1,200 samples, CudaDetectGlobal's K3 v2 tables)
  and a K2 v2-route plan (tile 512, 96 onsets, CudaDetectVPU's ring
  tables), at windows of one sample to three chunks and starts of every
  residue mod 4;
- a numpy emulation of M1 ring's staging (each window copied from its
  16-byte column, cut to the floats its block needs, the rest of the
  stage NaN) that reads no float outside what was copied, writes every
  real node once and padding never, and at a window of one chunk equals
  the numpy emulation of M1 bit for bit (within 1e-6 beyond);
- the routing: M1 ring and M2 ring on both routes, M1 and M2's simple
  form on the wide-span toy and at tile 64, in float64 the ring's f64
  forms where K3 v2 f64 takes the plan, with the refusal's words on the
  detector and in the route's log line;
- the wrappers: their checks, the CPU refusal, the arguments they hand
  the C entries, and those entries' signatures;
- ``global_v2_tables`` at tile 512 against the plan, K3 v2 still refusing
  it, and a mesh slab's tables, which keep flat indices global.

The kernels run only on the card, where chip_smoke.py holds them to these
plain versions, to M1 and M2's simple form and to K3 v2's tmax.

"""

import ctypes
import logging

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.migrate import migrate_map as j_migrate_map
from quakemigrate_tpu.ops.migrate import (
    migrate_marginalise as j_migrate_marginalise,
)
from quakemigrate_torch import _build
from quakemigrate_torch.ops import cuda_migrate as cm
from quakemigrate_torch.ops.migrate import _prepare_onsets
from quakemigrate_torch.signal.scan import detect_route, locate_kernels
from quakemigrate_torch.util import round_up

import test_torch_marginalise as t_m1
from test_torch_scan_route import _regional_traveltimes, _traveltimes

torch.set_num_threads(1)

RTOL_OF_MAX = 1e-5
# M1 ring against M1 beyond one chunk: the chunks' sums are added in
# other groupings (124 samples against 256), so they differ by roundings
M1_RTOL = 1e-6
# The ring emulation (numpy's exp) against the torch plain version
# (torch's exp): a few float32 ulps of exp
EXP_RTOL = 2e-6
CUDA = torch.device("cuda")  # a device type; nothing here touches a card
F64 = torch.float64
CHUNK = cm.RING_CHUNK
FSMP, NSAMPLES = 30, 300
WINDOWS = [(0, 25), (30, 31), (NSAMPLES - 17, 17), (44, 1), (7, 70),
           (37, 2 * CHUNK + 1)]
# Starts of every residue mod 4, at one chunk and at two
RESIDUES = [(100 + r, 60) for r in range(4)] + [(101 + r, 130)
                                                for r in range(4)]


def _geometry(name):
    """(traveltimes, node_count, detector class): the K3 route's plan
    (CudaDetectGlobal, tile 256, regional spans) or the K2 v2 route's
    (CudaDetectVPU, tile 512, 96 onsets)."""

    if name == "k3":
        return (_regional_traveltimes(node_count=(16, 16, 8), spacing_km=4.0,
                                      n_stations=6), (16, 16, 8),
                cm.CudaDetectGlobal)
    return _traveltimes((16, 16, 8), 96, 40), (16, 16, 8), cm.CudaDetectVPU


_CASES = {}


def _case(name):
    """Seeded onsets (one dead row), the detector of the geometry on the
    CPU, its prepared onsets and the ring's tables."""

    if name not in _CASES:
        tt, nc, kind = _geometry(name)
        rng = np.random.default_rng(2201 if name == "k3" else 2202)
        n_onsets = tt.shape[1]
        onsets = rng.uniform(0.2, 6.0, size=(
            n_onsets, FSMP + NSAMPLES + int(tt.max()) + 5)).astype(np.float32)
        mask = np.ones(n_onsets, np.float32)
        mask[3] = 0.0
        detector = kind(tt, nc, FSMP, NSAMPLES, "cpu")
        onsets_log, inv = detector.prepare(
            torch.from_numpy(onsets), torch.from_numpy(mask),
            float(mask.sum()))
        _CASES[name] = dict(tt=tt, onsets=onsets, mask=mask,
                            available=float(mask.sum()), detector=detector,
                            onsets_log=onsets_log, inv=inv,
                            tables=detector.ring_tables())
    return _CASES[name]


def _ring_m1(c, start, length):
    d = c["detector"]
    return cm.marginalise_ring_reference(
        c["onsets_log"], d.base, c["inv"], FSMP, start, length, d.n_nodes,
        c["tables"]).numpy()


@pytest.mark.parametrize("geometry", ["k3", "k2_v2"])
def test_ring_tables_on_both_routes(geometry):
    """K3's route runs the ring on K3 v2's own tables (no second table);
    K2 v2's builds its own at the first call, keeps it, and records its
    build seconds and bytes; the layout's block fits its budget."""

    c = _case(geometry)
    d = c["detector"]
    assert d.ring_refusal is None
    tables = d.ring_tables()
    assert tables is c["tables"] and d.ring_tables() is tables
    if geometry == "k3":
        assert tables is d.tables and d.tile == cm.GLOBAL_V2_TILE
    else:
        assert d.tile == 512 and tables.res.shape[1] == 4
        assert tables.build_s >= 0
        assert tables.nbytes == (tables.res.numel() * 2
                                 + tables.flat.numel() * 4
                                 + tables.win.numel() * 4)
    layout = tables.layout
    assert layout.shape in cm.RING_SHAPES
    assert cm.ring_smem(layout) < cm.global_v2_smem(
        layout.shape, layout.stage_floats, layout.group, layout.n_stages)
    assert cm.ring_smem(layout) <= cm.global_v2_budget(layout.shape)


@pytest.mark.parametrize("start, length", WINDOWS + RESIDUES)
@pytest.mark.parametrize("geometry", ["k3", "k2_v2"])
def test_marginalise_ring_reference_equals_jax(geometry, start, length):
    c = _case(geometry)
    got = _ring_m1(c, start, length)
    want = np.asarray(j_migrate_marginalise(
        c["onsets"], c["tt"], c["mask"], np.float32(c["available"]), FSMP,
        NSAMPLES, start, length, tile=128))
    assert got.shape == want.shape == (c["tt"].shape[0],)
    assert np.abs(got - want).max() <= RTOL_OF_MAX * np.abs(want).max()


@pytest.mark.parametrize("geometry", ["k3", "k2_v2"])
def test_map_ring_reference_equals_jax(geometry):
    c = _case(geometry)
    d = c["detector"]
    got = cm.map_ring_reference(c["onsets_log"], d.base, c["inv"], FSMP,
                                NSAMPLES, d.n_nodes, c["tables"]).numpy()
    want = np.asarray(j_migrate_map(
        c["onsets"], c["tt"], c["mask"], np.float32(c["available"]), FSMP,
        NSAMPLES, tile=128))
    assert got.shape == want.shape == (c["tt"].shape[0], NSAMPLES)
    assert np.abs(got - want).max() <= RTOL_OF_MAX * np.abs(want).max()


def _emulate_ring_m1(logged, inv, fsmp, base, tables, start, length,
                     n_nodes):
    """M1 ring in numpy float32, block by block: each onset's window
    copied as the kernel copies it (from ((fsmp + base) & ~3) + (d & ~3),
    cut to width - need floats and at the row's end) into a buffer that
    is NaN beyond the copy; every node's samples read at its entry less
    the window's offset plus d & 3; the onsets added in order, exp of
    the sum times inv, the lane's samples in k order, the xor tree, the
    chunks in chunk order. Returns (out, writes per flat node, whether
    any read of a used sample fell outside the copy)."""

    res = tables.res.long().numpy()
    win = tables.win.numpy().astype(np.int64)
    flat = tables.flat.numpy()
    base = np.asarray(base, np.int64)
    n_tiles, passes, n_onsets, slice_ = res.shape
    tile = passes * slice_
    t_len = logged.shape[1]
    ld = round_up(t_len, 4)
    rows = np.zeros((n_onsets, ld), np.float32)
    rows[:, :t_len] = logged
    n_chunks = max(1, -(-length // CHUNK))
    slots = cm.ring_slots(length)
    partial = np.zeros((n_chunks, n_nodes), np.float32)
    writes = np.zeros(n_nodes, int)
    outside = False
    lane_t = np.arange(32 * slots)
    for i in range(n_tiles):
        entries = res[i].transpose(1, 0, 2).reshape(n_onsets, tile)
        real = flat[i] >= 0
        for c in range(n_chunks):
            d = start + c * CHUNK
            cw = min(CHUNK, length - c * CHUNK)
            need = max(0, 128 - round_up(cw + 2, 4))
            acc = np.zeros((tile, 32 * slots), np.float32)
            for o in range(n_onsets):
                col = ((fsmp + base[i, o]) & ~3) + (d & ~3)
                copy = min(win[o, 1] - need, ld - col)
                buf = np.full(win[o, 1] + 128, np.nan, np.float32)
                buf[:copy] = rows[o, col:col + copy]
                idx = (entries[o] - win[o, 0] + (d & 3))[:, None] + lane_t
                acc += buf[idx]
            used = acc[:, :cw]
            outside |= bool(np.isnan(used).any())
            coa = np.exp(used * inv).astype(np.float32)
            lanes = np.zeros((tile, 32), np.float32)
            for t in range(cw):
                lanes[:, t % 32] += coa[:, t]
            for x in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[:, np.arange(32) ^ x]
            partial[c, flat[i][real]] = lanes[real, 0]
        writes[flat[i][real]] += 1
    out = partial[0].copy()
    for c in range(1, n_chunks):
        out += partial[c]
    return out, writes, outside


@pytest.mark.parametrize("start, length", WINDOWS + RESIDUES)
@pytest.mark.parametrize("geometry", ["k3", "k2_v2"])
def test_ring_emulation_stays_in_stage(geometry, start, length):
    """No sample the window needs is read from outside the copied part of
    its staged window, at any start residue; every real node is written
    once and padding never; the emulation agrees with the plain
    version."""

    c = _case(geometry)
    d = c["detector"]
    logged = c["onsets_log"].numpy()
    inv = np.float32(c["inv"].item())
    got, writes, outside = _emulate_ring_m1(
        logged, inv, FSMP, d.plan.base, c["tables"], start, length,
        d.n_nodes)
    assert not outside
    assert (writes == 1).all()  # every flat node is real here
    want = _ring_m1(c, start, length)
    assert np.abs(got - want).max() <= EXP_RTOL * np.abs(want).max()


def test_padding_never_written():
    """A grid whose bricks overhang it: padding nodes (flat -1) are never
    written, each real node once, and the plain version leaves zeros
    only where no real node is."""

    inputs = t_m1._make_inputs(t_m1.NSAMPLES, 2203)
    plan = cm.DetectPlan(inputs["traveltimes"], t_m1.NODE_COUNT)
    assert (plan.valid == 0).any()
    detector = cm.CudaDetectVPU(inputs["traveltimes"], t_m1.NODE_COUNT,
                                t_m1.FSMP, t_m1.NSAMPLES, "cpu", plan=plan)
    tables = detector.ring_tables()
    flat = tables.flat.numpy()
    assert (flat[plan.valid == 0] == -1).all()
    assert np.array_equal(np.sort(flat[flat >= 0]),
                          np.arange(plan.n_nodes))
    logged, inv = _m1_logged(inputs)
    _, writes, outside = _emulate_ring_m1(
        logged, inv, t_m1.FSMP, plan.base, tables, 5, 40, plan.n_nodes)
    assert not outside and (writes == 1).all()


def _m1_logged(inputs):
    logged = _prepare_onsets(
        torch.from_numpy(inputs["onsets"]),
        torch.from_numpy(inputs["mask"].astype(np.float32)),
    ).numpy().astype(np.float32)
    return logged, np.float32(1.0) / np.float32(inputs["available"])


def _long_inputs():
    """test_torch_marginalise's long scan (M1_CHUNK samples three times
    and more), its seed."""

    return t_m1._make_inputs(t_m1.LONG_NSAMPLES, 1314)


@pytest.mark.parametrize("start, length", [
    (0, 25), (30, 31), (t_m1.NSAMPLES - 17, 17), (44, 1), (7, 70),
    (1, 33), (2, 64), (3, 65), (0, 0)] + [(400 + r, CHUNK - r)
                                          for r in range(4)])
def test_one_chunk_equals_m1_emulation_bit_for_bit(start, length):
    """At a window of one chunk (CHUNK samples or fewer) M1 ring's
    arithmetic is M1's: the emulations are equal bit for bit, at every
    start residue mod 4, on the same tile-256 plan."""

    inputs = _long_inputs()
    plan = cm.DetectPlan(inputs["traveltimes"], t_m1.NODE_COUNT)
    detector = cm.CudaDetectVPU(inputs["traveltimes"], t_m1.NODE_COUNT,
                                t_m1.FSMP, inputs["nsamples"], "cpu",
                                plan=plan)
    logged, inv = _m1_logged(inputs)
    got, _, outside = _emulate_ring_m1(
        logged, inv, t_m1.FSMP, plan.base, detector.ring_tables(), start,
        length, plan.n_nodes)
    want, writes = t_m1._emulate_m1(inputs, plan, start, length)
    assert not outside and (writes == 1).all()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("start, length", [
    (0, t_m1.LONG_NSAMPLES), (37, 2 * t_m1.M1_CHUNK + 1),
    (101, CHUNK + 1), (2, 3 * CHUNK)])
def test_chunks_within_m1_rtol_of_m1_emulation(start, length):
    """Beyond one chunk M1 ring's chunks (124 samples) group the sums
    otherwise than M1's (256): within 1e-6 of M1's emulation per node."""

    inputs = _long_inputs()
    plan = cm.DetectPlan(inputs["traveltimes"], t_m1.NODE_COUNT)
    detector = cm.CudaDetectVPU(inputs["traveltimes"], t_m1.NODE_COUNT,
                                t_m1.FSMP, inputs["nsamples"], "cpu",
                                plan=plan)
    logged, inv = _m1_logged(inputs)
    got, _, outside = _emulate_ring_m1(
        logged, inv, t_m1.FSMP, plan.base, detector.ring_tables(), start,
        length, plan.n_nodes)
    want, _ = t_m1._emulate_m1(inputs, plan, start, length)
    assert not outside
    assert (np.abs(got - want) / np.abs(want)).max() <= M1_RTOL


def _wide_toy():
    tt = np.zeros((4 * 4 * 4, 2), np.int32)
    tt[1, 1] = cm.FINE16_MAX_SPAN + 1
    return tt, (4, 4, 4)


def _caught(monkeypatch):
    """Take CPU tensors as if on the card: the device checks pass and the
    launches are caught (their counts go to a copy of the module's)."""

    seen = []
    real_check = cm.check_kernel_args

    def on_card(*args, **kwargs):
        try:
            return real_check(*args, **kwargs)
        except ValueError as e:
            if "CUDA tensors" not in str(e):
                raise
            fine = args[2]
            return (args[0].shape[0], args[0].shape[1], fine.shape[0],
                    fine.shape[-1])

    monkeypatch.setattr(cm, "check_kernel_args", on_card)
    monkeypatch.setattr(cm, "_check_cuda", lambda device: None)
    monkeypatch.setattr(cm, "launch_kernel",
                        lambda name, device, *args: seen.append((name, args)))
    monkeypatch.setattr(cm, "launches", dict(cm.launches))
    return seen


def _toy_inputs(detector, t_len, seed=2204):
    rng = np.random.default_rng(seed)
    onsets = torch.from_numpy(rng.uniform(
        0.5, 3.0, size=(detector.plan.n_onsets, t_len)).astype(np.float32))
    mask = torch.ones(detector.plan.n_onsets)
    return detector.prepare(onsets, mask, float(detector.plan.n_onsets))


@pytest.mark.parametrize("kind", [cm.CudaDetectGlobal, cm.CudaDetectVPU])
def test_wide_span_toy_keeps_m1_and_m2_simple(kind, monkeypatch):
    """A residual span no ring holds: the detector keeps the refusal's
    words (K3 v2's on K3's route), and pass 2 and the map launch M1 and
    M2's simple form, nothing else."""

    tt, nc = _wide_toy()
    detector = kind(tt, nc, 0, 8, "cpu", plan=cm.DetectPlan(tt, nc))
    assert "shared memory" in detector.ring_refusal
    assert detector.ring_tables() is None
    if kind is cm.CudaDetectGlobal:
        assert detector.ring_refusal == detector.v2_refusal
    onsets_log, inv = _toy_inputs(detector, 8 + detector.plan.max_shift)
    seen = _caught(monkeypatch)
    detector.marginalise(onsets_log, inv, 2, 5)
    detector.map(onsets_log, inv)
    assert [name for name, _ in seen] == ["qm_migrate_marginalise",
                                          "qm_migrate_map"]
    assert {k: n for k, n in cm.launches.items() if n} == {
        "migrate_marginalise": 1, "migrate_map": 1}


@pytest.mark.parametrize("case", ["float64", "float64 wide span",
                                  "tile 64"])
def test_float64_and_tile_64_keep_m1_and_m2_simple(case):
    """``ring_refusal`` by type and tile: CudaDetectGlobal in float64 runs
    M1 ring f64 and M2 ring f64 on its K3 v2 f64 tables; a span the ring
    of doubles cannot hold (but float32's can) keeps M1 f64 and M2 simple
    f64 with K3 v2 f64's words; a tile of 64 nodes is not a whole pass of
    any float32 shape."""

    if case == "float64":
        tt = _traveltimes((8, 8, 4), 6, 30)
        double = cm.CudaDetectGlobal(tt, (8, 8, 4), 5, 40, "cpu", dtype=F64)
        assert double.tables is not None and double.ring_refusal is None
        assert cm.ring_refusal(double.plan, F64) is None
        assert double.ring_tables() is double.tables
        assert double.tables.layout.dtype == F64
    elif case == "float64 wide span":
        tt = np.zeros((64, 2), np.int32)
        tt[1, 1] = 15_000 - 1
        double = cm.CudaDetectGlobal(tt, (4, 4, 4), 5, 40, "cpu", dtype=F64)
        reason = cm.global_v2_refusal(double.plan, F64)
        assert cm.ring_refusal(double.plan) is None
        assert cm.ring_refusal(double.plan, F64) == reason
        assert double.ring_refusal == reason and "doubles" in reason
        assert double.ring_tables() is None
    else:
        tt = _traveltimes((8, 8, 4), 6, 30)
        small = cm.CudaDetectVPU(tt, (8, 8, 4), 5, 40, "cpu", tile=64,
                                 brick_shape=(4, 4, 4))
        assert small.ring_refusal == ("tile 64 is not a multiple of the "
                                      "ring's 128 nodes a pass")
        assert small.ring_tables() is None


def test_route_logs_locate_kernels(caplog):
    """The route's one log line says where locate runs: on the ring for
    256 onsets (K2 v2's route) and the F3-like plan (K3's), on M1 and M2
    simple with the ring's reason for the wide-span toy."""

    cases = [(_traveltimes((12, 12, 10), 256, 40), (12, 12, 10), "k2_v2"),
             (_regional_traveltimes(), (40, 40, 16), "k3"),
             (*_wide_toy(), "k3")]
    for tt, nc, route in cases:
        caplog.clear()
        with caplog.at_level(logging.INFO):
            got, _, plan = detect_route(tt, nc, CUDA)
        assert got == route
        (line,) = [r.getMessage() for r in caplog.records]
        assert locate_kernels(plan) in line
        if cm.ring_refusal(plan) is None:
            assert "locate on M1 ring and M2 ring" in line
        else:
            assert "locate on M1 and M2 simple (a ring of 2 stages" in line
    # float64: F3-like plans take M1 ring f64 and M2 ring f64 (and
    # "double" logs no line where K3 v2 f64 takes the plan); a span the
    # ring of doubles cannot hold logs K3 f64 and M1 f64 with its words
    f3 = cm.DetectPlan(_regional_traveltimes(), (40, 40, 16))
    assert locate_kernels(f3, F64) == "locate on M1 ring f64 and M2 ring f64"
    tt = np.zeros((64, 2), np.int32)
    tt[1, 1] = 15_000 - 1
    caplog.clear()
    with caplog.at_level(logging.INFO):
        got, _, plan = detect_route(tt, (4, 4, 4), CUDA, precision="double")
    assert got == "k3"
    (line,) = [r.getMessage() for r in caplog.records]
    assert locate_kernels(plan, F64) in line and "using K3 f64" in line
    assert ("locate on M1 f64 and M2 simple f64 (K3 v2's ring of 2 stages "
            "of one window of") in line


@pytest.mark.parametrize("geometry", ["k3", "k2_v2"])
def test_wrappers_raise_on_cpu_tensors(geometry):
    c = _case(geometry)
    d = c["detector"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        d.marginalise(c["onsets_log"], c["inv"], 0, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        d.map(c["onsets_log"], c["inv"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        cm.migrate_marginalise_ring_cuda(
            c["onsets_log"], d.base, c["inv"], FSMP, NSAMPLES, 0, 10,
            d.n_nodes, c["tables"], d._max_shift)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cm.migrate_map_ring_cuda(c["onsets_log"], d.base, c["inv"], FSMP,
                                 NSAMPLES, d.n_nodes, c["tables"],
                                 d._max_shift)


def _bad(c, what):
    """Arguments of migrate_marginalise_ring_cuda with one thing wrong."""

    d = c["detector"]
    args = dict(onsets_log=c["onsets_log"], base=d.base,
                inv_available=c["inv"], fsmp=FSMP, nsamples=NSAMPLES,
                window_start=0, window_length=10, n_nodes=d.n_nodes,
                tables=c["tables"], max_shift=d._max_shift)
    if what == "inside":
        args.update(window_start=NSAMPLES - 3, window_length=4)
    elif what == "too short":
        args["onsets_log"] = c["onsets_log"][
            :, :FSMP + NSAMPLES + d._max_shift - 1].contiguous()
    elif what == "built for fsmp":
        args["fsmp"] = FSMP + 1
    elif what == "float32 tensor":
        args["onsets_log"] = c["onsets_log"].double()
    elif what == "float32 layouts":
        # a float64 layout of a shape the f64 forms are not built for
        t = c["tables"]
        args["tables"] = type(t)(**{**vars(t), "layout": type(t.layout)(
            **{**vars(t.layout), "dtype": F64, "shape": (16, 16)})})
    elif what == "inconsistent shapes":
        args["base"] = d.base[:, :-1].contiguous()
    return args


@pytest.mark.parametrize("what", ["inside", "too short", "built for fsmp",
                                  "float32 tensor", "float32 layouts",
                                  "inconsistent shapes"])
def test_wrappers_check_their_arguments(what, monkeypatch):
    """Each check before the launch, reached with the device check passed;
    the map's wrapper shares the table and onset checks."""

    c = _case("k3")
    monkeypatch.setattr(cm, "_check_cuda", lambda device: None)
    monkeypatch.setattr(cm, "launch_kernel", lambda *a: pytest.fail(
        "launched past a failed check"))
    args = _bad(c, what)
    with pytest.raises(ValueError, match=what):
        cm.migrate_marginalise_ring_cuda(**args)
    if what != "inside":
        for key in ("window_start", "window_length"):
            args.pop(key)
        with pytest.raises(ValueError, match=what):
            cm.migrate_map_ring_cuda(**args)


@pytest.mark.parametrize("length, n_chunks", [
    (0, 1), (CHUNK, 1), (CHUNK + 1, 2), (2 * CHUNK + 1, 3)])
@pytest.mark.parametrize("geometry", ["k3", "k2_v2"])
def test_wrappers_hand_the_kernels_their_arguments(geometry, length,
                                                   n_chunks, monkeypatch):
    """The launches caught as if on the card: the C entries, every C
    argument but the stream, the chunk table where the window spans more
    than one chunk of CHUNK samples, the ring's layout and shape; the
    launches counted."""

    c = _case(geometry)
    d = c["detector"]
    seen = _caught(monkeypatch)
    out = d.marginalise(c["onsets_log"], c["inv"], 3, length)
    map_ = d.map(c["onsets_log"], c["inv"])
    assert out.shape == (d.n_nodes,) and out.dtype == torch.float32
    assert map_.shape == (d.n_nodes, NSAMPLES)
    (m1, m1_args), (m2, m2_args) = seen
    assert (m1, m2) == ("qm_migrate_marginalise_ring", "qm_migrate_map_ring")
    for name, args in seen:
        assert len(args) == len(_build.SIGNATURES[name]) - 1
    layout = c["tables"].layout
    split = -(-d.plan.n_onsets // layout.group) >= layout.n_stages
    assert split == cm.ring_split(layout, d.plan.n_onsets)
    n_tiles, tile = c["tables"].flat.shape
    assert m1_args[1] % 4 == 0 and m1_args[1] >= c["onsets_log"].shape[1]
    assert (m1_args[8] is None) == (n_chunks == 1)
    assert m1_args[9:] == (n_chunks, d.n_nodes, d.plan.n_onsets, n_tiles,
                           tile, FSMP, 3, length, layout.group,
                           layout.stage_floats, layout.n_stages,
                           *layout.shape, int(split))
    assert m2_args[8:] == (d.plan.n_onsets, n_tiles, tile, FSMP, NSAMPLES,
                           layout.group, layout.stage_floats,
                           layout.n_stages, *layout.shape, int(split))
    assert {k: n for k, n in cm.launches.items() if n} == {
        "migrate_marginalise_ring": 1, "migrate_map_ring": 1}


def test_ring_signature_entries():
    p, i = ctypes.c_void_p, ctypes.c_int
    assert _build.SIGNATURES["qm_migrate_marginalise_ring"] == (
        [p, i] + [p] * 7 + [i] * 14 + [p])
    assert _build.SIGNATURES["qm_migrate_map_ring"] == (
        [p, i] + [p] * 6 + [i] * 11 + [p])
    assert _build.SIGNATURES["qm_migrate_ring_blocks_per_sm"] == [i] * 7
    source = (_build.CSRC_DIR / "migrate_marginalise_ring.cu").read_text()
    for entry in ("qm_migrate_marginalise_ring", "qm_migrate_map_ring",
                  "qm_migrate_ring_blocks_per_sm"):
        assert f'extern "C" int {entry}(' in source
    for entry in ("qm_migrate_marginalise_ring", "qm_migrate_map_ring"):
        head = source[source.index(f'extern "C" int {entry}('):]
        assert "int npp, int split,\n    void* stream)" in head[:600]
    assert f"#define MR_CHUNK {CHUNK}" in source
    assert "#define MR_SHAPES(X) X(16, 8, 2) X(16, 16, 1)" in source
    assert cm.RING_SHAPES == {(16, 8): 2, (16, 16): 1}


@pytest.mark.parametrize("group", [1, 5, 12, 13, 24])
def test_ring_split_follows_the_ring(group):
    """The passes go on the grid where one pass of ceil(O / G) stages
    fills the ring's depth (always at one onset a stage), else each block
    takes its passes in turn (always at one stage a pass)."""

    spans = cm.DetectPlan(_traveltimes((8, 8, 4), 24, 30), (8, 8, 4)).r_spans
    layout = cm.global_v2_layout(spans, cm.GLOBAL_V2_SHAPE, group=group)
    split = cm.ring_split(layout, 24)
    assert split == (-(-24 // group) >= layout.n_stages)
    if group in (1, 24):
        assert split == (group == 1)


@pytest.mark.parametrize("length, slots", [
    (0, 1), (1, 1), (32, 1), (33, 2), (64, 2), (65, 4), (CHUNK, 4),
    (2038, 4)])
def test_ring_slots(length, slots):
    assert cm.ring_slots(length) == slots


@pytest.mark.parametrize("fsmp", [0, 1, 2, 3, 30])
def test_global_v2_tables_at_tile_512(fsmp):
    """The generalised tables at tile 512 (four passes of the (16, 8)
    shape): each entry is the window's offset plus (fsmp + base) & 3 plus
    the node's residual, in pass-major brick order; flat the plan's perm
    with -1 for padding; K3 v2 still refuses the tile, and its wrapper
    the table."""

    tt = _traveltimes((16, 16, 8), 20, 60)
    plan = cm.DetectPlan(tt, (16, 16, 8), tile=512, brick_shape=(8, 8, 8))
    layout = cm.global_v2_layout(plan.r_spans, cm.GLOBAL_V2_SHAPE)
    tables = cm.global_v2_tables(plan, fsmp, "cpu", layout)
    assert tables.res.shape == (plan.n_tiles, 4, 20, 128)
    assert tables.res.dtype == torch.uint16 and tables.fsmp == fsmp
    local = cm.ring_local(tables).numpy()
    lead = (fsmp + plan.base.astype(np.int64)) & 3
    np.testing.assert_array_equal(local, lead[:, :, None] + plan.fine)
    entry = tables.res.long().numpy()[:, 1, 7, 5]  # pass 1, onset 7, node 133
    np.testing.assert_array_equal(
        entry, layout.win[7, 0] + lead[:, 7] + plan.fine[:, 7, 133])
    flat = tables.flat.numpy()
    np.testing.assert_array_equal(
        flat, np.where(plan.valid > 0, plan.perm.reshape(plan.valid.shape),
                       -1))
    assert "tile 512 is not K3 v2's 256" in cm.global_v2_refusal(plan)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        cm.migrate_detect_global_v2_cuda(
            torch.zeros((20, 4 * 200)), torch.from_numpy(plan.base),
            torch.ones(1), fsmp, 100, tables, plan.max_shift)
    with pytest.raises(ValueError, match="nodes a pass"):
        cm.global_v2_tables(
            cm.DetectPlan(tt, (16, 16, 8), tile=64, brick_shape=(4, 4, 4)),
            fsmp, "cpu", layout)


def test_mesh_slab_keeps_flat_indices_global():
    """A slab of the K3 route's plan (as parallel.PlanSlab builds it):
    its detector's tables hold the slab's tiles with global flat indices,
    and the plain versions on the slab equal the whole plan's at the
    slab's nodes."""

    c = _case("k3")
    whole = c["detector"]
    slab_plan = whole.plan.slabs(2)[1]
    slab = cm.CudaDetectGlobal(None, None, FSMP, NSAMPLES, "cpu",
                               plan=slab_plan)
    assert slab.ring_refusal is None
    nodes = torch.from_numpy(slab_plan.nodes)
    flat = slab.ring_tables().flat
    assert torch.equal(torch.sort(flat[flat >= 0]).values.long(), nodes)
    got = cm.marginalise_ring_reference(
        c["onsets_log"], slab.base, c["inv"], FSMP, 7, 70, slab.n_nodes,
        slab.ring_tables())
    want = _ring_m1(c, 7, 70)
    assert torch.equal(got[nodes], torch.from_numpy(want)[nodes])
    got_map = cm.map_ring_reference(c["onsets_log"], slab.base, c["inv"],
                                    FSMP, NSAMPLES, slab.n_nodes,
                                    slab.ring_tables())
    want_map = cm.map_ring_reference(c["onsets_log"], whole.base, c["inv"],
                                     FSMP, NSAMPLES, whole.n_nodes,
                                     c["tables"])
    assert torch.equal(got_map[nodes], want_map[nodes])
