# -*- coding: utf-8 -*-
"""
M1 ring f64 and M2 ring f64 of quakemigrate_torch
(``csrc/migrate_marginalise_ring.cu`` on double: locate's pass 2 and map
under ``QuakeScan(precision="double")``, on K3 v2 f64's tables, the
redesign of M1 f64 and M2 simple f64) on the CPU, with JAX's x64 on
(tests/conftest.py):

- their plain versions, ``marginalise_ring_reference`` and
  ``map_ring_reference`` on float64 tables (2-double units, chunks of
  128), against the JAX ``migrate_marginalise`` and ``migrate_map`` in
  float64 within 1e-12 of the maximum, on an Icequake-like plan (25 m,
  250 Hz, 26 onsets in one stage) and an F3-like plan (K3's route, spans
  of ~1,200 samples), at windows of one sample to three chunks and starts
  of every residue mod 4;
- a numpy emulation of the f64 staging (each window copied from its
  16-byte column, ((fsmp + base) & ~1) + (d & ~1), cut to the doubles its
  block needs, the rest of the stage NaN): it reads no double outside
  the copy, writes every real node once and padding never, and at a
  window of one chunk equals a numpy emulation of M1 f64 bit for bit
  (within 1e-12 beyond); 128 is the largest even chunk K3 v2 f64's
  windows hold;
- the routing: M1 ring f64 and M2 ring f64 on K3 v2 f64's plans (its own
  tables, a ring no deeper than the stages a block loads), M1 f64 and M2
  simple f64 on
  the 15,000-span toy with K3 v2 f64's refusal words;
- the wrappers: their checks (mixed types, a float64 layout of a shape
  the f64 forms are not built for, another tile, float32 tables), the CPU
  refusal, the
  arguments they hand the f64 C entries, those entries' signatures and
  constants against the source, and a float64 mesh slab's tables, which
  keep flat indices global.

The kernels run only on the card, where chip_smoke.py holds them to these
plain versions, to M1 f64 and M2 simple f64 and to K3 v2 f64's tmax.

"""

import ctypes

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops.migrate import migrate_map as j_migrate_map
from quakemigrate_tpu.ops.migrate import (
    migrate_marginalise as j_migrate_marginalise,
)
from quakemigrate_torch import _build
from quakemigrate_torch.ops import cuda_migrate as cm
from quakemigrate_torch.signal.scan import locate_kernels
from quakemigrate_torch.util import round_up

from test_torch_scan_route import _regional_traveltimes

torch.set_num_threads(1)

F64 = torch.float64
RTOL_OF_MAX = 1e-12
# The numpy emulation (numpy's exp) against the torch plain version
# (torch's exp), and M1 ring f64 against M1 f64 beyond one chunk (the
# chunks of 128 against 256 group the sums otherwise)
EXP_RTOL = 1e-14
M1_RTOL = 1e-12
CHUNK = cm.RING_CHUNK_F64
M1_CHUNK = cm.M1_CHUNK
FSMP, NSAMPLES = 30, 300
WINDOWS = [(0, 25), (30, 31), (NSAMPLES - 17, 17), (44, 1), (7, 70),
           (37, 2 * CHUNK + 1)]
# Starts of every residue mod 4, at one chunk and at two
RESIDUES = [(100 + r, 60) for r in range(4)] + [(101 + r, 130)
                                                for r in range(4)]
# A residual span past K3 v2 f64's ring of doubles (float32's takes it)
WIDE_SPAN = 15_000


def _geometry(name):
    """(traveltimes, node_count): an Icequake-like plan (13 stations at
    25 m and 250 Hz: 26 onsets of short spans, one stage a pass) or an
    F3-like one (6 stations at 4 km and 100 Hz: spans of ~1,200
    samples)."""

    if name == "icequake":
        return (_regional_traveltimes(node_count=(16, 16, 8),
                                      spacing_km=0.025, rate=250,
                                      n_stations=13), (16, 16, 8))
    return (_regional_traveltimes(node_count=(16, 16, 8), spacing_km=4.0,
                                  n_stations=6), (16, 16, 8))


_CASES = {}


def _case(name):
    """Seeded float64 onsets (one dead row), CudaDetectGlobal in float64
    on the CPU, its prepared onsets and the ring's tables (K3 v2 f64's)."""

    if name not in _CASES:
        tt, nc = _geometry(name)
        rng = np.random.default_rng(2301 if name == "icequake" else 2302)
        n_onsets = tt.shape[1]
        onsets = rng.uniform(0.2, 6.0, size=(
            n_onsets, FSMP + NSAMPLES + int(tt.max()) + 5))
        mask = np.ones(n_onsets)
        mask[3] = 0.0
        detector = cm.CudaDetectGlobal(tt, nc, FSMP, NSAMPLES, "cpu",
                                       dtype=F64)
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


@pytest.mark.parametrize("geometry", ["icequake", "f3"])
def test_ring_f64_runs_on_k3_v2_f64_tables(geometry):
    """CudaDetectGlobal in float64 takes the ring on K3 v2 f64's own
    tables: one shape, (16, 8); the ring no deeper than the stages a
    block loads (two passes of ceil(O / G)), without K3 v2 f64's fold
    scratch; locate's words name the f64 ring."""

    c = _case(geometry)
    d = c["detector"]
    assert d.v2_refusal is None and d.ring_refusal is None
    assert cm.ring_refusal(d.plan, F64) is None
    tables = d.ring_tables()
    assert tables is d.tables is c["tables"]
    layout = tables.layout
    assert layout.dtype == F64 and layout.shape in cm.RING_SHAPES_F64
    assert cm.ring_shapes(F64) == cm.RING_SHAPES_F64
    loads = 2 * -(-d.plan.n_onsets // layout.group)
    assert cm.ring_stages(layout) == min(layout.n_stages, max(2, loads))
    stage = round_up(8 * layout.stage_floats + 2 * layout.group * 128, 128)
    depth = cm.ring_stages(layout)
    assert cm.ring_smem(layout) == depth * stage + 16 * depth
    assert cm.ring_smem(layout) < layout.smem
    # Icequake-like: every onset in one stage of short windows, so two
    # blocks fit an SM; F3-like: K3 v2 f64 has 2 stages already
    two_blocks = cm.ring_smem(layout) <= (cm.SMEM_PER_SM // 2
                                          - cm.SMEM_BLOCK_RESERVE)
    assert two_blocks == (geometry == "icequake")
    assert locate_kernels(d.plan, F64) == ("locate on M1 ring f64 and M2 "
                                           "ring f64")


def test_icequake_like_plan_holds_every_onset_in_one_stage():
    """As at the Icequake grid (G 26): every onset in one stage, so a
    block's two passes are two stage iterations and the passes stay in
    the block (ring_split)."""

    c = _case("icequake")
    layout = c["tables"].layout
    assert c["detector"].plan.n_onsets == 26 == layout.group
    assert cm.ring_stages(layout) == 2 < layout.n_stages
    assert not cm.ring_split(layout, 26)


@pytest.mark.parametrize("group", [1, 2, 5, 13, 26])
def test_ring_f64_depth_follows_the_stages_a_block_loads(group):
    """At G onsets a stage a block of two passes loads 2 ceil(O / G)
    stages: the f64 ring is that deep, at least 2 and at most the
    layout's depth; the passes go on the grid where one pass alone fills
    it (ring_split). The float32 ring keeps the layout's depth."""

    plan = _case("icequake")["detector"].plan
    layout = cm.global_v2_layout(plan.r_spans, (16, 8), group=group,
                                 dtype=F64)
    loads = 2 * -(-26 // group)
    depth = cm.ring_stages(layout)
    assert depth == min(layout.n_stages, max(2, loads))
    assert cm.ring_split(layout, 26) == (-(-26 // group) >= depth)
    assert cm.ring_smem(layout) == depth * round_up(
        8 * layout.stage_floats + 2 * group * 128, 128) + 16 * depth
    f32 = cm.global_v2_layout(plan.r_spans, (16, 8), group=group)
    assert cm.ring_stages(f32) == f32.n_stages


@pytest.mark.parametrize("start, length", WINDOWS + RESIDUES)
@pytest.mark.parametrize("geometry", ["icequake", "f3"])
def test_marginalise_ring_f64_reference_equals_jax(geometry, start, length):
    c = _case(geometry)
    got = _ring_m1(c, start, length)
    want = np.asarray(j_migrate_marginalise(
        c["onsets"], c["tt"], c["mask"], c["available"], FSMP, NSAMPLES,
        start, length, tile=128))
    assert got.dtype == np.float64 and want.dtype == np.float64
    assert got.shape == want.shape == (c["tt"].shape[0],)
    assert np.abs(got - want).max() <= RTOL_OF_MAX * np.abs(want).max()


@pytest.mark.parametrize("geometry", ["icequake", "f3"])
def test_map_ring_f64_reference_equals_jax(geometry):
    c = _case(geometry)
    d = c["detector"]
    got = cm.map_ring_reference(c["onsets_log"], d.base, c["inv"], FSMP,
                                NSAMPLES, d.n_nodes, c["tables"]).numpy()
    want = np.asarray(j_migrate_map(
        c["onsets"], c["tt"], c["mask"], c["available"], FSMP, NSAMPLES,
        tile=128))
    assert got.dtype == np.float64
    assert got.shape == want.shape == (c["tt"].shape[0], NSAMPLES)
    assert np.abs(got - want).max() <= RTOL_OF_MAX * np.abs(want).max()


def _emulate_ring_m1_f64(logged, inv, fsmp, base, tables, start, length,
                         n_nodes):
    """M1 ring f64 in numpy float64, block by block: each onset's window
    copied as the kernel copies it (from ((fsmp + base) & ~1) + (d & ~1),
    cut to width - need doubles, need = 128 - round_up(cw, 2), and at the
    row's end) into a buffer that is NaN beyond the copy; every node's
    samples read at its entry less the window's offset plus d & 1; the
    onsets added in order, exp of the sum times inv, the lane's samples
    in k order, the xor tree, the chunks in chunk order. Returns (out,
    writes per flat node, whether any read of a used sample fell outside
    the copy)."""

    res = tables.res.long().numpy()
    win = tables.win.numpy().astype(np.int64)
    flat = tables.flat.numpy()
    base = np.asarray(base, np.int64)
    n_tiles, passes, n_onsets, slice_ = res.shape
    tile = passes * slice_
    t_len = logged.shape[1]
    ld = round_up(t_len, 4)  # row_pitch's pitch
    rows = np.zeros((n_onsets, ld))
    rows[:, :t_len] = logged
    n_chunks = max(1, -(-length // CHUNK))
    slots = cm.ring_slots(length)
    partial = np.zeros((n_chunks, n_nodes))
    writes = np.zeros(n_nodes, int)
    outside = False
    lane_t = np.arange(32 * slots)
    for i in range(n_tiles):
        entries = res[i].transpose(1, 0, 2).reshape(n_onsets, tile)
        real = flat[i] >= 0
        for c in range(n_chunks):
            d = start + c * CHUNK
            cw = min(CHUNK, length - c * CHUNK)
            need = max(0, 128 - round_up(cw, 2))
            acc = np.zeros((tile, 32 * slots))
            for o in range(n_onsets):
                col = ((fsmp + base[i, o]) & ~1) + (d & ~1)
                copy = min(win[o, 1] - need, ld - col)
                buf = np.full(win[o, 1] + 128, np.nan)
                buf[:copy] = rows[o, col:col + copy]
                idx = (entries[o] - win[o, 0] + (d & 1))[:, None] + lane_t
                acc += buf[idx]
            used = acc[:, :cw]
            outside |= bool(np.isnan(used).any())
            coa = np.exp(used * inv)
            lanes = np.zeros((tile, 32))
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


def _emulate_m1_f64(logged, inv, plan, fsmp, start, length):
    """M1 f64's arithmetic in numpy float64 on the plan (chunks of
    M1_CHUNK samples, lanes j + 32 k added in k order, the xor tree, the
    chunks in order): out[perm[n]] for each real node n."""

    n_tiles, n_onsets, tile = plan.fine.shape
    n_chunks = max(1, -(-length // M1_CHUNK))
    partial = np.zeros((n_chunks, plan.n_nodes))
    t = np.arange(length)
    for i in range(n_tiles):
        real = np.flatnonzero(plan.valid[i])
        acc = np.zeros((real.size, length))
        for o in range(n_onsets):
            cols = (fsmp + start + plan.base[i, o]
                    + plan.fine[i, o, real][:, None] + t)
            acc += logged[o][cols]
        coa = np.exp(acc * inv)
        flat = plan.perm[i * tile + real]
        for c in range(n_chunks):
            lanes = np.zeros((real.size, 32))
            for s in range(c * M1_CHUNK, min((c + 1) * M1_CHUNK, length)):
                lanes[:, s % 32] += coa[:, s]
            for x in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[:, np.arange(32) ^ x]
            partial[c, flat] = lanes[:, 0]
    out = partial[0].copy()
    for c in range(1, n_chunks):
        out += partial[c]
    return out


def _emulate(c, start, length):
    d = c["detector"]
    return _emulate_ring_m1_f64(
        c["onsets_log"].numpy(), c["inv"].item(), FSMP, d.plan.base,
        c["tables"], start, length, d.n_nodes)


@pytest.mark.parametrize("start, length", WINDOWS + RESIDUES)
@pytest.mark.parametrize("geometry", ["icequake", "f3"])
def test_ring_f64_emulation_stays_in_stage(geometry, start, length):
    """No sample the window needs is read from outside the copied part of
    its staged window of doubles, at any start residue; every real node
    is written once and padding never; the emulation agrees with the
    plain version."""

    c = _case(geometry)
    got, writes, outside = _emulate(c, start, length)
    assert not outside
    assert (writes == 1).all()  # every flat node is real here
    want = _ring_m1(c, start, length)
    assert np.abs(got - want).max() <= EXP_RTOL * np.abs(want).max()


def test_padding_never_written():
    """A grid whose bricks overhang it: padding nodes (flat -1) are never
    written, each real node once."""

    tt = _regional_traveltimes(node_count=(9, 8, 7), spacing_km=1.0,
                               n_stations=4)
    detector = cm.CudaDetectGlobal(tt, (9, 8, 7), FSMP, 64, "cpu",
                                   dtype=F64)
    plan = detector.plan
    assert (plan.valid == 0).any()
    tables = detector.ring_tables()
    flat = tables.flat.numpy()
    assert (flat[plan.valid == 0] == -1).all()
    rng = np.random.default_rng(2303)
    logged = np.log(rng.uniform(0.5, 3.0, size=(
        plan.n_onsets, FSMP + 64 + plan.max_shift + 3)))
    _, writes, outside = _emulate_ring_m1_f64(
        logged, 0.125, FSMP, plan.base, tables, 5, 40, plan.n_nodes)
    assert not outside and (writes == 1).all()


@pytest.mark.parametrize("start, length", [
    (0, 25), (30, 31), (NSAMPLES - 17, 17), (44, 1), (7, 70), (1, 33),
    (2, 64), (3, 65), (0, 0)] + [(150 + r, CHUNK - r) for r in range(4)])
@pytest.mark.parametrize("geometry", ["icequake", "f3"])
def test_one_chunk_equals_m1_f64_emulation_bit_for_bit(geometry, start,
                                                       length):
    """At a window of one chunk (128 samples or fewer) M1 ring f64's
    arithmetic is M1 f64's: the emulations are equal bit for bit, at
    every start residue mod 4."""

    c = _case(geometry)
    got, _, outside = _emulate(c, start, length)
    want = _emulate_m1_f64(c["onsets_log"].numpy(), c["inv"].item(),
                           c["detector"].plan, FSMP, start, length)
    assert not outside
    assert np.array_equal(got, want)


@pytest.mark.parametrize("start, length", [
    (0, NSAMPLES), (37, 2 * CHUNK + 1), (101, CHUNK + 1), (2, M1_CHUNK)])
def test_chunks_within_m1_rtol_of_m1_f64_emulation(start, length):
    """Beyond one chunk M1 ring f64's chunks (128 samples) group the sums
    otherwise than M1 f64's (256): within 1e-12 of M1 f64's emulation
    per node."""

    c = _case("f3")
    got, _, outside = _emulate(c, start, length)
    want = _emulate_m1_f64(c["onsets_log"].numpy(), c["inv"].item(),
                           c["detector"].plan, FSMP, start, length)
    assert not outside
    assert (np.abs(got - want) / np.abs(want)).max() <= M1_RTOL


def test_chunk_128_is_the_largest_even_chunk_the_windows_hold():
    """A read's offset in K3 v2 f64's window is at most lead (1) + d & 1
    (1) + residual (r - 1) + sample (chunk - 1) = r + chunk, and the
    window holds round_up(r + 129, 2) doubles: 128 fits every span, 130
    does not."""

    spans = np.arange(0, 3000)
    widths = cm.global_v2_widths(spans, F64)

    def fits(chunk):
        return bool((1 + 1 + np.maximum(spans - 1, 0) + chunk - 1
                     <= widths - 1).all())

    assert cm.ring_chunk(F64) == CHUNK == 128
    assert fits(128) and not fits(130)
    assert cm.ring_chunk(torch.float32) == cm.RING_CHUNK == 124


def _wide_toy():
    tt = np.zeros((64, 2), np.int32)
    tt[1, 1] = WIDE_SPAN - 1
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


def test_wide_span_toy_keeps_m1_f64_and_m2_simple_f64(monkeypatch):
    """A residual span the ring of doubles cannot hold (float32's ring
    takes it): the detector keeps K3 v2 f64's words, and pass 2 and the
    map launch M1 f64 and M2 simple f64, nothing else."""

    tt, nc = _wide_toy()
    detector = cm.CudaDetectGlobal(tt, nc, 0, 8, "cpu", dtype=F64)
    assert detector.tables is None and detector.ring_tables() is None
    assert detector.ring_refusal == cm.global_v2_refusal(detector.plan, F64)
    assert "doubles" in detector.ring_refusal
    assert cm.ring_refusal(detector.plan) is None
    assert locate_kernels(detector.plan, F64).startswith(
        "locate on M1 f64 and M2 simple f64 (K3 v2's ring of 2 stages")
    rng = np.random.default_rng(2304)
    onsets = torch.from_numpy(rng.uniform(0.5, 3.0, size=(
        2, 8 + detector.plan.max_shift)))
    onsets_log, inv = detector.prepare(onsets, torch.ones(2, dtype=F64),
                                       2.0)
    seen = _caught(monkeypatch)
    detector.marginalise(onsets_log, inv, 2, 5)
    detector.map(onsets_log, inv)
    assert [name for name, _ in seen] == ["qm_migrate_marginalise_f64",
                                          "qm_migrate_map_f64"]
    assert {k: n for k, n in cm.launches.items() if n} == {
        "migrate_marginalise_f64": 1, "migrate_map_f64": 1}


@pytest.mark.parametrize("geometry", ["icequake", "f3"])
def test_wrappers_raise_on_cpu_tensors(geometry):
    c = _case(geometry)
    d = c["detector"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        d.marginalise(c["onsets_log"], c["inv"], 0, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        d.map(c["onsets_log"], c["inv"])


def _bad(c, what):
    """Arguments of migrate_marginalise_ring_cuda on float64 tables with
    one thing wrong, and the words of the error."""

    d = c["detector"]
    args = dict(onsets_log=c["onsets_log"], base=d.base,
                inv_available=c["inv"], fsmp=FSMP, nsamples=NSAMPLES,
                window_start=0, window_length=10, n_nodes=d.n_nodes,
                tables=c["tables"], max_shift=d._max_shift)
    if what == "float32 onsets":
        args["onsets_log"] = c["onsets_log"].float()
        return args, "onsets_log must be a contiguous torch.float64"
    if what == "float32 inv_available":
        args["inv_available"] = c["inv"].float()
        return args, "inv_available must be a contiguous torch.float64"
    if what == "wide shape":
        t = c["tables"]
        args["tables"] = type(t)(**{**vars(t), "layout": type(t.layout)(
            **{**vars(t.layout), "shape": (16, 16)})})
        return args, "float64 layouts of"
    t = c["tables"]
    if what == "tile 128":
        # one pass of 128 nodes a tile: consistent, but not K3 v2 f64's
        args["tables"] = type(t)(**{**vars(t),
                                    "res": t.res[:, :1].contiguous(),
                                    "flat": t.flat[:, :128].contiguous()})
        return args, "tiles of 256 nodes, not 128"
    # float64 onsets on float32 tables of the same layout
    args["tables"] = type(t)(**{**vars(t), "layout": type(t.layout)(
        **{**vars(t.layout), "dtype": torch.float32})})
    return args, "onsets_log must be a contiguous torch.float32"


@pytest.mark.parametrize("what", ["float32 onsets", "float32 inv_available",
                                  "wide shape", "tile 128",
                                  "float32 tables"])
def test_f64_wrappers_check_their_arguments(what, monkeypatch):
    """Mixed types, a float64 layout of a shape the f64 forms are not
    built for and float64 tables of another tile than K3 v2 f64's are
    refused before the launch, by both wrappers."""

    c = _case("f3")
    monkeypatch.setattr(cm, "_check_cuda", lambda device: None)
    monkeypatch.setattr(cm, "launch_kernel", lambda *a: pytest.fail(
        "launched past a failed check"))
    args, words = _bad(c, what)
    with pytest.raises(ValueError, match=words):
        cm.migrate_marginalise_ring_cuda(**args)
    for key in ("window_start", "window_length"):
        args.pop(key)
    with pytest.raises(ValueError, match=words):
        cm.migrate_map_ring_cuda(**args)


@pytest.mark.parametrize("length, n_chunks", [
    (0, 1), (CHUNK, 1), (CHUNK + 1, 2), (2 * CHUNK + 1, 3)])
@pytest.mark.parametrize("geometry", ["icequake", "f3"])
def test_wrappers_hand_the_f64_kernels_their_arguments(geometry, length,
                                                       n_chunks,
                                                       monkeypatch):
    """The launches caught as if on the card: the f64 C entries, every C
    argument but the stream, the chunk table where the window spans more
    than one chunk of 128 samples, the ring's layout at its f64 depth and
    shape; float64 outputs; the f64 launches counted."""

    c = _case(geometry)
    d = c["detector"]
    seen = _caught(monkeypatch)
    out = d.marginalise(c["onsets_log"], c["inv"], 3, length)
    map_ = d.map(c["onsets_log"], c["inv"])
    assert out.shape == (d.n_nodes,) and out.dtype == F64
    assert map_.shape == (d.n_nodes, NSAMPLES) and map_.dtype == F64
    (m1, m1_args), (m2, m2_args) = seen
    assert (m1, m2) == ("qm_migrate_marginalise_ring_f64",
                        "qm_migrate_map_ring_f64")
    for name, args in seen:
        assert len(args) == len(_build.SIGNATURES[name]) - 1
    layout = c["tables"].layout
    depth = cm.ring_stages(layout)
    split = -(-d.plan.n_onsets // layout.group) >= depth
    assert split == cm.ring_split(layout, d.plan.n_onsets)
    n_tiles, tile = c["tables"].flat.shape
    assert m1_args[1] % 2 == 0 and m1_args[1] >= c["onsets_log"].shape[1]
    assert (m1_args[8] is None) == (n_chunks == 1)
    assert m1_args[9:] == (n_chunks, d.n_nodes, d.plan.n_onsets, n_tiles,
                           tile, FSMP, 3, length, layout.group,
                           layout.stage_floats, depth, *layout.shape,
                           int(split))
    assert m2_args[8:] == (d.plan.n_onsets, n_tiles, tile, FSMP, NSAMPLES,
                           layout.group, layout.stage_floats, depth,
                           *layout.shape, int(split))
    assert {k: n for k, n in cm.launches.items() if n} == {
        "migrate_marginalise_ring_f64": 1, "migrate_map_ring_f64": 1}


def test_ring_f64_signature_entries():
    """The f64 C entries take the float entries' arguments; their
    constants match the source's."""

    p, i = ctypes.c_void_p, ctypes.c_int
    assert _build.SIGNATURES["qm_migrate_marginalise_ring_f64"] == (
        [p, i] + [p] * 7 + [i] * 14 + [p])
    assert _build.SIGNATURES["qm_migrate_map_ring_f64"] == (
        [p, i] + [p] * 6 + [i] * 11 + [p])
    assert _build.SIGNATURES["qm_migrate_ring_f64_blocks_per_sm"] == [i] * 7
    source = (_build.CSRC_DIR / "migrate_marginalise_ring.cu").read_text()
    for entry in ("qm_migrate_marginalise_ring_f64",
                  "qm_migrate_map_ring_f64",
                  "qm_migrate_ring_f64_blocks_per_sm"):
        assert f'extern "C" int {entry}(' in source
    assert f"#define MR_CHUNK_F64 {CHUNK}" in source
    assert "#define MR_SHAPES_F64(X) X(16, 8, 2)" in source
    assert cm.RING_SHAPES_F64 == {(16, 8): 2}
    assert set(cm.RING_SHAPES_F64) == set(cm.GLOBAL_V2_SHAPES_F64)


def test_mesh_slab_keeps_flat_indices_global():
    """A float64 slab of the F3-like plan (as parallel.PlanSlab builds
    it): its detector's K3 v2 f64 tables hold the slab's tiles with global
    flat indices, and the plain versions on the slab equal the whole
    plan's at the slab's nodes."""

    c = _case("f3")
    whole = c["detector"]
    slab_plan = whole.plan.slabs(2)[1]
    slab = cm.CudaDetectGlobal(None, None, FSMP, NSAMPLES, "cpu",
                               plan=slab_plan, dtype=F64)
    assert slab.ring_refusal is None
    tables = slab.ring_tables()
    assert tables.layout.dtype == F64
    nodes = torch.from_numpy(slab_plan.nodes)
    flat = tables.flat
    assert torch.equal(torch.sort(flat[flat >= 0]).values.long(), nodes)
    got = cm.marginalise_ring_reference(
        c["onsets_log"], slab.base, c["inv"], FSMP, 7, 70, slab.n_nodes,
        tables)
    want = _ring_m1(c, 7, 70)
    assert got.dtype == F64
    assert torch.equal(got[nodes], torch.from_numpy(want)[nodes])
    got_map = cm.map_ring_reference(c["onsets_log"], slab.base, c["inv"],
                                    FSMP, NSAMPLES, slab.n_nodes, tables)
    want_map = cm.map_ring_reference(c["onsets_log"], whole.base, c["inv"],
                                     FSMP, NSAMPLES, whole.n_nodes,
                                     c["tables"])
    assert torch.equal(got_map[nodes], want_map[nodes])
