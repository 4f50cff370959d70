# -*- coding: utf-8 -*-
"""
K3 v3 f64 of quakemigrate_torch (``csrc/migrate_detect_global_v3.cu``,
``precision="double"``'s detect kernel: K3 v2 f64's function on its
tables, redesigned as a persistent ring that stages each item once) on
the CPU, where no kernel runs:

- a numpy float64 emulation of the kernel through ``global_v2_tables``
  (its work items, the stages filled window by window from their 16-byte
  aligned columns with NaN past each copy, one stage an item where the
  layout's group holds every onset or G windows and one pass a stage,
  the rounds of 4 or 8 nodes a warp in pass order, each warp's running
  fold of its rounds and the warps folded in order) against JAX's float64
  ``migrate_detect`` on an Icequake-like plan (one stage an item) and an
  F3-like plan (the streamed form) with planted ties: max and max_coa_n
  within 1e-12, the argmax equal where the maximum is unique, and at the
  planted sample the smallest of the tied flat indices, across tiles
  and within one; its per-tile max and argmax bit for bit K3 v2 f64's
  emulation's, its sums within 1e-12;
- the ring on the host (``global_v3_layout``): the form and depth at
  the test plans, Icequake, F3 and 256 onsets, a ring wherever K3 v2 f64
  takes the plan, the block's bytes, and the shapes and forms (nodes a
  warp a round, the onset loop's unrolling) against the source;
- the wrapper with the launch caught: its C entry, arguments and launch
  count, its refusals (float32 tables, mixed types, CPU tensors, tables
  built for another ``fsmp``), and the route: ``CudaDetectGlobal`` in
  float64 (``QuakeScan(precision="double")``'s detector and the routed
  ``ops``' one) launching K3 v3 f64 where one stage holds an item and
  K3 v2 f64 on a layout of several groups, each the other's yardstick;
- experiments/exp_double.py's detect bound and gather floor on the CPU,
  and its refusal without a card; sass_loops' comparison of two
  checkouts' machine code, kernel by kernel.

The kernel runs on the card in chip_smoke.py's double_path and in
experiments/exp_double.py, held there to the plain float64 version and
to K3 v2 f64.

"""

import functools
import logging
import os
import pathlib
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops import migrate as j_migrate
from quakemigrate_torch import _build
from quakemigrate_torch.experiments import exp_double
from quakemigrate_torch.lut import traveltime_table
from quakemigrate_torch.ops import cuda_migrate as cm
from quakemigrate_torch.ops import routed
from quakemigrate_torch.signal.scan import detect_route

from test_torch_global_v2 import (
    F3_LIKE_NODES, TIE_A, TIE_B, TIE_C, TIE_T0, _f3_like_case, _flat,
    _geometry_spans, _k3_v2_emulation)

torch.set_num_threads(1)

RTOL = 1e-12
UNIQUE = 1e-10
CUDA = torch.device("cuda")  # a device type; nothing here touches a card
F64 = torch.float64
ICEQUAKE_LIKE_NODES = (24, 20, 16)


@functools.lru_cache(maxsize=None)
def _icequake_like_case(ties):
    """An Icequake-like window (25 m nodes, 12 surface stations x P/S at
    250 Hz, 24 onsets) small enough for the emulation, with a source
    planted at node A and sample TIE_T0 and A's traveltime row copied to
    B and C ("across") or to C only ("within"), as the F3-like case of
    test_torch_global_v2 plants them: float64 onsets, mask (8 live
    onsets), the plan. One stage holds the item."""

    rng = np.random.default_rng(29)
    axes = [np.arange(n) * 0.025 for n in ICEQUAKE_LIKE_NODES]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    stations = rng.uniform([0, 0], [axes[0][-1], axes[1][-1]], size=(12, 2))
    dist = [np.sqrt((x - sx) ** 2 + (y - sy) ** 2 + z**2)
            for sx, sy in stations]
    tt = np.ascontiguousarray(traveltime_table(
        [d / v for v in (3.63, 1.833) for d in dist], 250), np.int32)
    a = _flat(TIE_A, ICEQUAKE_LIKE_NODES)
    copies = [TIE_B, TIE_C] if ties == "across" else [TIE_C]
    for ijk in copies:
        tt[_flat(ijk, ICEQUAKE_LIKE_NODES)] = tt[a]
    fsmp, nsamples = 9, 150
    t_len = fsmp + nsamples + int(tt.max()) + 5
    n_onsets = tt.shape[1]
    onsets = rng.gamma(2.0, 1.5, size=(n_onsets, t_len))
    mask = np.zeros(n_onsets)
    mask[rng.choice(n_onsets, 8, replace=False)] = 1.0
    for o in range(n_onsets):
        onsets[o, fsmp + tt[a, o] + TIE_T0] += 60.0
    return SimpleNamespace(tt=tt, onsets=onsets, mask=mask, available=8.0,
                           fsmp=fsmp, nsamples=nsamples,
                           plan=cm.DetectPlan(tt, ICEQUAKE_LIKE_NODES),
                           nodes=ICEQUAKE_LIKE_NODES)


def _case(name, ties):
    """The Icequake-like or the F3-like case in float64."""

    if name == "icequake":
        return _icequake_like_case(ties)
    c = _f3_like_case(ties)
    return SimpleNamespace(tt=c.tt, onsets=c.onsets.astype(np.float64),
                           mask=c.mask.astype(np.float64),
                           available=float(c.available), fsmp=c.fsmp,
                           nsamples=c.nsamples, plan=c.plan,
                           nodes=F3_LIKE_NODES)


def _tables(case):
    plan = case.plan
    layout = cm.global_v2_layout(plan.r_spans, (16, 8), dtype=F64)
    return cm.global_v2_tables(plan, case.fsmp, "cpu", layout)


def _logged(case):
    return np.log(np.clip(case.onsets, 0.01, None)) * case.mask[:, None]


def _k3_v3_f64_emulation(logged, plan, tables, inv, fsmp, nsamples):
    """K3 v3 f64 in numpy float64 through K3 v2 f64's tables, item by
    item (tile, 128 samples): its stages (every window of the item in one
    where the ring takes one stage an item, else one group of G windows a
    stage, each round streaming the groups again), each window from its
    16-byte aligned column (2 doubles), cut at the row's end, the rest of
    the stage NaN; the rounds of 16 warps x NPP nodes in pass order, a
    node's window gathered at its residual entry in onset order; each
    warp's running fold over its rounds (the larger value, or on equal
    values the smaller flat index; padding left out; sums in round and
    node order), then the 16 warps folded in order. Returns (tmax, targ,
    tsum), each [n_tiles, nsamples], targ flat indices."""

    lay = tables.layout
    ring = cm.global_v3_layout(lay)
    npp, single = ring.npp, ring.stage_passes == 2
    warps = cm.GLOBAL_V3_WARPS
    res = tables.res.numpy().astype(np.int64)
    flat = tables.flat.numpy()
    win = tables.win.numpy()
    n_onsets, t_len = logged.shape
    ld = -(-t_len // 4) * 4
    rows = np.zeros((n_onsets, ld))
    rows[:, :t_len] = logged
    n_round = warps * npp
    per_pass = res.shape[3] // n_round
    groups = [range(o0, min(o0 + lay.group, n_onsets))
              for o0 in range(0, n_onsets, lay.group)]
    lanes = np.arange(128)
    big = np.iinfo(np.int32).max
    shape = (plan.n_tiles, nsamples)
    tmax, targ, tsum = np.zeros(shape), np.zeros(shape, np.int64), \
        np.zeros(shape)

    def stage(i, s0, onsets):
        st = np.full(lay.stage_floats, np.nan)
        for o in onsets:
            col = (fsmp + int(plan.base[i, o]) + s0) & ~1
            n = min(int(win[o, 1]), ld - col)
            st[win[o, 0]:win[o, 0] + n] = rows[o, col:col + n]
        return st

    for i in range(plan.n_tiles):
        for s0 in range(0, nsamples, 128):
            item = stage(i, s0, range(n_onsets)) if single else None
            best = np.full((warps, 128), -np.inf)
            arg = np.full((warps, 128), big, np.int64)
            total = np.zeros((warps, 128))
            for r in range(res.shape[1] * per_pass):
                p, q0 = divmod(r, per_pass)
                q0 *= n_round
                acc = np.zeros((n_round, 128))
                for grp in ([range(n_onsets)] if single else groups):
                    st = item if single else stage(i, s0, grp)
                    for o in grp:
                        acc = acc + st[res[i, p, o, q0:q0 + n_round][:, None]
                                       + lanes]
                coa = np.exp(acc * inv)
                nodes = flat[i, p * res.shape[3] + q0:][:n_round]
                for q in range(n_round):
                    if nodes[q] < 0:
                        continue
                    w = q // npp
                    better = (coa[q] > best[w]) | (
                        (coa[q] == best[w]) & (nodes[q] < arg[w]))
                    best[w] = np.where(better, coa[q], best[w])
                    arg[w] = np.where(better, nodes[q], arg[w])
                    total[w] = total[w] + coa[q]
            m, a, sums = best[0], arg[0], total[0]
            for v in range(1, warps):
                take = (best[v] > m) | ((best[v] == m) & (arg[v] < a))
                m = np.where(take, best[v], m)
                a = np.where(take, arg[v], a)
                sums = sums + total[v]
            k = min(128, nsamples - s0)
            tmax[i, s0:s0 + k] = m[:k]
            targ[i, s0:s0 + k] = a[:k]
            tsum[i, s0:s0 + k] = sums[:k]
    return tmax, targ, tsum


@functools.lru_cache(maxsize=None)
def _emulated(name, ties):
    case = _case(name, ties)
    tables = _tables(case)
    inv = 1.0 / case.available
    logged = _logged(case)
    v3 = _k3_v3_f64_emulation(logged, case.plan, tables, inv, case.fsmp,
                              case.nsamples)
    v2 = _k3_v2_emulation(logged, case.plan, tables, inv, case.fsmp,
                          case.nsamples)
    return case, tables, v3, v2


def _unique(coa):
    top = np.sort(coa, axis=0)[-2:]
    return top[0] < top[1] * (1 - UNIQUE)


@pytest.mark.parametrize("ties", ["across", "within"])
@pytest.mark.parametrize("name", ["icequake", "f3"])
def test_k3_v3_f64_emulation_matches_jax(name, ties):
    """The emulation, combined over the brick tiles, against JAX's
    float64 migrate_detect: max_coa and max_coa_n within 1e-12, the
    argmax equal where the maximum is unique, at the planted sample the
    smallest of the tied flat indices, and in A's tile the smaller of A
    and C."""

    case, tables, (tmax, targ, tsum), _ = _emulated(name, ties)
    form = cm.global_v3_layout(tables.layout).stage_passes
    assert form == (2 if name == "icequake" else 1)
    max_coa, max_idx, coa_sum = (x.numpy() for x in cm.combine_brick_tiles(
        torch.from_numpy(tmax), torch.from_numpy(targ).to(torch.int32),
        torch.from_numpy(tsum)))
    ref = [np.asarray(x) for x in j_migrate.migrate_detect(
        case.onsets, case.tt, case.mask, case.available, case.fsmp,
        case.nsamples)]
    assert max_coa.dtype == np.float64
    np.testing.assert_allclose(max_coa, ref[0], rtol=RTOL, atol=0)
    np.testing.assert_allclose(max_coa * case.tt.shape[0] / coa_sum,
                               ref[1], rtol=RTOL, atol=0)
    coa = np.asarray(j_migrate.migrate_map(
        case.onsets, case.tt, case.mask, case.available, case.fsmp,
        case.nsamples))
    unique = _unique(coa)
    assert unique.mean() > 0.5
    np.testing.assert_array_equal(max_idx[unique], ref[2][unique])
    flats = [_flat(ijk, case.nodes) for ijk in (TIE_A, TIE_B, TIE_C)]
    tied = [flats[0], flats[2]] + ([flats[1]] if ties == "across" else [])
    assert max_idx[TIE_T0] == ref[2][TIE_T0] == min(tied)
    a_pos = int(np.nonzero(case.plan.perm == flats[0])[0][0])
    c_pos = int(np.nonzero(case.plan.perm == flats[2])[0][0])
    assert a_pos // 256 == c_pos // 256
    assert targ[a_pos // 256, TIE_T0] == min(flats[0], flats[2])


@pytest.mark.parametrize("name", ["icequake", "f3"])
def test_k3_v3_f64_max_is_k3_v2_f64s(name):
    """Tile by tile and sample by sample, the emulation's max and argmax
    are K3 v2 f64's emulation's bit for bit (the same values, folded in
    another order), its sums within 1e-12."""

    _, _, v3, v2 = _emulated(name, "within")
    np.testing.assert_array_equal(v3[0], v2[0])
    np.testing.assert_array_equal(v3[1], v2[1])
    np.testing.assert_allclose(v3[2], v2[2], rtol=RTOL, atol=0)


# -- the ring on the host -----------------------------------------------------

@pytest.mark.parametrize("geometry, passes, n_stages", [
    ("icequake", 2, 4), ("f3", 1, 2), ("f1_256", 1, 2)])
def test_v3_ring_at_the_geometries(geometry, passes, n_stages):
    """One stage an item (4 nodes a warp a round) where K3 v2 f64's one
    group holds every onset, else G windows and one pass a stage (8 nodes,
    2 rounds, one a pass); the deepest ring
    that fits one block an SM; the block's bytes the source's formula."""

    spans = _geometry_spans(geometry)
    lay = cm.global_v2_layout(spans, (16, 8), dtype=F64)
    ring = cm.global_v3_layout(lay)
    assert (ring.stage_passes, ring.n_stages) == (passes, n_stages)
    assert (ring.npp, ring.unroll) == cm.GLOBAL_V3_FORM[passes]
    assert ring.npp == (4 if passes == 2 else 8)
    group = len(spans) if passes == 2 else lay.group
    assert passes == 1 or lay.group == len(spans)
    stage = -(-(8 * lay.stage_floats + 256 * passes * group) // 128) * 128
    assert ring.smem == n_stages * stage + 20 * 16 * 128 + 8 * (
        2 * n_stages + 2) <= cm.SMEM_LIMIT
    if n_stages < 4:
        assert cm.global_v3_smem(lay.stage_floats, lay.group, passes,
                                 n_stages + 1) > cm.SMEM_LIMIT


def _spans(span, n_onsets=24):
    return SimpleNamespace(tile=256, r_span=span, r_spans=[span] * n_onsets)


def _last_f64_span():
    """The widest residual span K3 v2 f64's ring of doubles holds."""

    span = 12_000
    while cm.global_v2_refusal(_spans(span), F64) is not None:
        span -= 1
    return span


@pytest.mark.parametrize("span", [10, 300, 2_990, 6_000, 11_000, 11_700,
                                  "last"])
def test_v3_takes_every_plan_k3_v2_f64_takes(span):
    """A ring of two of its stages fits wherever K3 v2 f64's fits, up to
    the last span K3 v2 f64's ring of doubles holds."""

    if span == "last":
        span = _last_f64_span()
        assert 11_700 < span < 11_900
        assert cm.global_v2_refusal(_spans(span + 1), F64) is not None
    plan = _spans(span)
    assert cm.global_v2_refusal(plan, F64) is None
    lay = cm.global_v2_layout(plan.r_spans, (16, 8), dtype=F64)
    assert cm.global_v3_layout(lay) is not None


def test_v3_shapes_match_the_source():
    src = (_build.CSRC_DIR / "migrate_detect_global_v3.cu").read_text()

    def define(name):
        return re.search(rf"#define {name} (\S+)", src).group(1)

    line = src[src.index("#define GW_FORMS(X)"):]
    line = line[:line.index("\n")]
    forms = tuple((int(n), int(u))
                  for n, u in re.findall(r"X\((\d+), (\d+)\)", line))
    assert forms == cm.GLOBAL_V3_FORMS
    assert set(cm.GLOBAL_V3_FORM.values()) <= set(forms)
    assert int(define("GW_SBLK")) == cm.GLOBAL_V2_SBLK
    assert int(define("GW_TILE")) == cm.GLOBAL_V2_TILE
    assert int(define("GW_WARPS")) == cm.GLOBAL_V3_WARPS
    assert int(define("GW_PASSES")) == cm.GLOBAL_V2_TILE // (16 * 8)
    assert "20 * GW_WARPS * GW_SBLK + 8 * (2 * n_stages + 2)" in src
    # The C entries' parameters against their ctypes signatures
    for name in ("qm_migrate_detect_global_v3_f64",
                 "qm_migrate_detect_global_v3_f64_blocks_per_sm"):
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        kinds = ["void*" in p for p in params.group(1).split(",")]
        assert [k == _build.ctypes.c_void_p
                for k in _build.SIGNATURES[name]] == kinds


def test_v3_ring_refuses_float32_layouts():
    lay = cm.global_v2_layout(_geometry_spans("f3"))
    with pytest.raises(ValueError, match="K3 v3 f64 takes"):
        cm.global_v3_layout(lay)


# -- the wrapper and the route, the launch caught -----------------------------

def _detector(name="icequake", dtype=F64):
    case = _case(name, "within")
    det = cm.CudaDetectGlobal(case.tt, case.nodes, case.fsmp, case.nsamples,
                              "cpu", plan=case.plan, dtype=dtype)
    onsets = torch.from_numpy(case.onsets).to(dtype)
    mask = torch.from_numpy(case.mask).to(dtype)
    onsets_log, inv = det.prepare(onsets, mask, case.available)
    return det, onsets_log, inv


@pytest.fixture
def caught(monkeypatch):
    """The launches caught (the C entry and its arguments) as if on the
    card: the wrappers' checks pass CPU tensors, nothing is launched."""

    seen = []
    monkeypatch.setattr(cm, "launch_kernel", lambda *a: seen.append(a))
    monkeypatch.setattr(cm, "launches", dict(cm.launches))
    real = cm._check_global_v2

    def on_card(onsets_log, base, inv, fsmp, nsamples, tables, *rest):
        try:
            return real(onsets_log, base, inv, fsmp, nsamples, tables, *rest)
        except ValueError as e:
            if "CUDA tensors" not in str(e):
                raise
            return onsets_log.shape[0], base.shape[0]

    monkeypatch.setattr(cm, "_check_global_v2", on_card)
    return seen


@pytest.mark.parametrize("name", ["icequake", "f3"])
def test_detector_launches_k3_v3_f64(name, caught):
    """CudaDetectGlobal in float64 launches K3 v3 f64 (its C entry, every
    argument of its signature, its form and ring) and counts it, on the
    route where one stage holds an item (Icequake) and through launch_v3
    on a layout of several groups (F3, whose route launches K3 v2 f64);
    K3 v2 f64 runs through launch_v2 wherever the route does not take
    it, its yardstick."""

    det, onsets_log, inv = _detector(name)
    ring = cm.global_v3_layout(det.layout)
    route = ("migrate_detect_global_v3_f64" if name == "icequake"
             else "migrate_detect_global_v2_f64")
    max_coa, max_idx, coa_sum = det.reduce_log(onsets_log, inv)
    assert caught[0][0] == f"qm_{route}"
    assert {k: n for k, n in cm.launches.items() if n} == {route: 1}
    assert max_coa.dtype == coa_sum.dtype == F64
    assert max_coa.shape == max_idx.shape == (det.nsamples,)
    det.launch_v3(onsets_log, inv)
    args = caught[1]
    assert args[0] == "qm_migrate_detect_global_v3_f64"
    assert len(args) - 2 == len(_build.SIGNATURES[args[0]]) - 1
    assert args[-6:] == (det.layout.group, det.layout.stage_floats,
                         ring.stage_passes, ring.n_stages, ring.npp,
                         ring.unroll)
    det.launch_v2(onsets_log, inv)
    assert caught[2][0] == "qm_migrate_detect_global_v2_f64"
    assert cm.launches["migrate_detect_global_v3_f64"] == 1 + (
        name == "icequake")
    assert cm.launches["migrate_detect_global_v2_f64"] == 1 + (name == "f3")


@pytest.mark.parametrize("name, passes, kernel", [
    ("icequake", 2, "qm_migrate_detect_global_v3_f64"),
    ("f3", 1, "qm_migrate_detect_global_v2_f64")])
def test_double_route_by_stage_passes(name, passes, kernel, monkeypatch):
    """The double route's kernel follows K3 v3 f64's layout: K3 v3 f64
    where one stage holds an item (stage_passes 2: the layout's one
    group), K3 v2 f64 on a layout of several groups (stage_passes 1),
    where K3 v3 f64's streamed form was the slower on the H100; float32
    keeps K3 v2."""

    det, onsets_log, inv = _detector(name)
    assert cm.global_v3_layout(det.layout).stage_passes == passes
    assert det.v3_route == (passes == 2)
    called = []
    for wrapper in ("migrate_detect_global_v3_f64_cuda",
                    "migrate_detect_global_v2_cuda"):
        monkeypatch.setattr(cm, wrapper, lambda *a, name=wrapper, **k: (
            called.append(name)))
    det.launch(onsets_log, inv)
    assert called == [{"qm_migrate_detect_global_v3_f64":
                       "migrate_detect_global_v3_f64_cuda",
                       "qm_migrate_detect_global_v2_f64":
                       "migrate_detect_global_v2_cuda"}[kernel]]
    assert not _detector(name, dtype=torch.float32)[0].v3_route


def test_float32_detector_keeps_k3_v2(caught):
    det, onsets_log, inv = _detector(dtype=torch.float32)
    det.reduce_log(onsets_log, inv)
    assert caught[0][0] == "qm_migrate_detect_global_v2"
    assert {k: n for k, n in cm.launches.items() if n} == {
        "migrate_detect_global_v2": 1}


def test_routed_ops_detector_launches_k3_v3_f64(caught):
    """The routed ``ops``' detector of a float64 flat table (an (N, 1, 1)
    grid of 256-node runs) launches K3 v3 f64, one stage an item."""

    case = _case("icequake", "within")
    routed.clear_cache()
    tt = torch.from_numpy(case.tt)
    onsets = torch.from_numpy(case.onsets)
    det = routed.detector(tt, tt.shape[0], onsets.shape[-1], case.fsmp,
                          case.nsamples, F64, torch.device("cpu"))
    routed.clear_cache()
    assert det.tables is not None
    det.reduce_log(*det.prepare(onsets, torch.from_numpy(case.mask),
                                case.available))
    assert caught[0][0] == "qm_migrate_detect_global_v3_f64"
    assert caught[0][-4:-2] == (2, cm.global_v3_layout(det.layout).n_stages)
    assert {k: n for k, n in cm.launches.items() if n} == {
        "migrate_detect_global_v3_f64": 1}


def test_double_route_names_k3_v3_f64(caplog):
    """precision="double" on a CUDA device type routes to "k3" (K3 v3
    f64, no line logged where it takes the plan); on a span K3 v2 f64's
    ring refuses, the line names K3 v3 f64's reason and K3 f64."""

    case = _case("icequake", "within")
    assert detect_route(case.tt, case.nodes, CUDA, precision="double")[
        :2] == ("k3", "precision='double'")
    tt = np.zeros((64, 2), np.int32)
    tt[1, 1] = 15_000 - 1
    with caplog.at_level(logging.INFO):
        route, why, _ = detect_route(tt, (4, 4, 4), CUDA, "auto", "double")
    assert route == "k3" and why.startswith("precision='double', K3 v3 f64")
    assert "using K3 f64" in caplog.text


def test_wrapper_refusals():
    """Before any launch: float32 tables, mixed types, tables built for
    another fsmp, CPU tensors."""

    det, onsets_log, inv = _detector()
    args = dict(onsets_log=onsets_log, base=det.base, inv_available=inv,
                fsmp=det.fsmp, nsamples=det.nsamples, tables=det.tables,
                max_shift=det._max_shift)

    def call(**kw):
        cm.migrate_detect_global_v3_f64_cuda(**{**args, **kw})

    det32, log32, inv32 = _detector(dtype=torch.float32)
    with pytest.raises(ValueError, match="K3 v3 f64 takes"):
        call(onsets_log=log32, inv_available=inv32, tables=det32.tables)
    with pytest.raises(ValueError, match="inv_available"):
        call(inv_available=inv.float())
    with pytest.raises(ValueError, match="onsets_log"):
        call(onsets_log=onsets_log.float())
    with pytest.raises(ValueError, match="fsmp"):
        call(fsmp=det.fsmp + 1)
    with pytest.raises(ValueError, match="CUDA"):
        call()


# -- the experiment on the CPU ------------------------------------------------

def test_experiment_bound_and_gather_floor_on_the_cpu():
    """exp_double's detect bound at the F3-like case in float64: the
    onset rows, K3 v2 f64's tables and inv_available read once and the
    three outputs written once against O + 4 FP64 operations a real
    node-sample; the gather floor the real nodes' 8-byte reads at the
    shared-memory rate; the ring's form on the case's detector."""

    case = _case("f3", "within")
    rng = np.random.default_rng(5)
    s = exp_double.setup(case.tt, case.nodes, case.fsmp, case.nsamples,
                         "cpu", rng=rng)
    plan, n_onsets = s.plan, case.tt.shape[1]
    t_len = s.onsets.shape[1]
    n_real = int(plan.valid.sum())
    b = exp_double.detect_bound(s, 8)
    nbytes = (8 * n_onsets * t_len + 4 * plan.n_tiles * n_onsets
              + 2 * plan.n_tiles * 256 * n_onsets + 4 * plan.n_tiles * 256
              + 8 * n_onsets + 8 + 20 * plan.n_tiles * case.nsamples)
    ops = n_real * case.nsamples * (n_onsets + 4)
    assert b["bound_ms"] == pytest.approx(
        max(nbytes / 3.35e12, ops / 34e12) * 1e3)
    assert b["gather_floor_ms"] == pytest.approx(
        8 * n_real * n_onsets * case.nsamples / 33.5e12 * 1e3)
    assert exp_double.v3_form(s.det[F64]) == "k3_v3_f64_streamed"


def test_experiment_requires_cuda():
    """With no card visible the experiment exits non-zero before any
    work."""

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "quakemigrate_torch.experiments.exp_double",
         "--detect"],
        cwd=pathlib.Path(__file__).resolve().parent.parent, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_sass_compare_sorts_kernels(monkeypatch, tmp_path):
    """sass_loops.compare (the machine-code comparison of two checkouts'
    libraries): kernels equal instruction for instruction, different, and
    built in one library only."""

    from quakemigrate_torch.experiments import sass_loops

    libs = {"here.so": {"a": [(0, "LDS R1, [R2]")], "b": [(0, "EXIT")],
                        "new": [(0, "EXIT")]},
            "there.so": {"a": [(0, "LDS R1, [R2]")], "b": [(0, "BRA 0x0")],
                         "old": [(0, "EXIT")]}}
    monkeypatch.setattr(_build, "build", lambda: "here.so")
    monkeypatch.setattr(sass_loops, "kernels_sass", lambda lib: libs[lib])
    monkeypatch.setattr(sass_loops.subprocess, "run", lambda *a, **k:
                        SimpleNamespace(stdout="building\nthere.so\n"))
    assert sass_loops.compare(tmp_path) == {
        "same": ["a"], "differ": ["b"], "only_here": ["new"],
        "only_there": ["old"]}
