# -*- coding: utf-8 -*-
"""
K3 v2 of quakemigrate_torch (``csrc/migrate_detect_global_v2.cu``, K3's
detect reduction on the brick plan with the onset windows streamed
through an mbarrier ring) on the CPU: its host ring layout (onsets a
stage, stage bytes, ring depth) within a block's shared memory at the
F3 geometry, at Icequake, at 256 onsets and where one onset a stage is
all that fits; the wide-span plan routed to K3 with K3 v2's reason
logged once; its tables against the plan; a numpy emulation of the
kernel (the windows copied stage by stage from their 16-byte aligned
columns and cut at the row's end, the gather in onset order across
stages, the fold and the cross-warp fold with the flat-index tie rule,
and the brick-tile combine) against the JAX ``migrate_detect`` on an
F3-like grid, and the brick-tile combine against the JAX
``detect_reduce`` on planted ties across tiles and within a tile; the
experiment's case and bound on the CPU and its refusal without a card,
and the machine-code census's spill count. The kernel runs only on the
card, where chip_smoke.py holds it against the plain version and K3.

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
from quakemigrate_torch.experiments import exp_global_v2, sass_loops
from quakemigrate_torch.ops import cuda_migrate as cm
from quakemigrate_torch.ops.migrate import detect_reduce
from quakemigrate_torch.signal.scan import detect_route

from test_torch_detect_v2 import ICEQUAKE_NODES, _icequake_traveltimes
from test_torch_scan_route import _regional_traveltimes, _traveltimes

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 2e-6
SUM_RTOL = 1e-4
CUDA = torch.device("cuda")  # a device type; nothing here touches a card
SHAPES = sorted(cm.GLOBAL_V2_SHAPES)


def _wide_toy():
    """test_torch_scan_route's wide-span toy: one residual past int16."""

    tt = np.zeros((4 * 4 * 4, 2), np.int32)
    tt[1, 1] = cm.FINE16_MAX_SPAN + 1
    return tt, (4, 4, 4)


def _uniform_spans(r_span, n_onsets=24):
    """A plan on a 4 x 4 x 4 grid whose every onset spans ``r_span``."""

    tt = np.zeros((64, n_onsets), np.int32)
    tt[1] = r_span - 1
    return cm.DetectPlan(tt, (4, 4, 4))


def _g1_span(shape):
    """A residual span at which two stages of one window fit ``shape``'s
    budget and two stages of two windows do not."""

    free = (cm.global_v2_budget(shape) - cm.global_v2_smem(shape, 0, 1, 2)
            - 4 * 2 * cm.GLOBAL_V2_TILE)
    return free // 8 * 3 // 4


@functools.lru_cache(maxsize=None)
def _geometry_spans(name):
    if name == "f3":
        return cm.DetectPlan(_regional_traveltimes(), (40, 40, 16)).r_spans
    if name == "icequake":
        return cm.DetectPlan(_icequake_traveltimes(), ICEQUAKE_NODES).r_spans
    # F1's 256 onsets (128 stations x P/S) on a small grid
    return cm.DetectPlan(_traveltimes((12, 12, 10), 256, 40),
                         (12, 12, 10)).r_spans


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("geometry", ["f3", "icequake", "f1_256", "g1"])
def test_layout_fits_shared_memory(geometry, shape):
    """The default ring at each geometry and shape: every group's windows
    at 16-byte offsets inside the stage without overlap, the stage under
    2^16 floats (uint16 entries), two to four stages and the block's
    shared memory within the shape's budget (at most SMEM_LIMIT, half an
    SM for two blocks an SM), the kernel's own formula; G the most onsets
    for which two stages fit, 1 where only one window a stage fits."""

    spans = (_uniform_spans(_g1_span(shape)).r_spans if geometry == "g1"
             else _geometry_spans(geometry))
    lay = cm.global_v2_layout(spans, shape)
    assert lay is not None and lay.shape == shape
    budget = cm.global_v2_budget(shape)
    assert budget <= cm.SMEM_LIMIT
    assert lay.smem == cm.global_v2_smem(shape, lay.stage_floats, lay.group,
                                         lay.n_stages) <= budget
    warps, npp = shape
    stage = -(-(4 * lay.stage_floats + 2 * lay.group * warps * npp)
              // 128) * 128
    assert lay.smem == (lay.n_stages * stage + 12 * warps * 128
                        + 16 * lay.n_stages)
    assert 2 <= lay.n_stages <= 4 and lay.stage_floats < 2**16
    assert lay.n_stages == max(
        n for n in cm.GLOBAL_V2_STAGES if cm.global_v2_smem(
            shape, lay.stage_floats, lay.group, n) <= budget)
    widths = cm.global_v2_widths(spans)
    np.testing.assert_array_equal(lay.win[:, 1], widths)
    assert (lay.win % 4 == 0).all()
    assert (np.asarray(spans) + 3 + 128 <= widths).all()
    for o0 in range(0, len(spans), lay.group):
        off = lay.win[o0:o0 + lay.group, 0]
        ends = off + lay.win[o0:o0 + lay.group, 1]
        assert off[0] == 0 and (off[1:] == ends[:-1]).all()
        assert ends[-1] <= lay.stage_floats
    bigger = cm.global_v2_layout(spans, shape, group=lay.group + 1)
    assert lay.group == len(spans) or bigger is None
    if geometry == "g1":
        assert lay.group == 1
    if geometry == "icequake":
        assert lay.group == 24 and lay.n_stages == 4


def test_f3_layout_fixed_group():
    """At F3 a fixed G gives the deepest ring that fits, and a G whose two
    stages do not fit gives None, as the sweep of chip_smoke.py asks."""

    spans = _geometry_spans("f3")
    shape = cm.GLOBAL_V2_SHAPE
    assert cm.global_v2_layout(spans, shape, group=1).n_stages == 4
    assert cm.global_v2_layout(spans, shape, group=2).n_stages == 3
    assert cm.global_v2_layout(spans, shape, group=4) is None
    assert cm.global_v2_layout(spans, shape).group == 3


def test_wide_span_toy_takes_k3_v1(caplog):
    """The wide-span toy (a residual past int16): K1 v2, K2 v2 and K3 v2
    all refuse it, so the "k3" route runs K3, decided before any launch,
    with K3 v2's reason in the route's reason and in the one log line;
    its detector builds no K3 v2 table. With kernel="xla" too."""

    tt, nc = _wide_toy()
    plan = cm.DetectPlan(tt, nc)
    reason = cm.global_v2_refusal(plan)
    assert reason is not None and "shared memory" in reason
    with caplog.at_level(logging.INFO):
        route, why, route_plan = detect_route(tt, nc, CUDA)
    assert route == "k3" and f"K3 v2 ({reason})" in why
    logged = [r.getMessage() for r in caplog.records]
    assert len(logged) == 1 and why in logged[0]
    assert "K3, the global-memory kernel" in logged[0]
    detect = cm.CudaDetectGlobal(tt, nc, 0, 8, "cpu", plan=route_plan)
    assert detect.v2_refusal == reason and detect.tables is None
    caplog.clear()
    with caplog.at_level(logging.INFO):
        route, why, _ = detect_route(tt, nc, CUDA, "xla")
    assert route == "k3" and why == f"kernel='xla', K3 v2 ({reason})"
    assert len(caplog.records) == 1


@pytest.mark.parametrize("span, shape", [
    (9_000, cm.GLOBAL_V2_SHAPE), (15_000, cm.GLOBAL_V2_WIDE_SHAPE),
    (25_000, cm.GLOBAL_V2_WIDE_SHAPE), (26_000, None)])
def test_span_picks_the_shape(span, shape, caplog):
    """K3 v2 runs its two-blocks-an-SM shape while that shape's ring holds
    two stages of the widest window, the one-block shape up to about
    25,000 samples of span, and refuses wider plans (K3 runs), the route
    (24 onsets of that span: K1 v2 and K2 v2 refuse them all) logging
    K3 v2's reason once; each shape's layout fits its budget."""

    plan = _uniform_spans(span)
    tt = np.zeros((64, 24), np.int32)
    tt[1] = span - 1
    assert cm.global_v2_shape(plan.r_spans) == shape
    with caplog.at_level(logging.INFO):
        route, why, _ = detect_route(tt, (4, 4, 4), CUDA)
    detect = cm.CudaDetectGlobal(tt, (4, 4, 4), 0, 8, "cpu", plan=plan)
    if shape is None:
        assert "K3 v2 (" in why and detect.tables is None
        assert "K3, the global-memory kernel" in caplog.records[0].getMessage()
        return
    assert "K3 v2" not in why and detect.v2_refusal is None
    assert detect.layout.shape == shape
    assert detect.layout.smem <= cm.global_v2_budget(shape)
    assert "K3 v2, the ring kernel" in caplog.records[0].getMessage()


def test_f3_route_takes_k3_v2(caplog):
    """The F3-like regional plan: the "k3" route's detector builds K3 v2's
    tables for the default shape; the log line names K3 v2."""

    tt = _regional_traveltimes()
    with caplog.at_level(logging.INFO):
        route, why, plan = detect_route(tt, (40, 40, 16), CUDA)
    assert route == "k3" and "K3 v2" not in why
    assert "K3 v2, the ring kernel" in caplog.records[0].getMessage()
    detect = cm.CudaDetectGlobal(tt, (40, 40, 16), 25, 100, "cpu",
                                 plan=plan)
    assert detect.v2_refusal is None
    assert detect.layout.shape == cm.GLOBAL_V2_SHAPE
    assert detect.tables.res.dtype == torch.uint16


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fsmp", [0, 5, 130])
def test_tables_against_the_plan(shape, fsmp):
    """Each entry of K3 v2's residual table, read from its onset's window
    (which starts at the 16-byte aligned column at or below fsmp +
    base), lands on the node's traveltime; flat holds each brick-order
    node's flat index, -1 for padding, in the table's order."""

    tt = _regional_traveltimes(node_count=(12, 9, 6))
    plan = cm.DetectPlan(tt, (12, 9, 6))
    lay = cm.global_v2_layout(plan.r_spans, shape)
    t = cm.global_v2_tables(plan, fsmp, "cpu", lay)
    warps, npp = shape
    passes = cm.GLOBAL_V2_TILE // (warps * npp)
    res = t.res.numpy().astype(np.int64)
    assert res.shape == (plan.n_tiles, passes, plan.n_onsets, warps * npp)
    # back to [tiles, O, tile] in brick order
    entry = res.transpose(0, 2, 1, 3).reshape(plan.n_tiles, plan.n_onsets,
                                              -1)
    col0 = (fsmp + plan.base) & ~3
    col = col0[:, :, None] + entry - lay.win[None, :, 0, None]
    np.testing.assert_array_equal(
        col, fsmp + plan.base[:, :, None] + plan.fine)
    flat = t.flat.numpy().ravel()
    live = plan.valid.ravel() > 0
    np.testing.assert_array_equal(flat[live], plan.perm[live])
    assert (flat[~live] == -1).all()
    brick_tt = plan.base[:, None, :] + plan.fine.transpose(0, 2, 1)
    np.testing.assert_array_equal(
        tt[flat[live]], brick_tt.reshape(-1, plan.n_onsets)[live])


def _k3_v2_emulation(logged, plan, tables, inv, fsmp, nsamples):
    """K3 v2 in numpy, in the logs' type (float32; float64 for K3 v2
    f64), through the module's tables: per block
    (tile, 128 samples) and pass, the ring's stages filled one group of G
    onsets at a time (each window from its 16-byte aligned column, cut
    at the row's end; the rest of the stage NaN, stale), each onset's
    window gathered at the warp's residual entries in onset order; then
    each warp folds its nodes (the larger value, or on equal values the
    smaller flat index; padding left out) and the warps are folded the
    same way, sums in warp order. Returns (tmax, targ, tsum), each
    [n_tiles, nsamples], targ flat indices."""

    lay = tables.layout
    warps, npp = lay.shape
    res = tables.res.numpy().astype(np.int64)
    flat = tables.flat.numpy()
    win = tables.win.numpy()
    n_onsets, t_len = logged.shape
    # The element type (float32, or float64 for K3 v2 f64) and its
    # 16-byte copy unit; the row pitch is a multiple of 4 elements
    dtype = logged.dtype
    unit = 16 // logged.itemsize
    ld = -(-t_len // 4) * 4
    rows = np.zeros((n_onsets, ld), dtype)
    rows[:, :t_len] = logged
    passes, slice_ = res.shape[1], res.shape[3]
    lanes = np.arange(128)
    big = np.iinfo(np.int32).max
    shape = (plan.n_tiles, nsamples)
    tmax, targ = np.zeros(shape, dtype), np.zeros(shape, np.int64)
    tsum = np.zeros(shape, dtype)
    for i in range(plan.n_tiles):
        for s0 in range(0, nsamples, 128):
            red_max = np.full((warps, 128), -np.inf, dtype)
            red_arg = np.full((warps, 128), big, np.int64)
            red_sum = np.zeros((warps, 128), dtype)
            for p in range(passes):
                acc = np.zeros((slice_, 128), dtype)
                for o0 in range(0, n_onsets, lay.group):
                    group = range(o0, min(o0 + lay.group, n_onsets))
                    stage = np.full(lay.stage_floats, np.nan, dtype)
                    for o in group:
                        col = (fsmp + int(plan.base[i, o]) + s0) & ~(unit - 1)
                        n = min(int(win[o, 1]), ld - col)
                        stage[win[o, 0]:win[o, 0] + n] = rows[o, col:col + n]
                    for o in group:
                        acc = acc + stage[res[i, p, o][:, None] + lanes]
                coa = np.exp(acc * dtype.type(inv))
                nodes = flat[i, p * slice_:(p + 1) * slice_]
                for q in range(slice_):
                    if nodes[q] < 0:
                        continue
                    w = q // npp
                    better = (coa[q] > red_max[w]) | (
                        (coa[q] == red_max[w]) & (nodes[q] < red_arg[w]))
                    red_max[w] = np.where(better, coa[q], red_max[w])
                    red_arg[w] = np.where(better, nodes[q], red_arg[w])
                    red_sum[w] = red_sum[w] + coa[q]
            m, a, total = red_max[0], red_arg[0], red_sum[0]
            for v in range(1, warps):
                take = (red_max[v] > m) | ((red_max[v] == m)
                                           & (red_arg[v] < a))
                m = np.where(take, red_max[v], m)
                a = np.where(take, red_arg[v], a)
                total = total + red_sum[v]
            k = min(128, nsamples - s0)
            tmax[i, s0:s0 + k] = m[:k]
            targ[i, s0:s0 + k] = a[:k]
            tsum[i, s0:s0 + k] = total[:k]
    return tmax, targ, tsum


F3_LIKE_NODES = (20, 20, 8)
# Flat (i, j, k) nodes whose traveltime rows are made equal: A in brick
# (0, 1, 0) (tile 2), B in brick (0, 2, 0) (tile 4) with a smaller flat
# index, C in A's tile with a smaller flat index than A's, in another
# warp of every shape
TIE_A, TIE_B, TIE_C = (7, 8, 0), (0, 16, 0), (2, 9, 3)
TIE_T0 = 37


def _flat(ijk, node_count=F3_LIKE_NODES):
    return int(np.ravel_multi_index(ijk, node_count))


@functools.lru_cache(maxsize=None)
def _f3_like_case(ties):
    """An F3-like window (10 km nodes, 12 stations x P/S at 100 Hz) with
    a source planted at node A and sample TIE_T0, A's traveltime row
    copied to B and C (``ties`` "across") or to C only ("within"); the
    numpy-seeded onsets and mask, their logs, the JAX migrate_detect of
    them and the plan. 8 live onsets of 24, so that 1 / available is
    exact."""

    tt = _regional_traveltimes(node_count=F3_LIKE_NODES, seed=11)
    a = _flat(TIE_A)
    copies = [TIE_B, TIE_C] if ties == "across" else [TIE_C]
    for ijk in copies:
        tt[_flat(ijk)] = tt[a]
    fsmp, nsamples = 12, 150
    t_len = fsmp + nsamples + int(tt.max()) + 5
    rng = np.random.default_rng(17)
    n_onsets = tt.shape[1]
    onsets = rng.gamma(2.0, 1.5, size=(n_onsets, t_len)).astype(np.float32)
    mask = np.zeros(n_onsets, np.float32)
    mask[rng.choice(n_onsets, 8, replace=False)] = 1.0
    for o in range(n_onsets):
        onsets[o, fsmp + tt[a, o] + TIE_T0] += 60.0
    available = np.float32(mask.sum())
    ref = [np.asarray(x) for x in j_migrate.migrate_detect(
        onsets, tt, mask, available, fsmp, nsamples)]
    logged = (np.log(np.clip(onsets, 0.01, None)) * mask[:, None]).astype(
        np.float32)
    plan = cm.DetectPlan(tt, F3_LIKE_NODES)
    return SimpleNamespace(tt=tt, onsets=onsets, mask=mask, logged=logged,
                           available=available, fsmp=fsmp,
                           nsamples=nsamples, plan=plan, ref=ref)


def _assert_argmax(got, want, case, at_max):
    """``got`` equals the JAX argmax ``want``, or where not, the float64
    coalescence at ``got`` lies within RTOL of the JAX maximum
    ``at_max`` (float32 logs and exps may round two nodes apart)."""

    differ = got != want
    if differ.any():
        t = np.arange(case.nsamples)
        cols = case.fsmp + case.tt[got].T + t
        at = np.exp(np.take_along_axis(
            case.logged.astype(np.float64), cols, axis=1).sum(0)
            / float(case.available))
        np.testing.assert_allclose(at[differ], at_max[differ], rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ties", ["across", "within"])
def test_k3_v2_emulation_matches_jax_migrate_detect(shape, ties):
    """The emulation on an F3-like grid with planted ties: its max equals
    the flat-order numpy max bit for bit and its argmax the first flat
    argmax at every sample, its sum within 1e-4; against the JAX
    migrate_detect, max_coa and max_coa_n at rtol 2e-6 and the argmax
    equal or tie-consistent, at the planted sample the smallest of the
    tied flat indices; A's tile gives the smaller of A and C."""

    case = _f3_like_case(ties)
    tt, plan, nsamples = case.tt, case.plan, case.nsamples
    assert cm.global_v2_refusal(plan) is None
    lay = cm.global_v2_layout(plan.r_spans, shape)
    tables = cm.global_v2_tables(plan, case.fsmp, "cpu", lay)
    inv = np.float32(1.0) / case.available
    tmax, targ, tsum = _k3_v2_emulation(case.logged, plan, tables, inv,
                                        case.fsmp, nsamples)
    max_coa, max_idx, coa_sum = (x.numpy() for x in cm.combine_brick_tiles(
        torch.from_numpy(tmax), torch.from_numpy(targ).to(torch.int32),
        torch.from_numpy(tsum)))
    assert np.isfinite(max_coa).all() and np.isfinite(coa_sum).all()

    coa = _flat_coalescence(case, inv)
    np.testing.assert_array_equal(max_coa, coa.max(axis=0))
    np.testing.assert_array_equal(max_idx, np.argmax(coa, axis=0))
    np.testing.assert_allclose(coa_sum, coa.sum(axis=0, dtype=np.float64),
                               rtol=SUM_RTOL)

    ref = case.ref
    np.testing.assert_allclose(max_coa, ref[0], rtol=RTOL)
    np.testing.assert_allclose(max_coa * tt.shape[0] / coa_sum, ref[1],
                               rtol=RTOL)
    _assert_argmax(max_idx, ref[2], case, ref[0])
    tied = [_flat(TIE_A), _flat(TIE_C)] + (
        [_flat(TIE_B)] if ties == "across" else [])
    assert max_idx[TIE_T0] == ref[2][TIE_T0] == min(tied)
    a_pos = int(np.nonzero(plan.perm == _flat(TIE_A))[0][0])
    assert targ[a_pos // 256, TIE_T0] == min(_flat(TIE_A), _flat(TIE_C))


def _flat_coalescence(case, inv):
    """The flat-order coalescence of the case, numpy float32 [N, S]: the
    onsets summed in order, ``exp(acc * inv)``."""

    t = np.arange(case.nsamples)
    acc = np.zeros((case.tt.shape[0], case.nsamples), np.float32)
    for o in range(case.tt.shape[1]):
        acc = acc + case.logged[o][case.fsmp + case.tt[:, o, None] + t]
    return np.exp(acc * inv)


def _brick_tile_outputs(case, inv):
    """Per brick tile of the case's plan and sample: the max, the smallest
    flat index attaining it and the sum of the flat-order coalescence."""

    coa = _flat_coalescence(case, inv)
    plan = case.plan
    shape = (plan.n_tiles, case.nsamples)
    tmax, targ = np.zeros(shape, np.float32), np.zeros(shape, np.int32)
    tsum = np.zeros(shape, np.float32)
    live = plan.valid > 0
    for i in range(plan.n_tiles):
        nodes = np.sort(plan.perm.reshape(live.shape)[i][live[i]])
        part = coa[nodes]
        tmax[i] = part.max(axis=0)
        targ[i] = nodes[np.argmax(part, axis=0)]
        tsum[i] = part.sum(axis=0)
    return tmax, targ, tsum


@pytest.mark.parametrize("ties", ["across", "within"])
def test_brick_combine_matches_jax_detect_reduce(ties):
    """The brick-tile combine on planted ties: per brick tile the max and
    its smallest flat index, combined, against JAX's detect_reduce: the
    max at rtol 2e-6, the argmax equal or tie-consistent, at the planted
    sample the smallest tied flat index (in a later tile than A's when
    the ties are across tiles), the grid sum within 1e-4. The flat-tile
    combine (first tile on equal maxima) does not give it there when the
    ties are across tiles."""

    case = _f3_like_case(ties)
    inv = np.float32(1.0) / case.available
    parts = [torch.from_numpy(x) for x in _brick_tile_outputs(case, inv)]
    max_coa, max_idx, coa_sum = (x.numpy()
                                 for x in cm.combine_brick_tiles(*parts))
    ref = [np.asarray(x) for x in j_migrate.detect_reduce(
        case.onsets, case.tt, case.mask, case.available, case.fsmp,
        case.nsamples, case.tt.shape[0])]
    np.testing.assert_allclose(max_coa, ref[0], rtol=RTOL)
    _assert_argmax(max_idx, ref[1], case, ref[0])
    np.testing.assert_allclose(coa_sum, ref[2], rtol=SUM_RTOL)
    want = min(_flat(TIE_A), _flat(TIE_C),
               *([_flat(TIE_B)] if ties == "across" else []))
    assert max_idx[TIE_T0] == ref[1][TIE_T0] == want
    first_tile = cm.combine_flat_tiles(*parts)[1].numpy()
    if ties == "across":
        assert first_tile[TIE_T0] != want
    else:
        assert first_tile[TIE_T0] == want


def test_flat_reference_matches_detect_reduce():
    """detect_reduce_flat_reference (K3's function on prepared onsets,
    the kernels' arithmetic), combined over its flat tiles, against the
    plain detect_reduce on the same window: max and sum at rtol 2e-6,
    the argmax equal where the maxima are."""

    case = _f3_like_case("across")
    inv = torch.tensor([1.0 / case.available], dtype=torch.float32)
    parts = cm.detect_reduce_flat_reference(
        torch.from_numpy(case.logged), torch.from_numpy(case.tt), inv,
        case.fsmp, case.nsamples)
    n_nodes = case.tt.shape[0]
    assert parts[0].shape == (-(-n_nodes // cm.K3_TILE), case.nsamples)
    got = cm.combine_flat_tiles(*parts)
    want = detect_reduce(
        torch.from_numpy(case.onsets), torch.from_numpy(case.tt),
        torch.from_numpy(case.mask), float(case.available), case.fsmp,
        case.nsamples, n_nodes)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=RTOL, atol=0)
    same = got[0] == want[0]
    assert torch.equal(got[1][same], want[1][same])
    assert int(got[1][TIE_T0]) == _flat(TIE_B)


def test_k3_route_detector_on_the_cpu():
    """CudaDetectGlobal on CPU tensors with K3 v2's tables: reduce is the
    plain detect_reduce bit for bit and counts no launch; reduce_log
    raises, as there is no kernel on the CPU."""

    case = _f3_like_case("within")
    detect = cm.CudaDetectGlobal(case.tt, F3_LIKE_NODES, case.fsmp,
                                 case.nsamples, "cpu", plan=case.plan)
    assert detect.tables is not None
    onsets, mask = torch.from_numpy(case.onsets), torch.from_numpy(
        case.mask)
    got = detect.reduce(onsets, mask, float(case.available))
    want = detect_reduce(onsets, torch.from_numpy(case.tt), mask,
                         float(case.available), case.fsmp, case.nsamples,
                         case.tt.shape[0])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert detect.launches == 0
    inv = torch.tensor([1.0 / case.available], dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        detect.reduce_log(torch.from_numpy(case.logged), inv)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper checks tables, geometry and shapes before any launch."""

    case = _f3_like_case("within")
    plan = case.plan
    tables = cm.global_v2_tables(plan, case.fsmp, "cpu",
                                 cm.global_v2_layout(plan.r_spans))
    base = torch.from_numpy(plan.base)

    def call(**kw):
        args = dict(onsets_log=torch.from_numpy(case.logged), base=base,
                    inv_available=torch.tensor([0.125]), fsmp=case.fsmp,
                    nsamples=case.nsamples, tables=tables,
                    max_shift=plan.max_shift)
        args.update(kw)
        cm.migrate_detect_global_v2_cuda(**args)

    with pytest.raises(ValueError, match="fsmp"):
        call(fsmp=case.fsmp + 1)
    with pytest.raises(ValueError, match="onset samples"):
        call(max_shift=plan.max_shift + 10)
    with pytest.raises(ValueError, match="contiguous"):
        call(base=base.to(torch.int64))
    with pytest.raises(ValueError, match="inconsistent"):
        call(base=base[:, :-1].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_kernel_shapes_match_the_source():
    """The shapes, sample block and tile that the host uses are the ones
    csrc/migrate_detect_global_v2.cu builds."""

    src = (_build.CSRC_DIR / "migrate_detect_global_v2.cu").read_text()
    line = src[src.index("#define GV_SHAPES(X)"):]
    line = line[:line.index("\n")]
    built = {(int(w), int(n)): int(b)
             for w, n, b in re.findall(r"X\((\d+), (\d+), (\d+)\)", line)}
    assert built == cm.GLOBAL_V2_SHAPES
    assert cm.GLOBAL_V2_SHAPE in built
    assert re.search(r"#define GV_SBLK (\d+)", src).group(1) == str(
        cm.GLOBAL_V2_SBLK)
    assert re.search(r"#define GV_TILE (\d+)", src).group(1) == str(
        cm.GLOBAL_V2_TILE)


def test_experiment_setup_and_bound_on_the_cpu():
    """The experiment's case on the CPU: the route's ring (16 x 8 at F3),
    its plain version (the flat reference, combined) and its bound: the
    onset rows, base, uint16 residuals, flat table, windows' table and
    inv_available read once and the three outputs written once against
    O + 4 operations a real node-sample, and the gather floor of the
    real nodes' reads."""

    tt = _regional_traveltimes(node_count=(12, 9, 6))
    rng = np.random.default_rng(3)
    s = exp_global_v2.setup(tt, (12, 9, 6), 20, 150, "cpu", rng)
    plan, n_onsets = s.plan, tt.shape[1]
    assert exp_global_v2.route_layout(s).shape == cm.GLOBAL_V2_SHAPE
    t_len = s.onsets_log.shape[1]
    assert t_len == 20 + 150 + plan.max_shift + 7
    b = exp_global_v2.bound(s)
    n_real = int(plan.valid.sum())
    nbytes = (4 * n_onsets * t_len + 4 * plan.n_tiles * n_onsets
              + 2 * plan.n_tiles * 256 * n_onsets + 4 * plan.n_tiles * 256
              + 8 * n_onsets + 4 + 12 * plan.n_tiles * 150)
    ops = n_real * 150 * (n_onsets + 4)
    assert b["bound_ms"] == pytest.approx(
        max(nbytes / 3.35e12, ops / 67e12) * 1e3)
    assert b["gather_bytes"] == 4 * n_real * n_onsets * 150
    got = exp_global_v2.plain(s)
    want = cm.combine_flat_tiles(*cm.detect_reduce_flat_reference(
        s.onsets_log, s.tt_dev, s.inv, 20, 150))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_experiment_requires_cuda():
    """With no card visible the experiment exits non-zero, before any
    work."""

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "quakemigrate_torch.experiments.exp_global_v2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


_SASS = """
        Function : _Z19qm_global_v2_kernelILi16ELi8ELi2EEvPKf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R20, [R2] ;
        /*0020*/                   LDS R8, [R4] ;
        /*0030*/                   FADD R16, R16, R8 ;
        /*0040*/                   STL [R1+0x4], R16 ;
        /*0050*/              @!P1 LDL R17, [R1+0x8] ;
        /*0060*/                @P0 BRA 0x10 ;
        /*0070*/                   STL [R1+0xc], R3 ;
        /*0080*/                   EXIT ;
"""


def test_sass_census_counts_spills_in_the_loop():
    """The census's spill count: the local loads and stores inside a loop
    (predicated ones too), not those after it."""

    instrs = sass_loops.parse_sass(_SASS)[
        "_Z19qm_global_v2_kernelILi16ELi8ELi2EEvPKf"]
    [rec] = sass_loops.loops(instrs)
    assert (rec["start"], rec["end"], rec["lds32"], rec["fadd"]) == (
        0x10, 0x60, 1, 1)
    assert sass_loops.local_ops(instrs, rec) == 2
    assert set(sass_loops.GLOBAL_PATTERNS) == {
        "qm_migrate_detect_global_kernel", "qm_global_v2_kernel"}
