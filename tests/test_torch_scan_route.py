# -*- coding: utf-8 -*-
"""
The route of quakemigrate_torch's DetectScan on the card, on the CPU:
``detect_route`` picks K1 v2 where the kernel can stage the plan, K2 v2,
whose shared memory does not grow with the onset count, on the same
plan where it cannot, and K3 (``CudaDetectGlobal``, the onset rows read
from global memory) where neither can, from the plan's sizes alone (the
JAX scan chooses between its Pallas plan and the XLA shift-table kernel
the same way), and logs the reasons once. At 256 onsets (128 stations x
P/S) K1 v2's slab and windows exceed a block's shared memory; a plan
whose residual span exceeds int16 has no K1 v2 table and is too wide for
K2 v2's ring, as is a coarse regional grid (40 x 40 x 16 nodes at 10 km,
12 stations x P/S at 100 Hz): both take K3; the Icequake-shaped 24
onsets stay on K1 v2. At 256 onsets the window of the K2 v2 route (its
plain version, as CudaDetectVPU runs it on CPU tensors) and the CPU's
plain window ``detect_window_fused`` are each held to the JAX
``detect_window_fused`` on the same numpy-seeded inputs: max_coa and
max_coa_n at rtol 2e-6 (float32), indices equal or tie-consistent (the
float64 coalescence at the port's node within 2e-6 of the maximum). A
numpy emulation of K3 (its clamp, node tiles, warps, fold and
first-flat-index combine) is held to the JAX ``migrate_detect`` at a
span no staged kernel takes, at the same tolerance.

"""

import logging

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops import migrate as j_migrate
from quakemigrate_tpu.ops import scan_window as j_scan_window
from quakemigrate_torch import DetectScan
from quakemigrate_torch.lut import traveltime_table
from quakemigrate_torch.ops import cuda_migrate
from quakemigrate_torch.ops.scan_window import (
    detect_window_cuda,
    detect_window_fused,
    stalta_front_end,
)
from quakemigrate_torch.signal.scan import detect_route

from test_torch_detect_v2 import ICEQUAKE_NODES, _icequake_traveltimes

torch.set_num_threads(1)

RTOL = 2e-6
CUDA = torch.device("cuda")  # a device type; nothing here touches a card


def _traveltimes(node_count, n_onsets, hi, seed=4):
    rng = np.random.default_rng(seed)
    n_nodes = int(np.prod(node_count))
    return rng.integers(0, hi, size=(n_nodes, n_onsets)).astype(np.int32)


def test_256_onsets_take_k2_v2(caplog):
    """128 stations x P/S on a small grid (every onset's residual span
    at least 16): K1 v2's slab and windows need more shared memory than
    a block has, so the route is K2 v2 on the same plan, logged once;
    K2 v2's block needs the same bytes as at 24 onsets."""

    tt = _traveltimes((12, 12, 10), 256, 40)
    plan = cuda_migrate.DetectPlan(tt, (12, 12, 10))
    assert min(plan.r_spans) >= 16
    reason = cuda_migrate.v2_refusal(plan.n_onsets, plan.tile,
                                     plan.win_floats, plan.r_span)
    assert "shared memory" in reason
    with pytest.raises(ValueError, match="shared memory"):
        cuda_migrate.v2_smem(plan.n_onsets, plan.tile, plan.win_floats)
    with caplog.at_level(logging.INFO):
        route, why, route_plan = detect_route(tt, (12, 12, 10), CUDA)
    assert (route, why) == ("k2_v2", reason)
    assert (route_plan.tile, route_plan.r_span) == (plan.tile, plan.r_span)
    np.testing.assert_array_equal(route_plan.fine, plan.fine)
    assert "fine16" not in vars(route_plan)  # K1 v2's table never built
    logged = [r.getMessage() for r in caplog.records]
    assert len(logged) == 1 and reason in logged[0]
    assert "K2 v2" in logged[0]
    assert cuda_migrate.vpu_v2_refusal(plan.tile, plan.r_span) is None
    assert cuda_migrate.vpu_v2_smem(plan.tile, plan.r_span, 4) == (
        cuda_migrate.vpu_v2_smem(plan.tile, 40, 4))
    detect = cuda_migrate.CudaDetectVPU(tt, (12, 12, 10), 5, 20, "cpu",
                                        plan=route_plan)
    assert (detect.tile, detect.n_stages) == (256, 4)


def test_span_beyond_int16_takes_k3(caplog):
    """A plan whose residual span exceeds int16 builds, without K1 v2's
    table, and K1 v2 refuses it without raising; K2 v2's ring cannot
    hold its windows either, so the route is K3, decided before any
    launch, with both reasons logged once; K3's detector takes the plan
    for locate."""

    tt = np.zeros((4 * 4 * 4, 2), np.int32)
    tt[1, 1] = cuda_migrate.FINE16_MAX_SPAN + 1
    plan = cuda_migrate.DetectPlan(tt, (4, 4, 4))
    assert plan.fine16 is None and plan.r_span > cuda_migrate.FINE16_MAX_SPAN
    assert "int16" in cuda_migrate.v2_refusal(
        plan.n_onsets, plan.tile, plan.win_floats, plan.r_span)
    assert "shared memory" in cuda_migrate.vpu_v2_refusal(plan.tile,
                                                          plan.r_span)
    with caplog.at_level(logging.INFO):
        route, why, route_plan = detect_route(tt, (4, 4, 4), CUDA)
    assert route == "k3" and "int16" in why and "shared memory" in why
    assert route_plan.r_span == plan.r_span
    logged = [r.getMessage() for r in caplog.records]
    assert len(logged) == 1 and why in logged[0] and "K3" in logged[0]
    detect = cuda_migrate.CudaDetectGlobal(tt, (4, 4, 4), 0, 8, "cpu",
                                           plan=route_plan)
    assert detect.tt.dtype == torch.int32 and detect.fine.shape == (
        1, 2, 256)


def _regional_traveltimes(node_count=(40, 40, 16), spacing_km=10.0,
                          rate=100, n_stations=12, seed=7):
    """Homogeneous traveltimes (vp 6.0, vs 3.46 km/s) of ``n_stations``
    random surface stations on a grid of ``node_count`` nodes at
    ``spacing_km``, phase-major, at ``rate`` Hz."""

    axes = [np.arange(n) * spacing_km for n in node_count]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    rng = np.random.default_rng(seed)
    stations = rng.uniform([0.0, 0.0], [axes[0][-1], axes[1][-1]],
                           size=(n_stations, 2))
    dist = [np.sqrt((x - sx) ** 2 + (y - sy) ** 2 + z**2)
            for sx, sy in stations]
    return traveltime_table([d / v for v in (6.0, 3.46) for d in dist], rate)


def test_regional_10km_100hz_takes_k3(caplog):
    """40 x 40 x 16 nodes at 10 km, 24 onsets at 100 Hz: a residual span
    of about 3,000 samples, whose windows fit neither K1 v2's block nor
    K2 v2's ring, so the route is K3 on a CUDA device, with both reasons;
    kernel="xla" takes K3 too, and on the CPU the route stays plain."""

    tt = _regional_traveltimes()
    with caplog.at_level(logging.INFO):
        route, why, plan = detect_route(tt, (40, 40, 16), CUDA)
    assert route == "k3" and plan.r_span > 2900
    assert why.count("shared memory") == 2 and "K1 v2" in why
    assert len(caplog.records) == 1
    assert detect_route(tt, (40, 40, 16), CUDA, "xla")[0] == "k3"
    assert detect_route(tt, (40, 40, 16), torch.device("cpu"),
                        "xla")[0] == "plain"


def test_kernel_xla_takes_k3_at_icequake(caplog):
    """kernel="xla" (the reference's XLA shift-table kernel) takes K3 on
    a plan K1 v2 takes, without logging a refusal."""

    tt = _icequake_traveltimes()
    with caplog.at_level(logging.INFO):
        route, why, plan = detect_route(tt, ICEQUAKE_NODES, CUDA, "xla")
    assert (route, why) == ("k3", "kernel='xla'")
    assert plan.n_onsets == 24 and not caplog.records


def test_icequake_geometry_stays_on_k1_v2(caplog):
    """24 onsets on the Icequake grid: K1 v2 takes the plan, nothing is
    logged, and the route hands the plan to the detector."""

    tt = _icequake_traveltimes()
    with caplog.at_level(logging.INFO):
        route, why, plan = detect_route(tt, ICEQUAKE_NODES, CUDA)
    assert (route, why) == ("k1_v2", None)
    assert plan.n_onsets == 24 and plan.fine16 is not None
    assert not caplog.records


def test_cpu_scan_keeps_the_plain_path():
    """On the CPU nothing is planned or logged: the route is the plain
    window, as before, and it has no CUDA detector; 256 onsets change
    nothing there."""

    tt = _traveltimes((4, 4, 4), 256, 40)
    scan = DetectScan(tt, (4, 4, 4), 10, 10, device="cpu")
    assert (scan.route, scan.route_reason) == ("plain", None)
    with pytest.raises(ValueError, match="plain route"):
        scan.detector(50)


def _window(n_slots, node_count, fsmp, nsamples, lsmp, seed=8):
    """A numpy-seeded channel block of ``n_slots`` slots (3 channels,
    one dead slot and one dead channel) and its traveltimes."""

    rng = np.random.default_rng(seed)
    t_len = fsmp + nsamples + lsmp
    channels = rng.normal(size=(n_slots, 3, t_len)).astype(np.float32)
    chan_mask = np.ones((n_slots, 3), np.float32)
    slot_mask = np.ones(n_slots, np.float32)
    chan_mask[3, 2] = 0.0
    channels[3, 2] = 0.0
    slot_mask[5] = 0.0
    chan_mask[5] = 0.0
    channels[5] = 0.0
    nsta = rng.integers(2, 5, size=n_slots).astype(np.int32)
    nlta = (nsta * rng.integers(4, 8, size=n_slots)).astype(np.int32)
    tt = _traveltimes(node_count, n_slots, lsmp, seed)
    return (channels, chan_mask, slot_mask, nsta, nlta), tt


def _k3_emulation(onsets_log, tt, inv, fsmp, nsamples, tile=256, warps=8):
    """K3 in numpy, float32: the traveltimes clamped to ``[0, T - fsmp -
    nsamples]``, each node's onsets summed in order, ``exp(acc * inv)``;
    per tile of ``tile`` consecutive flat nodes, warp w folding nodes w,
    w + warps, ... in order (strict >, running sums), the warps met by
    the larger value or on equal values the smaller index, their sums in
    warp order; across tiles the first tile on equal maxima."""

    n_nodes, n_onsets = tt.shape
    d_max = onsets_log.shape[-1] - fsmp - nsamples
    cols = np.clip(tt, 0, d_max) + fsmp
    t = np.arange(nsamples)
    acc = np.zeros((n_nodes, nsamples), np.float32)
    for o in range(n_onsets):
        acc = acc + onsets_log[o][cols[:, o, None] + t]
    coa = np.exp((acc * inv).astype(np.float32))
    n_tiles = -(-n_nodes // tile)
    tmax = np.zeros((n_tiles, nsamples), np.float32)
    targ = np.zeros((n_tiles, nsamples), np.int64)
    tsum = np.zeros((n_tiles, nsamples), np.float32)
    for i in range(n_tiles):
        best = np.full(nsamples, -np.inf, np.float32)
        arg = np.full(nsamples, np.iinfo(np.int32).max)
        total = np.zeros(nsamples, np.float32)
        for w in range(warps):
            nodes = np.arange(i * tile + w, min((i + 1) * tile, n_nodes),
                              warps)
            w_best = np.full(nsamples, -np.inf, np.float32)
            w_arg = np.full(nsamples, np.iinfo(np.int32).max)
            w_sum = np.zeros(nsamples, np.float32)
            for n in nodes:
                better = coa[n] > w_best
                w_best = np.where(better, coa[n], w_best)
                w_arg = np.where(better, n, w_arg)
                w_sum = w_sum + coa[n]
            take = (w_best > best) | ((w_best == best) & (w_arg < arg))
            best = np.where(take, w_best, best)
            arg = np.where(take, w_arg, arg)
            total = total + w_sum
        tmax[i], targ[i], tsum[i] = best, arg, total
    first = np.argmax(tmax, axis=0)
    s = np.arange(nsamples)
    return tmax[first, s], targ[first, s], tsum.sum(axis=0)


def test_k3_emulation_matches_jax_migrate_detect():
    """K3's indexing, tiling and first-flat-index combine, emulated in
    numpy on a plan whose residual span no staged kernel takes (several
    traveltimes past the onset block, clamped), held to the JAX
    ``migrate_detect`` on the same float32 inputs: max_coa and max_coa_n
    at rtol 2e-6, the argmax equal or tie-consistent."""

    node_count, fsmp, nsamples = (9, 8, 7), 20, 40
    rng = np.random.default_rng(16)
    n_nodes, n_onsets = int(np.prod(node_count)), 6
    tt = rng.integers(0, 40_000, size=(n_nodes, n_onsets)).astype(np.int32)
    t_len = fsmp + nsamples + 35_000
    tt[:5, 0] = 50_000  # past the block: clamped to d_max
    plan = cuda_migrate.DetectPlan(tt, node_count)
    assert cuda_migrate.vpu_v2_refusal(plan.tile, plan.r_span) is not None
    onsets = rng.gamma(2.0, 1.5, size=(n_onsets, t_len)).astype(np.float32)
    mask = np.ones(n_onsets, np.float32)
    mask[-1] = 0.0
    available = np.float32(mask.sum())
    logged = (np.log(np.clip(onsets, 0.01, None)) * mask[:, None]).astype(
        np.float32)
    inv = np.float32(1.0) / available
    max_coa, max_idx, coa_sum = _k3_emulation(logged, tt, inv, fsmp,
                                              nsamples)
    ref = [np.asarray(x) for x in j_migrate.migrate_detect(
        onsets, tt, mask, available, fsmp, nsamples)]
    np.testing.assert_allclose(max_coa, ref[0], rtol=RTOL)
    np.testing.assert_allclose(max_coa * n_nodes / coa_sum, ref[1],
                               rtol=RTOL)
    differ = max_idx != ref[2]
    if differ.any():
        t = np.arange(nsamples)
        cols = np.clip(tt[max_idx], 0, t_len - fsmp - nsamples).T
        at = np.exp(np.take_along_axis(
            logged.astype(np.float64), fsmp + cols + t, axis=1).sum(0)
            / float(available))
        np.testing.assert_allclose(at[differ], ref[0][differ], rtol=RTOL)


def test_k3_route_window_on_the_cpu_is_the_plain_window():
    """DetectScan's K3 route on CPU tensors: CudaDetectGlobal runs the
    plain version, ops.migrate.detect_reduce, so the window equals the
    plain window bit for bit and counts no launch."""

    node_count, fsmp, nsamples, lsmp = (6, 5, 4), 30, 40, 24
    block, tt = _window(24, node_count, fsmp, nsamples, lsmp)
    tensors = [torch.from_numpy(a) for a in block]
    plain = detect_window_fused(*tensors, torch.from_numpy(tt), "classic",
                                "energy", 0.4, fsmp, nsamples)
    detect = cuda_migrate.CudaDetectGlobal(tt, node_count, fsmp, nsamples,
                                           "cpu")
    got = detect_window_cuda(stalta_front_end("classic", "energy", 0.4),
                             tensors, detect, int(np.prod(node_count)))
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert detect.launches == 0


def _k2_v2_route_window(block, tt, node_count, fsmp, nsamples):
    """The window as DetectScan's K2 v2 route computes it, on CPU
    tensors: CudaDetectVPU on the route's plan runs K2 v2's plain
    version."""

    plan = cuda_migrate.DetectPlan(tt, node_count)
    detect = cuda_migrate.CudaDetectVPU(tt, node_count, fsmp, nsamples,
                                        "cpu", plan=plan)
    out = detect_window_cuda(
        stalta_front_end("classic", "energy", 0.4),
        [torch.from_numpy(a) for a in block], detect, plan.n_nodes)
    assert detect.launches == 0
    return out


@pytest.mark.parametrize("route", ["plain", "k2_v2"])
def test_plain_window_at_256_onsets_matches_jax(route):
    node_count, fsmp, nsamples, lsmp = (6, 5, 4), 30, 40, 24
    block, tt = _window(256, node_count, fsmp, nsamples, lsmp)
    if route == "plain":
        out = detect_window_fused(
            *(torch.from_numpy(a) for a in block), torch.from_numpy(tt),
            "classic", "energy", 0.4, fsmp, nsamples,
        )
    else:
        out = _k2_v2_route_window(block, tt, node_count, fsmp, nsamples)
    got = [x.numpy() for x in out]
    ref = [np.asarray(x) for x in j_scan_window.detect_window_fused(
        *block, tt, "classic", "energy", 0.4, fsmp, nsamples,
    )]
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL)
    assert got[2].dtype == np.int32
    differ = got[2] != ref[2]
    if differ.any():
        # the float64 plain coalescence at the port's node equals the max
        onsets, available = j_scan_window.fused_onsets(
            *block, "classic", "energy", 0.4)
        logged = np.log(np.clip(np.asarray(onsets, np.float64), 0.01, None))
        logged *= block[2][:, None]
        t = np.arange(nsamples)
        cols = fsmp + tt[got[2]].T + t
        at_got = np.exp(np.take_along_axis(logged, cols, axis=1).sum(0)
                        / float(available))
        np.testing.assert_allclose(at_got[differ], ref[0][differ],
                                   rtol=RTOL)
