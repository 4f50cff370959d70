# -*- coding: utf-8 -*-
"""
The route of quakemigrate_torch's DetectScan on the card, on the CPU:
``detect_route`` picks K1 v2 where the kernel can stage the plan and K2
v2, whose shared memory does not grow with the onset count, on the same
plan where it cannot, from the plan's sizes alone (the JAX scan chooses
between its Pallas plan and the XLA shift-table kernel the same way),
logs the reason once, and raises where neither kernel takes the plan. At
256 onsets (128 stations x P/S) K1 v2's slab and windows exceed a
block's shared memory; a plan whose residual span exceeds int16 has no
K1 v2 table and is too wide for K2 v2's ring; the Icequake-shaped 24
onsets stay on K1 v2. At 256 onsets the window of the K2 v2 route (its
plain version, as CudaDetectVPU runs it on CPU tensors) and the CPU's
plain window ``detect_window_fused`` are each held to the JAX
``detect_window_fused`` on the same numpy-seeded inputs: max_coa and
max_coa_n at rtol 2e-6 (float32), indices equal or tie-consistent (the
float64 coalescence at the port's node within 2e-6 of the maximum).

"""

import logging

import numpy as np
import pytest
import torch

from quakemigrate_tpu.ops import scan_window as j_scan_window
from quakemigrate_torch import DetectScan
from quakemigrate_torch.ops import cuda_migrate
from quakemigrate_torch.ops.scan_window import (
    detect_window_fused,
    detect_window_fused_cuda,
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


def test_span_beyond_int16_takes_no_kernel(caplog):
    """A plan whose residual span exceeds int16 builds, without K1 v2's
    table, and K1 v2 refuses it without raising; K2 v2's ring cannot
    hold its windows either, so the route raises, naming both reasons,
    before any launch."""

    tt = np.zeros((4 * 4 * 4, 2), np.int32)
    tt[1, 1] = cuda_migrate.FINE16_MAX_SPAN + 1
    plan = cuda_migrate.DetectPlan(tt, (4, 4, 4))
    assert plan.fine16 is None and plan.r_span > cuda_migrate.FINE16_MAX_SPAN
    assert "int16" in cuda_migrate.v2_refusal(
        plan.n_onsets, plan.tile, plan.win_floats, plan.r_span)
    assert "shared memory" in cuda_migrate.vpu_v2_refusal(plan.tile,
                                                          plan.r_span)
    with caplog.at_level(logging.INFO):
        with pytest.raises(ValueError, match="int16.*shared memory"):
            detect_route(tt, (4, 4, 4), CUDA)
    assert not caplog.records


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


def _k2_v2_route_window(block, tt, node_count, fsmp, nsamples):
    """The window as DetectScan's K2 v2 route computes it, on CPU
    tensors: CudaDetectVPU on the route's plan runs K2 v2's plain
    version."""

    plan = cuda_migrate.DetectPlan(tt, node_count)
    detect = cuda_migrate.CudaDetectVPU(tt, node_count, fsmp, nsamples,
                                        "cpu", plan=plan)
    out = detect_window_fused_cuda(
        *(torch.from_numpy(a) for a in block), detect, "classic", "energy",
        0.4, plan.n_nodes)
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
