# -*- coding: utf-8 -*-
"""
Continuous detect: the fused detect window run window after window, with
the host-to-device copy, the dispatch and the in-order drain of results
pipelined as in the JAX ``QuakeScan`` (``_detect_loop``,
``_run_detect_batch``, ``_drain_detect_results``).

The input of each window is the fixed-shape channel block that
``STALTAOnset.prepare_device_inputs`` builds. Archive reading, the onset
preprocessing that makes those blocks and the ``.scanmseed`` writer are
host layers that this package does not hold yet.

"""

import logging
from collections import deque

import numpy as np
import torch

from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.lut import unravel
from quakemigrate_torch.ops.cuda_migrate import (
    CudaDetect,
    CudaDetectVPU,
    DetectPlan,
    v2_refusal,
    vpu_v2_refusal,
)
from quakemigrate_torch.ops.scan_window import (
    detect_window_fused,
    detect_window_fused_cuda,
    pack_detect_window,
    unpack_detect_window,
)

# Windows dispatched but not yet fetched before the loop waits for the
# oldest (the JAX scan's default detect_drain_depth)
DRAIN_DEPTH = 8


def detect_route(traveltimes, node_count, device):
    """
    The migration that :class:`DetectScan` takes on ``device`` for these
    traveltimes, chosen from the plan's sizes before any launch, as the
    JAX scan's ``_mxu_kernel`` chooses between its Pallas plan and the
    XLA shift-table kernel. Returns (route, reason, plan):

    - on the CPU ``("plain", None, None)``, the flat-order window;
    - on a CUDA device ``("k1_v2", None, plan)`` where K1 v2 can stage
      the :class:`~quakemigrate_torch.ops.cuda_migrate.DetectPlan`
      (``v2_refusal``), else ``("k2_v2", reason, plan)`` where K2 v2,
      whose shared memory does not grow with the onset count, takes the
      same plan (``vpu_v2_refusal``), logging K1 v2's reason once.

    Raises where neither kernel can take the plan.

    """

    if device.type != "cuda":
        return "plain", None, None
    plan = DetectPlan(traveltimes, node_count)
    reason = v2_refusal(plan.n_onsets, plan.tile, plan.win_floats,
                        plan.r_span)
    if reason is None:
        return "k1_v2", None, plan
    k2_reason = vpu_v2_refusal(plan.tile, plan.r_span)
    if k2_reason is not None:
        raise ValueError(f"no CUDA kernel takes this scan geometry: K1 v2 "
                         f"({reason}), K2 v2 ({k2_reason})")
    logging.info(f"\tK1 v2 cannot take this scan geometry ({reason}); "
                 f"using K2 v2 on {device}.")
    return "k2_v2", reason, plan


class DetectScan:
    """
    Detect over a sequence of windows on one device.

    Parameters
    ----------
    traveltimes : [n_nodes, n_slots] int array
        Node-major traveltime sample offsets (lut.traveltime_table), one
        column per canonical (phase, station) slot.
    node_count : (nx, ny, nz)
        Grid shape; ``n_nodes == nx * ny * nz``.
    fsmp, lsmp : int
        Pre- and post-pad of each window in samples; the scan samples of
        a window of T samples are ``[fsmp, T - lsmp)``.
    position, transform, min_onset_value
        The STA/LTA onset's settings ("classic"/"centred"; "energy",
        "abs", "env" or "env_squared"; the onset floor).
    device : str or torch.device, default "cuda"
        Where the windows run: the card unless the caller asks for the
        CPU; "cuda" raises where CUDA is absent. On a CUDA device the
        migration is a CUDA kernel on the traveltimes' plan (see
        ``route``); on the CPU it is the plain flat-order reduction
        (ops.migrate).

    Attributes
    ----------
    route : "k1_v2", "k2_v2" or "plain"
        The migration the windows take, chosen from the plan's sizes
        before any launch (:func:`detect_route`): on a CUDA device K1 v2
        (``ops.cuda_migrate.CudaDetect``) where it can stage the plan,
        else K2 v2 (``ops.cuda_migrate.CudaDetectVPU``) on the same plan;
        on the CPU "plain", the flat-order window
        (``ops.scan_window.detect_window_fused``).
    route_reason : str or None
        Why a CUDA device did not take K1 v2 (logged once), else None.

    """

    def __init__(self, traveltimes, node_count, fsmp, lsmp,
                 position="classic", transform="energy",
                 min_onset_value=0.4, device="cuda"):
        self.device = resolve_device(device)
        self.traveltimes = np.ascontiguousarray(traveltimes, dtype=np.int32)
        self.node_count = tuple(int(n) for n in node_count)
        self.n_nodes = int(np.prod(self.node_count))
        if self.traveltimes.shape[0] != self.n_nodes:
            raise ValueError(
                f"{self.traveltimes.shape[0]} traveltime rows for a grid of "
                f"{self.n_nodes} nodes"
            )
        self.fsmp = int(fsmp)
        self.lsmp = int(lsmp)
        self.position = position
        self.transform = transform
        self.min_onset_value = float(min_onset_value)
        self._detector = None
        self._tt_flat = None
        self.route, self.route_reason, self._plan = detect_route(
            self.traveltimes, self.node_count, self.device)
        # Per-window device milliseconds (upload to packed result) of the
        # last detect() on a CUDA device, from CUDA events.
        self.window_ms = []

    def detector(self, nsamples):
        """The route's CUDA detector for windows of ``nsamples`` scan
        samples (K1 v2's on "k1_v2", K2 v2's on "k2_v2"), built on first
        use and kept while the geometry holds; raises on the "plain"
        route."""

        if self.route == "plain":
            raise ValueError("DetectScan on the plain route has no CUDA "
                             "detector")
        if self._detector is None or self._detector.nsamples != nsamples:
            kind = CudaDetect if self.route == "k1_v2" else CudaDetectVPU
            self._detector = kind(
                self.traveltimes, self.node_count, self.fsmp, nsamples,
                self.device, plan=self._plan,
            )
        return self._detector

    def detect(self, windows):
        """
        Run every window of ``windows``, an iterable of
        ``(channels, chan_mask, slot_mask, nsta, nlta)`` numpy blocks.

        Returns one entry per window, in order:
        ``(max_coa, max_coa_n, max_idx, ijk)`` numpy arrays over the
        window's scan samples (``ijk`` [S, 3] grid indices), or None for
        a window with no live slot, which is rejected before any device
        work, as the JAX scan rejects it.

        """

        results = []
        pending = deque()
        self.window_ms = []
        for block in windows:
            slot_mask = block[2]
            results.append(None)
            if np.asarray(slot_mask).sum() == 0:
                continue
            pending.append((len(results) - 1, *self._dispatch(*block)))
            while len(pending) > DRAIN_DEPTH:
                self._drain(pending.popleft(), results)
        while pending:
            self._drain(pending.popleft(), results)
        return results

    def _dispatch(self, channels, chan_mask, slot_mask, nsta, nlta):
        """Copy one window to the device and queue its device program.
        Returns (packed result on the host or on its way there, CUDA
        events (start, copied) or None)."""

        # The window's tensors land on self.device, so this one flag is
        # the tensors' device: it picks the kernel path and the events
        cuda = self.device.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device, non_blocking=True
            )

        channels, chan_mask, slot_mask, nsta, nlta = (
            put(a) for a in (channels, chan_mask, slot_mask, nsta, nlta)
        )
        nsamples = channels.shape[-1] - self.fsmp - self.lsmp
        if cuda:
            out = detect_window_fused_cuda(
                channels, chan_mask, slot_mask, nsta, nlta,
                self.detector(nsamples), self.position, self.transform,
                self.min_onset_value, self.n_nodes,
            )
        else:
            if self._tt_flat is None:
                self._tt_flat = torch.from_numpy(self.traveltimes)
            out = detect_window_fused(
                channels, chan_mask, slot_mask, nsta, nlta, self._tt_flat,
                self.position, self.transform, self.min_onset_value,
                self.fsmp, nsamples, n_nodes_real=self.n_nodes,
            )
        packed = pack_detect_window(*out)
        if not cuda:
            return packed, None
        # One non-blocking device-to-host copy into pinned memory; the
        # drain waits on the event recorded after it.
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        copied = torch.cuda.Event(enable_timing=True)
        copied.record(stream)
        return host, (start, copied)

    def _drain(self, entry, results):
        i, host, events = entry
        if events is not None:
            start, copied = events
            copied.synchronize()
            self.window_ms.append(start.elapsed_time(copied))
        max_coa, max_coa_n, max_idx = unpack_detect_window(host.numpy())
        results[i] = (
            max_coa, max_coa_n, max_idx, unravel(max_idx, self.node_count)
        )
