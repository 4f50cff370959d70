# -*- coding: utf-8 -*-
"""
Continuous detect, and locate.

:class:`DetectScan` runs the fused detect window window after window, with
the host-to-device copy, the dispatch and the in-order drain of results
pipelined as in the JAX ``QuakeScan`` (``_detect_loop``,
``_run_detect_batch``, ``_drain_detect_results``). On the fused path the
input of each window is the fixed-shape channel block that the onset's
``prepare_device_inputs`` builds (``STALTAOnset`` or ``KurtosisOnset``),
and the window runs that onset's front end (``ops.scan_window``). On the
standard path (any other ``Onset``, or ``fused_detect=False``) the input
is the onsets that ``calculate_onsets`` computed, in the canonical slot
layout (``ops.scan_window.onset_front_end``).

:class:`QuakeScan` is the user's entry point for detect and locate, after
the JAX ``QuakeScan``. Detect reads each window from the waveform archive
(one reader thread, two windows ahead), prepares its channel block, runs
the blocks through one :class:`DetectScan`'s dispatch/drain loop, and
writes the results, in order, to the run's ``.scanmseed`` and
StationAvailability files; ``resume=True`` restarts an interrupted scan
at its first missing timestep. Locate reads the triggered events, and
for each event (the reader thread one event ahead) computes its onsets on
the device, runs pass 1 (the detect migration, on detect's kernel route
and plan) to find the origin time, and pass 2 (M1, the marginalisation
over the marginal window) on the main thread; the location math, picks,
local magnitudes and files of each event run on a pool of host threads,
which wait on the CUDA event of M1's copy back and issue no work on the
card. Where the 4-D coalescence map is to be written or drawn (the
event video), locate's map path builds it instead (M2), takes pass 1's
outputs from it, copies it back and marginalises it on the host. The
figures (``plot``) are drawn on the post pool, one at a time.

"""

import contextlib
import logging
import threading
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from datetime import time as clock_time

import numpy as np
import torch
from scipy import ndimage

import quakemigrate_torch.plot as plot
import quakemigrate_torch.util as util
from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.io import (
    Event,
    Run,
    ScanmSEED,
    read_triggered_events,
    write_availability,
    write_coalescence,
    write_cut_waveforms,
)
from quakemigrate_torch.lut import traveltime_table, unravel
from quakemigrate_torch.seis import Stream, UTCDateTime, read
from quakemigrate_torch.signal.local_mag import LocalMag
from quakemigrate_torch.signal.onsets import KurtosisOnset, Onset, STALTAOnset
from quakemigrate_torch.signal.pickers import GaussianPicker, PhasePicker
from quakemigrate_torch.ops.migrate import (
    DEFAULT_TILE,
    find_max_coa,
    migrate_detect,
    migrate_map,
    migrate_marginalise,
)
from quakemigrate_torch.ops.cuda_migrate import (
    CudaDetect,
    CudaDetectGlobal,
    CudaDetectVPU,
    DetectPlan,
    global_v2_refusal,
    ring_refusal,
    v2_refusal,
    vpu_v2_refusal,
)
from quakemigrate_torch.ops.scan_window import (
    detect_window,
    detect_window_cuda,
    kurtosis_front_end,
    onset_front_end,
    pack_detect_window,
    stalta_front_end,
    unpack_detect_window,
)

# Windows dispatched but not yet fetched before the loop waits for the
# oldest (the JAX scan's default detect_drain_depth)
DRAIN_DEPTH = 8

warnings.filterwarnings(
    "ignore", message=("Covariance of the parameters could not be estimated")
)


# The CUDA detector of each route of detect_route
ROUTE_DETECTORS = {"k1_v2": CudaDetect, "k2_v2": CudaDetectVPU,
                   "k3": CudaDetectGlobal}


def detect_route(traveltimes, node_count, device, kernel="auto",
                 precision="single"):
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
      same plan (``vpu_v2_refusal``), logging K1 v2's reason once, else
      ``("k3", reasons, plan)``: ``CudaDetectGlobal``, logging both
      kernels' reasons once; on both routes the plan serves locate's M1
      ring and M2 ring, or M1 and M2's simple form where ``ring_refusal``
      refuses it (the log line says which);
    - with ``kernel="xla"`` (the reference's option that forces its XLA
      shift-table kernel), ``("k3", "kernel='xla'", plan)`` on a CUDA
      device whatever the plan;
    - with ``precision="double"`` (the reference then keeps its XLA
      functions in float64, whatever ``kernel`` is),
      ``("k3", "precision='double'", plan)``: the float64 kernels of the
      route, K3 v3 f64 on K3 v2 f64's ring of doubles (logged, with
      locate's, where that ring refuses the plan: K3 f64).

    On the "k3" route ``CudaDetectGlobal`` runs K3 v2, the ring kernel on
    the plan's brick tiles, where its ring holds the plan's widest window
    (``global_v2_refusal``; in float64, a ring of doubles), else K3, the
    global-memory kernel, which takes any span: K3 v2's reason then joins
    the route's reason and the log line.

    """

    if device.type != "cuda":
        return "plain", None, None
    return plan_route(DetectPlan(traveltimes, node_count), device, kernel,
                      precision)


def plan_route(plan, device, kernel="auto", precision="single"):
    """:func:`detect_route` of a :class:`DetectPlan` already built, on a
    CUDA ``device``: (route, reason, plan)."""

    double = precision == "double"
    k3_reason = global_v2_refusal(
        plan, torch.float64 if double else torch.float32)
    f64 = " f64" if double else ""
    # The ring kernel: K3 v2, in float64 K3 v3 f64 on K3 v2 f64's ring
    ring = "K3 v3 f64" if double else "K3 v2"
    k3 = (f"{ring}, the ring kernel on the brick plan"
          if k3_reason is None else f"K3{f64}, the global-memory kernel")
    if double or kernel == "xla":
        forced = "precision='double'" if double else "kernel='xla'"
        if k3_reason is None:
            return "k3", forced, plan
        reasons = f"{forced}, {ring} ({k3_reason})"
        dtype = torch.float64 if double else torch.float32
        logging.info(f"\t{reasons}; using {k3} on {device}, "
                     f"{locate_kernels(plan, dtype)}.")
        return "k3", reasons, plan
    reason = v2_refusal(plan.n_onsets, plan.tile, plan.win_floats,
                        plan.r_span)
    if reason is None:
        return "k1_v2", None, plan
    k2_reason = vpu_v2_refusal(plan.tile, plan.r_span)
    if k2_reason is None:
        logging.info(f"\tK1 v2 cannot take this scan geometry ({reason}); "
                     f"using K2 v2 on {device}, {locate_kernels(plan)}.")
        return "k2_v2", reason, plan
    reasons = f"K1 v2 ({reason}), K2 v2 ({k2_reason})"
    if k3_reason is not None:
        reasons += f", K3 v2 ({k3_reason})"
    logging.info(f"\tNo staged kernel takes this scan geometry: {reasons}; "
                 f"using {k3} on {device}, {locate_kernels(plan)}.")
    return "k3", reasons, plan


def locate_kernels(plan, dtype=torch.float32):
    """Locate's kernels on the "k2_v2" and "k3" routes of ``plan`` for
    onsets of ``dtype``, in words for the route's log line: M1 ring and M2
    ring, or M1 and M2's simple form with the reason the ring refuses the
    plan (``ring_refusal``); in float64 their f64 forms (M1 ring f64 and
    M2 ring f64 wherever K3 v2 f64 takes the plan)."""

    reason = ring_refusal(plan, dtype)
    f64 = " f64" if dtype == torch.float64 else ""
    if reason is None:
        return f"locate on M1 ring{f64} and M2 ring{f64}"
    return f"locate on M1{f64} and M2 simple{f64} ({reason})"


def route_detector(route, plan, traveltimes, node_count, fsmp, nsamples,
                   device, cached=None, dtype=torch.float32):
    """
    The CUDA detector of ``route`` (:func:`detect_route`) for windows of
    ``nsamples`` scan samples after ``fsmp`` whose onsets migrate in
    ``dtype``: K1 v2's on "k1_v2", K2 v2's on "k2_v2", K3's on "k3" (the
    one route with float64 forms), built on the shared ``plan``. Returns
    ``cached`` while its geometry and type hold; raises on the "plain"
    route.

    """

    if route == "plain":
        raise ValueError("the plain route has no CUDA detector")
    if cached is not None and (cached.fsmp, cached.nsamples,
                               cached.dtype) == (fsmp, nsamples, dtype):
        return cached
    return ROUTE_DETECTORS[route](traveltimes, node_count, fsmp, nsamples,
                                  device, plan=plan, dtype=dtype)


def _inert(block):
    """An inert window of a fused block's shapes: all-ones channels and
    zero masks, the per-slot arguments of ``block``."""

    def like(a, value):
        if torch.is_tensor(a):
            return torch.full_like(a, value)
        return np.full_like(a, value)

    return (like(block[0], 1.0), like(block[1], 0.0), like(block[2], 0.0),
            *block[3:])


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
    front_end : callable, optional
        The onset front end of the windows
        (``ops.scan_window.stalta_front_end`` or ``kurtosis_front_end``):
        a block ``(channels, chan_mask, slot_mask, *per-slot arguments)``
        to (combined onsets, available); or, on the standard path,
        ``ops.scan_window.onset_front_end``, whose block is ``(onsets,
        available, slot_mask)``, onsets already computed. Default: the
        classic STA/LTA of the signal's energy with an onset floor of
        0.4.
    device : str or torch.device, default "cuda"
        Where the windows run: the card unless the caller asks for the
        CPU; "cuda" raises where CUDA is absent. On a CUDA device the
        migration is a CUDA kernel on the traveltimes' plan (see
        ``route``); on the CPU it is the plain flat-order reduction
        (ops.migrate).
    drain_depth : int, default 8
        Windows dispatched but not yet fetched before the loop waits for
        the oldest (the JAX scan's ``detect_drain_depth``).
    route : tuple, optional
        :func:`detect_route`'s (route, reason, plan) for these traveltimes
        on ``device``, where the caller has it already (QuakeScan shares
        one plan between detect and locate; ``detect_route(...,
        kernel="xla")`` gives K3's).
    dtype : torch.dtype, default torch.float32
        The element type the windows migrate in on the card: float64
        (``precision="double"``) takes the float64 forms of the "k3"
        route's kernels; the blocks come in that type. The CPU's plain
        window runs in the blocks' own type.
    mesh : quakemigrate_torch.parallel.Mesh, optional
        Shard each window's migration over the mesh's "grid" axis
        (``parallel.MeshDetect``): on a CPU mesh the plain reduction on
        flat slabs of the table padded to whole ``tile``s, on a CUDA mesh
        the route's kernel on slabs of the plan's tiles; the onset front
        end once a device, the slabs combined and the packed result on
        the mesh's first device, which ``device`` must be.
    tile : int, default ops.migrate.DEFAULT_TILE
        The flat slabs' node tile on a CPU mesh (the reference's ``tile``).
    batch : int, optional
        With a mesh that has a "batch" axis: windows a dispatch, a
        multiple of the batch rows; window j of a dispatch runs on row
        ``j // (batch / rows)``, a short dispatch is filled with inert
        windows (ones, masks 0), and each window's live count is clamped
        to 1, as the reference's batched mesh does.

    Attributes
    ----------
    route : "k1_v2", "k2_v2", "k3" or "plain"
        The migration the windows take, chosen from the plan's sizes
        before any launch (:func:`detect_route`): on a CUDA device K1 v2
        (``ops.cuda_migrate.CudaDetect``) where it can stage the plan,
        else K2 v2 (``ops.cuda_migrate.CudaDetectVPU``) on the same plan,
        else K3 v2, or K3 where K3 v2's ring cannot hold the plan's
        widest window (``ops.cuda_migrate.CudaDetectGlobal``); on the CPU
        "plain", the flat-order window (``ops.scan_window.detect_window``).
    route_reason : str or None
        Why a CUDA device did not take K1 v2 (logged once), else None.

    """

    def __init__(self, traveltimes, node_count, fsmp, lsmp,
                 front_end=stalta_front_end("classic", "energy", 0.4),
                 device="cuda", drain_depth=DRAIN_DEPTH, route=None,
                 dtype=torch.float32, mesh=None, tile=DEFAULT_TILE,
                 batch=None):
        self.device = resolve_device(device)
        if mesh is not None and mesh.first != self.device:
            raise ValueError(f"device {self.device} is not the mesh's first "
                             f"device {mesh.first}")
        self.mesh, self.tile, self.batch = mesh, tile, batch
        self._mesh_detect = None
        self.dtype = dtype
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
        self.front_end = front_end
        self._detector = None
        self._tt_flat = None
        self.route, self.route_reason, self._plan = route or detect_route(
            self.traveltimes, self.node_count, self.device)
        self.drain_depth = max(1, int(drain_depth))
        # Per-dispatch device milliseconds (upload to packed result) of
        # the last detect() on a CUDA device, from CUDA events (a dispatch
        # is one window, or on a batched mesh one batch); and the host
        # seconds of each dispatched window's dispatch and of its fetch
        # (wait, copy and unpack), in window order.
        self.window_ms, self.dispatch_s, self.fetch_s = [], [], []

    def mesh_detect(self):
        """The ``parallel.MeshDetect`` of the windows on the mesh, built
        on first use: the slabs of the table (CPU mesh) or of the route's
        plan (CUDA mesh)."""

        if self._mesh_detect is None:
            from quakemigrate_torch.parallel import MeshDetect, scan_slabs

            slabs = scan_slabs(self.mesh, self.traveltimes, self.route,
                               self._plan, self.tile, dtype=self.dtype)
            self._mesh_detect = MeshDetect(
                self.mesh, slabs, self.n_nodes,
                batch_axis="batch" if self.batch else None)
        return self._mesh_detect

    def detector(self, nsamples):
        """The route's CUDA detector for windows of ``nsamples`` scan
        samples (K1 v2's on "k1_v2", K2 v2's on "k2_v2", K3's on "k3"),
        built on first use and kept while the geometry holds; raises on
        the "plain" route."""

        self._detector = route_detector(
            self.route, self._plan, self.traveltimes, self.node_count,
            self.fsmp, nsamples, self.device, cached=self._detector,
            dtype=self.dtype,
        )
        return self._detector

    def detect(self, windows):
        """
        Run every window of ``windows``, an iterable of
        ``(channels, chan_mask, slot_mask, *per-slot arguments)`` numpy
        blocks (STA/LTA: ``nsta, nlta``; kurtosis: ``nkurt``), the
        blocks of the scan's front end (on the standard path ``(onsets,
        available, slot_mask)``, numpy arrays or tensors).

        Returns one entry per window, in order:
        ``(max_coa, max_coa_n, max_idx, ijk)`` numpy arrays over the
        window's scan samples (``ijk`` [S, 3] grid indices), or None for
        a window with no live slot, which is rejected before any device
        work, as the JAX scan rejects it.

        """

        return list(self.stream(windows))

    def stream(self, windows):
        """
        The dispatch/drain loop of :meth:`detect` as a generator: yields
        each window's result (or None) in window order as soon as it is
        drained, while up to ``drain_depth`` later windows are already
        dispatched. ``windows`` is consumed lazily, so a caller can read
        and prepare window i + 1 while the device runs window i. A window
        given as None, or with no live slot, yields None without device
        work.

        """

        pending = deque()
        # A mesh's windows waiting for their dispatch: [entry, block],
        # each entry a list filled with (host, events, j) on dispatch
        waiting = []
        self.window_ms, self.dispatch_s, self.fetch_s = [], [], []
        for block in windows:
            if block is None or float(block[2].sum()) == 0:
                pending.append(None)
            elif self.mesh is None:
                t0 = time.perf_counter()
                pending.append(self._dispatch(*block))
                self.dispatch_s.append(time.perf_counter() - t0)
            else:
                waiting.append(([None], block))
                pending.append(waiting[-1][0])
                if len(waiting) == (self.batch or 1):
                    self._dispatch_mesh(waiting)
            while len(pending) > self.drain_depth:
                if waiting and pending[0] is waiting[0][0]:
                    self._dispatch_mesh(waiting)
                yield self._drain(pending.popleft())
        if waiting:
            self._dispatch_mesh(waiting)
        while pending:
            yield self._drain(pending.popleft())

    def _dispatch(self, *block):
        """Copy one window's block to the device and queue its device
        program. Returns (packed result on the host or on its way there,
        CUDA events (start, copied) or None)."""

        # The window's tensors land on self.device, so this one flag is
        # the tensors' device: it picks the kernel path and the events
        cuda = self.device.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)

        def put(a):
            if not torch.is_tensor(a):
                a = torch.from_numpy(np.ascontiguousarray(a))
            return a.to(self.device, non_blocking=True)

        block = tuple(put(a) for a in block)
        nsamples = block[0].shape[-1] - self.fsmp - self.lsmp
        if cuda:
            out = detect_window_cuda(self.front_end, block,
                                     self.detector(nsamples), self.n_nodes)
        else:
            if self._tt_flat is None:
                self._tt_flat = torch.from_numpy(self.traveltimes)
            out = detect_window(self.front_end, block, self._tt_flat,
                                self.fsmp, nsamples,
                                n_nodes_real=self.n_nodes)
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

    def _dispatch_mesh(self, waiting):
        """Dispatch the mesh's waiting windows, filled up to ``batch``
        with inert windows: each window's sharded program
        (``parallel.MeshDetect.window``), the packed results stacked on
        the first device and copied back at once; fills each waiting
        entry with (host [B, 3, S], events or None, j) and empties
        ``waiting``."""

        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        blocks = [block for _, block in waiting]
        nsamples = blocks[0][0].shape[-1] - self.fsmp - self.lsmp
        md = self.mesh_detect()
        if self.batch:
            blocks += [_inert(blocks[0])] * (self.batch - len(blocks))
        per = len(blocks) // len(md.rows)
        packed = torch.stack([pack_detect_window(*md.window(
            self.front_end, block, self.fsmp, nsamples, row=j // per,
            clamp=bool(self.batch))) for j, block in enumerate(blocks)])
        events = None
        if cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            copied = torch.cuda.Event(enable_timing=True)
            copied.record(stream)
            packed, events = host, (start, copied)
        for j, (entry, _) in enumerate(waiting):
            entry[0] = (packed, events if j == 0 else None, j)
        dt = (time.perf_counter() - t0) / len(waiting)
        self.dispatch_s.extend([dt] * len(waiting))
        waiting.clear()

    def _drain(self, entry):
        if entry is None:
            return None
        t0 = time.perf_counter()
        if isinstance(entry, list):
            # A mesh's window: its row of the dispatch's packed results
            host, events, j = entry[0]
            host = host[j]
        else:
            host, events = entry
        if events is not None:
            start, copied = events
            copied.synchronize()
            self.window_ms.append(start.elapsed_time(copied))
        max_coa, max_coa_n, max_idx = unpack_detect_window(host.numpy())
        self.fetch_s.append(time.perf_counter() - t0)
        return max_coa, max_coa_n, max_idx, unravel(max_idx, self.node_count)


class QuakeScan:
    """
    Detect and locate earthquakes by migration of onset functions through
    a traveltime lookup table: the detect and locate stages of the JAX
    ``QuakeScan`` on :class:`DetectScan`'s kernel route.

    Detect runs from a waveform archive to the run's ``.scanmseed`` and
    StationAvailability files. Locate reads the TriggeredEvents files of
    the run (or one ``trigger_file``) and writes, per event, its
    ``.event`` and ``.picks`` files (and, as asked, its ``.amps`` file and
    local magnitude, its cut waveforms and its coalescence maps). By
    default it takes the two-pass path: pass 1 is the detect migration
    over the event's window, pass 2 (M1) the marginalisation over the
    marginal window, and the 4-D map is never built. With
    ``write_coalescence`` it takes the map path where the map fits
    ``locate_map_memory_limit``: the map is built (M2 on the card),
    pass 1's outputs are taken from it, and it is marginalised on the
    host.

    Parameters
    ----------
    archive : quakemigrate_torch.io.Archive
    lut : quakemigrate_torch.lut.LUT
    onset : Onset
        Any :class:`~quakemigrate_torch.signal.onsets.Onset`: a
        ``STALTAOnset`` or ``KurtosisOnset`` (the classes themselves, not
        subclasses) takes detect's fused window unless ``fused_detect`` is
        False; any other onset, the deprecated STA/LTA classes among them,
        takes the reference's standard path: ``calculate_onsets(data,
        device=...)`` on the scan's device, then the onsets migrated in
        the canonical slot layout. Anything else raises OnsetTypeError.
    run_path, run_name : str
        The run directory is ``run_path/run_name`` (``run_subname``
        appends a subdirectory name).
    device : str or torch.device, optional
        Where the windows run: the card ("cuda") unless the caller asks
        for the CPU; "cuda" raises where CUDA is absent. With a ``mesh``
        the default is the mesh's first device, and another raises.
    picker : PhasePicker, optional
        Locate's phase picker (default ``GaussianPicker(onset=onset)``).
    mags : LocalMag, optional
        Local magnitudes: with a :class:`~quakemigrate_torch.signal.
        local_mag.LocalMag`, locate measures Wood-Anderson amplitudes
        (the archive needs a response inventory) and writes each event's
        ``.amps`` file and its ML columns of the ``.event``.
    timestep : float, default 120
        Seconds of scan output each detect window adds.
    marginal_window : float, default 2
        Locate's estimate of the origin-time uncertainty, in seconds.
    detect_drain_depth : int, default 8
        Windows dispatched but not yet fetched before the loop waits.
    locate_workers : int, default 4
        Host threads for each event's location math, picks and files,
        which overlap the next events' device work; 0 runs them inline.
    continuous_scanmseed_write : bool, default False
        Write the ``.scanmseed`` after every window, not only at the end
        of a day and of the scan.
    write_cut_waveforms, write_real_waveforms, write_wa_waveforms
        Locate's cut waveforms (``cut_waveform_format``: MSEED, SAC,
        GSE2 or SEGY): raw,
        response-removed and Wood-Anderson (``real_waveform_units`` and
        ``wa_waveform_units``, "displacement" or "velocity").
    write_marginal_coalescence, write_coalescence
        The marginalised 3-D coalescence map and the 4-D map
        ([nx, ny, nz, nsamples] over the event's window) as .npy files.
        The 4-D map takes the map path where ``n_nodes x nsamples`` x
        (4 bytes, or 8 under ``precision="double"``) are within
        ``locate_map_memory_limit`` (default 4e9), else it is logged as
        not written and locate takes the two-pass path.
    plot_event_summary, plot_event_video, plot_all_stns, xy_files
        Locate's figures, drawn as the JAX package draws them (``plot``):
        the event summary PDF from the marginalised map, and the event
        video, an animated GIF of the 4-D map, which
        ``plot_event_video`` keeps as ``write_coalescence`` does (the map
        path, within ``locate_map_memory_limit``; else the video is
        skipped and logged). Where matplotlib cannot be imported, locate
        logs one warning and draws nothing; the device work is the same.
    log, loglevel
        Logging to a file in the run directory, and its level.
    kernel : "auto", "mxu" or "xla", default "auto"
        The reference's migration kernel option. "auto" and "mxu" take
        :func:`detect_route`'s kernel; "xla" (the reference's XLA
        shift-table kernel) takes ``CudaDetectGlobal`` (K3 v2, or K3 on a
        plan too wide for K3 v2's ring), whatever the plan. Other values
        raise ValueError.
    precision : "single" or "double", default "single"
        The element type of the device work: float32, or float64 with
        "double" (the fused blocks, the onsets, the migration, the maps
        and the marginalisation), as the reference's. On the card
        "double" takes the "k3" route whatever ``kernel`` is (with
        "mxu" the reference's notice is logged): K3 v3 f64 on K3 v2
        f64's tables, then M1 ring f64 and M2 ring f64 on them for
        locate, or, on a plan too wide for that ring of doubles, K3 f64,
        M1 f64 and M2 simple f64.
    mesh : quakemigrate_torch.parallel.Mesh, optional
        Shard the grid-node axis over this device mesh
        (``parallel.make_mesh``), as the reference shards it over its JAX
        mesh: each device of the "grid" axis migrates a slab of the
        nodes, and the per-sample max, argmax and sum of the slabs are
        combined on the mesh's first device. On a CUDA mesh each slab runs
        the kernel of the scan's route (``detect_route``: K1 v2, K2 v2 or
        K3 v2/K3, and the float64 kernels with ``precision="double"``) on
        a slab of the plan's tiles; on a CPU mesh the plain reduction on
        flat slabs of the table padded to whole ``tile``s. A "batch" axis
        dispatches detect's fused windows in batches
        (``_mesh_batch_size``), window j on the batch row ``j // (batch
        / rows)``. Locate's pass 1 and pass 2 run on the slabs (each
        slab's M1 v2, or M1, writing its nodes of the [n_nodes] result);
        the map path runs unsharded on the first device. A device may
        repeat: its slabs run in turn.
    fused_detect : bool, default True
        Detect's fused window for ``STALTAOnset`` and ``KurtosisOnset``;
        False takes the standard path (see ``onset``) for them too.
    threads, tile, mxu_encoding, compilation_cache, detect_batch
        The reference's options that change only its speed: accepted,
        validated as the reference validates them (``mxu_encoding`` one
        of "i8x3", "i8x2", "bf16hl"; ``detect_batch`` at least 1), and
        without effect here: the port dispatches one window at a time on
        either path (the reference's batch of windows equals one window
        at a time). With a ``mesh``, as in the reference, ``tile`` is the
        node tile of a CPU mesh's flat slabs, and ``detect_batch`` sets
        the batch of a mesh's "batch" axis (``_mesh_batch_size``).
    time_step, n_cores, sampling_rate
        The reference's deprecated names: ``time_step`` sets
        ``timestep``, ``n_cores`` sets ``threads``, ``sampling_rate``
        sets nothing (the scan rate is the onset's); each prints the
        reference's notice.

    Attributes
    ----------
    detect_scan : DetectScan or None
        The dispatch/drain loop of the last detect (its ``route``,
        ``window_ms``, ``dispatch_s`` and ``fetch_s``).
    detect_batch_attrib : list of dict
        Host seconds of each window of the last detect, as the JAX loop's
        ``detect_batch_attrib`` splits them: ``read_wait`` (waiting on the
        reader thread), ``prepare`` (pre-processing and the channel
        block), ``dispatch`` (upload and launch), ``drain`` (waiting for
        and unpacking the result, and the ``.scanmseed`` append).
    locate_event_attrib : list of dict
        Host seconds of each located event of the last locate: on the main
        thread ``read_wait`` (waiting on the reader thread), ``onsets``
        (pre-processing, the onsets and the onset block), ``pass1`` (the
        migration, its copy back and the origin time), ``pass2`` (M1's
        dispatch and the start of its copy back); on the post thread
        ``pass2_wait`` (waiting for M1's result), ``location`` (the
        location math), ``picks`` and ``writes`` (the .event and the cut
        waveforms and maps); with ``mags``, ``magnitudes`` (amplitudes,
        magnitudes and the .amps file); where the 4-D map was written,
        ``map_write`` on the main thread. On the map path ``pass1`` is
        the map, its reduction and its copy back, ``pass2`` and
        ``pass2_wait`` are 0, and ``location`` includes the map's sum.
    locate_event_marks : list of float
        Main-thread seconds of each located event, as the JAX loop's.
    locate_route : str or None
        The route of locate's pass 1: :func:`detect_route`'s on the card,
        "plain" on the CPU.
    on_window : callable or None
        If set, called as ``on_window(i, block, result)`` for each detect
        window in order after its result is drained (``block`` is the
        channel block the window ran on, or None with ``result`` None for
        a window written as empty).
    on_event : callable or None
        If set, called on the main thread as ``on_event(event, pass1,
        coa_handle)`` for each event whose pass 1 ran: ``pass1`` is its
        (max_coa, max_coa_n, max_idx) numpy arrays over the window,
        ``coa_handle`` pass 2's (:meth:`_dispatch_marginalise`), or None
        for an event outside its marginal window or on the map path; the
        inputs of both passes on the scan's device are
        ``event._marginalise_inputs``, and on the map path
        ``event.map4d`` holds the map (trimmed to the marginal window
        once the event passes the gate).

    """

    _OPTION_DEFAULTS = {
        "timestep": 120.0,
        "marginal_window": 2.0,
        "detect_drain_depth": 8,
        "locate_workers": 4,
        "continuous_scanmseed_write": False,
        "log": False,
        "loglevel": "info",
        "run_subname": "",
        "plot_event_summary": True,
        "plot_event_video": False,
        # Options of the event summary figure
        "plot_all_stns": True,
        "xy_files": None,
        "write_cut_waveforms": False,
        "write_real_waveforms": False,
        "write_wa_waveforms": False,
        "cut_waveform_format": "MSEED",
        "real_waveform_units": "displacement",
        "wa_waveform_units": "displacement",
        "write_marginal_coalescence": False,
        "write_coalescence": False,
        "locate_map_memory_limit": 4e9,
        # The reference's device options, with its defaults. kernel="xla"
        # takes CudaDetectGlobal (K3 v2, or K3); "auto" and "mxu"
        # detect_route's kernel.
        "kernel": "auto",
        # "double": float64 device work, on the "k3" route's float64 forms
        "precision": "single",
        # A parallel.Mesh: the grid-node axis sharded over its devices
        "mesh": None,
        # Host threads of the reference's own C calls; the port has none
        "threads": 1,
        # The reference's XLA node tile: the port's plans fix their tiles;
        # a CPU mesh pads and reduces its flat slabs in it
        "tile": DEFAULT_TILE,
        # The reference's MXU table encoding: the port's kernels gather
        # the onsets in float32
        "mxu_encoding": "i8x2",
        # The reference's XLA compilation cache: the port compiles nothing
        # per run (the kernels are built once, at first use)
        "compilation_cache": True,
        # The fused window for STALTAOnset and KurtosisOnset; False takes
        # the standard path (calculate_onsets, then the migration)
        "fused_detect": True,
        # Windows a dispatch in the reference, a vmap whose results equal
        # one window at a time: the port dispatches one window at a time,
        # on the fused and the standard path
        "detect_batch": 1,
    }

    def __init__(self, archive, lut, onset, run_path, run_name,
                 device=None, **kwargs):
        if not isinstance(onset, Onset):
            raise util.OnsetTypeError
        mesh = kwargs.get("mesh")
        if mesh is None:
            self.device = resolve_device("cuda" if device is None else device)
        else:
            from quakemigrate_torch.parallel import Mesh, check_mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a quakemigrate_torch.parallel"
                                f".Mesh, got {type(mesh).__name__}")
            self.device = check_mesh(mesh).first
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {self.device}")
        self.archive = archive
        self.lut = lut
        self.onset = onset
        self.onset.post_pad = lut.max_traveltime
        for option, default in self._OPTION_DEFAULTS.items():
            setattr(self, option, kwargs.get(option, default))
        self.detect_drain_depth = max(1, int(self.detect_drain_depth))
        self.locate_workers = max(0, int(self.locate_workers))
        self.detect_batch = max(1, int(self.detect_batch))
        if self.kernel not in ("auto", "mxu", "xla"):
            raise ValueError(
                f"kernel must be 'auto', 'mxu' or 'xla', got {self.kernel!r}"
            )
        if self.mxu_encoding not in ("i8x3", "i8x2", "bf16hl"):
            raise ValueError(
                f"mxu_encoding must be 'i8x3', 'i8x2' or 'bf16hl', got "
                f"{self.mxu_encoding!r}"
            )
        picker = kwargs.get("picker")
        if picker is None:
            self.picker = GaussianPicker(onset=onset)
        elif isinstance(picker, PhasePicker):
            self.picker = picker
        else:
            raise util.PickerTypeError
        mags = kwargs.get("mags")
        if mags is not None and not isinstance(mags, LocalMag):
            raise util.MagsTypeError
        self.mags = mags
        self.pre_cut = self.post_cut = None
        self.run = Run(run_path, run_name, self.run_subname,
                       loglevel=self.loglevel)
        self.pre_pad = self.post_pad = 0.0
        self.detect_scan = None
        self.detect_batch_attrib = []
        self.locate_event_attrib = []
        self.locate_event_marks = []
        self.locate_route = None
        self.on_window = None
        self.on_event = None
        self._traveltimes = None
        self._traveltimes_key = None
        self._detect_scan_key = None
        self._route = None
        self._tt_flat = None
        self._locate_detector = None
        self._mesh_locate = None
        # pyplot's state is not thread-safe: the post pool's figures are
        # drawn one at a time
        self._plot_lock = threading.Lock()
        self._draw = False

        # The reference's deprecated parameter names (the properties at
        # the end of the class)
        for legacy in ("time_step", "n_cores", "sampling_rate"):
            setattr(self, legacy, kwargs.get(legacy))

    def __str__(self):
        out = ("\tScan parameters:\n"
               f"\t\tScan sampling rate = {self.scan_rate} Hz\n"
               f"\t\tDevice             = {self.device}\n")
        if self.run.stage == "locate":
            return out + f"\t\tMarginal window    = {self.marginal_window} s\n"
        return out + f"\t\tTime step          = {self.timestep} s\n"

    @property
    def _dtype(self):
        """The numpy element type of the device work: float64 under
        ``precision="double"``, else float32 (the reference's)."""

        return np.float64 if self.precision == "double" else np.float32

    @property
    def _torch_dtype(self):
        return torch.float64 if self.precision == "double" else torch.float32

    @property
    def _fused_active(self):
        """Detect's fused window: ``fused_detect`` and an onset of the
        classes the fused window covers (not a subclass), as the
        reference tests it."""

        return self.fused_detect and type(self.onset) in (STALTAOnset,
                                                          KurtosisOnset)

    @property
    def scan_rate(self):
        """Scan sampling rate: the onset sampling rate (the traveltime
        quantisation and window geometry depend on it)."""

        return self.onset.sampling_rate

    @scan_rate.setter
    def scan_rate(self, value):
        # As the reference: refuse, aloud, an assignment that would break
        # the traveltime quantisation
        if value != self.onset.sampling_rate:
            print(
                "Warning: scan sampling rate is fixed to the onset "
                f"sampling rate ({self.onset.sampling_rate} Hz); "
                f"ignoring {value}."
            )

    def _canonical_slots(self):
        """Phase-major (phase, station) slot ordering for the onset block."""

        return [(phase, station) for phase in self.onset.phases
                for station in self.archive.stations]

    def _traveltime_table(self):
        """Node-major int32 traveltime sample offsets, one column per
        canonical slot, as the JAX ``_build_device_state`` stacks them.
        Built once for the LUT's grid and tables: where they change (an
        in-place ``LUT.decimate``), the table, the route and its plan,
        and the detectors built on them are dropped and built anew."""

        tables = []
        for phase, station in self._canonical_slots():
            try:
                tables.append(self.lut[station][phase])
            except (KeyError, TypeError):
                raise util.LUTPhasesException(
                    f"Attempting to migrate phase {phase} for station "
                    f"{station}; traveltimes not found in the LUT. "
                    f"Please create a new lookup table with phases="
                    f"{self.onset.phases}."
                )
        key = (tuple(self.lut.node_count), self.scan_rate,
               tuple((id(t), t.shape) for t in tables))
        if key != self._traveltimes_key:
            self._traveltimes = traveltime_table(tables, self.scan_rate)
            self._traveltimes_key = key
            self._route = self._tt_flat = self._locate_detector = None
            self.detect_scan = self._mesh_locate = None
        return self._traveltimes

    def _detect_route(self):
        """:func:`detect_route` of the traveltimes on the scan's device,
        built once: detect and locate share its plan."""

        tt = self._traveltime_table()
        if self._route is None:
            if self.kernel == "mxu" and self.precision == "double":
                # The reference's notice (its _build_device_state)
                logging.info(
                    "\tkernel='mxu' computes in reduced-precision table "
                    "encodings (~f32 accurate); precision='double' keeps "
                    "the XLA shift-table kernel.")
            self._route = detect_route(tt, tuple(self.lut.node_count),
                                       self.device, self.kernel,
                                       self.precision)
        return self._route

    def _front_end_settings(self):
        """(front end factory, settings) of detect's windows
        (``ops.scan_window``) for this scan's onset and timestep: the
        onset's fused front end, or on the standard path
        ``onset_front_end``."""

        if not self._fused_active:
            return onset_front_end, ()
        if isinstance(self.onset, KurtosisOnset):
            return (kurtosis_front_end,
                    self.onset.fused_static_args(self.timestep))
        return stalta_front_end, (self.onset.position,
                                  self.onset.signal_transform,
                                  float(self.onset.min_onset_value))

    def _detect_scan(self, fsmp, lsmp):
        """The DetectScan of this scan geometry and onset front end,
        built once and kept while they hold."""

        route = self._detect_route()
        factory, settings = self._front_end_settings()
        # The reference batches a mesh's fused windows only
        batch = self._mesh_batch_size() if self._fused_active else None
        key = (fsmp, lsmp, factory, settings, batch)
        scan = self.detect_scan
        if scan is None or self._detect_scan_key != key:
            scan = self.detect_scan = DetectScan(
                self._traveltime_table(), tuple(self.lut.node_count), fsmp,
                lsmp, front_end=factory(*settings), device=self.device,
                drain_depth=self.detect_drain_depth, route=route,
                dtype=self._torch_dtype, mesh=self.mesh, tile=self.tile,
                batch=batch,
            )
            self._detect_scan_key = key
        return scan

    def _mesh_batch_size(self):
        """
        Fixed window-batch size for the fused batch x grid mesh path, or
        None when no mesh batch axis exists. Rounded up to a whole
        multiple of the mesh's batch extent so windows shard evenly
        (inert pad windows fill the remainder); at least one window per
        batch shard, so a 2-D mesh batches windows even at the default
        detect_batch=1.

        """

        if self.mesh is None or "batch" not in self.mesh.axis_names:
            return None
        nb = self.mesh.shape["batch"]
        return -(-max(self.detect_batch, nb) // nb) * nb

    def _detect_batch_size(self):
        """Windows per detect dispatch: detect_batch on one device (the
        port dispatches them one at a time, which the reference's batch
        equals); under a mesh, 1 unless the mesh has a "batch" axis (then
        the rounded window batch shards over it)."""

        if self.mesh is None:
            return self.detect_batch
        return self._mesh_batch_size() or 1

    def _mesh_locate_detect(self):
        """Locate's ``parallel.MeshDetect`` on the mesh (its first batch
        row), on the slabs of detect's route and plan, built once for the
        table."""

        if self._mesh_locate is None:
            from quakemigrate_torch.parallel import MeshDetect, scan_slabs

            route, _, plan = self._detect_route()
            self._mesh_locate = MeshDetect(self.mesh, scan_slabs(
                self.mesh, self._traveltime_table(), route, plan, self.tile,
                dtype=self._torch_dtype), int(np.prod(self.lut.node_count)))
        return self._mesh_locate

    # ------------------------------------------------------------------
    # detect
    # ------------------------------------------------------------------

    def detect(self, starttime, endtime, resume=False):
        """
        Continuous coalescence scan between two timestamps, writing the
        .scanmseed stream and the station availability tables.

        With ``resume=True``, the whole timesteps already present in the
        run's .scanmseed output are skipped: the scan fast-forwards to the
        first missing timestep (on the original timestep grid) and appends
        to the partially written day. Availability tables merge with the
        rows on disk, so a crashed scan restarts where it stopped.

        """

        self.run.stage = "detect"
        self.run.logger(self.log)

        starttime, endtime = UTCDateTime(starttime), UTCDateTime(endtime)
        if starttime >= endtime:
            raise util.TimeSpanException
        if endtime.time == clock_time(0, 0):
            endtime = endtime - 1 / self.scan_rate

        seed_stream = None
        if resume:
            starttime, seed_stream = self._detect_resume_state(
                starttime, endtime)
            if starttime is None:
                logging.info("\tNothing to resume: the requested span is "
                             "already fully scanned.")
                return
            logging.info(f"\tResuming detect from {starttime}.")

        n_steps = int(np.ceil((endtime - starttime) / self.timestep))
        calc_endtime = starttime + n_steps * self.timestep - 1 / self.scan_rate
        if calc_endtime - endtime > 1 / self.scan_rate:
            logging.info(
                f"Warning: chosen run duration {endtime - starttime} s is "
                f"not divisible by the specified timestep {self.timestep} s. "
                f"Detect will instead compute up to {calc_endtime}\n"
            )
        self._announce("\tDETECT - Continuous coalescence scan", [
            f"\n\tScanning from {starttime} to {calc_endtime}\n", self,
            str(self.onset)])

        self.detect_batch_attrib = []
        self._continuous_compute(starttime, n_steps, seed_stream)
        logging.info(util.log_spacer)

    @staticmethod
    def _announce(title, details):
        """Stage banner: spacer / title / spacer / details / spacer."""

        for line in (util.log_spacer, title, util.log_spacer, *details,
                     util.log_spacer):
            logging.info(line)

    def _detect_resume_state(self, starttime, endtime):
        """
        (new_starttime, seed_stream) for a resumed detect: fast-forward past
        whole timesteps already on disk, and preload the partially written
        day's stream so appends don't clobber it. (None, None) when the
        whole span is already scanned.

        """

        outdir = self.run.path / "detect" / "scanmseed"
        delta = 1.0 / self.scan_rate

        # Walk the days forward and require contiguous coverage from
        # starttime: a day file left by an unrelated earlier run (or one
        # preceded by an unscanned gap) must not fast-forward past work
        # that was never done.
        covered_to = starttime
        last_stream = None
        day = UTCDateTime(starttime.date)
        while day <= endtime:
            candidate = outdir / f"{day.year}_{day.julday:03d}.scanmseed"
            if not candidate.is_file():
                break
            try:
                on_disk = read(str(candidate))
                coa = on_disk.select(station="COA")[0]
            except (TypeError, ValueError, IndexError, OSError):
                # A crash mid-write can leave a truncated or empty day
                # file: exactly the state resume exists to recover from.
                logging.info(
                    f"\tResume: unreadable partial file {candidate}; "
                    f"rescanning from {covered_to}."
                )
                break
            if coa.stats.starttime > covered_to:
                break  # gap before this file: not this run's coverage
            if coa.stats.endtime + delta <= covered_to:
                break  # file ends before the requested span begins
            covered_to = coa.stats.endtime + delta
            last_stream = on_disk
            day = day + 86400

        done_steps = int(
            np.floor((covered_to - starttime) / self.timestep + 1e-9)
        )
        if done_steps <= 0:
            return starttime, None
        new_start = starttime + done_steps * self.timestep
        if new_start > endtime:
            return None, None

        # Seed only when appending into the same (partial) day, and trim
        # the seed to the whole-timestep boundary: the recomputed partial
        # step may differ by a count from the crashed run's values, and
        # ScanmSEED's merge refuses conflicting overlaps.
        seed = None
        if (last_stream is not None
                and new_start.date == last_stream[0].stats.starttime.date):
            seed = Stream()
            for tr in last_stream:
                seed += tr
            seed.trim(endtime=new_start - delta)
        return new_start, seed

    def _continuous_compute(self, starttime, n_steps, seed_stream=None):
        coalescence = ScanmSEED(
            self.run, self.continuous_scanmseed_write, self.scan_rate
        )
        if seed_stream is not None:
            # Resumed mid-day: carry the already-written part of the day
            # so the day-file write includes it.
            coalescence.stream = seed_stream
        self.pre_pad, self.post_pad = self.onset.pad(self.timestep)
        availability_cols = [f"{station}_{phase}"
                             for phase in self.onset.phases
                             for station in self.archive.stations]
        availability = {}

        def window(i):
            w_beg = starttime + self.timestep * i - self.pre_pad
            w_end = (starttime + self.timestep * (i + 1)
                     - 1 / self.scan_rate + self.post_pad)
            return w_beg, w_end

        scan = self._detect_scan(
            util.time2sample(self.pre_pad, self.scan_rate),
            util.time2sample(self.post_pad, self.scan_rate),
        )
        # Archive reads run on one worker thread, two windows ahead of the
        # window being prepared, while the device migrates earlier windows.
        reader = ThreadPoolExecutor(max_workers=1)
        reads = {i: reader.submit(self.archive.read_waveform_data, *window(i))
                 for i in range(min(2, n_steps))}
        try:
            self._detect_loop(scan, reader, reads, coalescence, availability,
                              availability_cols, starttime, n_steps, window)
        finally:
            # On failure paths too: stop the reader behind the traceback.
            reader.shutdown(wait=False, cancel_futures=True)

        if not coalescence.written:
            coalescence.write()
        write_availability(self.run, availability, availability_cols)

    def _detect_loop(self, scan, reader, reads, coalescence, availability,
                     availability_cols, starttime, n_steps, window):
        """Read and prepare each window, run the blocks through
        ``scan``'s dispatch/drain loop, and write each result in order."""

        ucf = self.lut.unit_conversion_factor
        attrib = self.detect_batch_attrib
        # Per window, in order: (i, window start, availability row, the
        # skip message of a window written as empty, its block)
        meta = deque()

        def blocks():
            for i in range(n_steps):
                if i + 1 < n_steps and i + 1 not in reads:
                    reads[i + 1] = reader.submit(
                        self.archive.read_waveform_data, *window(i + 1))
                w_beg, w_end = window(i)
                logging.info((f" Processing : {w_beg + self.pre_pad}-"
                              f"{w_end - self.post_pad} ").center(110, "~"))
                t0 = time.perf_counter()
                t1 = None
                try:
                    data = reads.pop(i).result()
                    t1 = time.perf_counter()
                    block, avail_row = self._prepare_window(data)
                except (util.ArchiveEmptyException, util.DataGapException,
                        util.DataAvailabilityException) as e:
                    t2 = time.perf_counter()
                    t1 = t2 if t1 is None else t1
                    attrib.append({"n": 1, "read_wait": t1 - t0,
                                   "prepare": t2 - t1})
                    meta.append((i, None, None, e.msg, None))
                    yield None
                    continue
                t2 = time.perf_counter()
                attrib.append({"n": 1, "read_wait": t1 - t0,
                               "prepare": t2 - t1})
                meta.append((i, data.starttime, avail_row, None,
                             block if self.on_window is not None else None))
                yield block

        drained = 0
        for result in scan.stream(blocks()):
            i, win_start, avail_row, msg, block = meta.popleft()
            t0 = time.perf_counter()
            step_label = str(starttime + self.timestep * i)
            if result is None:
                coalescence.empty(starttime, self.timestep, i,
                                  msg or util.DataAvailabilityException.msg,
                                  ucf)
                availability[step_label] = dict.fromkeys(availability_cols, 0)
                attrib[i].update(dispatch=0.0, drain=0.0)
            else:
                max_coa, max_coa_n, _, ijk = result
                coalescence.append(
                    win_start + self.pre_pad,
                    np.asarray(max_coa, dtype=np.float64),
                    np.asarray(max_coa_n, dtype=np.float64),
                    self.lut.index2coord(ijk), ucf,
                )
                availability[step_label] = avail_row
                attrib[i].update(
                    dispatch=scan.dispatch_s[drained],
                    drain=scan.fetch_s[drained] + time.perf_counter() - t0,
                )
                drained += 1
            if self.on_window is not None:
                self.on_window(i, block, result)

    def _prepare_window(self, data):
        """The stage of one detect window before its dispatch: its block
        and its availability row. On the fused path the onset's channel
        block (``prepare_device_inputs`` in the scan's dtype); on the
        standard path the onsets of ``calculate_onsets`` on the scan's
        device, scattered into the canonical slot layout in the scan's
        dtype (:meth:`_device_inputs`), as the block ``(onsets,
        available, slot_mask)`` of ``ops.scan_window.onset_front_end``. A
        window with no live slot raises DataAvailabilityException before
        any migration."""

        if self._fused_active:
            *block, availability = self.onset.prepare_device_inputs(
                data, self._canonical_slots(), dtype=self._dtype)
            if block[2].sum() == 0:
                raise util.DataAvailabilityException
            return tuple(block), availability
        onsets, onset_data = self.onset.calculate_onsets(data,
                                                         device=self.device)
        block, mask, available = self._device_inputs(onsets, onset_data)
        if available == 0:
            raise util.DataAvailabilityException
        return ((block, np.asarray(available, dtype=self._dtype), mask),
                onset_data.availability)

    # ------------------------------------------------------------------
    # locate
    # ------------------------------------------------------------------

    def locate(self, starttime=None, endtime=None, trigger_file=None):
        """
        Re-migrate short windows around triggered events on the full grid;
        compute locations, uncertainties and picks, and write each event's
        ``.event`` and ``.picks`` files.

        """

        self.run.stage = "locate"
        self.run.logger(self.log)

        if trigger_file is None and starttime is None and endtime is None:
            raise RuntimeError("Must supply an input argument.")
        if (starttime is None) ^ (endtime is None):
            raise RuntimeError("Must supply a starttime AND an endtime.")
        if starttime is not None:
            starttime, endtime = UTCDateTime(starttime), UTCDateTime(endtime)
            if starttime > endtime:
                raise util.TimeSpanException
        self._probe_figures()

        if trigger_file is not None:
            span = f"\n\tLocating events in {trigger_file}"
        else:
            span = f"\n\tLocating events from {starttime} to {endtime}\n"
        details = [span, self, str(self.onset), str(self.picker)]
        if self.mags is not None:
            details += [self.archive.__str__(response_only=True),
                        str(self.mags)]
        self._announce(
            "\tLOCATE - Determining event location and uncertainty", details
        )
        if trigger_file is not None:
            self._locate_events(trigger_file=trigger_file)
        else:
            self._locate_events(starttime=starttime, endtime=endtime)
        logging.info(util.log_spacer)

    def _probe_figures(self):
        """Whether locate draws its figures: matplotlib is probed once, and
        where a figure option is on and it cannot be imported, one warning
        names the options whose figures will not be drawn."""

        options = [name for name, on in (
            ("plot_event_summary", self.plot_event_summary),
            ("plot_event_video", self.plot_event_video),
            ("plot_picks", getattr(self.picker, "plot_picks", False)),
            ("plot_amplitudes", self.mags is not None
             and getattr(self.mags, "plot", False))) if on]
        self._draw = plot.available()
        if options and not self._draw:
            plot.missing_warning("locate", options)

    def _locate_events(self, **kwargs):
        candidates = read_triggered_events(self.run, **kwargs)
        total = len(candidates)

        self.pre_pad, self.post_pad = self.onset.pad(4 * self.marginal_window)
        events = [Event(self.marginal_window, row)
                  for row in candidates.rows()]

        # Archive reads for the next event overlap the current event's
        # device work and the post pool's host work.
        reader = ThreadPoolExecutor(max_workers=1)
        pending = {}

        def submit_read(j):
            if 0 <= j < len(events) and j not in pending:
                half_span = 2 * self.marginal_window
                w_beg = events[j].trigger_time - half_span - self.pre_pad
                w_end = events[j].trigger_time + half_span + self.post_pad
                pending[j] = reader.submit(
                    self._read_event_waveform_data, w_beg, w_end
                )

        n_workers = self.locate_workers
        post = (ThreadPoolExecutor(max_workers=n_workers)
                if n_workers else None)
        finishes = []  # submitted-but-unjoined post-processing futures

        self.locate_event_marks = []
        self.locate_event_attrib = []
        t_mark = time.perf_counter()
        try:
            submit_read(0)
            for i, event in enumerate(events):
                submit_read(i + 1)
                logging.info(util.log_spacer)
                logging.info(f"\tEVENT - {i + 1} of {total} - {event.uid}")
                logging.info(util.log_spacer)
                attrib = {}
                ok, coa_handle = self._locate_prepare(event, pending.pop(i),
                                                      attrib)
                if not ok:
                    continue
                self.locate_event_attrib.append(attrib)
                if post is None:
                    self._locate_finish(event, coa_handle, attrib)
                    logging.info(util.log_spacer)
                else:
                    # Backpressure: the device loop runs at most 2 x
                    # workers events ahead of the post pool (host memory
                    # holds each in-flight event's waveforms).
                    finishes.append(post.submit(self._locate_finish, event,
                                                coa_handle, attrib))
                    while len(finishes) > 2 * n_workers:
                        finishes.pop(0).result()
                now = time.perf_counter()
                self.locate_event_marks.append(now - t_mark)
                t_mark = now
            while finishes:
                finishes.pop(0).result()
        finally:
            reader.shutdown(wait=False, cancel_futures=True)
            if post is not None:
                post.shutdown(wait=True, cancel_futures=True)

    def _locate_prepare(self, event, waveform_read, attrib):
        """
        Device-facing stage of one candidate, on the main thread: the
        waveform read, the onsets, pass 1, the marginal-window gate, the
        trim, and the dispatch of pass 2. Returns ``(ok, coa_handle)``
        (:meth:`_dispatch_marginalise`).

        """

        t0 = time.perf_counter()
        try:
            logging.info("\tReading waveform data...")
            event.add_waveform_data(waveform_read.result())
            attrib["read_wait"] = time.perf_counter() - t0
            logging.info("\tComputing 4-D coalescence function...")
            event.add_compute_output(*self._compute(event.data, event,
                                                    attrib))
        except (
            util.ArchiveEmptyException,
            util.DataGapException,
            util.DataAvailabilityException,
        ) as e:
            logging.info(e.msg)
            return False, None

        if self.write_coalescence:
            if event.map4d is not None:
                logging.info("\tSaving full coalescence map...")
                t0 = time.perf_counter()
                write_coalescence(self.run, event.map4d, event)
                attrib["map_write"] = time.perf_counter() - t0
            else:
                logging.info(
                    "\tmap4d not retained (two-pass locate); raise "
                    "locate_map_memory_limit to write the full map."
                )

        pass1 = event._pass1
        if not event.in_marginal_window():
            if self.on_event is not None:
                self.on_event(event, pass1, None)
            return False, None
        event.trim2window()
        t0 = time.perf_counter()
        coa_handle = self._dispatch_marginalise(event)
        attrib["pass2"] = time.perf_counter() - t0
        if self.on_event is not None:
            self.on_event(event, pass1, coa_handle)
        return True, coa_handle

    def _device_inputs(self, onsets, onset_data):
        """
        Scatter the computed onsets [n, T] into the fixed canonical slot
        layout on the scan's device, in the scan's dtype (float32, or
        float64 under ``precision="double"``), as the reference's
        ``_device_inputs``, and build the availability mask: (block
        [n_slots, T] tensor, mask [n_slots] numpy, available). Each slot's
        row is ``onsets[OnsetData.rows[key]]`` where the onset gives
        ``rows`` (the port's onsets), else ``OnsetData.onsets[station]
        [phase]``, a numpy array or a tensor (the reference's contract of
        ``calculate_onsets``, which a user's onset may follow).

        """

        slots = {f"{station}_{phase}": s for s, (phase, station)
                 in enumerate(self._canonical_slots())}
        dtype = self._torch_dtype
        mask = np.zeros(len(slots), dtype=self._dtype)
        rows = [(slots[f"{station}_{phase}"], station, phase)
                for station, phase_onsets in onset_data.onsets.items()
                for phase in phase_onsets]
        for slot, _, _ in rows:
            mask[slot] = 1.0
        t_len = onsets.shape[-1]
        if onset_data.rows is not None and torch.is_tensor(onsets):
            idx = [onset_data.rows[f"{station}_{phase}"]
                   for _, station, phase in rows]
            block = torch.ones((len(slots), t_len), dtype=dtype,
                               device=self.device)
            block[torch.tensor([r[0] for r in rows], device=self.device)] = (
                onsets.to(self.device)[torch.tensor(idx, device=self.device)]
                .to(dtype))
        else:
            host = np.ones((len(slots), t_len), dtype=self._dtype)
            for slot, station, phase in rows:
                row = onset_data.onsets[station][phase]
                host[slot] = (row.cpu().numpy() if torch.is_tensor(row)
                              else row)
            block = torch.from_numpy(host).to(self.device)
        return block, mask, float(mask.sum())

    def _flat_traveltimes(self):
        """The traveltimes as a CPU tensor, for the plain CPU path."""

        if self._tt_flat is None:
            self._tt_flat = torch.from_numpy(self._traveltime_table())
        return self._tt_flat

    @util.timeit("info")
    def _compute(self, data, event, attrib):
        """
        One locate window: the onsets on the scan's device and pass 1, the
        per-sample max, normalised max and argmax node over the window.
        Keeps the inputs of pass 2 on the event (``_marginalise_inputs``)
        and pass 1's result (``_pass1``).

        Two paths, as the JAX ``_compute`` chooses them. The map path,
        where ``write_coalescence`` or ``plot_event_video`` is set and
        the map's ``n_nodes x nsamples`` x the element's bytes are within
        ``locate_map_memory_limit``: the 4-D map (M2 on the card: the route's detector's ``map``; the plain
        ``migrate_map`` on the CPU), pass 1's outputs from it
        (``find_max_coa``, on the map's device), and the map copied back
        through a pinned buffer as [nx, ny, nz, nsamples]. Otherwise the
        two-pass path's pass 1: on the card the detect kernel of the
        scan's route (K1 v2, or K2 v2 on a plan K1 v2 refuses, or K3 v2
        (K3 on a plan too wide for its ring) on a plan neither takes or
        with ``kernel="xla"``); on the CPU the
        plain flat-order migration.

        """

        t0 = time.perf_counter()
        onsets, onset_data = self.onset.calculate_onsets(
            data, device=self.device)
        block, mask, available = self._device_inputs(onsets, onset_data)
        mask = torch.from_numpy(mask).to(self.device)
        fsmp = util.time2sample(self.pre_pad, onset_data.sampling_rate)
        lsmp = util.time2sample(self.post_pad, onset_data.sampling_rate)
        nsamples = block.shape[-1] - fsmp - lsmp
        t1 = time.perf_counter()

        n_nodes = int(np.prod(self.lut.node_count))
        map_bytes = n_nodes * nsamples * np.dtype(self._dtype).itemsize
        want_map = self.write_coalescence or self.plot_event_video
        retain_map = want_map and map_bytes <= self.locate_map_memory_limit
        if want_map and not retain_map:
            logging.info(
                f"\t\tmap4d would need {map_bytes / 1e9:.1f} GB > "
                "locate_map_memory_limit; using two-pass map-free "
                "locate (no full map / event video will be written)."
            )

        inputs = {"block": block, "mask": mask, "available": available,
                  "fsmp": fsmp, "nsamples": nsamples}
        route, _, plan = self._detect_route()
        self.locate_route = route
        map_host = None
        if self.mesh is not None and not retain_map:
            # Pass 1 on the mesh's slabs; pass 2 takes their inputs
            mesh_detect = self._mesh_locate_detect()
            inputs["mesh"] = mesh_detect.prepare(block, mask, available,
                                                 fsmp, nsamples)
            result = mesh_detect.reduce(inputs["mesh"], fsmp, nsamples)
        elif route == "plain":
            if retain_map:
                map_flat = migrate_map(block, self._flat_traveltimes(), mask,
                                       available, fsmp, nsamples)
                result = find_max_coa(map_flat)
                map_host = map_flat
            else:
                result = migrate_detect(block, self._flat_traveltimes(), mask,
                                        available, fsmp, nsamples)
        else:
            # Pass 1's detector: one per locate geometry, as the JAX
            # _mxu_kernel caches one, on detect's route and plan
            detector = self._locate_detector = route_detector(
                route, plan, self._traveltime_table(),
                tuple(self.lut.node_count), fsmp, nsamples, self.device,
                cached=self._locate_detector, dtype=self._torch_dtype,
            )
            onsets_log, inv_available = detector.prepare(block, mask,
                                                         available)
            inputs.update(onsets_log=onsets_log, inv_available=inv_available)
            if retain_map:
                map_flat = detector.map(onsets_log, inv_available)
                result = find_max_coa(map_flat)
                # Queued before pass 1's copy below, which waits for it
                map_host = torch.empty(map_flat.shape, dtype=map_flat.dtype,
                                       pin_memory=True)
                map_host.copy_(map_flat, non_blocking=True)
            else:
                max_coa, max_idx, coa_sum = detector.reduce_log(
                    onsets_log, inv_available)
                result = (max_coa, max_coa * detector.n_nodes / coa_sum,
                          max_idx)
        # One copy of the three outputs to the host
        max_coa, max_coa_n, max_idx = unpack_detect_window(
            pack_detect_window(*result).cpu())
        event._marginalise_inputs = inputs
        event._pass1 = (max_coa, max_coa_n, max_idx)
        map4d = None
        if map_host is not None:
            map4d = map_host.numpy().reshape(
                tuple(self.lut.node_count) + (nsamples,))

        coord = self.lut.index2coord(max_idx, unravel=True)
        times = event.mw_times(self.scan_rate, count=nsamples)
        attrib["onsets"] = t1 - t0
        attrib["pass1"] = time.perf_counter() - t1
        return (
            times,
            np.asarray(max_coa, dtype=np.float64),
            np.asarray(max_coa_n, dtype=np.float64),
            coord,
            map4d,
            onset_data,
        )

    def _dispatch_marginalise(self, event):
        """
        Pass 2 for a trimmed event: the coalescence summed over the
        marginal window ``[first, last)`` of ``trim_bounds``, [n_nodes]
        in flat node order. On the card M1 runs on the main thread and its
        result is copied to a pinned host buffer after a recorded CUDA
        event; returns (host buffer, event), and the post thread waits on
        the event. On the CPU the plain version runs: (result, None). On
        the map path (``event.map4d`` kept) there is no pass 2: None.

        """

        if event.map4d is not None:
            return None
        inputs = event._marginalise_inputs
        i0, i1 = event.trim_bounds
        if self.mesh is not None:
            # Each slab's marginalisation writes its nodes of the result
            marginal = self._mesh_locate_detect().marginalise(
                inputs["mesh"], inputs["fsmp"], inputs["nsamples"], i0,
                i1 - i0)
            if self.device.type != "cuda":
                return marginal, None
        elif self.device.type != "cuda":
            return migrate_marginalise(
                inputs["block"], self._flat_traveltimes(), inputs["mask"],
                inputs["available"], inputs["fsmp"], inputs["nsamples"], i0,
                i1 - i0,
            ), None
        else:
            marginal = self._locate_detector.marginalise(
                inputs["onsets_log"], inputs["inv_available"], i0, i1 - i0)
        host = torch.empty(marginal.shape, dtype=marginal.dtype,
                           pin_memory=True)
        host.copy_(marginal, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(self.device))
        return host, copied

    def _locate_finish(self, event, coa_handle, attrib):
        """
        Host post-processing of one migrated candidate, on a
        ``locate_workers`` pool thread (or inline): wait for pass 2's
        result, then location and uncertainty, picks and the output
        files. Issues no work on the card.

        """

        t0 = time.perf_counter()
        marginal = None
        if coa_handle is not None:
            marginal, copied = coa_handle
            if copied is not None:
                copied.synchronize()
            marginal = marginal.numpy()
        t1 = time.perf_counter()
        logging.info(f"\t[{event.uid}] Determining event location and "
                     "uncertainty...")
        coa_map = self._calculate_location(event, marginal)
        t2 = time.perf_counter()

        if self.write_marginal_coalescence:
            logging.info(f"\t[{event.uid}] Saving marginalised coalescence "
                         "map...")
            write_coalescence(self.run, coa_map, event, marginalised=True)
        t3 = time.perf_counter()

        logging.info(f"\t[{event.uid}] Making phase picks...")
        # Where the picker or the magnitudes draw, that stage holds the
        # lock the event figures hold; figure-free runs stay parallel
        with self._figure_guard(getattr(self.picker, "plot_picks", False)):
            event, _ = self.picker.pick_phases(event, self.lut, self.run)
        t4 = time.perf_counter()

        if self.mags is not None:
            logging.info(f"\t[{event.uid}] Calculating magnitude...")
            with self._figure_guard(getattr(self.mags, "plot", False)):
                event, _ = self.mags.calc_magnitude(event, self.lut,
                                                    self.run)
            attrib["magnitudes"] = time.perf_counter() - t4
        t5 = time.perf_counter()

        event.write(self.run, self.lut)
        if self._draw:
            with self._plot_lock:
                self._write_event_figures(event, coa_map)
        self._write_event_waveforms(event)
        attrib.update(pass2_wait=t1 - t0, location=t2 - t1, picks=t4 - t3,
                      writes=(t3 - t2) + (time.perf_counter() - t5))
        return True

    def _figure_guard(self, draws):
        """The figure lock where a stage draws, else no lock."""

        return (self._plot_lock if draws and self._draw
                else contextlib.nullcontext())

    def _write_event_figures(self, event, coa_map):
        """The event summary from the marginalised map, and the event
        video from the kept 4-D map (skipped and logged where the map was
        not kept)."""

        if self.plot_event_summary:
            from quakemigrate_torch.plot.event import event_summary

            event_summary(
                self.run, event, coa_map, self.lut,
                xy_files=self.xy_files, plot_all_stns=self.plot_all_stns,
            )
        if self.plot_event_video:
            if event.map4d is None:
                logging.info(
                    "\tSkipping event video: map4d was not retained "
                    "(its size exceeds locate_map_memory_limit)."
                )
            else:
                from quakemigrate_torch.plot.video import event_video

                event_video(self.run, event, self.lut)

    def _write_event_waveforms(self, event):
        """The cut waveforms asked for: raw, response-removed ("real") and
        Wood-Anderson, each in its own directory."""

        flavours = (
            (self.write_cut_waveforms, {}),
            (self.write_real_waveforms,
             dict(waveform_type="real", units=self.real_waveform_units)),
            (self.write_wa_waveforms,
             dict(waveform_type="wa", units=self.wa_waveform_units)),
        )
        for enabled, extras in flavours:
            if enabled:
                write_cut_waveforms(
                    self.run, event, self.cut_waveform_format,
                    pre_cut=self.pre_cut, post_cut=self.post_cut, **extras,
                )

    @util.timeit("info")
    def _read_event_waveform_data(self, w_beg, w_end):
        """Read waveform data for one event, with the magnitude pads and
        the cut pads if set."""

        pre_pad = post_pad = 0.0
        if self.mags is not None:
            pre_pad, post_pad = self.mags.amp.pad(
                self.marginal_window,
                self.lut.max_traveltime,
                self.lut.fraction_tt,
            )

        if self.pre_cut:
            pre_pad = max(pre_pad, self.pre_cut)
        if self.post_cut:
            post_pad = max(post_pad, self.post_cut)

        pre_pad = max(0.0, pre_pad - self.marginal_window - self.pre_pad)
        post_pad = max(0.0, post_pad - self.marginal_window - self.post_pad)

        return self.archive.read_waveform_data(w_beg, w_end, pre_pad, post_pad)

    # ------------------------------------------------------------------
    # Location estimation (host-side post-processing of the 3-D map), as
    # the JAX package computes it, in float64 numpy and scipy
    # ------------------------------------------------------------------

    @util.timeit("info")
    def _calculate_location(self, event, marginal):
        """
        From the marginalised map (flat, [n_nodes]; or, on the map path,
        with ``marginal`` None, the kept map4d summed over its samples in
        its own type, as the JAX map path sums it), compute the three
        location estimates: interpolated spline peak, 3-D Gaussian fit,
        and global covariance. Returns the normalised map (nx, ny, nz).

        """

        if event.map4d is not None:
            coa_map = np.sum(event.map4d, axis=-1)
        else:
            coa_map = np.asarray(marginal, dtype=np.float64).reshape(
                tuple(self.lut.node_count))
        coa_map = coa_map / np.nanmax(coa_map)

        event.add_spline_location(self._splineloc(np.copy(coa_map)))

        smoothed_coa_map = self._gaufilt3d(np.copy(coa_map))
        event.add_gaussian_location(*self._gaufit3d(smoothed_coa_map))

        event.add_covariance_location(*self._covfit3d(np.copy(coa_map)))

        return coa_map

    @staticmethod
    def _peak_window(shape, centre, width):
        """(lo, hi) corners of a width^3 box around ``centre``, grid-clipped."""

        half = (width - 1) // 2
        shape, centre = np.asarray(shape), np.asarray(centre)
        lo = np.clip(centre - half, 0, shape)
        hi = np.clip(centre + half + 1, 0, shape)
        return lo, hi

    @util.timeit()
    def _splineloc(self, coa_map, win=5, upscale=10):
        """
        Sub-node location: cubic RBF fit over a win^3 box at the gridded
        peak, evaluated on an ``upscale``-times-finer lattice.

        """

        peak = np.unravel_index(np.nanargmax(coa_map), coa_map.shape)
        lo, hi = self._peak_window(coa_map.shape, peak, win)
        spans = hi - lo

        if not (spans[0] == spans[1] == spans[2]):
            logging.info(
                "\t !!!! Spline error: interpolation window crosses edge of "
                "grid !!!!"
            )
            return self.lut.index2coord([list(peak)])[0]

        box = coa_map[tuple(slice(a, b) for a, b in zip(lo, hi))]

        # Cubic RBF (phi = r^3) fit at the coarse lattice points, evaluated
        # on the upscaled lattice; the fine-point distances come from one
        # (M,3)@(3,125) product via |x-c|^2 = |x|^2 + |c|^2 - 2x.c.
        coarse = np.indices(box.shape, dtype=np.float64).reshape(3, -1).T
        gram_d2 = (
            (coarse[:, None, :] - coarse[None, :, :]) ** 2
        ).sum(-1)
        gram = gram_d2 * np.sqrt(gram_d2)
        values = box.ravel().astype(np.float64)
        try:
            weights = np.linalg.solve(gram, values)
        except np.linalg.LinAlgError:
            weights = np.linalg.lstsq(gram, values, rcond=None)[0]

        fine_axes = [
            np.linspace(0, dim - 1, (dim - 1) * upscale + 1)
            for dim in box.shape
        ]
        fine = np.meshgrid(*fine_axes, indexing="ij")
        pts = np.stack([g.ravel() for g in fine], axis=1)
        d2 = (
            (pts**2).sum(1)[:, None]
            + (coarse**2).sum(1)[None, :]
            - 2.0 * (pts @ coarse.T)
        )
        np.maximum(d2, 0.0, out=d2)
        sampled = ((d2 * np.sqrt(d2)) @ weights).reshape(fine[0].shape)

        refined = (
            np.asarray(np.unravel_index(np.nanargmax(sampled), sampled.shape))
            / upscale
            + lo
        )
        logging.debug("\t\tGridded loc: {}   {}   {}".format(*peak))
        logging.debug("\t\tSpline  loc: {} {} {}".format(*refined))

        drift = np.abs(np.asarray(peak) - refined)
        if (drift > 1).any():
            logging.debug(
                "\tSpline warning: spline location outside grid cell "
                "with maximum coalescence value"
            )
        if (drift > (win - 1) // 2).any():
            logging.info(
                "\t !!!! Spline error: location outside interpolation "
                "window !!!!"
            )
            return self.lut.index2coord([list(peak)])[0]

        return self.lut.index2coord([list(refined)])[0]

    @util.timeit()
    def _gaufit3d(self, coa_map, thresh=0.0, win=7):
        """
        3-D Gaussian fit (a quadratic form in log space) over a win^3 box at
        the peak of the smoothed map; returns (location, 1-sigma errors).

        """

        peak = np.unravel_index(np.nanargmax(coa_map), coa_map.shape)
        in_fit = (coa_map > thresh) & self._mask3d(coa_map.shape, peak, win)
        nodes = np.where(in_fit)

        values = (coa_map - np.nanmean(coa_map)).astype(np.float64)[nodes]
        neg_log = -np.log(np.clip(values, 1e-300, np.inf))

        # Design matrix rows: x², y², z², xy, xz, yz, x, y, z, 1 — offsets
        # are measured from the peak node.
        x, y, z = (idx - c for idx, c in zip(nodes, peak))
        design = np.stack(
            [x * x, y * y, z * z, x * y, x * z, y * z, x, y, z,
             np.ones(x.size)]
        )
        P = np.matmul(neg_log, np.linalg.pinv(design))
        quad, cross, linear = P[:3], P[3:6], P[6:9]

        def symmetric(diagonal, off_scale):
            m = np.diag(diagonal).astype(float)
            m[0, 1] = m[1, 0] = cross[0] * off_scale
            m[0, 2] = m[2, 0] = cross[1] * off_scale
            m[1, 2] = m[2, 1] = cross[2] * off_scale
            return m

        curvature = -symmetric(2 * quad, 1.0)
        offset = np.matmul(np.linalg.inv(curvature), linear)

        eigenvalues, _ = np.linalg.eig(symmetric(quad, 0.5))
        sigmas = np.sqrt(0.5 / np.clip(np.abs(eigenvalues), 1e-10, np.inf)) / 2

        location = self.lut.index2coord([list(offset + peak)])[0]
        return location, sigmas * self.lut.node_spacing

    @util.timeit()
    def _covfit3d(self, coa_map, thresh=0.90, win=None):
        """
        Coalescence-weighted mean position and covariance of the map values
        above ``thresh`` (optionally restricted to a win^3 box at the peak).

        """

        keep = coa_map > thresh
        if win:
            peak = np.unravel_index(np.nanargmax(coa_map), coa_map.shape)
            keep &= self._mask3d(coa_map.shape, peak, win)

        kept_idx = np.nonzero(keep)
        weights = coa_map[kept_idx].astype(np.float64)
        total = weights.sum()

        positions = [
            idx * spacing
            for idx, spacing in zip(kept_idx, self.lut.node_spacing)
        ]

        mean = [np.sum(weights * axis) / total for axis in positions]
        deviations = [axis - m for axis, m in zip(positions, mean)]

        covariance = np.empty((3, 3))
        for r in range(3):
            for c in range(r, 3):
                covariance[r, c] = covariance[c, r] = (
                    np.sum(weights * deviations[r] * deviations[c]) / total
                )

        location_xyz = self.lut.ll_corner + np.array(mean)
        location = self.lut.coord2grid(location_xyz, inverse=True)[0]
        return location, np.diag(np.sqrt(abs(covariance)))

    @util.timeit()
    def _gaufilt3d(self, map3d, sgm=0.8, shp=None, _radius=12):
        """
        Double Gaussian smoothing (forward + mirrored to cancel the
        even-axis phase shift), normalised to peak 1: each pass is three
        truncated 1-D convolutions of the separable kernel, whose
        per-axis ``origin`` reproduces the centring of a full-grid
        ``fftconvolve('same')`` and of its flipped second pass.

        """

        if shp is None:
            shp = map3d.shape

        kernels = []
        for n, profile in zip(shp, util.gaussian_profiles(shp, sgm)):
            c2 = n - 1  # 2 * (fractional centre index)
            lo = max(0, -(-(c2 - 2 * _radius) // 2))
            hi = min(n, (c2 + 2 * _radius) // 2 + 1)
            kernels.append((profile[lo:hi], lo, n))

        smoothed = map3d
        for centre in ("first", "flipped"):
            for axis, (w, lo, n) in enumerate(kernels):
                full_centre = (n - 1) // 2 if centre == "first" else n // 2
                origin = (full_centre - lo) - len(w) // 2
                smoothed = ndimage.convolve1d(
                    smoothed, w, axis=axis, mode="constant", cval=0.0,
                    origin=origin,
                )
            smoothed = smoothed / np.nanmax(smoothed)

        return smoothed

    @classmethod
    def _mask3d(cls, n, i, window):
        """Boolean mask of a window^3 box around node i in an n-shaped grid."""

        lo, hi = cls._peak_window(n, i, window)
        mask = np.zeros(np.asarray(n), dtype=bool)
        mask[tuple(slice(a, b) for a, b in zip(lo, hi))] = True
        return mask

    # --- the reference's deprecated parameter names: setters that accept
    # and warn, so old user scripts keep running unchanged ---

    sampling_rate = util.legacy_parameter(
        "scan_rate",
        lambda self: (
            "Warning: Parameter name has changed - continuing. Currently\n"
            "the scan sampling rate must be the same as the onset sampling\n"
            "rate, which you have set to "
            f"{getattr(self, 'scan_rate', '')} Hz."),
        assign=False,
    )
    time_step = util.legacy_parameter(
        "timestep", util.renamed_notice("time_step", "timestep"))
    n_cores = util.legacy_parameter(
        "threads",
        util.renamed_notice("n_cores", "threads")
        + "\n(On TPU, host thread count does not affect the migration.)",
    )
