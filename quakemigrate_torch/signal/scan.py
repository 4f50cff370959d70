# -*- coding: utf-8 -*-
"""
Continuous detect.

:class:`DetectScan` runs the fused detect window window after window, with
the host-to-device copy, the dispatch and the in-order drain of results
pipelined as in the JAX ``QuakeScan`` (``_detect_loop``,
``_run_detect_batch``, ``_drain_detect_results``). The input of each
window is the fixed-shape channel block that
``STALTAOnset.prepare_device_inputs`` builds.

:class:`QuakeScan` is the user's entry point for detect, after the JAX
``QuakeScan.detect``: it reads each window from the waveform archive (one
reader thread, two windows ahead), prepares its channel block, runs the
blocks through one :class:`DetectScan`'s dispatch/drain loop, and writes
the results, in order, to the run's ``.scanmseed`` and StationAvailability
files.

"""

import logging
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from datetime import time as clock_time

import numpy as np
import torch

import quakemigrate_torch.util as util
from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.io import Run, ScanmSEED, write_availability
from quakemigrate_torch.lut import traveltime_table, unravel
from quakemigrate_torch.seis import UTCDateTime
from quakemigrate_torch.signal.onsets import STALTAOnset
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
    drain_depth : int, default 8
        Windows dispatched but not yet fetched before the loop waits for
        the oldest (the JAX scan's ``detect_drain_depth``).

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
                 min_onset_value=0.4, device="cuda",
                 drain_depth=DRAIN_DEPTH):
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
        self.drain_depth = max(1, int(drain_depth))
        # Per-window device milliseconds (upload to packed result) of the
        # last detect() on a CUDA device, from CUDA events; and the host
        # seconds of each dispatched window's dispatch and of its fetch
        # (wait, copy and unpack), in window order.
        self.window_ms, self.dispatch_s, self.fetch_s = [], [], []

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
        self.window_ms, self.dispatch_s, self.fetch_s = [], [], []
        for block in windows:
            if block is None or np.asarray(block[2]).sum() == 0:
                pending.append(None)
            else:
                t0 = time.perf_counter()
                pending.append(self._dispatch(*block))
                self.dispatch_s.append(time.perf_counter() - t0)
            while len(pending) > self.drain_depth:
                yield self._drain(pending.popleft())
        while pending:
            yield self._drain(pending.popleft())

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

    def _drain(self, entry):
        if entry is None:
            return None
        t0 = time.perf_counter()
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
    Detect earthquakes by continuous migration of onset functions through
    a traveltime lookup table, from a waveform archive to the run's
    ``.scanmseed`` and StationAvailability files: the detect stage of the
    JAX ``QuakeScan`` on :class:`DetectScan`'s kernel route.

    Parameters
    ----------
    archive : quakemigrate_torch.io.Archive
    lut : quakemigrate_torch.lut.LUT
    onset : quakemigrate_torch.signal.onsets.STALTAOnset
    run_path, run_name : str
        The run directory is ``run_path/run_name`` (``run_subname``
        appends a subdirectory name).
    device : str or torch.device, default "cuda"
        Where the windows run: the card unless the caller asks for the
        CPU; "cuda" raises where CUDA is absent.
    timestep : float, default 120
        Seconds of scan output each window adds.
    detect_drain_depth : int, default 8
        Windows dispatched but not yet fetched before the loop waits.
    continuous_scanmseed_write : bool, default False
        Write the ``.scanmseed`` after every window, not only at the end
        of a day and of the scan.
    log, loglevel
        Logging to a file in the run directory, and its level.

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
    on_window : callable or None
        If set, called as ``on_window(i, block, result)`` for each window
        in order after its result is drained (``block`` is the channel
        block the window ran on, or None with ``result`` None for a window
        written as empty).

    """

    _OPTION_DEFAULTS = {
        "timestep": 120.0,
        "detect_drain_depth": 8,
        "continuous_scanmseed_write": False,
        "log": False,
        "loglevel": "info",
        "run_subname": "",
    }

    def __init__(self, archive, lut, onset, run_path, run_name,
                 device="cuda", **kwargs):
        if not isinstance(onset, STALTAOnset):
            raise util.OnsetTypeError
        self.device = resolve_device(device)
        self.archive = archive
        self.lut = lut
        self.onset = onset
        self.onset.post_pad = lut.max_traveltime
        for option, default in self._OPTION_DEFAULTS.items():
            setattr(self, option, kwargs.get(option, default))
        self.detect_drain_depth = max(1, int(self.detect_drain_depth))
        self.run = Run(run_path, run_name, self.run_subname,
                       loglevel=self.loglevel)
        self.pre_pad = self.post_pad = 0.0
        self.detect_scan = None
        self.detect_batch_attrib = []
        self.on_window = None
        self._traveltimes = None

    def __str__(self):
        return ("\tScan parameters:\n"
                f"\t\tScan sampling rate = {self.scan_rate} Hz\n"
                f"\t\tDevice             = {self.device}\n"
                f"\t\tTime step          = {self.timestep} s\n")

    @property
    def scan_rate(self):
        """Scan sampling rate: the onset sampling rate (the traveltime
        quantisation and window geometry depend on it)."""

        return self.onset.sampling_rate

    def _canonical_slots(self):
        """Phase-major (phase, station) slot ordering for the onset block."""

        return [(phase, station) for phase in self.onset.phases
                for station in self.archive.stations]

    def _traveltime_table(self):
        """Node-major int32 traveltime sample offsets, one column per
        canonical slot, as the JAX ``_build_device_state`` stacks them."""

        if self._traveltimes is None:
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
            self._traveltimes = traveltime_table(tables, self.scan_rate)
        return self._traveltimes

    def _detect_scan(self, fsmp, lsmp):
        """The DetectScan of this scan geometry, built once."""

        scan = self.detect_scan
        if scan is None or (scan.fsmp, scan.lsmp) != (fsmp, lsmp):
            scan = self.detect_scan = DetectScan(
                self._traveltime_table(), tuple(self.lut.node_count), fsmp,
                lsmp, position=self.onset.position,
                transform=self.onset.signal_transform,
                min_onset_value=self.onset.min_onset_value,
                device=self.device, drain_depth=self.detect_drain_depth,
            )
        return scan

    def detect(self, starttime, endtime):
        """
        Continuous coalescence scan between two timestamps, writing the
        .scanmseed stream and the station availability tables.

        """

        self.run.stage = "detect"
        self.run.logger(self.log)

        starttime, endtime = UTCDateTime(starttime), UTCDateTime(endtime)
        if starttime >= endtime:
            raise util.TimeSpanException
        if endtime.time == clock_time(0, 0):
            endtime = endtime - 1 / self.scan_rate

        n_steps = int(np.ceil((endtime - starttime) / self.timestep))
        calc_endtime = starttime + n_steps * self.timestep - 1 / self.scan_rate
        if calc_endtime - endtime > 1 / self.scan_rate:
            logging.info(
                f"Warning: chosen run duration {endtime - starttime} s is "
                f"not divisible by the specified timestep {self.timestep} s. "
                f"Detect will instead compute up to {calc_endtime}\n"
            )
        for line in (util.log_spacer, "\tDETECT - Continuous coalescence "
                     "scan", util.log_spacer,
                     f"\n\tScanning from {starttime} to {calc_endtime}\n",
                     self, str(self.onset), util.log_spacer):
            logging.info(line)

        self.detect_batch_attrib = []
        self._continuous_compute(starttime, n_steps)
        logging.info(util.log_spacer)

    def _continuous_compute(self, starttime, n_steps):
        coalescence = ScanmSEED(
            self.run, self.continuous_scanmseed_write, self.scan_rate
        )
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
        """Host-side stage of one detect window: the channel block and its
        availability row. A window with no live slot raises
        DataAvailabilityException before any device work."""

        *block, availability = self.onset.prepare_device_inputs(
            data, self._canonical_slots(), dtype=np.float32)
        if block[2].sum() == 0:
            raise util.DataAvailabilityException
        return tuple(block), availability
