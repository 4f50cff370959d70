#!/usr/bin/env python3
"""
Smoke run of quakemigrate_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

1. Requires CUDA (exits non-zero without it) and prints the card's name
   and power limit from nvidia-smi.
2. Builds the CUDA kernels from quakemigrate_torch/csrc with nvcc
   (sm_90a) and prints the build time and the compiler's resource report.
3. Holds the migrate-and-reduce kernels K1 (csrc/migrate_detect.cu) and
   K1 v2 (csrc/migrate_detect_v2.cu, the main path's) against their
   plain PyTorch version on the card, on a small random plan and at the
   Icequake detect geometry: tmax and tsum within 1e-5 relative (same
   summation order, so only expf ulps remain), and the kernel's argmax
   node tie-consistent (the plain coalescence there within 1e-5 of the
   tile max). K1 v2 is also held bit for bit to K1 (tmax, targ, tsum) at
   Icequake, and the two are timed in turns (v2, K1, K1, v2; 20
   launches a turn), with their resident blocks per SM.
4. Drives the port's main path, DetectScan.detect (K1 v2), over 16 consecutive
   windows at the Icequake detect geometry (71 x 64 x 57 nodes, 12
   stations x P/S, 3 channels, 250 Hz, 2.5 s timestep) with one planted
   source, and checks: 16 kernel launches; finite outputs of the right
   shape; agreement with the plain window path on the card (max_coa
   within 1e-5, max_coa_n within 1e-4 relative: sums over 2.6e5 nodes
   in another order; tie-consistent argmax); and the planted window's
   peak above every other window's, within one grid node of the source.
   archive_detect, the main path from a user's entry point: the
   Icequake example's LUT built with the port (its 13 stations, the lcc
   grid at 25 m: 71 x 64 x 57 nodes, homogeneous vp 3.630, vs 1.833
   km/s), 120 s of 250 Hz three-component synthetics with one source
   planted at a grid node (quakemigrate_torch.synthetics), written as a
   YEAR/JD/STATION STEIM2 archive; the example's STALTAOnset (classic,
   bandpass [10, 124, 4], P 0.01/0.25 s, S 0.05/0.5 s) and
   QuakeScan.detect over the middle 60 s at timestep 2.5 s (24 windows).
   Checks: route k1_v2, one K1 v2 launch a dispatched window and no other
   detect kernel; each window's result against the plain window on the
   card for the block the scan prepared (the tolerances of step 4); the
   .scanmseed read back by the port's reader (5 channels of 15,000
   samples); the peak's X/Y/Z within one node of the planted source.
   Prints the detect's wall time and real-time factor, cold and warm, the
   device ms a window, the host seconds split into read wait, prepare,
   dispatch and drain/append, and each host layer's ms a window timed
   alone (archive read, pre-process, block, .scanmseed append). The
   scan's own log goes to a file in the phase's temporary directory.
   archive_locate follows on the same workspace and .scanmseed: Trigger
   with the example's settings (iceland_trigger.py: marginal window
   0.06 s, minimum interval 0.12 s, static 2.15 on the normalised
   trace) and QuakeScan.locate with iceland_locate.py's (centred
   STA/LTA, GaussianPicker, cut waveforms) on the card. Checks: exactly
   the planted event triggered, within the marginal window of its
   origin; route k1_v2, one K1 v2 launch an event migrated and one M1
   v2 (csrc/migrate_marginalise_v2.cu) launch an event through the
   marginal-window gate, no M1 (csrc/migrate_marginalise.cu), no other
   kernel and no plain version on a CUDA tensor; pass 1 against the
   plain migration (the tolerances of step 4) and M1 v2 against the
   plain migrate_marginalise (1e-5 of the map's maximum, the same peak
   node); the spline hypocentre within one node of the planted source;
   the .event, .picks and cut waveforms read back, with P and S picks at
   every station. Locate runs again warm, and its per-event host split
   (read wait, onsets, pass 1, pass 2, location math, picks, writes)
   and trigger's wall are printed. Then, at the locate window, M1 v2
   bit for bit to M1 and the two timed in turns (v2, v1, v1, v2), with
   K1 v2 timed; M1 v2 on archive_detect's 2,038-sample scan at windows
   of one chunk (128 samples), three chunks (300) and the whole scan,
   each held to the plain version and to M1 (bit for bit at one chunk)
   and timed in turns with it; and M1 at 128 stations x P/S (256
   onsets, a plan K1 v2 refuses, so CudaDetectVPU's route), held to its
   plain version, its launches counted.
5. The VPU-plan kernel (csrc/migrate_detect_vpu.cu) against its plain
   version on a small plan and at the Icequake grid (tile 512, bricks
   8 x 8 x 8), timed; then K2 v2 (csrc/migrate_detect_vpu_v2.cu, the
   same kernel on an mbarrier ring) at both plans against its own plain
   version, bit for bit to K2 (tmax, targ, tsum) and, in tmax and targ,
   to K1, and at Icequake timed in turns with K2 and K1 v2 (v2, v1, K1
   v2, K1 v2, v1, v2) with its shared memory, blocks per SM, registers
   and spills. Then the VPU path: the 16 windows' onsets from
   fused_onsets through CudaDetectVPU (K2 v2), with 16 launches of K2
   v2 and none of K2, max_coa and max_coa_n within 1e-5 and 1e-4 of
   DetectScan's results, argmax tie-consistent, and the planted node
   found within one grid node. K2, which no path runs now, reports its
   launches as K2 v2's yardstick, each case read straight after a
   reset: its own small and Icequake cases, and the day case of step 8.
   F1 follows: 2 windows of 128 stations x P/S (256 onsets) on the
   Icequake grid, which K1 v2 cannot stage, go through DetectScan by
   its K2 v2 route on the same plan (the reason printed; 2 launches of
   K2 v2, none of K1 v2 or K2; outputs finite, max_coa and max_coa_n
   within 1e-5 of the plain window, the argmax tie-consistent).
6. The detect-kernel breakdown (quakemigrate_torch.ops.cuda_breakdown):
   each ablation of K1 against its own plain
   contract, the resident-staging kernel and the pipelined kernel (2, 3
   and 4 stages, and per-onset spans) against the plain version, at the
   day-scale workload cut to a 625-sample window; then the breakdown's
   entry point (experiments/exp_kernel_breakdown.run) at the full
   30,000-sample window, which holds the resident and pipelined kernels
   to K1's outputs, and K1 held
   against its plain version (timed once) at that size.
7. The shifted-copy kernel (csrc/migrate_detect_x16.cu) in both layouts
   against its plain version (the stride-table reference) on a small
   plan; then, at the day-scale workload and the TPU experiment's plan
   (tile 512, bricks 8 x 8 x 8), its entry point's run
   (experiments/exp_x16.run) at 625 and at 30,000 samples, which holds
   both layouts bit for bit (tmax, targ, tsum) to K1
   at the same plan and times them beside it; at 30,000 samples both
   layouts are also held to the plain version (timed once). The same
   run holds E2 v2, the redesign on K1 v2's slab
   (csrc/migrate_detect_x16_v2.cu), in both layouts bit for bit to K1,
   times it in turns with v1's layouts, K1 and K1 v2 at that plan, and
   holds its NOGATHER and NOREDUCE bit for bit to K1 v2's and times
   them; at 625 and 30,000 samples its plain version is held bit for bit
   to the plan reference (timed once) and the kernel to its plain
   version (tsum within 1e-5: the plain version sums the nodes in
   another order).
8. The staging probes (csrc/migrate_detect_pipelined.cu, static2 and
   packed) through experiments/exp_dma_probe.main_probe at 625 and
   30,000 samples: static2 bit for bit to K1 and to
   its plain version within 1e-5, packed equal to its closed form. The
   same run holds E4b v2, the probes on E1c v2's TMA ring
   (csrc/migrate_detect_probe_v2.cu): static2 bit for bit to K1, packed
   equal to its closed form, timed in turns with E1c v2 at that plan and
   v1's modes; static2's plain version bit for bit to the plan reference
   (timed once) and the kernel to it within 1e-5. On the same setup K2
   v2 (experiments/exp_vpu_v2.run): bit for bit to K2 and, in tmax and
   targ, to K1, timed in turns with K2 and K1 v2, and held to its plain
   version (timed once).
9. The streaming probe (csrc/stream_probe.cu) through
   experiments/exp_dma_probe.main_stream at rows 64, 256 and 1024, 2 GiB
   streamed each from a seeded random bf16 source of 512 MiB, its output
   equal to its plain version, with torch.sum over the same bytes timed.
10. The one-hot product layouts on the tensor cores: v1
   (csrc/dot_layout.cu, mma.sync) in every mode at a small shape and v2
   (csrc/dot_layout_v2.cu, wgmma fed by a TMA ring) in every mode at its
   own small shape, each equal to the plain version bit for bit; then
   their entry point's run (experiments/exp_dot_layout.run): every mode
   at the three TPU shapes and 4096 steps, both held to the plain
   version (rtol 1e-6) and timed in turns (v2, v1, v1, v2) beside
   torch.matmul on the same bf16 operands, with the bytes each stages
   from L2 a step.
11. The stride-16 table detect kernel on the tensor cores, v1
   (csrc/migrate_detect_x16g.cu, mma.sync) in both forms and v2
   (csrc/migrate_detect_x16g_v2.cu, wgmma) against their plain version
   on the small plan (tmax and tsum within 1e-5, argmax tie-consistent;
   noreduce within 1e-5; v2's nomain equal to its closed form), v2 at
   tiles 64 and 512; then their entry point's run
   (experiments/exp_x16g.run) at 625 and at 30,000 samples, tile 512,
   which holds v1's forms and v2 to K1 at the same plan
   within the hi/lo bound computed from the onsets (argmax
   tie-consistent at that bound), noreduce to its plain version and the
   ablations that zero an operand to their closed form, times them all,
   and times v2 in turns with v1's forms (v2, fuse, expand, expand,
   fuse, v2); at 30,000 samples v1's forms and v2 are also held to their
   plain version (timed once).
12. K1 v2 at the day-scale window (30,000 samples, K1's plan, tile 256,
   bricks 8 x 8 x 4): bit for bit to K1, the two timed in turns, and
   v2's NOGATHER and NOREDUCE ablations, held bit for bit to K1's
   (NOREDUCE with the sums of padding nodes at 0: v2 skips their
   gather) and timed; at 625 samples (step 6) the ablations are held to
   their plain versions. K1's launches are counted over this step and
   step 3's K1 v2 case, where K1 is the yardstick.
13. E1c v2 and E1b v2, the pipelined and resident kernels redesigned on
   K1 v2's gather core with TMA-fed staging
   (csrc/migrate_detect_pipelined_v2.cu, csrc/migrate_detect_resident_v2.cu):
   at 625 samples (step 6) every depth of E1c v2 and E1b v2 against
   their plain versions, and their NOREDUCE and NOGATHER against K1 v2's
   plain ablations; the breakdown's entry point (step 6) runs both beside
   their v1 and holds them to K1; at 30,000 samples both against their
   plain versions (timed once; each plain version bit for bit to the plan
   reference the breakdown computed). At 30,000 and 625 samples both bit
   for bit to K1 (tmax, targ, tsum), timed in turns with E1c v1 (its
   fastest depth), E1b v1 (group 2), K1 and K1 v2, with their NOGATHER
   and NOREDUCE held bit for bit to K1 v2's and timed, and their blocks
   per SM, registers and spills.

14. The machine-code census (experiments/sass_loops.census) of K2, K2
   v2 and K1 v2: each gather loop's instructions, loads and adds, and
   its instructions a node-onset-sample.

Every kernel line carries its launches on its path (each path run with
the counts set to 0 just before it), its time and its plain version's,
and its bound: the larger of the bytes it must move (inputs read once,
outputs written once) over 3.35 TB/s and the operations of the function
it computes over the peak for their type: float32 at 67 TFLOP/s, or
bf16 products on the tensor cores at 989 TFLOP/s for the product
layouts. The detect kernels also carry the floor of their shared-memory
gather: the 4-byte reads the function needs, O per real node and sample,
at 33.5 TB/s (padding nodes are not counted, so every detect kernel's
floor measures the same work whatever its plan pads); the tensor-core
detect kernel,
whose bound is the detect contract read through its hi/lo tables, also
carries the floor of its one-hot products on the tensor cores.

Every failure raises. The last two lines are the kernels' JSON record
and {"ok": true, "device": {...}}.

"""

import json
import logging
import pathlib
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch

# Icequake_Iceland detect geometry (examples/Icequake_Iceland)
NODE_COUNT = (71, 64, 57)
SPACING_KM = 0.025
RATE = 250
N_STATIONS = 12
VP, VS = 3.63, 1.833
FSMP, LSMP, NSAMPLES = 475, 575, 625
STA_LTA = {"P": (0.01, 0.25), "S": (0.05, 0.5)}
N_WINDOWS = 16
PLANT_WINDOW = 9
# archive_detect: the Icequake example's inputs, and a synthetic archive of
# 2 x ARCHIVE_SPAN_S seconds from ARCHIVE_START, scanned over its middle
# ARCHIVE_SPAN_S seconds at the example's timestep
ICEQUAKE_DIR = (pathlib.Path(__file__).resolve().parent / "examples"
                / "Icequake_Iceland")
ARCHIVE_START = "2014-06-29T18:41:00.0"
ARCHIVE_SPAN_S = 60.0
ARCHIVE_TIMESTEP = 2.5
DEAD_WINDOW, DEAD_STATION = 3, 5
# archive_locate: the example's trigger (iceland_trigger.py) and locate
# (iceland_locate.py) settings
LOCATE_MARGINAL_WINDOW = 0.06
LOCATE_MIN_EVENT_INTERVAL = 0.12
LOCATE_THRESHOLD = 2.15
# archive_detect's window at Icequake (fsmp, nsamples, lsmp), over which
# M1 is also timed
DETECT_WINDOW = (413, 2038, 1000)

KERNEL_RTOL = 1e-5
MAX_COA_RTOL = 1e-5
MAX_COA_N_RTOL = 1e-4
# M1 against its plain version: sums of coalescence over the window in
# other orders, within this share of the map's maximum
M1_RTOL_OF_MAX = 1e-5

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3
# bandwidth, float32 rate outside the tensor cores, and shared-memory
# bandwidth (32 banks x 4 B x 132 SMs at 1980 MHz).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12  # tensor cores, dense bf16
SMEM_BYTES_PER_S = 33.5e12
# The streaming probe streams 2 GiB per rows value here (16 GiB in
# experiments/exp_dma_probe.py), to keep the smoke short.
SMOKE_STREAM_BYTES = 2 * 2**30


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds of ``fn()`` on the current stream, CUDA events."""

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def roofline(nbytes, flops, flop_per_s=FP32_FLOP_PER_S):
    """The least time for a function that must move ``nbytes`` through
    device memory and do ``flops`` operations at ``flop_per_s`` (float32
    by default): (ms, "bytes" or "operations"), whichever bounds it."""

    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flop_per_s * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def detect_bound(args, n_nodes):
    """Bound of the detect contract on the kernel arguments ``args``
    (onsets_log, base, fine, valid, inv_available, fsmp, nsamples) for a
    grid of ``n_nodes`` real nodes: every input read once and the three
    [n_tiles, S] outputs written once, against O adds and four more
    operations (scale, exp, valid, sum) per node and sample. Also the
    floor of the gather itself: the function's n_nodes x O x S 4-byte
    shared-memory reads at the shared-memory bandwidth."""

    tensors, nsamples = args[:5], args[6]
    n_tiles, n_onsets = args[1].shape
    nbytes = (sum(x.numel() * x.element_size() for x in tensors)
              + 3 * 4 * n_tiles * nsamples)
    bound_ms, bound_by = roofline(
        nbytes, n_nodes * nsamples * (n_onsets + 4))
    smem_ms = n_nodes * n_onsets * nsamples * 4 / SMEM_BYTES_PER_S * 1e3
    return {"bound_ms": bound_ms, "bound_by": bound_by,
            "smem_bound_ms": smem_ms}


def icequake_traveltimes(rng, n_stations=N_STATIONS):
    """Homogeneous-moveout tables of ``n_stations`` surface stations,
    phase-major (P for every station, then S)."""

    from quakemigrate_torch.lut import traveltime_table

    axes = [np.arange(n) * SPACING_KM for n in NODE_COUNT]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    stations = rng.uniform(
        [0.0, 0.0], [axes[0][-1], axes[1][-1]], size=(n_stations, 2)
    )
    dist = [np.sqrt((x - sx) ** 2 + (y - sy) ** 2 + z**2)
            for sx, sy in stations]
    tables = [d / v for v in (VP, VS) for d in dist]
    return traveltime_table(tables, RATE)


def kernel_case(name, tt, node_count, fsmp, nsamples, tile, brick, rng,
                device, n_masked=1, time_it=False, kernel="k1"):
    """A detect kernel against its plain version on the same staged
    onsets: ``kernel`` is "k1" (csrc/migrate_detect.cu), "v2" (K1 v2,
    also held bit for bit to K1 and, with ``time_it``, timed in turns
    with it), "vpu" (the VPU-plan kernel, at a CudaDetectVPU plan),
    "vpu_v2" (K2 v2, at that plan, through its own plain version; also
    held bit for bit to K2 and, in tmax and targ, to K1 and, with
    ``time_it``, timed in turns with K2 and K1 v2) or a layout of the
    shifted-copy kernel ("x16a", "x16b"; its plain version is the
    stride-table reference)."""

    from quakemigrate_torch.ops.cuda_migrate import (
        VPU_V2_GROUP,
        CudaDetect,
        CudaDetectVPU,
        DetectPlan,
        detect_blocks_per_sm,
        detect_reduce_plan_reference,
        detect_v2_blocks_per_sm,
        migrate_detect_cuda,
        migrate_detect_v2_cuda,
        migrate_detect_vpu_cuda,
        migrate_detect_vpu_v2_cuda,
        vpu_v2_reference,
    )
    from quakemigrate_torch.experiments import exp_vpu_v2
    from quakemigrate_torch.experiments.exp_kernel_breakdown import in_turns
    from quakemigrate_torch.ops.cuda_x16 import migrate_detect_x16_cuda
    from quakemigrate_torch.ops.migrate import _prepare_onsets
    from quakemigrate_torch.ops.x16 import detect_reduce_stride_reference

    n_onsets = tt.shape[1]
    t_len = fsmp + nsamples + int(tt.max()) + 7
    plan = DetectPlan(tt, node_count, tile=tile, brick_shape=brick)
    det = (CudaDetectVPU if kernel in ("vpu", "vpu_v2") else CudaDetect)(
        tt, node_count, fsmp, nsamples, device, tile=tile, brick_shape=brick,
        plan=plan)
    plain = detect_reduce_plan_reference

    def k1(*a):
        return migrate_detect_cuda(*a, det.r_span)

    def fn(*a):
        if kernel == "k1":
            return k1(*a)
        if kernel == "v2":
            return migrate_detect_v2_cuda(*a[:2], det.fine16, *a[3:],
                                          det.span_off, det.win_floats)
        if kernel == "vpu":
            return migrate_detect_vpu_cuda(*a, det.r_span)
        if kernel == "vpu_v2":
            return migrate_detect_vpu_v2_cuda(a[0], a[1], *a[3:], det.tables,
                                              det.n_stages)
        return migrate_detect_x16_cuda(*a, det.r_span,
                                       int(np.maximum(tt, 0).max()), kernel)

    if kernel in ("x16a", "x16b"):
        plain = detect_reduce_stride_reference
    if kernel == "vpu_v2":
        def plain(*a):
            return vpu_v2_reference(a[0], a[1], *a[3:], det.tables)
    onsets = torch.from_numpy(
        rng.gamma(2.0, 1.5, size=(n_onsets, t_len)).astype(np.float32)
    ).to(device)
    mask = torch.ones(n_onsets, dtype=torch.float32, device=device)
    mask[n_onsets - n_masked:] = 0.0
    onsets_log = _prepare_onsets(onsets, mask).contiguous()
    inv_available = (1.0 / mask.sum()).reshape(1)
    args = (onsets_log, det.base, det.fine, det.valid, inv_available,
            fsmp, nsamples)

    kmax, karg, ksum = fn(*args)
    pmax, parg, psum = plain(*args)
    torch.cuda.synchronize()

    rel_max = ((kmax - pmax).abs() / pmax.abs()).max().item()
    rel_sum = ((ksum - psum).abs() / psum.abs()).max().item()
    abs_err = (kmax - pmax).abs().max().item()

    # Plain coalescence at the kernel's chosen node
    t = torch.arange(nsamples, device=device)
    idx = karg.long()
    acc = torch.zeros_like(pmax)
    for o in range(n_onsets):
        cols = fsmp + det.base[:, o, None] + det.fine[:, o, :].gather(1, idx)
        acc = acc + onsets_log[o][cols + t]
    at_k = torch.exp(acc * inv_available) * det.valid.gather(1, idx)
    tie_err = ((pmax - at_k).abs() / pmax.abs()).max().item()
    arg_equal = (karg == parg).float().mean().item()

    print(f"kernel[{name}]: tiles {det.base.shape[0]} x tile {tile}, "
          f"onsets {n_onsets}, samples {nsamples}, r_span {det.r_span}; "
          f"rel err tmax {rel_max:.3e} tsum {rel_sum:.3e}, abs err tmax "
          f"{abs_err:.3e}, argmax equal {arg_equal:.6f}, tie err "
          f"{tie_err:.3e}")
    check(np.isfinite([rel_max, rel_sum, tie_err]).all(),
          f"{name}: non-finite kernel output")
    check(rel_max <= KERNEL_RTOL, f"{name}: tmax rel err {rel_max}")
    check(rel_sum <= KERNEL_RTOL, f"{name}: tsum rel err {rel_sum}")
    check(tie_err <= KERNEL_RTOL, f"{name}: argmax tie err {tie_err}")

    record = {"max_abs_err": abs_err, "max_rel_err_tmax": rel_max,
              "max_rel_err_tsum": rel_sum, "tie_rel_err": tie_err,
              **detect_bound(args, det.n_nodes)}
    if kernel == "v2":
        k1_outs = k1(*args)
        same = [torch.equal(a, b) for a, b in zip((kmax, karg, ksum), k1_outs)]
        record["blocks_per_sm"] = detect_v2_blocks_per_sm(
            n_onsets, tile, det.win_floats, device)
        record["k1_blocks_per_sm"] = detect_blocks_per_sm(
            n_onsets, det.r_span, device)
        print(f"kernel[{name}]: equal to K1 (tmax, targ, tsum) {same}; "
              f"blocks per SM {record['blocks_per_sm']} (K1 "
              f"{record['k1_blocks_per_sm']})")
        check(all(same), f"{name}: K1 v2 differs from K1")
    if kernel == "vpu_v2":
        same = [torch.equal(a, b) for a, b in zip(
            (kmax, karg, ksum), migrate_detect_vpu_cuda(*args, det.r_span))]
        same_k1 = [torch.equal(a, b) for a, b in zip(
            (kmax, karg), migrate_detect_cuda(*args, det.r_span))]
        print(f"kernel[{name}]: equal to K2 (tmax, targ, tsum) {same}, to "
              f"K1 (tmax, targ) {same_k1}; npp {det.tables.npp}, group "
              f"{VPU_V2_GROUP}, {det.n_stages} stages")
        check(all(same), f"{name}: K2 v2 differs from K2")
        check(all(same_k1), f"{name}: K2 v2's tmax or targ differs from K1's")
        if time_it:
            # bit for bit again, then in turns with K2 and K1 v2
            record.update(exp_vpu_v2.run(exp_vpu_v2.plan_setup(plan, args),
                                         reps=20, n_stages=det.n_stages))
    if time_it and kernel == "v2":
        turns = in_turns({"v2": lambda: fn(*args), "k1": lambda: k1(*args)},
                         reps=20)
        record["ms"] = float(np.mean(turns["v2"]))
        record["k1_ms"] = float(np.mean(turns["k1"]))
        record["turns_ms"] = turns
    elif time_it and kernel != "vpu_v2":
        record["ms"] = cuda_ms(lambda: fn(*args), reps=20)
    if time_it:
        record["plain_ms"] = cuda_ms(lambda: plain(*args), reps=3, warmup=1)
        print(f"kernel[{name}]: {record['ms']:.4f} ms per launch, plain "
              f"version {record['plain_ms']:.4f} ms"
              + (f"; in turns {turns}" if kernel == "v2" else "")
              + (f"; in turns {record['turns_ms']}" if kernel == "vpu_v2"
                 else ""))
    return record


def make_windows(tt, rng, n_windows=N_WINDOWS, plant_window=PLANT_WINDOW):
    """``n_windows`` consecutive windows of a continuous 3-component noise
    record of the stations of ``tt`` (phase-major slots) with one planted
    source in window ``plant_window``; returns (windows, planted node
    index)."""

    from quakemigrate_torch.util import time2sample

    n_slots = tt.shape[1]
    n_stations = n_slots // 2
    hop = NSAMPLES
    t_len = FSMP + NSAMPLES + LSMP
    total = (n_windows - 1) * hop + t_len
    waves = rng.normal(size=(n_stations, 3, total)).astype(np.float32)

    planted = tuple(int(rng.integers(8, n - 8)) for n in NODE_COUNT)
    node = int(np.ravel_multi_index(planted, NODE_COUNT))
    origin = plant_window * hop + FSMP + 300
    # Amplitude 4 against unit noise keeps the STA/LTA below saturation,
    # so each onset peaks at one sample and the planted node is sharp.
    wavelet = np.array([4.0, -4.0], np.float32)
    for s in range(n_stations):
        for phase_slot in (s, s + n_stations):
            arrival = origin + int(tt[node, phase_slot])
            for c in range(3):
                waves[s, c, arrival:arrival + len(wavelet)] += (
                    wavelet * (1.0 - 0.2 * c)
                )

    nsta = np.array(
        [time2sample(STA_LTA[p][0], RATE) for p in ("P", "S")
         for _ in range(n_stations)], dtype=np.int32)
    nlta = np.array(
        [time2sample(STA_LTA[p][1], RATE) for p in ("P", "S")
         for _ in range(n_stations)], dtype=np.int32)

    windows = []
    for w in range(n_windows):
        seg = waves[:, :, w * hop:w * hop + t_len]
        channels = np.concatenate([seg, seg])  # P slots, then S slots
        chan_mask = np.ones((n_slots, 3), np.float32)
        slot_mask = np.ones(n_slots, np.float32)
        if w == DEAD_WINDOW:
            for slot in (DEAD_STATION, DEAD_STATION + n_stations):
                channels[slot] = 0.0
                chan_mask[slot] = 0.0
                slot_mask[slot] = 0.0
        windows.append(
            (np.ascontiguousarray(channels), chan_mask, slot_mask, nsta, nlta)
        )
    return windows, node


def plain_window(block, tt_dev, device, fsmp=FSMP, nsamples=NSAMPLES):
    from quakemigrate_torch.ops.scan_window import detect_window_fused

    tensors = [torch.from_numpy(a).to(device) for a in block]
    return detect_window_fused(
        *tensors, tt_dev, "classic", "energy", 0.4, fsmp, nsamples,
    )


def plain_coa_at(block, tt_dev, idx, device, fsmp=FSMP, nsamples=NSAMPLES):
    """Plain flat-order coalescence of one window at node idx[t]."""

    from quakemigrate_torch.ops.migrate import _prepare_onsets
    from quakemigrate_torch.ops.scan_window import fused_onsets

    channels, chan_mask, slot_mask, nsta, nlta = (
        torch.from_numpy(a).to(device) for a in block
    )
    combined, available = fused_onsets(
        channels, chan_mask, slot_mask, nsta, nlta, "classic", "energy", 0.4
    )
    onsets_log = _prepare_onsets(combined, slot_mask)
    t = torch.arange(nsamples, device=device)
    rows = tt_dev[torch.from_numpy(idx).long().to(device)].long()
    acc = torch.zeros(nsamples, dtype=torch.float32, device=device)
    for o in range(onsets_log.shape[0]):
        acc = acc + onsets_log[o][fsmp + rows[:, o] + t]
    return torch.exp(acc / available).cpu().numpy()


def run_slice(tt, rng, device):
    from quakemigrate_torch.signal.scan import DetectScan

    windows, node = make_windows(tt, rng)
    planted_ijk = np.array(np.unravel_index(node, NODE_COUNT))
    scan = DetectScan(tt, NODE_COUNT, FSMP, LSMP, position="classic",
                      transform="energy", min_onset_value=0.4, device=device)
    print(f"slice: route {scan.route}")
    check(scan.route == "k1_v2", f"the Icequake window takes the "
          f"{scan.route} route ({scan.route_reason})")
    detector = scan.detector(NSAMPLES)  # plan built before the counted run

    detector.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = scan.detect(windows)
    wall = time.perf_counter() - t0
    launches = detector.launches
    print(f"slice: {N_WINDOWS} windows in {wall:.3f} s wall; kernel "
          f"launches {launches}; per-window device ms (upload, onsets, "
          f"kernel, combine, copy back) {np.round(scan.window_ms, 3).tolist()}")
    check(launches == N_WINDOWS,
          f"{launches} kernel launches for {N_WINDOWS} windows")

    tt_dev = torch.from_numpy(tt).to(device)
    peaks = []
    for w, (block, res) in enumerate(zip(windows, results)):
        check(res is not None, f"window {w} returned no result")
        max_coa, max_coa_n, max_idx, ijk = res
        check(max_coa.shape == (NSAMPLES,) and ijk.shape == (NSAMPLES, 3),
              f"window {w}: shapes {max_coa.shape}, {ijk.shape}")
        check(np.isfinite(max_coa).all() and np.isfinite(max_coa_n).all(),
              f"window {w}: non-finite coalescence")
        check(((max_idx >= 0) & (max_idx < tt.shape[0])).all(),
              f"window {w}: node index out of range")
        ref = [x.cpu().numpy() for x in plain_window(block, tt_dev, device)]
        rel = np.abs(max_coa - ref[0]) / np.abs(ref[0])
        rel_n = np.abs(max_coa_n - ref[1]) / np.abs(ref[1])
        tie = np.abs(ref[0] - plain_coa_at(block, tt_dev, max_idx, device))
        tie = tie / np.abs(ref[0])
        check(rel.max() <= MAX_COA_RTOL, f"window {w}: max_coa {rel.max()}")
        check(rel_n.max() <= MAX_COA_N_RTOL,
              f"window {w}: max_coa_n {rel_n.max()}")
        check(tie.max() <= MAX_COA_RTOL, f"window {w}: argmax tie {tie.max()}")
        peak = int(np.argmax(max_coa))
        peaks.append((float(max_coa[peak]), ijk[peak]))
        print(f"window {w:2d}: peak max_coa {max_coa[peak]:.6f} at "
              f"{ijk[peak].tolist()}; vs plain: max_coa {rel.max():.2e}, "
              f"max_coa_n {rel_n.max():.2e}, tie {tie.max():.2e}, argmax "
              f"equal {(max_idx == ref[2]).mean():.4f}")

    values = np.array([p[0] for p in peaks])
    others = np.delete(values, PLANT_WINDOW)
    dist = int(np.abs(peaks[PLANT_WINDOW][1] - planted_ijk).max())
    print(f"slice: planted node {planted_ijk.tolist()} in window "
          f"{PLANT_WINDOW}; peak {values[PLANT_WINDOW]:.6f} vs best other "
          f"{others.max():.6f}; node distance {dist}")
    check(values[PLANT_WINDOW] > others.max(),
          "the planted window's peak is not the highest")
    check(dist <= 1, f"peak node {dist} nodes from the planted node")

    # The same windows again, warm (not counted): steady-state wall time
    # per window against the device time the windows' CUDA events cover
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan.detect(windows)
    warm_wall = time.perf_counter() - t0
    busy = sum(scan.window_ms) / 1e3
    print(f"slice (warm): {warm_wall / N_WINDOWS * 1e3:.3f} ms wall per "
          f"window, device {np.median(scan.window_ms):.3f} ms median per "
          f"window, device busy share {busy / warm_wall:.3f}")

    # Window compute alone, kernel path against the plain path, on the
    # same uploaded blocks (information, not a claim)
    from quakemigrate_torch.ops.scan_window import (
        detect_window_fused,
        detect_window_fused_cuda,
    )

    block = [torch.from_numpy(a).to(device) for a in windows[0]]
    kernel_ms = cuda_ms(lambda: detect_window_fused_cuda(
        *block, detector, "classic", "energy", 0.4, scan.n_nodes), reps=10)
    plain_ms = cuda_ms(lambda: detect_window_fused(
        *block, tt_dev, "classic", "energy", 0.4, FSMP, NSAMPLES), reps=3,
        warmup=1)
    print(f"slice: window compute {kernel_ms:.4f} ms with the kernel, "
          f"{plain_ms:.4f} ms plain")
    return launches, windows, results, planted_ijk


def run_vpu_path(tt, windows, scan_results, planted_ijk, device):
    """The VPU-plan kernel's path: each window's onsets (fused_onsets)
    through CudaDetectVPU (K2 v2), held against DetectScan's results."""

    from quakemigrate_torch.lut import unravel
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops.scan_window import fused_onsets

    detector = cm.CudaDetectVPU(tt, NODE_COUNT, FSMP, NSAMPLES, device)
    blocks = [[torch.from_numpy(a).to(device) for a in block]
              for block in windows]
    torch.cuda.synchronize()

    detector.launches = 0
    cm.reset_launches()
    outs = []
    for channels, chan_mask, slot_mask, nsta, nlta in blocks:
        combined, available = fused_onsets(
            channels, chan_mask, slot_mask, nsta, nlta, "classic", "energy",
            0.4,
        )
        outs.append(detector(combined, slot_mask, available))
    torch.cuda.synchronize()
    launches = cm.launches["migrate_detect_vpu_v2"]
    print(f"vpu path: {N_WINDOWS} windows, kernel launches {cm.launches}")
    check(launches == detector.launches == N_WINDOWS,
          f"{launches} K2 v2 launches for {N_WINDOWS} windows")
    check(cm.launches["migrate_detect_vpu"] == 0,
          "vpu path: K2 v1 was launched")

    tt_dev = torch.from_numpy(tt).to(device)
    peaks = []
    for w, (block, out, ref) in enumerate(zip(windows, outs, scan_results)):
        max_coa, max_coa_n, max_idx = (x.cpu().numpy() for x in out)
        check(np.isfinite(max_coa).all() and np.isfinite(max_coa_n).all(),
              f"vpu window {w}: non-finite coalescence")
        rel = np.abs(max_coa - ref[0]) / np.abs(ref[0])
        rel_n = np.abs(max_coa_n - ref[1]) / np.abs(ref[1])
        tie = np.abs(ref[0] - plain_coa_at(block, tt_dev, max_idx, device))
        tie = tie / np.abs(ref[0])
        check(rel.max() <= MAX_COA_RTOL, f"vpu window {w}: max_coa {rel.max()}")
        check(rel_n.max() <= MAX_COA_N_RTOL,
              f"vpu window {w}: max_coa_n {rel_n.max()}")
        check(tie.max() <= MAX_COA_RTOL,
              f"vpu window {w}: argmax tie {tie.max()}")
        peak = int(np.argmax(max_coa))
        peaks.append((float(max_coa[peak]),
                      unravel(max_idx[peak:peak + 1], NODE_COUNT)[0]))
        print(f"vpu window {w:2d}: vs DetectScan: max_coa {rel.max():.2e}, "
              f"max_coa_n {rel_n.max():.2e}, tie {tie.max():.2e}, argmax "
              f"equal {(max_idx == ref[2]).mean():.4f}")
    values = np.array([p[0] for p in peaks])
    dist = int(np.abs(peaks[PLANT_WINDOW][1] - planted_ijk).max())
    print(f"vpu path: planted window peak {values[PLANT_WINDOW]:.6f}, best "
          f"other {np.delete(values, PLANT_WINDOW).max():.6f}; node "
          f"distance {dist}")
    check(values[PLANT_WINDOW] > np.delete(values, PLANT_WINDOW).max(),
          "vpu path: the planted window's peak is not the highest")
    check(dist <= 1, f"vpu path: peak node {dist} nodes from the planted node")
    return launches


def vpu_v2_day_path(s):
    """K2 v2 at the day-scale window at the VPU plan (the setup ``s``:
    30,000 samples, tile 512, bricks 8 x 8 x 8): bit for bit to K2 v1
    (tmax, targ, tsum) and, in tmax and targ, to K1, timed in turns with
    K2 v1 and K1 v2 (experiments/exp_vpu_v2.run, 5 launches a turn); its
    plain version timed once and the kernel held to it."""

    from quakemigrate_torch.experiments import exp_vpu_v2
    from quakemigrate_torch.ops import cuda_migrate as cm

    record = exp_vpu_v2.run(s)
    a = s.args
    tables = cm.vpu_v2_tables(s.plan, a[5], s.device)
    t0 = time.perf_counter()
    ref = cm.vpu_v2_reference(a[0], a[1], *a[3:], tables)
    torch.cuda.synchronize()
    record["plain_ms"] = (time.perf_counter() - t0) * 1e3
    record["max_abs_err"] = hold(
        f"vpu v2 at {s.nsamples} samples",
        cm.migrate_detect_vpu_v2_cuda(a[0], a[1], *a[3:], tables), ref, s,
        "full")
    record.update(detect_bound(s.args, s.plan.n_nodes))
    print(f"vpu v2 day: {record['ms']:.4f} ms (K2 {record['v1_ms']:.4f}, "
          f"K1 v2 {record['k1_v2_ms']:.4f} in the same turns); plain "
          f"version {record['plain_ms']:.1f} ms (one run); gather floor "
          f"{record['smem_bound_ms']:.4f} ms")
    return record


def f1_path(device, n_stations=128, n_windows=2):
    """F1: windows K1 v2 cannot stage. The Icequake grid with
    ``n_stations`` stations x P/S (256 onsets): DetectScan takes its K2
    v2 route on the same plan (K1 v2 refuses it; the reason printed),
    launches K2 v2 once a window and K1 v2 and K2 never, and its results
    are held to the plain window (max_coa and max_coa_n within 1e-5, the
    argmax tie-consistent). Returns K2 v2's launches, a record, and the
    traveltimes and DetectScan's route (detect_route's route, reason and
    plan: archive_locate runs pass 2 on them)."""

    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.signal.scan import DetectScan

    rng = np.random.default_rng(2029)
    tt = icequake_traveltimes(rng, n_stations)
    windows, _ = make_windows(tt, rng, n_windows, plant_window=1)
    scan = DetectScan(tt, NODE_COUNT, FSMP, LSMP, position="classic",
                      transform="energy", min_onset_value=0.4, device=device)
    print(f"f1: {tt.shape[1]} onsets, route {scan.route}: "
          f"{scan.route_reason}")
    check(scan.route == "k2_v2" and "shared memory" in scan.route_reason,
          f"f1: route {scan.route} ({scan.route_reason})")
    detector = scan.detector(NSAMPLES)  # plan built before the counted run
    t = detector.tables
    smem = cm.vpu_v2_smem(detector.tile, t.r_span, detector.n_stages)
    check(smem <= cm.SMEM_LIMIT, f"f1: K2 v2 needs {smem} bytes")
    torch.cuda.synchronize()
    cm.reset_launches()
    t0 = time.perf_counter()
    results = scan.detect(windows)
    wall = time.perf_counter() - t0
    launches = dict(cm.launches)
    check(launches["migrate_detect_vpu_v2"] == n_windows,
          f"f1: {launches['migrate_detect_vpu_v2']} K2 v2 launches for "
          f"{n_windows} windows")
    check(launches["migrate_detect_v2"] == 0
          and launches["migrate_detect_vpu"] == 0,
          f"f1: K1 v2 or K2 was launched ({launches})")

    tt_dev = torch.from_numpy(tt).to(device)
    errs = []
    t0 = time.perf_counter()
    refs = [[x.cpu().numpy() for x in plain_window(block, tt_dev, device)]
            for block in windows]
    plain_wall = time.perf_counter() - t0
    for w, (block, res, ref) in enumerate(zip(windows, results, refs)):
        max_coa, max_coa_n, max_idx, ijk = res
        check(max_coa.shape == (NSAMPLES,) and ijk.shape == (NSAMPLES, 3)
              and np.isfinite(max_coa).all() and np.isfinite(max_coa_n).all(),
              f"f1 window {w}: shapes or non-finite values")
        rel = np.abs(max_coa - ref[0]) / np.abs(ref[0])
        rel_n = np.abs(max_coa_n - ref[1]) / np.abs(ref[1])
        tie = np.abs(ref[0] - plain_coa_at(block, tt_dev, max_idx, device))
        tie = tie / np.abs(ref[0])
        check(rel.max() <= MAX_COA_RTOL and rel_n.max() <= MAX_COA_RTOL,
              f"f1 window {w}: K2 v2 route {rel.max()}, {rel_n.max()}")
        check(tie.max() <= MAX_COA_RTOL, f"f1 window {w}: argmax tie "
              f"{tie.max()}")
        errs.append(float(np.abs(max_coa - ref[0]).max()))
        peak = int(np.argmax(max_coa))
        print(f"f1 window {w}: K2 v2 route vs plain window max_coa "
              f"{rel.max():.2e}, max_coa_n {rel_n.max():.2e}, tie "
              f"{tie.max():.2e}, argmax equal {(max_idx == ref[2]).mean():.4f}"
              f"; peak {max_coa[peak]:.6f} at {ijk[peak].tolist()}")
    print(f"f1: {n_windows} windows through DetectScan's K2 v2 route in "
          f"{wall:.3f} s wall (first call; device ms a window "
          f"{np.round(scan.window_ms, 3).tolist()}), the plain window "
          f"{plain_wall:.3f} s; K2 v2 block {smem} bytes ({t.npp} nodes a "
          f"pass, {cm.VPU_V2_GROUP} onsets a stage, {detector.n_stages} "
          f"stages); launches {launches}")
    return launches["migrate_detect_vpu_v2"], {
        "onsets": tt.shape[1], "route": scan.route,
        "route_reason": scan.route_reason, "route_wall_s": wall,
        "window_ms": scan.window_ms, "plain_window_wall_s": plain_wall,
        "vpu_v2_smem": smem, "tile": detector.tile,
        "n_stages": detector.n_stages, "max_abs_err": max(errs)}, (
            tt, (scan.route, scan.route_reason, scan._plan))


def archive_workspace(root, spacing_km=SPACING_KM, span_s=ARCHIVE_SPAN_S):
    """The archive_detect phase's inputs, made with the port alone: the
    Icequake example's LUT (its stations, its lcc grid at ``spacing_km``,
    homogeneous vp 3.630 and vs 1.833 km/s), one planted source at a grid
    node, 2 x ``span_s`` seconds of 250 Hz three-component synthetics from
    quakemigrate_torch.synthetics (noise on the amplitudes, none on the
    traveltimes), written as a YEAR/JD/STATION STEIM2 archive under
    ``root``. Returns (lut, stations, archive path, planted grid index,
    seconds spent on the LUT, the synthetics and the archive, the planted
    origin time)."""

    from quakemigrate_torch.coords import Proj
    from quakemigrate_torch.io import read_stations
    from quakemigrate_torch.lut import compute_traveltimes
    from quakemigrate_torch.seis import UTCDateTime
    from quakemigrate_torch.synthetics import (
        GaussianDerivativeWavelet,
        simulate_waveforms,
    )

    stations = read_stations(ICEQUAKE_DIR / "inputs" / "iceland_stations.txt")
    grid_spec = dict(
        ll_corner=[-17.24, 64.322, -1.4], ur_corner=[-17.204, 64.336, 0.0],
        node_spacing=[spacing_km] * 3,
        grid_proj=Proj(proj="lcc", units="km", lon_0=-17.222, lat_0=64.329,
                       lat_1=64.323, lat_2=64.335, datum="WGS84",
                       ellps="WGS84", no_defs=True),
        coord_proj=Proj(proj="longlat", datum="WGS84", ellps="WGS84",
                        no_defs=True),
    )
    times = {}
    t0 = time.perf_counter()
    lut = compute_traveltimes(grid_spec, stations, method="homogeneous",
                              phases=["P", "S"], vp=VP, vs=VS)
    times["lut_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    planted = tuple(int(n * f) for n, f in zip(lut.node_count,
                                                (0.45, 0.55, 0.7)))
    source = lut.index2coord([planted])[0]
    wavelet = GaussianDerivativeWavelet(30.0, RATE, span_s)
    stream = simulate_waveforms(
        wavelet, source, lut, magnitude=1.0, angle_of_incidence=80,
        noise={"traveltime": {"P": 0.0, "S": 0.0},
               "amplitude": {"P": 0.05, "S": 0.05}},
        starttime=ARCHIVE_START, rng=np.random.default_rng(2031),
    )
    times["synthetics_s"] = time.perf_counter() - t0
    # The wavelet's zero crossing, its origin, is its middle sample rolled
    # by int(rate * 0.5 / frequency) + 3 samples (GaussianDerivativeWavelet)
    origin = UTCDateTime(ARCHIVE_START) + span_s + (
        int(RATE * 0.5 / 30.0) + 3) / RATE

    t0 = time.perf_counter()
    archive = root / "mSEED"
    for tr in stream:
        day = tr.stats.starttime
        folder = archive / str(day.year) / f"{day.julday:03d}"
        folder.mkdir(parents=True, exist_ok=True)
        tr.data = np.round(tr.data * 1e3).astype(np.int32)  # counts
        tr.write(str(folder / f"{tr.stats.station}_{tr.stats.channel[-1]}.m"),
                 format="MSEED", encoding="STEIM2")
    times["archive_s"] = time.perf_counter() - t0
    return lut, stations, archive, np.array(planted), times, origin


def archive_detect_path(device, f1_route):
    """archive_detect: QuakeScan.detect from a miniSEED archive to
    .scanmseed on the card, without jax. The workspace of
    :func:`archive_workspace`; the example's STALTAOnset (classic, bandpass
    [10, 124, 4], P 0.01/0.25 s, S 0.05/0.5 s) and QuakeScan over
    ARCHIVE_SPAN_S seconds at timestep 2.5 s. Checks: route k1_v2, K1 v2
    launched once a dispatched window and no other detect kernel; each
    window's result held to the plain window on the card for the block
    the scan prepared; the .scanmseed read back by the port's reader
    (five channels of ARCHIVE_SPAN_S x 250 samples); the peak's X/Y/Z
    within one node of the planted source. Then the same detect again,
    warm, and the host layers timed alone on the same windows. Then
    archive_locate on the same workspace (:func:`archive_locate_path`).
    Returns (K1 v2 launches, record, archive_locate's record)."""

    import tempfile

    from quakemigrate_torch.io import Archive
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.seis import UTCDateTime, read
    from quakemigrate_torch.signal.onsets import STALTAOnset, pre_process
    from quakemigrate_torch.signal.scan import QuakeScan

    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        lut, stations, archive_path, planted, times, origin = (
            archive_workspace(root))
        record.update(times)
        check(tuple(lut.node_count) == NODE_COUNT,
              f"archive_detect: grid {lut.node_count}")
        archive = Archive(archive_path, stations,
                          archive_format="YEAR/JD/STATION")
        onset = STALTAOnset(position="classic", sampling_rate=RATE)
        onset.phases = ["P", "S"]
        onset.bandpass_filters = {"P": [10, 124, 4], "S": [10, 124, 4]}
        onset.sta_lta_windows = {p: list(w) for p, w in STA_LTA.items()}
        scan = QuakeScan(archive, lut, onset, str(root / "runs"),
                         "archive_detect", device=device,
                         timestep=ARCHIVE_TIMESTEP)
        windows = {}
        scan.on_window = lambda i, block, result: windows.update(
            {i: (block, result)})
        start = UTCDateTime(ARCHIVE_START) + ARCHIVE_SPAN_S / 2
        end = start + ARCHIVE_SPAN_S

        def detect(label):
            """One detect, its log written to a file beside the run;
            returns its wall seconds."""

            torch.cuda.synchronize()
            return quiet(root, f"detect_{label}",
                         lambda: scan.detect(start, end))[1]

        cm.reset_launches()
        wall = detect("cold")
        launches = dict(cm.launches)
        detect_scan = scan.detect_scan
        n_windows = len(windows)
        dispatched = sum(r is not None for _, r in windows.values())
        print(f"archive_detect: {n_windows} windows ({dispatched} "
              f"dispatched), route {detect_scan.route}, fsmp "
              f"{detect_scan.fsmp}, lsmp {detect_scan.lsmp}, "
              f"{detect_scan.traveltimes.shape[1]} onsets; kernel launches "
              f"{launches}")
        check(detect_scan.route == "k1_v2",
              f"archive_detect: route {detect_scan.route} "
              f"({detect_scan.route_reason})")
        check(n_windows == round(ARCHIVE_SPAN_S / ARCHIVE_TIMESTEP)
              and dispatched == n_windows,
              f"archive_detect: {dispatched} of {n_windows} windows "
              "dispatched")
        check(launches["migrate_detect_v2"] == dispatched,
              f"archive_detect: {launches['migrate_detect_v2']} K1 v2 "
              f"launches for {dispatched} windows")
        check(all(n == 0 for k, n in launches.items()
                  if k != "migrate_detect_v2"),
              f"archive_detect: another detect kernel ran ({launches})")

        # Each window against the plain window on the card
        fsmp, lsmp = detect_scan.fsmp, detect_scan.lsmp
        nsamples = int(round(ARCHIVE_TIMESTEP * RATE))
        tt_dev = torch.from_numpy(detect_scan.traveltimes).to(device)
        errs = {"max_coa": 0.0, "max_coa_n": 0.0, "tie": 0.0,
                "max_abs_err": 0.0, "argmax_equal": []}
        for i, (block, res) in sorted(windows.items()):
            max_coa, max_coa_n, max_idx, ijk = res
            check(max_coa.shape == (nsamples,) and ijk.shape == (nsamples, 3)
                  and np.isfinite(max_coa).all()
                  and np.isfinite(max_coa_n).all(),
                  f"archive_detect window {i}: shapes or non-finite values")
            ref = [x.cpu().numpy() for x in plain_window(
                block, tt_dev, device, fsmp, nsamples)]
            rel = np.abs(max_coa - ref[0]) / np.abs(ref[0])
            rel_n = np.abs(max_coa_n - ref[1]) / np.abs(ref[1])
            tie = np.abs(ref[0] - plain_coa_at(block, tt_dev, max_idx,
                                               device, fsmp, nsamples))
            tie = tie / np.abs(ref[0])
            check(rel.max() <= MAX_COA_RTOL and rel_n.max() <= MAX_COA_N_RTOL
                  and tie.max() <= MAX_COA_RTOL,
                  f"archive_detect window {i}: max_coa {rel.max()}, "
                  f"max_coa_n {rel_n.max()}, tie {tie.max()}")
            errs["max_coa"] = max(errs["max_coa"], float(rel.max()))
            errs["max_coa_n"] = max(errs["max_coa_n"], float(rel_n.max()))
            errs["tie"] = max(errs["tie"], float(tie.max()))
            errs["max_abs_err"] = max(errs["max_abs_err"], float(
                np.abs(max_coa - ref[0]).max()))
            errs["argmax_equal"].append(float((max_idx == ref[2]).mean()))
        print(f"archive_detect: every window vs the plain window: max_coa "
              f"{errs['max_coa']:.2e}, max_coa_n {errs['max_coa_n']:.2e}, "
              f"tie {errs['tie']:.2e}, argmax equal "
              f"{min(errs['argmax_equal']):.4f} at least")

        # The .scanmseed, read back by the port's reader
        day = start
        path = (scan.run.path / "detect" / "scanmseed"
                / f"{day.year}_{day.julday:03d}.scanmseed")
        out = {tr.stats.station: tr for tr in read(path)}
        npts = int(round(ARCHIVE_SPAN_S * RATE))
        check(sorted(out) == sorted(("COA", "COA_N", "X", "Y", "Z"))
              and all(tr.stats.npts == npts for tr in out.values())
              and out["COA"].stats.starttime == start,
              f"archive_detect: .scanmseed {[str(tr) for tr in out.values()]}")
        peak = int(np.argmax(out["COA"].data))
        xyz = np.array([[out["X"].data[peak] / 1e6, out["Y"].data[peak] / 1e6,
                         out["Z"].data[peak] / 1e3
                         / lut.unit_conversion_factor]])
        node = lut.index2coord(xyz, inverse=True)[0]
        dist = int(np.abs(node - planted).max())
        print(f"archive_detect: .scanmseed {len(out)} channels x {npts} "
              f"samples; peak COA {out['COA'].data[peak] / 1e5:.5f} at "
              f"{out['COA'].stats.starttime + peak / RATE}, node "
              f"{node.tolist()} against the planted {planted.tolist()} "
              f"({dist} nodes)")
        check(dist <= 1, f"archive_detect: peak {dist} nodes from the "
              "planted source")

        def split(attrib):
            return {k: sum(row[k] for row in attrib) for k in
                    ("read_wait", "prepare", "dispatch", "drain")}

        cold = {"wall_s": wall, "host_s": split(scan.detect_batch_attrib),
                "window_ms": list(detect_scan.window_ms)}
        scan.on_window = None
        warm_wall = detect("warm")
        warm = {"wall_s": warm_wall, "host_s": split(scan.detect_batch_attrib),
                "window_ms": list(detect_scan.window_ms),
                "fetch_s": sum(detect_scan.fetch_s)}
        for label, run in (("cold", cold), ("warm", warm)):
            host = run["host_s"]
            print(f"archive_detect ({label}): detect {run['wall_s']:.3f} s "
                  f"wall for {ARCHIVE_SPAN_S:.0f} s of data, real-time "
                  f"factor {ARCHIVE_SPAN_S / run['wall_s']:.1f}; device ms "
                  f"a window median {np.median(run['window_ms']):.3f} "
                  f"(min {min(run['window_ms']):.3f}, max "
                  f"{max(run['window_ms']):.3f}); host s: read wait "
                  f"{host['read_wait']:.3f}, prepare {host['prepare']:.3f}, "
                  f"dispatch {host['dispatch']:.3f}, drain/append "
                  f"{host['drain']:.3f}")

        # The host layers alone, a window at a time on the main thread
        layers = {"read": [], "pre_process": [], "prepare": []}
        for i in range(n_windows):
            w_beg = start + ARCHIVE_TIMESTEP * i - scan.pre_pad
            w_end = (start + ARCHIVE_TIMESTEP * (i + 1) - 1 / RATE
                     + scan.post_pad)
            t0 = time.perf_counter()
            data = archive.read_waveform_data(w_beg, w_end)
            t1 = time.perf_counter()
            for phase in onset.phases:
                pre_process(data.waveforms.select(
                    channel=onset.channel_maps[phase]), RATE, False, None,
                    onset.bandpass_filters[phase], data.starttime,
                    data.endtime)
            t2 = time.perf_counter()
            scan._prepare_window(data)
            t3 = time.perf_counter()
            layers["read"].append(t1 - t0)
            layers["pre_process"].append(t2 - t1)
            layers["prepare"].append(t3 - t2)
        layer_ms = {k: 1e3 * float(np.mean(v)) for k, v in layers.items()}
        layer_ms["block"] = layer_ms["prepare"] - layer_ms["pre_process"]
        layer_ms["append"] = 1e3 * (warm["host_s"]["drain"]
                                    - warm["fetch_s"]) / n_windows
        print(f"archive_detect: host layers alone, ms a window: archive read "
              f"{layer_ms['read']:.3f}, pre-process {layer_ms['pre_process']:.3f}"
              f", block (prepare {layer_ms['prepare']:.3f} less pre-process) "
              f"{layer_ms['block']:.3f}, .scanmseed append "
              f"{layer_ms['append']:.3f}")
        locate_record = archive_locate_path(device, root, scan, planted,
                                            origin, start, end, f1_route)
    record.update({
        "windows": n_windows, "dispatched": dispatched, "fsmp": fsmp,
        "lsmp": lsmp, "onsets": int(detect_scan.traveltimes.shape[1]),
        "route": detect_scan.route, "launches": launches,
        "cold": cold, "warm": {k: v for k, v in warm.items()
                               if k != "fetch_s"},
        "real_time_factor": ARCHIVE_SPAN_S / warm_wall,
        "host_layer_ms": layer_ms, "planted": planted.tolist(),
        "peak_node": node.tolist(), "peak_node_distance": dist,
        "vs_plain": {k: v for k, v in errs.items() if k != "argmax_equal"},
        "argmax_equal_min": min(errs["argmax_equal"]),
    })
    return launches["migrate_detect_v2"], record, locate_record


def quiet(root, label, fn):
    """Run ``fn()`` with its log (the stages log to stdout) written to a
    file under ``root``; returns (its result, wall seconds)."""

    import contextlib

    with open(root / f"{label}.log", "w") as log, \
            contextlib.redirect_stdout(log):
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    root_logger = logging.getLogger()
    for handler in list(root_logger.handlers):
        root_logger.removeHandler(handler)
    return out, wall


def median_ms(fn, reps, turns=5, warmup=2):
    """Median over ``turns`` of :func:`cuda_ms` (mean of ``reps``)."""

    return float(np.median([cuda_ms(fn, reps, warmup)
                            for _ in range(turns)]))


def marginalise_bound(tt, window_length, base=None):
    """Bound of the marginalisation, migrate_marginalise over a window of
    ``window_length`` samples for the int32 [n_nodes, O] traveltimes
    ``tt``: the bytes the kernel's function must move, each read or
    written once (the traveltimes; of each onset row the f32 columns the
    window touches, from its least traveltime to its largest plus the
    window; the mask; the f32 [n_nodes] output), not the padding nodes of
    the kernel's plan; against O adds and three more operations (scale,
    exp, sum) a node and window sample. The traveltimes are M1's int32 a
    node-onset where ``base`` is None; given the plan's int32 [tiles, O]
    ``base``, they are M1 v2's: its int16 residuals (``fine16``, 2 bytes
    a real node-onset) and ``base``. Also the floor of the gather, the
    n_nodes x O x len 4-byte reads at the shared-memory bandwidth."""

    tt = np.asarray(tt)
    n_nodes, n_onsets = tt.shape
    columns = (tt.max(axis=0).astype(np.int64) - tt.min(axis=0)
               + window_length)
    tt_bytes = (4 * tt.size if base is None
                else 2 * tt.size + base.numel() * base.element_size())
    nbytes = tt_bytes + 4 * (int(columns.sum()) + n_onsets + n_nodes)
    bound_ms, bound_by = roofline(
        nbytes, n_nodes * window_length * (n_onsets + 3))
    gather_ms = (n_nodes * n_onsets * window_length * 4 / SMEM_BYTES_PER_S
                 * 1e3)
    return {"bound_ms": bound_ms, "bound_by": bound_by,
            "smem_bound_ms": gather_ms}


def m1_setup(tt, node_count, fsmp, nsamples, lsmp, rng, device, route):
    """Pass 2 on the detector that locate's routing builds
    (``signal/scan.py``'s route_detector) for ``route``, the (route,
    reason, plan) that detect_route gave these traveltimes: M1 v2 through
    CudaDetect on "k1_v2", M1 through CudaDetectVPU on "k2_v2"; on seeded
    random onsets at a scan geometry."""

    from quakemigrate_torch.signal.scan import route_detector

    n_onsets = tt.shape[1]
    route, refusal, plan = route
    detector = route_detector(route, plan, tt, node_count, fsmp, nsamples,
                              device)
    onsets = torch.from_numpy(rng.uniform(
        0.3, 4.0, size=(n_onsets, fsmp + nsamples + lsmp)).astype(
            np.float32)).to(device)
    mask = torch.ones(n_onsets, dtype=torch.float32, device=device)
    onsets_log, inv = detector.prepare(onsets, mask, float(n_onsets))
    return SimpleNamespace(
        tt=tt, detector=detector, route=route, refusal=refusal,
        onsets=onsets, mask=mask,
        onsets_log=onsets_log, inv=inv, fsmp=fsmp, nsamples=nsamples,
        tt_dev=torch.from_numpy(tt).to(device))


def m1_v1(detector, onsets_log, inv, start, length):
    """M1 (csrc/migrate_marginalise.cu) on a CudaDetect's plan: M1 v2's
    yardstick, and its equal up to one chunk."""

    from quakemigrate_torch.ops import cuda_migrate as cm

    return cm.migrate_marginalise_cuda(
        onsets_log, detector.base, detector.fine, detector.valid,
        detector.perm, inv, detector.fsmp, detector.nsamples, start, length,
        detector.n_nodes, detector._max_shift)


def m1_resources(length):
    """ptxas's registers and spills of the M1 v2 kernel that a window of
    ``length`` samples takes (its default shape)."""

    from quakemigrate_torch import _build
    from quakemigrate_torch.ops import cuda_migrate as cm

    spn = cm.m1_v2_slots(length)
    tag = f"ILi{cm.M1_V2_NODES_IN_FLIGHT[spn]}ELi{spn}E"
    return next(v for name, v in _build.kernel_resources(
        "qm_migrate_marginalise_v2_kernel").items() if tag in name)


def m1_case(name, s, window, reps=20):
    """Pass 2 on the setup ``s`` (:func:`m1_setup`) at a window ``(start,
    length)``: the route's kernel against the plain version on the card,
    within M1_RTOL_OF_MAX of the map's maximum and the same peak node.
    On K1 v2's route M1 v2 is also held to M1 (bit for bit up to one
    chunk of M1_V2_CHUNK samples, else the largest relative difference),
    and the two are timed in turns (v2, v1, v1, v2; ``reps`` launches a
    turn), with M1 v2's blocks per SM, registers and spills; on K2 v2's
    route M1 is timed alone (median of 5 turns). The plain version is
    timed once. The bound is the route kernel's (:func:`marginalise_bound`:
    M1 v2's int16 residuals on K1 v2's route, with M1's int32 bound beside
    it as ``v1_bound_ms``). Returns a record."""

    from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops.migrate import migrate_marginalise

    detector, start, length = s.detector, *window
    n_onsets = s.tt.shape[1]

    def kernel():
        return detector.marginalise(s.onsets_log, s.inv, start, length)

    def plain():
        return migrate_marginalise(s.onsets, s.tt_dev, s.mask,
                                   float(n_onsets), s.fsmp, s.nsamples,
                                   start, length)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    same_peak = int(torch.argmax(got)) == int(torch.argmax(want))
    check(torch.isfinite(got).all() and err <= M1_RTOL_OF_MAX and same_peak,
          f"m1 {name}: {err} of the maximum, peak equal {same_peak}")
    route = s.route
    record = {"onsets": n_onsets, "window": [start, length], "route": route,
              "refusal_k1_v2": s.refusal, "max_err_of_max": err,
              "max_abs_err": float((got - want).abs().max())}
    if route == "k1_v2":
        def v1():
            return m1_v1(detector, s.onsets_log, s.inv, start, length)

        ref = v1()
        equal = bool(torch.equal(got, ref))
        rel_v1 = float(((got - ref).abs() / ref.abs()).max())
        check(equal or length > cm.M1_V2_CHUNK,
              f"m1 {name}: M1 v2 differs from M1 ({rel_v1}) over "
              f"{length} samples")
        turns = ekb.in_turns({"v2": kernel, "v1": v1}, reps)
        record.update(
            ms=float(np.mean(turns["v2"])), v1_ms=float(np.mean(turns["v1"])),
            turns_ms=turns, equal_to_v1=equal, max_rel_diff_v1=rel_v1,
            blocks_per_sm=cm.marginalise_v2_blocks_per_sm(
                n_onsets, detector.tile, detector.win_floats, length,
                detector.device),
            **m1_resources(length))
    else:
        record["ms"] = median_ms(kernel, reps)
    # The plain version once, warm from the check above
    record["plain_ms"] = median_ms(plain, 1, turns=1, warmup=0)
    record.update(marginalise_bound(
        s.tt, length, detector.base if route == "k1_v2" else None))
    if route == "k1_v2":
        record["v1_bound_ms"] = marginalise_bound(s.tt, length)["bound_ms"]
    extra = (f"; M1 in turns {record['v1_ms']:.4f} ms (bound "
             f"{record['v1_bound_ms']:.4f}), equal "
             f"{record['equal_to_v1']} (largest relative difference "
             f"{record['max_rel_diff_v1']:.2e}), blocks per SM "
             f"{record['blocks_per_sm']}, {record['registers']} registers, "
             f"spills {record['spill_stores']} / {record['spill_loads']}"
             if route == "k1_v2" else "")
    print(f"m1 {name}: route {route}, {n_onsets} onsets, window {start} + "
          f"{length} of {s.nsamples}: {record['ms']:.4f} ms (plain "
          f"{record['plain_ms']:.4f}; bound {record['bound_ms']:.4f} by "
          f"{record['bound_by']}, gather floor "
          f"{record['smem_bound_ms']:.4f}), {err:.2e} of the maximum{extra}; "
          f"K1 v2 refusal: {s.refusal}")
    return record


class NoPlainOnCuda:
    """Within the block, the plain versions that locate's CPU path calls
    raise if they are given CUDA tensors."""

    def __init__(self):
        from quakemigrate_torch.ops import cuda_migrate as cm
        from quakemigrate_torch.signal import scan as scan_module

        self.targets = [(scan_module, "migrate_detect"),
                        (scan_module, "migrate_marginalise"),
                        (cm, "detect_reduce_plan_reference"),
                        (cm, "vpu_v2_reference")]

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.targets]
        for (module, name), fn in zip(self.targets, self.saved):
            def guarded(*args, _fn=fn, _name=name, **kwargs):
                check(not any(torch.is_tensor(a) and a.is_cuda
                              for a in args),
                      f"archive_locate: plain {_name} ran on CUDA tensors")
                return _fn(*args, **kwargs)
            setattr(module, name, guarded)
        return self

    def __exit__(self, *exc):
        for (module, name), fn in zip(self.targets, self.saved):
            setattr(module, name, fn)


def archive_locate_path(device, root, detect, planted, origin, start, end,
                        f1_route):
    """archive_locate: Trigger and QuakeScan.locate on the card, on
    archive_detect's workspace and .scanmseed, without jax. Trigger with
    iceland_trigger.py's settings (marginal window 0.06 s, minimum event
    interval 0.12 s, the normalised trace, static threshold
    LOCATE_THRESHOLD); locate with iceland_locate.py's (centred STA/LTA,
    bandpass [10, 124, 4], P 0.01/0.25 s, S 0.05/0.5 s, GaussianPicker,
    marginal window 0.06 s, cut waveforms), figures logged as not drawn.
    Checks: exactly the planted event triggered, within the marginal
    window of its origin time; pass 1 on route k1_v2, one K1 v2 launch an
    event read and one M1 v2 launch an event that passes the
    marginal-window gate, none of M1, no other detect kernel and no plain version on a CUDA tensor;
    each pass 1 against the plain migration on the card (max_coa 1e-5,
    max_coa_n 1e-4, argmax tie-consistent); each pass 2 (M1 v2) result
    against the plain migrate_marginalise on the card (M1_RTOL_OF_MAX of
    the maximum, the same peak node); the spline hypocentre within one
    node of the planted source; the .event, .picks and cut waveforms read
    back by the port's readers, with P and S picks at every station;
    locate run again, warm, for its per-event split. Then M1 v2 and M1
    (bit-equal) in turns at the locate window, K1 v2 timed; M1 v2 at one
    chunk, three chunks and archive_detect's window (:func:`m1_case`);
    and M1 at F1's geometry (256 onsets, on ``f1_route``, F1's traveltimes
    and DetectScan's route, k2_v2: CudaDetectVPU). Returns a record."""

    from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
    from quakemigrate_torch.io import read_scanmseed, read_triggered_events
    from quakemigrate_torch.io.table import read_csv
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops.migrate import (
        _prepare_onsets,
        migrate_detect,
        migrate_marginalise,
    )
    from quakemigrate_torch.seis import UTCDateTime, read
    from quakemigrate_torch.signal import QuakeScan, Trigger
    from quakemigrate_torch.signal.onsets import STALTAOnset
    from quakemigrate_torch.signal.pickers import GaussianPicker

    lut, run = detect.lut, detect.run
    runs, run_name = run.path.parent, run.name

    # Trigger, on the host
    trig = Trigger(lut, run_path=str(runs), run_name=run_name,
                   marginal_window=LOCATE_MARGINAL_WINDOW,
                   min_event_interval=LOCATE_MIN_EVENT_INTERVAL,
                   normalise_coalescence=True, threshold_method="static",
                   static_threshold=LOCATE_THRESHOLD)
    _, trigger_s = quiet(root, "trigger", lambda: trig.trigger(start, end))
    (data, _), _ = quiet(root, "read_scanmseed", lambda: read_scanmseed(
        run, start, end, 0.0, lut.unit_conversion_factor))
    coa_n = np.asarray(data["COA_N"])
    peak = int(np.argmax(coa_n))
    away = np.abs(np.arange(coa_n.size) - peak) > round(
        LOCATE_MIN_EVENT_INTERVAL * RATE)
    events = read_triggered_events(run, starttime=start, endtime=end)
    print(f"archive_locate: trigger {trigger_s:.3f} s wall; the normalised "
          f"trace peaks at {coa_n[peak]:.5f}, its maximum beyond "
          f"{LOCATE_MIN_EVENT_INTERVAL} s of the peak is "
          f"{coa_n[away].max():.5f} (threshold {LOCATE_THRESHOLD}); "
          f"{len(events)} event(s) triggered: "
          f"{[str(t) for t in events['CoaTime']]}, planted origin {origin}")
    check(len(events) == 1 and abs(events["CoaTime"][0] - origin)
          < LOCATE_MARGINAL_WINDOW,
          f"archive_locate: triggered {[str(t) for t in events['CoaTime']]}"
          f" for the origin {origin}")

    # Locate, on the card
    onset = STALTAOnset(position="centred", sampling_rate=RATE)
    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [10, 124, 4], "S": [10, 124, 4]}
    onset.sta_lta_windows = {p: list(w) for p, w in STA_LTA.items()}
    picker = GaussianPicker(onset=onset)
    picker.plot_picks = True
    scan = QuakeScan(detect.archive, lut, onset, str(runs), run_name,
                     device=device, picker=picker)
    scan.marginal_window = LOCATE_MARGINAL_WINDOW
    scan.write_cut_waveforms = True
    seen = []
    scan.on_event = lambda event, pass1, handle: seen.append(
        (event, pass1, handle))
    torch.cuda.synchronize()
    cm.reset_launches()
    with NoPlainOnCuda():
        _, locate_s = quiet(root, "locate",
                            lambda: scan.locate(starttime=start, endtime=end))
    torch.cuda.synchronize()
    launches = dict(cm.launches)
    n_read = len(seen)
    n_gated = sum(handle is not None for _, _, handle in seen)
    print(f"archive_locate: locate {locate_s:.3f} s wall, route "
          f"{scan.locate_route}; {n_read} event(s) migrated, {n_gated} "
          f"through the marginal-window gate; kernel launches {launches}")
    check(scan.locate_route == "k1_v2", f"archive_locate: route "
          f"{scan.locate_route}")
    check(n_read == len(events) and n_gated == n_read,
          f"archive_locate: {n_read} migrated, {n_gated} gated of "
          f"{len(events)}")
    check(launches["migrate_detect_v2"] == n_read
          and launches["migrate_marginalise_v2"] == n_gated
          and launches["migrate_marginalise"] == 0
          and all(n == 0 for k, n in launches.items()
                  if k not in ("migrate_detect_v2", "migrate_marginalise_v2")),
          f"archive_locate: launches {launches}")

    # Each pass against its plain version on the card
    tt_dev = torch.from_numpy(scan._traveltime_table()).to(device)
    errs = {"max_coa": 0.0, "max_coa_n": 0.0, "tie": 0.0, "m1": 0.0,
            "m1_abs": 0.0, "pass1_abs": 0.0}
    for event, (max_coa, max_coa_n, max_idx), handle in seen:
        inp = event._marginalise_inputs
        fsmp, nsamples = inp["fsmp"], inp["nsamples"]
        ref = [x.cpu().numpy() for x in migrate_detect(
            inp["block"], tt_dev, inp["mask"], inp["available"], fsmp,
            nsamples)]
        onsets_log = _prepare_onsets(inp["block"], inp["mask"])
        t = torch.arange(nsamples, device=device)
        rows = tt_dev[torch.from_numpy(max_idx).long().to(device)].long()
        acc = torch.zeros(nsamples, dtype=torch.float32, device=device)
        for o in range(onsets_log.shape[0]):
            acc = acc + onsets_log[o][fsmp + rows[:, o] + t]
        at_idx = torch.exp(acc / inp["available"]).cpu().numpy()
        rel = float((np.abs(max_coa - ref[0]) / np.abs(ref[0])).max())
        rel_n = float((np.abs(max_coa_n - ref[1]) / np.abs(ref[1])).max())
        tie = float((np.abs(ref[0] - at_idx) / np.abs(ref[0])).max())
        check(rel <= MAX_COA_RTOL and rel_n <= MAX_COA_N_RTOL
              and tie <= MAX_COA_RTOL,
              f"archive_locate pass 1 {event.uid}: max_coa {rel}, max_coa_n "
              f"{rel_n}, tie {tie}")
        errs["max_coa"] = max(errs["max_coa"], rel)
        errs["max_coa_n"] = max(errs["max_coa_n"], rel_n)
        errs["tie"] = max(errs["tie"], tie)
        errs["pass1_abs"] = max(errs["pass1_abs"],
                                float(np.abs(max_coa - ref[0]).max()))
        marginal, copied = handle
        copied.synchronize()
        i0, i1 = event.trim_bounds
        want = migrate_marginalise(inp["block"], tt_dev, inp["mask"],
                                   inp["available"], fsmp, nsamples, i0,
                                   i1 - i0).cpu()
        m1_err = float((marginal - want).abs().max() / want.abs().max())
        same_peak = int(torch.argmax(marginal)) == int(torch.argmax(want))
        check(m1_err <= M1_RTOL_OF_MAX and same_peak,
              f"archive_locate M1 {event.uid}: {m1_err} of the maximum, "
              f"peak equal {same_peak}")
        errs["m1"] = max(errs["m1"], m1_err)
        errs["m1_abs"] = max(errs["m1_abs"],
                             float((marginal - want).abs().max()))
        print(f"archive_locate {event.uid}: window fsmp {fsmp} + {nsamples} "
              f"samples, marginal window [{i0}, {i1}); pass 1 vs plain "
              f"max_coa {rel:.2e}, max_coa_n {rel_n:.2e}, tie {tie:.2e}, "
              f"argmax equal {(max_idx == ref[2]).mean():.4f}; M1 vs plain "
              f"{m1_err:.2e} of the maximum, peak node equal {same_peak}")

    # The location and the files, read back by the port's readers
    event = seen[0][0]
    node = lut.index2coord([event.hypocentre], inverse=True)[0]
    dist = int(np.abs(node - planted).max())
    out = run.path / "locate"
    header, rows = read_csv(out / "events" / f"{event.uid}.event")
    written = dict(zip(header, rows[0]))
    pick_header, pick_rows = read_csv(out / "picks" / f"{event.uid}.picks")
    cut = read(out / "raw_cut_waveforms" / f"{event.uid}.m")
    print(f"archive_locate: origin {event.otime} (planted {origin}), spline "
          f"node {node.tolist()} against the planted {planted.tolist()} "
          f"({dist} nodes); .event X {written['X']}, Y {written['Y']}, Z "
          f"{written['Z']}, COA {written['COA']}; {len(cut)} cut traces")
    check(dist <= 1, f"archive_locate: located {dist} nodes from the "
          "planted source")
    check(len(header) == 20 and written["EventID"] == event.uid,
          f"archive_locate: .event {header}")
    check(len(cut) == 3 * len(lut.station_data["Name"]),
          f"archive_locate: {len(cut)} cut traces")
    picks = [dict(zip(pick_header, r)) for r in pick_rows]
    residuals = {}
    for row in picks:
        tt = float(np.ravel(lut.traveltime_to(row["Phase"], planted,
                                              row["Station"]))[0])
        if row["PickTime"] != "-1":
            residuals[f"{row['Station']}_{row['Phase']}"] = round(
                UTCDateTime(row["PickTime"]) - (origin + tt), 6)
    stations = list(lut.station_data["Name"])
    print(f"archive_locate: {len(residuals)} of {len(picks)} picks made; "
          f"residual (s) against the modelled arrival at the planted node: "
          f"{residuals}")
    check(len(picks) == 2 * len(stations)
          and sorted(residuals) == sorted(f"{s}_{p}" for s in stations
                                          for p in ("P", "S")),
          f"archive_locate: picks {sorted(residuals)}")

    def split():
        return {k: [row.get(k) for row in scan.locate_event_attrib]
                for k in ("read_wait", "onsets", "pass1", "pass2",
                          "pass2_wait", "location", "picks", "writes")}

    # The same locate again, warm: the plan and its tables are on the card
    cold_split = split()
    scan.on_event = None
    _, warm_s = quiet(root, "locate_warm",
                      lambda: scan.locate(starttime=start, endtime=end))
    warm_split = split()
    print(f"archive_locate: per-event split, host s, cold ({locate_s:.3f} s "
          f"wall): {cold_split}; warm ({warm_s:.3f} s wall): {warm_split}")

    # M1 v2 and M1 in turns at the locate window, M1 v2 also at one chunk,
    # three chunks and archive_detect's window, and M1 at F1's geometry
    # (K1 v2 refuses its plan: CudaDetectVPU's route) with its launches
    inp = event._marginalise_inputs
    detector = scan._locate_detector  # pass 1's, at the event's geometry
    check((detector.fsmp, detector.nsamples) == (inp["fsmp"],
                                                 inp["nsamples"]),
          "archive_locate: pass 1's detector is not at the event's geometry")
    i0, i1 = event.trim_bounds

    def m1_v2_locate():
        return detector.marginalise(inp["onsets_log"], inp["inv_available"],
                                    i0, i1 - i0)

    def m1_locate():
        return m1_v1(detector, inp["onsets_log"], inp["inv_available"], i0,
                     i1 - i0)

    m1_equal = bool(torch.equal(m1_v2_locate(), m1_locate()))
    check(m1_equal, "archive_locate: M1 v2 differs from M1 at the locate "
          "window")
    m1_turns = ekb.in_turns({"v2": m1_v2_locate, "v1": m1_locate}, 50)
    m1_plain_ms = median_ms(lambda: migrate_marginalise(
        inp["block"], tt_dev, inp["mask"], inp["available"], inp["fsmp"],
        inp["nsamples"], i0, i1 - i0), 3, turns=1, warmup=0)
    tt = scan._traveltime_table()
    m1_bound = marginalise_bound(tt, i1 - i0)
    m1_v2_bound = marginalise_bound(tt, i1 - i0, detector.base)
    k1_v2_ms = median_ms(lambda: detector.launch(inp["onsets_log"],
                                                 inp["inv_available"]), 50)
    k1_v2_bound = detect_bound(
        (inp["onsets_log"], detector.base, detector.fine16, detector.valid,
         inp["inv_available"], inp["fsmp"], inp["nsamples"]),
        detector.n_nodes)
    m1_v2_resources = {
        "blocks_per_sm": cm.marginalise_v2_blocks_per_sm(
            tt.shape[1], detector.tile, detector.win_floats, i1 - i0,
            device),
        **m1_resources(i1 - i0)}
    print(f"archive_locate: at the locate window ({i1 - i0} samples) M1 v2 "
          f"in turns {m1_turns['v2'][0]:.4f} / {m1_turns['v2'][1]:.4f} ms, "
          f"M1 {m1_turns['v1'][0]:.4f} / {m1_turns['v1'][1]:.4f} ms, equal "
          f"{m1_equal} (plain {m1_plain_ms:.4f}; bound M1 v2 "
          f"{m1_v2_bound['bound_ms']:.4f} by {m1_v2_bound['bound_by']}, M1 "
          f"{m1_bound['bound_ms']:.4f} by {m1_bound['bound_by']}, gather "
          f"floor {m1_bound['smem_bound_ms']:.4f}; M1 v2 {m1_v2_resources}); "
          f"K1 v2 at the locate window ({inp['nsamples']} samples) "
          f"{k1_v2_ms:.4f} ms (bound {k1_v2_bound['bound_ms']:.4f}, gather "
          f"floor {k1_v2_bound['smem_bound_ms']:.4f})")

    fsmp, nsamples, lsmp = DETECT_WINDOW
    m1_detect = m1_setup(tt, tuple(lut.node_count), fsmp, nsamples, lsmp,
                         np.random.default_rng(2033), device,
                         scan._detect_route())
    m1_windows = {
        name: m1_case(name, m1_detect, window, reps=reps)
        for name, window, reps in (
            ("one chunk", (700, cm.M1_V2_CHUNK), 20),
            ("three chunks", (37, 300), 20),
            ("detect window", (0, nsamples), 5))}
    del m1_detect
    torch.cuda.synchronize()
    cm.reset_launches()
    f1 = m1_case("f1", m1_setup(f1_route[0], NODE_COUNT, FSMP, NSAMPLES,
                                LSMP, np.random.default_rng(2032), device,
                                f1_route[1]), (100, 30))
    torch.cuda.synchronize()
    f1["launches"] = dict(cm.launches)
    check(f1["route"] == "k2_v2" and f1["launches"]["migrate_marginalise"] > 0
          and all(n == 0 for k, n in f1["launches"].items()
                  if k != "migrate_marginalise"),
          f"m1 f1: route {f1['route']}, launches {f1['launches']}")
    return {
        "trigger_s": trigger_s, "locate_s": locate_s,
        "coa_n_peak": float(coa_n[peak]),
        "coa_n_noise_max": float(coa_n[away].max()),
        "threshold": LOCATE_THRESHOLD,
        "events": len(events), "trigger_time": str(events["CoaTime"][0]),
        "origin": str(origin), "otime": str(event.otime),
        "launches": launches, "route": scan.locate_route,
        "vs_plain": errs, "spline_node": node.tolist(),
        "planted": planted.tolist(), "node_distance": dist,
        "pick_residuals_s": residuals, "event_split_s": cold_split,
        "locate_warm_s": warm_s, "event_split_warm_s": warm_split,
        "window": [inp["fsmp"], inp["nsamples"]], "marginal_window": [i0, i1],
        "m1_v2_ms": float(np.mean(m1_turns["v2"])),
        "m1_ms": float(np.mean(m1_turns["v1"])), "m1_turns_ms": m1_turns,
        "m1_equal": m1_equal, "m1_v2_resources": m1_v2_resources,
        "m1_plain_ms": m1_plain_ms, **m1_bound, "m1_v2_bound": m1_v2_bound,
        "k1_v2_ms": k1_v2_ms, "k1_v2_bound": k1_v2_bound,
        "m1_f1": f1, "m1_windows": m1_windows,
    }


def scaled_err(got, ref):
    """Largest |got - ref| over max(|ref|, 1): relative where values are
    large, absolute near zero (the ablations' sums of logs can be 0)."""

    return ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()


def coa_at(s, idx, variant):
    """Plain coalescence of ablation ``variant`` ("full" or "noexp") at
    the local node idx[tile, t] of each tile, from setup ``s``."""

    onsets_log, base, fine, valid, inv_available, fsmp, nsamples = s.args
    t = torch.arange(nsamples, device=onsets_log.device)
    idx = idx.long()
    acc = torch.zeros(idx.shape, dtype=torch.float32,
                      device=onsets_log.device)
    for o in range(base.shape[1]):
        cols = fsmp + base[:, o, None] + fine[:, o, :].gather(1, idx)
        acc = acc + onsets_log[o][cols + t]
    coa = acc * inv_available
    if variant == "full":
        coa = torch.exp(coa)
    return coa * valid.gather(1, idx)


def hold(name, outs, ref, s, variant):
    """A breakdown kernel's outputs against its plain contract; returns
    the largest absolute error of tmax and tsum."""

    err = max(scaled_err(outs[0], ref[0]), scaled_err(outs[2], ref[2]))
    if variant in ("full", "noexp"):
        tie = scaled_err(coa_at(s, outs[1], variant), ref[0])
    else:
        tie = 0.0 if bool((outs[1] == 0).all()) else float("inf")
    abs_err = max((outs[0] - ref[0]).abs().max().item(),
                  (outs[2] - ref[2]).abs().max().item())
    print(f"breakdown[{name}]: err {err:.3e}, argmax tie err {tie:.3e}, "
          f"abs err {abs_err:.3e}")
    check(err <= KERNEL_RTOL, f"{name}: error {err}")
    check(tie <= KERNEL_RTOL, f"{name}: argmax tie error {tie}")
    return abs_err


def breakdown_checks(device):
    """Every breakdown kernel against its plain version at the day-scale
    workload cut to a 625-sample window; kernel and plain timed there.
    K1 v2's ablations against theirs, untimed."""

    from quakemigrate_torch.experiments import exp_kernel_breakdown as exp
    from quakemigrate_torch.ops import cuda_breakdown as cb

    s = exp.setup(nsamples=NSAMPLES, device=device)
    r_span = s.plan.r_span
    full_ref = cb.detect_reduce_ablate_reference(*s.args, "full")
    records = {}
    for variant in cb.ABLATIONS:
        ref = cb.detect_reduce_ablate_reference(*s.args, variant)
        outs = cb.migrate_detect_ablate_cuda(*s.args, r_span, variant)
        records[variant] = {
            "max_abs_err": hold(variant, outs, ref, s, variant),
            "ms_625": cuda_ms(lambda: cb.migrate_detect_ablate_cuda(
                *s.args, r_span, variant), reps=20),
            "plain_ms_625": cuda_ms(lambda: cb.detect_reduce_ablate_reference(
                *s.args, variant), reps=3, warmup=1),
        }
        print(f"breakdown[{variant}] at {NSAMPLES} samples: "
              f"{records[variant]['ms_625']:.4f} ms, plain "
              f"{records[variant]['plain_ms_625']:.4f} ms")

    group, gbase, gwidth = cb.resident_groups(s.args[1], r_span)
    outs = cb.migrate_detect_resident_cuda(*s.args, group, gbase, gwidth)
    records["resident"] = {
        "max_abs_err": hold(f"resident group {group}", outs, full_ref, s,
                            "full"),
    }
    errs = []
    for per_onset, n_stages in [(False, n) for n in cb.STAGES] + [(True, 3)]:
        offs = cb.span_offsets(s.plan.r_spans, per_onset)
        outs = cb.migrate_detect_pipelined_cuda(
            *s.args, torch.from_numpy(offs).to(device), int(offs[-1]),
            n_stages)
        errs.append(hold(f"pipelined stages={n_stages} per_onset="
                         f"{per_onset}", outs, full_ref, s, "full"))
    records["pipelined"] = {"max_abs_err": max(errs)}

    v2_args = (*s.args[:2], torch.from_numpy(s.plan.fine16).to(device),
               *s.args[3:], torch.from_numpy(s.plan.span_off).to(device),
               s.plan.win_floats)
    records["v2"] = {"max_abs_err": max(
        hold(f"v2 {variant}", cb.migrate_detect_v2_ablate_cuda(
            *v2_args, variant), cb.v2_ablate_reference(*s.args, variant), s,
            variant)
        for variant in cb.V2_ABLATIONS)}

    # E1c v2 (every depth) and E1b v2 against their plain versions, which
    # gather through the same slabs; their ablations against K1 v2's
    e1c, e1b = e1_v2_calls(s)
    a = s.args
    plain_c = cb.pipelined_v2_reference(a[0], a[1], *a[3:], e1c.tables)
    plain_b = cb.resident_v2_reference(a[0], *a[3:], e1b.tables)
    errs_c = [hold(f"pipelined v2 stages={n}", e1c(n_stages=n), plain_c, s,
                   "full") for n in cb.PIPELINED_V2_STAGES]
    errs_b = [hold(f"resident v2 group={e1b.tables.group}", e1b(), plain_b,
                   s, "full")]
    for variant in ("noreduce", "nogather"):
        ref = cb.v2_ablate_reference(*a, variant)
        errs_c.append(hold(f"pipelined v2 {variant}", e1c(variant=variant),
                           ref, s, variant))
        errs_b.append(hold(f"resident v2 {variant}", e1b(variant=variant),
                           ref, s, variant))
    records["pipelined_v2"] = {"max_abs_err": max(errs_c)}
    records["resident_v2"] = {"max_abs_err": max(errs_b)}
    torch.cuda.synchronize()
    return records


def e1_v2_calls(s):
    """E1c v2 (2 stages unless asked) and E1b v2 on the setup ``s`` of
    experiments/exp_kernel_breakdown, as calls of (n_stages, variant) and
    (variant), with their tables as attributes."""

    from quakemigrate_torch.ops import cuda_breakdown as cb

    a = s.args
    tables_c = cb.pipelined_v2_tables(s.plan, a[5], s.device)
    tables_b = cb.resident_v2_tables(s.plan, a[5], s.device)

    def e1c(n_stages=2, variant="full"):
        return cb.migrate_detect_pipelined_v2_cuda(
            a[0], a[1], *a[3:], tables_c, n_stages, variant)

    def e1b(variant="full"):
        return cb.migrate_detect_resident_v2_cuda(a[0], *a[3:], tables_b,
                                                  variant)

    e1c.tables, e1b.tables = tables_c, tables_b
    return e1c, e1b


def breakdown_path(s):
    """The breakdown's entry point at the full day-scale window (the setup
    ``s`` of experiments/exp_kernel_breakdown), with the launch counts set
    to 0 just before it; and K1 against its plain version (timed once) at
    that size."""

    from quakemigrate_torch.experiments import exp_kernel_breakdown as exp
    from quakemigrate_torch.ops import cuda_breakdown as cb

    torch.cuda.synchronize()
    cb.reset_launches()
    results = exp.run(s)
    counts = {name: cb.launches[name] for name in (
        "migrate_detect_ablate", "migrate_detect_resident",
        "migrate_detect_pipelined", "migrate_detect_resident_v2",
        "migrate_detect_pipelined_v2")}
    print(f"breakdown path: launches {counts}")
    for name, n in counts.items():
        check(n > 0, f"breakdown path: {name} was never launched")

    t0 = time.perf_counter()
    ref = cb.detect_reduce_ablate_reference(*s.args, "full")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    outs = cb.migrate_detect_ablate_cuda(*s.args, s.plan.r_span, "full")
    abs_err = hold(f"full at {s.nsamples} samples", outs, ref, s, "full")
    print(f"breakdown path: plain version at {s.nsamples} samples "
          f"{plain_ms:.1f} ms (one run)")
    return counts, results, plain_ms, abs_err, detect_bound(
        s.args, s.plan.n_nodes), ref


def e1_v2_turns(s, deep_v1, reps):
    """E1c v2 and E1b v2 on the setup ``s`` of
    experiments/exp_kernel_breakdown: each bit for bit to K1 (tmax, targ,
    tsum); the two timed in turns with E1c v1 at ``deep_v1`` (its record
    in the breakdown: n_stages, blocks_per_sm), E1b v1 at group 2, K1 and
    K1 v2 (``reps`` launches a turn); their NOGATHER and NOREDUCE, each
    bit for bit to K1 v2's and timed; blocks per SM, and registers and
    spills from ptxas."""

    from quakemigrate_torch import _build
    from quakemigrate_torch.experiments.exp_kernel_breakdown import in_turns
    from quakemigrate_torch.ops import cuda_breakdown as cb
    from quakemigrate_torch.ops.cuda_migrate import (
        migrate_detect_cuda,
        migrate_detect_v2_cuda,
    )

    plan, a, device = s.plan, s.args, s.device
    e1c, e1b = e1_v2_calls(s)
    v2_args = (*a[:2], torch.from_numpy(plan.fine16).to(device), *a[3:],
               torch.from_numpy(plan.span_off).to(device), plan.win_floats)
    offs = cb.span_offsets(plan.r_spans, per_onset=False)
    offs_dev = torch.from_numpy(offs).to(device)
    group1, gbase1, gwidth1 = cb.resident_groups(a[1], plan.r_span, 2)
    fns = {
        "e1c_v2": e1c,
        "e1b_v2": e1b,
        "e1c_v1": lambda: cb.migrate_detect_pipelined_cuda(
            *a, offs_dev, int(offs[-1]), deep_v1["n_stages"],
            deep_v1["blocks_per_sm"]),
        "e1b_v1": lambda: cb.migrate_detect_resident_cuda(
            *a, group1, gbase1, gwidth1),
        "k1": lambda: migrate_detect_cuda(*a, plan.r_span),
        "k1_v2": lambda: migrate_detect_v2_cuda(*v2_args),
    }

    def equal(got, want, what):
        same = [torch.equal(x, y) for x, y in zip(got, want)]
        print(f"e1 v2 at {s.nsamples}: {what} equal (tmax, targ, tsum) "
              f"{same}")
        check(all(same), f"e1 v2 at {s.nsamples}: {what} differs")

    k1 = fns["k1"]()
    equal(e1c(), k1, "E1c v2 and K1")
    equal(e1b(), k1, "E1b v2 and K1")
    turns = in_turns(fns, reps=reps)
    record = {"turns_ms": turns}
    for name in ("e1c", "e1b"):
        record[name] = {"ms": float(np.mean(turns[f"{name}_v2"])),
                        "v1_ms": float(np.mean(turns[f"{name}_v1"]))}
    for variant in ("nogather", "noreduce"):
        want = cb.migrate_detect_v2_ablate_cuda(*v2_args, variant)
        equal(e1c(variant=variant), want, f"E1c v2 {variant} and K1 v2's")
        equal(e1b(variant=variant), want, f"E1b v2 {variant} and K1 v2's")
        record["e1c"][f"{variant}_ms"] = cuda_ms(
            lambda: e1c(variant=variant), reps=reps)
        record["e1b"][f"{variant}_ms"] = cuda_ms(
            lambda: e1b(variant=variant), reps=reps)
        record[f"k1_v2_{variant}_ms"] = cuda_ms(
            lambda: cb.migrate_detect_v2_ablate_cuda(*v2_args, variant),
            reps=reps)
    t = e1b.tables
    record["e1c"].update(
        n_stages=2, stride=e1c.tables.stride, box=e1c.tables.box,
        blocks_per_sm=cb.pipelined_v2_blocks_per_sm(
            plan.n_onsets, plan.tile, e1c.tables.stride, 2, device),
        **next(iter(_build.kernel_resources(
            "qm_pipelined_v2_kernelILi0ELi2E").values())))
    record["e1b"].update(
        group=t.group, win_floats=t.win_floats,
        blocks_per_sm=cb.resident_v2_blocks_per_sm(
            plan.n_onsets, plan.tile, t.win_floats, device),
        **next(iter(_build.kernel_resources(
            "qm_resident_v2_kernelILi0E").values())))
    for name in ("k1", "k1_v2", "e1c_v1", "e1b_v1"):
        record[f"{name}_ms"] = float(np.mean(turns[name]))
    print(f"e1 v2 at {s.nsamples} samples, in turns (ms): {turns}")
    for name in ("e1c", "e1b"):
        print(f"e1 v2 at {s.nsamples}: {name} {record[name]}")
    torch.cuda.synchronize()
    return record


def e1_v2_plain(s, plan_ref):
    """E1c v2 and E1b v2 at the setup ``s`` against their plain versions,
    each timed once; each plain version also bit for bit to the plan
    reference ``plan_ref`` that the breakdown path computed. Returns
    ({name: plain ms}, {name: max abs error})."""

    from quakemigrate_torch.ops import cuda_breakdown as cb

    a = s.args
    e1c, e1b = e1_v2_calls(s)
    plains = {
        "e1c": lambda: cb.pipelined_v2_reference(a[0], a[1], *a[3:],
                                                 e1c.tables),
        "e1b": lambda: cb.resident_v2_reference(a[0], *a[3:], e1b.tables),
    }
    plain_ms, errs = {}, {}
    for name, kernel in (("e1c", e1c), ("e1b", e1b)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = plains[name]()
        torch.cuda.synchronize()
        plain_ms[name] = (time.perf_counter() - t0) * 1e3
        same = [torch.equal(x, y) for x, y in zip(ref, plan_ref)]
        print(f"e1 v2 at {s.nsamples}: {name} plain version equal to the "
              f"plan reference {same}; {plain_ms[name]:.1f} ms (one run)")
        check(all(same), f"{name} v2 plain version differs")
        errs[name] = hold(f"{name} v2 at {s.nsamples} samples", kernel(),
                          ref, s, "full")
        del ref
    return plain_ms, errs


def v2_day_path(s):
    """K1 v2 at the day-scale window (the setup ``s``: 30,000 samples,
    K1's plan): bit for bit to K1 (tmax, targ, tsum), the two timed in
    turns (20 launches a turn); v2's NOGATHER and NOREDUCE, each bit for
    bit to K1's (NOREDUCE with the sums of padding nodes at 0, whose
    gather v2 skips) and timed; the blocks per SM of both."""

    from quakemigrate_torch.experiments.exp_kernel_breakdown import in_turns
    from quakemigrate_torch.ops import cuda_breakdown as cb
    from quakemigrate_torch.ops.cuda_migrate import (
        detect_blocks_per_sm,
        detect_v2_blocks_per_sm,
        migrate_detect_cuda,
        migrate_detect_v2_cuda,
    )

    plan, valid = s.plan, s.args[3]
    v2_args = (*s.args[:2], torch.from_numpy(plan.fine16).to(s.device),
               *s.args[3:], torch.from_numpy(plan.span_off).to(s.device),
               plan.win_floats)

    def equal(got, want, what):
        same = [torch.equal(a, b) for a, b in zip(got, want)]
        print(f"v2 day: {what} equal (tmax, targ, tsum) {same}")
        check(all(same), f"v2 day: {what} differs")

    equal(migrate_detect_v2_cuda(*v2_args),
          migrate_detect_cuda(*s.args, plan.r_span), "K1 v2 and K1")
    turns = in_turns({
        "v2": lambda: migrate_detect_v2_cuda(*v2_args),
        "k1": lambda: migrate_detect_cuda(*s.args, plan.r_span),
    }, reps=20)
    record = {"ms": float(np.mean(turns["v2"])),
              "k1_ms": float(np.mean(turns["k1"])), "turns_ms": turns}
    for variant in ("nogather", "noreduce"):
        want = list(cb.migrate_detect_ablate_cuda(*s.args, plan.r_span,
                                                  variant))
        if variant == "noreduce":
            want[0] = torch.where(valid[:, :1] != 0, want[0], 0.0)
            want[2] = torch.where(valid[:, 1:2] != 0, want[2], 0.0)
        equal(cb.migrate_detect_v2_ablate_cuda(*v2_args, variant), want,
              f"v2 {variant} and K1's")
        record[f"{variant}_ms"] = cuda_ms(
            lambda: cb.migrate_detect_v2_ablate_cuda(*v2_args, variant),
            reps=20)
    record["blocks_per_sm"] = detect_v2_blocks_per_sm(
        plan.n_onsets, plan.tile, plan.win_floats, s.device)
    record["k1_blocks_per_sm"] = detect_blocks_per_sm(
        plan.n_onsets, plan.r_span, s.device)
    record.update(detect_bound(s.args, plan.n_nodes))
    print(f"v2 day at {s.nsamples} samples: v2 {record['ms']:.4f} ms, K1 "
          f"{record['k1_ms']:.4f} ms (turns {turns}); v2 nogather "
          f"{record['nogather_ms']:.4f}, noreduce {record['noreduce_ms']:.4f}"
          f" ms; blocks per SM {record['blocks_per_sm']} (K1 "
          f"{record['k1_blocks_per_sm']}); gather floor "
          f"{record['smem_bound_ms']:.4f} ms")
    torch.cuda.synchronize()
    return record


def x16_and_probe_checks(small_tt, rng, device):
    """The shifted-copy kernel against its plain version on the small plan
    (both layouts); then the shifted-copy kernel, v1 and v2, and the
    staging probes, v1 and v2, at the day-scale workload cut to a
    625-sample window (tile 512), through the experiments' own runs: each
    held bit for bit to the production kernel at that plan (packed: to
    its closed form), and timed; and E2 v2 and E4b v2 against their
    plain versions there."""

    from quakemigrate_torch.experiments import exp_dma_probe, exp_x16
    from quakemigrate_torch.ops.cuda_migrate import (
        detect_reduce_plan_reference,
    )
    from quakemigrate_torch.ops.cuda_x16 import LAYOUTS

    small_err = max(
        kernel_case(f"x16 {layout} small", small_tt, (10, 9, 8), 16, 100, 64,
                    (4, 4, 4), rng, device, kernel=layout)["max_abs_err"]
        for layout in LAYOUTS)
    s = exp_x16.setup(nsamples=NSAMPLES, device=device)
    x16 = {r["name"]: r for r in exp_x16.run(s)}
    probe = {r["name"]: r for r in exp_dma_probe.main_probe(s)}
    ref = detect_reduce_plan_reference(*s.args)
    _, x16_v2_err = x16_v2_plain(s, ref)
    _, probe_v2_err = probe_v2_plain(s, ref)
    return small_err, x16, probe, x16_v2_err, probe_v2_err


def x16_v2_plain(s, ref):
    """E2 v2 in both layouts against its plain version on the setup ``s``
    of experiments/exp_x16 (each plain version timed once, and bit for bit
    to the plan reference ``ref``). The kernel's tsum sums the nodes in
    K1's order, the plain version's in torch.sum's, so the kernel is held
    to it within KERNEL_RTOL (tmax and targ equal too, where they are).
    Returns ({layout: plain ms}, the largest absolute error)."""

    from quakemigrate_torch.ops import cuda_x16 as cx
    from quakemigrate_torch.ops.x16 import x16_v2_reference

    a = s.args
    plain_ms, errs = {}, []
    for layout in cx.LAYOUTS:
        tables = cx.x16_v2_tables(s.plan, a[5], s.device, layout)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = x16_v2_reference(a[0], a[1], *a[3:], tables)
        torch.cuda.synchronize()
        plain_ms[layout] = (time.perf_counter() - t0) * 1e3
        same = [torch.equal(x, y) for x, y in zip(plain, ref)]
        outs = cx.migrate_detect_x16_v2_cuda(a[0], a[1], *a[3:], tables)
        equal = [torch.equal(x, y) for x, y in zip(outs, plain)]
        print(f"x16 v2 {layout} at {s.nsamples}: plain version equal to the "
              f"plan reference {same}, {plain_ms[layout]:.1f} ms (one run); "
              f"kernel equal to it (tmax, targ, tsum) {equal}")
        check(all(same), f"x16 v2 {layout}: plain version differs")
        errs.append(hold(f"x16 {layout} v2 at {s.nsamples} samples", outs,
                         plain, s, "full"))
        del plain
    return plain_ms, max(errs)


def probe_v2_plain(s, ref):
    """E4b v2 on the setup ``s``: static2 against its plain version (timed
    once; bit for bit to the plan reference ``ref``), packed equal to its
    closed form. Returns (plain ms, the largest absolute error)."""

    from quakemigrate_torch.ops import cuda_breakdown as cb
    from quakemigrate_torch.ops import cuda_probe as cp

    a = s.args
    tables = cb.pipelined_v2_tables(s.plan, a[5], s.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = cp.detect_reduce_probe_v2_reference(a[0], a[1], *a[3:], tables,
                                                "static2")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = [torch.equal(x, y) for x, y in zip(plain, ref)]
    print(f"probe v2 at {s.nsamples}: static2's plain version equal to the "
          f"plan reference {same}, {plain_ms:.1f} ms (one run)")
    check(all(same), "probe v2: static2's plain version differs")
    err = hold(f"probe static2 v2 at {s.nsamples} samples",
               cp.migrate_detect_probe_v2_cuda(a[0], a[1], *a[3:], tables,
                                               "static2"), plain, s, "full")
    packed = cp.migrate_detect_probe_v2_cuda(
        a[0], a[1], *a[3:], tables, "packed",
        cp.packed_v2_zeros(s.nsamples, s.plan.n_onsets, tables.stride,
                           s.device))
    closed = cp.packed_reference(a[3], s.nsamples)
    same = [torch.equal(x, y) for x, y in zip(packed, closed)]
    print(f"probe v2 at {s.nsamples}: packed equal to its closed form {same}")
    check(all(same), "probe v2: packed differs from its closed form")
    return plain_ms, err


def x16_path(s):
    """The shifted-copy experiment's run at the full day-scale window (v1
    and E2 v2), with the launch counts set to 0 just before it; then v1's
    layouts against their plain version (timed once) and E2 v2's against
    theirs (:func:`x16_v2_plain`) at that size."""

    from quakemigrate_torch.experiments import exp_x16
    from quakemigrate_torch.ops import cuda_x16 as cx
    from quakemigrate_torch.ops.x16 import detect_reduce_stride_reference

    torch.cuda.synchronize()
    cx.reset_launches()
    records = exp_x16.run(s)
    launches = dict(cx.launches)
    print(f"x16 path: launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"x16 path: {name} was never launched")

    t0 = time.perf_counter()
    ref = detect_reduce_stride_reference(*s.args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = [hold(f"x16 {layout} at {s.nsamples} samples",
                 cx.migrate_detect_x16_cuda(*s.args, s.plan.r_span,
                                            s.plan.max_shift, layout),
                 ref, s, "full")
            for layout in cx.LAYOUTS]
    print(f"x16 path: plain version at {s.nsamples} samples {plain_ms:.1f} "
          "ms (one run)")
    # the stride reference adds the same values in the same order as the
    # plan reference, so it serves as E2 v2's plan reference too
    v2_plain_ms, v2_err = x16_v2_plain(s, ref)
    return (launches, {r["name"]: r for r in records}, plain_ms, max(errs),
            v2_plain_ms, v2_err)


def probe_path(s):
    """The staging probes' run at the full day-scale window (v1 and E4b
    v2), with the launch counts set to 0 just before it; then static2
    against its plain version (timed once) and packed against its closed
    form, v1 and v2 (:func:`probe_v2_plain`)."""

    from quakemigrate_torch.experiments import exp_dma_probe
    from quakemigrate_torch.ops import cuda_breakdown as cb
    from quakemigrate_torch.ops import cuda_probe as cp
    from quakemigrate_torch.ops.cuda_migrate import (
        detect_reduce_plan_reference,
    )

    torch.cuda.synchronize()
    cp.reset_launches()
    records = exp_dma_probe.main_probe(s)
    launches = {name: cp.launches[name] for name in (
        "migrate_detect_probe", "migrate_detect_probe_v2")}
    print(f"probe path: launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"probe path: {name} was never launched")

    offs = cb.span_offsets(s.plan.r_spans, per_onset=False, align=4)
    span_off, slot = torch.from_numpy(offs).to(s.device), int(offs[-1])
    t0 = time.perf_counter()
    ref = detect_reduce_plan_reference(*s.args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = hold(f"probe static2 at {s.nsamples} samples",
               cp.migrate_detect_probe_cuda(*s.args, span_off, slot,
                                            "static2"), ref, s, "full")
    packed = cp.migrate_detect_probe_cuda(
        *s.args, span_off, slot, "packed",
        cp.packed_zeros(s.nsamples, slot, s.device))
    closed = cp.packed_reference(s.args[3], s.nsamples)
    packed_err = max((a.float() - b.float()).abs().max().item()
                     for a, b in zip(packed, closed))
    check(packed_err == 0.0, f"probe packed: differs from its closed form "
                             f"by {packed_err}")
    packed_plain_ms = cuda_ms(
        lambda: cp.packed_reference(s.args[3], s.nsamples), reps=3)
    print(f"probe path: static2's plain version at {s.nsamples} samples "
          f"{plain_ms:.1f} ms (one run); packed's closed form "
          f"{packed_plain_ms:.4f} ms")
    v2_plain_ms, v2_err = probe_v2_plain(s, ref)
    return (launches, {r["name"]: r for r in records}, plain_ms,
            packed_plain_ms, max(err, packed_err), v2_plain_ms, v2_err)


def stream_path(device):
    """The streaming probe's run at rows 64, 256 and 1024, 2 GiB streamed
    each, with the launch count set to 0 just before it; each output is
    held to its plain version inside the run."""

    from quakemigrate_torch.experiments import exp_dma_probe
    from quakemigrate_torch.ops import cuda_probe as cp

    torch.cuda.synchronize()
    cp.reset_launches()
    records = exp_dma_probe.main_stream(device,
                                        stream_bytes=SMOKE_STREAM_BYTES)
    launches = cp.launches["stream_probe"]
    print(f"stream path: launches {launches}")
    check(launches > 0, "stream path: stream_probe was never launched")
    return launches, records


def dot_layout_checks(device):
    """The one-hot product layouts in every mode, equal to the plain
    version: every value there is exact. v1 (csrc/dot_layout.cu) at (K,
    M, N, steps) = (64, 256, 384, 3), v2 (csrc/dot_layout_v2.cu, whose
    strips are 256 columns wide) at (128, 256, 512, 3)."""

    from quakemigrate_torch.ops import cuda_dot_layout as cdl
    from quakemigrate_torch.ops import dot_layout as dl

    for name, kernel, shape in (
            ("dot_layout", cdl.dot_layout_cuda, (64, 256, 384, 3)),
            ("dot_layout_v2", cdl.dot_layout_v2_cuda, (128, 256, 512, 3))):
        for mode in dl.MODES:
            out = kernel(mode, *shape, device)
            ref = dl.dot_layout_reference(mode, *shape, device)
            check(torch.equal(out, ref),
                  f"{name} {mode} at {shape} differs from its plain version "
                  f"by {(out - ref).abs().max().item()}")
        print(f"{name}: every mode at (K, M, N, steps) = {shape} equal to "
              "its plain version")


def dot_layout_path(device):
    """The layouts' entry point (experiments/exp_dot_layout.run): every
    mode at the TPU shapes and 4096 steps, v2 and v1 each held to the
    plain version (rtol 1e-6) and timed in turns beside torch.matmul, with
    the launch counts set to 0 just before it. Returns (launches by
    kernel, records with their bounds)."""

    from quakemigrate_torch.experiments import exp_dot_layout
    from quakemigrate_torch.ops import cuda_dot_layout as cdl
    from quakemigrate_torch.ops import dot_layout as dl

    torch.cuda.synchronize()
    cdl.reset_launches()
    records = exp_dot_layout.run(device)
    launches = dict(cdl.launches)
    print(f"dot_layout path: launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"dot_layout path: {name} was never launched")
    for r in records:
        K, M, N, mode = r["K"], r["M"], r["N"], r["mode"]
        nb = N * (2 if dl.MODES[mode] else 1)
        nbytes = 2 * K * M + 2 * K * nb + 4 * r["steps"] * N
        r["bound_ms"], r["bound_by"] = roofline(
            nbytes, dl.flops_per_step(mode, K, M, N) * r["steps"],
            BF16_TC_FLOP_PER_S)
    return launches, records


def x16g_small_checks(small_tt, rng, device):
    """The stride-16 tensor-core kernels against their plain version on
    the small plan: v1 (csrc/migrate_detect_x16g.cu) in both forms at tile
    64, v2 (csrc/migrate_detect_x16g_v2.cu) at tiles 64 and 512 (bricks 4^3
    and 8^3): tmax and tsum within 1e-5 relative, the argmax
    tie-consistent (the plain hi/lo coalescence at the kernel's node within
    1e-5 of the max); noreduce within 1e-5 (node 1's truncation within 1);
    v2's nomain equal to its closed form. Returns the largest absolute
    error of v1 and of v2."""

    from quakemigrate_torch.ops import cuda_x16g as cg
    from quakemigrate_torch.ops import x16g
    from quakemigrate_torch.ops.cuda_migrate import DetectPlan
    from quakemigrate_torch.ops.migrate import _prepare_onsets

    fsmp, nsamples, node_count = 16, 100, (10, 9, 8)
    n_onsets = small_tt.shape[1]
    t_len = fsmp + nsamples + int(small_tt.max()) + 7
    onsets = torch.from_numpy(
        rng.gamma(2.0, 1.5, size=(n_onsets, t_len)).astype(np.float32)
    ).to(device)
    mask = torch.ones(n_onsets, dtype=torch.float32, device=device)
    mask[-1] = 0.0
    onsets_log = _prepare_onsets(onsets, mask).contiguous()
    inv = (1.0 / mask.sum()).reshape(1)
    abs_err = {"v1": 0.0, "v2": 0.0}
    for tile, brick in ((64, (4, 4, 4)), (512, (8, 8, 8))):
        plan = DetectPlan(small_tt, node_count, tile=tile, brick_shape=brick)
        p = cg.plan_on_device(plan, device)
        hi, lo, want, a_pad = cg.build_inputs(p, onsets_log, fsmp, nsamples)
        plain = (hi, lo, a_pad, p.base16_dev, p.fine16, p.valid, inv,
                 nsamples)
        ref = x16g.detect_reduce_x16g_reference(*plain)
        ref_nr = x16g.detect_reduce_x16g_reference(*plain, ablate="noreduce")
        forms = {"v2": lambda ablate: cg.migrate_detect_x16g_v2_cuda(
            p, hi, lo, want, inv, nsamples, ablate=ablate)}
        if tile == 64:
            forms.update({
                f"v1 fuse={fuse}": lambda ablate, fuse=fuse:
                    cg.migrate_detect_x16g_cuda(p, hi, lo, want, inv,
                                                nsamples, fuse=fuse,
                                                ablate=ablate)
                for fuse in (False, True)})
        for name, kernel in forms.items():
            outs = kernel("full")
            at_arg = x16g.coa_at_nodes(*plain[:-1], outs[1])
            errs = [((a - b).abs() / b.abs()).max().item()
                    for a, b in ((outs[0], ref[0]), (outs[2], ref[2]),
                                 (at_arg, ref[0]))]
            key = name[:2]
            abs_err[key] = max(abs_err[key],
                               (outs[0] - ref[0]).abs().max().item())
            print(f"x16g small {name} tile {tile}: rel err tmax "
                  f"{errs[0]:.3e} tsum {errs[1]:.3e}, tie err {errs[2]:.3e}, "
                  f"argmax equal "
                  f"{(outs[1] == ref[1]).float().mean().item():.6f}")
            check(max(errs) <= KERNEL_RTOL,
                  f"x16g small {name} tile {tile}: {errs}")
            if name == "v1 fuse=True":
                continue  # v1's noreduce is one kernel for both forms
            outs = kernel("noreduce")
            err = max(scaled_err(outs[0], ref_nr[0]),
                      scaled_err(outs[2], ref_nr[2]))
            arg_err = (outs[1] - ref_nr[1]).abs().max().item()
            print(f"x16g small {name} tile {tile} noreduce: err {err:.3e}, "
                  f"node 1 {arg_err}")
            check(err <= KERNEL_RTOL and arg_err <= 1,
                  f"x16g small {name} tile {tile} noreduce differs")
        outs = forms["v2"]("nomain")
        closed = x16g.zero_acc_reference(p.valid, nsamples)
        check(all(torch.equal(o, r) for o, r in zip(outs, closed)),
              f"x16g small v2 tile {tile} nomain differs from its closed "
              "form")
        print(f"x16g small v2 tile {tile} nomain: equal to its closed form")
    return abs_err["v1"], abs_err["v2"]


def x16g_path(s):
    """The stride-16 experiment's run (experiments/exp_x16g.run) at the
    setup ``s``, with the launch counts set to 0 just before it; then v1's
    forms and v2 against the plain version (timed once). Returns
    (launches by kernel, records, plain ms, abs err by kernel, bounds).

    The bound is that of the function the kernel computes, the detect
    contract read through the hi/lo tables: its inputs read once and
    outputs written once, against 2 O adds (hi and lo words) and four
    more operations (scale, exp, valid, sum) per node and sample in
    float32. The floor of the one-hot design on the tensor cores (4 K bf16
    flop per padded node and padded sample) is kept apart as
    ``tc_floor_ms``, and the float32 contract's bound as
    ``contract_bound_ms``."""

    from quakemigrate_torch.experiments import exp_x16g
    from quakemigrate_torch.ops import cuda_x16g as cg
    from quakemigrate_torch.ops import x16g

    torch.cuda.synchronize()
    cg.reset_launches()
    records, inputs = exp_x16g.run(s)
    launches = dict(cg.launches)
    print(f"x16g path at {s.nsamples} samples: launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"x16g path: {name} was never launched")

    hi, lo, want, a_pad = inputs
    plain = (hi, lo, a_pad, s.p.base16_dev, s.p.fine16, s.p.valid,
             s.args[4], s.nsamples)
    t0 = time.perf_counter()
    ref = x16g.detect_reduce_x16g_reference(*plain)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    abs_err = {"v1": 0.0, "v2": 0.0}
    for form in ("expand", "fuse", "v2"):
        outs = exp_x16g.launch(s, inputs, form)
        errs = [((outs[0] - ref[0]).abs() / ref[0]).max().item(),
                ((outs[2] - ref[2]).abs() / ref[2]).max().item(),
                ((x16g.coa_at_nodes(*plain[:-1], outs[1]) - ref[0]).abs()
                 / ref[0]).max().item()]
        key = "v2" if form == "v2" else "v1"
        abs_err[key] = max(abs_err[key],
                           (outs[0] - ref[0]).abs().max().item())
        print(f"x16g path: {form} against its plain version at {s.nsamples} "
              f"samples: rel err tmax {errs[0]:.3e} tsum {errs[1]:.3e}, tie "
              f"err {errs[2]:.3e}, argmax equal "
              f"{(outs[1] == ref[1]).float().mean().item():.6f}")
        check(max(errs) <= KERNEL_RTOL,
              f"x16g {form} at {s.nsamples}: rel errs {errs}")
    print(f"x16g path: plain version {plain_ms:.1f} ms (one run)")
    nbytes = (2 * hi.numel() * 2 + want.numel() * 4 + s.p.fine16.numel() * 4
              + s.p.valid.numel() * 4 + s.p.a_off.numel() * 4 + 4
              + 3 * 4 * s.plan.n_tiles * s.nsamples)
    bound_ms, bound_by = roofline(
        nbytes, s.plan.n_nodes * s.nsamples * (2 * s.p.n_onsets + 4))
    tc_floor_ms, _ = roofline(nbytes, s.flops, BF16_TC_FLOP_PER_S)
    contract = detect_bound(s.args, s.plan.n_nodes)
    bounds = {"bound_ms": bound_ms, "bound_by": bound_by,
              "tc_floor_ms": tc_floor_ms,
              "contract_bound_ms": contract["bound_ms"],
              "contract_bound_by": contract["bound_by"]}
    print(f"x16g path: bound {bound_ms:.4f} ms ({bound_by}); one-hot "
          f"tensor-core floor {tc_floor_ms:.4f} ms; float32 contract "
          f"{contract['bound_ms']:.4f} ms")
    return launches, records, plain_ms, abs_err, bounds


def main():
    from quakemigrate_torch import _build
    from quakemigrate_torch.device import resolve_device

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    device = resolve_device("cuda")
    smi = nvidia_smi()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    print(lib_path.with_suffix(".log").read_text().strip())

    rng = np.random.default_rng(2024)
    small_tt = rng.integers(0, 40, size=(10 * 9 * 8, 6)).astype(np.int32)
    kernel_case("small", small_tt, (10, 9, 8), 16, 100, 64, (4, 4, 4), rng,
                device)
    tt = icequake_traveltimes(rng)
    record = kernel_case("icequake", tt, NODE_COUNT, FSMP, NSAMPLES, 256,
                         (8, 8, 4), rng, device, n_masked=2, time_it=True)

    from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
    from quakemigrate_torch.ops import cuda_migrate as cm

    rng_v2 = np.random.default_rng(2028)
    v2_small = kernel_case("v2 small", small_tt, (10, 9, 8), 16, 100, 64,
                           (4, 4, 4), rng_v2, device, kernel="v2")
    torch.cuda.synchronize()
    cm.reset_launches()  # K1's launches: the yardstick of K1 v2's cases
    v2_record = kernel_case("v2 icequake", tt, NODE_COUNT, FSMP, NSAMPLES,
                            256, (8, 8, 4), rng_v2, device, n_masked=2,
                            time_it=True, kernel="v2")
    k1_launches = cm.launches["migrate_detect"]

    # K2, K2 v2's yardstick on no path: its launches a case, each read
    # straight after a reset
    vpu_v1_launches = {}
    rng_vpu = np.random.default_rng(2025)
    torch.cuda.synchronize()
    cm.reset_launches()
    kernel_case("vpu small", small_tt, (10, 9, 8), 16, 100, 64, (4, 4, 4),
                rng_vpu, device, kernel="vpu")
    torch.cuda.synchronize()
    vpu_v1_launches["small"] = cm.launches["migrate_detect_vpu"]
    cm.reset_launches()
    vpu_record = kernel_case("vpu icequake", tt, NODE_COUNT, FSMP, NSAMPLES,
                             512, (8, 8, 8), rng_vpu, device, n_masked=2,
                             time_it=True, kernel="vpu")
    torch.cuda.synchronize()
    vpu_v1_launches["icequake"] = cm.launches["migrate_detect_vpu"]
    rng_vpu_v2 = np.random.default_rng(2030)
    vpu_v2_small = kernel_case("vpu v2 small", small_tt, (10, 9, 8), 16, 100,
                               64, (4, 4, 4), rng_vpu_v2, device,
                               kernel="vpu_v2")
    vpu_v2_record = kernel_case("vpu v2 icequake", tt, NODE_COUNT, FSMP,
                                NSAMPLES, 512, (8, 8, 8), rng_vpu_v2, device,
                                n_masked=2, time_it=True, kernel="vpu_v2")

    launches, windows, results, planted_ijk = run_slice(tt, rng, device)
    vpu_launches = run_vpu_path(tt, windows, results, planted_ijk, device)
    f1_launches, f1_record, f1_route = f1_path(device)
    archive_launches, archive_record, locate_record = archive_detect_path(
        device, f1_route)
    del f1_route

    checks = breakdown_checks(device)
    s_day = ekb.setup(device=device)
    counts, e1, e1_plain_ms, e1_abs_err, e1_bound, e1_ref = breakdown_path(
        s_day)
    e1_v2_plain_ms, e1_v2_errs = e1_v2_plain(s_day, e1_ref)
    del e1_ref
    resident_v1 = [r for r in e1["resident"] if " v2 " not in r["name"]]
    deep_v1 = [r for r in e1["deep"] if " v2 " not in r["name"]]
    e1_v2_day = e1_v2_turns(s_day, min(deep_v1, key=lambda r: r["ms"]),
                            reps=5)
    torch.cuda.synchronize()
    cm.reset_launches()
    v2_day = v2_day_path(s_day)
    k1_launches += cm.launches["migrate_detect"]
    del s_day
    torch.cuda.empty_cache()
    e1_v2_625 = e1_v2_turns(ekb.setup(nsamples=NSAMPLES, device=device),
                            min(deep_v1, key=lambda r: r["ms"]), reps=20)
    torch.cuda.empty_cache()
    by_name = {r["name"]: r for part in e1.values() for r in part}

    from quakemigrate_torch.experiments import exp_x16

    (x16_small_err, x16_625, probe_625, x16_v2_err_625,
     probe_v2_err_625) = x16_and_probe_checks(
        small_tt, np.random.default_rng(2026), device)
    s30 = exp_x16.setup(device=device)
    day_bound = detect_bound(s30.args, s30.plan.n_nodes)
    (x16_launches, x16_30k, x16_plain_ms, x16_err, x16_v2_plain_ms,
     x16_v2_err) = x16_path(s30)
    (probe_launches, probe_30k, probe_plain_ms, packed_plain_ms,
     probe_err, probe_v2_plain_ms, probe_v2_err) = probe_path(s30)
    torch.cuda.synchronize()
    cm.reset_launches()
    vpu_v2_day = vpu_v2_day_path(s30)
    torch.cuda.synchronize()
    vpu_v1_launches["day"] = cm.launches["migrate_detect_vpu"]
    del s30
    torch.cuda.empty_cache()
    stream_launches, streams = stream_path(device)
    stream = min(streams, key=lambda r: r["ms"])
    stream_bound_ms, stream_bound_by = roofline(stream["stream_bytes"], 0)

    from quakemigrate_torch.experiments import exp_x16g

    dot_layout_checks(device)
    dl_launches, dl_records = dot_layout_path(device)
    dl_configs = {f"{r['mode']} {r['K']}x{r['M']}x{r['N']}": r
                  for r in dl_records}
    dl_head = next(r for r in dl_records if r["mode"] == "kk"
                   and (r["K"], r["M"], r["N"]) == (1536, 1024, 2048))
    x16g_small_err, x16g_v2_small_err = x16g_small_checks(
        small_tt, np.random.default_rng(2027), device)
    x16g_625, _ = exp_x16g.run(exp_x16g.setup(NSAMPLES, device))
    torch.cuda.empty_cache()
    (x16g_launches, x16g_30k, x16g_plain_ms, x16g_err,
     x16g_bounds) = x16g_path(exp_x16g.setup(device=device))

    from quakemigrate_torch.experiments import sass_loops

    census = sass_loops.census(sass_loops.VPU_PATTERNS
                               + ("qm_migrate_detect_v2_kernelILi0E",))
    sass_loops.print_census(census)

    kernels = [{
        "name": "migrate_detect",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect.cu",
        "replaces": "quakemigrate_tpu/ops/pallas_migrate.py:399",
        "launches": k1_launches,
        "max_abs_err": record["max_abs_err"],
        "max_rel_err_tmax": record["max_rel_err_tmax"],
        "max_rel_err_tsum": record["max_rel_err_tsum"],
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"],
        "bound_by": record["bound_by"],
        "smem_bound_ms": record["smem_bound_ms"],
        "library_ms": None,
    }, {
        "name": "migrate_detect_v2",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_v2.cu",
        "replaces": "quakemigrate_tpu/ops/pallas_migrate.py:399",
        # the main path: QuakeScan.detect over the archive (archive_detect);
        # the slice's DetectScan run over prepared blocks beside it
        "launches": archive_launches,
        "slice_launches": launches,
        "locate_launches": locate_record["launches"]["migrate_detect_v2"],
        "locate_ms": locate_record["k1_v2_ms"],
        "locate_bound": locate_record["k1_v2_bound"],
        "archive_detect": archive_record,
        "max_abs_err": max(v2_small["max_abs_err"], v2_record["max_abs_err"],
                           checks["v2"]["max_abs_err"],
                           archive_record["vs_plain"]["max_abs_err"],
                           locate_record["vs_plain"]["pass1_abs"]),
        "max_rel_err_tmax": v2_record["max_rel_err_tmax"],
        "max_rel_err_tsum": v2_record["max_rel_err_tsum"],
        "ms": v2_record["ms"],
        "k1_ms": v2_record["k1_ms"],
        "plain_ms": v2_record["plain_ms"],
        "bound_ms": v2_record["bound_ms"],
        "bound_by": v2_record["bound_by"],
        "smem_bound_ms": v2_record["smem_bound_ms"],
        "library_ms": None,
        "blocks_per_sm": v2_record["blocks_per_sm"],
        "k1_blocks_per_sm": v2_record["k1_blocks_per_sm"],
        "turns_ms": v2_record["turns_ms"],
        "day": v2_day,
    }, {
        "name": "migrate_detect_vpu",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_vpu.cu",
        "replaces": "quakemigrate_tpu/ops/pallas_migrate.py:242",
        # K2 runs on no path: its Icequake case's launches, and each
        # case's, as K2 v2's yardstick
        "launches": vpu_v1_launches["icequake"],
        "yardstick_launches": vpu_v1_launches,
        "max_abs_err": vpu_record["max_abs_err"],
        "max_rel_err_tmax": vpu_record["max_rel_err_tmax"],
        "max_rel_err_tsum": vpu_record["max_rel_err_tsum"],
        "ms": vpu_record["ms"],
        "turns_ms": vpu_v2_record["turns_ms"]["vpu"],
        "plain_ms": vpu_record["plain_ms"],
        "bound_ms": vpu_record["bound_ms"],
        "bound_by": vpu_record["bound_by"],
        "smem_bound_ms": vpu_record["smem_bound_ms"],
        "library_ms": None,
        "day_ms": vpu_v2_day["v1_ms"],
    }, {
        "name": "migrate_detect_vpu_v2",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_vpu_v2.cu",
        "replaces": "quakemigrate_tpu/ops/pallas_migrate.py:242",
        "launches": vpu_launches,
        "max_abs_err": max(vpu_v2_small["max_abs_err"],
                           vpu_v2_record["max_abs_err"],
                           vpu_v2_day["max_abs_err"]),
        "max_rel_err_tmax": vpu_v2_record["max_rel_err_tmax"],
        "max_rel_err_tsum": vpu_v2_record["max_rel_err_tsum"],
        "ms": vpu_v2_record["ms"],
        "v1_ms": vpu_v2_record["v1_ms"],
        "k1_v2_ms": vpu_v2_record["k1_v2_ms"],
        "turns_ms": vpu_v2_record["turns_ms"],
        "plain_ms": vpu_v2_record["plain_ms"],
        "bound_ms": vpu_v2_record["bound_ms"],
        "bound_by": vpu_v2_record["bound_by"],
        "smem_bound_ms": vpu_v2_record["smem_bound_ms"],
        "library_ms": None,
        **{k: vpu_v2_record[k] for k in (
            "npp", "group", "n_stages", "smem", "blocks_per_sm",
            "registers", "spill_stores", "spill_loads")},
        "day": {k: vpu_v2_day[k] for k in (
            "ms", "v1_ms", "k1_v2_ms", "turns_ms", "plain_ms", "bound_ms",
            "bound_by", "smem_bound_ms", "max_abs_err")},
        "f1": {"launches": f1_launches, **f1_record},
        "census": {
            name: {"instructions": n, "loops": [
                {k: rec[k] for k in ("n", "lds32", "lds128", "fadd")}
                for rec in recs]}
            for name, (n, recs) in census.items()},
    }, {
        "name": "migrate_detect_ablate",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect.cu",
        "replaces": "experiments/exp_kernel_breakdown.py:36",
        "launches": counts["migrate_detect_ablate"],
        "max_abs_err": max([e1_abs_err] + [
            checks[r["name"]]["max_abs_err"] for r in e1["ablate"]]),
        "ms": by_name["full"]["ms"],
        "plain_ms": e1_plain_ms,
        **e1_bound,
        "library_ms": None,
        "variants": {
            r["name"]: {"ms": r["ms"], **checks[r["name"]]}
            for r in e1["ablate"]
        },
    }, {
        "name": "migrate_detect_resident",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_resident.cu",
        "replaces": "experiments/exp_kernel_breakdown.py:261",
        "launches": counts["migrate_detect_resident"],
        "max_abs_err": checks["resident"]["max_abs_err"],
        "ms": min(r["ms"] for r in resident_v1),
        "plain_ms": e1_plain_ms,
        **e1_bound,
        "library_ms": None,
        "configs": {r["name"]: r["ms"] for r in resident_v1},
    }, {
        "name": "migrate_detect_pipelined",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_pipelined.cu",
        "replaces": "experiments/exp_kernel_breakdown.py:459",
        "launches": counts["migrate_detect_pipelined"],
        "max_abs_err": checks["pipelined"]["max_abs_err"],
        "ms": min(r["ms"] for r in deep_v1 + e1["pspan"]),
        "plain_ms": e1_plain_ms,
        **e1_bound,
        "library_ms": None,
        "configs": {r["name"]: r["ms"] for r in deep_v1 + e1["pspan"]},
    }, *[{
        "name": f"migrate_detect_{kind}_v2",
        "route": "cuda",
        "source": f"quakemigrate_torch/csrc/migrate_detect_{kind}_v2.cu",
        "replaces": f"experiments/exp_kernel_breakdown.py:{line}",
        "launches": counts[f"migrate_detect_{kind}_v2"],
        "max_abs_err": max(checks[f"{kind}_v2"]["max_abs_err"],
                           e1_v2_errs[key]),
        "ms": e1_v2_day[key]["ms"],
        "plain_ms": e1_v2_plain_ms[key],
        **e1_bound,
        "library_ms": None,
        "v1_ms": e1_v2_day[key]["v1_ms"],
        "k1_ms": e1_v2_day["k1_ms"],
        "k1_v2_ms": e1_v2_day["k1_v2_ms"],
        "turns_ms": e1_v2_day["turns_ms"],
        "day": e1_v2_day[key],
        "ms_625": e1_v2_625[key]["ms"],
        "v1_ms_625": e1_v2_625[key]["v1_ms"],
        "k1_ms_625": e1_v2_625["k1_ms"],
        "k1_v2_ms_625": e1_v2_625["k1_v2_ms"],
        "turns_ms_625": e1_v2_625["turns_ms"],
        "k1_v2_nogather_ms": e1_v2_day["k1_v2_nogather_ms"],
        "k1_v2_noreduce_ms": e1_v2_day["k1_v2_noreduce_ms"],
    } for kind, key, line in (("pipelined", "e1c", 459),
                              ("resident", "e1b", 261))], {
        "name": "migrate_detect_x16",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_x16.cu",
        "replaces": "experiments/exp_x16.py:46",
        "launches": x16_launches["migrate_detect_x16"],
        "max_abs_err": max(x16_small_err, x16_err),
        "ms": x16_30k["x16a"]["ms"],
        "plain_ms": x16_plain_ms,
        **day_bound,
        "library_ms": None,
        "layouts": {
            layout: {"ms": x16_30k[layout]["ms"],
                     "ms_625": x16_625[layout]["ms"],
                     "blocks_per_sm": x16_30k[layout]["blocks_per_sm"]}
            for layout in ("x16a", "x16b")
        },
        "full": {"ms": x16_30k["full"]["ms"],
                 "ms_625": x16_625["full"]["ms"],
                 "blocks_per_sm": x16_30k["full"]["blocks_per_sm"]},
        "ref_ms": x16_30k["ref"]["ms"],
    }, {
        "name": "migrate_detect_x16_v2",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_x16_v2.cu",
        "replaces": "experiments/exp_x16.py:46",
        "launches": x16_launches["migrate_detect_x16_v2"],
        "max_abs_err": max(x16_v2_err_625, x16_v2_err),
        "ms": x16_30k["x16a_v2"]["ms"],
        "plain_ms": x16_v2_plain_ms["x16a"],
        **day_bound,
        "library_ms": None,
        "layouts": {
            name[:-3]: {
                **{k: x16_30k[name][k] for k in (
                    "ms", "turns_ms", "v1_ms", "v1_turns_ms", "nogather_ms",
                    "noreduce_ms", "copy_floats", "smem", "blocks_per_sm",
                    "registers", "spill_stores", "spill_loads")},
                "plain_ms": x16_v2_plain_ms[name[:-3]],
                **{f"{k}_625": x16_625[name][k] for k in (
                    "ms", "turns_ms", "v1_ms", "nogather_ms",
                    "noreduce_ms")}}
            for name in ("x16a_v2", "x16b_v2")
        },
        "k1_ms": x16_30k["x16a_v2"]["k1_ms"],
        "k1_v2_ms": x16_30k["k1_v2"]["ms"],
        "k1_v2_turns_ms": x16_30k["k1_v2"]["turns_ms"],
        "k1_v2_nogather_ms": x16_30k["k1_v2"]["nogather_ms"],
        "k1_v2_noreduce_ms": x16_30k["k1_v2"]["noreduce_ms"],
        "k1_v2_blocks_per_sm": x16_30k["k1_v2"]["blocks_per_sm"],
        "k1_ms_625": x16_625["x16a_v2"]["k1_ms"],
        "k1_v2_ms_625": x16_625["k1_v2"]["ms"],
    }, {
        "name": "migrate_detect_probe",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_pipelined.cu",
        "replaces": "experiments/exp_dma_probe.py:117",
        "launches": probe_launches["migrate_detect_probe"],
        "max_abs_err": probe_err,
        "ms": probe_30k["static2"]["ms"],
        "plain_ms": probe_plain_ms,
        **day_bound,
        "library_ms": None,
        "modes": {
            name: {"ms": probe_30k[name]["ms"],
                   "ms_625": probe_625[name]["ms"]}
            for name in ("full", "ref", "static2", "packed")
        },
        "packed_plain_ms": packed_plain_ms,
    }, {
        "name": "migrate_detect_probe_v2",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_probe_v2.cu",
        "replaces": "experiments/exp_dma_probe.py:117",
        "launches": probe_launches["migrate_detect_probe_v2"],
        "max_abs_err": max(probe_v2_err_625, probe_v2_err),
        "ms": probe_30k["static2_v2"]["ms"],
        "plain_ms": probe_v2_plain_ms,
        **day_bound,
        "library_ms": None,
        "modes": {
            name: {
                **{k: probe_30k[name][k] for k in (
                    "ms", "turns_ms", "v1_ms", "v1_turns_ms",
                    "blocks_per_sm", "smem", "registers", "spill_stores",
                    "spill_loads")},
                **{f"{k}_625": probe_625[name][k] for k in (
                    "ms", "turns_ms", "v1_ms")}}
            for name in ("static2_v2", "packed_v2")
        },
        "ref_v2": {"ms": probe_30k["ref_v2"]["ms"],
                   "turns_ms": probe_30k["ref_v2"]["turns_ms"],
                   "blocks_per_sm": probe_30k["ref_v2"]["blocks_per_sm"],
                   "ms_625": probe_625["ref_v2"]["ms"]},
        "packed_plain_ms": packed_plain_ms,
    }, {
        "name": "stream_probe",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/stream_probe.cu",
        "replaces": "experiments/exp_dma_probe.py:48",
        "launches": stream_launches,
        "max_abs_err": max(r["max_abs_err"] for r in streams),
        "ms": stream["ms"],
        "plain_ms": stream["plain_ms"],
        "bound_ms": stream_bound_ms,
        "bound_by": stream_bound_by,
        "library_ms": stream["library_ms"],
        "rows": stream["rows"],
        "configs": {
            str(r["rows"]): {k: r[k] for k in (
                "ms", "gbps", "plain_ms", "library_ms", "source_sum_gbps")}
            for r in streams
        },
    }, {
        "name": "dot_layout",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/dot_layout.cu",
        "replaces": "experiments/exp_dot_layout.py:31",
        "launches": dl_launches["dot_layout"],
        "max_abs_err": max(r["v1_max_abs_err"] for r in dl_records),
        "ms": dl_head["v1_ms"],
        "plain_ms": dl_head["plain_ms"],
        "bound_ms": dl_head["bound_ms"],
        "bound_by": dl_head["bound_by"],
        "library_ms": dl_head["library_ms"],
        "mode": "kk",
        "shape": [1536, 1024, 2048],
        "steps": dl_head["steps"],
        "configs": {
            key: {"ms": r["v1_ms"], "us_per_step": r["v1_us_per_step"],
                  "tflops": r["v1_tflops"],
                  "staged_bytes_per_step": r["v1_staged_bytes_per_step"],
                  "staged_tbps": r["v1_staged_tbps"],
                  **{k: r[k] for k in (
                      "plain_ms", "bound_ms", "library_ms",
                      "library_us_per_step", "library_tflops")}}
            for key, r in dl_configs.items()
        },
    }, {
        "name": "dot_layout_v2",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/dot_layout_v2.cu",
        "replaces": "experiments/exp_dot_layout.py:31",
        "launches": dl_launches["dot_layout_v2"],
        "max_abs_err": max(r["max_abs_err"] for r in dl_records),
        "ms": dl_head["ms"],
        "v1_ms": dl_head["v1_ms"],
        "plain_ms": dl_head["plain_ms"],
        "bound_ms": dl_head["bound_ms"],
        "bound_by": dl_head["bound_by"],
        "library_ms": dl_head["library_ms"],
        "mode": "kk",
        "shape": [1536, 1024, 2048],
        "steps": dl_head["steps"],
        "configs": {
            key: {k: r[k] for k in (
                "ms", "turns_ms", "us_per_step", "tflops",
                "staged_bytes_per_step", "staged_tbps", "v1_ms",
                "v1_us_per_step", "v1_tflops", "plain_ms", "bound_ms",
                "library_ms", "library_us_per_step", "library_tflops")}
            for key, r in dl_configs.items()
        },
    }, {
        "name": "migrate_detect_x16g",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_x16g.cu",
        "replaces": "experiments/exp_x16g.py:53",
        "launches": x16g_launches["migrate_detect_x16g"],
        "max_abs_err": max(x16g_small_err, x16g_err["v1"]),
        "ms": x16g_30k["expand"]["ms"],
        "plain_ms": x16g_plain_ms,
        **x16g_bounds,
        "library_ms": None,
        "forms": {
            name: {"ms": x16g_30k[name]["ms"],
                   "ms_625": x16g_625[name]["ms"],
                   "tflops": x16g_30k[name]["tflops"],
                   "blocks_per_sm": x16g_30k[name]["blocks_per_sm"],
                   "max_rel_err_tmax_vs_k1":
                       x16g_30k[name]["max_rel_err_tmax"],
                   "tie_rel_err_vs_k1": x16g_30k[name]["tie_rel_err"]}
            for name in ("expand", "fuse")
        },
        "ablations": {
            name: {"ms": x16g_30k[name]["ms"], "ms_625": x16g_625[name]["ms"]}
            for name in exp_x16g.ABLATION_CASES
        },
        "k1_full": {"ms": x16g_30k["full"]["ms"],
                    "ms_625": x16g_625["full"]["ms"],
                    "blocks_per_sm": x16g_30k["full"]["blocks_per_sm"]},
        "tables_ms": x16g_30k["tables"]["ms"],
        "tables_ms_625": x16g_625["tables"]["ms"],
        "hilo_bound": x16g_30k["expand"]["bound"],
    }, {
        "name": "migrate_detect_x16g_v2",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_x16g_v2.cu",
        "replaces": "experiments/exp_x16g.py:53",
        "launches": x16g_launches["migrate_detect_x16g_v2"],
        "max_abs_err": max(x16g_v2_small_err, x16g_err["v2"]),
        "ms": x16g_30k["v2"]["ms"],
        "turns_ms": x16g_30k["v2"]["turns_ms"],
        "fuse_ms": x16g_30k["v2"]["v1_turns_ms"]["fuse"],
        "expand_ms": x16g_30k["v2"]["v1_turns_ms"]["expand"],
        "ms_625": x16g_625["v2"]["ms"],
        "turns_ms_625": x16g_625["v2"]["turns_ms"],
        "fuse_ms_625": x16g_625["v2"]["v1_turns_ms"]["fuse"],
        "expand_ms_625": x16g_625["v2"]["v1_turns_ms"]["expand"],
        "plain_ms": x16g_plain_ms,
        **x16g_bounds,
        "library_ms": None,
        "tflops": x16g_30k["v2"]["tflops"],
        "tc_floor_share": x16g_bounds["tc_floor_ms"] / x16g_30k["v2"]["ms"],
        "blocks_per_sm": x16g_30k["v2"]["blocks_per_sm"],
        "registers": x16g_30k["v2"]["registers"],
        "spill_stores": x16g_30k["v2"]["spill_stores"],
        "spill_loads": x16g_30k["v2"]["spill_loads"],
        "wgmma_serialized": x16g_30k["v2"]["wgmma_serialized"],
        "max_rel_err_tmax_vs_k1": x16g_30k["v2"]["max_rel_err_tmax"],
        "tie_rel_err_vs_k1": x16g_30k["v2"]["tie_rel_err"],
        "equal_to_expand": x16g_30k["v2"]["equal_to_expand"],
        "ablations": {
            name: {"ms": x16g_30k[name]["ms"], "ms_625": x16g_625[name]["ms"]}
            for name in ("v2_nomain", "v2_noreduce")
        },
    }, {
        "name": "migrate_marginalise",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_marginalise.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:291",
        # the k2_v2 route's pass 2 (CudaDetectVPU.marginalise, F1's
        # geometry); on the main path (archive_locate, route k1_v2) it
        # launches no time, and is timed in turns beside M1 v2
        "launches": locate_record["m1_f1"]["launches"]["migrate_marginalise"],
        "locate_launches": locate_record["launches"]["migrate_marginalise"],
        "max_abs_err": locate_record["m1_f1"]["max_abs_err"],
        "ms": locate_record["m1_ms"],
        "plain_ms": locate_record["m1_plain_ms"],
        "bound_ms": locate_record["bound_ms"],
        "bound_by": locate_record["bound_by"],
        "smem_bound_ms": locate_record["smem_bound_ms"],
        "library_ms": None,
        "window": locate_record["marginal_window"],
        "f1": locate_record["m1_f1"],
        "windows_ms": {name: r["v1_ms"] for name, r in
                       locate_record["m1_windows"].items()},
    }, {
        "name": "migrate_marginalise_v2",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_marginalise_v2.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:291",
        # the main path: QuakeScan.locate over the archive (archive_locate)
        "launches": locate_record["launches"]["migrate_marginalise_v2"],
        "max_abs_err": max([locate_record["vs_plain"]["m1_abs"]] + [
            r["max_abs_err"] for r in locate_record["m1_windows"].values()]),
        "max_err_of_max": locate_record["vs_plain"]["m1"],
        "ms": locate_record["m1_v2_ms"],
        "v1_ms": locate_record["m1_ms"],
        "turns_ms": locate_record["m1_turns_ms"],
        "equal_to_v1": locate_record["m1_equal"],
        "plain_ms": locate_record["m1_plain_ms"],
        # its own inputs: int16 residuals and base (M1's int32 bound is
        # in M1's entry)
        **locate_record["m1_v2_bound"],
        "library_ms": None,
        **locate_record["m1_v2_resources"],
        "window": locate_record["marginal_window"],
        "windows": locate_record["m1_windows"],
        "archive_locate": {k: v for k, v in locate_record.items() if k not in (
            "m1_f1", "m1_windows", "m1_ms", "m1_v2_ms", "m1_turns_ms",
            "m1_equal", "m1_v2_resources", "m1_plain_ms", "bound_ms",
            "bound_by", "smem_bound_ms", "m1_v2_bound")},
    }]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: no launch on its path")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
