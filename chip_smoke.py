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
import subprocess
import time

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
DEAD_WINDOW, DEAD_STATION = 3, 5

KERNEL_RTOL = 1e-5
MAX_COA_RTOL = 1e-5
MAX_COA_N_RTOL = 1e-4

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


def plain_window(block, tt_dev, device):
    from quakemigrate_torch.ops.scan_window import detect_window_fused

    tensors = [torch.from_numpy(a).to(device) for a in block]
    return detect_window_fused(
        *tensors, tt_dev, "classic", "energy", 0.4, FSMP, NSAMPLES,
    )


def plain_coa_at(block, tt_dev, idx, device):
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
    t = torch.arange(NSAMPLES, device=device)
    rows = tt_dev[torch.from_numpy(idx).long().to(device)].long()
    acc = torch.zeros(NSAMPLES, dtype=torch.float32, device=device)
    for o in range(onsets_log.shape[0]):
        acc = acc + onsets_log[o][FSMP + rows[:, o] + t]
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
    argmax tie-consistent). Returns K2 v2's launches and a record."""

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
        "n_stages": detector.n_stages, "max_abs_err": max(errs)}


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
    f1_launches, f1_record = f1_path(device)

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
        "launches": launches,
        "max_abs_err": max(v2_small["max_abs_err"], v2_record["max_abs_err"],
                           checks["v2"]["max_abs_err"]),
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
