#!/usr/bin/env python3
"""
Smoke run of quakemigrate_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

1. Requires CUDA (exits non-zero without it) and prints the card's name
   and power limit from nvidia-smi.
2. Builds the CUDA kernels from quakemigrate_torch/csrc with nvcc
   (sm_90a) and prints the build time and the compiler's resource report.
   recursive_stalta: R1 (csrc/recursive_stalta.cu, the recursive STA/LTA)
   on its main path, core.compat.recursive_sta_lta and
   ops.recursive_sta_lta on the card (one launch each, counted from 0),
   then at (26, 2038) and (256, 360,000) in float32 and float64 against
   its plain version on the card (float64 within 1e-12 relative; float32
   no further from the float64 plain version than twice the float32
   plain version), timed with CUDA events beside the plain version and
   its bound. compat_path: core.compat.migrate on the card (the detect
   route's map kernel: on K1 v2's plan M2 v2, and on 256 onsets K2 v2's,
   M2 ring; one launch, nothing else) against device="cpu" within 1e-5,
   and find_max_coa on the card against the CPU (max and argmax equal,
   the normalised max within 1e-6).
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
   onsets, a plan K1 v2 refuses, so CudaDetectVPU's route): one launch of
   M1 ring (csrc/migrate_marginalise_ring.cu) and nothing else, held to
   the plain version, to its own plain version on its tables and to M1
   bit for bit, timed in turns with M1, its table's build time and bytes
   printed. Last, the map path: the same
   event located again with write_coalescence=True (one launch each of
   M2 v2 and of its tables' kernel at the fresh detector's first map,
   csrc/migrate_map_persistent.cu, and no other kernel; the .npy of
   [nx, ny, nz, 61] read back, finite; the spline hypocentre within one
   node of the two-pass run's), its per-event split printed. Then
   plot_path: the same event located with plot_event_summary=True and
   plot_event_video=True on the card and with device="cpu": the video
   keeps the 4-D map, so on the card one launch each of M2 v2 and its
   tables' kernel and no other kernel;
   the .event held to the CPU run's within a digit, the kept map within
   1e-5 of each value of the CPU run's; where matplotlib imports, the
   event summary PDF and the event video GIF (a frame a sample) at the
   JAX package's paths in both runs, else neither (the same device
   work); the figures' status and sizes, the phase's wall and the map's
   copy-back ms printed beside the card's name and power limit. Then
   ring_locate: the same event located on the "k3" route
   (kernel="xla": pass 1 on K3 v2), two-pass on M1 ring and on the map
   path on M2 ring, and again with the ring held back, on M1 and M2's
   simple form: one launch of each kernel named and nothing else, the
   .event files byte-equal (X, Y, Z equal) and the .npy maps equal.
   format_detect: archive_detect's archive cut to 40 s about the planted
   origin and written by the port's writers as MSEED, SAC, GSE2 and
   SEG-Y, each read back equal to the MSEED cut (samples, station and
   channel, start; the rate 250 Hz, from SAC 1 / float32(0.004), its
   float32 delta read as the JAX package reads it); QuakeScan.detect
   over 10 s from each on the card: from MSEED, GSE2 and SEG-Y K1 v2
   once a window, nothing else, each .scanmseed equal to the MSEED run's
   byte for byte; from SAC the reference's outcome, every trace refused
   by the scan (its rate cannot be resampled to the onset's), every
   availability cell 0, the .scanmseed equal byte for byte to a
   device="cpu" run's of the same SAC archive, its route and launches
   printed and recorded.
   mesh_path: QuakeScan(mesh=...) (quakemigrate_torch.parallel) on the
   card, whose one device stands for every device of each mesh, so the
   slabs run in turn on it: detect over 10 s of the same archive about
   the planted origin unsharded, on a grid mesh of 4 slabs of the brick
   plan's tiles and on a 2 x 2 ("batch", "grid") mesh (two windows a
   dispatch): route k1_v2, K1 v2 once a slab and window, nothing else,
   no plain version on a CUDA tensor; each window's max bit for bit the
   unsharded run's, the argmax equal or tie-consistent, the .scanmseed's
   COA equal and COA_N within a count; the planted event located on the
   grid mesh (K1 v2 and M1 v2 once a slab) with the unsharded run's X, Y
   and Z; one F3 window on a grid mesh of 4 slabs (K3 v2 once a slab,
   max and argmax bit for bit the unsharded window's). Prints the device
   ms a window of each run warm and the route's kernel alone, the whole
   plan against the slabs in turns.
   vt_locate_mags: detect -> trigger -> locate with local magnitudes on
   the card at the full width of the Volcanotectonic_Iceland example:
   its 12 stations on its lcc grid at 0.5 km (58 x 57 x 37 nodes), its
   LUT built as dike_intrusion_lut.py builds it (method "1dsweep" on
   iceland_vmodel.txt, sweep_dx 0.1 km; the build's host seconds
   printed), 24 onsets at 50 Hz, 360 s of synthetic STEIM2 along that
   LUT with two planted events, a generated StationXML (and the same
   responses as RESP and SAC_PZ), and
   the example's settings (env_squared STA/LTA, the trigger's region and
   thresholds, response removal with pre_filt (0.05, 0.06, 30, 35) and
   water level 60, its amplitude and magnitude parameters, marginal
   window 1 s, raw and Wood-Anderson cut waveforms). Checks: the two
   events triggered and located within one node; K1 v2 and M1 v2 once an
   event, nothing else, no plain version on a CUDA tensor; a finite ML,
   ML_Err and ML_r2 in each .event, its .amps and WA cut waveforms read
   back; each ML equal, in its 3 written figures, to a locate of the same
   events with device="cpu" and to locates on the card with the responses
   read from RESP and from SAC_PZ. Prints the per-event split with
   magnitudes.
   ops_path: quakemigrate_torch.ops' device functions, the JAX package's
   public names, routed by the tensors' device (ops/routed.py), on the
   Icequake flat table on the card (259,008 nodes, 26 onsets, windows of
   625 samples from step 4's records): migrate_detect_batch over 4
   windows on the "k3" route's K3 v2 (its detector built once for the
   batch) equal to 4 migrate_detect calls bit for bit, each within 1e-5
   (max) and 1e-4 (normalised) of the plain migrate_detect on the card,
   the argmax tie-consistent; the same in float64 on K3 v3 f64
   (csrc/migrate_detect_global_v3.cu), within 1e-12, its per-tile max and
   argmax bit for bit K3 v2 f64's, timed in turns with K3 v2 f64, K3 f64
   and K3 v2; migrate_map over 61 samples on M2 ring (and M2 ring f64) within
   1e-5 (1e-12) of the plain map, each also held to M2 simple (M2 simple
   f64) and K3 v2's (K3 v2 f64's) tmax bit for bit and timed in turns
   with it; detect_reduce on a padded
   slab (node_offset 100,000, n_nodes_real 150,000, 4,000 padding rows)
   bit for bit the unpadded slice's and within 1e-5 of the plain slab;
   a flat table whose span K3 v2's ring cannot hold (one traveltime of
   32,768) on K3 and K3 f64, held to the plain version. No plain version
   runs on a CUDA tensor in the routed calls; each kernel's launches
   counted from 0, and each timed (CUDA events) beside the routed call,
   the plain version and its bound.
   export_path: quakemigrate_torch.export on archive_locate's and
   vt_locate_mags' run directories (kept past their phases): read_run's
   records, one per .event; write_quakeml parsed with xml.etree, one
   event per .event file, each ML equal to the .event's; nlloc_obs one
   line per pick that is not -1; the Snuffler markers (one phase line a
   usable pick) and stations; sac_mfast's SAC files read back by the
   port's reader. Where the device="cpu" locate of vt_locate_mags wrote
   .event, .picks and .amps files equal to the card's byte for byte, its
   exports are byte-equal to the card run's too.
   map_path: the route's map kernel, M2 v2 (csrc/migrate_map_persistent.cu,
   the redesign of M2, csrc/migrate_marginalise_v2.cu), against the
   plain migrate_map on the card at the Icequake locate window (61
   samples, the Icequake plan) and the VT one (201 samples, the VT
   plan): within 1e-5 of each value, its per-sample max bit for bit K1
   v2's tmax, its sum over a marginal window within 1e-6 of M1 v2's, M2
   and the simple form (csrc/migrate_marginalise.cu) bit for bit M2 v2,
   M2 v2 within 1e-5 of its own plain version, M2 v2's tables (built by
   their kernel at the first map) equal to their plain build and timed
   in turns with it; M2 v2, M2, M1 v2 and K1 v2 timed in turns (CUDA
   events), M2 v2 and M2 in three more rounds of turns (M2 v2's median
   must be the faster at both: it is the route's kernel) and by the
   profiler's device time, the simple form, the plain map and the map's
   copy back to a pinned buffer timed; then M2
   ring on F1's route (256 onsets, CudaDetectVPU; one launch, nothing
   else), held to the plain map, its own plain version and M2's simple
   form bit for bit, timed in turns with M2 simple.
   f3_path: a coarse regional scan that no staged kernel takes (40 x 40
   x 16 nodes at 10 km, homogeneous vp 6.0 and vs 3.46 km/s, 12 surface
   stations x P/S at 100 Hz, a residual span of ~3,000 samples): the
   route decided before any launch is "k3" with K1 v2's and K2 v2's
   reasons, on which K3 v2 (csrc/migrate_detect_global_v2.cu, the brick
   plan's windows streamed through an mbarrier ring) takes the plan; 3
   windows through DetectScan launch K3 v2 once each and nothing else,
   held to the plain window on the card (the tolerances of step 4) and
   exactly to the plain version with the kernels' arithmetic (max_coa
   bit for bit, the argmax the first flat argmax at every sample, the
   sum within 1e-4; bit for bit to K3 in max and argmax), the planted
   source within a node; locate's pass 1 there through route_detector
   (K3 v2 once, held exactly, its peak at the planted node); M1 ring over
   100 samples and M2 ring over the window on K3 v2's tables (one launch
   each, nothing else), held to the plain migrate_marginalise and
   migrate_map, to their own plain versions, to M1 and M2 simple bit for
   bit (M1 ring within 1e-6 of M1 over three chunks) and the map's max to
   K3 v2's tmax, and timed in turns with M1 and M2 simple
   (experiments/exp_ring), with their bounds, gather floors,
   registers and spills; the same in double on the plan's K3 v2 f64
   tables: M1 ring f64 and M2 ring f64 (the source on double) against M1
   f64 and M2 simple f64 (bit for bit at 100 samples and over 1,000,
   within 1e-12 over two chunks of 128, the map's max K3 v2 f64's tmax),
   in turns with them; and detect in double on the window's onsets: the
   detector's window on K3 v2 f64 (one launch: F3's layout has several
   groups, where K3 v3 f64's streamed form is the slower), K3 v3 f64
   held to the plain float64 reduction and to K3 v2 f64 bit for bit in
   the per-tile max and argmax, in turns with K3 v2 f64, K3 v2, K3 f64
   and K3 (experiments/exp_double). K3 v2 timed
   in turns with K3
   (csrc/migrate_detect_global.cu), with its bound, gather floor, ring,
   blocks per SM, registers and spills, and a sweep of its onsets a
   stage. Then K3 v2 at the
   Icequake window with kernel="xla" (4 windows, held as at F3), timed
   in turns with K3 and K1 v2; and two plans of the K3 route's toy
   geometry (4 x 4 x 4 nodes, one traveltime of 32,768 samples: K3 v2's
   ring cannot hold its window, so K3 runs; one of 14,999 with
   kernel="xla": K3 v2 on its one-block shape), 2 windows each, held as
   at F3, then locate's kernels on each: M1 and M2's simple form on the
   first (the ring refuses it, as K3 v2 does: the wide-span path), M1
   ring and M2 ring on the second, one launch each, held to the plain
   versions; and the 14,999 plan in float64 (precision="double"): K3 v2
   f64's ring of doubles cannot hold it, so K3 f64 runs, held to the
   plain float64 reduction within 1e-12, then M1 f64 and M2 simple f64
   (csrc/migrate_marginalise.cu on double; the ring of doubles refuses
   the plan too), one launch each, held to the plain float64 functions.
   kurtosis_detect: a new synthetic Icequake workspace;
   QuakeScan.detect with KurtosisOnset (the example's bandpass, kurtosis
   windows 0.25 / 0.5 s, 0.05 s of smoothing) over 60 s on K1 v2 (one
   launch a window, nothing else), each window held to the plain
   kurtosis window on the card, the front end's float32 error against
   float64 within twice the CPU's, the planted source within a node;
   Trigger (static 2.8 on the normalised trace): exactly the planted
   event; QuakeScan.locate of it with the same onset (one K1 v2 and one
   M1 v2 launch), located within a node. decimate_detect: a QuakeScan
   built on that workspace's LUT, the LUT decimated in place by [2, 2,
   2], then detect: the scan migrates on the 36 x 32 x 29 grid (K1 v2
   once a window) and finds the planted source within a decimated node.
   double_path: a third synthetic Icequake workspace; QuakeScan with
   precision="double" over 10 s about the planted event: detect (the
   fused STA/LTA window in float64 on the "k3" route, K3 v3 f64,
   csrc/migrate_detect_global_v3.cu, on K3 v2 f64's tables, once a
   window and nothing else; each window held to the plain float64
   reduction within 1e-12, its max bit for bit K3 v2 f64's, and the
   .scanmseed to a device="cpu" float64 detect of 2 windows: one count),
   Trigger (exactly the planted event), locate two-pass (K3 v3 f64 and
   M1 ring f64, csrc/migrate_marginalise_ring.cu on double, on K3 v2
   f64's tables) and on the map path (M2 ring f64),
   nothing of M1 f64 or M2 simple f64, each against the same locate on
   the CPU in float64 (the .event within a written digit, the marginal
   and the 4-D map within 1e-12); then each float64 kernel at those
   shapes held to its plain version and timed in turns with its float32
   form (experiments/exp_double): K3 v3 f64 at the planted window with
   K3 v2 f64 (bit for bit in the per-tile max and argmax), K3 v2, K3
   f64 and K3; M1 ring f64 with M1 f64, M1 ring and
   M1 (bit for bit M1 f64 at locate's window), M2 ring f64 with M2
   simple f64, M2 ring and M2 simple (bit for bit M2 simple f64, its max
   K3 v2 f64's tmax). standard_path on the same
   workspace in float32: a user's Onset subclass defined here (numpy
   onsets from calculate_onsets only) through detect, Trigger and
   locate, fused_detect=False with the example's STALTAOnset, and
   ClassicSTALTAOnset, each on the detect route's K1 v2 once a window
   and held to the same run on the CPU.
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
   v2, K1 v2, K3 and K3 v2's shapes: each gather loop's instructions,
   loads, adds and register spills (LDL, STL), and its instructions a
   node-onset-sample.

The onset front ends of detect's fused window run on FE1 v2 (STA/LTA)
and FE2 v2 (kurtosis), csrc/front_end_v2.cu (a grid of row segments),
wherever a fused detect window runs on the card:
archive_detect, decimate_detect, double_path's detect and every mesh of
mesh_path check one FE1 v2 launch a window (counted from 0 with the
path's other kernels), kurtosis_detect one FE2 v2 launch a window, the
standard path's none, and no launch of FE1 or FE2 (csrc/front_end.cu,
their yardstick); those detects run under NoPlainOnCuda, which also
refuses the plain front ends (ops.scan_window.fused_onsets and
fused_kurtosis_onsets) a CUDA tensor. archive_detect and kurtosis_detect
also run one window with the scan's front end, with FE1 or FE2 and with
the plain front end called directly (torch.profiler's launches a window,
CUDA-event ms in turns, the host's enqueue). front_end_path then holds
FE1 v2 and FE2 v2 to their plain versions on the card on those paths'
blocks, a 30,000-sample block (the archive block tiled) and 120,000-sample
blocks in float32 and float64, which FE2 cannot stage: FE1 over both
positions and four transforms, FE2 at nsmooth 1, 5 and 12, each printing
its share equal bit for bit and its largest difference; v2 fails unless
equal bit for bit to the plain version and to v1 where v1 takes the
block, v1 above 1e-6 relative in float32 or 1e-13 in float64; FE1 v2
against the CPU's plain version within FRONT_END_RTOL; and times v2, v1
and the plain version on each block in turns, with the profiler's device
time, the wrappers' host enqueue, the bound, and v2's registers, spills
and blocks per SM.

Locate's onsets run on ON1 v2 (the static STA/LTA) and ON2 v2 (the
kurtosis onset), csrc/locate_onsets_v2.cu (a grid of row segments), one
launch a phase of calculate_onsets with the per-station combine fused:
archive_locate (and its map path, plot_path), vt_locate_mags,
double_path's locates and standard_path's STA/LTA detects (two a window)
count ON1 v2 from 0 with cuda_migrate's kernels, kurtosis_detect's locate
ON2 v2, none of ON1 or ON2 (csrc/locate_onsets.cu, their yardstick), and
NoPlainOnCuda refuses their plain versions a CUDA tensor; archive_locate
prints locate_event_attrib's onsets span cold and warm, and
archive_locate and kurtosis_detect time calculate_onsets on the event's
data by the kernel's route and by the plain chain on the card (equal bit
for bit; host wall, the profiler's device work, each phase's call by v2,
v1 and the plain chain in turns). compat_path holds core.compat's
overlapping_sta_lta and centred_sta_lta on the card to device="cpu"
(equal, one ON1 v2 launch each). locate_onsets_path, after
front_end_path, holds ON1 v2 and ON2 v2 (through the routed functions)
and ON1 and ON2 (through their wrappers) bit for bit to their plain
versions on the card at locate's Icequake and VT shapes, compat's rows
(R1's cases), 120,000 samples and rows shorter than every window, both
output modes, float32 and float64, ON1's four transforms, ON2's nsmooth
1, 5 and 12; times v2, v1 and the plain chain in turns (queued device
time, as issued, the profiler's launches a call, the host's enqueue)
beside the bound at locate's S phase, compat's rows and 120,000 samples
in both types, and prints the four kernels' registers, spills and blocks
per SM.

Every kernel line carries its launches on its path (each path run with
the counts set to 0 just before it), its time and its plain version's,
and its bound: the larger of the bytes it must move (inputs read once,
outputs written once) over 3.35 TB/s and the operations of the function
it computes over the peak for their type: float32 at 67 TFLOP/s
(float64 at 34), or
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
# M2 against the plain migrate_map: the onsets summed in the same order,
# the exp's ulps and the plain version's division by available in place
# of the kernel's product with its inverse; and M2's sum over a marginal
# window against M1 v2's, the same values added in another order
MAP_RTOL = 1e-5
MAP_SUM_RTOL = 1e-6
# vt_locate_mags: the Volcanotectonic_Iceland example's inputs and a
# synthetic archive of VT_SPAN_S seconds from VT_START, VT_N_EVENTS
# sources VT_SPACING_S apart at the grid fractions VT_PLANTED, detected
# over VT_DETECT_SPAN_S seconds from VT_START + VT_DETECT_OFFSET_S
VT_DIR = (pathlib.Path(__file__).resolve().parent / "examples"
          / "Volcanotectonic_Iceland")
VT_RATE = 50
VT_START = "2014-08-24T00:01:00.0"
VT_SPAN_S, VT_SPACING_S, VT_N_EVENTS = 360.0, 60.0, 2
VT_PLANTED = ((0.45, 0.55, 0.45), (0.6, 0.4, 0.55))
VT_DETECT_OFFSET_S, VT_DETECT_SPAN_S, VT_TIMESTEP = 60.0, 240.0, 60.0
VT_WAVELET_HZ, VT_MAGNITUDE = 5.0, 2.0
# Counts per m/s of the generated inventory's channels
VT_SENSITIVITY = 1.0e9
# The example's 1dsweep LUT (dike_intrusion_lut.py): its 2-D grid spacing
VT_SWEEP_DX = 0.1
# recursive_stalta: R1 at (rows, n) with (nsta, nlta); float64 against
# its plain version within R1_F64_RTOL relative, float32 no further from
# the float64 plain version than twice the float32 plain version (the CPU
# tests' tolerances, there against the JAX package)
R1_CASES = (((26, 2038), (20, 200)), ((256, 360_000), (200, 5000)))
R1_F64_RTOL = 1e-12
# compat_path: (grid, onsets, samples, first_idx, last_idx, largest
# traveltime) of compat.migrate on a grid K1 v2 takes and on one of 256
# onsets, whose slab K1 v2 cannot stage (the k2_v2 route, M2's simple form)
COMPAT_CASES = {"k1_v2": ((20, 18, 12), 24, 600, 100, 200, 80),
                "k2_v2": ((12, 10, 8), 256, 400, 50, 150, 60)}
# find_max_coa on the card against the CPU: the normalised max is a
# float32 sum over the nodes in another order
COMPAT_NORM_RTOL = 1e-6
# format_detect: archive_detect's archive cut to FORMAT_CUT_S seconds each
# side of the planted origin, in each format; detect over FORMAT_SPAN_S
# seconds from FORMAT_SPAN_S / 2 before the origin
FORMAT_CUT_S, FORMAT_SPAN_S = 20.0, 10.0

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3
# bandwidth, float32 rate outside the tensor cores, and shared-memory
# bandwidth (32 banks x 4 B x 132 SMs at 1980 MHz).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12  # outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12  # tensor cores, dense bf16
SMEM_BYTES_PER_S = 33.5e12
# The streaming probe streams 2 GiB per rows value here (16 GiB in
# experiments/exp_dma_probe.py), to keep the smoke short.
SMOKE_STREAM_BYTES = 2 * 2**30
# f3_path: a coarse regional scan no staged kernel takes (K3's route): 40 x
# 40 x 16 nodes at 10 km, homogeneous vp 6.0 and vs 3.46 km/s, 12 surface
# stations x P/S at 100 Hz, windows of F3_FSMP + F3_NSAMPLES samples and a
# post-pad past the largest traveltime
F3_NODES, F3_SPACING_KM, F3_RATE = (40, 40, 16), 10.0, 100
F3_VP, F3_VS = 6.0, 3.46
F3_FSMP, F3_NSAMPLES, F3_WINDOWS = 200, 1000, 3
F3_STA_LTA = {"P": (0.2, 1.0), "S": (0.2, 1.0)}
# Locate's pass 1 on F3's route: scan samples about the planted peak
F3_LOCATE_NSAMPLES = 400
# K3 and K3 v2 against the plain version with their arithmetic: the max
# and the argmax exact, the sum (its tiles added in another order) within
K3_SUM_RTOL = 1e-4
# kurtosis_detect: KurtosisOnset at the Icequake example's bandpass, with
# kurtosis windows of its LTA lengths and 0.05 s of smoothing (12 samples
# at 250 Hz: numpy's even-length centring); the trigger's static
# threshold on the normalised trace (a CPU rehearsal at 0.05 and 0.1 km:
# the planted event's peak 3.60, the trace's largest value beyond the
# minimum event interval 2.02)
KURTOSIS_WINDOWS = {"P": 0.25, "S": 0.5}
KURTOSIS_SMOOTHING = 0.05
KURTOSIS_THRESHOLD = 2.8
# The kurtosis front end (float32 running sums of x to x^4, in the
# reference's order on every device: ops/rolling.py) on the card against
# its plain version in float32 on the CPU, relative: the CPU tests' float32
# tolerance. Both are also read against float64 on the CPU: before an
# event near 1e-5, after one ~3-4e-3 (the running sums hold the event's
# x^4 and the windows' differences cancel; the reference sums in float32
# too), which is why the card must take the CPU's order to meet it.
FRONT_END_RTOL = 1e-5
# FE1 and FE2 (csrc/front_end.cu) against their plain versions on the card,
# relative: they add in the plain versions' order and round where they
# round, so equal bit for bit is expected; these bounds are what fails
# (FE1 v2 and FE2 v2 fail unless equal bit for bit)
FE_RTOL = {torch.float32: 1e-6, torch.float64: 1e-13}
# The day-scale block of front_end_path: the archive window's block tiled
# to this many samples
FE_DAY_SAMPLES = 30_000
# front_end_path's long blocks (the archive and double_path's blocks tiled;
# a 120 s window at 1 kHz): FE2 cannot stage them, FE2 v2 takes them
FE_LONG_SAMPLES = 120_000
# Blocks the detect paths prepared, kept for front_end_path: "archive"
# (archive_detect's peak window), "kurtosis" (kurtosis_detect's planted
# window and its settings (nsmooth, taper_pad, min_onset_value)), "double"
# (double_path's planted window, float64)
FRONT_END_BLOCKS = {}
# kurtosis_detect's device="cpu" QuakeScan.detect (the plain window over
# all 259,008 nodes, ~10 s a window on the host): the windows before, at
# and after the planted one
KURTOSIS_CPU_WINDOWS = 3


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


def make_windows(tt, rng, n_windows=N_WINDOWS, plant_window=PLANT_WINDOW,
                 node_count=NODE_COUNT, fsmp=FSMP, nsamples=NSAMPLES,
                 lsmp=LSMP, rate=RATE, sta_lta=STA_LTA):
    """``n_windows`` consecutive windows of a continuous 3-component noise
    record of the stations of ``tt`` (phase-major slots) with one planted
    source in window ``plant_window``; returns (windows, planted node
    index). The geometry defaults to the Icequake window's."""

    from quakemigrate_torch.util import time2sample

    n_slots = tt.shape[1]
    n_stations = n_slots // 2
    hop = nsamples
    t_len = fsmp + nsamples + lsmp
    total = (n_windows - 1) * hop + t_len
    waves = rng.normal(size=(n_stations, 3, total)).astype(np.float32)

    planted = tuple(int(rng.integers(min(8, n // 4), n - min(8, n // 4)))
                    for n in node_count)
    node = int(np.ravel_multi_index(planted, node_count))
    origin = plant_window * hop + fsmp + min(300, nsamples // 2)
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
        [time2sample(sta_lta[p][0], rate) for p in ("P", "S")
         for _ in range(n_stations)], dtype=np.int32)
    nlta = np.array(
        [time2sample(sta_lta[p][1], rate) for p in ("P", "S")
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
    acc = torch.zeros(nsamples, dtype=onsets_log.dtype, device=device)
    for o in range(onsets_log.shape[0]):
        acc = acc + onsets_log[o][fsmp + rows[:, o] + t]
    return torch.exp(acc / available).cpu().numpy()


def run_slice(tt, rng, device):
    from quakemigrate_torch.signal.scan import DetectScan

    windows, node = make_windows(tt, rng)
    planted_ijk = np.array(np.unravel_index(node, NODE_COUNT))
    scan = DetectScan(tt, NODE_COUNT, FSMP, LSMP, device=device)
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
        detect_window_cuda,
        detect_window_fused,
    )

    block = [torch.from_numpy(a).to(device) for a in windows[0]]
    kernel_ms = cuda_ms(lambda: detect_window_cuda(
        scan.front_end, block, detector, scan.n_nodes), reps=10)
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
    scan = DetectScan(tt, NODE_COUNT, FSMP, LSMP, device=device)
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
    lut, times["lut_s"] = quiet(root, "lut", lambda: compute_traveltimes(
        grid_spec, stations, method="homogeneous", phases=["P", "S"],
        vp=VP, vs=VS))

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


def archive_onset():
    """The Icequake example's STALTAOnset (classic, bandpass [10, 124, 4],
    P 0.01/0.25 s, S 0.05/0.5 s) at RATE."""

    from quakemigrate_torch.signal.onsets import STALTAOnset

    onset = STALTAOnset(position="classic", sampling_rate=RATE)
    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [10, 124, 4], "S": [10, 124, 4]}
    onset.sta_lta_windows = {p: list(w) for p, w in STA_LTA.items()}
    return onset


def archive_detect_path(device, f1_route, keep=None):
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
    archive_locate on the same workspace (:func:`archive_locate_path`),
    whose locate outputs are kept under ``keep`` for export_path (the
    record's "export": run dir, stations, units, no CPU run). Returns (K1
    v2 launches, record, archive_locate's record)."""

    import tempfile

    from quakemigrate_torch.io import Archive
    from quakemigrate_torch.ops import cuda_front_end as cfe
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.seis import UTCDateTime, read
    from quakemigrate_torch.signal.onsets import pre_process
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
        onset = archive_onset()
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
        cfe.reset_launches()
        with NoPlainOnCuda("archive_detect"):
            wall = detect("cold")
        launches = dict(cm.launches)
        fe_launches = dict(cfe.launches)
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
        check(fe_launches == front_end_only("front_end_stalta_v2",
                                            dispatched),
              f"archive_detect: front-end launches {fe_launches} for "
              f"{dispatched} windows")

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
              f"{min(errs['argmax_equal']):.4f} at least; FE1 launches "
              f"{fe_launches}")
        peak_window = max(windows, key=lambda i: windows[i][1][0].max())
        FRONT_END_BLOCKS["archive"] = windows[peak_window][0]

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
        window = front_end_window("archive_detect", scan,
                                  windows[peak_window][0])
        window["scan_dispatch_s"] = warm["host_s"]["dispatch"] / n_windows
        print(f"archive_detect: host layers alone, ms a window: archive read "
              f"{layer_ms['read']:.3f}, pre-process {layer_ms['pre_process']:.3f}"
              f", block (prepare {layer_ms['prepare']:.3f} less pre-process) "
              f"{layer_ms['block']:.3f}, .scanmseed append "
              f"{layer_ms['append']:.3f}")
        locate_record = archive_locate_path(device, root, scan, planted,
                                            origin, start, end, f1_route)
        if keep is not None:
            locate_record["export"] = (
                keep_locate(scan.run.path, keep, "archive_locate"),
                stations, lut.unit_name, None)
        record["format_detect"] = format_detect_path(device, root, lut,
                                                     stations, origin)
        record["mesh_path"] = mesh_path(device, root, lut, stations, origin)
    record.update({
        "windows": n_windows, "dispatched": dispatched, "fsmp": fsmp,
        "lsmp": lsmp, "onsets": int(detect_scan.traveltimes.shape[1]),
        "route": detect_scan.route, "launches": launches,
        "front_end_launches": fe_launches, "front_end_window": window,
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
    CudaDetect on "k1_v2", M1 ring through CudaDetectVPU on "k2_v2" (its
    ring tables built here, before any counted call: their build seconds
    and bytes in ``ring_build``); on seeded random onsets at a scan
    geometry."""

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
    ring_build = None
    if route == "k2_v2":
        check(detector.ring_refusal is None, f"the ring refuses the "
              f"{route} plan: {detector.ring_refusal}")
        t0 = time.perf_counter()
        tables = detector.ring_tables()
        ring_build = {"wall_s": time.perf_counter() - t0,
                      "build_s": tables.build_s, "bytes": tables.nbytes}
    return SimpleNamespace(
        tt=tt, detector=detector, route=route, refusal=refusal,
        onsets=onsets, mask=mask,
        onsets_log=onsets_log, inv=inv, fsmp=fsmp, nsamples=nsamples,
        tt_dev=torch.from_numpy(tt).to(device), ring_build=ring_build)


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
    route M1 ring is held to its plain version on its tables and to M1
    and timed in turns with it (exp_ring.m1_case: its bound and gather
    floor, ring, registers and spills). The route's one call runs first,
    its launches counted from 0 (``launches``). The plain version is
    timed once. The bound is the route kernel's (:func:`marginalise_bound`:
    M1 v2's int16 residuals on K1 v2's route, with M1's int32 bound beside
    it as ``v1_bound_ms``; exp_ring.bound on K2 v2's). Returns a
    record."""

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

    torch.cuda.synchronize()
    cm.reset_launches()
    got = kernel()
    torch.cuda.synchronize()
    launches = dict(cm.launches)
    want = plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    same_peak = int(torch.argmax(got)) == int(torch.argmax(want))
    check(torch.isfinite(got).all() and err <= M1_RTOL_OF_MAX and same_peak,
          f"m1 {name}: {err} of the maximum, peak equal {same_peak}")
    route = s.route
    record = {"onsets": n_onsets, "window": [start, length], "route": route,
              "refusal_k1_v2": s.refusal, "max_err_of_max": err,
              "max_abs_err": float((got - want).abs().max()),
              "launches": launches}
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
        from quakemigrate_torch.experiments import exp_ring

        ring = exp_ring.m1_case(exp_ring.setup(detector, s.onsets_log,
                                               s.inv, f"m1 {name}"),
                                window, reps)
        record.update(ring=ring, ms=ring["ms"], v1_ms=ring["m1_ms"],
                      turns_ms=ring["turns_ms"],
                      equal_to_v1=ring["equal_to_m1"],
                      max_rel_diff_v1=ring["max_rel_diff_m1"],
                      ring_build=s.ring_build)
    # The plain version once, warm from the check above
    record["plain_ms"] = median_ms(plain, 1, turns=1, warmup=0)
    record.update(marginalise_bound(
        s.tt, length, detector.base if route == "k1_v2" else None))
    if route == "k1_v2":
        record["v1_bound_ms"] = marginalise_bound(s.tt, length)["bound_ms"]
    else:
        # M1's bound on its int32 table beside the ring's own
        record["v1_bound_ms"] = record["bound_ms"]
        record.update({k: record["ring"][k] for k in (
            "bound_ms", "bound_by", "smem_bound_ms")})
    extra = (f"; M1 in turns {record['v1_ms']:.4f} ms (bound "
             f"{record['v1_bound_ms']:.4f}), equal "
             f"{record['equal_to_v1']} (largest relative difference "
             f"{record['max_rel_diff_v1']:.2e}), blocks per SM "
             f"{record['blocks_per_sm']}, {record['registers']} registers, "
             f"spills {record['spill_stores']} / {record['spill_loads']}"
             if route == "k1_v2" else
             f"; M1 ring in turns with M1 {record['v1_ms']:.4f} ms (bound "
             f"{record['v1_bound_ms']:.4f}), equal {record['equal_to_v1']} "
             f"(largest relative difference "
             f"{record['max_rel_diff_v1']:.2e}); ring tables "
             f"{s.ring_build}")
    print(f"m1 {name}: route {route}, {n_onsets} onsets, window {start} + "
          f"{length} of {s.nsamples}: {record['ms']:.4f} ms (plain "
          f"{record['plain_ms']:.4f}; bound {record['bound_ms']:.4f} by "
          f"{record['bound_by']}, gather floor "
          f"{record['smem_bound_ms']:.4f}), {err:.2e} of the maximum{extra}; "
          f"K1 v2 refusal: {s.refusal}")
    return record


class NoPlainOnCuda:
    """Within the block, the plain versions that detect's and locate's CPU
    paths call (the plain onset front ends of the fused window among them,
    which the front ends' factories call on a CPU block, and the plain
    versions of ON1 v2 and ON2 v2, which calculate_onsets calls on CPU
    tensors)
    and the ``extra`` (module, name) pairs raise if they are given CUDA
    tensors."""

    def __init__(self, label="archive_locate", extra=()):
        from quakemigrate_torch.ops import cuda_migrate as cm
        from quakemigrate_torch.ops import kurtosis, scan_window, stalta
        from quakemigrate_torch.signal import scan as scan_module

        self.label = label
        self.targets = [(scan_module, "detect_window"),
                        (scan_window, "fused_onsets"),
                        (scan_window, "fused_kurtosis_onsets"),
                        (stalta, "overlapping_sta_lta_plain"),
                        (stalta, "centred_sta_lta_plain"),
                        (stalta, "station_sta_lta_plain"),
                        (stalta, "combine_stations"),
                        (kurtosis, "kurtosis_onset_plain"),
                        (kurtosis, "station_kurtosis_onset_plain"),
                        (scan_module, "migrate_detect"),
                        (scan_module, "migrate_marginalise"),
                        (scan_module, "migrate_map"),
                        (cm, "detect_reduce_plan_reference"),
                        (cm, "vpu_v2_reference"),
                        (cm, "marginalise_ring_reference"),
                        (cm, "map_ring_reference"),
                        (cm, "detect_reduce"), *extra]

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.targets]
        for (module, name), fn in zip(self.targets, self.saved):
            def guarded(*args, _fn=fn, _name=name, **kwargs):
                check(not any(torch.is_tensor(a) and a.is_cuda
                              for a in args
                              + tuple(a for x in args if isinstance(x, tuple)
                                      for a in x)),
                      f"{self.label}: plain {_name} ran on CUDA tensors")
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
    marginal window 0.06 s, cut waveforms), no figures (plot_path's).
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
    and M1 ring at F1's geometry (256 onsets, on ``f1_route``, F1's
    traveltimes and DetectScan's route, k2_v2: CudaDetectVPU) in turns
    with M1; last :func:`ring_locate_path`. Returns a record."""

    from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
    from quakemigrate_torch.io import read_scanmseed, read_triggered_events
    from quakemigrate_torch.io.table import read_csv
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops import cuda_onsets as con
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
                   static_threshold=LOCATE_THRESHOLD,
                   plot_trigger_summary=False)
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
    scan = QuakeScan(detect.archive, lut, onset, str(runs), run_name,
                     device=device, picker=picker, plot_event_summary=False)
    scan.marginal_window = LOCATE_MARGINAL_WINDOW
    scan.write_cut_waveforms = True
    seen = []
    scan.on_event = lambda event, pass1, handle: seen.append(
        (event, pass1, handle))
    torch.cuda.synchronize()
    cm.reset_launches()
    con.reset_launches()
    with NoPlainOnCuda():
        _, locate_s = quiet(root, "locate",
                            lambda: scan.locate(starttime=start, endtime=end))
    torch.cuda.synchronize()
    launches = dict(cm.launches)
    onset_launches = dict(con.launches)
    n_read = len(seen)
    n_gated = sum(handle is not None for _, _, handle in seen)
    print(f"archive_locate: locate {locate_s:.3f} s wall, route "
          f"{scan.locate_route}; {n_read} event(s) migrated, {n_gated} "
          f"through the marginal-window gate; kernel launches {launches}, "
          f"onsets {onset_launches}")
    check(onset_launches == onsets_only("onset_stalta_v2", 2 * n_read),
          f"archive_locate: onset launches {onset_launches} for {n_read} "
          "event(s) of two phases")
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

    # The same locate again, warm: the plan and its tables are on the card;
    # the event's waveform data kept for calculate_onsets' case
    cold_split = split()
    scan.on_event = None
    event_data = []
    calculate = onset.calculate_onsets
    onset.calculate_onsets = lambda data, **kw: (
        event_data.append(data) or calculate(data, **kw))
    _, warm_s = quiet(root, "locate_warm",
                      lambda: scan.locate(starttime=start, endtime=end))
    del onset.calculate_onsets
    warm_split = split()
    print(f"archive_locate: per-event split, host s, cold ({locate_s:.3f} s "
          f"wall): {cold_split}; warm ({warm_s:.3f} s wall): {warm_split}")
    print(f"archive_locate: locate_event_attrib's onsets span, host s an "
          f"event, cold {cold_split['onsets']}, warm {warm_split['onsets']} "
          f"({nvidia_smi()})")
    onsets_record = onsets_case("archive_locate", onset, event_data[0],
                                device)

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
    # F1's pass 2 on K2 v2's route: M1 ring once in the route's call (its
    # launches counted from 0 inside m1_case), M1 only in the turns
    f1 = m1_case("f1", m1_setup(f1_route[0], NODE_COUNT, FSMP, NSAMPLES,
                                LSMP, np.random.default_rng(2032), device,
                                f1_route[1]), (100, 30))
    check(f1["route"] == "k2_v2"
          and f1["launches"]["migrate_marginalise_ring"] == 1
          and all(n == 0 for k, n in f1["launches"].items()
                  if k != "migrate_marginalise_ring"),
          f"m1 f1: route {f1['route']}, launches {f1['launches']}")

    # The map path: the same events located again with write_coalescence,
    # the map built by M2 on K1 v2's route, pass 1 taken from it
    trigger_file = (run.path / "trigger" / "events"
                    / f"{run_name}_{start.year}_{start.julday:03d}"
                    "_TriggeredEvents.csv")
    map_scan = QuakeScan(detect.archive, lut, onset, str(runs), "map_path",
                         device=device, picker=picker,
                         marginal_window=LOCATE_MARGINAL_WINDOW,
                         write_coalescence=True, plot_event_summary=False)
    map_seen = []
    map_scan.on_event = lambda event, pass1, handle: map_seen.append(
        (event, handle))
    torch.cuda.synchronize()
    cm.reset_launches()
    con.reset_launches()
    with NoPlainOnCuda():
        _, map_s = quiet(root, "locate_map", lambda: map_scan.locate(
            trigger_file=str(trigger_file)))
    torch.cuda.synchronize()
    map_launches = dict(cm.launches)
    map_onset_launches = dict(con.launches)
    check(map_onset_launches == onsets_only("onset_stalta_v2", 2),
          f"map_path: onset launches {map_onset_launches}")
    (map_event, map_handle), = map_seen
    map_file = (runs / "map_path" / "locate" / "coalescence_maps"
                / f"{map_event.uid}.npy")
    map4d = np.load(map_file)
    map_node = lut.index2coord([map_event.hypocentre], inverse=True)[0]
    map_dist = int(np.abs(map_node - node).max())
    map_split = {k: [row.get(k) for row in map_scan.locate_event_attrib]
                 for k in ("read_wait", "onsets", "pass1", "map_write",
                           "location", "picks", "writes")}
    print(f"map_path: QuakeScan.locate(write_coalescence=True) {map_s:.3f} s "
          f"wall, route {map_scan.locate_route}, launches {map_launches}; "
          f".npy {map4d.shape} {map4d.dtype}; spline node "
          f"{map_node.tolist()} against the two-pass run's {node.tolist()} "
          f"({map_dist} nodes); per-event split, host s: {map_split}")
    map_keys = ("migrate_map_persistent", "migrate_map_persistent_tables")
    check(map_scan.locate_route == "k1_v2" and map_handle is None
          and all(n == (k in map_keys) for k, n in map_launches.items()),
          f"map_path: route {map_scan.locate_route}, launches {map_launches}")
    check(map4d.shape == tuple(lut.node_count) + (inp["nsamples"],)
          and bool(np.isfinite(map4d).all()) and map_dist <= 1,
          f"map_path: .npy {map4d.shape}, {map_dist} nodes from the "
          "two-pass location")
    map_record = {"locate_s": map_s, "launches": map_launches,
                  "onset_launches": map_onset_launches,
                  "npy_shape": list(map4d.shape), "spline_node":
                  map_node.tolist(), "node_distance_two_pass": map_dist,
                  "event_split_s": map_split}
    del map4d
    plot_record = plot_path(device, root, detect.archive, lut, onset,
                            trigger_file, planted)
    ring_locate = ring_locate_path(device, root, detect, trigger_file,
                                   onset, picker)
    return {
        "ring_locate": ring_locate,
        "trigger_s": trigger_s, "locate_s": locate_s,
        "coa_n_peak": float(coa_n[peak]),
        "coa_n_noise_max": float(coa_n[away].max()),
        "threshold": LOCATE_THRESHOLD,
        "events": len(events), "trigger_time": str(events["CoaTime"][0]),
        "origin": str(origin), "otime": str(event.otime),
        "launches": launches, "onset_launches": onset_launches,
        "onsets": onsets_record, "onset_samples": inp["block"].shape[-1],
        "route": scan.locate_route,
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
        "m1_f1": f1, "m1_windows": m1_windows, "map": map_record,
        "plot": plot_record,
        # the example's plan and locate window, for map_path's kernel case
        "map_geometry": {
            "tt": tt, "node_count": NODE_COUNT, "fsmp": inp["fsmp"],
            "nsamples": inp["nsamples"],
            "lsmp": inp["block"].shape[-1] - inp["fsmp"] - inp["nsamples"]},
    }


def ring_locate_path(device, root, detect, trigger_file, onset, picker):
    """ring_locate: the archive's event located on the "k3" route
    (QuakeScan(kernel="xla"): pass 1 on K3 v2) two-pass and on the map
    path, each twice: on M1 ring or M2 ring (K3 v2's tables), and with the
    ring held back (``CudaDetectGlobal.ring_tables`` None) on M1 or M2's
    simple form. Checks: one K3 v2 launch a run and one launch of the
    locate kernel named, nothing else, no plain version on a CUDA tensor;
    each ring run's .event byte-equal to the old kernel's run, its X, Y
    and Z equal, the map path's .npy equal. Returns a record."""

    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.signal import QuakeScan

    lut, runs = detect.lut, detect.run.path.parent
    record = {}
    for map_path in (False, True):
        runs_of = {}
        for ring in (True, False):
            name = (f"ring_locate_{'map' if map_path else 'two_pass'}_"
                    f"{'ring' if ring else 'old'}")
            scan = QuakeScan(detect.archive, lut, onset, str(runs), name,
                             device=device, picker=picker,
                             marginal_window=LOCATE_MARGINAL_WINDOW,
                             kernel="xla", write_coalescence=map_path,
                             plot_event_summary=False)
            saved = cm.CudaDetectGlobal.ring_tables
            if not ring:
                cm.CudaDetectGlobal.ring_tables = lambda self: None
            try:
                torch.cuda.synchronize()
                cm.reset_launches()
                with NoPlainOnCuda("ring_locate"):
                    _, wall = quiet(root, name, lambda: scan.locate(
                        trigger_file=str(trigger_file)))
                torch.cuda.synchronize()
            finally:
                cm.CudaDetectGlobal.ring_tables = saved
            launches = {k: n for k, n in cm.launches.items() if n}
            kernel = ("migrate_map" if map_path else "migrate_marginalise")
            kernel += "_ring" if ring else ""
            want = ({"migrate_detect_global_v2": 1, kernel: 1} if not map_path
                    else {kernel: 1})
            check(scan.locate_route == "k3" and launches == want,
                  f"{name}: route {scan.locate_route}, launches {launches}, "
                  f"expected {want}")
            runs_of[ring] = (runs / name, launches, wall)
        (ring_dir, ring_launches, ring_s), (old_dir, old_launches, old_s) = (
            runs_of[True], runs_of[False])
        (rows, ring_bytes), (old_rows, old_bytes) = (event_text(ring_dir),
                                                     event_text(old_dir))
        xyz = {k: (rows[1][rows[0].index(k)], old_rows[1][old_rows[0].index(k)])
               for k in ("X", "Y", "Z")}
        equal = ring_bytes == old_bytes
        check(equal and all(a == b for a, b in xyz.values()),
              f"ring_locate: .event of the ring run and the old kernels' "
              f"differ: {xyz}")
        entry = {"launches": ring_launches, "old_launches": old_launches,
                 "event_byte_equal": equal, "xyz": xyz,
                 "wall_s": ring_s, "old_wall_s": old_s}
        if map_path:
            entry["npy_equal"] = bool(np.array_equal(
                npy_of(ring_dir, "coalescence_maps"),
                npy_of(old_dir, "coalescence_maps")))
            check(entry["npy_equal"], "ring_locate: the map path's .npy "
                  "differs from the old kernel's")
        record["map_path" if map_path else "two_pass"] = entry
        print(f"ring_locate {'map path' if map_path else 'two-pass'}: route "
              f"k3, launches {ring_launches} against {old_launches}; .event "
              f"byte-equal {equal}, X/Y/Z {xyz}"
              + (f", .npy equal {entry['npy_equal']}" if map_path else "")
              + f"; {ring_s:.3f} s and {old_s:.3f} s wall")
    return record


def plot_path(device, root, archive, lut, onset, trigger_file, planted):
    """plot_path: QuakeScan.locate of archive_locate's event with
    plot_event_summary=True and plot_event_video=True, on the card and
    with device="cpu" (:func:`locate_card_and_cpu`, no plain version on a
    CUDA tensor). On the card exactly one launch of the route's map
    kernel (migrate_map_persistent, M2 v2: the video keeps the 4-D map)
    and one of its tables' kernel (the fresh detector's first map), and
    nothing else; the .event held to the CPU run's (:func:`hold_event`) and the
    kept map4d to the CPU run's within MAP_RTOL of each value. Where
    matplotlib imports, the event summary PDF and the GIF at their paths
    in both runs, the GIF's frames one a sample of the kept map; where it
    does not, neither file and the same device work. Prints the figures'
    status, the phase's wall and the map's copy-back ms beside the card's
    name and power limit. Returns a record."""

    from quakemigrate_torch import plot
    from quakemigrate_torch.signal import QuakeScan
    from quakemigrate_torch.signal.pickers import GaussianPicker

    t0 = time.perf_counter()
    events, scans = {}, {}

    def make(name, dev, **options):
        scan = scans[name] = QuakeScan(
            archive, lut, onset, str(root / "runs"), name, device=dev,
            picker=GaussianPicker(onset=onset),
            marginal_window=LOCATE_MARGINAL_WINDOW, **options)
        scan.on_event = lambda event, pass1, handle: events.update(
            {name: event})
        return scan

    card_dir, cpu_dir, event, record = locate_card_and_cpu(
        root, "plot_path", make, trigger_file,
        {"migrate_map_persistent": 1, "migrate_map_persistent_tables": 1,
         "onset_stalta_v2": 2},
        planted, lut, plot_event_summary=True, plot_event_video=True)
    cpu_event = events["plot_path_cpu"]
    check(event.map4d is not None and cpu_event.map4d is not None
          and event.map4d.shape == cpu_event.map4d.shape,
          "plot_path: the 4-D map was not kept")
    map_rel = float((np.abs(event.map4d - cpu_event.map4d)
                     / np.abs(cpu_event.map4d)).max())
    check(bool(np.isfinite(event.map4d).all()) and map_rel <= MAP_RTOL,
          f"plot_path: map4d {map_rel} relative to the CPU run's")

    drawn = plot.available()
    figures = {}
    for label, run_dir in (("card", card_dir), ("cpu", cpu_dir)):
        pdfs = sorted((run_dir / "locate" / "summaries").glob("*.pdf"))
        gifs = sorted((run_dir / "locate" / "videos").glob("*.gif"))
        entry = {"pdf": [p.name for p in pdfs], "gif": [p.name for p in gifs]}
        if drawn:
            from PIL import Image

            check(len(pdfs) == len(gifs) == 1
                  and pdfs[0].name == f"{run_dir.name}_{event.uid}"
                  "_EventSummary.pdf"
                  and gifs[0].name == f"{run_dir.name}_{event.uid}"
                  "_Coalescence.gif",
                  f"plot_path {label}: figures {entry}")
            with Image.open(gifs[0]) as im:
                frames = im.n_frames
            check(frames == event.map4d.shape[-1],
                  f"plot_path {label}: {frames} GIF frames for "
                  f"{event.map4d.shape[-1]} samples")
            entry.update(pdf_bytes=pdfs[0].stat().st_size,
                         gif_bytes=gifs[0].stat().st_size,
                         gif_frames=frames)
        else:
            # One warning in the locate's log, naming both options
            log_text = (root / f"plot_path{'' if label == 'card' else '_cpu'}"
                        ".log").read_text()
            warned = [line for line in log_text.splitlines()
                      if "matplotlib cannot be imported" in line]
            entry["warnings"] = len(warned)
            check(not pdfs and not gifs and len(warned) == 1
                  and "plot_event_summary, plot_event_video" in warned[0],
                  f"plot_path {label}: without matplotlib {entry}, "
                  f"warnings {warned}")
        figures[label] = entry
    record.update(map_rel_err=map_rel, map_shape=list(event.map4d.shape),
                  figures=figures, matplotlib=None)
    if drawn:
        import matplotlib

        record["matplotlib"] = matplotlib.__version__
    # The map's copy back, timed on the event's own inputs with the scan's
    # detector, after the counted run
    inp = event._marginalise_inputs
    map_flat = scans["plot_path"]._locate_detector.map(
        inp["onsets_log"], inp["inv_available"])
    record["copy_back_ms"] = copy_back_ms(map_flat)
    record["map_bytes"] = map_flat.numel() * map_flat.element_size()
    del map_flat
    record["phase_wall_s"] = time.perf_counter() - t0
    print(f"plot_path: figures "
          + (f"drawn (matplotlib {record['matplotlib']}): PDF "
             f"{figures['card']['pdf_bytes']} B, GIF "
             f"{figures['card']['gif_bytes']} B of "
             f"{figures['card']['gif_frames']} frames" if drawn
             else "not drawn (matplotlib absent; one warning in each "
             "run's log)")
          + f"; map4d {record['map_shape']} within {map_rel:.2e} of the "
          f"CPU run's; phase {record['phase_wall_s']:.3f} s wall, the map's "
          "copy "
          f"back ({record['map_bytes']} B) {record['copy_back_ms']:.4f} ms; "
          f"{nvidia_smi()}")
    return record


def map_bound(tt, nsamples, base):
    """Bound of the map, migrate_map over ``nsamples`` scan samples for the
    int32 [n_nodes, O] traveltimes ``tt``: the bytes M2's function must
    move, each read or written once (the f32 [n_nodes, nsamples] map; the
    plan's int16 residuals, 2 bytes a real node-onset, and its int32
    ``base``; of each onset row the f32 columns the scan touches; the
    mask), against O adds and three more operations (scale, exp, store) a
    node and sample; and the floor of the gather, the n_nodes x O x
    nsamples 4-byte reads at the shared-memory bandwidth. Also the output
    alone over the memory rate, ``output_ms``."""

    tt = np.asarray(tt)
    n_nodes, n_onsets = tt.shape
    columns = (tt.max(axis=0).astype(np.int64) - tt.min(axis=0) + nsamples)
    out_bytes = 4 * n_nodes * nsamples
    nbytes = (out_bytes + 2 * tt.size + base.numel() * base.element_size()
              + 4 * (int(columns.sum()) + n_onsets))
    bound_ms, bound_by = roofline(nbytes,
                                  n_nodes * nsamples * (n_onsets + 3))
    return {"bound_ms": bound_ms, "bound_by": bound_by,
            "smem_bound_ms": (n_nodes * n_onsets * nsamples * 4
                              / SMEM_BYTES_PER_S * 1e3),
            "output_ms": out_bytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": n_nodes * nsamples * (n_onsets + 3) / FP32_FLOP_PER_S
            * 1e3}


def copy_back_ms(tensor, reps=5):
    """CUDA-event ms of one non-blocking copy of ``tensor`` into a pinned
    host buffer (the map path's copy back), the median of ``reps``."""

    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        host.copy_(tensor, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:]))


def map_case(name, s, window, reps=20):
    """The map on the setup ``s`` (:func:`m1_setup`) over its whole scan:
    the route's kernel (M2 v2 on K1 v2's route, M2 ring on K2 v2's)
    against the plain
    migrate_map on the card, within MAP_RTOL of each value. On K1 v2's
    route also: the map's per-sample max bit for bit K1 v2's tmax
    (combined over tiles); its sum over the marginal window ``(start,
    length)`` within MAP_SUM_RTOL of M1 v2's; M2 v2, M2 and M2's simple
    form on the same plan bit for bit the route's map; M2 v2 within
    MAP_RTOL of its plain version; M2 v2, M2, M1 v2 (at the window) and K1
    v2 timed in turns (CUDA events); M2 v2 and M2 in three more rounds
    of turns enqueued behind a hold (the kernels back to back, without
    the host's enqueue), whose medians must show M2 v2, the route's
    kernel, the faster, and by the profiler's device time; the simple form
    alone. On K2 v2's route the route's kernel is M2 ring, held to its
    plain version on its tables and to M2's simple form bit for bit and
    timed in turns with it (exp_ring.m2_case). The route's one call runs
    first, its launches counted from 0 (``launches``). The plain map is
    timed once, and the map's copy back to a pinned buffer. Returns a
    record."""

    from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops.migrate import migrate_map

    detector, (start, length) = s.detector, window
    n_onsets = s.tt.shape[1]

    def m2():
        return detector.map(s.onsets_log, s.inv)

    def plain():
        return migrate_map(s.onsets, s.tt_dev, s.mask, float(n_onsets),
                           s.fsmp, s.nsamples)

    torch.cuda.synchronize()
    cm.reset_launches()
    got = m2()
    torch.cuda.synchronize()
    launches = dict(cm.launches)
    want = plain()
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs()).max())
    check(got.shape == (detector.n_nodes, s.nsamples)
          and bool(torch.isfinite(got).all()) and rel <= MAP_RTOL,
          f"map {name}: {rel} relative to the plain map")
    record = {"route": s.route, "onsets": n_onsets, "nodes": detector.n_nodes,
              "nsamples": s.nsamples, "max_rel_err": rel,
              "max_abs_err": float((got - want).abs().max()),
              "window": [start, length], "launches": launches}
    if s.route == "k1_v2":
        from quakemigrate_torch.experiments import exp_ring

        max_coa, _, _ = cm.combine_tiles(
            *detector.launch(s.onsets_log, s.inv), detector.perm,
            detector.tile)
        max_equal = bool(torch.equal(got.max(dim=0).values, max_coa))
        m1_v2 = detector.marginalise(s.onsets_log, s.inv, start, length)
        sums = got[:, start:start + length].sum(dim=1)
        sum_rel = float(((sums - m1_v2).abs() / m1_v2.abs()).max())
        simple = cm.migrate_map_cuda(
            s.onsets_log, detector.base, detector.fine, detector.valid,
            detector.perm, s.inv, s.fsmp, s.nsamples, detector.n_nodes,
            detector._max_shift)
        simple_equal = bool(torch.equal(simple, got))
        del simple
        # M2 v2 and M2 on the same plan: each map bit for bit the route's,
        # M2 v2 within MAP_RTOL of its plain version (its staging emulated
        # on the card, migrate_map_persistent_reference)
        t_len = s.onsets_log.shape[1]
        tables = detector.map_tables(t_len)
        check(tables is not None, f"map {name}: M2 v2 refuses the plan: "
              f"{detector.map_refusal}")

        def m2_v2():
            return cm.migrate_map_persistent_cuda(
                s.onsets_log, detector.base, s.inv, s.fsmp, s.nsamples,
                detector.n_nodes, tables, detector._max_shift)

        def m2_v1():
            return detector.map_m2(s.onsets_log, s.inv)

        # M2 v2's tables, built by their kernel at the route's first map:
        # held bit for bit to the plain build on the same tables of K1 v2
        # and timed in turns with it
        build_args = (detector.fine16, detector.base, detector.valid,
                      detector.perm, tables.woff, tables.layout, s.fsmp,
                      t_len)
        ref_res, ref_flat = cm.map_persistent_tables_reference(*build_args)
        res_diff = (ref_res.view(torch.int16).int()
                    - tables.res.view(torch.int16).int()).abs()
        tables_err = max(int(res_diff.max()),
                         int((ref_flat - tables.flat).abs().max()))
        del ref_res, ref_flat, res_diff
        check(tables_err == 0, f"map {name}: M2 v2's tables differ from "
              f"their plain build by up to {tables_err}")
        build_turns = ekb.in_turns({
            "kernel": lambda: cm.map_persistent_tables_cuda(*build_args),
            "plain": lambda: cm.map_persistent_tables_reference(
                *build_args)}, reps)
        build_bytes = sum(t.numel() * t.element_size() for t in (
            detector.fine16, detector.base, detector.valid, detector.perm,
            tables.woff, tables.res, tables.flat))
        tables_record = {
            "max_abs_err": tables_err,
            "ms": float(np.mean(build_turns["kernel"])),
            "plain_ms": float(np.mean(build_turns["plain"])),
            "turns_ms": build_turns, "bytes": build_bytes,
            "bound_ms": build_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "build_s": tables.build_s, "table_bytes": tables.nbytes,
            "first_call_launches": launches[
                "migrate_map_persistent_tables"]}

        # Launches of M2 v2 and M2 off the route's call: their holds and
        # turns here (the yardstick's count)
        before = dict(cm.launches)
        equal = {}
        for key, fn in (("m2_v2", m2_v2), ("m2", m2_v1)):
            other = fn()
            equal[key] = bool(torch.equal(other, got))
            del other
        emulated = cm.migrate_map_persistent_reference(
            s.onsets_log, detector.base, s.inv, s.fsmp, s.nsamples,
            detector.n_nodes, tables)
        v2_rel = float(((got - emulated).abs() / emulated.abs()).max())
        del emulated
        check(max_equal and sum_rel <= MAP_SUM_RTOL and simple_equal
              and all(equal.values()) and v2_rel <= MAP_RTOL,
              f"map {name}: max equal to K1 v2's tmax {max_equal}, window "
              f"sum vs M1 v2 {sum_rel}, simple form equal {simple_equal}, "
              f"M2 v2 and M2 equal {equal}, M2 v2 vs its plain version "
              f"{v2_rel}")
        fns = {"m2_v2": m2_v2, "m2": m2_v1,
               "m1_v2": lambda: detector.marginalise(s.onsets_log, s.inv,
                                                     start, length),
               "k1_v2": lambda: detector.launch(s.onsets_log, s.inv)}
        turns = ekb.in_turns(fns, reps)
        # The route's test: M2 v2 against M2 in three more rounds of turns
        # (M2 v2, M2, M2, M2 v2 each), the calls enqueued behind a hold so
        # that CUDA events time the kernels back to back and not the
        # host's enqueue (M2 v2's ~0.08 ms is below its wrapper's), their
        # medians; beside them the kernels alone (torch.profiler's device
        # time), printed
        route_turns = {"m2_v2": [], "m2": []}
        for _ in range(3):
            for key, ms in ekb.in_turns({k: fns[k] for k in route_turns},
                                        reps, queued=True).items():
                route_turns[key] += ms
        route_ms = {k: float(np.median(v)) for k, v in route_turns.items()}
        device_ms = {k: exp_ring.device_ms(fns[k], reps)
                     for k in route_turns}
        case_launches = {k: cm.launches[k] - before[k] for k in (
            "migrate_map_persistent", "migrate_map_v2")}
        check(route_ms["m2_v2"] < route_ms["m2"],
              f"map {name}: M2 v2 takes the route but is not faster than "
              f"M2 in queued turns: {route_turns}")
        lay = tables.layout
        record.update(
            ms=float(np.mean(turns["m2_v2"])),
            m2_v2_ms=float(np.mean(turns["m2_v2"])),
            m2_ms=float(np.mean(turns["m2"])),
            m1_v2_ms=float(np.mean(turns["m1_v2"])),
            k1_v2_ms=float(np.mean(turns["k1_v2"])), turns_ms=turns,
            route_ms=route_ms, route_turns_ms=route_turns,
            device_ms=device_ms,
            case_launches=case_launches,
            max_equal_to_k1_v2=max_equal, window_sum_rel_err_m1_v2=sum_rel,
            simple_equal=simple_equal, equal_to_route=equal,
            m2_v2_rel_err_plain=v2_rel,
            m2_v2={"layout": {k: getattr(lay, k) for k in (
                       "shape", "run", "runs", "parts", "npi",
                       "stage_floats", "n_stages", "smem")},
                   "items": int(tables.items.numel()) * lay.runs,
                   "table_build_s": tables.build_s,
                   "table_bytes": tables.nbytes,
                   "blocks_per_sm": cm.map_persistent_blocks_per_sm(
                       lay, s.onsets_log.device),
                   **next(iter(_build_resources(
                       "qm_map_persistent_kernelILi{}ELi{}ELi{}ELi0E".format(
                           *lay.shape)).values()))},
            tables_kernel=tables_record,
            m2_blocks_per_sm=cm.marginalise_v2_blocks_per_sm(
                n_onsets, detector.tile, detector.win_floats, s.nsamples,
                s.onsets_log.device),
            simple_ms=median_ms(lambda: cm.migrate_map_cuda(
                s.onsets_log, detector.base, detector.fine, detector.valid,
                detector.perm, s.inv, s.fsmp, s.nsamples, detector.n_nodes,
                detector._max_shift), reps))
    else:
        from quakemigrate_torch.experiments import exp_ring

        del want
        ring = exp_ring.m2_case(exp_ring.setup(detector, s.onsets_log, s.inv,
                                               f"map {name}"), reps)
        record.update(ring=ring, ms=ring["ms"],
                      simple_ms=ring["m2_simple_ms"],
                      turns_ms=ring["turns_ms"],
                      simple_equal=ring["equal_to_m2_simple"],
                      ring_build=s.ring_build)
    record["plain_ms"] = median_ms(plain, 1, turns=1, warmup=0)
    record["copy_back_ms"] = copy_back_ms(got)
    record.update(map_bound(s.tt, s.nsamples, detector.base))
    extra = (f"; in turns M2 v2 {record['m2_v2_ms']:.4f} ms, M2 "
             f"{record['m2_ms']:.4f}, M1 v2 {record['m1_v2_ms']:.4f} ms at "
             f"{length} samples, K1 v2 {record['k1_v2_ms']:.4f} ms; M2 v2 "
             f"against M2 in three more rounds, queued, medians "
             f"{record['route_ms']}; device (profiler) "
             f"{record['device_ms']}; M2 v2 "
             f"{record['m2_v2']}; max bit for bit "
             f"K1 v2's tmax {record['max_equal_to_k1_v2']}, window sum vs "
             f"M1 v2 {record['window_sum_rel_err_m1_v2']:.2e}, simple form "
             f"{record['simple_ms']:.4f} ms and equal "
             f"{record['simple_equal']}, M2 v2 and M2 equal "
             f"{record['equal_to_route']}; M2 v2's tables' kernel "
             f"{record['tables_kernel']['ms']:.4f} ms in turns with its "
             f"plain build {record['tables_kernel']['plain_ms']:.4f}, "
             f"differing by {record['tables_kernel']['max_abs_err']}"
             if s.route == "k1_v2" else
             f"; M2 ring in turns with M2 simple {record['simple_ms']:.4f} "
             f"ms, equal {record['simple_equal']}; ring tables "
             f"{s.ring_build}")
    print(f"map {name}: route {s.route}, {n_onsets} onsets, "
          f"{detector.n_nodes} nodes x {s.nsamples} samples: {record['ms']:.4f}"
          f" ms (plain {record['plain_ms']:.4f}; bound "
          f"{record['bound_ms']:.4f} by {record['bound_by']}: output "
          f"{record['output_ms']:.4f}, operations {record['ops_ms']:.4f}; "
          f"gather floor {record['smem_bound_ms']:.4f}); copy back "
          f"{record['copy_back_ms']:.4f} ms; {rel:.2e} relative to the "
          f"plain map{extra}")
    del got
    torch.cuda.empty_cache()
    return record


def map_kernel_path(device, icequake, f1_route, vt):
    """The map_path phase's kernel cases: M2 against the plain migrate_map
    at the Icequake example's locate window (61 samples, its plan and 26
    onsets, archive_locate's geometry ``icequake``) and at the VT
    example's (201 samples, the VT plan of vt_locate_mags, ``vt``), both
    on K1 v2's route with seeded random onsets (:func:`map_case`; the
    marginal windows of 30 and 100 samples); then M2's simple form on
    F1's geometry (256 onsets on the Icequake grid, K2 v2's route:
    CudaDetectVPU), M2 ring there, its launches counted. Returns a
    record."""

    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.signal.scan import detect_route

    cases = {}
    for name, g, window, seed in (("icequake", icequake, (15, 30), 2040),
                                  ("vt", vt, (50, 100), 2041)):
        s = m1_setup(g["tt"], g["node_count"], g["fsmp"], g["nsamples"],
                     g["lsmp"], np.random.default_rng(seed), device,
                     detect_route(g["tt"], g["node_count"], device))
        cases[name] = map_case(name, s, window)
        del s
    # F1's map on K2 v2's route: M2 ring once in the route's call (its
    # launches counted from 0 inside map_case), M2 simple only in turns
    f1 = map_case("f1", m1_setup(f1_route[0], NODE_COUNT, FSMP, 61, LSMP,
                                 np.random.default_rng(2042), device,
                                 f1_route[1]), (10, 41), reps=5)
    check(f1["route"] == "k2_v2" and f1["launches"]["migrate_map_ring"] == 1
          and all(n == 0 for k, n in f1["launches"].items()
                  if k != "migrate_map_ring"),
          f"map f1: route {f1['route']}, launches {f1['launches']}")
    cases["f1"] = f1
    return cases


_VT_STATIONXML = """<?xml version="1.0" encoding="UTF-8"?>
<FDSNStationXML xmlns="http://www.fdsn.org/xml/station/1" schemaVersion="1.1">
  <Source>chip_smoke</Source>
  <Created>2014-01-01T00:00:00</Created>
  <Network code="SC">
{stations}
  </Network>
</FDSNStationXML>
"""

_VT_CHANNEL = """      <Channel code="CH{comp}" locationCode="" startDate="2014-01-01T00:00:00">
        <Latitude>{lat}</Latitude><Longitude>{lon}</Longitude>
        <Elevation>{elev}</Elevation><Depth>0</Depth>
        <SampleRate>{sps}</SampleRate>
        <Response>
          <InstrumentSensitivity>
            <Value>{sensitivity}</Value><Frequency>5.0</Frequency>
            <InputUnits><Name>M/S</Name></InputUnits>
            <OutputUnits><Name>COUNTS</Name></OutputUnits>
          </InstrumentSensitivity>
          <Stage number="1">
            <PolesZeros>
              <InputUnits><Name>M/S</Name></InputUnits>
              <OutputUnits><Name>V</Name></OutputUnits>
              <PzTransferFunctionType>LAPLACE (RADIANS/SECOND)</PzTransferFunctionType>
              <NormalizationFactor>1.0</NormalizationFactor>
              <NormalizationFrequency>5.0</NormalizationFrequency>
              <Zero number="0"><Real>0</Real><Imaginary>0</Imaginary></Zero>
              <Zero number="1"><Real>0</Real><Imaginary>0</Imaginary></Zero>
              <Pole number="0"><Real>-4.44</Real><Imaginary>4.44</Imaginary></Pole>
              <Pole number="1"><Real>-4.44</Real><Imaginary>-4.44</Imaginary></Pole>
            </PolesZeros>
          </Stage>
        </Response>
      </Channel>"""


def vt_stationxml(stations, path):
    """A StationXML inventory of the VT stations' Z/N/E channels: a 2-pole
    1 s velocity sensor of VT_SENSITIVITY counts per m/s."""

    blocks = []
    for row in stations.rows():
        channels = "\n".join(_VT_CHANNEL.format(
            comp=c, lat=row["Latitude"], lon=row["Longitude"],
            elev=-row["Elevation"] * 1e3, sps=VT_RATE,
            sensitivity=VT_SENSITIVITY) for c in "ZNE")
        blocks.append(
            f'    <Station code="{row["Name"]}">\n'
            f"      <Latitude>{row['Latitude']}</Latitude>\n"
            f"      <Longitude>{row['Longitude']}</Longitude>\n"
            f"      <Elevation>{-row['Elevation'] * 1e3}</Elevation>\n"
            f"{channels}\n    </Station>")
    path.write_text(_VT_STATIONXML.format(stations="\n".join(blocks)))
    return path


_VT_RESP = """B050F03     Station:     {station}
B050F16     Network:     SC
B052F03     Location:    ??
B052F04     Channel:     CH{comp}
B052F22     Start date:  2014,001,00:00:00
B052F23     End date:    No Ending Time
B053F03     Transfer function type:                A [Laplace Transform (Rad/sec)]
B053F04     Stage sequence number:                 1
B053F05     Response in units lookup:              M/S - Velocity in Meters Per Second
B053F06     Response out units lookup:             V - Volts
B053F07     A0 normalization factor:               1.0
B053F08     Normalization frequency:               5.0
B053F09     Number of zeroes:                      2
B053F14     Number of poles:                       2
B053F10-13     0  0.000000E+00  0.000000E+00  0.000000E+00  0.000000E+00
B053F10-13     1  0.000000E+00  0.000000E+00  0.000000E+00  0.000000E+00
B053F15-18     0 -4.440000E+00  4.440000E+00  0.000000E+00  0.000000E+00
B053F15-18     1 -4.440000E+00 -4.440000E+00  0.000000E+00  0.000000E+00
B058F03     Stage sequence number:                 0
B058F04     Sensitivity:                           {sensitivity:E}
B058F05     Frequency of sensitivity:              5.0
#
"""

# The same response with respect to displacement: a third zero at the
# origin, CONSTANT = A0 x sensitivity
_VT_SAC_PZ = """* NETWORK   (KNETWK): SC
* STATION    (KSTNM): {station}
* LOCATION   (KHOLE):
* CHANNEL   (KCMPNM): CH{comp}
* START             : 2014-01-01T00:00:00
* END               : 2599-12-31T23:59:59
* INPUT UNIT        : M
ZEROS 3
POLES 2
        -4.440000e+00   +4.440000e+00
        -4.440000e+00   -4.440000e+00
CONSTANT {sensitivity:+e}
"""


def vt_responses(stations, root):
    """The generated StationXML's responses (:func:`vt_stationxml`) also as
    one concatenated RESP file and one SAC_PZ file. Returns {"stationxml",
    "resp", "sac_pz"} -> path."""

    paths = {"stationxml": vt_stationxml(stations, root / "response.xml"),
             "resp": root / "RESP.vt", "sac_pz": root / "SAC_PZs_vt"}
    for key, template in (("resp", _VT_RESP), ("sac_pz", _VT_SAC_PZ)):
        paths[key].write_text("".join(
            template.format(station=name, comp=comp,
                            sensitivity=VT_SENSITIVITY)
            for name in stations["Name"] for comp in "ZNE"))
    return paths


def vt_workspace(root, spacing_km=0.5):
    """vt_locate_mags' inputs, made with the port alone: the
    Volcanotectonic_Iceland example's LUT as dike_intrusion_lut.py builds
    it (its lcc grid at 0.5 km, its 12 stations, method "1dsweep" on
    iceland_vmodel.txt with sweep_dx VT_SWEEP_DX), VT_N_EVENTS sources
    planted at grid nodes VT_SPACING_S apart, VT_SPAN_S seconds of 50 Hz
    three-component synthetics in counts along that LUT's traveltimes
    (quakemigrate_torch.synthetics, noise on the amplitudes) written as a
    YEAR/JD/STATION STEIM2 archive, and a generated StationXML with the
    same responses as RESP and SAC_PZ (:func:`vt_responses`). Returns
    (lut, stations, archive path, response files, planted grid indices,
    origin times, the LUT build's host seconds)."""

    from quakemigrate_torch.coords import Proj
    from quakemigrate_torch.io import read_stations, read_vmodel
    from quakemigrate_torch.lut import compute_traveltimes
    from quakemigrate_torch.seis import UTCDateTime
    from quakemigrate_torch.synthetics import (
        GaussianDerivativeWavelet,
        simulate_waveforms,
    )

    stations = read_stations(VT_DIR / "inputs" / "iceland_stations.txt")
    grid_spec = dict(
        ll_corner=[-17.2, 64.7, -2.0], ur_corner=[-16.6, 64.95, 16.0],
        node_spacing=[spacing_km] * 3,
        grid_proj=Proj(proj="lcc", units="km", lon_0=-16.9, lat_0=64.8,
                       lat_1=64.7, lat_2=64.9, datum="WGS84", ellps="WGS84",
                       no_defs=True),
        coord_proj=Proj(proj="longlat", datum="WGS84", ellps="WGS84",
                        no_defs=True),
    )
    lut, lut_s = quiet(root, "vt_lut", lambda: compute_traveltimes(
        grid_spec, stations, method="1dsweep",
        vmod=read_vmodel(VT_DIR / "inputs" / "iceland_vmodel.txt"),
        phases=["P", "S"], sweep_dx=VT_SWEEP_DX))
    half = VT_SPAN_S / 2 - VT_SPACING_S * (VT_N_EVENTS - 1) / 2
    wavelet = GaussianDerivativeWavelet(VT_WAVELET_HZ, VT_RATE, half)
    rng = np.random.default_rng(2043)
    planted, origins, total = [], [], {}
    for k, fractions in enumerate(VT_PLANTED[:VT_N_EVENTS]):
        node = tuple(int(n * f) for n, f in zip(lut.node_count, fractions))
        start = UTCDateTime(VT_START) + k * VT_SPACING_S
        stream = simulate_waveforms(
            wavelet, lut.index2coord([node])[0], lut, magnitude=VT_MAGNITUDE,
            angle_of_incidence=80,
            noise={"traveltime": {"P": 0.0, "S": 0.0},
                   "amplitude": {"P": 0.02, "S": 0.02}},
            starttime=start, rng=rng)
        offset = int(round(k * VT_SPACING_S * VT_RATE))
        for tr in stream:
            data = total.setdefault(tr.id, (tr, np.zeros(
                int(round(VT_SPAN_S * VT_RATE)) + 1)))[1]
            data[offset:offset + tr.stats.npts] += tr.data
        planted.append(node)
        origins.append(start + half + (int(VT_RATE * 0.5 / VT_WAVELET_HZ)
                                       + 3) / VT_RATE)
    archive = root / "mSEED"
    for tr, data in total.values():
        tr = tr.copy()
        tr.stats.starttime = UTCDateTime(VT_START)
        tr.data = np.round(data * 1e3).astype(np.int32)  # counts
        day = tr.stats.starttime
        folder = archive / str(day.year) / f"{day.julday:03d}"
        folder.mkdir(parents=True, exist_ok=True)
        tr.write(str(folder / f"{tr.stats.station}_{tr.stats.channel[-1]}.m"),
                 format="MSEED", encoding="STEIM2")
    return (lut, stations, archive, vt_responses(stations, root),
            np.array(planted), origins, lut_s)


def vt_locate_mags_path(device, spacing_km=0.5, keep=None):
    """vt_locate_mags: detect -> trigger -> locate with local magnitudes on
    the card at the full width of the Volcanotectonic_Iceland example
    (:func:`vt_workspace`), with the example's settings: detect with the
    classic env_squared STA/LTA (bandpass [2, 16, 2], 0.2/1.0 s) at
    timestep VT_TIMESTEP; trigger as dike_intrusion_trigger.py (marginal
    window 0.75 s, minimum interval 1.5 s, static 1.85 on the normalised
    trace, its region); locate as dike_intrusion_locate.py (centred
    env_squared onsets, GaussianPicker, marginal window 1.0 s, the
    Archive's response removal with pre_filt (0.05, 0.06, 30, 35) and
    water level 60, amp_params and mag_params as the example:
    Greenfield2018_bardarbunga, S_amp, trace filter .*H[NE]$, noise filter
    3), raw and Wood-Anderson cut waveforms. Checks: the planted events,
    and only they, triggered; each located within one node of its source;
    K1 v2 and M1 v2 launched once an event, no other kernel and no plain
    version on a CUDA tensor; each .event with a finite ML, ML_Err and
    ML_r2 and its .amps and WA cut waveforms written; each ML equal, in
    its 3 written significant figures, to a locate of the same events with
    device="cpu", and to locates on the card with the same responses read
    from RESP and from SAC_PZ (K1 v2 and M1 v2 once an event each). Prints
    the 1dsweep LUT's host seconds and the per-event split of
    locate_event_attrib, its magnitudes key among them. Returns a record
    with the VT plan's traveltimes and locate window for map_path, and,
    given ``keep``, the card's and the CPU's locate outputs kept there for
    export_path (its "export")."""

    import tempfile

    from quakemigrate_torch.io import (
        Archive,
        read_response_inv,
        read_triggered_events,
    )
    from quakemigrate_torch.io.table import read_csv
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops import cuda_onsets as con
    from quakemigrate_torch.seis import UTCDateTime, read
    from quakemigrate_torch.signal import QuakeScan, Trigger
    from quakemigrate_torch.signal.local_mag import LocalMag
    from quakemigrate_torch.signal.onsets import STALTAOnset
    from quakemigrate_torch.signal.pickers import GaussianPicker

    def onset(position):
        o = STALTAOnset(position=position, sampling_rate=VT_RATE,
                        signal_transform="env_squared")
        o.phases = ["P", "S"]
        o.bandpass_filters = {"P": [2, 16, 2], "S": [2, 16, 2]}
        o.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
        return o

    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        (lut, stations, archive_path, response_files, planted, origins,
         record["lut_s"]) = vt_workspace(root, spacing_km)
        record["workspace_s"] = time.perf_counter() - t0

        def vt_archive(responses, **options):
            return Archive(
                archive_path, stations, archive_format="YEAR/JD/STATION",
                response_inv=read_response_inv(str(responses), **options),
                response_removal_params={"pre_filt": (0.05, 0.06, 30, 35),
                                         "water_level": 60.0})

        archive = vt_archive(response_files["stationxml"])
        runs, run_name = root / "runs", "vt"
        start = UTCDateTime(VT_START) + VT_DETECT_OFFSET_S
        end = start + VT_DETECT_SPAN_S
        scan = QuakeScan(archive, lut, onset("classic"), str(runs), run_name,
                         device=device, timestep=VT_TIMESTEP)
        torch.cuda.synchronize()
        cm.reset_launches()
        _, detect_s = quiet(root, "detect", lambda: scan.detect(start, end))
        detect_launches = dict(cm.launches)
        trig = Trigger(lut, run_path=str(runs), run_name=run_name,
                       marginal_window=0.75, min_event_interval=1.5,
                       normalise_coalescence=True, threshold_method="static",
                       static_threshold=1.85, plot_trigger_summary=False)
        _, trigger_s = quiet(root, "trigger", lambda: trig.trigger(
            start, end, region=[-17.15, 64.72, 0.0, -16.65, 64.93, 14.0]))
        events = read_triggered_events(scan.run, starttime=start,
                                       endtime=end)
        times = [str(t) for t in events["CoaTime"]]
        print(f"vt_locate_mags: grid {lut.node_count.tolist()} "
              f"({int(np.prod(lut.node_count))} nodes), "
              f"{len(lut.station_data['Name'])} stations x P/S at "
              f"{VT_RATE} Hz; 1dsweep LUT (sweep_dx {VT_SWEEP_DX} km) "
              f"{record['lut_s']:.3f} s on the host; workspace "
              f"{record['workspace_s']:.3f} s, "
              f"detect {detect_s:.3f} s (launches {detect_launches}), trigger "
              f"{trigger_s:.3f} s; {len(events)} event(s) triggered: {times}; "
              f"planted origins {[str(o) for o in origins]}")
        check(len(events) == len(origins) and all(
            abs(t - o) < 1.0 for t, o in zip(events["CoaTime"], origins)),
            f"vt_locate_mags: triggered {times} for {origins}")
        trigger_file = (runs / run_name / "trigger" / "events"
                        / f"{run_name}_{start.year}_{start.julday:03d}"
                        "_TriggeredEvents.csv")

        def locate(dev, name, archive=archive):
            picker_onset = onset("centred")
            mags = LocalMag(
                amp_params={"signal_window": 1.0, "noise_window": 5.0,
                            "noise_measure": "ENV", "bandpass_filter": True,
                            "bandpass_lowcut": 2.0, "bandpass_highcut": 20.0,
                            "filter_corners": 4},
                mag_params={"A0": "Greenfield2018_bardarbunga",
                            "use_hyp_dist": True, "amp_feature": "S_amp",
                            "trace_filter": ".*H[NE]$", "noise_filter": 3.0},
                plot_amplitudes=False)
            loc = QuakeScan(archive, lut, picker_onset, str(runs), name,
                            device=dev, plot_event_summary=False,
                            picker=GaussianPicker(onset=picker_onset),
                            mags=mags, marginal_window=1.0,
                            write_cut_waveforms=True,
                            write_wa_waveforms=True)
            seen = []
            loc.on_event = lambda event, pass1, handle: seen.append(event)
            torch.cuda.synchronize()
            cm.reset_launches()
            con.reset_launches()
            with NoPlainOnCuda():
                _, wall = quiet(root, f"locate_{name}", lambda: loc.locate(
                    trigger_file=str(trigger_file)))
            torch.cuda.synchronize()
            return loc, seen, wall, {**cm.launches, **con.launches}

        loc, seen, locate_s, launches = locate(device, "vt_card")
        n = len(seen)
        print(f"vt_locate_mags: locate on the card {locate_s:.3f} s wall, "
              f"route {loc.locate_route}, {n} event(s), launches {launches}")
        locate_kernels = {"migrate_detect_v2": n,
                          "migrate_marginalise_v2": n,
                          "onset_stalta_v2": 2 * n}
        check(n == len(origins) and loc.locate_route == "k1_v2"
              and all(v == locate_kernels.get(k, 0)
                      for k, v in launches.items()),
              f"vt_locate_mags: {n} events, route {loc.locate_route}, "
              f"launches {launches}")
        record["onset_samples"] = seen[0]._marginalise_inputs[
            "block"].shape[-1]
        cpu, cpu_seen, cpu_s, _ = locate("cpu", "vt_cpu")
        # The same locate on the card with the responses read from RESP and
        # from SAC_PZ
        by_format = {}
        for key, options in (("resp", {}), ("sac_pz",
                                            {"sac_pz_format": True})):
            _, fmt_seen, fmt_s, fmt_launches = locate(
                device, f"vt_{key}",
                vt_archive(response_files[key], **options))
            by_format[key] = {"wall_s": fmt_s, "launches": fmt_launches,
                              "events": len(fmt_seen)}
            check(len(fmt_seen) == n
                  and fmt_launches["migrate_detect_v2"] == n
                  and fmt_launches["migrate_marginalise_v2"] == n,
                  f"vt_locate_mags {key}: {len(fmt_seen)} events, launches "
                  f"{fmt_launches}")
        out, cpu_out = runs / "vt_card" / "locate", runs / "vt_cpu" / "locate"
        results = []
        for event in seen:
            node = lut.index2coord([event.hypocentre], inverse=True)[0]
            dists = [int(np.abs(node - p).max()) for p in planted]
            header, rows = read_csv(out / "events" / f"{event.uid}.event")
            row = dict(zip(header, rows[0]))
            cpu_header, cpu_rows = read_csv(cpu_out / "events"
                                            / f"{event.uid}.event")
            cpu_row = dict(zip(cpu_header, cpu_rows[0]))
            amps_header, amps = read_csv(out / "amplitudes"
                                         / f"{event.uid}.amps")
            wa = read(out / "wa_cut_waveforms" / f"{event.uid}.m")
            ml = [row.get(k, "") for k in ("ML", "ML_Err", "ML_r2")]
            finite = all(v != "" and np.isfinite(float(v)) for v in ml)
            ml_by_format = {}
            for key in by_format:
                fmt_header, fmt_rows = read_csv(
                    runs / f"vt_{key}" / "locate" / "events"
                    / f"{event.uid}.event")
                ml_by_format[key] = dict(zip(fmt_header, fmt_rows[0]))["ML"]
            results.append({
                "uid": event.uid, "node": node.tolist(),
                "node_distance": min(dists), "ML": ml,
                "ML_cpu": [cpu_row.get(k, "") for k in ("ML", "ML_Err",
                                                        "ML_r2")],
                "ML_resp": ml_by_format["resp"],
                "ML_sac_pz": ml_by_format["sac_pz"],
                "amps_rows": len(amps),
                "ml_rows": sum(r[amps_header.index("ML")] != ""
                               for r in amps),
                "wa_traces": len(wa), "X": row["X"], "Y": row["Y"],
                "Z": row["Z"], "X_cpu": cpu_row["X"],
                "Y_cpu": cpu_row["Y"], "Z_cpu": cpu_row["Z"]})
            print(f"vt_locate_mags {event.uid}: node {node.tolist()} "
                  f"({min(dists)} nodes from the nearest planted source); "
                  f"ML, ML_Err, ML_r2 {ml} (CPU run "
                  f"{results[-1]['ML_cpu']}, RESP {ml_by_format['resp']}, "
                  f"SAC_PZ {ml_by_format['sac_pz']}); X/Y/Z {row['X']} "
                  f"{row['Y']} "
                  f"{row['Z']} (CPU run {cpu_row['X']} {cpu_row['Y']} "
                  f"{cpu_row['Z']}); .amps {len(amps)} rows, "
                  f"{results[-1]['ml_rows']} with an ML; {len(wa)} WA cut "
                  f"traces")
            check(min(dists) <= 1 and finite and row["ML"] == cpu_row["ML"]
                  and ml_by_format == {"resp": row["ML"],
                                       "sac_pz": row["ML"]}
                  and len(amps) == 3 * len(stations) and len(wa) > 0,
                  f"vt_locate_mags {event.uid}: {results[-1]}")

        def split(scan_):
            keys = sorted({k for r in scan_.locate_event_attrib for k in r})
            return {k: [r.get(k) for r in scan_.locate_event_attrib]
                    for k in keys}

        record.update(
            grid=lut.node_count.tolist(), onsets=2 * len(stations),
            detect_s=detect_s, detect_launches=detect_launches,
            trigger_s=trigger_s, locate_s=locate_s, locate_cpu_s=cpu_s,
            launches=launches, events=results, response_formats=by_format,
            event_split_s=split(loc), event_split_cpu_s=split(cpu))
        print(f"vt_locate_mags: per-event split, host s, card: "
              f"{record['event_split_s']}; CPU ({cpu_s:.3f} s wall): "
              f"{record['event_split_cpu_s']}")
        inp = seen[0]._marginalise_inputs
        record["map_geometry"] = {
            "tt": loc._traveltime_table(),
            "node_count": tuple(int(n) for n in lut.node_count),
            "fsmp": inp["fsmp"], "nsamples": inp["nsamples"],
            "lsmp": inp["block"].shape[-1] - inp["fsmp"] - inp["nsamples"]}
        if keep is not None:
            record["export"] = (
                keep_locate(runs / "vt_card", keep, "vt_locate_mags"),
                stations, lut.unit_name,
                keep_locate(runs / "vt_cpu", keep, "vt_locate_mags_cpu"))
    return record


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


def f3_traveltimes(rng):
    """Homogeneous-moveout tables of the F3 geometry: 12 surface stations
    at random on the grid of F3_NODES at F3_SPACING_KM, vp F3_VP and vs
    F3_VS, phase-major, at F3_RATE."""

    from quakemigrate_torch.lut import traveltime_table

    axes = [np.arange(n) * F3_SPACING_KM for n in F3_NODES]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    stations = rng.uniform([0.0, 0.0], [axes[0][-1], axes[1][-1]],
                           size=(N_STATIONS, 2))
    dist = [np.sqrt((x - sx) ** 2 + (y - sy) ** 2 + z**2)
            for sx, sy in stations]
    return traveltime_table([d / v for v in (F3_VP, F3_VS) for d in dist],
                            F3_RATE)


def k3_bound(n_nodes, n_onsets, t_len, nsamples):
    """K3's bound (:func:`roofline`): its inputs read once (the logged
    onsets [O, T], the flat int32 traveltimes [N, O], inv_available) and
    its three [n_tiles, S] outputs written once, against O adds and four
    more operations (scale, exp, max, sum) per node and sample; and the
    floor of its gather, the n_nodes x O x S 4-byte onset reads. K3 reads
    the onset rows with global loads: they stay in L2 (whose rate NVIDIA
    does not publish) and are cached in L1, which shares the SM's
    shared-memory pipe, so the floor is taken at SMEM_BYTES_PER_S, as
    for the staged kernels (``smem_bound_ms``)."""

    from quakemigrate_torch.ops.cuda_migrate import K3_TILE

    n_tiles = -(-n_nodes // K3_TILE)
    nbytes = 4 * (n_onsets * t_len + n_nodes * n_onsets + 1
                  + 3 * n_tiles * nsamples)
    bound_ms, bound_by = roofline(nbytes, n_nodes * nsamples * (n_onsets + 4))
    gather = 4 * n_nodes * n_onsets * nsamples
    return {"bound_ms": bound_ms, "bound_by": bound_by,
            "smem_bound_ms": gather / SMEM_BYTES_PER_S * 1e3,
            "gather_bytes": gather}


def hold_windows(label, windows, results, tt_dev, device, fsmp, nsamples,
                 plain, coa_at_idx):
    """Each window's DetectScan result against ``plain(block)`` (max_coa,
    max_coa_n, max_idx on the card): max_coa within MAX_COA_RTOL,
    max_coa_n within MAX_COA_N_RTOL, the argmax equal or tie-consistent
    (``coa_at_idx(block, idx)``, the plain coalescence at the chosen node,
    within MAX_COA_RTOL of the maximum). Returns (errors, peaks)."""

    errs = {"max_coa": 0.0, "max_coa_n": 0.0, "tie": 0.0, "max_abs_err": 0.0,
            "argmax_equal": []}
    peaks = []
    for w, (block, res) in enumerate(zip(windows, results)):
        check(res is not None, f"{label} window {w}: no result")
        max_coa, max_coa_n, max_idx, ijk = res
        check(max_coa.shape == (nsamples,) and ijk.shape == (nsamples, 3)
              and np.isfinite(max_coa).all() and np.isfinite(max_coa_n).all(),
              f"{label} window {w}: shapes or non-finite values")
        ref = [x.cpu().numpy() for x in plain(block)]
        rel = np.abs(max_coa - ref[0]) / np.abs(ref[0])
        rel_n = np.abs(max_coa_n - ref[1]) / np.abs(ref[1])
        tie = np.abs(ref[0] - coa_at_idx(block, max_idx)) / np.abs(ref[0])
        check(rel.max() <= MAX_COA_RTOL and rel_n.max() <= MAX_COA_N_RTOL
              and tie.max() <= MAX_COA_RTOL,
              f"{label} window {w}: max_coa {rel.max()}, max_coa_n "
              f"{rel_n.max()}, tie {tie.max()}")
        errs["max_coa"] = max(errs["max_coa"], float(rel.max()))
        errs["max_coa_n"] = max(errs["max_coa_n"], float(rel_n.max()))
        errs["tie"] = max(errs["tie"], float(tie.max()))
        errs["max_abs_err"] = max(errs["max_abs_err"],
                                  float(np.abs(max_coa - ref[0]).max()))
        errs["argmax_equal"].append(float((max_idx == ref[2]).mean()))
        peak = int(np.argmax(max_coa))
        peaks.append((float(max_coa[peak]), ijk[peak], peak))
    print(f"{label}: every window vs its plain version on the card: max_coa "
          f"{errs['max_coa']:.2e}, max_coa_n {errs['max_coa_n']:.2e}, tie "
          f"{errs['tie']:.2e}, argmax equal {errs['argmax_equal']}")
    return errs, peaks


def hold_to_cpu_run(label, root, scan, windows, start, first, coa_at_idx,
                    cpu_scan, n_windows=KURTOSIS_CPU_WINDOWS,
                    rtol=MAX_COA_RTOL, rtol_n=MAX_COA_N_RTOL, block_rtol=0.0):
    """Hold ``scan``'s detect on the card to ``cpu_scan``, the same
    QuakeScan with device="cpu" (the plain window), run here over
    ``n_windows`` windows from the card run's window ``first``
    (``windows``: the card's (block, result) in order, from ``start``).
    Checks: each window's block equal to the card's (within
    ``block_rtol`` where the onsets were computed on each device, on the
    standard path); max_coa within ``rtol`` and max_coa_n within
    ``rtol_n`` of the CPU's (default MAX_COA_RTOL and MAX_COA_N_RTOL); the
    card's argmax the CPU's or tie-consistent (the CPU's plain coalescence
    at the card's node, ``coa_at_idx(block, idx, "cpu")``, within
    ``rtol`` of the CPU's maximum); the .scanmseed over that span:
    COA and COA_N within max(1 count, ``rtol`` of the value) of the
    CPU's, the CPU tests' bound, X, Y and Z equal where the argmaxes
    are. Returns a record."""

    from quakemigrate_torch.seis import read

    def host(a):
        return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

    def block_equal(a, b):
        a, b = host(a), host(b)
        if not block_rtol:
            return np.array_equal(a, b)
        return a.shape == b.shape and np.allclose(a, b, rtol=block_rtol,
                                                  atol=0)

    n = n_windows
    cpu_start = start + first * ARCHIVE_TIMESTEP
    cpu_seen = {}
    cpu_scan.on_window = lambda i, block, result: cpu_seen.update(
        {i: (block, result)})
    _, wall = quiet(root, f"{label}_cpu", lambda: cpu_scan.detect(
        cpu_start, cpu_start + n * ARCHIVE_TIMESTEP))
    check(sorted(cpu_seen) == list(range(n)),
          f"{label} on the CPU: windows {sorted(cpu_seen)}")
    errs = {"max_coa": 0.0, "max_coa_n": 0.0, "tie": 0.0}
    same = []
    for i in range(n):
        (block, res), (cpu_block, ref) = windows[first + i], cpu_seen[i]
        check(len(block) == len(cpu_block) and all(
            block_equal(a, b) for a, b in zip(block, cpu_block)),
            f"{label}: the CPU's window {i} is not the card's {first + i}")
        rel = np.abs(res[0] - ref[0]) / np.abs(ref[0])
        rel_n = np.abs(res[1] - ref[1]) / np.abs(ref[1])
        tie = np.abs(ref[0] - coa_at_idx(cpu_block, res[2], "cpu")) / np.abs(
            ref[0])
        check(rel.max() <= rtol and rel_n.max() <= rtol_n
              and tie.max() <= rtol,
              f"{label} window {first + i} against the CPU's: max_coa "
              f"{rel.max()}, max_coa_n {rel_n.max()}, tie {tie.max()}")
        for key, x in (("max_coa", rel), ("max_coa_n", rel_n), ("tie", tie)):
            errs[key] = max(errs[key], float(x.max()))
        same.append(res[2] == ref[2])
    same = np.concatenate(same)

    def traces(qs):
        path = (qs.run.path / "detect" / "scanmseed"
                / f"{cpu_start.year}_{cpu_start.julday:03d}.scanmseed")
        return {tr.stats.station: tr for tr in read(path)}

    card, cpu = traces(scan), traces(cpu_scan)
    counts = {}
    for name, rtol in (("COA", rtol), ("COA_N", rtol),
                       ("X", None), ("Y", None), ("Z", None)):
        want = cpu[name].data.astype(np.int64)
        off = int(round((cpu[name].stats.starttime
                         - card[name].stats.starttime)
                        * card[name].stats.sampling_rate))
        got = card[name].data[off:off + want.size].astype(np.int64)
        check(off >= 0 and got.size == want.size == same.size,
              f"{label}: .scanmseed {name} spans {got.size} / {want.size} "
              f"samples at offset {off}, {same.size} scanned")
        diff = np.abs(got - want)
        ok = (diff <= np.maximum(1, rtol * np.abs(want)) if rtol
              else (diff == 0) | ~same)
        check(ok.all(), f"{label}: .scanmseed {name} differs from the "
              f"CPU's at {int((~ok).sum())} samples (largest {diff.max()})")
        counts[name] = int(diff.max())
    record = {"windows": [first, first + n], "wall_s": wall,
              "vs_cpu": errs, "argmax_equal": float(same.mean()),
              "scanmseed_max_count_diff": counts}
    print(f"{label}: device=\"cpu\" detect of windows {first}-"
          f"{first + n - 1}: {wall:.3f} s wall; the card against it {record}")
    return record


def hold_k3_windows(label, detector, windows, results, tt_dev, device):
    """Each window's K3 route result held exactly, on the prepared onsets
    of its block (the DetectScan's front end): the detector's kernel
    (K3 v2 where it takes the plan, else K3) combined over its tiles
    against the plain version with the kernels' arithmetic
    (``ops.cuda_migrate.detect_reduce_flat_reference``): max_coa bit for
    bit, the argmax the first flat argmax at every sample, the sum within
    K3_SUM_RTOL; K3 v2 also bit for bit to K3 in max and argmax; and the
    DetectScan's max_coa and max_idx equal to that launch's. These
    launches come after the path's counts were read. Returns a record."""

    from quakemigrate_torch.experiments import exp_global_v2
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops.scan_window import fused_onsets

    rec = {"max_bit_equal": True, "argmax_equal": True, "sum_rel_err": 0.0,
           "max_abs_err": 0.0, "scan_equal": True}
    if detector.tables is not None:
        rec["equal_to_k3"] = True
    for w, (block, res) in enumerate(zip(windows, results)):
        tensors = [torch.from_numpy(a).to(device) for a in block]
        combined, available = fused_onsets(*tensors, "classic", "energy",
                                           0.4)
        onsets_log, inv = detector.prepare(combined, tensors[2], available)
        got = detector.reduce_log(onsets_log, inv)
        ref = cm.combine_flat_tiles(*cm.detect_reduce_flat_reference(
            onsets_log, tt_dev, inv, detector.fsmp, detector.nsamples))
        v1 = (None if detector.tables is None else cm.combine_flat_tiles(
            *detector.launch_v1(onsets_log, inv)))
        held = exp_global_v2.hold(got, ref, v1)
        scan_equal = (np.array_equal(res[0], got[0].cpu().numpy())
                      and np.array_equal(res[2], got[1].cpu().numpy()))
        check(held["ok"] and held["sum_rel_err"] <= K3_SUM_RTOL
              and scan_equal, f"{label} window {w}: {held}, the scan's "
              f"result equal to the kernel's {scan_equal}")
        for key in ("max_bit_equal", "argmax_equal", "equal_to_k3"):
            if key in rec:
                rec[key] = rec[key] and held[key]
        rec["scan_equal"] = rec["scan_equal"] and scan_equal
        for key in ("sum_rel_err", "max_abs_err"):
            rec[key] = max(rec[key], held[key])
    print(f"{label}: every window's kernel against the plain version with "
          f"its arithmetic: {rec}")
    return rec


def f3_path(device):
    """F3: a coarse regional scan no staged kernel takes. The geometry of
    F3_NODES (25,600 nodes at 10 km, 12 stations x P/S at 100 Hz):
    detect_route gives "k3" with K1 v2's and K2 v2's reasons, decided
    before any launch, and K3 v2 takes the plan; F3_WINDOWS windows
    through DetectScan launch K3 v2 (csrc/migrate_detect_global_v2.cu)
    once each and no other kernel, held to the plain window on the card
    (max_coa 1e-5, max_coa_n 1e-4, the argmax tie-consistent) and
    exactly (:func:`hold_k3_windows`), the planted source found within
    one node. Then locate's passes on the same plan: pass 1 through
    route_detector at a locate geometry (K3 v2 once, held exactly), M1
    ring over a 100-sample marginal window at the peak against the plain
    migrate_marginalise (M1_RTOL_OF_MAX of the maximum, the same peak
    node) and M2 ring against the plain migrate_map (MAP_RTOL of each
    value), one launch each and nothing else; each held to its plain
    version on K3 v2's tables and to the old kernel (M1 bit for bit at
    this one-chunk window, M2 simple bit for bit, the map's max K3 v2's
    tmax bit for bit) and timed in turns with it (exp_ring), with its
    bound, gather floor, ring, registers and spills. K3 v2 timed in turns
    with K3 (CUDA events), with its bound, gather floor, ring, blocks per
    SM, registers and spills, and a sweep of its onsets a stage. In double
    on the same window's onsets: M1 ring f64 and M2 ring f64 against M1
    f64 and M2 simple f64 (exp_ring), and detect's K3 v3 f64 (its
    streamed form) held to the plain float64 reduction and to K3 v2 f64,
    in turns with K3 v2 f64, K3 v2, K3 f64 and K3 (exp_double)."""

    from quakemigrate_torch.experiments import (
        exp_double,
        exp_global_v2,
        exp_ring,
    )
    from quakemigrate_torch.experiments.exp_kernel_breakdown import in_turns
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops.migrate import (
        detect_reduce,
        migrate_map,
        migrate_marginalise,
    )
    from quakemigrate_torch.ops.scan_window import fused_onsets
    from quakemigrate_torch.signal.scan import (
        DetectScan,
        detect_route,
        route_detector,
    )

    rng = np.random.default_rng(2032)
    tt = f3_traveltimes(rng)
    lsmp = int(tt.max()) + 2 * int(F3_STA_LTA["S"][1] * F3_RATE) + 100
    windows, node = make_windows(
        tt, rng, F3_WINDOWS, plant_window=1, node_count=F3_NODES,
        fsmp=F3_FSMP, nsamples=F3_NSAMPLES, lsmp=lsmp, rate=F3_RATE,
        sta_lta=F3_STA_LTA)
    planted = np.array(np.unravel_index(node, F3_NODES))
    route = detect_route(tt, F3_NODES, device)
    plan = route[2]
    print(f"f3: {np.prod(F3_NODES)} nodes, {tt.shape[1]} onsets, r_span "
          f"{plan.r_span}, largest traveltime {tt.max()} samples; route "
          f"{route[0]}: {route[1]}")
    check(route[0] == "k3" and "K1 v2 (" in route[1]
          and "K2 v2 (" in route[1] and "K3 v2" not in route[1],
          f"f3: route {route[0]} ({route[1]})")
    scan = DetectScan(tt, F3_NODES, F3_FSMP, lsmp, device=device, route=route)
    detector = scan.detector(F3_NSAMPLES)  # tables up before the count
    check(detector.tables is not None, f"f3: K3 v2 refused the plan: "
          f"{detector.v2_refusal}")
    torch.cuda.synchronize()
    cm.reset_launches()
    t0 = time.perf_counter()
    results = scan.detect(windows)
    wall = time.perf_counter() - t0
    launches = dict(cm.launches)
    check(launches["migrate_detect_global_v2"] == F3_WINDOWS
          and sum(launches.values()) == F3_WINDOWS,
          f"f3: launches {launches} for {F3_WINDOWS} windows")
    tt_dev = torch.from_numpy(tt).to(device)
    errs, peaks = hold_windows(
        "f3", windows, results, tt_dev, device, F3_FSMP, F3_NSAMPLES,
        lambda b: plain_window(b, tt_dev, device, F3_FSMP, F3_NSAMPLES),
        lambda b, idx: plain_coa_at(b, tt_dev, idx, device, F3_FSMP,
                                    F3_NSAMPLES))
    exact = hold_k3_windows("f3", detector, windows, results, tt_dev, device)
    dist = int(np.abs(peaks[1][1] - planted).max())
    print(f"f3: planted node {planted.tolist()}, window 1's peak "
          f"{peaks[1][0]:.6f} at {peaks[1][1].tolist()} ({dist} nodes); "
          f"{F3_WINDOWS} windows in {wall:.3f} s wall (first call), "
          f"device ms a window {np.round(scan.window_ms, 3).tolist()}")
    check(dist <= 1, f"f3: peak {dist} nodes from the planted source")

    # Locate's passes on the same plan, for the planted window: pass 1 as
    # QuakeScan.locate builds it (route_detector on detect's route and
    # plan, at the locate geometry: F3_LOCATE_NSAMPLES about the peak)
    block = [torch.from_numpy(a).to(device) for a in windows[1]]
    combined, available = fused_onsets(*block, "classic", "energy", 0.4)
    mask = block[2]
    l_fsmp = F3_FSMP + min(max(0, peaks[1][2] - F3_LOCATE_NSAMPLES // 2),
                           F3_NSAMPLES - F3_LOCATE_NSAMPLES)
    torch.cuda.synchronize()
    cm.reset_launches()
    pass1 = route_detector(route[0], plan, tt, F3_NODES, l_fsmp,
                           F3_LOCATE_NSAMPLES, device)
    l_log, l_inv = pass1.prepare(combined, mask, available)
    l_got = pass1.reduce_log(l_log, l_inv)
    torch.cuda.synchronize()
    pass1_launches = dict(cm.launches)
    check(pass1_launches["migrate_detect_global_v2"] == 1
          and sum(pass1_launches.values()) == 1,
          f"f3: locate pass 1 launches {pass1_launches}")
    pass1_rec = exp_global_v2.hold(
        l_got, cm.combine_flat_tiles(*cm.detect_reduce_flat_reference(
            l_log, tt_dev, l_inv, l_fsmp, F3_LOCATE_NSAMPLES)),
        cm.combine_flat_tiles(*pass1.launch_v1(l_log, l_inv)))
    l_peak = int(torch.argmax(l_got[0]))
    pass1_rec.update(launches=pass1_launches["migrate_detect_global_v2"],
                     fsmp=l_fsmp, nsamples=F3_LOCATE_NSAMPLES,
                     peak_node=np.unravel_index(
                         int(l_got[1][l_peak]), F3_NODES))
    pass1_rec["peak_node"] = [int(i) for i in pass1_rec["peak_node"]]
    check(pass1_rec["ok"] and pass1_rec["sum_rel_err"] <= K3_SUM_RTOL
          and np.abs(np.array(pass1_rec["peak_node"]) - planted).max() <= 1,
          f"f3: locate pass 1 {pass1_rec}")
    print(f"f3: locate's pass 1 (route_detector, {F3_LOCATE_NSAMPLES} "
          f"samples from {l_fsmp}): launches {pass1_launches}; {pass1_rec}")

    onsets_log, inv = detector.prepare(combined, mask, available)
    i0 = min(max(0, peaks[1][2] - 50), F3_NSAMPLES - 100)
    torch.cuda.synchronize()
    cm.reset_launches()
    marginal = detector.marginalise(onsets_log, inv, i0, 100)
    map_ = detector.map(onsets_log, inv)
    torch.cuda.synchronize()
    locate_launches = dict(cm.launches)
    check(locate_launches["migrate_marginalise_ring"] == 1
          and locate_launches["migrate_map_ring"] == 1
          and sum(locate_launches.values()) == 2,
          f"f3: locate launches {locate_launches}")
    t0 = time.perf_counter()
    want = migrate_marginalise(combined, tt_dev, mask, available, F3_FSMP,
                               F3_NSAMPLES, i0, 100)
    torch.cuda.synchronize()
    m1_plain_ms = (time.perf_counter() - t0) * 1e3
    m1_err = float((marginal - want).abs().max() / want.abs().max())
    same_peak = int(torch.argmax(marginal)) == int(torch.argmax(want))
    check(m1_err <= M1_RTOL_OF_MAX and same_peak,
          f"f3: M1 {m1_err} of the maximum, peak equal {same_peak}")
    t0 = time.perf_counter()
    want_map = migrate_map(combined, tt_dev, mask, available, F3_FSMP,
                           F3_NSAMPLES)
    torch.cuda.synchronize()
    map_plain_ms = (time.perf_counter() - t0) * 1e3
    map_err = float(((map_ - want_map).abs() / want_map.abs()).max())
    check(map_err <= MAP_RTOL, f"f3: M2 ring {map_err}")
    del want_map, map_
    torch.cuda.empty_cache()
    # The ring kernels against their plain versions and the old kernels,
    # in turns with them
    ring_case = exp_ring.setup(detector, onsets_log, inv, "f3")
    ring_m1 = exp_ring.m1_case(ring_case, (i0, 100))
    # Three chunks of 124 from a start of residue 1 mod 4: within 1e-6 of
    # M1 (whose chunks are 256)
    ring_m1["three_chunks"] = exp_ring.m1_case(
        ring_case, exp_ring.F3_CHUNKS_WINDOW, reps=5)
    ring_m2 = exp_ring.m2_case(ring_case, reps=10,
                               tmax=exp_ring.k3_tmax(ring_case))
    torch.cuda.empty_cache()
    # F3 in double: M1 ring f64 and M2 ring f64 on the plan's K3 v2 f64
    # tables and the same onsets in float64, held and in turns with M1 f64
    # and M2 simple f64: at 100 samples, over the same 249 samples (two
    # chunks of 128), the map over 1,000
    det64 = cm.CudaDetectGlobal(tt, F3_NODES, F3_FSMP, F3_NSAMPLES, device,
                                plan=plan, dtype=torch.float64)
    case64 = exp_ring.setup(det64, onsets_log.double(), inv.double(),
                            "f3 f64")
    f3_double = {
        "m1": exp_ring.m1_case(case64, (i0, 100)),
        "m1_chunks": exp_ring.m1_case(case64, exp_ring.F3_CHUNKS_WINDOW,
                                      reps=5),
        "map": exp_ring.m2_case(case64, reps=10,
                                tmax=exp_ring.k3_tmax(case64))}
    del case64, det64
    # Detect in double on the window's onsets: K3 v3 f64 (the streamed
    # form: G 3) held and in turns with K3 v2 f64, K3 v2, K3 f64 and K3
    s64 = exp_double.setup(tt, F3_NODES, F3_FSMP, F3_NSAMPLES, device,
                           onsets=combined.double().cpu().numpy(),
                           n_masked=0, plan=plan)
    s64.mask, s64.available = mask.double(), float(mask.sum())
    for dtype, det in s64.det.items():
        s64.prepared[dtype] = det.prepare(s64.onsets.to(dtype),
                                          s64.mask.to(dtype), s64.available)
    f3_double["k3"] = exp_double.detect_case(s64, "f3 double k3")
    # F3's layout has several groups: the detector's window runs K3 v2
    # f64, K3 v3 f64 (its streamed form) only as the yardstick
    check(f3_double["k3"]["ok"] and f3_double["k3"]["v3_launches"] == {
              "migrate_detect_global_v2_f64": 1},
          f"f3: K3 v3 f64 or K3 v2 f64 does not hold, or the detector's "
          f"window launched {f3_double['k3']['v3_launches']}")
    del s64
    torch.cuda.empty_cache()

    case = exp_global_v2.setup(tt, F3_NODES, F3_FSMP, F3_NSAMPLES, device,
                               onsets_log=onsets_log, inv=inv, plan=plan)
    bound = exp_global_v2.bound(case)
    v1_bound = k3_bound(tt.shape[0], tt.shape[1], onsets_log.shape[1],
                        F3_NSAMPLES)
    turns = in_turns({"k3_v2": lambda: detector.launch(onsets_log, inv),
                      "k3": lambda: detector.launch_v1(onsets_log, inv)},
                     reps=20)
    k3_v2_ms, k3_ms = (float(np.mean(turns[k])) for k in ("k3_v2", "k3"))
    plain_ms = cuda_ms(lambda: detect_reduce(
        combined, tt_dev, mask, available, F3_FSMP, F3_NSAMPLES,
        tt.shape[0]), reps=3, warmup=1)
    m1_ms, map_ms = ring_m1["m1_ms"], ring_m2["m2_simple_ms"]
    layout = exp_global_v2.layout_record(case, detector.layout)
    resources = exp_global_v2.resources()
    print(f"f3: K3 v2 {k3_v2_ms:.4f} ms, K3 {k3_ms:.4f} ms a launch in "
          f"turns {turns}; plain detect_reduce {plain_ms:.4f} ms; K3 v2's "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), gather "
          f"floor {bound['smem_bound_ms']:.4f} ms, the gather at "
          f"{bound['gather_bytes'] / k3_v2_ms / 1e9:.3f} TB/s (K3 at "
          f"{v1_bound['gather_bytes'] / k3_ms / 1e9:.3f}); ring {layout}; "
          f"resources {resources}; M1 ring at 100 samples "
          f"{ring_m1['ms']:.4f} ms, M1 {m1_ms:.4f} (plain "
          f"{m1_plain_ms:.3f} ms, one run, {m1_err:.2e} of the maximum), "
          f"M2 ring at {F3_NSAMPLES} samples {ring_m2['ms']:.4f} ms, M2 "
          f"simple {map_ms:.4f} (plain {map_plain_ms:.3f} ms, one run, "
          f"{map_err:.2e} relative)")
    print(f"f3: K3 v2's onsets a stage (shape {cm.GLOBAL_V2_SHAPE}, the "
          "deepest ring at each):")
    sweep = exp_global_v2.sweep(case, exp_global_v2.plain(case),
                                shapes=(cm.GLOBAL_V2_SHAPE,))
    check(all(r["ok"] for r in sweep), "f3: a ring of the sweep does not "
          "hold")
    m1_bound = marginalise_bound(tt, 100)
    map_bound_ = map_bound(tt, F3_NSAMPLES, detector.base)
    return {
        "launches": launches["migrate_detect_global_v2"], "route": route[0],
        "route_reason": route[1], "r_span": plan.r_span,
        "nodes": int(np.prod(F3_NODES)), "onsets": int(tt.shape[1]),
        "nsamples": F3_NSAMPLES, "windows": F3_WINDOWS, "wall_s": wall,
        "window_ms": scan.window_ms, "planted": planted.tolist(),
        "peak_node_distance": dist,
        "vs_plain": {k: v for k, v in errs.items() if k != "argmax_equal"},
        "argmax_equal": errs["argmax_equal"], "exact": exact,
        "ms": k3_v2_ms, "k3_ms": k3_ms, "turns_ms": turns,
        "plain_ms": plain_ms, **bound, **layout, "resources": resources,
        "sweep": sweep, "locate_pass1": pass1_rec,
        "k3": {**v1_bound, "ms": k3_ms},
        # M1 and M2 simple: timed in turns beside the ring kernels
        "m1": {"window": 100, "ms": m1_ms, **m1_bound},
        "map": {"nsamples": F3_NSAMPLES, "ms": map_ms, **map_bound_},
        "m1_ring": {"launches": locate_launches["migrate_marginalise_ring"],
                    "plain_function_ms": m1_plain_ms,
                    "err_of_max": m1_err, **ring_m1},
        "map_ring": {"launches": locate_launches["migrate_map_ring"],
                     "plain_function_ms": map_plain_ms,
                     "function_rel_err": map_err, **ring_m2},
        "double": f3_double}


def _build_resources(kernel):
    """Registers and spills of ``kernel`` from the build's ptxas report."""

    from quakemigrate_torch import _build

    return {name.split("_kernel")[0]: {k: v for k, v in entry.items()
                                       if k != "wgmma_serialized"}
            for name, entry in _build.kernel_resources(kernel).items()}


def xla_icequake_path(device, tt, windows, n_windows=4):
    """kernel="xla" at Icequake: the slice's pre-built windows (24 onsets,
    625 samples) through DetectScan on detect_route's kernel="xla" route,
    "k3", where K3 v2 takes the plan K1 v2 takes: each window held to the
    plain window and exactly (:func:`hold_k3_windows`); K3 v2 timed in
    turns with K3 and K1 v2 on the same prepared onsets (k3_v2, k3,
    k1_v2, k1_v2, k3, k3_v2; 20 launches a turn). Returns a record."""

    from quakemigrate_torch.experiments import exp_global_v2, exp_ring
    from quakemigrate_torch.experiments.exp_kernel_breakdown import in_turns
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops.scan_window import fused_onsets
    from quakemigrate_torch.signal.scan import DetectScan, detect_route

    scan = DetectScan(tt, NODE_COUNT, FSMP, LSMP, device=device,
                      route=detect_route(tt, NODE_COUNT, device, "xla"))
    check((scan.route, scan.route_reason) == ("k3", "kernel='xla'"),
          f"xla: route {scan.route} ({scan.route_reason})")
    detector = scan.detector(NSAMPLES)
    check(detector.tables is not None, "xla: K3 v2 refused the plan")
    torch.cuda.synchronize()
    cm.reset_launches()
    results = scan.detect(windows[:n_windows])
    launches = dict(cm.launches)
    check(launches["migrate_detect_global_v2"] == n_windows
          and sum(launches.values()) == n_windows,
          f"xla: launches {launches} for {n_windows} windows")
    tt_dev = torch.from_numpy(tt).to(device)
    errs, _ = hold_windows(
        "xla icequake", windows[:n_windows], results, tt_dev, device, FSMP,
        NSAMPLES, lambda b: plain_window(b, tt_dev, device),
        lambda b, idx: plain_coa_at(b, tt_dev, idx, device))
    exact = hold_k3_windows("xla icequake", detector, windows[:n_windows],
                            results, tt_dev, device)
    block = [torch.from_numpy(a).to(device) for a in windows[0]]
    combined, available = fused_onsets(*block, "classic", "energy", 0.4)
    onsets_log, inv = detector.prepare(combined, block[2], available)
    k1_v2 = cm.CudaDetect(tt, NODE_COUNT, FSMP, NSAMPLES, device,
                          plan=scan._plan)
    turns = in_turns({"k3_v2": lambda: detector.launch(onsets_log, inv),
                      "k3": lambda: detector.launch_v1(onsets_log, inv),
                      "k1_v2": lambda: k1_v2.launch(onsets_log, inv)},
                     reps=20)
    case = exp_global_v2.setup(tt, NODE_COUNT, FSMP, NSAMPLES, device,
                               onsets_log=onsets_log, inv=inv,
                               plan=scan._plan)
    bound = exp_global_v2.bound(case)
    layout = exp_global_v2.layout_record(case, detector.layout)
    mean = {k: float(np.mean(v)) for k, v in turns.items()}
    record = {"launches": launches["migrate_detect_global_v2"],
              "ms": mean["k3_v2"], "k3_ms": mean["k3"],
              "k1_v2_ms": mean["k1_v2"], "turns_ms": turns, **bound,
              **layout, "exact": exact,
              "vs_plain": {k: v for k, v in errs.items()
                           if k != "argmax_equal"},
              "argmax_equal": errs["argmax_equal"]}
    print(f"xla icequake: K3 v2 {record['ms']:.4f} ms, K3 "
          f"{record['k3_ms']:.4f} ms, K1 v2 {record['k1_v2_ms']:.4f} ms in "
          f"turns {turns}; K3 v2's bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}), gather floor {bound['smem_bound_ms']:.4f} "
          f"ms, the gather at {bound['gather_bytes'] / record['ms'] / 1e9:.3f}"
          f" TB/s; ring {layout}; launches {launches}")
    return record


def span_path(device, span, kernel="auto", n_windows=2, precision="single"):
    """A plan of the K3 route's toy geometry (tests/test_torch_scan_route.py:
    4 x 4 x 4 nodes, one station x P/S, one traveltime of ``span`` - 1
    samples) through DetectScan on detect_route's ``kernel`` route,
    which must be "k3": at 32,769 samples K3 v2's ring cannot hold the
    window, so K3 (csrc/migrate_detect_global.cu) runs, its reason
    logged with the others; at 15,000 with kernel="xla", K3 v2 on its
    one-block shape (GLOBAL_V2_WIDE_SHAPE). Each window launches the
    kernel once and nothing else and is held to the plain window and
    exactly (:func:`hold_k3_windows`). With ``precision="double"`` the
    blocks are float64 and the route's float64 form runs: at 15,000
    samples K3 v2 f64's ring of doubles cannot hold the window, so K3 f64,
    held to the plain window and to the plain float64 reduction within
    DOUBLE_RTOL (:func:`hold_double_windows`). Locate's kernels follow on
    the detector for the first window's onsets (their launches counted
    from 0): at 32,769 samples the ring refuses the plan as K3 v2 does, so
    M1 and M2's simple form run, one launch each (the wide-span path of
    the two); at 15,000 M1 ring and M2 ring on K3 v2's one-block shape; in
    double at 15,000 the ring of doubles refuses the plan as K3 v2 f64
    does, so M1 f64 and M2 simple f64 run, one launch each (their path
    since M1 ring f64 and M2 ring f64 took K3 v2 f64's plans); each held
    to the plain migrate_marginalise (over 100 samples) and migrate_map,
    in float64 within DOUBLE_RTOL. Returns a record."""

    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops.migrate import (
        migrate_map,
        migrate_marginalise,
    )
    from quakemigrate_torch.ops.scan_window import fused_onsets
    from quakemigrate_torch.signal.scan import DetectScan, detect_route

    double = precision == "double"

    node_count = (4, 4, 4)
    tt = np.zeros((int(np.prod(node_count)), 2), np.int32)
    tt[1, 1] = span - 1
    fsmp, nsamples = 200, 300
    lsmp = int(tt.max()) + 2 * int(F3_STA_LTA["S"][1] * F3_RATE) + 100
    windows, _ = make_windows(
        tt, np.random.default_rng(2033), n_windows, plant_window=0,
        node_count=node_count, fsmp=fsmp, nsamples=nsamples, lsmp=lsmp,
        rate=F3_RATE, sta_lta=F3_STA_LTA)
    dtype = torch.float64 if double else torch.float32
    if double:
        windows = [tuple(a.astype(np.float64) if a.dtype == np.float32
                         else a for a in block) for block in windows]
    route = detect_route(tt, node_count, device, kernel, precision)
    scan = DetectScan(tt, node_count, fsmp, lsmp, device=device, route=route,
                      dtype=dtype)
    detector = scan.detector(nsamples)
    label = f"span {span}" + (" double" if double else "")
    name = cm.typed("migrate_detect_global" if detector.tables is None
                    else "migrate_detect_global_v2", dtype)
    check(route[0] == "k3" and ((detector.tables is None)
                                == ("K3 v2" in route[1])),
          f"{label}: route {route[0]} ({route[1]})")
    torch.cuda.synchronize()
    cm.reset_launches()
    results = scan.detect(windows)
    launches = dict(cm.launches)
    check(launches[name] == n_windows
          and sum(launches.values()) == n_windows,
          f"{label}: launches {launches} for {n_windows} windows")
    tt_dev = torch.from_numpy(tt).to(device)
    errs, _ = hold_windows(
        label, windows, results, tt_dev, device, fsmp, nsamples,
        lambda b: plain_window(b, tt_dev, device, fsmp, nsamples),
        lambda b, idx: plain_coa_at(b, tt_dev, idx, device, fsmp, nsamples))
    exact = (hold_double_windows(label, scan, windows, results) if double
             else hold_k3_windows(label, detector, windows, results, tt_dev,
                                  device))
    shape = None if detector.layout is None else list(detector.layout.shape)
    print(f"{label}: route {route[0]} ({route[1]}); {name}, shape {shape}; "
          f"launches {launches}")
    record = {"launches": launches[name], "kernel": name, "shape": shape,
              "route_reason": route[1], "r_span": route[2].r_span,
              "exact": exact,
              "vs_plain": {k: v for k, v in errs.items()
                           if k != "argmax_equal"}}

    # Locate's pass 2 and map on the same detector
    block = [torch.from_numpy(a).to(device) for a in windows[0]]
    combined, available = fused_onsets(*block, "classic", "energy", 0.4)
    onsets_log, inv = detector.prepare(combined, block[2], available)
    ring = detector.ring_refusal is None
    locate = [cm.typed(name, dtype) for name in (
        ["migrate_marginalise_ring", "migrate_map_ring"] if ring
        else ["migrate_marginalise", "migrate_map"])]
    torch.cuda.synchronize()
    cm.reset_launches()
    marginal = detector.marginalise(onsets_log, inv, 100, 100)
    map_ = detector.map(onsets_log, inv)
    torch.cuda.synchronize()
    locate_launches = dict(cm.launches)
    check(ring == (detector.tables is not None)
          and locate_launches == {k: int(k in locate) for k in cm.launches},
          f"{label}: locate launches {locate_launches} (ring refusal "
          f"{detector.ring_refusal})")
    want = migrate_marginalise(combined, tt_dev, block[2], available, fsmp,
                               nsamples, 100, 100)
    want_map = migrate_map(combined, tt_dev, block[2], available, fsmp,
                           nsamples)
    m1_err = float((marginal - want).abs().max() / want.abs().max())
    map_err = float(((map_ - want_map).abs() / want_map.abs()).max())
    check(marginal.dtype == map_.dtype == dtype
          and m1_err <= (DOUBLE_RTOL if double else M1_RTOL_OF_MAX)
          and map_err <= (DOUBLE_RTOL if double else MAP_RTOL),
          f"{label}: locate's kernels {m1_err}, {map_err}")
    print(f"{label}: locate on {locate} (ring refusal "
          f"{detector.ring_refusal}): launches {locate_launches}; "
          f"marginal {m1_err:.2e} of the maximum, map {map_err:.2e}")
    record["locate"] = {
        "kernels": locate, "ring_refusal": detector.ring_refusal,
        "launches": {k: locate_launches[k] for k in locate},
        "m1_err_of_max": m1_err,
        "m1_abs_err": float((marginal - want).abs().max()),
        "map_rel_err": map_err,
        "map_abs_err": float((map_ - want_map).abs().max())}
    return record


def kurtosis_onset_for(rate=RATE):
    """The kurtosis_detect phase's KurtosisOnset: the Icequake example's
    bandpass, KURTOSIS_WINDOWS and KURTOSIS_SMOOTHING."""

    from quakemigrate_torch.signal.onsets import KurtosisOnset

    return KurtosisOnset(
        sampling_rate=rate, phases=["P", "S"],
        bandpass_filters={"P": [10, 124, 4], "S": [10, 124, 4]},
        kurtosis_windows=dict(KURTOSIS_WINDOWS),
        smoothing_window=KURTOSIS_SMOOTHING)


def kurtosis_detect_path(device, root, lut, archive, planted, origin, start,
                         end):
    """kurtosis_detect: QuakeScan.detect with KurtosisOnset over the
    synthetic Icequake archive (259,008 nodes, 26 onsets, 250 Hz, 60 s at
    timestep 2.5 s) on the card. Checks: route k1_v2, one K1 v2 launch a
    window and no other kernel; each window held to the plain kurtosis
    window on the card (max_coa 1e-5, max_coa_n 1e-4, argmax
    tie-consistent); for the first and the planted window the front end
    on the card within FRONT_END_RTOL of its plain version in float32 on
    the CPU (both also read against float64); the same QuakeScan.detect
    with device="cpu" over KURTOSIS_CPU_WINDOWS windows about the planted
    one (:func:`hold_to_cpu_run`); the .scanmseed peak within one node of
    the planted source. Then Trigger (the normalised trace, static
    KURTOSIS_THRESHOLD, the example's marginal window and interval):
    exactly the planted event; and QuakeScan.locate of it with the same
    onset on the card: one K1 v2 and one M1 v2 launch, no plain version
    on a CUDA tensor, the spline hypocentre within one node of the
    planted source. Returns a record."""

    from quakemigrate_torch.io import read_scanmseed, read_triggered_events
    from quakemigrate_torch.ops import cuda_front_end as cfe
    from quakemigrate_torch.ops import cuda_onsets as con
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops.scan_window import (
        detect_window_fused_kurtosis,
        fused_kurtosis_onsets,
    )
    from quakemigrate_torch.signal import QuakeScan, Trigger

    onset = kurtosis_onset_for()
    scan = QuakeScan(archive, lut, onset, str(root / "runs"),
                     "kurtosis_detect", device=device,
                     timestep=ARCHIVE_TIMESTEP)
    seen = {}
    scan.on_window = lambda i, block, result: seen.update(
        {i: (block, result)})
    torch.cuda.synchronize()
    cm.reset_launches()
    cfe.reset_launches()
    with NoPlainOnCuda("kurtosis_detect"):
        _, wall = quiet(root, "kurtosis_detect",
                        lambda: scan.detect(start, end))
    launches = dict(cm.launches)
    fe_launches = dict(cfe.launches)
    detect_scan = scan.detect_scan
    n_windows = len(seen)
    print(f"kurtosis_detect: {n_windows} windows, route {detect_scan.route}, "
          f"fsmp {detect_scan.fsmp}, lsmp {detect_scan.lsmp}; {wall:.3f} s "
          f"wall (cold); launches {launches}, front end {fe_launches}")
    check(detect_scan.route == "k1_v2"
          and n_windows == round(ARCHIVE_SPAN_S / ARCHIVE_TIMESTEP)
          and launches["migrate_detect_v2"] == n_windows
          and sum(launches.values()) == n_windows
          and fe_launches == front_end_only("front_end_kurtosis_v2",
                                            n_windows),
          f"kurtosis_detect: route {detect_scan.route}, {n_windows} windows, "
          f"launches {launches}, front end {fe_launches}")
    nsmooth, taper_pad, min_onset = onset.fused_static_args(ARCHIVE_TIMESTEP)
    check(nsmooth == 12, f"kurtosis_detect: nsmooth {nsmooth}")
    fsmp = detect_scan.fsmp
    nsamples = int(round(ARCHIVE_TIMESTEP * RATE))
    tt_dev = torch.from_numpy(detect_scan.traveltimes).to(device)

    def on_card(block):
        return [torch.from_numpy(a).to(device) for a in block]

    def plain(block):
        return detect_window_fused_kurtosis(
            *on_card(block), tt_dev, nsmooth, taper_pad, min_onset, fsmp,
            nsamples)

    coa_at_idx = coa_at_for(scan)

    order = sorted(seen)
    blocks = [seen[i][0] for i in order]
    errs, peaks = hold_windows(
        "kurtosis_detect", blocks, [seen[i][1] for i in order], tt_dev,
        device, fsmp, nsamples, plain, coa_at_idx)
    planted_window = int(np.argmax([p[0] for p in peaks]))
    FRONT_END_BLOCKS["kurtosis"] = (blocks[planted_window],
                                    (nsmooth, taper_pad, min_onset))
    front = {}
    for w in sorted({0, planted_window}):
        # the card's front end is the path's: FE2
        card, _ = detect_scan.front_end(*on_card(blocks[w]))
        cpu, _ = fused_kurtosis_onsets(
            *(torch.from_numpy(a) for a in blocks[w]), nsmooth, taper_pad,
            min_onset)
        exact, _ = fused_kurtosis_onsets(
            *(torch.from_numpy(a.astype(np.float64) if a.dtype == np.float32
                               else a) for a in blocks[w]),
            nsmooth, taper_pad, min_onset)

        def err(x, ref):
            return float(((x.cpu().double() - ref.double()).abs()
                          / ref.double().abs()).max())

        front[w] = {"card_vs_cpu": err(card, cpu),
                    "card_vs_f64": err(card, exact),
                    "cpu_vs_f64": err(cpu, exact)}
        check(front[w]["card_vs_cpu"] <= FRONT_END_RTOL,
              f"kurtosis_detect: window {w}'s front end {front[w]}")
    print(f"kurtosis_detect: the front end in float32 on the card (FE2) "
          f"against the CPU's, and each against float64 on the CPU, by "
          f"window: {front}")
    window = front_end_window("kurtosis_detect", scan,
                              blocks[planted_window])
    window["scan_dispatch_s"] = sum(
        row["dispatch"] for row in scan.detect_batch_attrib) / n_windows

    first = min(max(planted_window - 1, 0), n_windows - KURTOSIS_CPU_WINDOWS)
    cpu_run = hold_to_cpu_run(
        "kurtosis_detect", root, scan, [seen[i] for i in order], start,
        first, coa_at_idx,
        QuakeScan(archive, lut, kurtosis_onset_for(), str(root / "runs"),
                  "kurtosis_detect_cpu", device="cpu",
                  timestep=ARCHIVE_TIMESTEP))

    (data, _), _ = quiet(root, "kurtosis_read_scanmseed",
                         lambda: read_scanmseed(scan.run, start, end, 0.0,
                                                lut.unit_conversion_factor))
    coa_n = np.asarray(data["COA_N"])
    peak = int(np.argmax(coa_n))
    away = np.abs(np.arange(coa_n.size) - peak) > round(
        LOCATE_MIN_EVENT_INTERVAL * RATE)
    ijk = peaks[planted_window][1]
    dist = int(np.abs(ijk - planted).max())
    print(f"kurtosis_detect: normalised trace peak {coa_n[peak]:.5f}, its "
          f"largest value beyond {LOCATE_MIN_EVENT_INTERVAL} s of the peak "
          f"{coa_n[away].max():.5f}; the planted window's peak at "
          f"{ijk.tolist()} against the planted {planted.tolist()} ({dist} "
          f"nodes)")
    check(dist <= 1, f"kurtosis_detect: peak {dist} nodes from the planted "
          "source")

    runs, run_name = scan.run.path.parent, scan.run.name
    trig = Trigger(lut, run_path=str(runs), run_name=run_name,
                   marginal_window=LOCATE_MARGINAL_WINDOW,
                   min_event_interval=LOCATE_MIN_EVENT_INTERVAL,
                   normalise_coalescence=True, threshold_method="static",
                   static_threshold=KURTOSIS_THRESHOLD,
                   plot_trigger_summary=False)
    _, trigger_s = quiet(root, "kurtosis_trigger",
                         lambda: trig.trigger(start, end))
    events = read_triggered_events(scan.run, starttime=start, endtime=end)
    print(f"kurtosis_detect: trigger {trigger_s:.3f} s; {len(events)} "
          f"event(s): {[str(t) for t in events['CoaTime']]}, planted "
          f"origin {origin}")
    check(len(events) == 1 and abs(events["CoaTime"][0] - origin)
          < LOCATE_MARGINAL_WINDOW,
          f"kurtosis_detect: triggered {[str(t) for t in events['CoaTime']]}")

    locate = QuakeScan(archive, lut, kurtosis_onset_for(), str(runs),
                       run_name, device=device,
                       marginal_window=LOCATE_MARGINAL_WINDOW,
                       plot_event_summary=False)
    located = []
    locate.on_event = lambda event, pass1, handle: located.append(event)
    event_data = []
    calculate = locate.onset.calculate_onsets
    locate.onset.calculate_onsets = lambda data, **kw: (
        event_data.append(data) or calculate(data, **kw))
    torch.cuda.synchronize()
    cm.reset_launches()
    con.reset_launches()
    with NoPlainOnCuda():
        _, locate_s = quiet(root, "kurtosis_locate",
                            lambda: locate.locate(starttime=start,
                                                  endtime=end))
    torch.cuda.synchronize()
    del locate.onset.calculate_onsets
    locate_launches = {**cm.launches, **con.launches}
    check(len(located) == 1 and locate.locate_route == "k1_v2"
          and locate_launches["migrate_detect_v2"] == 1
          and locate_launches["migrate_marginalise_v2"] == 1
          and locate_launches["onset_kurtosis_v2"] == 2
          and sum(locate_launches.values()) == 4,
          f"kurtosis_detect locate: {len(located)} events, route "
          f"{locate.locate_route}, launches {locate_launches}")
    onsets_record = onsets_case("kurtosis_detect", locate.onset,
                                event_data[0], device)
    event = located[0]
    node = lut.index2coord([event.hypocentre], inverse=True)[0]
    loc_dist = int(np.abs(node - planted).max())
    print(f"kurtosis_detect: locate {locate_s:.3f} s wall, origin "
          f"{event.otime} (planted {origin}), spline node {node.tolist()} "
          f"({loc_dist} nodes); launches {locate_launches}; split "
          f"{locate.locate_event_attrib}")
    check(loc_dist <= 1, f"kurtosis_detect: located {loc_dist} nodes from "
          "the planted source")
    return {"launches": launches["migrate_detect_v2"], "windows": n_windows,
            "front_end_launches": fe_launches, "front_end_window": window,
            "wall_s": wall, "window_ms": list(detect_scan.window_ms),
            "vs_plain": {k: v for k, v in errs.items()
                         if k != "argmax_equal"},
            "argmax_equal_min": min(errs["argmax_equal"]),
            "front_end": front, "cpu_run": cpu_run,
            "peak_node_distance": dist, "coa_n_peak": float(coa_n[peak]),
            "coa_n_away_max": float(coa_n[away].max()),
            "trigger_s": trigger_s, "locate_s": locate_s,
            "locate_launches": locate_launches, "onsets": onsets_record,
            "onset_samples": located[0]._marginalise_inputs[
                "block"].shape[-1],
            "located_node_distance": loc_dist,
            "locate_split": locate.locate_event_attrib}


def decimate_detect_path(device, root, lut, archive, planted, start, end):
    """decimate_detect: a QuakeScan built on the Icequake LUT, the LUT
    then decimated in place by [2, 2, 2] (as the Askja example's detect
    script does), and QuakeScan.detect over the same archive with the
    example's STA/LTA onset: the scan migrates on the decimated grid (the
    flat table and the plan built anew; K1 v2 once a window), and the
    .scanmseed peak lies within one decimated node of the planted source.
    Returns a record."""

    from quakemigrate_torch.ops import cuda_front_end as cfe
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.seis import read
    from quakemigrate_torch.signal.onsets import STALTAOnset
    from quakemigrate_torch.signal.scan import QuakeScan

    onset = STALTAOnset(position="classic", sampling_rate=RATE)
    onset.bandpass_filters = {"P": [10, 124, 4], "S": [10, 124, 4]}
    onset.sta_lta_windows = {p: list(w) for p, w in STA_LTA.items()}
    scan = QuakeScan(archive, lut, onset, str(root / "runs"),
                     "decimate_detect", device=device,
                     timestep=ARCHIVE_TIMESTEP)
    full_rows = scan._traveltime_table().shape[0]
    counts = lut.node_count.copy()
    lut.decimate([2, 2, 2], inplace=True)
    torch.cuda.synchronize()
    cm.reset_launches()
    cfe.reset_launches()
    with NoPlainOnCuda("decimate_detect"):
        _, wall = quiet(root, "decimate_detect",
                        lambda: scan.detect(start, end))
    launches = dict(cm.launches)
    fe_launches = dict(cfe.launches)
    n_windows = round(ARCHIVE_SPAN_S / ARCHIVE_TIMESTEP)
    rows = scan.detect_scan.traveltimes.shape[0]
    print(f"decimate_detect: grid {counts.tolist()} -> "
          f"{lut.node_count.tolist()} ({full_rows} -> {rows} traveltime "
          f"rows), route {scan.detect_scan.route}; {wall:.3f} s wall; "
          f"launches {launches}, front end {fe_launches}")
    check(rows == lut.n_nodes and scan.detect_scan.route == "k1_v2"
          and launches["migrate_detect_v2"] == n_windows
          and sum(launches.values()) == n_windows
          and fe_launches == front_end_only("front_end_stalta_v2",
                                            n_windows),
          f"decimate_detect: {rows} rows for {lut.n_nodes} nodes, route "
          f"{scan.detect_scan.route}, launches {launches}, front end "
          f"{fe_launches}")
    path = (scan.run.path / "detect" / "scanmseed"
            / f"{start.year}_{start.julday:03d}.scanmseed")
    out = {tr.stats.station: tr for tr in read(path)}
    peak = int(np.argmax(out["COA"].data))
    xyz = np.array([[out["X"].data[peak] / 1e6, out["Y"].data[peak] / 1e6,
                     out["Z"].data[peak] / 1e3 / lut.unit_conversion_factor]])
    node = lut.index2coord(xyz, inverse=True)[0]
    offset = (counts - 2 * (lut.node_count - 1) - 1) // 2
    planted_small = (planted - offset) / 2
    dist = float(np.abs(node - planted_small).max())
    print(f"decimate_detect: peak at decimated node {node.tolist()}, the "
          f"planted source at {planted_small.tolist()} ({dist} nodes)")
    check(dist <= 1, f"decimate_detect: peak {dist} decimated nodes from "
          "the planted source")
    return {"launches": launches["migrate_detect_v2"], "wall_s": wall,
            "front_end_launches": fe_launches,
            "node_count": lut.node_count.tolist(), "rows": rows,
            "window_ms": list(scan.detect_scan.window_ms),
            "peak_node_distance": dist}


def kurtosis_decimate_path(device):
    """kurtosis_detect (:func:`kurtosis_detect_path`), then
    decimate_detect (:func:`decimate_detect_path`), on one synthetic
    Icequake workspace (:func:`archive_workspace`) in a temporary
    directory. Returns their records."""

    import tempfile

    from quakemigrate_torch.io import Archive
    from quakemigrate_torch.seis import UTCDateTime

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        lut, stations, archive_path, planted, _, origin = (
            archive_workspace(root))
        archive = Archive(archive_path, stations,
                          archive_format="YEAR/JD/STATION")
        start = UTCDateTime(ARCHIVE_START) + ARCHIVE_SPAN_S / 2
        end = start + ARCHIVE_SPAN_S
        kurt = kurtosis_detect_path(device, root, lut, archive, planted,
                                    origin, start, end)
        dec = decimate_detect_path(device, root, lut, archive, planted,
                                   start, end)
    return kurt, dec


# double_path and standard_path: detect over DOUBLE_SPAN_S seconds about the
# planted event of an archive_detect workspace (windows of 2.5 s), the
# device="cpu" run held to it over CPU_HOLD_WINDOWS windows from the one
# before the planted window (the plain window over 259,008 nodes, ~10 s a
# window on the host); float64 against float64 within DOUBLE_RTOL (the
# kernels multiply by 1 / available where the plain version divides, and
# sum the tiles in another order: ~1e-15 in a CPU rehearsal), the
# standard path's onsets on the card against the CPU's within
# STANDARD_ONSET_RTOL (float64 ops on two devices, cast to float32)
DOUBLE_SPAN_S = 10.0
CPU_HOLD_WINDOWS = 2
DOUBLE_RTOL = 1e-12
# What the kernels line takes of an exp_ring record of M1 ring f64 (M2
# ring f64's: the same but its window and M1's keys)
RING_RECORD_KEYS = (
    "ms", "m1_ms", "other_split_ms", "split", "turns_ms", "kernel_ms",
    "plain_ms", "max_rel_err", "bound_ms", "bound_by", "smem_bound_ms",
    "equal_to_m1", "window", "n_stages", "layout_n_stages", "group", "smem",
    "blocks_per_sm", "passes", "registers", "spill_stores", "spill_loads")
STANDARD_ONSET_RTOL = 1e-6


def onsets_only(key, n):
    """The onsets' launch counts (ON1, ON2, ON1 v2, ON2 v2) of a run that
    launched ``key`` (a key of ops.cuda_onsets.launches, or None) ``n``
    times and no other."""

    from quakemigrate_torch.ops import cuda_onsets as con

    return {k: n if k == key else 0 for k in con.launches}


def front_end_only(key, n):
    """The front-end launch counts of a path whose windows ran ``key``
    (a key of ops.cuda_front_end.launches, or None) ``n`` times and no
    other front-end kernel."""

    from quakemigrate_torch.ops import cuda_front_end as cfe

    return {k: n if k == key else 0 for k in cfe.launches}


def block_tensors(block, device):
    """A detect window's block (numpy arrays or tensors) as tensors on
    ``device``."""

    return [(a if torch.is_tensor(a) else torch.from_numpy(
        np.ascontiguousarray(a))).to(device) for a in block]


def coa_at_for(scan):
    """``coa_at_idx(block, idx, device)`` of a QuakeScan's detect windows:
    the plain coalescence of the block (its DetectScan's front end, in the
    block's type) at node ``idx[t]`` for each scan sample t, on
    ``device`` (the scan's where None)."""

    from quakemigrate_torch.ops.migrate import _prepare_onsets

    ds = scan.detect_scan
    nsamples = int(round(scan.timestep * scan.scan_rate))

    def coa_at_idx(block, idx, dev=None):
        dev = ds.device if dev is None else dev
        tensors = block_tensors(block, dev)
        combined, available = ds.front_end(*tensors)
        onsets_log = _prepare_onsets(combined, tensors[2])
        tt = torch.from_numpy(ds.traveltimes).to(dev)
        rows = tt[torch.from_numpy(np.asarray(idx)).long().to(dev)].long()
        t = torch.arange(nsamples, device=dev)
        acc = torch.zeros(nsamples, dtype=onsets_log.dtype, device=dev)
        for o in range(onsets_log.shape[0]):
            acc = acc + onsets_log[o][ds.fsmp + rows[:, o] + t]
        return torch.exp(acc / available).cpu().numpy()
    return coa_at_idx


def window_case(scan, block):
    """exp_double's case of one detect window of ``scan`` (the block's
    combined onsets in float64 on the card, the plan of the scan's
    traveltimes), for the float64 kernels' holds, turns and bounds."""

    from quakemigrate_torch.experiments import exp_double

    ds = scan.detect_scan
    tensors = block_tensors(block, ds.device)
    combined, _ = ds.front_end(*tensors)
    mask = tensors[2].cpu().numpy()
    s = exp_double.setup(ds.traveltimes, ds.node_count, ds.fsmp,
                         int(round(scan.timestep * scan.scan_rate)),
                         ds.device, onsets=combined.double().cpu().numpy(),
                         n_masked=0)
    s.mask = torch.from_numpy(mask.astype(np.float64)).to(ds.device)
    s.available = float(mask.sum())
    for dtype, det in s.det.items():
        s.prepared[dtype] = det.prepare(s.onsets.to(dtype), s.mask.to(dtype),
                                        s.available)
    return s


def hold_double_windows(label, scan, windows, results):
    """Each float64 window's kernel held on the card (K3 v3 f64, or K3 f64
    where K3 v2 f64's ring refuses the plan): the DetectScan's detector on
    the window's prepared onsets against the plain float64
    ``detect_reduce`` (exp_double.hold_detect: max and sum within
    DOUBLE_RTOL, the argmax equal or tie-consistent), the scan's max_coa
    and max_idx equal to that launch's, and K3 v3 f64's per-tile max and
    argmax equal to K3 v2 f64's (``v2_equal``). These launches come after
    the path's counts were read. ``scan`` is a DetectScan or a QuakeScan.
    Returns a record."""

    from types import SimpleNamespace as NS

    from quakemigrate_torch.experiments import exp_double

    ds = getattr(scan, "detect_scan", scan)
    rec = {"max": 0.0, "sum": 0.0, "tie": 0.0, "max_abs_err": 0.0,
           "argmax_equal": 1.0, "scan_equal": True, "v2_equal": None}
    for w, (block, res) in enumerate(zip(windows, results)):
        tensors = block_tensors(block, ds.device)
        combined, available = ds.front_end(*tensors)
        nsamples = res[0].shape[0]
        detector = ds.detector(nsamples)
        onsets_log, inv = detector.prepare(combined, tensors[2], available)
        got = detector.reduce_log(onsets_log, inv)
        s = NS(onsets=combined.double(), mask=tensors[2].double(),
               available=float(tensors[2].sum()), device=ds.device,
               tt_dev=torch.from_numpy(ds.traveltimes).to(ds.device),
               fsmp=ds.fsmp, nsamples=nsamples, plan=ds._plan)
        held = exp_double.hold_detect(s, got)
        scan_equal = (np.array_equal(res[0], got[0].cpu().numpy())
                      and np.array_equal(res[2], got[1].cpu().numpy()))
        v2_equal = None
        if detector.tables is not None:
            v3 = detector.launch(onsets_log, inv)
            v2 = detector.launch_v2(onsets_log, inv)
            v2_equal = (torch.equal(v3[0], v2[0])
                        and torch.equal(v3[1], v2[1]))
            rec["v2_equal"] = v2_equal
            del v3, v2
        check(held["ok"] and held["max"] <= DOUBLE_RTOL and scan_equal
              and v2_equal is not False,
              f"{label} window {w}: {held}, the scan's result equal to the "
              f"kernel's {scan_equal}, K3 v3 f64's max and argmax K3 v2 "
              f"f64's {v2_equal}")
        for key in ("max", "sum", "tie", "max_abs_err"):
            rec[key] = max(rec[key], held[key])
        rec["argmax_equal"] = min(rec["argmax_equal"], held["argmax_equal"])
        rec["scan_equal"] = rec["scan_equal"] and scan_equal
    print(f"{label}: every float64 window's kernel against the plain "
          f"float64 version: {rec}")
    return rec


def event_text(run_dir):
    """The header and rows of the run's one .event file (csv)."""

    import csv

    files = sorted((run_dir / "locate" / "events").glob("*.event"))
    check(len(files) == 1, f"{run_dir.name}: .event files {files}")
    with open(files[0], newline="") as f:
        return list(csv.reader(f)), files[0].read_bytes()


def hold_event(label, card_dir, cpu_dir):
    """The card run's .event against the CPU run's: the same header and
    text fields, each number within one unit of the CPU's last written
    digit. Returns whether the files are equal byte for byte."""

    (got, got_bytes), (want, want_bytes) = (event_text(card_dir),
                                            event_text(cpu_dir))
    check(got[0] == want[0] and len(got) == len(want) == 2,
          f"{label}: .event header or rows differ")
    for name, a, b in zip(want[0], got[1], want[1]):
        try:
            x, y = float(a), float(b)
        except ValueError:
            check(a == b, f"{label}: .event {name} {a} against {b}")
            continue
        mantissa, _, exponent = b.lower().partition("e")
        unit = 10.0 ** (-len(mantissa.partition(".")[2])
                        + (int(exponent) if exponent else 0))
        check(abs(x - y) <= unit * (1 + 1e-9),
              f"{label}: .event {name} {a} against the CPU's {b}")
    return got_bytes == want_bytes


def npy_of(run_dir, kind):
    files = sorted((run_dir / "locate" / kind).glob("*.npy"))
    check(len(files) == 1, f"{run_dir.name}: {kind} {files}")
    return np.load(files[0])


def detect_and_hold(device, root, label, make_scan, start, end, planted,
                    route, kernel, front_end=None, onsets=None,
                    block_rtol=0.0, rtol=MAX_COA_RTOL,
                    rtol_n=MAX_COA_N_RTOL):
    """QuakeScan.detect over [start, end) on the card with the scan that
    ``make_scan(name, device)`` builds (no plain window or front end on a
    CUDA tensor): its route ``route``, ``kernel`` (a key of
    cuda_migrate.launches) launched once a window and nothing else,
    ``front_end`` (a key of cuda_front_end.launches, or None on the
    standard path) once a window and the other front end never, and
    ``onsets`` (a key of cuda_onsets.launches, or None: the fused path or
    a user's onset) twice a window (calculate_onsets' two phases on the
    standard path) and the other never; then
    held to the same
    detect with device="cpu" over CPU_HOLD_WINDOWS windows from the one
    before the planted window (:func:`hold_to_cpu_run`), and the
    planted window's peak within one node of the planted source. Returns
    (scan, record, the card's (block, result) by window)."""

    from quakemigrate_torch.ops import cuda_front_end as cfe
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops import cuda_onsets as con

    scan = make_scan(label, device)
    seen = {}
    scan.on_window = lambda i, block, result: seen.update(
        {i: (block, result)})
    torch.cuda.synchronize()
    cm.reset_launches()
    cfe.reset_launches()
    con.reset_launches()
    with NoPlainOnCuda(label):
        _, wall = quiet(root, label, lambda: scan.detect(start, end))
    torch.cuda.synchronize()
    launches = dict(cm.launches)
    fe_launches = dict(cfe.launches)
    onset_launches = dict(con.launches)
    ds = scan.detect_scan
    n_windows = len(seen)
    check(ds.route == route and n_windows == round(
        DOUBLE_SPAN_S / ARCHIVE_TIMESTEP) and launches[kernel] == n_windows
        and sum(launches.values()) == n_windows
        and fe_launches == front_end_only(front_end, n_windows)
        and onset_launches == onsets_only(onsets, 2 * n_windows),
        f"{label}: route {ds.route} ({ds.route_reason}), {n_windows} "
        f"windows, launches {launches}, front end {fe_launches}, onsets "
        f"{onset_launches}")
    order = sorted(seen)
    windows = [seen[i] for i in order]
    peaks = [float(res[0].max()) for _, res in windows]
    planted_window = int(np.argmax(peaks))
    _, res = windows[planted_window]
    ijk = res[3][int(np.argmax(res[0]))]
    dist = int(np.abs(ijk - planted).max())
    check(dist <= 1, f"{label}: peak {dist} nodes from the planted source")
    first = min(max(planted_window - 1, 0), n_windows - CPU_HOLD_WINDOWS)
    cpu_run = hold_to_cpu_run(
        label, root, scan, windows, start, first, coa_at_for(scan),
        make_scan(f"{label}_cpu", "cpu"), n_windows=CPU_HOLD_WINDOWS,
        rtol=rtol, rtol_n=rtol_n, block_rtol=block_rtol)
    record = {"route": ds.route, "route_reason": ds.route_reason,
              "windows": n_windows, "launches": launches,
              "front_end_launches": fe_launches,
              "onset_launches": onset_launches, "wall_s": wall,
              "window_ms": list(ds.window_ms), "cpu_run": cpu_run,
              "peak_node_distance": dist, "planted_window": planted_window}
    print(f"{label}: detect on the card {wall:.3f} s wall, route {ds.route} "
          f"({ds.route_reason}); launches {launches}, front end "
          f"{fe_launches}; planted window "
          f"{planted_window}, peak {dist} nodes from the planted source")
    return scan, record, windows


def trigger_one(root, scan, lut, start, end, origin, label):
    """Trigger over the scan's run (the example's settings): exactly the
    planted event. Returns the trigger file."""

    from quakemigrate_torch.io import read_triggered_events
    from quakemigrate_torch.signal import Trigger

    runs, run_name = scan.run.path.parent, scan.run.name
    trig = Trigger(lut, run_path=str(runs), run_name=run_name,
                   marginal_window=LOCATE_MARGINAL_WINDOW,
                   min_event_interval=LOCATE_MIN_EVENT_INTERVAL,
                   normalise_coalescence=True, threshold_method="static",
                   static_threshold=LOCATE_THRESHOLD,
                   plot_trigger_summary=False)
    quiet(root, f"{label}_trigger", lambda: trig.trigger(start, end))
    events = read_triggered_events(scan.run, starttime=start, endtime=end)
    check(len(events) == 1 and abs(events["CoaTime"][0] - origin)
          < LOCATE_MARGINAL_WINDOW,
          f"{label}: triggered {[str(t) for t in events['CoaTime']]}")
    return (scan.run.path / "trigger" / "events"
            / f"{run_name}_{start.year}_{start.julday:03d}"
            "_TriggeredEvents.csv")


def locate_card_and_cpu(root, label, make_scan, trigger_file, kernels,
                        planted, lut, **options):
    """QuakeScan.locate of ``trigger_file``'s event on the card (the
    scan ``make_scan(name, device, **options)`` builds; no plain version
    on a CUDA tensor; launches exactly ``kernels``, {name: count} of
    cuda_migrate's and the onsets' launches) and
    the same with device="cpu"; the .event held (:func:`hold_event`),
    the hypocentre within one node of the planted source. Returns
    (card run dir, CPU run dir, the card's event, record)."""

    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops import cuda_onsets as con

    scan = make_scan(label, "cuda", **options)
    seen = []
    scan.on_event = lambda event, pass1, handle: seen.append(event)
    torch.cuda.synchronize()
    cm.reset_launches()
    con.reset_launches()
    with NoPlainOnCuda(label):
        _, wall = quiet(root, label, lambda: scan.locate(
            trigger_file=str(trigger_file)))
    torch.cuda.synchronize()
    launches = {**cm.launches, **con.launches}
    check(len(seen) == 1 and launches == {**{k: 0 for k in launches},
                                          **kernels},
          f"{label}: {len(seen)} events, route {scan.locate_route}, "
          f"launches {launches}")
    cpu = make_scan(f"{label}_cpu", "cpu", **options)
    _, cpu_wall = quiet(root, f"{label}_cpu", lambda: cpu.locate(
        trigger_file=str(trigger_file)))
    node = lut.index2coord([seen[0].hypocentre], inverse=True)[0]
    dist = int(np.abs(node - planted).max())
    check(dist <= 1, f"{label}: located {dist} nodes from the planted source")
    equal = hold_event(label, scan.run.path, cpu.run.path)
    record = {"route": scan.locate_route, "launches": {
        k: v for k, v in launches.items() if v}, "wall_s": wall,
        "cpu_wall_s": cpu_wall, "node_distance": dist,
        "event_byte_equal": equal}
    print(f"{label}: locate on the card {wall:.3f} s, on the CPU "
          f"{cpu_wall:.3f} s; route {scan.locate_route}, launches "
          f"{record['launches']}, {dist} nodes from the planted source, "
          f".event byte-equal to the CPU's {equal}")
    return scan.run.path, cpu.run.path, seen[0], record


def double_path(device, root, lut, archive, planted, origin, start, end):
    """double_path: QuakeScan(precision="double") on the card over the
    Icequake workspace: detect (the fused STA/LTA window in float64, the
    "k3" route's K3 v3 f64 once a window and nothing else; each window's
    kernel held to the plain float64 reduction within DOUBLE_RTOL and to
    K3 v2 f64 bit for bit in the per-tile max and argmax, the .scanmseed
    to the device="cpu" float64 run: one count, X/Y/Z equal where the
    argmaxes are), Trigger (exactly the planted event), locate two-pass
    (K3 v3 f64 and M1 ring f64 once each, on K3 v2 f64's tables, nothing
    of K3 v2 f64 or M1 f64) and on the map path (M2 ring f64 once,
    nothing of M2 simple f64), each against the same locate on the CPU in
    float64: the .event within a digit, the marginal map and the 4-D map
    within DOUBLE_RTOL. Then each float64 kernel at the main path's shapes
    (the planted window's onsets; locate's) held to its plain version and
    timed in turns with its float32 form (exp_double): K3 v3 f64 with its
    yardstick K3 v2 f64, K3 v2, K3 f64 and K3; M1 ring f64 through
    exp_ring.m1_case in turns with M1 f64, M1 ring and M1, bit for bit M1
    f64 at locate's window (one chunk); M2 ring f64 through
    exp_ring.m2_case with M2 simple f64, M2 ring and M2 simple, bit for
    bit M2 simple f64 and its max K3 v2 f64's tmax. Returns a record."""

    from quakemigrate_torch.experiments import exp_double
    from quakemigrate_torch.signal.scan import QuakeScan

    def make(name, dev, **options):
        return QuakeScan(archive, lut, archive_onset(), str(root / "runs"),
                         name, device=dev, timestep=ARCHIVE_TIMESTEP,
                         marginal_window=LOCATE_MARGINAL_WINDOW,
                         precision="double", plot_event_summary=False,
                         **options)

    scan, record, windows = detect_and_hold(
        device, root, "double_detect", make, start, end, planted, "k3",
        "migrate_detect_global_v3_f64", front_end="front_end_stalta_v2",
        rtol=DOUBLE_RTOL, rtol_n=DOUBLE_RTOL)
    check(scan.detect_scan.route_reason == "precision='double'"
          and windows[0][0][0].dtype == np.float64,
          f"double_detect: {scan.detect_scan.route_reason}, blocks "
          f"{windows[0][0][0].dtype}")
    FRONT_END_BLOCKS["double"] = windows[record["planted_window"]][0]
    record["exact"] = hold_double_windows(
        "double_detect", scan, [b for b, _ in windows],
        [r for _, r in windows])
    trigger_file = trigger_one(root, scan, lut, start, end, origin,
                               "double_detect")
    two_card, two_cpu, event, record["two_pass"] = locate_card_and_cpu(
        root, "double_locate", make, trigger_file,
        {"migrate_detect_global_v3_f64": 1,
         "migrate_marginalise_ring_f64": 1, "onset_stalta_v2": 2},
        planted, lut, write_marginal_coalescence=True)
    marg = [npy_of(d, "marginalised_coalescence_maps")
            for d in (two_card, two_cpu)]
    record["two_pass"]["marginal_map_err"] = float(
        np.abs(marg[0] - marg[1]).max() / np.abs(marg[1]).max())
    map_card, map_cpu, map_event, record["map_path"] = locate_card_and_cpu(
        root, "double_map", make, trigger_file,
        {"migrate_map_ring_f64": 1, "onset_stalta_v2": 2}, planted, lut,
        write_coalescence=True)
    maps = [npy_of(d, "coalescence_maps") for d in (map_card, map_cpu)]
    record["map_path"]["map_rel_err"] = float(
        (np.abs(maps[0] - maps[1]) / np.abs(maps[1])).max())
    check(maps[0].dtype == np.float64 and marg[0].dtype == np.float64
          and record["map_path"]["map_rel_err"] <= DOUBLE_RTOL
          and record["two_pass"]["marginal_map_err"] <= DOUBLE_RTOL,
          f"double_path: maps against the CPU's {record['map_path']}, "
          f"{record['two_pass']}")
    del maps, marg
    print(f"double_path: the marginal map within "
          f"{record['two_pass']['marginal_map_err']:.2e} of the CPU's, the "
          f"4-D map {record['map_path']['map_rel_err']:.2e}")

    # The float64 kernels at the main path's shapes, held and timed in
    # turns with their float32 forms on the same inputs
    s = window_case(scan, windows[record["planted_window"]][0])
    record["k3_case"] = exp_double.detect_case(s, "double k3 at the window")
    check(record["exact"]["v2_equal"] is True
          and record["k3_case"]["v3_launches"] == {
              "migrate_detect_global_v3_f64": 1},
          f"double_path: K3 v3 f64 against K3 v2 f64 "
          f"{record['exact']['v2_equal']}, "
          f"{record['k3_case']['v3_equal_to_v2']}")
    del s
    inp = event._marginalise_inputs
    i0, i1 = event.trim_bounds
    s = exp_double.setup(scan._traveltime_table(), tuple(lut.node_count),
                         inp["fsmp"], inp["nsamples"], device,
                         onsets=inp["block"].cpu().numpy(), n_masked=0)
    s.mask, s.available = inp["mask"].double(), float(inp["available"])
    for dtype, det in s.det.items():
        s.prepared[dtype] = det.prepare(s.onsets.to(dtype), s.mask.to(dtype),
                                        s.available)
    record["m1_case"] = exp_double.marginalise_case(s, i0, i1 - i0)
    record["m2_case"] = exp_double.map_case(s)
    for key in ("k3_case", "m1_case", "m2_case"):
        check(record[key]["ok"], f"double_path: {key} does not hold")
    ring_m1, ring_m2 = record["m1_case"]["ring"], record["m2_case"]["ring"]
    check(ring_m1 is not None and ring_m2 is not None
          and ring_m1["equal_to_m1"] and ring_m2["equal_to_m2_simple"]
          and ring_m2["max_equal_to_k3_v2"],
          f"double_path: M1 ring f64 / M2 ring f64 not bit for bit M1 f64 / "
          f"M2 simple f64 and K3 v2 f64's tmax at locate's shapes")
    return record


def custom_onset_class():
    """A user's Onset subclass with only calculate_onsets (the reference's
    one abstract method): per phase the port's pre-processing (the
    Icequake example's bandpass), then in numpy a classic STA/LTA of each
    trace's energy at the example's windows, the RMS of a station's
    channels, clipped at 0.4; numpy onsets, no ``rows``."""

    from quakemigrate_torch.signal.onsets import Onset, OnsetData, pre_process

    class EnergyRatioOnset(Onset):
        phases = ["P", "S"]
        channel_maps = {"P": "*Z", "S": "*[N,E,1,2]"}
        channel_counts = {"P": 1, "S": 2}
        bandpass = [10, 124, 4]

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self._post = 0.0

        @property
        def pre_pad(self):
            return STA_LTA["S"][1] + 3 * STA_LTA["S"][0]

        @pre_pad.setter
        def pre_pad(self, value):
            pass

        @property
        def post_pad(self):
            return self._post

        @post_pad.setter
        def post_pad(self, ttmax):
            self._post = np.ceil(ttmax + 2 * STA_LTA["S"][1])

        def gaussian_halfwidth(self, phase):
            return STA_LTA[phase][0] * self.sampling_rate / 2

        def calculate_onsets(self, data, timespan=None, **kwargs):
            rate = self.sampling_rate
            t_len = int(round((data.endtime - data.starttime) * rate)) + 1
            rows, onsets, availability, filtered = [], {}, {}, None
            for phase in self.phases:
                nsta, nlta = (int(w * rate) + 1 for w in STA_LTA[phase])
                conditioned = pre_process(
                    data.waveforms.select(channel=self.channel_maps[phase]),
                    rate, data.resample, data.upfactor, self.bandpass,
                    data.starttime, data.endtime)
                filtered = (conditioned if filtered is None
                            else filtered + conditioned)
                for station in data.stations:
                    traces = [np.asarray(tr.data, np.float64) for tr in
                              conditioned.select(station=station)]
                    ok = (len(traces) == self.channel_counts[phase]
                          and all(len(x) == t_len for x in traces))
                    availability[f"{station}_{phase}"] = int(ok)
                    if not ok:
                        continue
                    csum = np.concatenate(
                        [np.zeros((len(traces), 1)),
                         np.cumsum(np.stack(traces) ** 2, axis=1)], axis=1)
                    sta = (csum[:, nsta:] - csum[:, :-nsta]) / nsta
                    lta = (csum[:, nlta:] - csum[:, :-nlta]) / nlta
                    ratio = np.ones((len(traces), t_len))
                    ratio[:, nlta - 1:] = (sta[:, nlta - nsta:]
                                           / np.maximum(lta, 1e-300))
                    row = np.maximum(np.sqrt((ratio ** 2).mean(axis=0)), 0.4)
                    rows.append(row)
                    onsets.setdefault(station, {})[phase] = row
            return np.stack(rows), OnsetData(
                onsets, self.phases, self.channel_maps, filtered,
                availability, data.starttime, data.endtime, rate)

    return EnergyRatioOnset


def standard_path(device, root, lut, archive, planted, origin, start, end):
    """standard_path: the reference's standard detect path on the card
    over the Icequake workspace, in float32 (its onsets from
    calculate_onsets, cast to float32 in the canonical slot layout, on
    the detect route's K1 v2): a user's Onset subclass defined here
    (numpy onsets from calculate_onsets only) through detect, Trigger and
    locate; ``fused_detect=False`` with the example's STALTAOnset; and
    ``ClassicSTALTAOnset``. Each reports its route, launches K1 v2 once a
    window and nothing else, and is held to the same run on the CPU
    (:func:`detect_and_hold`; the custom onset's locate too, K1 v2 and M1
    v2 once each). Returns a record."""

    from quakemigrate_torch.signal.onsets import ClassicSTALTAOnset
    from quakemigrate_torch.signal.scan import QuakeScan

    custom = custom_onset_class()

    def classic():
        onset = ClassicSTALTAOnset(sampling_rate=RATE)
        onset.bandpass_filters = {"P": [10, 124, 4], "S": [10, 124, 4]}
        onset.sta_lta_windows = {p: list(w) for p, w in STA_LTA.items()}
        return onset

    variants = {
        "custom": (lambda: custom(sampling_rate=RATE), {}, 0.0, None),
        "unfused": (archive_onset, {"fused_detect": False},
                    STANDARD_ONSET_RTOL, "onset_stalta_v2"),
        "classic": (classic, {}, STANDARD_ONSET_RTOL, "onset_stalta_v2"),
    }
    record = {}
    for name, (onset_of, options, block_rtol, onsets) in variants.items():
        def make(run, dev, onset_of=onset_of, options=options, **extra):
            return QuakeScan(archive, lut, onset_of(), str(root / "runs"),
                             run, device=dev, timestep=ARCHIVE_TIMESTEP,
                             marginal_window=LOCATE_MARGINAL_WINDOW,
                             plot_event_summary=False, **options, **extra)

        label = f"standard_{name}"
        scan, rec, _ = detect_and_hold(
            device, root, label, make, start, end, planted, "k1_v2",
            "migrate_detect_v2", onsets=onsets, block_rtol=block_rtol)
        check(not scan._fused_active, f"{label}: took the fused window")
        if name == "custom":
            trigger_file = trigger_one(root, scan, lut, start, end, origin,
                                       label)
            *_, rec["locate"] = locate_card_and_cpu(
                root, f"{label}_locate", make, trigger_file,
                {"migrate_detect_v2": 1, "migrate_marginalise_v2": 1},
                planted, lut)
        record[name] = rec
    return record


def double_standard_paths(device):
    """double_path and standard_path (:func:`double_path`,
    :func:`standard_path`) on one synthetic Icequake workspace
    (:func:`archive_workspace`) in a temporary directory, over
    DOUBLE_SPAN_S seconds about its planted event. Returns their
    records."""

    import tempfile

    from quakemigrate_torch.io import Archive
    from quakemigrate_torch.seis import UTCDateTime

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        lut, stations, archive_path, planted, _, origin = (
            archive_workspace(root))
        archive = Archive(archive_path, stations,
                          archive_format="YEAR/JD/STATION")
        start = (UTCDateTime(ARCHIVE_START) + ARCHIVE_SPAN_S
                 - DOUBLE_SPAN_S / 2)
        end = start + DOUBLE_SPAN_S
        double = double_path(device, root, lut, archive, planted, origin,
                             start, end)
        standard = standard_path(device, root, lut, archive, planted,
                                 origin, start, end)
    return double, standard


def front_end_window(label, scan, block, reps=10):
    """One detect window of ``scan`` (a QuakeScan after its detect) on
    ``block``, the scan's own front end (FE1 v2 or FE2 v2) against FE1 or
    FE2 (their yardstick) and the plain front end called directly, the
    same detector after each: the device kernels of a window
    (torch.profiler over ``reps`` windows, copies apart, by name), the
    front-end kernels' launches counted by their wrappers over the same
    windows, the window's CUDA-event ms in turns (FE, FE v1, plain, plain,
    FE v1, FE; mean of ``reps``), and the host's enqueue of a window
    (seconds, median of ``reps``, each from a synchronised device).
    Observations, not a claim. Returns a record."""

    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from quakemigrate_torch.experiments.exp_kernel_breakdown import in_turns
    from quakemigrate_torch.ops import cuda_front_end as cfe
    from quakemigrate_torch.ops import scan_window as sw
    from quakemigrate_torch.ops.scan_window import detect_window_cuda

    ds = scan.detect_scan
    factory, settings = scan._front_end_settings()
    plain = (sw.fused_kurtosis_onsets
             if factory is sw.kurtosis_front_end else sw.fused_onsets)
    tensors = block_tensors(block, ds.device)
    detector = ds.detector(tensors[0].shape[-1] - ds.fsmp - ds.lsmp)
    v1 = (cfe.fused_kurtosis_onsets_cuda
          if factory is sw.kurtosis_front_end else cfe.fused_onsets_cuda)
    fronts = {"fe": ds.front_end,
              "fe_v1": lambda *b: v1(*b, *settings),
              "plain": lambda *b: plain(*b, *settings)}
    fns = {key: (lambda front=front: detect_window_cuda(
        front, tensors, detector, ds.n_nodes)) for key, front in fronts.items()}
    record = {}
    for key, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        before = sum(cfe.launches.values())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        fe_launches = (sum(cfe.launches.values()) - before) / reps
        names = Counter(e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        copies = sum(c for n, c in names.items()
                     if n.startswith(("Memcpy", "Memset")))
        host = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        record[key] = {
            "launches": (sum(names.values()) - copies) / reps,
            "copies": copies / reps, "fe_launches": fe_launches,
            "dispatch_s": float(np.median(host)),
            "kernels": {n: c / reps for n, c in sorted(names.items())
                        if not n.startswith(("Memcpy", "Memset"))}}
    turns = in_turns(fns, reps)
    for key in fns:
        record[key]["turns_ms"] = turns[key]
        record[key]["ms"] = float(np.mean(turns[key]))
    print(f"{label}: a window with the scan's front end against the plain "
          f"front end called directly: " + "; ".join(
              f"{key} {r['launches']} kernels a window (profiler; front end "
              f"{r['fe_launches']} by its wrapper), {r['ms']:.4f} ms, host "
              f"enqueue {r['dispatch_s'] * 1e3:.4f} ms"
              for key, r in record.items()))
    print(f"{label}: the window's kernels with the scan's front end: "
          f"{record['fe']['kernels']}")
    return record


def front_end_bound(kind, tensors, nsmooth=1, transform="energy"):
    """FE1's or FE2's bound on a block: the block read once and the
    combined onsets and the available count written once, at the memory
    rate, against the arithmetic a sample of a row needs (FE1: the
    transform's square, the running sum's addition, two differences, a
    division and a multiplication for the ratio, the square, the weight
    and the combine's addition; FE2: three products for the powers, four
    additions, four differences, four divisions, the moments' 13 and the
    gate's product, the gradient, the smoothing's 2 a sample of the box
    where nsmooth > 1, 1 + cf and the combine's three) and three a
    combined sample (the division by the live count, the square root, the
    clip), at the card's rate for the dtype; compares and selects not
    counted. Returns {"bound_ms", "bound_by", "bytes", "operations"}."""

    channels = tensors[0]
    n_slots, c_max, t = channels.shape
    item = channels.element_size()
    nbytes = (sum(a.numel() * a.element_size() for a in tensors)
              + (n_slots * t + 1) * item)
    if kind == "stalta":
        per = 8 + (transform in ("energy", "env_squared"))
    else:
        per = 35 + (2 * nsmooth if nsmooth > 1 else 0)
    ops = n_slots * c_max * t * per + n_slots * t * 3
    bound_ms, bound_by = roofline(
        nbytes, ops, FP64_FLOP_PER_S if item == 8 else FP32_FLOP_PER_S)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "operations": ops}


def hold_front_end(label, got, want, rtol, exact=False):
    """``got`` (a front-end kernel's (combined, available)) against
    ``want`` (its plain version's, or another form's) on the card: the
    share of the combined onsets equal bit for bit, the largest relative
    and absolute difference, the available counts equal. Fails above
    ``rtol``, or with ``exact`` unless every value is equal bit for bit.
    Returns a record."""

    (got, available), (want, want_available) = got, want
    torch.cuda.synchronize()
    ints = torch.int64 if got.dtype == torch.float64 else torch.int32
    bit_equal = float((got.view(ints) == want.view(ints)).double().mean())
    diff = (got.double() - want.double()).abs()
    rel = float((diff / want.double().abs()).max())
    record = {"bit_equal": bit_equal, "max_rel": rel,
              "max_abs_err": float(diff.max()),
              "available_equal": float(available) == float(want_available)}
    print(f"front_end {label}: bit-equal share {bit_equal:.6f}, largest "
          f"relative difference {rel:.3e}, available equal "
          f"{record['available_equal']}")
    check(rel <= rtol and record["available_equal"]
          and (bit_equal == 1.0 or not exact),
          f"front_end {label}: {record}")
    return record


def front_end_resources(device):
    """Registers and spills of FE1 v2 and FE2 v2 (each instance, from the
    build's ptxas report) and their resident blocks per SM at three
    channels (the occupancy API): {"FE1 v2 f32": {...}, ...}."""

    from quakemigrate_torch import _build
    from quakemigrate_torch.ops.cuda_migrate import blocks_per_sm

    out = {}
    for name, entry in _build.kernel_resources("qm_fv").items():
        kind = 1 if "qm_fv1" in name else 2
        f64 = "IdE" in name
        label = f"FE{kind} v2 {'f64' if f64 else 'f32'}"
        out[label] = {k: v for k, v in entry.items()
                      if k != "wgmma_serialized"}
        out[label]["blocks_per_sm"] = blocks_per_sm(
            "qm_front_end_v2_blocks_per_sm", device, kind - 1, int(f64), 3)
    for name, entry in _build.kernel_resources("qm_fe").items():
        label = (f"FE{1 if 'qm_fe1' in name else 2} "
                 f"{'f64' if 'IdE' in name else 'f32'}")
        out[label] = {k: v for k, v in entry.items()
                      if k != "wgmma_serialized"}
    print(f"front_end: registers, spills and blocks per SM {out}")
    check(len(out) == 8 and all(
        r["spill_stores"] == 0 and r["spill_loads"] == 0
        for label, r in out.items() if " v2 " in label),
        f"front_end: FE1 v2 and FE2 v2 instances spill or are missing: {out}")
    return out


def front_end_device_ms(fn, reps):
    """torch.profiler's device time of ``fn()``'s hand kernels and of its
    memsets (the workspace's flags FE1 v2 and FE2 v2 zero on the stream),
    ms a call over ``reps`` calls after a warm-up call: {"kernel",
    "memset"}."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]

    def ms(keep):
        us = sum(e.time_range.elapsed_us() for e in device if keep(e.name))
        return us / reps / 1e3 if us > 0 else None

    return {"kernel": ms(lambda n: "qm_" in n),
            "memset": ms(lambda n: n.startswith("Memset"))}


def enqueue_s(fn, reps):
    """The host's enqueue of ``fn()`` (seconds, median of ``reps``, each
    from a synchronised device)."""

    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(host))


def front_end_path(device, reps=20):
    """front_end_path: FE1 v2 and FE2 v2 (csrc/front_end_v2.cu, the detect
    paths' front ends) and FE1 and FE2 (csrc/front_end.cu, their
    yardstick) held to their plain versions on the card, in the
    reference's order, over the CPU tests' cases at full size:
    archive_detect's block (float32, 2,038 samples), kurtosis_detect's
    block, a 30,000-sample block (the archive block tiled), double_path's
    float64 block, and blocks of 120,000 samples in float32 and float64
    (the archive and double blocks tiled; FE2 cannot stage them). FE1
    over both positions and the four transforms on the STA/LTA blocks;
    FE2 at nsmooth 1 and 5 and kurtosis_detect's settings (nsmooth 12,
    its taper), on the STA/LTA blocks with nkurt = nlta. Each hold prints
    the share equal bit for bit and the largest difference; v2 must equal
    the plain version bit for bit, and v1 where v1 takes the block (v1
    fails above FE_RTOL). FE1 v2 on the archive block also against the
    plain version on the CPU (within FRONT_END_RTOL). Then each kernel
    timed at the path's settings on each block: CUDA events over wrapper
    calls in turns (v2, v1, plain, plain, v1, v2; mean of ``reps``, half
    as many at 120,000 samples), v2 and v1 again with the calls queued
    behind a hold (their device time back to back, v2's memset
    included), torch.profiler's device time of the kernels (and of v2's
    memset; it can drop events, reading low), the wrappers' host
    enqueue, and
    :func:`front_end_bound`; and FE1 v2 and FE2 v2's registers, spills
    and blocks per SM. No PyTorch call computes either front end
    (library_ms None). v1's launches are counted over the path (the
    yardstick's). Returns a record."""

    from quakemigrate_torch.experiments.exp_kernel_breakdown import in_turns
    from quakemigrate_torch.ops import cuda_front_end as cfe
    from quakemigrate_torch.ops import scan_window as sw

    t_phase = time.perf_counter()
    kurt_block, kurt_settings = FRONT_END_BLOCKS["kurtosis"]
    archive = FRONT_END_BLOCKS["archive"]
    double = FRONT_END_BLOCKS["double"]

    def tiled(block, samples):
        reps_t = -(-samples // block[0].shape[-1])
        return (np.ascontiguousarray(np.tile(block[0], (1, 1, reps_t))[
            ..., :samples]), *block[1:])

    blocks = {"archive": block_tensors(archive, device),
              "kurtosis": block_tensors(kurt_block, device),
              "day": block_tensors(tiled(archive, FE_DAY_SAMPLES), device),
              "double": block_tensors(double, device),
              "long": block_tensors(tiled(archive, FE_LONG_SAMPLES), device),
              "long_double": block_tensors(tiled(double, FE_LONG_SAMPLES),
                                           device)}
    _, taper_pad, min_onset = kurt_settings
    record = {"holds": {}, "v2_vs_v1": {}, "times": {}, "shapes": {
        k: list(b[0].shape) + [str(b[0].dtype)] for k, b in blocks.items()}}

    def v1_takes(b, powers):
        n_slots, c_max, t = b[0].shape
        return cfe.stage_bytes(t, powers * c_max, b[0].element_size()) <= (
            cfe.MAX_STAGE_BYTES)

    def stalta(b, position="classic", transform="energy"):
        args = (*b, position, transform, 0.4)
        return {"v2": lambda: cfe.fused_onsets_cuda_v2(*args),
                "v1": lambda: cfe.fused_onsets_cuda(*args),
                "plain": lambda: sw.fused_onsets(*args)}

    def kurtosis_inputs(b):
        return (*b[:3], b[3 if len(b) == 4 else 4])

    def kurtosis(b, nsmooth, taper=taper_pad):
        args = (*kurtosis_inputs(b), nsmooth, taper, min_onset)
        return {"v2": lambda: cfe.fused_kurtosis_onsets_cuda_v2(*args),
                "v1": lambda: cfe.fused_kurtosis_onsets_cuda(*args),
                "plain": lambda: sw.fused_kurtosis_onsets(*args)}

    def hold(label, fns, rtol, with_v1):
        want = fns["plain"]()
        got = fns["v2"]()
        record["holds"][f"{label} v2"] = hold_front_end(
            f"{label} v2", got, want, rtol, exact=True)
        if with_v1:
            v1 = fns["v1"]()
            record["holds"][f"{label} v1"] = hold_front_end(
                f"{label} v1", v1, want, rtol)
            record["v2_vs_v1"][label] = hold_front_end(
                f"{label} v2 against v1", got, v1, rtol, exact=True)

    cfe.reset_launches()
    for name, b in blocks.items():
        rtol = FE_RTOL[b[0].dtype]
        if len(b) == 5:
            for position in ("classic", "centred"):
                for transform in ("energy", "abs", "env", "env_squared"):
                    hold(f"FE1 {name} {position} {transform}",
                         stalta(b, position, transform), rtol,
                         v1_takes(b, 1))
        for nsmooth, taper in ((1, 0), (5, 20), (12, taper_pad)):
            hold(f"FE2 {name} nsmooth {nsmooth} taper {taper}",
                 kurtosis(b, nsmooth, taper), rtol,
                 v1_takes(kurtosis_inputs(b), 4))

    card, _ = cfe.fused_onsets_cuda_v2(*blocks["archive"], "classic",
                                       "energy", 0.4)
    cpu, _ = sw.fused_onsets(*(torch.from_numpy(a) for a in archive),
                             "classic", "energy", 0.4)
    record["fe1_card_vs_cpu"] = float(
        ((card.cpu().double() - cpu.double()).abs() / cpu.double().abs())
        .max())
    check(record["fe1_card_vs_cpu"] <= FRONT_END_RTOL,
          f"front_end: FE1 v2 on the card against the plain version on the "
          f"CPU {record['fe1_card_vs_cpu']}")

    for name, b in blocks.items():
        kinds = (("kurtosis",) if len(b) == 4 else ("stalta", "kurtosis"))
        for kind in kinds:
            inputs = b if kind == "stalta" else kurtosis_inputs(b)
            fns = (stalta(b) if kind == "stalta"
                   else kurtosis(b, kurt_settings[0]))
            if not v1_takes(inputs, 1 if kind == "stalta" else 4):
                del fns["v1"]
            n = reps if b[0].shape[-1] <= FE_DAY_SAMPLES else reps // 2
            turns = in_turns(fns, n)
            queued = in_turns({k: f for k, f in fns.items() if k != "plain"},
                              n, queued=True)
            entry = {"turns_ms": turns, "queued_turns_ms": queued,
                     **{f"{k}_ms" if k != "v2" else "ms":
                        float(np.mean(turns[k])) for k in fns},
                     **{f"{k}_queued_ms" if k != "v2" else "queued_ms":
                        float(np.mean(queued[k])) for k in queued},
                     **front_end_bound(kind, inputs, kurt_settings[0])}
            for k in ("v2", "v1"):
                if k in fns:
                    dev = front_end_device_ms(fns[k], n)
                    entry["device_ms" if k == "v2" else "v1_device_ms"] = (
                        dev["kernel"])
                    if k == "v2":
                        entry["memset_ms"] = dev["memset"]
                    entry["enqueue_s" if k == "v2" else "v1_enqueue_s"] = (
                        enqueue_s(fns[k], n))
            record["times"][f"{kind} {name}"] = entry
            print(f"front_end {'FE1' if kind == 'stalta' else 'FE2'} {name} "
                  f"{record['shapes'][name]}: v2 {entry['ms']:.4f} ms "
                  f"(queued {entry['queued_ms']:.4f}; device "
                  f"{entry['device_ms']}, memset "
                  f"{entry['memset_ms']}; enqueue "
                  f"{entry['enqueue_s'] * 1e3:.4f} ms); v1 "
                  f"{entry.get('v1_ms')} (queued "
                  f"{entry.get('v1_queued_ms')}; device "
                  f"{entry.get('v1_device_ms')}; enqueue "
                  f"{entry.get('v1_enqueue_s', float('nan')) * 1e3:.4f} ms); "
                  f"plain "
                  f"{entry['plain_ms']:.4f}; bound {entry['bound_ms']:.6f} "
                  f"by {entry['bound_by']}, {entry['bytes']} bytes, "
                  f"{entry['operations']} operations")
    record["v1_launches"] = {k: cfe.launches[k] for k in (
        "front_end_stalta", "front_end_kurtosis")}
    record["resources"] = front_end_resources(device)
    for version in ("v2", "v1"):
        for key in ("FE1", "FE2"):
            chosen = [r for label, r in record["holds"].items()
                      if label.startswith(key) and label.endswith(
                          f" {version}")]
            record.setdefault("max_abs_err", {})[f"{key} {version}"] = max(
                r["max_abs_err"] for r in chosen)
            record.setdefault("bit_equal_min", {})[f"{key} {version}"] = min(
                r["bit_equal"] for r in chosen)
    record["phase_s"] = time.perf_counter() - t_phase
    print(f"front_end: {len(record['holds'])} holds against the plain "
          f"versions and {len(record['v2_vs_v1'])} of v2 against v1, the "
          f"least bit-equal "
          f"shares {record['bit_equal_min']}, the largest differences "
          f"{record['max_abs_err']}; FE1 v2 card against CPU "
          f"{record['fe1_card_vs_cpu']:.2e}; v1 launches "
          f"{record['v1_launches']}; phase {record['phase_s']:.1f} s")
    return record


# locate_onsets_path: the Icequake example's stations (archive_locate's
# 13) and VT's 12; rows of 120,000 samples (as front_end_path's) and a
# row shorter than every window
ICEQUAKE_STATIONS = 13
VT_STATIONS = 12
ONSET_SHORT_SAMPLES = 40


def onset_rows(rng, shape, dtype, device):
    """Rows of seeded noise with an arrival 40 times louder in the middle
    (a tenth of the row, at least 3 samples), on ``device``."""

    rows = rng.standard_normal(shape, dtype=np.dtype(str(dtype)[6:]))
    t = shape[-1]
    start, end = t // 2, t // 2 + max(t // 10, 3)
    rows[..., start:end] *= 40.0
    return torch.from_numpy(rows).to(dtype).to(device)


def station_offsets(stations, per_station):
    """Offsets of ``stations`` stations of ``per_station`` rows each."""

    return [s * per_station for s in range(stations + 1)]


def onset_bound(kurtosis, rows, units, t, itemsize, nsmooth=1,
                transform=None, stations=False):
    """ON1's (``kurtosis`` False) or ON2's bound on a call: the rows read
    once and the onsets written once (``units`` rows of ``t`` samples) at
    the memory rate, against the operations a sample of a row needs (ON1:
    the transform's square or magnitude (none for ``transform`` None, the
    rows mode's), the running sum's addition, two differences,
    the division and the multiplication of the ratio; ON2: three products
    for the powers, four additions, four differences, four divisions, the
    moments' 13 and the gate's product, the gradient, the smoothing's two
    a sample of the box where nsmooth > 1 and 1 + cf), in stations mode
    two more (the square, the addition) and three a combined sample (the
    division, the root, the clamp), at the card's rate for the dtype;
    compares and selects not counted. Returns {"bound_ms", "bound_by",
    "bytes", "operations"}."""

    nbytes = (rows + units) * t * itemsize
    if kurtosis:
        per = 35 + (2 * nsmooth if nsmooth > 1 else 0)
    else:
        per = 5 + (transform in ("energy", "abs", "env_squared"))
    ops = rows * t * per + ((rows * t * 2 + units * t * 3) if stations
                            else 0)
    bound_ms, bound_by = roofline(
        nbytes, ops, FP64_FLOP_PER_S if itemsize == 8 else FP32_FLOP_PER_S)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "operations": ops}


def hold_onset(holds, label, got, want):
    """A kernel's onsets ``got`` against its plain version's ``want`` on
    the card: fails unless equal bit for bit."""

    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    diff = float((got.double() - want.double()).abs().max())
    holds[label] = {"equal": equal, "max_abs_err": diff,
                    "shape": list(got.shape), "dtype": str(got.dtype)}
    check(equal, f"locate_onsets {label}: {diff} from its plain version")


def kernels_per_call(fn, reps=5):
    """torch.profiler's device work of ``fn()``, a call over ``reps``
    calls after a warm-up call: kernels and copies (Memcpy, Memset)
    launched, and the kernels' device ms."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in device if e.name.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in device if e not in copies]
    return {"kernels": len(kernels) / reps, "copies": len(copies) / reps,
            "kernel_ms": sum(e.time_range.elapsed_us()
                             for e in kernels) / reps / 1e3}


def onset_turns(label, kernel, plain, bound, reps=20, v1=None):
    """ON1 v2's or ON2 v2's call ``kernel``, ON1's or ON2's ``v1`` (where
    given) and their plain chain ``plain`` on the same inputs, timed in
    turns (v2, v1, plain, plain, v1, v2): each kernel's device time
    enqueued behind a hold (``queued_ms``: its calls back to back) and as
    the host issues its calls (``cuda_ms``), the plain chain's as the host
    issues it (its hundreds of launches a call fill the launch queue
    behind a hold, and the chain is bound by their issue); v2's launches a
    call by its wrapper's count, the plain chain's kernels and copies a
    call by the profiler (which drops events at times: a floor), and the
    host's enqueue of each. Returns a record (``ms``, ``issued_ms``,
    ``enqueue_s``: v2's; ``v1_*``: v1's)."""

    from quakemigrate_torch.experiments.exp_kernel_breakdown import (
        cuda_ms,
        queued_ms,
    )
    from quakemigrate_torch.ops import cuda_onsets as con

    calls = {"kernel": kernel, "v1": v1}
    order = ["kernel", "v1", "plain", "plain", "v1", "kernel"]
    turns = {"kernel": [], "kernel_issued": [], "v1": [], "v1_issued": [],
             "plain": []}
    for name in order:
        if name == "plain":
            turns["plain"].append(cuda_ms(plain, reps))
        elif calls[name] is not None:
            turns[name].append(queued_ms(calls[name], reps))
            turns[f"{name}_issued"].append(cuda_ms(calls[name], reps))
    before = sum(con.launches.values())
    enqueue = enqueue_s(kernel, reps)
    record = {"ms": float(np.mean(turns["kernel"])),
              "issued_ms": float(np.mean(turns["kernel_issued"])),
              "plain_ms": float(np.mean(turns["plain"])),
              "turns_ms": turns, **bound,
              "launches_a_call": (sum(con.launches.values()) - before) / reps,
              "plain_calls": kernels_per_call(plain),
              "enqueue_s": enqueue,
              "plain_enqueue_s": enqueue_s(plain, reps)}
    if v1 is not None:
        record.update({"v1_ms": float(np.mean(turns["v1"])),
                       "v1_issued_ms": float(np.mean(turns["v1_issued"])),
                       "v1_enqueue_s": enqueue_s(v1, reps)})
    v1_text = (f"; v1 {record['v1_ms']:.4f} queued {turns['v1']}, "
               f"{record['v1_issued_ms']:.4f} as issued, enqueue "
               f"{record['v1_enqueue_s'] * 1e3:.4f} ms" if v1 is not None
               else "")
    print(f"locate_onsets {label}: v2 {record['ms']:.4f} ms a call queued "
          f"in turns {turns['kernel']}, {record['issued_ms']:.4f} as "
          f"issued{v1_text}; plain chain {record['plain_ms']:.4f} as issued "
          f"{turns['plain']}; bound {bound['bound_ms']:.6f} ms by "
          f"{bound['bound_by']}; {record['launches_a_call']} launch a call "
          f"against the plain chain's {record['plain_calls']}; host "
          f"enqueue {record['enqueue_s'] * 1e3:.4f} ms against "
          f"{record['plain_enqueue_s'] * 1e3:.4f}")
    return record


def onset_resources(device):
    """Registers and spills of ON1, ON2, ON1 v2 and ON2 v2 (each instance,
    from the build's ptxas report) and their resident blocks per SM (the
    occupancy API; v2's at its long rows' shared memory): {"ON1 f32":
    {...}, ..., "ON1 v2 f32": {...}, ...}. Fails where a v2 instance
    spills."""

    from quakemigrate_torch import _build
    from quakemigrate_torch.ops import cuda_onsets as con

    out = {}
    for prefix, version in (("qm_on", 1), ("qm_ov", 2)):
        for name, entry in _build.kernel_resources(prefix).items():
            kurtosis = f"{prefix}2" in name
            f64 = "IdE" in name
            dtype = torch.float64 if f64 else torch.float32
            label = (f"ON{2 if kurtosis else 1}"
                     f"{' v2' if version == 2 else ''} "
                     f"{'f64' if f64 else 'f32'}")
            out[label] = {k: v for k, v in entry.items()
                          if k != "wgmma_serialized"}
            out[label]["blocks_per_sm"] = con.blocks_per_sm(
                kurtosis, dtype, device, version)
    print(f"locate_onsets: registers, spills and blocks per SM {out}")
    check(len(out) == 8, f"locate_onsets: instances missing: {out}")
    # a spilling build of ON2 v2 float64 gave wrong onsets on the card
    check(all(v["spill_stores"] == 0 and v["spill_loads"] == 0
              for k, v in out.items() if " v2 " in k),
          f"locate_onsets: a v2 instance spills: {out}")
    return out


def onsets_case(label, onset, data, device, reps=5):
    """calculate_onsets of ``onset`` (STALTAOnset or KurtosisOnset) on an
    event's waveform ``data`` on the card: by its kernel's route (one
    launch a phase) and with each phase's entry sent to the plain chain on
    the card, held equal bit for bit; the call's host wall (it ends in
    the copy back) and the profiler's device work a call for both routes;
    then each phase's entry alone, kernel against plain chain, in turns
    (:func:`onset_turns`, ON1 v2 or ON2 v2 with ON1 or ON2). Returns a
    record."""

    from quakemigrate_torch.ops import cuda_onsets as con
    from quakemigrate_torch.ops import kurtosis as kops
    from quakemigrate_torch.ops import stalta as sops
    from quakemigrate_torch.signal.onsets import kurtosis as onsets_kurtosis

    if hasattr(onset, "kurtosis_windows"):
        module, name = onsets_kurtosis, "station_kurtosis_onset"
        plain = kops.station_kurtosis_onset_plain
        v1 = con.station_kurtosis_onset_cuda
    else:
        module, name = sops, "station_sta_lta"
        plain = sops.station_sta_lta_plain
        v1 = con.station_sta_lta_cuda
    entry = getattr(module, name)
    phases = []

    def capture(*args, **kwargs):
        phases.append(args)
        return entry(*args, **kwargs)

    def kernel_route():
        return onset.calculate_onsets(data, device=device)[0]

    def plain_route():
        setattr(module, name, plain)
        try:
            return onset.calculate_onsets(data, device=device)[0]
        finally:
            setattr(module, name, entry)

    setattr(module, name, capture)
    try:
        got = kernel_route()
    finally:
        setattr(module, name, entry)
    want = plain_route()
    equal = bool(torch.equal(got, want))
    check(equal, f"{label} calculate_onsets: the kernel's route differs "
          "from the plain chain's")

    def wall(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    record = {"equal_to_plain": equal, "onsets": list(got.shape),
              "wall_s": wall(kernel_route), "plain_wall_s": wall(plain_route),
              "device": kernels_per_call(kernel_route, reps),
              "plain_device": kernels_per_call(plain_route, reps),
              "phases": {}}
    kurtosis = module is onsets_kurtosis
    for args in phases:
        traces, offsets = args[0], args[1]
        key = f"{len(offsets) - 1} stations, {traces.shape[0]} rows"
        bound = onset_bound(kurtosis, traces.shape[0], len(offsets) - 1,
                            traces.shape[1], traces.element_size(),
                            nsmooth=args[3] if kurtosis else 1,
                            transform="energy" if kurtosis else args[5],
                            stations=True)
        record["phases"][key] = onset_turns(
            f"{label} calculate_onsets' phase of {key}",
            lambda: entry(*args), lambda: plain(*args), bound,
            v1=lambda: v1(*args))
    print(f"{label}: calculate_onsets on the card, {record['onsets']} "
          f"onsets: kernel's route {record['wall_s']:.4f} s host wall, "
          f"device {record['device']}; plain chain "
          f"{record['plain_wall_s']:.4f} s, device "
          f"{record['plain_device']}; equal bit for bit {equal} "
          f"({nvidia_smi()})")
    return record


def locate_onsets_path(device, locate_samples, vt_samples, reps=20):
    """locate_onsets_path: ON1 v2 and ON2 v2 (csrc/locate_onsets_v2.cu,
    through the routed ops functions) and ON1 and ON2
    (csrc/locate_onsets.cu, their yardstick, through their wrappers) on
    the card against their plain versions (the reference's order of
    additions) bit for bit, each at every hold, at the shapes of their
    paths: locate at Icequake (13 stations, P one row a station and S two,
    the locate block's ``locate_samples`` samples, float64;
    archive_locate's STA/LTA windows and kurtosis_detect's), VT (12
    stations, ``vt_samples``, env_squared), core.compat's float32 rows
    (R1's cases: (26, 2,038), (256, 360,000)), rows of 120,000 samples in
    float32 and float64 and rows shorter than every window: ON1 classic and
    centred, the energy, abs, env and env_squared transforms in stations
    mode, rows mode on the samples as they are; ON2 at nsmooth 1, 5 and the
    onset's 12, both modes, float64 and float32. Then v2, v1 and the plain
    chain timed in turns (:func:`onset_turns`) at locate's S phase,
    compat's rows and 120,000 samples in both types, and the four kernels'
    registers, spills and blocks per SM. Returns a record."""

    from quakemigrate_torch import util
    from quakemigrate_torch.ops import cuda_onsets as con
    from quakemigrate_torch.ops import kurtosis as kops
    from quakemigrate_torch.ops import stalta as sops

    rng = np.random.default_rng(2060)
    f32, f64 = torch.float32, torch.float64
    stw = {p: util.time2sample(w[0], RATE) + 1 for p, w in STA_LTA.items()}
    ltw = {p: util.time2sample(w[1], RATE) + 1 for p, w in STA_LTA.items()}
    k_onset = kurtosis_onset_for()
    nkurt = {p: k_onset._nkurt(p) for p in ("P", "S")}
    nsmooth = k_onset.nsmooth
    per_station = {"P": 1, "S": 2}
    plain_rows = {"classic": sops.overlapping_sta_lta_plain,
                  "centred": sops.centred_sta_lta_plain}
    routed_rows = {"classic": sops.overlapping_sta_lta,
                   "centred": sops.centred_sta_lta}
    holds = {}
    torch.cuda.synchronize()
    con.reset_launches()

    def hold_both(label, want, v2, v1):
        """v2 (the routed function) and v1 (its wrapper) against the plain
        version's ``want``."""

        hold_onset(holds, f"ON{label[0]} v2 {label[1:]}", v2(), want)
        hold_onset(holds, f"ON{label[0]} v1 {label[1:]}", v1(), want)

    def on1_stations(label, x, offsets, nsta, nlta, positions, transforms,
                     edges=None):
        for position in positions:
            for transform in transforms:
                args = (x, offsets, nsta, nlta, position, transform, edges,
                        0.4)
                hold_both(f"1{label} {position} {transform}",
                          sops.station_sta_lta_plain(*args),
                          lambda: sops.station_sta_lta(*args),
                          lambda: con.station_sta_lta_cuda(*args))

    def on1_rows(label, x, nsta, nlta):
        for position in ("classic", "centred"):
            hold_both(f"1rows {label} {position}",
                      plain_rows[position](x, nsta, nlta),
                      lambda: routed_rows[position](x, nsta, nlta),
                      lambda: con.sta_lta_cuda(x, nsta, nlta, position))

    def on2(label, x, offsets, n, smooths, edges=None):
        for ns in smooths:
            if offsets is None:
                hold_both(f"2rows {label} nsmooth {ns}",
                          kops.kurtosis_onset_plain(x, n, ns),
                          lambda: kops.kurtosis_onset(x, n, ns),
                          lambda: con.kurtosis_onset_cuda(x, n, ns))
            else:
                args = (x, offsets, n, ns, edges, 0.4)
                hold_both(f"2{label} nsmooth {ns}",
                          kops.station_kurtosis_onset_plain(*args),
                          lambda: kops.station_kurtosis_onset(*args),
                          lambda: con.station_kurtosis_onset_cuda(*args))

    transforms = ("energy", "abs", "env", "env_squared")
    ice = {}
    for phase in ("P", "S"):
        rows = ICEQUAKE_STATIONS * per_station[phase]
        offsets = station_offsets(ICEQUAKE_STATIONS, per_station[phase])
        x = onset_rows(rng, (rows, locate_samples), f64, device)
        ice[phase] = (x, offsets)
        on1_stations(f"icequake {phase}", x, offsets, stw[phase],
                     ltw[phase], ("classic", "centred"), transforms)
        on2(f"icequake {phase}", x, offsets, nkurt[phase],
            (1, 5, nsmooth))
    x, offsets = ice["S"]
    on1_stations("icequake S edges", x, offsets, stw["S"], ltw["S"],
                 ("centred",), ("energy",), (40, locate_samples - 30))
    on2("icequake S edges", x, offsets, nkurt["S"], (nsmooth,),
        (nkurt["S"] + 20, locate_samples - 1))
    on1_rows("icequake S f64", x, stw["S"], ltw["S"])
    on2("icequake S f64", x, None, nkurt["S"], (1, 5, nsmooth))
    x32 = x.float()
    on1_stations("icequake S f32", x32, offsets, stw["S"], ltw["S"],
                 ("classic", "centred"), ("energy",))
    on2("icequake S f32", x32, offsets, nkurt["S"], (5, nsmooth))
    on2("icequake S f32", x32, None, nkurt["S"], (1, 5, nsmooth))
    vt = onset_rows(rng, (2 * VT_STATIONS, vt_samples), f64, device)
    vt_stw, vt_ltw = 11, 51  # vt_locate_mags' [0.2, 1.0] s at 50 Hz
    on1_stations("vt S", vt, station_offsets(VT_STATIONS, 2), vt_stw,
                 vt_ltw, ("classic", "centred"), ("env_squared",))
    compat_rows = {shape: onset_rows(rng, shape, f32, device) ** 2
                   for shape, _ in R1_CASES}
    for shape, (nsta, nlta) in R1_CASES:
        on1_rows(f"compat {shape}", compat_rows[shape], nsta, nlta)
    longs = {}
    for dtype in (f32, f64):
        long = onset_rows(rng, (3, FE_LONG_SAMPLES), dtype, device)
        longs[dtype] = long
        name = f"{FE_LONG_SAMPLES} {str(dtype)[6:]}"
        on1_stations(name, long, [0, 1, 3], 250, 2500,
                     ("classic", "centred"), ("energy", "abs"))
        on1_rows(name, long ** 2, 250, 2500)
        on2(name, long, [0, 1, 3], 250, (nsmooth,))
        on2(name, long, None, 250, (5,))
        short = onset_rows(rng, (3, ONSET_SHORT_SAMPLES), dtype, device)
        name = f"{ONSET_SHORT_SAMPLES} {str(dtype)[6:]}"
        on1_stations(name, short, [0, 1, 3], stw["S"], ltw["S"],
                     ("classic", "centred"), ("energy",))
        on1_rows(name, short ** 2, stw["S"], ltw["S"])
        on2(name, short, [0, 1, 3], nkurt["S"], (nsmooth,))
        on2(name, short, None, nkurt["S"], (1, 6))
    torch.cuda.synchronize()
    hold_launches = dict(con.launches)
    print(f"locate_onsets: {len(holds)} holds, each equal bit for bit to "
          f"its plain version; launches {hold_launches}")
    check(hold_launches["onset_stalta_v2"] == hold_launches["onset_stalta"]
          and hold_launches["onset_kurtosis_v2"]
          == hold_launches["onset_kurtosis"],
          f"locate_onsets: v2 and v1 launches differ: {hold_launches}")

    # v2, v1 and the plain chain timed in turns
    times = {}
    x, offsets = ice["S"]
    args = (x, offsets, stw["S"], ltw["S"], "centred", "energy", None, 0.4)
    times["ON1 locate S"] = onset_turns(
        "ON1 locate S", lambda: sops.station_sta_lta(*args),
        lambda: sops.station_sta_lta_plain(*args),
        onset_bound(False, x.shape[0], len(offsets) - 1, locate_samples, 8,
                    transform="energy", stations=True), reps,
        v1=lambda: con.station_sta_lta_cuda(*args))
    kargs = (x, offsets, nkurt["S"], nsmooth, None, 0.4)
    times["ON2 locate S"] = onset_turns(
        "ON2 locate S", lambda: kops.station_kurtosis_onset(*kargs),
        lambda: kops.station_kurtosis_onset_plain(*kargs),
        onset_bound(True, x.shape[0], len(offsets) - 1, locate_samples, 8,
                    nsmooth=nsmooth, stations=True), reps,
        v1=lambda: con.station_kurtosis_onset_cuda(*kargs))
    for shape, (nsta, nlta) in R1_CASES:
        rows = compat_rows[shape]
        times[f"ON1 compat {shape}"] = onset_turns(
            f"ON1 compat {shape}",
            lambda: sops.overlapping_sta_lta(rows, nsta, nlta),
            lambda: sops.overlapping_sta_lta_plain(rows, nsta, nlta),
            onset_bound(False, shape[0], shape[0], shape[1], 4),
            reps if shape[1] < 10_000 else 5,
            v1=lambda: con.sta_lta_cuda(rows, nsta, nlta, "classic"))
    for dtype, long in longs.items():
        name = f"{FE_LONG_SAMPLES} {str(dtype)[6:]}"
        size = long.element_size()
        largs = (long, [0, 1, 3], 250, 2500, "classic", "energy", None, 0.4)
        times[f"ON1 {name}"] = onset_turns(
            f"ON1 {name}", lambda: sops.station_sta_lta(*largs),
            lambda: sops.station_sta_lta_plain(*largs),
            onset_bound(False, 3, 2, FE_LONG_SAMPLES, size,
                        transform="energy", stations=True), 5,
            v1=lambda: con.station_sta_lta_cuda(*largs))
        times[f"ON2 {name}"] = onset_turns(
            f"ON2 {name}",
            lambda: kops.kurtosis_onset(long, 250, nsmooth),
            lambda: kops.kurtosis_onset_plain(long, 250, nsmooth),
            onset_bound(True, 3, 3, FE_LONG_SAMPLES, size, nsmooth=nsmooth),
            5, v1=lambda: con.kurtosis_onset_cuda(long, 250, nsmooth))
    del long, longs, rows, compat_rows, ice, vt
    torch.cuda.empty_cache()
    return {"holds": holds, "hold_launches": hold_launches, "times": times,
            "resources": onset_resources(device),
            "windows": {"stw": stw, "ltw": ltw, "nkurt": nkurt,
                        "nsmooth": nsmooth},
            "samples": {"locate": locate_samples, "vt": vt_samples}}


def rel_err(got, ref):
    """Largest |got - ref| / |ref| (float64, on the host)."""

    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(got - ref)
                        / np.maximum(np.abs(ref), np.finfo(np.float64).tiny)))


def recursive_stalta_path(device):
    """recursive_stalta: R1 (csrc/recursive_stalta.cu) on its paths and
    against its plain version. The main path first, with the counts at 0:
    compat.recursive_sta_lta (numpy in and out, the card by default) and
    ops.recursive_sta_lta on a CUDA tensor, at (26, 2038) with (nsta, nlta)
    (20, 200): one launch each, each within twice the float32 plain
    version's error of the float64 plain version. Then at each of R1_CASES
    in float32 and float64: float64 within R1_F64_RTOL of the plain version
    on the card, float32 no further from the float64 plain version than
    twice the float32 plain version; R1 and the plain version timed with
    CUDA events; the bound the bytes read once and written once (the
    operations, 8 a sample, bound it far less). Returns the record."""

    from quakemigrate_torch.core import compat
    from quakemigrate_torch.ops import cuda_stalta
    from quakemigrate_torch.ops.stalta import (
        recursive_sta_lta,
        recursive_sta_lta_plain,
    )

    rng = np.random.default_rng(2050)
    (shape, (nsta, nlta)) = R1_CASES[0]
    signal = rng.standard_normal(shape) ** 2
    x = torch.from_numpy(signal).to(device)
    ref = recursive_sta_lta_plain(x, nsta, nlta).cpu().numpy()
    plain_err = rel_err(recursive_sta_lta_plain(x.float(), nsta, nlta).cpu(),
                        ref)
    torch.cuda.synchronize()
    cuda_stalta.reset_launches()
    by_compat = compat.recursive_sta_lta(signal, nsta, nlta)
    by_ops = recursive_sta_lta(x.float(), nsta, nlta).cpu().numpy()
    torch.cuda.synchronize()
    launches = cuda_stalta.launches["recursive_stalta"]
    path_err = max(rel_err(by_compat, ref), rel_err(by_ops, ref))
    print(f"recursive_stalta: main path (compat and ops at {shape}, "
          f"{nsta}/{nlta}): {launches} R1 launches; error vs float64 "
          f"{path_err:.3e} (float32 plain {plain_err:.3e})")
    check(launches == 2, f"recursive_stalta: {launches} launches, not 2")
    check(path_err <= max(2 * plain_err, np.finfo(np.float32).eps),
          f"recursive_stalta: main path error {path_err} against the "
          f"plain version's {plain_err}")

    cases = []
    for shape, (nsta, nlta) in R1_CASES:
        x64 = torch.from_numpy(rng.standard_normal(shape) ** 2).to(device)
        ref = recursive_sta_lta_plain(x64, nsta, nlta)
        for x in (x64.float(), x64):
            itemsize = x.element_size()
            got = cuda_stalta.recursive_sta_lta_cuda(x, nsta, nlta)
            plain = recursive_sta_lta_plain(x, nsta, nlta)
            torch.cuda.synchronize()
            err = rel_err(got.cpu(), ref.cpu())
            plain_err = rel_err(plain.cpu(), ref.cpu())
            abs_err = float((got - plain).abs().max())
            if itemsize == 8:
                ok = err <= R1_F64_RTOL
            else:
                ok = err <= max(2 * plain_err, np.finfo(np.float32).eps)
            del got, plain
            big = x.numel() > 10**7
            ms = median_ms(lambda: cuda_stalta.recursive_sta_lta_cuda(
                x, nsta, nlta), reps=5 if big else 50)
            plain_ms = cuda_ms(lambda: recursive_sta_lta_plain(
                x, nsta, nlta), reps=2 if big else 10, warmup=1)
            bound_ms, bound_by = roofline(
                2 * x.numel() * itemsize, 8 * x.numel(),
                FP64_FLOP_PER_S if itemsize == 8 else FP32_FLOP_PER_S)
            case = {"shape": list(shape), "nsta": nsta, "nlta": nlta,
                    "dtype": str(x.dtype).replace("torch.", ""),
                    "max_rel_err_vs_f64": err,
                    "plain_max_rel_err_vs_f64": plain_err,
                    "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_share": bound_ms / ms}
            cases.append(case)
            print(f"recursive_stalta {shape} {case['dtype']} "
                  f"({nsta}/{nlta}): R1 {ms:.4f} ms, plain {plain_ms:.3f} "
                  f"ms, bound {bound_ms:.4f} ms ({bound_by}, "
                  f"{100 * bound_ms / ms:.1f} %); error vs float64 plain "
                  f"{err:.3e} (plain {plain_err:.3e}), |R1 - plain| "
                  f"{abs_err:.3e}")
            check(ok, f"recursive_stalta {shape} {case['dtype']}: error "
                  f"{err} (plain {plain_err})")
        del x64, ref
        torch.cuda.empty_cache()
    return {"launches": launches, "main_path_err": path_err,
            "cases": cases}


def compat_path(device):
    """compat_path: core.compat's migrate and find_max_coa on the card (the
    default device) against device="cpu", at each of COMPAT_CASES: the
    route detect_route takes for the clipped traveltimes; migrate's map
    within MAP_RTOL relative of the CPU's, with one launch of the map
    kernel on K1 v2's route (M2 v2, csrc/migrate_map_persistent.cu, and
    one of its tables' kernel) or of M2 ring on K2 v2's
    (csrc/migrate_marginalise_ring.cu) and no other kernel; then
    find_max_coa of that map on the card and the CPU: the max and the
    argmax equal, the normalised max within COMPAT_NORM_RTOL; last
    overlapping_sta_lta and centred_sta_lta on the card at R1's first case
    (float32 rows of 2,038 samples): one ON1 v2 launch each
    (csrc/locate_onsets_v2.cu), equal to device="cpu". Returns the
    record."""

    from quakemigrate_torch.core import compat
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops import cuda_onsets as con
    from quakemigrate_torch.signal.scan import detect_route

    rng = np.random.default_rng(2051)
    record = {}
    for name, (grid, n_onsets, t_len, first, last, max_tt) in (
            COMPAT_CASES.items()):
        onsets = rng.uniform(0.3, 4.0, (n_onsets, t_len))
        tt = rng.integers(0, max_tt, grid + (n_onsets,))
        route = detect_route(
            np.clip(tt.reshape(-1, n_onsets), 0, last).astype(np.int32),
            grid, device)[0]
        # on K1 v2's route M2 v2 and, at the detector's first map, its
        # tables' kernel
        kernels = ({"migrate_map_persistent": 1,
                    "migrate_map_persistent_tables": 1} if route == "k1_v2"
                   else {"migrate_map_ring": 1})
        torch.cuda.synchronize()
        cm.reset_launches()
        t0 = time.perf_counter()
        card = compat.migrate(onsets, tt, first, last, n_onsets)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in cm.launches.items() if v}
        cpu = compat.migrate(onsets, tt, first, last, n_onsets,
                             device="cpu")
        err = rel_err(card, cpu)
        fm_card = compat.find_max_coa(card)
        fm_cpu = compat.find_max_coa(card, device="cpu")
        norm_err = rel_err(fm_card[1], fm_cpu[1])
        record[name] = {
            "grid": list(grid), "onsets": n_onsets,
            "nsamples": t_len - first - last, "route": route,
            "launches": launches, "wall_s": wall, "max_rel_err": err,
            "max_abs_err": float(np.abs(card - cpu).max()),
            "find_max_coa": {
                "max_equal": bool(np.array_equal(fm_card[0], fm_cpu[0])),
                "argmax_equal": bool(np.array_equal(fm_card[2], fm_cpu[2])),
                "norm_rel_err": norm_err}}
        print(f"compat_path {name}: grid {grid}, {n_onsets} onsets, "
              f"{t_len - first - last} samples; route {route}, launches "
              f"{launches}, {wall:.3f} s wall; map vs CPU {err:.3e}; "
              f"find_max_coa {record[name]['find_max_coa']}")
        check(card.shape == grid + (t_len - first - last,)
              and card.dtype == np.float64 and np.isfinite(card).all(),
              f"compat_path {name}: map {card.shape} {card.dtype}")
        check(route == name and launches == kernels,
              f"compat_path {name}: route {route}, launches {launches}")
        check(err <= MAP_RTOL, f"compat_path {name}: map error {err}")
        check(record[name]["find_max_coa"]["max_equal"]
              and record[name]["find_max_coa"]["argmax_equal"]
              and norm_err <= COMPAT_NORM_RTOL,
              f"compat_path {name}: find_max_coa {record[name]}")

    # The static STA/LTAs on the card (ON1 v2, one launch each, counted
    # from 0) against device="cpu" (the plain version), equal
    (shape, (nsta, nlta)) = R1_CASES[0]
    signal = rng.standard_normal(shape) ** 2
    for name in ("overlapping_sta_lta", "centred_sta_lta"):
        torch.cuda.synchronize()
        con.reset_launches()
        card = getattr(compat, name)(signal, nsta, nlta)
        launches = dict(con.launches)
        cpu = getattr(compat, name)(signal, nsta, nlta, device="cpu")
        equal = bool(np.array_equal(card, cpu))
        record[name] = {"shape": list(shape), "launches": launches,
                        "equal_to_cpu": equal,
                        "max_abs_err": float(np.abs(card - cpu).max())}
        print(f"compat_path {name} {shape} (nsta {nsta}, nlta {nlta}): "
              f"launches {launches}, equal to device='cpu' {equal}")
        check(equal and card.dtype == np.float64
              and launches == onsets_only("onset_stalta_v2", 1),
              f"compat_path {name}: {record[name]}")
    return record


def format_detect_path(device, root, lut, stations, origin):
    """format_detect: archive_detect's archive (under ``root``) cut to
    FORMAT_CUT_S seconds each side of the planted ``origin`` and written
    by the port's writers as MSEED (STEIM2), SAC, GSE2 and SEG-Y; each
    read back by the port's reader, its samples, ids, start and rate equal
    to the MSEED cut's; then QuakeScan.detect on the card over
    FORMAT_SPAN_S seconds about the origin from each (route k1_v2, K1 v2
    once a window and nothing else), each .scanmseed equal to the MSEED
    run's byte for byte. Returns the record."""

    from quakemigrate_torch.io import Archive
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.seis import read
    from quakemigrate_torch.signal.scan import QuakeScan

    files = sorted((root / "mSEED").rglob("*.m"))
    cut = {}
    for path in files:
        st = read(path, starttime=origin - FORMAT_CUT_S,
                  endtime=origin + FORMAT_CUT_S)
        cut[path.relative_to(root / "mSEED")] = st
    start = origin - FORMAT_SPAN_S / 2
    end = start + FORMAT_SPAN_S
    record, scanmseed = {}, {}
    for fmt in ("MSEED", "SAC", "GSE2", "SEGY"):
        archive_path = root / f"format_{fmt}"
        t0 = time.perf_counter()
        for rel, st in cut.items():
            (archive_path / rel).parent.mkdir(parents=True, exist_ok=True)
            options = {"encoding": "STEIM2"} if fmt == "MSEED" else {}
            st.write(str(archive_path / rel), format=fmt, **options)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = {rel: read(archive_path / rel) for rel in cut}
        read_s = time.perf_counter() - t0
        # SAC holds delta in float32, read as it is, as the JAX package
        # reads it: 250 Hz comes back as 1 / float32(0.004)
        rate = 1.0 / float(np.float32(1.0 / RATE)) if fmt == "SAC" else RATE
        for rel, st in cut.items():
            (got,), (want,) = back[rel].traces, st.traces
            # GSE2 holds no network code
            check((got.stats.station, got.stats.channel)
                  == (want.stats.station, want.stats.channel)
                  and got.stats.starttime == want.stats.starttime
                  and want.stats.sampling_rate == RATE
                  and got.stats.sampling_rate == rate
                  and np.array_equal(np.asarray(got.data, np.int64),
                                     want.data),
                  f"format_detect {fmt}: {rel} read back as {got}")

        def make_scan(label, on):
            return QuakeScan(Archive(archive_path, stations,
                                     archive_format="YEAR/JD/STATION"),
                             lut, archive_onset(), str(root / "runs"),
                             label, device=on, timestep=ARCHIVE_TIMESTEP)

        scan = make_scan(f"format_{fmt}", device)
        torch.cuda.synchronize()
        cm.reset_launches()
        _, wall = quiet(root, f"format_{fmt}", lambda: scan.detect(start,
                                                                   end))
        launches = {k: v for k, v in cm.launches.items() if v}
        scanmseed[fmt] = scanmseed_bytes(scan)
        n_windows = round(FORMAT_SPAN_S / ARCHIVE_TIMESTEP)
        record[fmt] = {"files": len(cut), "write_s": write_s,
                       "read_s": read_s, "detect_s": wall,
                       "rate": rate, "route": scan.detect_scan.route,
                       "launches": launches}
        if fmt == "SAC":
            # The reference's outcome: the scan cannot resample the float32
            # rate to the onset's, so every trace is refused; the card's
            # .scanmseed equals a device="cpu" run's of the same archive
            cpu = make_scan("format_SAC_cpu", "cpu")
            quiet(root, "format_SAC_cpu", lambda: cpu.detect(start, end))
            cells = availability_cells(scan)
            record[fmt].update(
                availability_cells=len(cells),
                availability_zero=bool(cells) and not any(cells),
                scanmseed_equal_cpu=scanmseed[fmt] == scanmseed_bytes(cpu))
            print(f"format_detect SAC: rate {rate!r} Hz; detect over "
                  f"{FORMAT_SPAN_S:.0f} s {wall:.3f} s wall, route "
                  f"{scan.detect_scan.route}, launches {launches}; "
                  f"{len(cells)} availability cells, all 0: "
                  f"{record[fmt]['availability_zero']}; .scanmseed "
                  f"({len(scanmseed[fmt])} bytes) equal to the device=\"cpu\""
                  f" run's: {record[fmt]['scanmseed_equal_cpu']}")
            check(record[fmt]["availability_zero"]
                  and record[fmt]["scanmseed_equal_cpu"],
                  f"format_detect SAC: {record[fmt]}")
            continue
        record[fmt]["scanmseed_equal"] = scanmseed[fmt] == scanmseed["MSEED"]
        print(f"format_detect {fmt}: {len(cut)} files of "
              f"{2 * FORMAT_CUT_S:.0f} s written in {write_s:.3f} s, read "
              f"back equal in {read_s:.3f} s; detect over "
              f"{FORMAT_SPAN_S:.0f} s {wall:.3f} s wall, route "
              f"{scan.detect_scan.route}, launches {launches}; .scanmseed "
              f"({len(scanmseed[fmt])} bytes) equal to the MSEED run's: "
              f"{record[fmt]['scanmseed_equal']}")
        check(scan.detect_scan.route == "k1_v2"
              and launches == {"migrate_detect_v2": n_windows},
              f"format_detect {fmt}: route {scan.detect_scan.route}, "
              f"launches {launches}")
        check(record[fmt]["scanmseed_equal"],
              f"format_detect {fmt}: .scanmseed differs from the MSEED run's")
    return record


# mesh_path: QuakeScan(mesh=...) on one card, the slabs of each mesh in
# turn on it: MESH_SPAN_S seconds of archive_detect's archive about the
# planted origin on a grid mesh of MESH_SLABS slabs and on a 2 x 2
# ("batch", "grid") mesh
MESH_SPAN_S = 10.0
MESH_SLABS = 4


def mesh_path(device, root, lut, stations, origin):
    """mesh_path: QuakeScan(mesh=...) on the card, without jax, on
    archive_detect's archive (under ``root``; 259,008 nodes, 26 onsets,
    250 Hz). The one card stands for every device of the meshes, so each
    mesh's slabs run in turn on it and their partial results are combined
    on it (parallel.combine_slabs): detect over MESH_SPAN_S seconds about
    the planted ``origin`` unsharded, on a grid mesh of MESH_SLABS slabs
    and on a 2 x 2 ("batch", "grid") mesh (two windows a dispatch, two
    slabs a window). Checks: route k1_v2, K1 v2 launched once a slab and
    window and nothing else, no plain version on a CUDA tensor; each
    window's max_coa equal bit for bit to the unsharded run's, max_coa_n
    within MAX_COA_N_RTOL, the argmax equal or tie-consistent (the plain
    coalescence at the mesh's node within MAX_COA_RTOL of the max); the
    .scanmseed's COA equal, COA_N within 1 count, X/Y/Z equal where the
    argmax is. Then the planted event located from a trigger row at its
    origin, unsharded and on the grid mesh: pass 1 on K1 v2 and pass 2 on
    M1 v2, once a slab each, nothing else; the .event's X, Y and Z equal
    to the unsharded run's. Last, one F3 window (f3_path's geometry, the
    "k3" route) through DetectScan on a grid mesh of MESH_SLABS slabs: K3
    v2 once a slab, max and argmax equal bit for bit to the unsharded
    window (K3 v2's first flat index rule holds across slabs). Times, on
    the card: each run's device ms a dispatch; warm, each run's prepared
    windows again through its DetectScan (device ms a window, a 2 x 2
    dispatch halved); and the route's kernel alone, the whole plan
    against the slabs one after another, in turns (:func:`slab_turns`).
    Returns a record."""

    import csv

    from quakemigrate_torch.io import Archive
    from quakemigrate_torch.ops import cuda_front_end as cfe
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.parallel import make_mesh
    from quakemigrate_torch.seis import read
    from quakemigrate_torch.signal.onsets import STALTAOnset
    from quakemigrate_torch.signal.scan import (
        DetectScan,
        QuakeScan,
        detect_route,
    )

    t_phase = time.perf_counter()
    start = origin - MESH_SPAN_S / 2
    end = start + MESH_SPAN_S
    archive = Archive(root / "mSEED", stations,
                      archive_format="YEAR/JD/STATION")
    meshes = {
        "unsharded": (None, 1),
        "grid4": (make_mesh([device] * MESH_SLABS), MESH_SLABS),
        "batch2x2": (make_mesh([device] * 4, axis_names=("batch", "grid"),
                               shape=(2, 2)), 2),
    }
    n_windows = round(MESH_SPAN_S / ARCHIVE_TIMESTEP)
    record, runs = {}, {}
    for label, (mesh, slabs) in meshes.items():
        scan = QuakeScan(archive, lut, archive_onset(), str(root / "runs"),
                         f"mesh_{label}", device=device, mesh=mesh,
                         timestep=ARCHIVE_TIMESTEP)
        seen = {}
        scan.on_window = lambda i, block, result, seen=seen: seen.update(
            {i: (block, result)})
        torch.cuda.synchronize()
        cm.reset_launches()
        cfe.reset_launches()
        with NoPlainOnCuda("mesh_path"):
            _, wall = quiet(root, f"mesh_{label}",
                            lambda: scan.detect(start, end))
        torch.cuda.synchronize()
        launches = {k: v for k, v in cm.launches.items() if v}
        # FE1 once a window and device of the mesh's row: the one card
        # stands for every device, so once a window
        fe_launches = dict(cfe.launches)
        ms = list(scan.detect_scan.window_ms)
        runs[label] = (scan, seen)
        record[label] = {"slabs_a_window": slabs, "wall_s": wall,
                         "launches": launches,
                         "front_end_launches": fe_launches,
                         "dispatch_ms": ms, "dispatches": len(ms)}
        print(f"mesh_path {label}: {mesh}, route {scan.detect_scan.route}, "
              f"{len(seen)} windows in {len(ms)} dispatches, {wall:.3f} s "
              f"wall, launches {launches}, front end {fe_launches}, device "
              f"ms a dispatch {np.round(ms, 4).tolist()}")
        check(scan.detect_scan.route == "k1_v2" and len(seen) == n_windows
              and all(r is not None for _, r in seen.values())
              and launches == {"migrate_detect_v2": slabs * n_windows}
              and fe_launches == front_end_only("front_end_stalta_v2",
                                                n_windows),
              f"mesh_path {label}: route {scan.detect_scan.route}, "
              f"{len(seen)} windows, launches {launches}, front end "
              f"{fe_launches}")

    single, single_seen = runs["unsharded"]
    fsmp = single.detect_scan.fsmp
    nsamples = int(round(ARCHIVE_TIMESTEP * RATE))
    tt_dev = torch.from_numpy(single.detect_scan.traveltimes).to(device)

    def traces(scan):
        day = start
        path = (scan.run.path / "detect" / "scanmseed"
                / f"{day.year}_{day.julday:03d}.scanmseed")
        return {tr.stats.station: tr.data.astype(np.int64)
                for tr in read(path)}

    want = traces(single)
    for label in ("grid4", "batch2x2"):
        scan, seen = runs[label]
        errs = {"max_coa_n": 0.0, "tie": 0.0, "argmax_equal": []}
        same = []
        for i in range(n_windows):
            block, (max_coa, max_coa_n, max_idx, _) = seen[i]
            ref = single_seen[i][1]
            rel_n = np.abs(max_coa_n - ref[1]) / np.abs(ref[1])
            tie = np.abs(ref[0] - plain_coa_at(
                block, tt_dev, max_idx, device, fsmp, nsamples)) / ref[0]
            check(np.array_equal(max_coa, ref[0])
                  and rel_n.max() <= MAX_COA_N_RTOL
                  and tie.max() <= MAX_COA_RTOL,
                  f"mesh_path {label} window {i}: max_coa equal "
                  f"{np.array_equal(max_coa, ref[0])}, max_coa_n "
                  f"{rel_n.max()}, tie {tie.max()}")
            errs["max_coa_n"] = max(errs["max_coa_n"], float(rel_n.max()))
            errs["tie"] = max(errs["tie"], float(tie.max()))
            same.append(max_idx == ref[2])
        same = np.concatenate(same)
        got = traces(scan)
        diff = {k: int(np.abs(got[k] - want[k]).max()) for k in want}
        xyz_equal = all(np.array_equal(got[k][same], want[k][same])
                        for k in ("X", "Y", "Z"))
        record[label].update(
            vs_unsharded=errs | {"argmax_equal": float(same.mean())},
            scanmseed_max_count_diff=diff, xyz_equal_where_argmax=xyz_equal)
        print(f"mesh_path {label} against the unsharded run: max_coa bit "
              f"for bit, max_coa_n {errs['max_coa_n']:.2e}, tie "
              f"{errs['tie']:.2e}, argmax equal {same.mean():.4f}; "
              f".scanmseed count differences {diff}")
        check(sorted(got) == sorted(want) and diff["COA"] == 0
              and diff["COA_N"] <= 1 and xyz_equal,
              f"mesh_path {label}: .scanmseed against the unsharded run's: "
              f"{diff}, X/Y/Z equal where the argmax is: {xyz_equal}")

    # Warm, on the card: each run's windows again through its DetectScan
    # (the blocks the scans prepared), device ms a window; and the kernel
    # alone, K1 v2 on the whole plan against the grid mesh's slab
    # launches, in turns
    blocks = [single_seen[i][0] for i in range(n_windows)]
    for label in meshes:
        scan = runs[label][0].detect_scan
        ms = []
        for _ in range(3):
            scan.detect(blocks)
            ms += [m / (scan.batch or 1) for m in scan.window_ms]
        record[label]["warm_window_ms"] = float(np.median(ms))
    record["k1_v2_turns_ms"] = slab_turns(
        single.detect_scan, runs["grid4"][0].detect_scan, blocks[1],
        nsamples)

    # Locate the planted event from a trigger row at its origin
    trigger = root / "mesh_trigger.csv"
    uid = "".join(c for c in str(origin)[:23] if c.isdigit())
    with open(trigger, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["EventID", "CoaTime", "TRIG_COA", "COA_X", "COA_Y",
                         "COA_Z", "COA", "COA_NORM"])
        writer.writerow([uid, str(origin), 3.0, 0.0, 0.0, 0.0, 3.0, 3.0])
    events = {}
    for label in ("unsharded", "grid4"):
        onset = STALTAOnset(position="centred", sampling_rate=RATE)
        onset.phases = ["P", "S"]
        onset.bandpass_filters = {"P": [10, 124, 4], "S": [10, 124, 4]}
        onset.sta_lta_windows = {p: list(w) for p, w in STA_LTA.items()}
        scan = QuakeScan(archive, lut, onset, str(root / "runs"),
                         f"mesh_locate_{label}", device=device,
                         mesh=meshes[label][0],
                         marginal_window=LOCATE_MARGINAL_WINDOW,
                         plot_event_summary=False)
        torch.cuda.synchronize()
        cm.reset_launches()
        with NoPlainOnCuda("mesh_path"):
            _, wall = quiet(root, f"mesh_locate_{label}",
                            lambda: scan.locate(trigger_file=str(trigger)))
        torch.cuda.synchronize()
        launches = {k: v for k, v in cm.launches.items() if v}
        (path,) = sorted((scan.run.path / "locate" / "events").glob(
            "*.event"))
        with open(path, newline="") as f:
            header, row = list(csv.reader(f))[:2]
        events[label] = dict(zip(header, row))
        slabs = meshes[label][1]
        record[f"locate_{label}"] = {"wall_s": wall, "launches": launches}
        print(f"mesh_path locate {label}: {wall:.3f} s wall, launches "
              f"{launches}; X {events[label]['X']}, Y {events[label]['Y']},"
              f" Z {events[label]['Z']}")
        check(launches == {"migrate_detect_v2": slabs,
                           "migrate_marginalise_v2": slabs},
              f"mesh_path locate {label}: launches {launches}")
    xyz = {k: (events["grid4"][k], events["unsharded"][k])
           for k in ("X", "Y", "Z")}
    record["locate_grid4"]["xyz_equal"] = all(a == b for a, b in xyz.values())
    check(record["locate_grid4"]["xyz_equal"],
          f"mesh_path locate: the mesh's X, Y, Z against the unsharded "
          f"run's: {xyz}")

    # One F3 window on the "k3" route, K3 v2 a slab
    rng = np.random.default_rng(2032)
    tt = f3_traveltimes(rng)
    lsmp = int(tt.max()) + 2 * int(F3_STA_LTA["S"][1] * F3_RATE) + 100
    windows, _ = make_windows(
        tt, rng, F3_WINDOWS, plant_window=1, node_count=F3_NODES,
        fsmp=F3_FSMP, nsamples=F3_NSAMPLES, lsmp=lsmp, rate=F3_RATE,
        sta_lta=F3_STA_LTA)
    route = detect_route(tt, F3_NODES, device)
    f3 = {}
    for label, mesh in (("unsharded", None),
                        ("grid4", make_mesh([device] * MESH_SLABS))):
        scan = DetectScan(tt, F3_NODES, F3_FSMP, lsmp, device=device,
                          route=route, mesh=mesh)
        scan.detect([windows[1]])  # the slabs' tables up before the count
        torch.cuda.synchronize()
        cm.reset_launches()
        result = scan.detect([windows[1]])[0]
        torch.cuda.synchronize()
        launches = {k: v for k, v in cm.launches.items() if v}
        ms = []
        for _ in range(3):
            scan.detect([windows[1]])
            ms.append(scan.window_ms[0])
        f3[label] = (result, launches, ms, scan)
    (got, launches, ms, scan), (ref, _, single_ms, single_scan) = (
        f3["grid4"], f3["unsharded"])
    rel_n = float((np.abs(got[1] - ref[1]) / np.abs(ref[1])).max())
    record["f3"] = {"route": route[0], "launches": launches,
                    "max_equal": bool(np.array_equal(got[0], ref[0])),
                    "argmax_equal": bool(np.array_equal(got[2], ref[2])),
                    "max_coa_n_rel": rel_n, "window_ms": ms,
                    "unsharded_window_ms": single_ms,
                    "k3_v2_turns_ms": slab_turns(single_scan, scan,
                                                 windows[1], F3_NSAMPLES)}
    print(f"mesh_path f3: route {route[0]}, launches {launches}; max and "
          f"argmax equal to the unsharded window: "
          f"{record['f3']['max_equal']}, {record['f3']['argmax_equal']}, "
          f"max_coa_n {rel_n:.2e}; device ms a window {np.round(ms, 4)} "
          f"against unsharded {np.round(single_ms, 4)}; K3 v2 alone, "
          f"whole plan against the slabs in turns "
          f"{record['f3']['k3_v2_turns_ms']}")
    check(route[0] == "k3"
          and launches == {"migrate_detect_global_v2": MESH_SLABS}
          and record["f3"]["max_equal"] and record["f3"]["argmax_equal"]
          and rel_n <= MAX_COA_N_RTOL, f"mesh_path f3: {record['f3']}")

    print(f"mesh_path: device ms a window, warm (median of 3 passes over "
          f"the {n_windows} prepared windows): unsharded "
          f"{record['unsharded']['warm_window_ms']:.4f}, grid4 "
          f"{record['grid4']['warm_window_ms']:.4f} ({MESH_SLABS} slabs), "
          f"batch2x2 {record['batch2x2']['warm_window_ms']:.4f} (a "
          f"dispatch of two windows, halved); K1 v2 alone, the whole plan "
          f"against the grid mesh's slabs in turns "
          f"{record['k1_v2_turns_ms']}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    record["phase_s"] = time.perf_counter() - t_phase
    return record


def slab_turns(single, sharded, block, nsamples, reps=20):
    """The route's kernel alone on one window's prepared onsets: the
    unsharded DetectScan's detector on the whole plan against the mesh
    DetectScan's slab detectors launched one after another, timed in
    turns (unsharded, slabs, slabs, unsharded; CUDA events, mean of
    ``reps``). Returns {"unsharded": [ms, ms], "slabs": [ms, ms]}."""

    device = single.device
    det = single.detector(nsamples)
    slab_dets = [slab.detector(device, single.fsmp, nsamples)
                 for slab in sharded.mesh_detect().slabs]
    tensors = [torch.from_numpy(a).to(device) for a in block]
    combined, available = single.front_end(*tensors)
    onsets_log, inv = det.prepare(combined, tensors[2], available)
    fns = {"unsharded": lambda: det.launch(onsets_log, inv),
           "slabs": lambda: [d.launch(onsets_log, inv) for d in slab_dets]}
    turns = {"unsharded": [], "slabs": []}
    for label in ("unsharded", "slabs", "slabs", "unsharded"):
        turns[label].append(cuda_ms(fns[label], reps))
    return turns


def scanmseed_bytes(scan):
    """The bytes of a detect run's one .scanmseed file."""

    (path,) = sorted((scan.run.path / "detect" / "scanmseed").glob(
        "*.scanmseed"))
    return path.read_bytes()


def availability_cells(scan):
    """Every station-phase cell of a detect run's StationAvailability
    files, as ints."""

    import csv

    cells = []
    for path in sorted((scan.run.path / "detect" / "availability").glob(
            "*.csv")):
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        cells += [int(cell) for row in rows[1:] for cell in row[1:]]
    return cells


# ops_path: the Icequake flat table (26 onsets) through the routed ops
OPS_WINDOWS = 4
OPS_MAP_SAMPLES = 61
OPS_SLAB = (100_000, 160_000, 150_000, 4_000)  # first row, end, real, pad
OPS_WIDE_SPAN = 32_769


def routed_bound(n_nodes, n_onsets, t_len, nsamples, itemsize=4,
                 map_out=False):
    """Bound of a routed ops call (:func:`roofline`): the bytes its
    function must move, each input read once (the onsets [O, T] of
    ``itemsize``, the int32 flat table [N, O], the mask [O]) and each
    output written once (max, int32 argmax and normalised max [S]; or,
    with ``map_out``, the map [N, S]); against O adds and four more
    operations a node and sample (three for the map) at the peak for the
    onsets' type. Also the floor of the gather, the N x O x S reads of
    ``itemsize`` at the shared-memory rate."""

    out = (n_nodes * nsamples * itemsize if map_out
           else nsamples * (2 * itemsize + 4))
    nbytes = (itemsize * (n_onsets * t_len + n_onsets) + 4 * n_nodes
              * n_onsets + out)
    bound_ms, bound_by = roofline(
        nbytes, n_nodes * nsamples * (n_onsets + (3 if map_out else 4)),
        FP64_FLOP_PER_S if itemsize == 8 else FP32_FLOP_PER_S)
    return {"bound_ms": bound_ms, "bound_by": bound_by,
            "smem_bound_ms": (n_nodes * n_onsets * nsamples * itemsize
                              / SMEM_BYTES_PER_S * 1e3)}


def flat_coa_at(onsets, tt_dev, mask, available, idx, fsmp, nsamples):
    """The plain flat-order coalescence of node idx[t] at sample t, in the
    onsets' type, traveltimes clamped to the block as the plain versions
    clamp them."""

    from quakemigrate_torch.ops.migrate import _prepare_onsets

    onsets_log = _prepare_onsets(onsets, mask)
    d_max = onsets.shape[-1] - fsmp - nsamples
    t = torch.arange(nsamples, device=onsets.device)
    rows = torch.clamp(tt_dev[idx.long()].long(), 0, d_max)
    acc = torch.zeros(nsamples, dtype=onsets_log.dtype, device=onsets.device)
    for o in range(onsets_log.shape[0]):
        acc = acc + onsets_log[o][fsmp + rows[:, o] + t]
    return torch.exp(acc / available)


def hold_detect(label, got, ref, onsets, tt_dev, mask, available, fsmp,
                nsamples, rtol, rtol_n):
    """A routed (max_coa, max_coa_n, max_idx) against the plain version's
    on the card: max within ``rtol``, normalised within ``rtol_n``, the
    argmax tie-consistent (the plain coalescence at the chosen node
    within ``rtol`` of the maximum). Returns the errors."""

    rel = float((torch.abs(got[0] - ref[0]) / torch.abs(ref[0])).max())
    rel_n = float((torch.abs(got[1] - ref[1]) / torch.abs(ref[1])).max())
    at = flat_coa_at(onsets, tt_dev, mask, available, got[2], fsmp,
                     nsamples)
    tie = float((torch.abs(at - ref[0]) / torch.abs(ref[0])).max())
    check(got[0].shape == (nsamples,) and got[2].dtype == torch.int32
          and bool(torch.isfinite(got[0]).all()) and rel <= rtol
          and rel_n <= rtol_n and tie <= rtol,
          f"{label}: max {rel:.2e}, normalised {rel_n:.2e}, tie {tie:.2e}")
    return {"max": rel, "max_coa_n": rel_n, "tie": tie,
            "max_abs_err": float(torch.abs(got[0] - ref[0]).max()),
            "argmax_equal": float((got[2] == ref[2]).double().mean())}


def ops_path(device):
    """ops_path: the JAX package's public device functions of migration in
    quakemigrate_torch.ops (ops/routed.py), on CUDA tensors through the
    "k3" route's kernels, at the Icequake flat table (26 onsets, 259,008
    nodes; windows of 625 samples made as step 4 makes them). Checks:
    migrate_detect_batch over OPS_WINDOWS windows equal to that many
    migrate_detect calls bit for bit (max, normalised max, argmax) and
    each held to the plain migrate_detect on the card (:func:`hold_detect`:
    1e-5, 1e-4, tie-consistent), K3 v2 once a call and the detector built
    once; the same in float64 on K3 v3 f64 (1e-12; its per-tile max and
    argmax K3 v2 f64's, timed in turns with K3 v2 f64, K3 f64 and K3 v2);
    migrate_map over
    OPS_MAP_SAMPLES samples on M2 ring (on K3 v2's tables) and M2 ring
    f64 (on K3 v2 f64's) within MAP_RTOL (DOUBLE_RTOL) of the plain map;
    detect_reduce on a padded
    slab (OPS_SLAB) bit for bit the unpadded slice's, within 1e-5 of the
    plain version on the slab, its argmax global and below n_nodes_real;
    a flat table with one traveltime of OPS_WIDE_SPAN - 1 on K3 and K3
    f64 (K3 v2's ring refuses it), held to the plain version. The routed
    calls run under :class:`NoPlainOnCuda` (the plain ops.migrate
    functions too), their launches counted from 0: exactly the kernels
    named, nothing else. Then each kernel timed with CUDA events on the
    prepared onsets beside the routed call, the plain version and
    :func:`routed_bound`; M2 ring and M2 ring f64 also held to their
    plain version, to M2 simple (M2 simple f64) bit for bit and to K3
    v2's (K3 v2 f64's) tmax, and timed in turns with M2 simple (M2 simple
    f64; exp_ring.m2_case). Returns a record."""

    from quakemigrate_torch import ops
    from quakemigrate_torch.experiments import exp_ring
    from quakemigrate_torch.experiments.exp_kernel_breakdown import in_turns
    from quakemigrate_torch.ops import cuda_migrate as cm
    from quakemigrate_torch.ops import migrate as plain
    from quakemigrate_torch.ops import routed
    from quakemigrate_torch.ops.scan_window import fused_onsets

    rng = np.random.default_rng(2033)
    tt = icequake_traveltimes(rng, n_stations=13)
    n_nodes, n_onsets = tt.shape
    windows, _ = make_windows(tt, rng, n_windows=OPS_WINDOWS,
                              plant_window=1)
    fronts, masks = [], []
    for block in windows:
        tensors = [torch.from_numpy(a).to(device) for a in block]
        fronts.append(fused_onsets(*tensors, "classic", "energy", 0.4))
        masks.append(tensors[2])
    onsets = torch.stack([c for c, _ in fronts])
    masks = torch.stack(masks)
    available = torch.stack([a for _, a in fronts]).to(onsets.dtype)
    tt_dev = torch.from_numpy(tt).to(device)
    t_len = onsets.shape[-1]
    f64 = {"onsets": onsets.double(), "masks": masks.double(),
           "available": available.double()}
    first, end, n_real, pad = OPS_SLAB
    slab = torch.cat([tt_dev[first:end], torch.zeros(
        (pad, n_onsets), dtype=torch.int32, device=device)])
    wide = rng.integers(0, 40, size=(64, 2)).astype(np.int32)
    wide[5, 1] = OPS_WIDE_SPAN - 1
    wide_dev = torch.from_numpy(wide).to(device)
    wide_onsets = torch.from_numpy(rng.gamma(
        2.0, 1.5, size=(2, 16 + 100 + OPS_WIDE_SPAN))).float().to(device)
    wide_mask = torch.ones(2, device=device)

    routed.clear_cache()
    guard = NoPlainOnCuda("ops_path", extra=[
        (plain, name) for name in ("detect_reduce", "migrate_detect",
                                   "migrate_detect_batch", "migrate_map")])
    out, calls, detectors, builds = {}, {}, {}, []
    torch.cuda.synchronize()
    cm.reset_launches()
    with guard:
        for key, o, m, a in (("f32", onsets, masks, available),
                             ("f64", f64["onsets"], f64["masks"],
                              f64["available"])):
            t0 = time.perf_counter()
            out[key] = ops.migrate_detect_batch(o, tt_dev, m, a, FSMP,
                                                NSAMPLES)
            torch.cuda.synchronize()
            calls[f"batch_{key}_s"] = time.perf_counter() - t0
            out[f"{key}_single"] = [ops.migrate_detect(
                o[b], tt_dev, m[b], a[b], FSMP, NSAMPLES)
                for b in range(OPS_WINDOWS)]
            # The batch and the single calls built one detector
            builds.append(len(routed._detectors))
            detectors[key] = routed.detector(tt_dev, n_nodes, t_len, FSMP,
                                             NSAMPLES, o.dtype, o.device)
            out[f"map_{key}"] = ops.migrate_map(o[0], tt_dev, m[0], a[0],
                                                FSMP, OPS_MAP_SAMPLES)
            detectors[f"map_{key}"] = routed.detector(
                tt_dev, n_nodes, t_len, FSMP, OPS_MAP_SAMPLES, o.dtype,
                o.device)
        out["slab"] = ops.detect_reduce(
            onsets[0], slab, masks[0], available[0], FSMP, NSAMPLES, n_real,
            node_offset=first)
        out["slice"] = ops.detect_reduce(
            onsets[0], tt_dev[first:n_real], masks[0], available[0], FSMP,
            NSAMPLES, n_nodes, node_offset=first)
        for key, o, m in (("wide", wide_onsets, wide_mask),
                          ("wide_f64", wide_onsets.double(),
                           wide_mask.double())):
            out[key] = ops.migrate_detect(o, wide_dev, m, 2.0, 16, 100)
            detectors[key] = routed.detector(wide_dev, 64, o.shape[-1], 16,
                                             100, o.dtype, o.device)
    torch.cuda.synchronize()
    launches = dict(cm.launches)
    expected = {"migrate_detect_global_v2": 2 * OPS_WINDOWS + 2,
                "migrate_detect_global_v3_f64": 2 * OPS_WINDOWS,
                "migrate_map_ring": 1, "migrate_map_ring_f64": 1,
                "migrate_detect_global": 1, "migrate_detect_global_f64": 1}
    check(launches == {k: expected.get(k, 0) for k in launches},
          f"ops_path: launches {launches}, expected {expected}")
    check(builds == [1, 3], f"ops_path: detectors cached after each "
          f"batch and its single calls {builds}, not [1, 3]")
    check(all(detectors[k].tables is not None for k in ("f32", "f64"))
          and all(detectors[k].tables is None
                  for k in ("wide", "wide_f64"))
          and detectors["map_f32"].ring_refusal is None
          and detectors["map_f64"].ring_refusal is None,
          "ops_path: K3 v2 refused the flat Icequake table, or took the "
          "wide one, or the ring refused the map's")
    check(cm.global_v3_layout(detectors["f64"].layout).stage_passes == 2,
          "ops_path: K3 v3 f64 does not take the flat table one stage an "
          "item")

    # Held to the plain versions on the card (outside the guard)
    record = {"launches": launches, "nodes": n_nodes, "onsets": n_onsets,
              "windows": OPS_WINDOWS, "nsamples": NSAMPLES,
              "r_span": detectors["f32"].r_span, **calls}
    for key, o, m, a, rtol, rtol_n in (
            ("f32", onsets, masks, available, MAX_COA_RTOL, MAX_COA_N_RTOL),
            ("f64", f64["onsets"], f64["masks"], f64["available"],
             DOUBLE_RTOL, DOUBLE_RTOL)):
        batch, errs = out[key], []
        for b in range(OPS_WINDOWS):
            single = out[f"{key}_single"][b]
            check(all(torch.equal(part, whole[b])
                      for part, whole in zip(single, batch)),
                  f"ops_path {key}: window {b} of the batch is not its "
                  "single call bit for bit")
            ref = plain.migrate_detect(o[b], tt_dev, m[b], a[b], FSMP,
                                       NSAMPLES)
            errs.append(hold_detect(f"ops_path {key} window {b}",
                                    [x[b] for x in batch], ref, o[b],
                                    tt_dev, m[b], a[b], FSMP, NSAMPLES,
                                    rtol, rtol_n))
        record[f"detect_{key}"] = {
            k: max(e[k] for e in errs) for k in errs[0]
            if k != "argmax_equal"}
        record[f"detect_{key}"]["argmax_equal"] = [e["argmax_equal"]
                                                   for e in errs]
        ref_map = plain.migrate_map(o[0], tt_dev, m[0], a[0], FSMP,
                                    OPS_MAP_SAMPLES)
        got_map = out[f"map_{key}"]
        map_rel = float((torch.abs(got_map - ref_map)
                         / torch.abs(ref_map)).max())
        check(got_map.shape == (n_nodes, OPS_MAP_SAMPLES)
              and map_rel <= (MAP_RTOL if key == "f32" else DOUBLE_RTOL),
              f"ops_path map {key}: {map_rel:.2e}")
        record[f"map_{key}"] = {
            "max_rel_err": map_rel,
            "max_abs_err": float(torch.abs(got_map - ref_map).max())}
    del out["map_f32"], out["map_f64"], ref_map, got_map
    check(all(torch.equal(a, b) for a, b in zip(out["slab"], out["slice"])),
          "ops_path: the padded slab differs from its unpadded slice")
    ref = plain.detect_reduce(onsets[0], slab, masks[0], available[0], FSMP,
                              NSAMPLES, n_real, node_offset=first)
    slab_rel = float((torch.abs(out["slab"][0] - ref[0])
                      / torch.abs(ref[0])).max())
    check(slab_rel <= MAX_COA_RTOL and int(out["slab"][1].min()) >= first
          and int(out["slab"][1].max()) < n_real,
          f"ops_path slab: {slab_rel:.2e}, argmax in "
          f"[{int(out['slab'][1].min())}, {int(out['slab'][1].max())}]")
    record["slab"] = {"max": slab_rel, "argmax_equal": float(
        (out["slab"][1] == ref[1]).double().mean())}
    for key, o, m, rtol in (("wide", wide_onsets, wide_mask, MAX_COA_RTOL),
                            ("wide_f64", wide_onsets.double(),
                             wide_mask.double(), DOUBLE_RTOL)):
        ref = plain.migrate_detect(o, wide_dev, m, 2.0, 16, 100)
        record[key] = hold_detect(f"ops_path {key}", out[key], ref, o,
                                  wide_dev, m, 2.0, 16, 100, rtol,
                                  MAX_COA_N_RTOL if key == "wide"
                                  else DOUBLE_RTOL)

    # Times: each kernel on the routed detector's prepared onsets, the
    # routed call, the plain version
    times = {}
    for key, o, m, a, itemsize in (
            ("f32", onsets, masks, available, 4),
            ("f64", f64["onsets"], f64["masks"], f64["available"], 8)):
        det, map_det = detectors[key], detectors[f"map_{key}"]
        onsets_log, inv = det.prepare(o[0], m[0], a[0])
        map_log, map_inv = map_det.prepare(o[0], m[0], a[0])
        times[key] = {
            "k3_v2_ms": median_ms(lambda: det.launch(onsets_log, inv), 20),
            "k3_ms": median_ms(lambda: det.launch_v1(onsets_log, inv), 20),
            "call_ms": median_ms(lambda: ops.migrate_detect(
                o[0], tt_dev, m[0], a[0], FSMP, NSAMPLES), 20),
            "plain_ms": median_ms(lambda: plain.migrate_detect(
                o[0], tt_dev, m[0], a[0], FSMP, NSAMPLES), 1, turns=1,
                warmup=0),
            "map_ms": median_ms(lambda: map_det.map(map_log, map_inv), 20),
            "map_call_ms": median_ms(lambda: ops.migrate_map(
                o[0], tt_dev, m[0], a[0], FSMP, OPS_MAP_SAMPLES), 20),
            "map_plain_ms": median_ms(lambda: plain.migrate_map(
                o[0], tt_dev, m[0], a[0], FSMP, OPS_MAP_SAMPLES), 1,
                turns=1, warmup=0),
            "bound": routed_bound(n_nodes, n_onsets, t_len, NSAMPLES,
                                  itemsize),
            "map_bound": routed_bound(n_nodes, n_onsets, t_len,
                                      OPS_MAP_SAMPLES, itemsize,
                                      map_out=True),
        }
        # M2 ring (M2 ring f64) on K3 v2's (K3 v2 f64's) tables of the
        # map's detector, held to its plain version, to M2 simple (f64)
        # and to K3 v2's tmax, in turns with M2 simple
        ring_case = exp_ring.setup(map_det, map_log, map_inv,
                                   f"ops_path map {key}")
        times[key]["map_ring"] = exp_ring.m2_case(
            ring_case, tmax=exp_ring.k3_tmax(ring_case))
        times[key]["map_ms"] = times[key]["map_ring"]["ms"]
        times[key]["map_simple_ms"] = times[key]["map_ring"]["m2_simple_ms"]
        del ring_case
        del map_log
    # K3 v3 f64 in turns with its yardstick K3 v2 f64, K3 f64 and K3 v2 on
    # the first window, its per-tile max and argmax K3 v2 f64's
    det64, det32 = detectors["f64"], detectors["f32"]
    log64, inv64 = det64.prepare(f64["onsets"][0], f64["masks"][0],
                                 f64["available"][0])
    log32, inv32 = det32.prepare(onsets[0], masks[0], available[0])
    v3, v2 = det64.launch(log64, inv64), det64.launch_v2(log64, inv64)
    torch.cuda.synchronize()
    v3_equal = torch.equal(v3[0], v2[0]) and torch.equal(v3[1], v2[1])
    check(v3_equal, "ops_path: K3 v3 f64's max or argmax differs from K3 "
          "v2 f64's")
    del v3, v2
    turns = in_turns({
        "k3_v3_f64": lambda: det64.launch(log64, inv64),
        "k3_v2_f64": lambda: det64.launch_v2(log64, inv64),
        "k3_f64": lambda: det64.launch_v1(log64, inv64),
        "k3_v2": lambda: det32.launch(log32, inv32)}, reps=20)
    times["f64"].update(
        turns_ms=turns, v3_equal_to_v2=v3_equal,
        **{f"{k}_turns_ms": float(np.mean(v)) for k, v in turns.items()})
    times["f64"]["k3_v3_ms"] = times["f64"]["k3_v3_f64_turns_ms"]
    times["f64"]["k3_v2_ms"] = times["f64"]["k3_v2_f64_turns_ms"]
    del log64, log32
    for key, o, m in (("wide", wide_onsets, wide_mask),
                      ("wide_f64", wide_onsets.double(), wide_mask.double())):
        det = detectors[key]
        onsets_log, inv = det.prepare(o, m, 2.0)
        times[key] = {
            "k3_ms": median_ms(lambda: det.launch(onsets_log, inv), 20),
            "plain_ms": median_ms(lambda: plain.migrate_detect(
                o, wide_dev, m, 2.0, 16, 100), 1, turns=1, warmup=0),
            "bound": routed_bound(64, 2, o.shape[-1], 100,
                                  o.element_size())}
    record["times"] = times
    del detectors
    routed.clear_cache()
    print(f"ops_path f64: K3 v3 f64 in turns {turns}")
    for key in ("f32", "f64"):
        t = times[key]
        print(f"ops_path {key}: K3 v2 {t['k3_v2_ms']:.4f} ms (K3 "
              f"{t['k3_ms']:.4f}; the routed migrate_detect "
              f"{t['call_ms']:.4f}; plain {t['plain_ms']:.4f}; bound "
              f"{t['bound']['bound_ms']:.4f} by {t['bound']['bound_by']}, "
              f"gather floor {t['bound']['smem_bound_ms']:.4f}); "
              f"{'M2 ring' if key == 'f32' else 'M2 ring f64'} over "
              f"{OPS_MAP_SAMPLES} samples {t['map_ms']:.4f} ms (M2 simple "
              f"{t['map_simple_ms']:.4f}; the "
              f"routed migrate_map {t['map_call_ms']:.4f}; plain "
              f"{t['map_plain_ms']:.4f}; bound "
              f"{t['map_bound']['bound_ms']:.4f} by "
              f"{t['map_bound']['bound_by']}); errors "
              f"{record[f'detect_{key}']}, map {record[f'map_{key}']}")
    print(f"ops_path: wide span K3 {times['wide']['k3_ms']:.4f} ms, K3 f64 "
          f"{times['wide_f64']['k3_ms']:.4f} ms; slab {record['slab']}; "
          f"batch of {OPS_WINDOWS} (cold, the plan built) "
          f"{calls['batch_f32_s']:.3f} s, float64 "
          f"{calls['batch_f64_s']:.3f} s; launches {launches}; r_span "
          f"{record['r_span']}")
    return record


def keep_locate(run_dir, keep, label):
    """A copy of a run's locate outputs under ``keep/label`` (the phase's
    temporary directory goes with it), for export_path."""

    import shutil

    target = keep / label
    shutil.copytree(run_dir / "locate", target / "locate")
    return target


def locate_files(run_dir):
    """{relative path: bytes} of a run's .event, .picks and .amps files."""

    locate = run_dir / "locate"
    return {p.relative_to(locate).as_posix(): p.read_bytes()
            for kind in ("events", "picks", "amplitudes")
            for p in sorted((locate / kind).glob("*")) if p.is_file()}


def export_run(run_dir, stations, units, out):
    """Every export of quakemigrate_torch.export on one run directory into
    ``out``, checked: one record and one QuakeML event per .event file,
    each ML equal to the .event's; one NLLoc line and one Snuffler phase
    line per pick that is not -1; a station line per station; SAC files
    from sac_mfast that read back with the port's reader. Returns
    (record, {relative path: bytes} of everything written)."""

    import xml.etree.ElementTree as ElementTree

    from quakemigrate_torch import export
    from quakemigrate_torch.io.table import read_table
    from quakemigrate_torch.seis import read

    t0 = time.perf_counter()
    events = sorted((run_dir / "locate" / "events").glob("*.event"))
    records = export.read_run(run_dir, units)
    check(events and len(records) == len(events),
          f"export {run_dir.name}: {len(records)} records for "
          f"{len(events)} .event files")
    export.write_quakeml(run_dir, out / "catalogue.xml", units)
    ns = {"q": "http://quakeml.org/xmlns/bed/1.2"}
    root = ElementTree.parse(out / "catalogue.xml").getroot()
    xml_events = root.findall("q:eventParameters/q:event", ns)
    check(len(xml_events) == len(events),
          f"export {run_dir.name}: {len(xml_events)} QuakeML events")
    ml = []
    for record, element in zip(records, xml_events):
        row = read_table(run_dir / "locate" / "events"
                         / f"{record.uid}.event").row(0)
        value = element.find("q:magnitude/q:mag/q:value", ns)
        if "ML" in row and row["ML"] == row["ML"]:
            check(value is not None and float(value.text) == row["ML"],
                  f"export {record.uid}: QuakeML ML "
                  f"{None if value is None else value.text}, .event "
                  f"{row['ML']}")
            ml.append(float(value.text))
        usable = sum(str(t) != "-1" for t in record.picks["PickTime"])
        export.nlloc_obs(record, out / f"{record.uid}.obs")
        lines = (out / f"{record.uid}.obs").read_text().splitlines()
        export.snuffler_markers(record, out)
        markers = (out / record.uid / f"{record.uid}.markers").read_text()
        check(len(lines) == usable and markers.count("phase:") == usable,
              f"export {record.uid}: {len(lines)} NLLoc lines, "
              f"{markers.count('phase:')} markers for {usable} picks")
        waves = run_dir / "locate" / "raw_cut_waveforms"
        export.sac_mfast(record, stations, out / "mfast", units,
                         str(next(waves.glob(f"{record.uid}.*"))))
    export.snuffler_stations(stations, out, "stations.pf")
    check(len((out / "stations.pf").read_text().splitlines())
          == len(stations), f"export {run_dir.name}: station file")
    sac = sorted((out / "mfast").rglob("*"))
    sac = [p for p in sac if p.is_file()]
    for path in sac:
        st = read(str(path), format="SAC")
        check(len(st) == 1 and st[0].stats.npts > 0
              and bool(np.isfinite(st[0].data).all()),
              f"export {path.name}: read back {st}")
    check(sac, f"export {run_dir.name}: no MFAST SAC file")
    written = {p.relative_to(out).as_posix(): p.read_bytes()
               for p in sorted(out.rglob("*")) if p.is_file()}
    return {"events": len(records), "ml": ml, "sac_files": len(sac),
            "files": len(written), "wall_s": time.perf_counter() - t0}, written


def export_path(runs):
    """export_path: :func:`export_run` on each kept run directory (``runs``:
    label -> (run dir, stations, units, the run dir of the same locate
    with device="cpu" or None)). Where that CPU run's .event, .picks and
    .amps files equal the card run's byte for byte, its exports are
    byte-equal to the card run's too. Returns a record."""

    import tempfile

    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (run_dir, stations, units, cpu_dir) in runs.items():
            out = pathlib.Path(tmp) / label
            record[label], written = export_run(run_dir, stations, units,
                                                out)
            if cpu_dir is not None:
                same = locate_files(run_dir) == locate_files(cpu_dir)
                record[label]["cpu_files_equal"] = same
                if same:
                    _, cpu_written = export_run(cpu_dir, stations, units,
                                                pathlib.Path(tmp)
                                                / f"{label}_cpu")
                    check(cpu_written == written,
                          f"export {label}: the CPU run's exports differ")
                    record[label]["cpu_exports_equal"] = True
            print(f"export_path {label}: {record[label]}")
    return record


def main():
    import tempfile

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

    r1_record = recursive_stalta_path(device)
    compat_record = compat_path(device)

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
    keep_tmp = tempfile.TemporaryDirectory()
    keep = pathlib.Path(keep_tmp.name)
    archive_launches, archive_record, locate_record = archive_detect_path(
        device, f1_route, keep=keep)
    vt_record = vt_locate_mags_path(device, keep=keep)
    torch.cuda.empty_cache()
    ops_record = ops_path(device)
    torch.cuda.empty_cache()
    vt_record["export_path"] = export_path({
        "archive_locate": locate_record.pop("export"),
        "vt_locate_mags": vt_record.pop("export")})
    keep_tmp.cleanup()
    map_cases = map_kernel_path(device, locate_record.pop("map_geometry"),
                                f1_route, vt_record.pop("map_geometry"))
    del f1_route
    f3_record = f3_path(device)
    xla_record = xla_icequake_path(device, tt, windows)
    wide_record = span_path(device, 32_769)
    mid_record = span_path(device, 15_000, kernel="xla")
    wide_double = span_path(device, 15_000, precision="double")
    check(wide_record["kernel"] == "migrate_detect_global"
          and mid_record["shape"] == [16, 16]
          and wide_double["kernel"] == "migrate_detect_global_f64"
          and wide_record["locate"]["kernels"] == [
              "migrate_marginalise", "migrate_map"]
          and wide_double["locate"]["kernels"] == [
              "migrate_marginalise_f64", "migrate_map_f64"]
          and mid_record["locate"]["kernels"] == [
              "migrate_marginalise_ring", "migrate_map_ring"],
          f"span paths: {wide_record['kernel']}, {mid_record['shape']}, "
          f"{wide_double['kernel']}, locate {wide_record['locate']}, "
          f"{mid_record['locate']}, {wide_double['locate']}")
    kurtosis_record, decimate_record = kurtosis_decimate_path(device)
    torch.cuda.empty_cache()
    double_record, standard_record = double_standard_paths(device)
    torch.cuda.empty_cache()
    fe_record = front_end_path(device)
    FRONT_END_BLOCKS.clear()
    torch.cuda.empty_cache()
    onsets_record = locate_onsets_path(
        device, locate_record["onset_samples"], vt_record["onset_samples"])

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
                               + ("qm_migrate_detect_v2_kernelILi0E",)
                               + sass_loops.GLOBAL_PATTERNS)
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
        # mesh_path: K1 v2 once a slab and window of each mesh, and once a
        # slab in the grid mesh's locate pass 1
        "mesh_launches": {
            label: archive_record["mesh_path"][label]["launches"].get(
                "migrate_detect_v2", 0)
            for label in ("grid4", "batch2x2", "locate_grid4")},
        "mesh_window_ms": {
            label: archive_record["mesh_path"][label]["warm_window_ms"]
            for label in ("unsharded", "grid4", "batch2x2")},
        "mesh_turns_ms": archive_record["mesh_path"]["k1_v2_turns_ms"],
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
        "kurtosis_detect": kurtosis_record,
        "decimate_detect": decimate_record,
        # the reference's standard detect path (standard_path): a user's
        # onset, fused_detect=False and ClassicSTALTAOnset on K1 v2
        "standard_path": standard_record,
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
                {k: rec[k]
                 for k in ("n", "lds32", "lds128", "fadd", "local")}
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
        # pass 2 on the plans the ring refuses: the wide-span path
        # (span_path at 32,769 samples); on the main path (archive_locate,
        # route k1_v2) it launches no time, and is timed in turns beside
        # M1 v2, and at F1 and F3 beside M1 ring
        "launches": wide_record["locate"]["launches"]["migrate_marginalise"],
        "locate_launches": locate_record["launches"]["migrate_marginalise"],
        "max_abs_err": wide_record["locate"]["m1_abs_err"],
        "ms": locate_record["m1_ms"],
        "plain_ms": locate_record["m1_plain_ms"],
        "bound_ms": locate_record["bound_ms"],
        "bound_by": locate_record["bound_by"],
        "smem_bound_ms": locate_record["smem_bound_ms"],
        "library_ms": None,
        "window": locate_record["marginal_window"],
        "f1_ms": locate_record["m1_f1"]["v1_ms"],
        "f1_bound_ms": locate_record["m1_f1"]["v1_bound_ms"],
        "windows_ms": {name: r["v1_ms"] for name, r in
                       locate_record["m1_windows"].items()},
        "wide_span": wide_record["locate"],
    }, {
        "name": "migrate_marginalise_ring",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_marginalise_ring.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:291",
        # locate's pass 2 on K3's route (f3_path; span_path at 15,000
        # samples, K3 v2's one-block shape) and K2 v2's (F1)
        "launches": (f3_record["m1_ring"]["launches"]
                     + locate_record["m1_f1"]["launches"][
                         "migrate_marginalise_ring"]
                     + mid_record["locate"]["launches"][
                         "migrate_marginalise_ring"]
                     + locate_record["ring_locate"]["two_pass"]["launches"][
                         "migrate_marginalise_ring"]),
        "launches_by_path": {
            "ring_locate": locate_record["ring_locate"]["two_pass"][
                "launches"]["migrate_marginalise_ring"],
            "f3_path": f3_record["m1_ring"]["launches"],
            "f1": locate_record["m1_f1"]["launches"][
                "migrate_marginalise_ring"],
            "span_path_15000": mid_record["locate"]["launches"][
                "migrate_marginalise_ring"]},
        "max_abs_err": max(f3_record["m1_ring"]["max_abs_err"],
                           locate_record["m1_f1"]["ring"]["max_abs_err"]),
        **{k: f3_record["m1_ring"][k] for k in (
            "ms", "m1_ms", "turns_ms", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "smem_bound_ms", "equal_to_m1", "window",
            "registers", "spill_stores", "spill_loads", "blocks_per_sm")},
        "library_ms": None,
        "f3": f3_record["m1_ring"],
        "f1": locate_record["m1_f1"]["ring"],
        "f1_ring_build": locate_record["m1_f1"]["ring_build"],
        "span_path_15000": mid_record["locate"],
        "ring_locate": locate_record["ring_locate"]["two_pass"],
    }, {
        "name": "migrate_marginalise_v2",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_marginalise_v2.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:291",
        # the main path: QuakeScan.locate over the archive (archive_locate)
        "launches": locate_record["launches"]["migrate_marginalise_v2"],
        # mesh_path: once a slab in the grid mesh's locate pass 2
        "mesh_launches": archive_record["mesh_path"]["locate_grid4"][
            "launches"].get("migrate_marginalise_v2", 0),
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
            "bound_by", "smem_bound_ms", "m1_v2_bound", "map")},
        "vt_locate_mags_launches": vt_record["launches"][
            "migrate_marginalise_v2"],
    }, {
        "name": "migrate_map_persistent",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_map_persistent.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:264",
        # the main path: QuakeScan.locate(write_coalescence=True) over the
        # archive (archive_locate's map path)
        "launches": locate_record["map"]["launches"][
            "migrate_map_persistent"],
        "case_launches": {k: map_cases[k]["case_launches"][
            "migrate_map_persistent"] for k in ("icequake", "vt")},
        # bit for bit the route's map in map_case: the route's errors
        "max_abs_err": max(map_cases[k]["max_abs_err"]
                           for k in ("icequake", "vt")),
        "max_rel_err": max(map_cases[k]["max_rel_err"]
                           for k in ("icequake", "vt")),
        "ms": map_cases["icequake"]["m2_v2_ms"],
        **{k: map_cases["icequake"][k] for k in (
            "plain_ms", "bound_ms", "bound_by", "smem_bound_ms",
            "output_ms", "ops_ms", "m2_ms", "m1_v2_ms", "k1_v2_ms",
            "turns_ms", "route_ms", "route_turns_ms", "device_ms",
            "copy_back_ms",
            "nsamples", "max_equal_to_k1_v2", "window_sum_rel_err_m1_v2",
            "equal_to_route", "m2_v2_rel_err_plain", "m2_v2")},
        "library_ms": None,
        # locate(plot_event_video=True): the video's map (plot_path)
        "plot_path_launches": locate_record["plot"]["launches"][
            "migrate_map_persistent"],
        "vt": map_cases["vt"],
        "map_path": locate_record["map"],
        "plot_path": locate_record["plot"],
        "vt_locate_mags": vt_record,
    }, {
        "name": "migrate_map_persistent_tables",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_map_persistent.cu",
        # M2 v2's tables of migrate_map's staging, built on the card from
        # K1 v2's at a detector's first map
        "replaces": "quakemigrate_tpu/ops/migrate.py:264",
        # the main path: archive_locate's map path (a fresh detector)
        "launches": locate_record["map"]["launches"][
            "migrate_map_persistent_tables"],
        **{k: map_cases["icequake"]["tables_kernel"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "turns_ms", "bytes", "build_s", "table_bytes",
            "first_call_launches")},
        "vt": map_cases["vt"]["tables_kernel"],
        "plot_path_launches": locate_record["plot"]["launches"][
            "migrate_map_persistent_tables"],
        "compat_path_launches": compat_record["k1_v2"]["launches"][
            "migrate_map_persistent_tables"],
    }, {
        "name": "migrate_map_v2",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_marginalise_v2.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:264",
        # M2, redesigned as M2 v2: the map kernel of the plans M2 v2
        # refuses, none on the main path; its launches in map_case as M2
        # v2's yardstick (its hold and turns)
        "launches": map_cases["icequake"]["case_launches"][
            "migrate_map_v2"],
        "main_path_launches": locate_record["map"]["launches"][
            "migrate_map_v2"],
        "case_launches": {k: map_cases[k]["case_launches"][
            "migrate_map_v2"] for k in ("icequake", "vt")},
        "max_abs_err": max(map_cases[k]["max_abs_err"]
                           for k in ("icequake", "vt")),
        "max_rel_err": max(map_cases[k]["max_rel_err"]
                           for k in ("icequake", "vt")),
        "ms": map_cases["icequake"]["m2_ms"],
        **{k: map_cases["icequake"][k] for k in (
            "plain_ms", "bound_ms", "bound_by", "smem_bound_ms",
            "output_ms", "ops_ms", "m1_v2_ms", "k1_v2_ms", "turns_ms",
            "device_ms", "nsamples", "m2_blocks_per_sm")},
        "vt_ms": map_cases["vt"]["m2_ms"],
        "library_ms": None,
    }, {
        "name": "migrate_map",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_marginalise.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:264",
        # M2's simple form on the plans the ring refuses: the wide-span
        # path (span_path at 32,769 samples); timed at F1 (K2 v2's route)
        # and F3 in turns beside M2 ring, and beside M2 on the Icequake
        # and VT plans
        "launches": wide_record["locate"]["launches"]["migrate_map"],
        "max_abs_err": wide_record["locate"]["map_abs_err"],
        "max_rel_err": wide_record["locate"]["map_rel_err"],
        "ms": map_cases["f1"]["simple_ms"],
        **{k: map_cases["f1"][k] for k in (
            "plain_ms", "bound_ms", "bound_by", "smem_bound_ms",
            "output_ms", "ops_ms", "copy_back_ms", "onsets", "nsamples")},
        "library_ms": None,
        "icequake_ms": map_cases["icequake"]["simple_ms"],
        "vt_ms": map_cases["vt"]["simple_ms"],
        "equal_to_m2": [map_cases[k]["simple_equal"]
                        for k in ("icequake", "vt")],
        # K3's route (f3_path): in turns beside M2 ring
        "f3": f3_record["map"],
        "wide_span": wide_record["locate"],
    }, {
        "name": "migrate_map_ring",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_marginalise_ring.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:264",
        # locate's map on K3's route (f3_path; span_path at 15,000) and K2
        # v2's (F1), the routed ops.migrate_map (ops_path) and
        # core.compat.migrate on K2 v2's route (compat_path)
        "launches": (f3_record["map_ring"]["launches"]
                     + map_cases["f1"]["launches"]["migrate_map_ring"]
                     + mid_record["locate"]["launches"]["migrate_map_ring"]
                     + ops_record["launches"]["migrate_map_ring"]
                     + compat_record["k2_v2"]["launches"][
                         "migrate_map_ring"]
                     + locate_record["ring_locate"]["map_path"]["launches"][
                         "migrate_map_ring"]),
        "launches_by_path": {
            "ring_locate": locate_record["ring_locate"]["map_path"][
                "launches"]["migrate_map_ring"],
            "f3_path": f3_record["map_ring"]["launches"],
            "f1": map_cases["f1"]["launches"]["migrate_map_ring"],
            "span_path_15000": mid_record["locate"]["launches"][
                "migrate_map_ring"],
            "ops_path": ops_record["launches"]["migrate_map_ring"],
            "compat_path": compat_record["k2_v2"]["launches"][
                "migrate_map_ring"]},
        "max_abs_err": max(f3_record["map_ring"]["max_abs_err"],
                           map_cases["f1"]["ring"]["max_abs_err"]),
        **{k: f3_record["map_ring"][k] for k in (
            "ms", "m2_simple_ms", "turns_ms", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by", "smem_bound_ms", "output_ms",
            "equal_to_m2_simple",
            "max_equal_to_k3_v2", "nsamples", "registers", "spill_stores",
            "spill_loads", "blocks_per_sm")},
        "library_ms": None,
        "f3": f3_record["map_ring"],
        "f1": map_cases["f1"]["ring"],
        "f1_ring_build": map_cases["f1"]["ring_build"],
        "span_path_15000": mid_record["locate"],
        "ring_locate": locate_record["ring_locate"]["map_path"],
    }, {
        "name": "migrate_detect_global",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_global.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:124",
        # its path: DetectScan's k3 route on a plan too wide for K3 v2's
        # ring (span_path); K3 v2's yardstick at F3 and Icequake
        "launches": wide_record["launches"],
        "max_abs_err": wide_record["exact"]["max_abs_err"],
        "ms": f3_record["k3_ms"],
        "plain_ms": f3_record["plain_ms"],
        "bound_ms": f3_record["k3"]["bound_ms"],
        "bound_by": f3_record["k3"]["bound_by"],
        "smem_bound_ms": f3_record["k3"]["smem_bound_ms"],
        "library_ms": None,
        "resources": _build_resources("qm_migrate_detect_global_kernelIf"),
        "xla_icequake_ms": xla_record["k3_ms"],
        "wide_span": wide_record,
    }, {
        "name": "migrate_detect_global_v2",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_global_v2.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:124",
        # its path: DetectScan's k3 route at F3's geometry (f3_path), and
        # locate's pass 1 there; the Icequake window with kernel="xla"
        "launches": f3_record["launches"],
        # mesh_path: one F3 window on a grid mesh, once a slab
        "mesh_launches": archive_record["mesh_path"]["f3"]["launches"].get(
            "migrate_detect_global_v2", 0),
        "mesh_window_ms": archive_record["mesh_path"]["f3"]["window_ms"],
        "unsharded_window_ms": archive_record["mesh_path"]["f3"][
            "unsharded_window_ms"],
        "mesh_turns_ms": archive_record["mesh_path"]["f3"]["k3_v2_turns_ms"],
        "max_abs_err": max(f3_record["exact"]["max_abs_err"],
                           xla_record["exact"]["max_abs_err"]),
        "ms": f3_record["ms"],
        "plain_ms": f3_record["plain_ms"],
        "bound_ms": f3_record["bound_ms"],
        "bound_by": f3_record["bound_by"],
        "smem_bound_ms": f3_record["smem_bound_ms"],
        "library_ms": None,
        "resources": f3_record["resources"],
        "f3": {k: v for k, v in f3_record.items()
               if k not in ("m1", "map", "k3", "double")},
        "xla_icequake": xla_record,
        "mid_span": mid_record,
    }]
    k3_case = double_record["k3_case"]
    m1_case, m2_case = double_record["m1_case"], double_record["m2_case"]
    ring_m1, ring_m2 = m1_case["ring"], m2_case["ring"]
    double_launches = double_record["launches"]
    f3_k3 = f3_record["double"]["k3"]
    kernels += [{
        "name": "migrate_detect_global_v3_f64",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_global_v3.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:124",
        # the main path: QuakeScan(precision="double").detect over the
        # archive (double_path), and its locate's pass 1; the routed
        # ops.migrate_detect on float64 onsets (ops_path)
        "launches": (double_launches["migrate_detect_global_v3_f64"]
                     + double_record["two_pass"]["launches"][
                         "migrate_detect_global_v3_f64"]),
        "max_abs_err": max(double_record["exact"]["max_abs_err"],
                           k3_case["k3_v3_f64"]["max_abs_err"]),
        "max_rel_err": max(double_record["exact"]["max"],
                           k3_case["k3_v3_f64"]["max"]),
        # exp_double.detect_case at the planted window: in turns with K3
        # v2 f64 (its yardstick), K3 f64, K3 v2 and K3
        "ms": k3_case["ms"]["k3_v3_f64"],
        "k3_v2_f64_ms": k3_case["ms"]["k3_v2_f64"],
        "k3_f64_ms": k3_case["ms"]["k3_f64"],
        "f32_ms": k3_case["ms"]["k3_v2"],
        "turns_ms": k3_case["turns_ms"],
        "plain_ms": k3_case["plain_ms"],
        # the contract's bound (FP64 operations at FP64_FLOP_PER_S) and the
        # 8-byte gather floor at the shared-memory rate
        **k3_case["k3_v3_f64_bound"],
        "fp64_flop_per_s": FP64_FLOP_PER_S,
        "library_ms": None,
        "ring": k3_case["v3_ring"],
        "layout": k3_case["layout"],
        "blocks_per_sm": k3_case["v3_blocks_per_sm"],
        **k3_case["k3_v3_f64_resources"],
        "equal_to_k3_v2_f64": {
            "windows": double_record["exact"]["v2_equal"],
            "planted_window": k3_case["v3_equal_to_v2"],
            "f3": f3_k3["v3_equal_to_v2"]},
        "f3": {k: f3_k3[k] for k in (
            "ms", "turns_ms", "plain_ms", "k3_v3_f64", "k3_v3_f64_bound",
            "v3_ring", "layout", "v3_blocks_per_sm",
            "k3_v3_f64_resources")},
        "double_path": {k: v for k, v in double_record.items()
                        if k not in ("k3_case", "m1_case", "m2_case")},
    }, {
        "name": "migrate_detect_global_v2_f64",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_global_v2.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:124",
        # redesigned as K3 v3 f64; since the double route's repair the
        # kernel of layouts of several groups: F3's window through the
        # detector (f3_path), and K3 v3 f64's yardstick at the planted
        # window (its hold and turns)
        "launches": f3_k3["v3_launches"]["migrate_detect_global_v2_f64"],
        "yardstick_launches": k3_case["case_launches"][
            "migrate_detect_global_v2_f64"],
        "f3_launches": f3_k3["case_launches"][
            "migrate_detect_global_v2_f64"],
        "max_abs_err": k3_case["k3_v2_f64"]["max_abs_err"],
        "max_rel_err": k3_case["k3_v2_f64"]["max"],
        "ms": k3_case["ms"]["k3_v2_f64"],
        "f32_ms": k3_case["ms"]["k3_v2"],
        "turns_ms": k3_case["turns_ms"],
        "plain_ms": k3_case["plain_ms"],
        **k3_case["k3_v2_f64_bound"],
        "library_ms": None,
        "f32_bound_ms": k3_case["k3_v2_bound"]["bound_ms"],
        "layout": k3_case["layout"],
        "blocks_per_sm": k3_case["blocks_per_sm"],
        **k3_case["k3_v2_f64_resources"],
        "f3": {"ms": f3_k3["ms"]["k3_v2_f64"],
               "k3_v2_f64": f3_k3["k3_v2_f64"]},
    }, {
        "name": "migrate_detect_global_f64",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_detect_global.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:124",
        # its path: DetectScan's k3 route in float64 on a plan too wide for
        # K3 v2 f64's ring (span_path at 15,000 samples); timed at the
        # double_path window in turns with K3
        "launches": wide_double["launches"],
        "max_abs_err": max(wide_double["exact"]["max_abs_err"],
                           k3_case["k3_f64"]["max_abs_err"]),
        "max_rel_err": max(wide_double["exact"]["max"],
                           k3_case["k3_f64"]["max"]),
        "ms": k3_case["ms"]["k3_f64"],
        "f32_ms": k3_case["ms"]["k3"],
        "plain_ms": k3_case["plain_ms"],
        **k3_case["k3_f64_bound"],
        "library_ms": None,
        "f32_bound_ms": k3_case["k3_bound"]["bound_ms"],
        **k3_case["k3_f64_resources"],
        "wide_span": wide_double,
    }, {
        "name": "migrate_marginalise_ring_f64",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_marginalise_ring.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:291",
        # the main path: QuakeScan(precision="double").locate, pass 2, on
        # K3 v2 f64's tables
        "launches": double_record["two_pass"]["launches"][
            "migrate_marginalise_ring_f64"],
        "max_abs_err": max(ring_m1["max_abs_err"], m1_case["max_abs_err"]),
        "err_of_max": m1_case["err_of_max"],
        # exp_ring.m1_case at locate's window: held to
        # marginalise_ring_reference (plain_ms) and M1 f64, in turns with
        # M1 f64 (m1_ms) and the float32 forms; its bound and gather floor
        # from its own inputs (K3 v2 f64's uint16 entries, exp_ring.bound)
        **{k: ring_m1[k] for k in RING_RECORD_KEYS},
        "f32_ms": m1_case["ms"]["m1_ring_f32"],
        "function_plain_ms": m1_case["plain_ms"],
        "library_ms": None,
        "f3": f3_record["double"]["m1"],
        "f3_two_chunks": f3_record["double"]["m1_chunks"],
    }, {
        "name": "migrate_map_ring_f64",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_marginalise_ring.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:264",
        # the main path: QuakeScan(precision="double",
        # write_coalescence=True).locate, the map path; the routed
        # ops.migrate_map on float64 onsets (ops_path)
        "launches": (double_record["map_path"]["launches"][
            "migrate_map_ring_f64"]
            + ops_record["launches"]["migrate_map_ring_f64"]),
        "max_abs_err": max(ring_m2["max_abs_err"], m2_case["max_abs_err"]),
        "function_max_rel_err": m2_case["max_rel_err"],
        # exp_ring.m2_case at locate's map: held to map_ring_reference, to
        # M2 simple f64 and K3 v2 f64's tmax, in turns with M2 simple f64
        # (m2_simple_ms) and the float32 forms; its own bound
        **{k: ring_m2[k] for k in RING_RECORD_KEYS + (
            "m2_simple_ms", "equal_to_m2_simple", "max_equal_to_k3_v2",
            "nsamples", "output_ms")
           if k not in ("m1_ms", "equal_to_m1", "window")},
        "f32_ms": m2_case["ms"]["m2_ring_f32"],
        "function_plain_ms": m2_case["plain_ms"],
        "library_ms": None,
        "f3": f3_record["double"]["map"],
    }, {
        "name": "migrate_marginalise_f64",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_marginalise.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:291",
        # redesigned as M1 ring f64; its path: locate's pass 2 in double on
        # a plan too wide for K3 v2 f64's ring (span_path at 15,000
        # samples); timed at double_path's window in turns with the ring
        "launches": wide_double["locate"]["launches"][
            "migrate_marginalise_f64"],
        "max_abs_err": max(m1_case["m1_f64_max_abs_err"],
                           wide_double["locate"]["m1_abs_err"]),
        "err_of_max": m1_case["m1_f64_err_of_max"],
        "ms": m1_case["ms"]["m1"],
        "f32_ms": m1_case["ms"]["m1_f32"],
        "turns_ms": ring_m1["turns_ms"],
        "plain_ms": m1_case["plain_ms"],
        # its own inputs: the plan's int32 traveltimes
        **m1_case["m1_f64_bound"],
        "gather_floor_ms": ring_m1["smem_bound_ms"],
        "library_ms": None,
        "f32_bound_ms": m1_case["m1_bound"]["bound_ms"],
        "window": m1_case["window"],
        **m1_case["resources"],
        "wide_span": wide_double["locate"],
    }, {
        "name": "migrate_map_f64",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/migrate_marginalise.cu",
        "replaces": "quakemigrate_tpu/ops/migrate.py:264",
        # redesigned as M2 ring f64; its path: the map in double on a plan
        # too wide for K3 v2 f64's ring (span_path at 15,000 samples);
        # timed at double_path's shapes in turns with the ring
        "launches": wide_double["locate"]["launches"]["migrate_map_f64"],
        "max_abs_err": wide_double["locate"]["map_abs_err"],
        "max_rel_err": m2_case["m2_simple_f64_max_rel_err"],
        "ms": m2_case["ms"]["m2_simple"],
        "f32_ms": m2_case["ms"]["m2_simple_f32"],
        "turns_ms": ring_m2["turns_ms"],
        "plain_ms": m2_case["plain_ms"],
        **m2_case["m2_simple_f64_bound"],
        "gather_floor_ms": ring_m2["smem_bound_ms"],
        "library_ms": None,
        "f32_bound_ms": m2_case["m2_simple_bound"]["bound_ms"],
        "nsamples": m2_case["nsamples"],
        **m2_case["resources"],
        "wide_span": wide_double["locate"],
    }]
    r1_main = next(c for c in r1_record["cases"]
                   if c["shape"] == list(R1_CASES[-1][0])
                   and c["dtype"] == "float32")
    kernels.append({
        "name": "recursive_stalta",
        "route": "cuda",
        "source": "quakemigrate_torch/csrc/recursive_stalta.cu",
        "replaces": "quakemigrate_tpu/ops/stalta.py:84",
        # the main path: core.compat.recursive_sta_lta and
        # ops.recursive_sta_lta on the card (recursive_stalta_path)
        "launches": r1_record["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in r1_record["cases"]),
        **{k: r1_main[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by")},
        "library_ms": None,
        "shape": r1_main["shape"],
        "dtype": "float32",
        "main_path_err": r1_record["main_path_err"],
        "cases": r1_record["cases"],
    })
    # FE1 v2 and FE2 v2: launches on the main path (archive_detect's and
    # kurtosis_detect's QuakeScan.detect), the other paths' beside them;
    # times at the archive window's block (FE1 v2) and kurtosis_detect's
    # (FE2 v2), the other blocks' under "times". FE1 and FE2, their
    # yardstick on no path: their launches over front_end_path, their
    # times in the same turns.
    mesh = archive_record["mesh_path"]
    for name, key, main_record, time_key, paths in (
            ("front_end_stalta", "FE1", archive_record, "stalta archive", {
                "decimate_detect": decimate_record["front_end_launches"],
                "double_detect": double_record["front_end_launches"],
                **{f"mesh_{label}": mesh[label]["front_end_launches"]
                   for label in ("unsharded", "grid4", "batch2x2")}}),
            ("front_end_kurtosis", "FE2", kurtosis_record,
             "kurtosis kurtosis", {})):
        main_time = fe_record["times"][time_key]
        common = {
            "route": "cuda",
            "replaces": ("quakemigrate_tpu/ops/scan_window.py:123"
                         if key == "FE1" else
                         "quakemigrate_tpu/ops/scan_window.py:166"),
            "plain_ms": main_time["plain_ms"],
            **{k: main_time[k] for k in ("bound_ms", "bound_by")},
            "library_ms": None,
            "shapes": fe_record["shapes"],
        }
        kernels.append({
            "name": f"{name}_v2",
            "source": "quakemigrate_torch/csrc/front_end_v2.cu",
            **common,
            "launches": main_record["front_end_launches"][f"{name}_v2"],
            "path_launches": {k: v[f"{name}_v2"] for k, v in paths.items()},
            "max_abs_err": fe_record["max_abs_err"][f"{key} v2"],
            **{k: main_time[k] for k in ("ms", "queued_ms", "device_ms",
                                         "memset_ms", "enqueue_s")},
            "v1_ms": main_time.get("v1_ms"),
            "bit_equal_min": fe_record["bit_equal_min"][f"{key} v2"],
            "holds": {k: v for k, v in fe_record["holds"].items()
                      if k.startswith(key) and k.endswith(" v2")},
            "against_v1": {k: v for k, v in fe_record["v2_vs_v1"].items()
                           if k.startswith(key)},
            "times": {k: v for k, v in fe_record["times"].items()
                      if k.startswith("stalta" if key == "FE1"
                                      else "kurtosis")},
            "resources": {k: v for k, v in fe_record["resources"].items()
                          if k.startswith(f"{key} v2")},
            "window": main_record["front_end_window"],
        })
        kernels.append({
            "name": name,
            "source": "quakemigrate_torch/csrc/front_end.cu",
            **common,
            # the yardstick of FE1 v2 / FE2 v2 on no path: its launches
            # over front_end_path
            "launches": fe_record["v1_launches"][name],
            "max_abs_err": fe_record["max_abs_err"][f"{key} v1"],
            "ms": main_time["v1_ms"],
            "queued_ms": main_time["v1_queued_ms"],
            "device_ms": main_time["v1_device_ms"],
            "enqueue_s": main_time["v1_enqueue_s"],
            "bit_equal_min": fe_record["bit_equal_min"][f"{key} v1"],
            "resources": {k: v for k, v in fe_record["resources"].items()
                          if k.startswith(key) and " v2 " not in k},
        })
    kernels[-4]["card_vs_cpu"] = fe_record["fe1_card_vs_cpu"]
    for name, case in (("migrate_map_persistent", "k1_v2"),
                       ("migrate_map_ring", "k2_v2")):
        kernels[next(i for i, k in enumerate(kernels)
                     if k["name"] == name)]["compat_path"] = (
            compat_record[case])
    kernels[next(i for i, k in enumerate(kernels)
                 if k["name"] == "migrate_marginalise")]["f3"] = (
        f3_record["m1"])
    # ops_path: the routed ops functions' kernels, their launches there
    times = ops_record["times"]
    t32, t64 = times["f32"], times["f64"]
    geometry = {k: ops_record[k] for k in (
        "nodes", "onsets", "windows", "nsamples", "r_span", "batch_f32_s",
        "batch_f64_s")}
    ops_entries = {
        "migrate_detect_global_v2": {
            "ms": t32["k3_v2_ms"], "call_ms": t32["call_ms"],
            "plain_ms": t32["plain_ms"], **t32["bound"],
            "errors": ops_record["detect_f32"], "slab": ops_record["slab"],
            **geometry},
        "migrate_detect_global_v3_f64": {
            "ms": t64["k3_v3_ms"], "call_ms": t64["call_ms"],
            "plain_ms": t64["plain_ms"], **t64["bound"],
            "turns_ms": t64["turns_ms"],
            "equal_to_k3_v2_f64": t64["v3_equal_to_v2"],
            "errors": ops_record["detect_f64"]},
        "migrate_detect_global_v2_f64": {
            "ms": t64["k3_v2_ms"], "turns_ms": t64["turns_ms"],
            "plain_ms": t64["plain_ms"], **t64["bound"]},
        "migrate_detect_global": {
            "ms": times["wide"]["k3_ms"], "icequake_ms": t32["k3_ms"],
            "plain_ms": times["wide"]["plain_ms"], **times["wide"]["bound"],
            "errors": ops_record["wide"]},
        "migrate_detect_global_f64": {
            "ms": times["wide_f64"]["k3_ms"], "icequake_ms": t64["k3_ms"],
            "plain_ms": times["wide_f64"]["plain_ms"],
            **times["wide_f64"]["bound"], "errors": ops_record["wide_f64"]},
        "migrate_map_ring": {
            "ms": t32["map_ms"], "m2_simple_ms": t32["map_simple_ms"],
            "call_ms": t32["map_call_ms"], "plain_ms": t32["map_plain_ms"],
            **t32["map_bound"], "errors": ops_record["map_f32"],
            "ring": t32["map_ring"]},
        "migrate_map_ring_f64": {
            "ms": t64["map_ms"], "m2_simple_f64_ms": t64["map_simple_ms"],
            "call_ms": t64["map_call_ms"], "plain_ms": t64["map_plain_ms"],
            **t64["map_bound"], "errors": ops_record["map_f64"],
            "ring": t64["map_ring"]},
    }
    for name, entry in ops_entries.items():
        kernel = kernels[next(i for i, k in enumerate(kernels)
                              if k["name"] == name)]
        kernel["ops_path_launches"] = ops_record["launches"][name]
        kernel["ops_path"] = entry
    # ON1 v2 and ON2 v2: launches on the main path (archive_locate's and
    # kurtosis_detect's QuakeScan.locate, one a phase), the other paths'
    # beside them; ON1 and ON2, their yardstick on no path: their launches
    # over locate_onsets_path's holds. Times at locate's S phase (v2's and
    # v1's from the same turns), the others under "times"
    on_times = onsets_record["times"]
    double_locate = double_record["two_pass"]["launches"]
    stalta_v2 = "onset_stalta_v2"
    stalta_paths = {
        "map_path": locate_record["map"]["onset_launches"][stalta_v2],
        "plot_path": locate_record["plot"]["launches"].get(stalta_v2, 0),
        "vt_locate_mags": vt_record["launches"][stalta_v2],
        "double_locate": double_locate.get(stalta_v2, 0),
        "double_map": double_record["map_path"]["launches"].get(
            stalta_v2, 0),
        **{f"standard_{v}": standard_record[v]["onset_launches"][stalta_v2]
           for v in ("unfused", "classic")},
        **{f"compat_{f}": compat_record[f]["launches"][stalta_v2]
           for f in ("overlapping_sta_lta", "centred_sta_lta")}}
    for name, key, replaces, main_launches, paths in (
            ("onset_stalta", "ON1", "quakemigrate_tpu/ops/stalta.py:39",
             locate_record["onset_launches"][stalta_v2], stalta_paths),
            ("onset_kurtosis", "ON2", "quakemigrate_tpu/ops/kurtosis.py:69",
             kurtosis_record["locate_launches"]["onset_kurtosis_v2"], {})):
        main_time = on_times[f"{key} locate S"]
        for version in (2, 1):
            tag = f"{key} v{version}"
            kernel_name = name + ("_v2" if version == 2 else "")
            prefix = "" if version == 2 else "v1_"
            entry = {
                "name": kernel_name,
                "route": "cuda",
                "source": ("quakemigrate_torch/csrc/locate_onsets_v2.cu"
                           if version == 2 else
                           "quakemigrate_torch/csrc/locate_onsets.cu"),
                "replaces": replaces,
                **({"also_replaces": "quakemigrate_tpu/ops/stalta.py:57"}
                   if key == "ON1" else {}),
                "launches": (main_launches if version == 2
                             else onsets_record["hold_launches"][name]),
                "hold_launches": onsets_record["hold_launches"][
                    kernel_name],
                "max_abs_err": max(r["max_abs_err"] for label, r in
                                   onsets_record["holds"].items()
                                   if label.startswith(tag + " ")),
                "holds": sum(label.startswith(tag + " ")
                             for label in onsets_record["holds"]),
                "ms": main_time[f"{prefix}ms"],
                "issued_ms": main_time[f"{prefix}issued_ms"],
                "enqueue_s": main_time[f"{prefix}enqueue_s"],
                **{k: main_time[k] for k in (
                    "plain_ms", "turns_ms", "bound_ms", "bound_by",
                    "bytes", "operations", "plain_calls",
                    "plain_enqueue_s")},
                "library_ms": None,
                "times": {k: {kk: v[kk] for kk in (
                    f"{prefix}ms", f"{prefix}issued_ms",
                    f"{prefix}enqueue_s", "plain_ms", "bound_ms",
                    "bound_by")} for k, v in on_times.items()
                    if k.startswith(key + " ")},
                "resources": {k: v for k, v in onsets_record[
                    "resources"].items()
                    if k.startswith(key) and (" v2 " in k) == (
                        version == 2)},
                "samples": onsets_record["samples"],
                "windows": onsets_record["windows"],
            }
            if version == 2:
                entry["path_launches"] = paths
                entry["launches_a_call"] = main_time["launches_a_call"]
                entry["calculate_onsets"] = (
                    locate_record if key == "ON1" else kurtosis_record)[
                    "onsets"]
            else:
                # the yardstick of v2 on no path: its launches over
                # locate_onsets_path's holds
                entry["yardstick_of"] = kernel_name + "_v2"
            kernels.append(entry)
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
