# -*- coding: utf-8 -*-
"""
M1 ring and M2 ring (``csrc/migrate_marginalise_ring.cu``: locate's pass
2 and map on K3 v2's ring of onset windows) on the card beside M1 and M2's
simple form (``csrc/migrate_marginalise.cu``), the kernels they replace on
the routes whose plans K1 v2 does not stage:

- F3 (40 x 40 x 16 nodes at 10 km, 12 stations x P/S at 100 Hz, K3's
  route, ``CudaDetectGlobal`` on K3 v2's tables): M1 ring at a 100-sample
  window and over three chunks (249 samples), M2 ring over 1,000
  samples;
- F1 (the Icequake grid, 256 onsets, K2 v2's route, ``CudaDetectVPU`` on
  the tile-256 plan ``detect_route`` gives it, the ring's own tables):
  M1 ring at 30 samples, M2 ring over 61.

With ``--double``, M1 ring f64 and M2 ring f64 (the same source on
double, ``QuakeScan(precision="double")``'s locate on K3 v2 f64's tables,
``CudaDetectGlobal(dtype=float64)``) beside M1 f64 and M2 simple f64:

- F3 in double: M1 ring f64 at 100 samples and over two chunks (249
  samples), M2 ring f64 over 1,000 samples;
- the Icequake window in double (71 x 64 x 57 nodes, 24 onsets): M1
  ring f64 at 30 samples (locate's window), M2 ring f64 over 61.

On the Icequake window it also times the ring at each other depth K3 v2
f64's layout holds (2 up to its 4 stages; ``cm.ring_stages`` patched for
the call, :func:`at_depth`), in turns with the rest, each held bit for
bit to the ring at its own depth.

Each case holds the ring kernel to its plain version on the same tables
(``marginalise_ring_reference``, ``map_ring_reference``: within 1e-5 of
each value, 1e-12 in float64) and to the old kernel: M1 (M1 f64) bit for
bit at a window of one chunk (124 samples or fewer, 128 in float64),
within 1e-6 relative beyond (1e-12); M2 simple (M2 simple f64) bit for
bit, and, on K3 v2's tables, the map's per-sample max K3 v2's (K3 v2
f64's) tmax bit for bit. Then the two are timed in turns with the ring's other grid (its
passes split over blocks or not, the other of ``ring_split``'s choice),
held equal to it (ring,
old, other, other, old, ring; CUDA events, ``reps`` launches a turn),
the kernels' own device time beside each (torch.profiler's CUDA
activity: CUDA events around a loop of launches also count the host's
enqueue, which a kernel of tens of microseconds does not hide), with the
bound (the bytes the function must
move, inputs read once and outputs written once, at 3.35 TB/s, against
O adds and 3 more operations a real node and sample at 67 TFLOP/s, at
34 TFLOP/s in float64), the gather floor (real nodes x O x samples 4-byte
reads, 8-byte in float64, at 33.5 TB/s), the ring, blocks per SM,
ptxas's registers and spills, and F1's table build time and bytes.
Requires CUDA; exits non-zero without it.

    python3 -m quakemigrate_torch.experiments.exp_ring [--double]

"""

import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from quakemigrate_torch import _build
from quakemigrate_torch.experiments import exp_global_v2
from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
from quakemigrate_torch.experiments.workload import workload
from quakemigrate_torch.ops import cuda_migrate as cm

REPS = 20
# The ring kernels against their plain versions (the same sums; exp and
# torch.exp may differ in the last place), and M1 ring against M1 beyond
# one chunk (the chunks group the samples otherwise), per element type
RING_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
M1_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}
# Mangled name of the ring kernels (their ptxas report), and the
# template argument of each element type in it
KERNEL = "qm_ring_kernel"
TYPE_CODE = {torch.float32: "f", torch.float64: "d"}
HBM_BYTES_PER_S = exp_global_v2.HBM_BYTES_PER_S
SMEM_BYTES_PER_S = exp_global_v2.SMEM_BYTES_PER_S
FP32_FLOP_PER_S = exp_global_v2.FP32_FLOP_PER_S
# The H100 SXM's float64 rate outside the tensor cores (data sheet)
FP64_FLOP_PER_S = 34e12
F64 = torch.float64

F3_WINDOW = (450, 100)
# 249 samples from a start of residue 1 mod 4: three chunks of M1 ring's
# 124 (the last of one sample), two of M1 ring f64's 128
F3_CHUNKS_WINDOW = (37, 249)
F1_FSMP, F1_NSAMPLES, F1_MAP_NSAMPLES, F1_WINDOW = 413, 625, 61, (100, 30)
# The Icequake window in double: locate's pass 2 window and map
ICE_FSMP, ICE_WINDOW, ICE_MAP_NSAMPLES = 413, (15, 30), 61


def setup(detector, onsets_log, inv, label):
    """A case: a detector of the "k3" or "k2_v2" route whose plan the
    ring takes, and its prepared onsets on the card."""

    check(detector.ring_refusal is None,
          f"{label}: the ring refuses the plan ({detector.ring_refusal})")
    return SimpleNamespace(det=detector, onsets_log=onsets_log, inv=inv,
                           label=label, tables=detector.ring_tables())


def check(cond, msg):
    if not cond:
        raise SystemExit(f"exp_ring: FAILED: {msg}")


def m1_ring(s, start, length, split=None):
    d = s.det
    return lambda: cm.migrate_marginalise_ring_cuda(
        s.onsets_log, d.base, s.inv, d.fsmp, d.nsamples, start, length,
        d.n_nodes, s.tables, d._max_shift, split)


def m1(s, start, length):
    d = s.det
    return lambda: cm.migrate_marginalise_cuda(
        s.onsets_log, d.base, d.fine, d.valid, d.perm, s.inv, d.fsmp,
        d.nsamples, start, length, d.n_nodes, d._max_shift)


def m2_ring(s, split=None):
    d = s.det
    return lambda: cm.migrate_map_ring_cuda(
        s.onsets_log, d.base, s.inv, d.fsmp, d.nsamples, d.n_nodes,
        s.tables, d._max_shift, split)


def real_nodes(s, device):
    """The flat indices of the plan's real nodes, the rows the ring
    kernels write."""

    plan = s.det.plan
    return torch.from_numpy(np.unique(
        plan.perm[plan.valid.ravel() > 0]).astype(np.int64)).to(device)


def at_depth(fn, n_stages):
    """``fn`` with the ring kernels ``n_stages`` deep: ``cm.ring_stages``
    patched for the call, so the wrappers' checks, split and launch
    follow that depth. For the depth sweep only."""

    def call():
        keep = cm.ring_stages
        cm.ring_stages = lambda layout: n_stages
        try:
            return fn()
        finally:
            cm.ring_stages = keep
    return call


def depth_sweep(s, make, length, map_=False):
    """The ring ``make()`` at each depth the case's layout holds but the
    one the wrappers run (:func:`cm.ring_stages`), each held bit for bit
    to it on the real nodes: ({"ring_d<n>": fn}, {n: blocks per SM})."""

    layout = s.tables.layout
    want = make()()
    nodes = real_nodes(s, want.device)
    fns, blocks = {}, {}
    for n in cm.GLOBAL_V2_STAGES:
        if n > layout.n_stages or n == cm.ring_stages(layout):
            continue
        fn = at_depth(make(), n)
        check(bool(torch.equal(fn()[nodes], want[nodes])),
              f"{s.label}: the ring differs at {n} stages")
        fns[f"ring_d{n}"] = fn
        blocks[n] = at_depth(lambda: cm.ring_blocks_per_sm(
            layout, length, map_), n)()
    return fns, blocks


def m2_simple(s):
    d = s.det
    return lambda: cm.migrate_map_cuda(
        s.onsets_log, d.base, d.fine, d.valid, d.perm, s.inv, d.fsmp,
        d.nsamples, d.n_nodes, d._max_shift)


def device_ms(fn, reps=REPS):
    """The device time of ``fn()``'s hand kernels (names holding "qm_")
    per call, from torch.profiler's CUDA activity over ``reps`` calls
    after one warm-up call: the kernels alone, without the host's enqueue
    between launches that CUDA events around a loop of small kernels
    also count. None where the profiler records no device time."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in device if "qm_" in e.name)
    if us <= 0:
        print(f"exp_ring: no qm_ kernel among the profiler's "
              f"{len(device)} device events "
              f"{sorted({e.name for e in device})[:8]}")
        return None
    return us / reps / 1e3


def bound(s, length, map_=False):
    """The bound of the ring kernels' function at ``length`` samples: the
    bytes each input read once (the uint16 residual entries of the real
    nodes, ``base``, their flat indices, the windows' table, of each
    onset row the columns from its least traveltime to its largest plus
    the samples, inv_available) and the output written once ([n_nodes],
    or [n_nodes, length] for the map) at the memory rate, against O adds
    and 3 more operations (scale, exp, sum or store) a real node and
    sample at the float32 rate (float64's in float64); and the gather
    floor, the real nodes x O x samples reads of the element at the
    shared-memory rate."""

    item = s.det.dtype.itemsize
    rate = FP64_FLOP_PER_S if item == 8 else FP32_FLOP_PER_S
    plan = s.det.plan
    live = plan.valid > 0
    n_real = int(live.sum())
    n_onsets = plan.n_onsets
    tt = np.where(live[:, None, :], plan.base[:, :, None] + plan.fine,
                  0).astype(np.int64)
    lo = np.where(live[:, None, :], tt, np.iinfo(np.int64).max).min(
        axis=(0, 2))
    hi = tt.max(axis=(0, 2))
    columns = int((hi - lo + length).sum())
    out = item * plan.n_nodes * (length if map_ else 1)
    nbytes = (2 * n_real * n_onsets + 4 * plan.n_tiles * n_onsets
              + 4 * n_real + 8 * n_onsets + item * columns + item + out)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_real * length * (n_onsets + 3) / rate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "smem_bound_ms": (item * n_real * n_onsets * length
                              / SMEM_BYTES_PER_S * 1e3),
            "output_ms": out / HBM_BYTES_PER_S * 1e3}


def resources(shape, slots, map_, dtype=torch.float32):
    """ptxas's registers and spills of the ring kernel at ``shape``, k
    slots, form and element type (the blocks per SM it is built for:
    :func:`cm.ring_shapes`, one at 4 k slots in float64)."""

    (w, npp), minb = shape, cm.ring_shapes(dtype)[shape]
    if dtype == F64 and slots == 4:
        minb = 1
    tag = (f"ILi{w}ELi{npp}ELi{minb}ELi{slots}ELb{int(map_)}E"
           f"{TYPE_CODE[dtype]}E")
    found = [v for name, v in _build.kernel_resources(KERNEL).items()
             if tag in name]
    check(len(found) == 1, f"no ptxas report for {tag}")
    return {k: found[0][k] for k in ("registers", "spill_stores",
                                     "spill_loads")}


def ring_record(s, length, map_):
    layout = s.tables.layout
    return {"shape": list(layout.shape), "group": layout.group,
            "n_stages": cm.ring_stages(layout),
            "layout_n_stages": layout.n_stages,
            "stage_floats": layout.stage_floats,
            "smem": cm.ring_smem(layout),
            "blocks_per_sm": cm.ring_blocks_per_sm(layout, length, map_),
            "passes": int(s.tables.res.shape[1]),
            "dtype": str(layout.dtype).replace("torch.", ""),
            **resources(layout.shape, cm.ring_slots(length), map_,
                        layout.dtype)}


def m1_case(s, window, reps=REPS, extra=None):
    """M1 ring (M1 ring f64 on float64 tables) at ``window`` (start,
    length) on the case: held to its plain version and to M1 (M1 f64),
    timed in turns with M1, the other grid and ``extra`` ({name: fn},
    not held here). Returns a record."""

    start, length = window
    d = s.det
    dtype = s.tables.layout.dtype
    chunk = cm.ring_chunk(dtype)
    split = cm.ring_split(s.tables.layout, d.plan.n_onsets)
    ring, old = m1_ring(s, start, length), m1(s, start, length)
    other = m1_ring(s, start, length, not split)
    extra = extra or {}
    cm.reset_launches()
    got = ring()
    torch.cuda.synchronize()
    key = cm.typed("migrate_marginalise_ring", dtype)
    check(cm.launches[key] == 1,
          f"{s.label}: M1 ring did not launch ({cm.launches})")
    ref = cm.marginalise_ring_reference(
        s.onsets_log, d.base, s.inv, d.fsmp, start, length, d.n_nodes,
        s.tables)
    v1, v2 = old(), other()
    torch.cuda.synchronize()
    nodes = real_nodes(s, got.device)
    got, ref, v1, v2 = got[nodes], ref[nodes], v1[nodes], v2[nodes]
    rel = float(((got - ref).abs() / ref.abs()).max())
    equal = bool(torch.equal(got, v1))
    check(bool(torch.equal(got, v2)), f"{s.label}: M1 ring differs with "
          "and without its passes on the grid")
    rel_v1 = float(((got - v1).abs() / v1.abs()).max())
    one_chunk = length <= chunk
    check(bool(torch.isfinite(got).all()) and got.dtype == dtype
          and rel <= RING_RTOL[dtype],
          f"{s.label}: M1 ring {rel} from its plain version")
    check(equal if one_chunk else rel_v1 <= M1_RTOL[dtype],
          f"{s.label}: M1 ring against M1: equal {equal}, {rel_v1}")
    fns = {"ring": ring, "m1": old, "ring_other": other, **extra}
    turns = ekb.in_turns(fns, reps)
    kernel_ms = {name: device_ms(fn, reps) for name, fn in fns.items()}
    plain_ms = ekb.cuda_ms(lambda: cm.marginalise_ring_reference(
        s.onsets_log, d.base, s.inv, d.fsmp, start, length, d.n_nodes,
        s.tables), reps=1, warmup=0)
    rec = {"window": [start, length], "onsets": d.plan.n_onsets,
           "nodes": d.n_nodes, "tile": d.tile,
           "ms": float(np.mean(turns["ring"])),
           "m1_ms": float(np.mean(turns["m1"])),
           "other_split_ms": float(np.mean(turns["ring_other"])),
           "extra_ms": {name: float(np.mean(turns[name]))
                        for name in extra},
           "split": split, "turns_ms": turns,
           "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "max_rel_err": rel,
           "max_abs_err": float((got - ref).abs().max()),
           "equal_to_m1": equal, "max_rel_diff_m1": rel_v1,
           **bound(s, length), **ring_record(s, length, False)}
    print(f"exp_ring {s.label} M1 ring at {length} samples from {start}: "
          f"in turns {turns['ring'][0]:.4f} / {turns['ring'][1]:.4f} ms, "
          f"M1 {turns['m1'][0]:.4f} / {turns['m1'][1]:.4f} ms, the ring "
          f"with split={not split} {turns['ring_other'][0]:.4f} / "
          f"{turns['ring_other'][1]:.4f} ms, {rec['extra_ms']} (plain "
          f"{plain_ms:.4f}); the kernels alone (profiler) {kernel_ms}; "
          f"bound {rec['bound_ms']:.4f} by "
          f"{rec['bound_by']}, gather floor {rec['smem_bound_ms']:.4f}; "
          f"{rel:.2e} from its plain version, equal to M1 {equal} "
          f"({rel_v1:.2e}); ring {ring_record(s, length, False)}")
    return rec


def m2_case(s, reps=REPS, tmax=None, extra=None):
    """M2 ring (M2 ring f64 on float64 tables) over the case's scan: held
    to its plain version, to M2's simple form (M2 simple f64) bit for bit
    and, given K3 v2's (K3 v2 f64's) combined ``tmax``, its per-sample max
    to it bit for bit; timed in turns with M2 simple, the other grid and
    ``extra`` ({name: fn}, not held here). Returns a record."""

    d = s.det
    dtype = s.tables.layout.dtype
    split = cm.ring_split(s.tables.layout, d.plan.n_onsets)
    ring, old = m2_ring(s), m2_simple(s)
    other = m2_ring(s, not split)
    extra = extra or {}
    cm.reset_launches()
    got = ring()
    torch.cuda.synchronize()
    key = cm.typed("migrate_map_ring", dtype)
    check(cm.launches[key] == 1,
          f"{s.label}: M2 ring did not launch ({cm.launches})")
    ref = cm.map_ring_reference(s.onsets_log, d.base, s.inv, d.fsmp,
                                d.nsamples, d.n_nodes, s.tables)
    nodes = real_nodes(s, got.device)
    rel = float(((got[nodes] - ref[nodes]).abs() / ref[nodes].abs()).max())
    abs_err = float((got[nodes] - ref[nodes]).abs().max())
    del ref
    simple = old()
    torch.cuda.synchronize()
    equal = bool(torch.equal(got[nodes], simple[nodes]))
    del simple
    check(bool(torch.equal(got[nodes], other()[nodes])),
          f"{s.label}: M2 ring differs with and without its passes on the "
          "grid")
    max_equal = (None if tmax is None
                 else bool(torch.equal(got.max(dim=0).values, tmax)))
    check(bool(torch.isfinite(got[nodes]).all()) and got.dtype == dtype
          and rel <= RING_RTOL[dtype] and equal and max_equal is not False,
          f"{s.label}: M2 ring {rel} from its plain version, equal to M2 "
          f"simple {equal}, max equal to K3 v2's tmax {max_equal}")
    del got
    torch.cuda.empty_cache()
    fns = {"ring": ring, "m2_simple": old, "ring_other": other, **extra}
    turns = ekb.in_turns(fns, reps)
    kernel_ms = {name: device_ms(fn, reps) for name, fn in fns.items()}
    plain_ms = ekb.cuda_ms(lambda: cm.map_ring_reference(
        s.onsets_log, d.base, s.inv, d.fsmp, d.nsamples, d.n_nodes,
        s.tables), reps=1, warmup=0)
    rec = {"nsamples": d.nsamples, "onsets": d.plan.n_onsets,
           "nodes": d.n_nodes, "tile": d.tile,
           "ms": float(np.mean(turns["ring"])),
           "m2_simple_ms": float(np.mean(turns["m2_simple"])),
           "other_split_ms": float(np.mean(turns["ring_other"])),
           "extra_ms": {name: float(np.mean(turns[name]))
                        for name in extra},
           "split": split, "kernel_ms": kernel_ms,
           "turns_ms": turns, "plain_ms": plain_ms, "max_rel_err": rel,
           "max_abs_err": abs_err, "equal_to_m2_simple": equal,
           "max_equal_to_k3_v2": max_equal,
           **bound(s, d.nsamples, map_=True),
           **ring_record(s, d.nsamples, True)}
    print(f"exp_ring {s.label} M2 ring over {d.nsamples} samples: in turns "
          f"{turns['ring'][0]:.4f} / {turns['ring'][1]:.4f} ms, M2 simple "
          f"{turns['m2_simple'][0]:.4f} / {turns['m2_simple'][1]:.4f} ms, "
          f"the ring with split={not split} "
          f"{turns['ring_other'][0]:.4f} / {turns['ring_other'][1]:.4f} ms, "
          f"{rec['extra_ms']} (plain {plain_ms:.4f}); the kernels alone (profiler) "
          f"{kernel_ms}; bound {rec['bound_ms']:.4f} by "
          f"{rec['bound_by']} (output {rec['output_ms']:.4f}), gather floor "
          f"{rec['smem_bound_ms']:.4f}; {rel:.2e} from its plain version, "
          f"equal to M2 simple {equal}, max equal to K3 v2's tmax "
          f"{max_equal}; ring {ring_record(s, d.nsamples, True)}")
    return rec


def k3_tmax(s):
    """K3 v2's per-sample max on the case's detector (its tables), the
    reference of M2 ring's max; in float64 the route's K3 v3 f64, whose
    max is K3 v2 f64's bit for bit."""

    return cm.combine_brick_tiles(*s.det.launch(s.onsets_log, s.inv))[0]


def f3_case(device, dtype=torch.float32):
    """F3 on K3's route: CudaDetectGlobal on the plan (K3 v2's tables, K3
    v2 f64's in float64) and seeded gamma onsets in ``dtype``."""

    rng = np.random.default_rng(2032)
    tt = exp_global_v2.f3_traveltimes(rng)
    g = exp_global_v2.setup(tt, exp_global_v2.F3_NODES,
                            exp_global_v2.F3_FSMP, exp_global_v2.F3_NSAMPLES,
                            device, rng)
    det = cm.CudaDetectGlobal(tt, g.node_count, g.fsmp, g.nsamples, device,
                              plan=g.plan, dtype=dtype)
    label = "f3" if dtype == torch.float32 else "f3 f64"
    return setup(det, g.onsets_log.to(dtype), g.inv.to(dtype), label)


def icequake_f64_case(device, nsamples, plan=None):
    """The Icequake window in double (``workload``: 71 x 64 x 57 nodes, 24
    onsets) on the "k3" route of ``precision="double"``:
    CudaDetectGlobal(dtype=float64) on the plan (``plan``, or built), its
    K3 v2 f64 tables, the onsets in float64."""

    dims, tt, onsets = workload(nsamples, fsmp=ICE_FSMP)
    det = cm.CudaDetectGlobal(tt, dims, ICE_FSMP, nsamples, device,
                              plan=plan or cm.DetectPlan(tt, dims),
                              dtype=F64)
    onsets_log = torch.from_numpy(
        np.log(np.clip(onsets.astype(np.float64), 0.01, None))).to(device)
    inv = torch.full((1,), 1.0 / onsets.shape[0], dtype=F64, device=device)
    return setup(det, onsets_log, inv, "icequake f64")


def f1_case(device, nsamples, plan=None):
    """F1 on K2 v2's route: the Icequake grid with 256 onsets
    (``workload``), CudaDetectVPU on the tile-256 plan (``plan``, or
    built), the ring's tables built at the first call (its build seconds
    and bytes on ``tables``)."""

    dims, tt, onsets = workload(nsamples, n_onsets=256, fsmp=F1_FSMP)
    det = cm.CudaDetectVPU(tt, dims, F1_FSMP, nsamples, device,
                           plan=plan or cm.DetectPlan(tt, dims))
    onsets_log = torch.from_numpy(
        np.log(np.clip(onsets, 0.01, None))).to(device)
    inv = torch.full((1,), 1.0 / 256, dtype=torch.float32, device=device)
    return setup(det, onsets_log, inv, "f1")


def run_double(device):
    """The float64 cases: F3 and the Icequake window in double."""

    f3 = f3_case(device, F64)
    records = {"f3_m1_f64": m1_case(f3, F3_WINDOW),
               "f3_m1_f64_chunks": m1_case(f3, F3_CHUNKS_WINDOW, reps=5),
               "f3_m2_f64": m2_case(f3, reps=10, tmax=k3_tmax(f3))}
    del f3
    torch.cuda.empty_cache()
    ice = icequake_f64_case(device, ICE_MAP_NSAMPLES)
    depths, blocks = depth_sweep(ice, lambda: m1_ring(ice, *ICE_WINDOW),
                                 ICE_WINDOW[1])
    records["icequake_m1_f64"] = m1_case(ice, ICE_WINDOW, extra=depths)
    records["icequake_m1_f64"]["blocks_per_sm_by_depth"] = blocks
    depths, blocks = depth_sweep(ice, lambda: m2_ring(ice),
                                 ICE_MAP_NSAMPLES, map_=True)
    records["icequake_m2_f64"] = m2_case(ice, reps=10, tmax=k3_tmax(ice),
                                         extra=depths)
    records["icequake_m2_f64"]["blocks_per_sm_by_depth"] = blocks
    print(f"exp_ring icequake f64: blocks per SM at the other depths, M1 "
          f"ring f64 {records['icequake_m1_f64']['blocks_per_sm_by_depth']}"
          f", M2 ring f64 "
          f"{records['icequake_m2_f64']['blocks_per_sm_by_depth']}")
    return records


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("exp_ring: CUDA is not available")
    _build.load_library()
    device = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    if "--double" in argv:
        return run_double(device)
    f3 = f3_case(device)
    records = {"f3_m1": m1_case(f3, F3_WINDOW),
               "f3_m1_chunks": m1_case(f3, F3_CHUNKS_WINDOW, reps=5),
               "f3_m2": m2_case(f3, reps=10, tmax=k3_tmax(f3))}
    del f3
    t0 = time.perf_counter()
    f1 = f1_case(device, F1_NSAMPLES)
    print(f"exp_ring f1: plan, detector and ring tables in "
          f"{time.perf_counter() - t0:.3f} s, the ring tables in "
          f"{f1.tables.build_s:.3f} s ({f1.tables.nbytes} bytes on the "
          f"card)")
    records["f1_m1"] = m1_case(f1, F1_WINDOW)
    plan = f1.det.plan
    del f1
    torch.cuda.empty_cache()
    records["f1_m2"] = m2_case(f1_case(device, F1_MAP_NSAMPLES, plan),
                               reps=10)
    return records


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
