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

Each case holds the ring kernel to its plain version on the same tables
(``marginalise_ring_reference``, ``map_ring_reference``: within 1e-5 of
each value) and to the old kernel: M1 bit for bit at a window of one chunk
(124 samples or fewer), within 1e-6 relative beyond; M2 simple bit for
bit, and, on K3 v2's tables, the map's per-sample max K3 v2's tmax bit for
bit. Then the two are timed in turns with the ring's other grid (its
passes split over blocks or not, the other of ``ring_split``'s choice),
held equal to it (ring,
old, other, other, old, ring; CUDA events, ``reps`` launches a turn),
the kernels' own device time beside each (torch.profiler's CUDA
activity: CUDA events around a loop of launches also count the host's
enqueue, which a kernel of tens of microseconds does not hide), with the
bound (the bytes the function must
move, inputs read once and outputs written once, at 3.35 TB/s, against
O adds and 3 more operations a real node and sample at 67 TFLOP/s), the
gather floor (real nodes x O x samples 4-byte reads at 33.5 TB/s), the
ring, blocks per SM, ptxas's registers and spills, and F1's table build
time and bytes. Requires CUDA; exits non-zero without it.

    python3 -m quakemigrate_torch.experiments.exp_ring

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
# one chunk (the chunks group the samples otherwise)
RING_RTOL = 1e-5
M1_RTOL = 1e-6
# Mangled name of the ring kernels (their ptxas report)
KERNEL = "qm_ring_kernel"
HBM_BYTES_PER_S = exp_global_v2.HBM_BYTES_PER_S
SMEM_BYTES_PER_S = exp_global_v2.SMEM_BYTES_PER_S
FP32_FLOP_PER_S = exp_global_v2.FP32_FLOP_PER_S

F3_WINDOW = (450, 100)
# Three chunks of M1 ring from a start of residue 1 mod 4
F3_CHUNKS_WINDOW = (37, 2 * cm.RING_CHUNK + 1)
F1_FSMP, F1_NSAMPLES, F1_MAP_NSAMPLES, F1_WINDOW = 413, 625, 61, (100, 30)


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
    onset row the f32 columns from its least traveltime to its largest
    plus the samples, inv_available) and the output written once (f32
    [n_nodes], or [n_nodes, length] for the map) at the memory rate,
    against O adds and 3 more operations (scale, exp, sum or store) a
    real node and sample at the float32 rate; and the gather floor, the
    real nodes x O x samples 4-byte reads at the shared-memory rate."""

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
    out = 4 * plan.n_nodes * (length if map_ else 1)
    nbytes = (2 * n_real * n_onsets + 4 * plan.n_tiles * n_onsets
              + 4 * n_real + 8 * n_onsets + 4 * columns + 4 + out)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_real * length * (n_onsets + 3) / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "smem_bound_ms": (4 * n_real * n_onsets * length
                              / SMEM_BYTES_PER_S * 1e3),
            "output_ms": out / HBM_BYTES_PER_S * 1e3}


def resources(shape, slots, map_):
    """ptxas's registers and spills of the ring kernel at ``shape``, k
    slots and form."""

    (w, npp), minb = shape, cm.RING_SHAPES[shape]
    tag = f"ILi{w}ELi{npp}ELi{minb}ELi{slots}ELb{int(map_)}E"
    found = [v for name, v in _build.kernel_resources(KERNEL).items()
             if tag in name]
    check(len(found) == 1, f"no ptxas report for {tag}")
    return {k: found[0][k] for k in ("registers", "spill_stores",
                                     "spill_loads")}


def ring_record(s, length, map_):
    layout = s.tables.layout
    return {"shape": list(layout.shape), "group": layout.group,
            "n_stages": layout.n_stages, "stage_floats": layout.stage_floats,
            "smem": cm.ring_smem(layout),
            "blocks_per_sm": cm.ring_blocks_per_sm(layout, length, map_),
            "passes": int(s.tables.res.shape[1]),
            **resources(layout.shape, cm.ring_slots(length), map_)}


def m1_case(s, window, reps=REPS):
    """M1 ring at ``window`` (start, length) on the case: held to its
    plain version and to M1, timed in turns with M1. Returns a record."""

    start, length = window
    d = s.det
    split = cm.ring_split(s.tables.layout, d.plan.n_onsets)
    ring, old = m1_ring(s, start, length), m1(s, start, length)
    other = m1_ring(s, start, length, not split)
    cm.reset_launches()
    got = ring()
    torch.cuda.synchronize()
    check(cm.launches["migrate_marginalise_ring"] == 1,
          f"{s.label}: M1 ring did not launch ({cm.launches})")
    ref = cm.marginalise_ring_reference(
        s.onsets_log, d.base, s.inv, d.fsmp, start, length, d.n_nodes,
        s.tables)
    v1, v2 = old(), other()
    torch.cuda.synchronize()
    nodes = torch.from_numpy(np.flatnonzero(np.isin(
        np.arange(d.n_nodes), d.plan.perm[d.plan.valid.ravel() > 0]))).to(
            got.device)
    got, ref, v1, v2 = got[nodes], ref[nodes], v1[nodes], v2[nodes]
    rel = float(((got - ref).abs() / ref.abs()).max())
    equal = bool(torch.equal(got, v1))
    check(bool(torch.equal(got, v2)), f"{s.label}: M1 ring differs with "
          "and without its passes on the grid")
    rel_v1 = float(((got - v1).abs() / v1.abs()).max())
    one_chunk = length <= cm.RING_CHUNK
    check(bool(torch.isfinite(got).all()) and rel <= RING_RTOL,
          f"{s.label}: M1 ring {rel} from its plain version")
    check(equal if one_chunk else rel_v1 <= M1_RTOL,
          f"{s.label}: M1 ring against M1: equal {equal}, {rel_v1}")
    turns = ekb.in_turns({"ring": ring, "m1": old, "ring_other": other},
                         reps)
    kernel_ms = {name: device_ms(fn, reps) for name, fn in (
        ("ring", ring), ("m1", old), ("ring_other", other))}
    plain_ms = ekb.cuda_ms(lambda: cm.marginalise_ring_reference(
        s.onsets_log, d.base, s.inv, d.fsmp, start, length, d.n_nodes,
        s.tables), reps=1, warmup=0)
    rec = {"window": [start, length], "onsets": d.plan.n_onsets,
           "nodes": d.n_nodes, "tile": d.tile,
           "ms": float(np.mean(turns["ring"])),
           "m1_ms": float(np.mean(turns["m1"])),
           "other_split_ms": float(np.mean(turns["ring_other"])),
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
          f"{turns['ring_other'][1]:.4f} ms (plain "
          f"{plain_ms:.4f}); the kernels alone (profiler) {kernel_ms}; "
          f"bound {rec['bound_ms']:.4f} by "
          f"{rec['bound_by']}, gather floor {rec['smem_bound_ms']:.4f}; "
          f"{rel:.2e} from its plain version, equal to M1 {equal} "
          f"({rel_v1:.2e}); ring {ring_record(s, length, False)}")
    return rec


def m2_case(s, reps=REPS, tmax=None):
    """M2 ring over the case's scan: held to its plain version, to M2's
    simple form bit for bit and, given K3 v2's combined ``tmax``, its
    per-sample max to it bit for bit; timed in turns with M2 simple.
    Returns a record."""

    d = s.det
    split = cm.ring_split(s.tables.layout, d.plan.n_onsets)
    ring, old = m2_ring(s), m2_simple(s)
    other = m2_ring(s, not split)
    cm.reset_launches()
    got = ring()
    torch.cuda.synchronize()
    check(cm.launches["migrate_map_ring"] == 1,
          f"{s.label}: M2 ring did not launch ({cm.launches})")
    ref = cm.map_ring_reference(s.onsets_log, d.base, s.inv, d.fsmp,
                                d.nsamples, d.n_nodes, s.tables)
    nodes = torch.from_numpy(np.unique(
        d.plan.perm[d.plan.valid.ravel() > 0]).astype(np.int64)).to(
            got.device)
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
    check(bool(torch.isfinite(got[nodes]).all()) and rel <= RING_RTOL
          and equal and max_equal is not False,
          f"{s.label}: M2 ring {rel} from its plain version, equal to M2 "
          f"simple {equal}, max equal to K3 v2's tmax {max_equal}")
    del got
    torch.cuda.empty_cache()
    turns = ekb.in_turns({"ring": ring, "m2_simple": old,
                          "ring_other": other}, reps)
    kernel_ms = {name: device_ms(fn, reps) for name, fn in (
        ("ring", ring), ("m2_simple", old), ("ring_other", other))}
    plain_ms = ekb.cuda_ms(lambda: cm.map_ring_reference(
        s.onsets_log, d.base, s.inv, d.fsmp, d.nsamples, d.n_nodes,
        s.tables), reps=1, warmup=0)
    rec = {"nsamples": d.nsamples, "onsets": d.plan.n_onsets,
           "nodes": d.n_nodes, "tile": d.tile,
           "ms": float(np.mean(turns["ring"])),
           "m2_simple_ms": float(np.mean(turns["m2_simple"])),
           "other_split_ms": float(np.mean(turns["ring_other"])),
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
          f"{turns['ring_other'][0]:.4f} / {turns['ring_other'][1]:.4f} ms "
          f"(plain {plain_ms:.4f}); the kernels alone (profiler) "
          f"{kernel_ms}; bound {rec['bound_ms']:.4f} by "
          f"{rec['bound_by']} (output {rec['output_ms']:.4f}), gather floor "
          f"{rec['smem_bound_ms']:.4f}; {rel:.2e} from its plain version, "
          f"equal to M2 simple {equal}, max equal to K3 v2's tmax "
          f"{max_equal}; ring {ring_record(s, d.nsamples, True)}")
    return rec


def k3_tmax(s):
    """K3 v2's per-sample max on the case's detector (its tables), the
    reference of M2 ring's max."""

    return cm.combine_brick_tiles(*s.det.launch(s.onsets_log, s.inv))[0]


def f3_case(device):
    """F3 on K3's route: CudaDetectGlobal on the plan (K3 v2's tables) and
    seeded gamma onsets."""

    rng = np.random.default_rng(2032)
    tt = exp_global_v2.f3_traveltimes(rng)
    g = exp_global_v2.setup(tt, exp_global_v2.F3_NODES,
                            exp_global_v2.F3_FSMP, exp_global_v2.F3_NSAMPLES,
                            device, rng)
    det = cm.CudaDetectGlobal(tt, g.node_count, g.fsmp, g.nsamples, device,
                              plan=g.plan)
    return setup(det, g.onsets_log, g.inv, "f3")


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


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("exp_ring: CUDA is not available")
    _build.load_library()
    device = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
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
