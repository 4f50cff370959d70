# -*- coding: utf-8 -*-
"""
K3 v2, K3's detect reduction on the brick plan with the onset windows
streamed through an mbarrier ring (``csrc/migrate_detect_global_v2.cu``),
on the card beside K3 (``csrc/migrate_detect_global.cu``), at the F3
geometry (40 x 40 x 16 nodes at 10 km, 12 surface stations x P/S at 100
Hz, 1,000 samples: a residual span of ~3,000 samples that no staged
kernel takes) and at the Icequake window (71 x 64 x 57 nodes, 24 onsets,
625 samples), with K1 v2 beside them there.

Each case holds K3 v2, combined over its brick tiles, to the plain
version with the kernels' arithmetic (``detect_reduce_flat_reference``,
combined over its flat tiles): the max bit for bit, the argmax equal to
the first flat argmax at every sample, the sum within 1e-4; and to K3:
the max and the argmax bit for bit. Then K3 v2 and K3 (and K1 v2 at
Icequake) are timed in turns, with K3 v2's bound and gather floor, ring
layout, shared memory, blocks per SM, registers and spills. ``--sweep``
also times every shape at every onsets-a-stage G that fits, each held to
the plain version. Times are CUDA-event milliseconds per launch.
Requires CUDA; exits non-zero without it.

    python3 -m quakemigrate_torch.experiments.exp_global_v2 [--sweep]

"""

import argparse
import sys
from types import SimpleNamespace

import numpy as np
import torch

from quakemigrate_torch import _build
from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
from quakemigrate_torch.experiments.workload import workload
from quakemigrate_torch.lut import traveltime_table
from quakemigrate_torch.ops import cuda_migrate as cm

REPS = 20
SUM_RTOL = 1e-4
# Mangled name of K3 v2's kernels (their ptxas report)
KERNEL = "qm_global_v2_kernel"
# The card's rates of the bound: device memory, shared memory (132 SMs x
# 128 bytes a clock at 1.98 GHz) and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SMEM_BYTES_PER_S = 33.5e12
FP32_FLOP_PER_S = 67e12

# The F3 geometry: a coarse regional grid at 100 Hz
F3_NODES, F3_SPACING_KM, F3_RATE = (40, 40, 16), 10.0, 100
F3_VP, F3_VS, F3_STATIONS = 6.0, 3.46, 12
F3_FSMP, F3_NSAMPLES = 200, 1000
# The Icequake window of the detect slice
ICEQUAKE_NSAMPLES = 625


def f3_traveltimes(rng):
    """Homogeneous-moveout tables of the F3 geometry: F3_STATIONS surface
    stations at random on the grid of F3_NODES at F3_SPACING_KM, vp F3_VP
    and vs F3_VS, phase-major, at F3_RATE."""

    axes = [np.arange(n) * F3_SPACING_KM for n in F3_NODES]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    stations = rng.uniform([0.0, 0.0], [axes[0][-1], axes[1][-1]],
                           size=(F3_STATIONS, 2))
    dist = [np.sqrt((x - sx) ** 2 + (y - sy) ** 2 + z**2)
            for sx, sy in stations]
    return traveltime_table([d / v for v in (F3_VP, F3_VS) for d in dist],
                            F3_RATE)


def setup(tt, node_count, fsmp, nsamples, device, rng=None, onsets_log=None,
          inv=None, plan=None):
    """A case on ``device``: the plan of the traveltimes ``tt``, the flat
    table, and prepared onsets (``onsets_log`` and ``inv``, or gamma
    onsets from ``rng``, every onset live, long enough for the plan)."""

    plan = plan or cm.DetectPlan(tt, node_count)
    if onsets_log is None:
        t_len = fsmp + nsamples + plan.max_shift + 7
        onsets = rng.gamma(2.0, 1.5, size=(plan.n_onsets, t_len))
        onsets_log = torch.from_numpy(
            np.log(np.clip(onsets, 0.01, None)).astype(np.float32)).to(
                device)
        inv = torch.full((1,), 1.0 / plan.n_onsets, dtype=torch.float32,
                         device=device)
    return SimpleNamespace(
        device=torch.device(device), plan=plan, node_count=node_count,
        tt=tt, tt_dev=torch.from_numpy(np.ascontiguousarray(
            tt, np.int32)).to(device),
        base=torch.from_numpy(plan.base).to(device),
        onsets_log=onsets_log.contiguous(), inv=inv, fsmp=fsmp,
        nsamples=nsamples)


def bound(s):
    """K3 v2's bound (the larger of its bytes over the memory rate and
    its operations over the float32 rate): its inputs read once (the
    onset rows, the plan's base, the uint16 residuals, the flat table,
    the windows' table, inv_available) and its three [n_tiles, S]
    outputs written once, against O adds and four more operations
    (scale, exp, max, sum) a real node and sample; and the floor of its
    gather, the real nodes x O x S 4-byte reads at the shared-memory
    rate."""

    plan = s.plan
    n_real = int(plan.valid.sum())
    n_onsets, t_len = s.onsets_log.shape
    tiles = plan.n_tiles
    nbytes = (4 * n_onsets * t_len + 4 * tiles * n_onsets
              + 2 * tiles * cm.GLOBAL_V2_TILE * n_onsets
              + 4 * tiles * cm.GLOBAL_V2_TILE + 8 * n_onsets + 4
              + 12 * tiles * s.nsamples)
    flops = n_real * s.nsamples * (n_onsets + 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    gather = 4 * n_real * n_onsets * s.nsamples
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "smem_bound_ms": gather / SMEM_BYTES_PER_S * 1e3,
            "gather_bytes": gather}


def route_layout(s):
    """The ring DetectScan's "k3" route runs for the case's plan."""

    return cm.global_v2_layout(s.plan.r_spans,
                               cm.global_v2_shape(s.plan.r_spans))


def k3_v2(s, layout=None):
    """K3 v2's launch on the case at a ring ``layout`` (the route's where
    None): a callable returning (tmax, targ, tsum) per brick
    tile."""

    layout = layout or route_layout(s)
    tables = cm.global_v2_tables(s.plan, s.fsmp, s.device, layout)
    return lambda: cm.migrate_detect_global_v2_cuda(
        s.onsets_log, s.base, s.inv, s.fsmp, s.nsamples, tables,
        s.plan.max_shift)


def k3(s):
    """K3's launch on the case's flat table."""

    return lambda: cm.migrate_detect_global_cuda(
        s.onsets_log, s.tt_dev, s.inv, s.fsmp, s.nsamples)


def plain(s):
    """The plain version with the kernels' arithmetic, combined over its
    flat tiles: (max_coa, max_idx, coa_sum)."""

    return cm.combine_flat_tiles(*cm.detect_reduce_flat_reference(
        s.onsets_log, s.tt_dev, s.inv, s.fsmp, s.nsamples))


def hold(got, ref, v1=None):
    """K3 v2's combined outputs ``got`` against the plain version's
    ``ref`` and K3's combined ``v1``: {"max_bit_equal", "argmax_equal",
    "sum_rel_err", "max_abs_err", "max_rel_err", "equal_to_k3", "ok"}."""

    torch.cuda.synchronize()
    rec = {"max_bit_equal": bool(torch.equal(got[0], ref[0])),
           "argmax_equal": bool(torch.equal(got[1], ref[1])),
           "sum_rel_err": float(((got[2] - ref[2]).abs()
                                 / ref[2].abs()).max()),
           "max_abs_err": float((got[0] - ref[0]).abs().max()),
           "max_rel_err": float(((got[0] - ref[0]).abs()
                                 / ref[0].abs()).max()),
           "argmax_equal_share": float((got[1] == ref[1]).float().mean())}
    if v1 is not None:
        rec["equal_to_k3"] = bool(torch.equal(got[0], v1[0])
                                  and torch.equal(got[1], v1[1]))
    rec["ok"] = bool(rec["max_bit_equal"] and rec["argmax_equal"]
                     and rec["sum_rel_err"] <= SUM_RTOL
                     and rec.get("equal_to_k3", True))
    return rec


def resources():
    """ptxas's registers and spills of each K3 v2 shape: {"WxNPP": ...}."""

    out = {}
    for name, v in _build.kernel_resources(KERNEL).items():
        for (w, npp), minb in cm.GLOBAL_V2_SHAPES.items():
            if f"ILi{w}ELi{npp}ELi{minb}E" in name:
                out[f"{w}x{npp}"] = {k: v[k] for k in (
                    "registers", "spill_stores", "spill_loads")}
    return out


def layout_record(s, layout):
    """The ring's G, depth, stage and shared-memory bytes and blocks per
    SM."""

    return {"shape": list(layout.shape), "group": layout.group,
            "n_stages": layout.n_stages,
            "stage_floats": layout.stage_floats, "smem": layout.smem,
            "blocks_per_sm": cm.global_v2_blocks_per_sm(layout, s.device)}


def sweep(s, ref, reps=REPS, shapes=tuple(sorted(cm.GLOBAL_V2_SHAPES))):
    """Each of ``shapes`` at every G from 1 that fits (the deepest ring
    at each), each held to the plain version ``ref`` and timed: a list of
    records."""

    out = []
    for shape in shapes:
        for group in range(1, s.plan.n_onsets + 1):
            layout = cm.global_v2_layout(s.plan.r_spans, shape, group=group)
            if layout is None:
                break
            fn = k3_v2(s, layout)
            held = hold(cm.combine_brick_tiles(*fn()), ref)
            rec = {**layout_record(s, layout), "ms": ekb.cuda_ms(fn, reps),
                   "ok": held["ok"]}
            out.append(rec)
            print(f"  shape {shape[0]}x{shape[1]} G {group:2d}: "
                  f"{rec['ms']:.4f} ms, {layout.n_stages} stages, smem "
                  f"{layout.smem}, blocks per SM {rec['blocks_per_sm']}, "
                  f"held {held['ok']}")
    return out


def run(s, label, reps=REPS, with_sweep=False, k1_v2=False):
    """
    K3 v2 on the case ``s`` at the route's ring: held to the plain
    version and K3 (:func:`hold`), then timed in turns with K3 (and K1 v2
    on the same plan with ``k1_v2``): k3_v2, k3[, k1_v2], ..., k3_v2;
    ``reps`` launches a turn. Returns a record (``ms``, ``k3_ms``,
    ``k1_v2_ms``, ``turns_ms``, the hold, the bound, the layout and
    resources, and with ``with_sweep`` the sweep).

    """

    layout = route_layout(s)
    fn, fn_v1 = k3_v2(s, layout), k3(s)
    ref = plain(s)
    held = hold(cm.combine_brick_tiles(*fn()),
                ref, cm.combine_flat_tiles(*fn_v1()))
    fns = {"k3_v2": fn, "k3": fn_v1}
    if k1_v2:
        det = cm.CudaDetect(s.tt, s.node_count, s.fsmp, s.nsamples,
                            s.device, plan=s.plan)
        fns["k1_v2"] = lambda: det.launch(s.onsets_log, s.inv)
    turns = ekb.in_turns(fns, reps)
    mean = {name: float(np.mean(ms)) for name, ms in turns.items()}
    record = {"ms": mean["k3_v2"], "k3_ms": mean["k3"],
              "k1_v2_ms": mean.get("k1_v2"), "turns_ms": turns,
              "r_span": s.plan.r_span, "n_tiles": s.plan.n_tiles,
              "nsamples": s.nsamples, "onsets": s.plan.n_onsets,
              **held, **bound(s), **layout_record(s, layout),
              "resources": resources()}
    print(f"{label}: K3 v2 against the plain version: max bit-equal "
          f"{held['max_bit_equal']}, argmax equal {held['argmax_equal']} "
          f"({held['argmax_equal_share']:.6f}), sum rel err "
          f"{held['sum_rel_err']:.2e}, equal to K3 "
          f"{held['equal_to_k3']}; in turns (ms) "
          + ", ".join(f"{name} {ms[0]:.4f} / {ms[1]:.4f}"
                      for name, ms in turns.items())
          + f"; bound {record['bound_ms']:.4f} ms ({record['bound_by']}), "
          f"gather floor {record['smem_bound_ms']:.4f} ms; shape "
          f"{layout.shape}, G {layout.group}, {layout.n_stages} stages, "
          f"stage {layout.stage_floats} floats, smem {layout.smem}, "
          f"blocks per SM {record['blocks_per_sm']}; resources "
          f"{record['resources']}")
    if with_sweep:
        record["sweep"] = sweep(s, ref, reps)
    return record


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sweep", action="store_true",
                        help="also time every shape at every G")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_global_v2: CUDA is not available")
    _build.load_library()
    print(torch.cuda.get_device_name(0))
    rng = np.random.default_rng(2032)
    f3 = setup(f3_traveltimes(rng), F3_NODES, F3_FSMP, F3_NSAMPLES, "cuda",
               rng)
    records = [run(f3, "f3", with_sweep=opts.sweep)]
    dims, tt, onsets = workload(ICEQUAKE_NSAMPLES, fsmp=ekb.FSMP)
    icequake = setup(tt, dims, ekb.FSMP, ICEQUAKE_NSAMPLES, "cuda",
                     onsets_log=torch.from_numpy(
                         np.log(np.clip(onsets, 0.01, None))).to("cuda"),
                     inv=torch.full((1,), 1.0 / tt.shape[1],
                                    dtype=torch.float32, device="cuda"))
    records.append(run(icequake, "icequake", with_sweep=opts.sweep,
                       k1_v2=True))
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise SystemExit("exp_global_v2: K3 v2 does not hold")


if __name__ == "__main__":
    sys.exit(main())
