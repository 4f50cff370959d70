# -*- coding: utf-8 -*-
"""
K2 v2, the VPU-plan detect kernel on an mbarrier ring
(``csrc/migrate_detect_vpu_v2.cu``), on the card beside K2 v1
(``csrc/migrate_detect_vpu.cu``) and K1 v2 at the same plan: by default
the day-scale Icequake window (71 x 64 x 57 nodes, 24 onsets, 30,000
samples) at the VPU plan (tile 512, bricks 8 x 8 x 8).

K2 v2 is held bit for bit to K2 v1 (tmax, targ, tsum) and, in tmax and
targ, to K1 at the same plan (its tsum sums the nodes in K2's order);
then K2 v2, K2 v1 and K1 v2 are timed in turns (v2, v1, K1 v2, K1 v2,
v1, v2), with K2 v2's shared memory, resident blocks per SM (occupancy
API) and registers and spills (ptxas). ``--configs`` also times every
ring depth the kernel takes, each held bit for bit to v1. Times are
CUDA-event
milliseconds per launch. Requires CUDA; exits non-zero without it.

    python3 -m quakemigrate_torch.experiments.exp_vpu_v2 [--nsamples N]
        [--configs]

"""

import argparse
import sys
from types import SimpleNamespace

import torch

from quakemigrate_torch import _build
from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
from quakemigrate_torch.ops import cuda_migrate as cm

NSAMPLES = ekb.NSAMPLES
TILE, BRICK = 512, (8, 8, 8)
REPS = 5
# The cases timed in turns, K2 v2 first
TURNS = ("vpu_v2", "vpu", "k1_v2")
# Mangled name of K2 v2's kernels (their ptxas report, their census)
KERNEL = "qm_vpu_v2_kernel"


def setup(nsamples=NSAMPLES, device="cuda"):
    """The day-scale workload on ``device`` at the VPU plan
    (:func:`exp_kernel_breakdown.setup` at tile 512, bricks 8^3)."""

    return ekb.setup(nsamples, device, tile=TILE, brick=BRICK)


def plan_setup(plan, args):
    """A setup of this module's shape for a :class:`DetectPlan` and its
    kernel arguments ``args`` (onsets_log, base, fine, valid,
    inv_available, fsmp, nsamples) on the card."""

    return SimpleNamespace(device=args[0].device, plan=plan, args=args,
                           nsamples=args[6])


def cases(s, tables, n_stages=4):
    """The launches of the setup ``s``: K2 v2 (through ``tables``, with
    an ``n_stages`` ring), K2 v1, K1 v2 and K1 at its plan."""

    plan, a = s.plan, s.args
    fine16 = torch.from_numpy(plan.fine16).to(s.device)
    span_off = torch.from_numpy(plan.span_off).to(s.device)
    return {
        "vpu_v2": lambda: cm.migrate_detect_vpu_v2_cuda(
            a[0], a[1], *a[3:], tables, n_stages),
        "vpu": lambda: cm.migrate_detect_vpu_cuda(*a, plan.r_span),
        "k1_v2": lambda: cm.migrate_detect_v2_cuda(
            a[0], a[1], fine16, *a[3:], span_off, plan.win_floats),
        "k1": lambda: cm.migrate_detect_cuda(*a, plan.r_span),
    }


def same(got, want, what):
    """Each output of ``got`` bit-equal to ``want``'s (tmax, targ, tsum;
    as many as ``want`` holds)."""

    for name, g, w in zip(("tmax", "targ", "tsum"), got, want):
        if not torch.equal(g, w):
            raise RuntimeError(f"{what}: {name} differs")


def resources(tile):
    """ptxas's registers and spills of K2 v2's kernel at ``tile``."""

    tag = f"ILi{tile // cm.VPU_NWARPS}ELi{cm.vpu_v2_npp(tile)}E"
    return next(v for name, v in _build.kernel_resources(KERNEL).items()
                if tag in name)


def layout_record(s, n_stages):
    """K2 v2's shared memory, blocks per SM and ptxas report at a ring
    depth."""

    plan = s.plan
    stride, _, _ = cm.vpu_v2_layout(plan.r_span)
    rec = resources(plan.tile)
    return {
        "npp": cm.vpu_v2_npp(plan.tile), "group": cm.VPU_V2_GROUP,
        "n_stages": n_stages,
        "smem": cm.vpu_v2_smem(plan.tile, plan.r_span, n_stages),
        "blocks_per_sm": cm.vpu_v2_blocks_per_sm(plan.tile, stride,
                                                 n_stages, s.device),
        "registers": rec["registers"], "spill_stores": rec["spill_stores"],
        "spill_loads": rec["spill_loads"],
    }


def run(s, reps=REPS, configs=False, n_stages=4):
    """
    K2 v2 on the setup ``s`` with an ``n_stages`` ring: bit for bit to K2
    v1, tmax and targ bit for bit to K1, then timed in turns with v1 and
    K1 v2 (:data:`TURNS`, ``reps`` launches a turn); with ``configs``
    every ring depth, each held to v1 and timed. Returns a record of K2 v2 (``ms``, ``v1_ms``, ``k1_v2_ms``,
    ``turns_ms``, its layout and resources, ``configs``).

    """

    plan = s.plan
    fsmp = s.args[5]
    tables = cm.vpu_v2_tables(plan, fsmp, s.device)
    fns = cases(s, tables, n_stages)
    v1 = fns["vpu"]()
    same(fns["vpu_v2"](), v1, "K2 v2 and K2")
    same(fns["vpu_v2"]()[:2], fns["k1"]()[:2], "K2 v2 and K1")
    turns = ekb.in_turns({name: fns[name] for name in TURNS}, reps)
    mean = {name: sum(ms) / len(ms) for name, ms in turns.items()}
    record = {"ms": mean["vpu_v2"], "v1_ms": mean["vpu"],
              "k1_v2_ms": mean["k1_v2"], "turns_ms": turns,
              "r_span": plan.r_span, "stride": tables.stride,
              "box": tables.box, "n_boxes": tables.n_boxes,
              **layout_record(s, n_stages),
              "configs": []}
    print(f"vpu v2: tile {plan.tile}, {plan.n_tiles} tiles, {s.nsamples} "
          f"samples, {plan.n_onsets} onsets, r_span {plan.r_span}: equal to "
          "K2 (tmax, targ, tsum) and to K1 (tmax, targ); in turns (ms) "
          + ", ".join(f"{name} {ms[0]:.4f} / {ms[1]:.4f}"
                      for name, ms in turns.items())
          + f"; npp {tables.npp}, group {cm.VPU_V2_GROUP}, {n_stages} "
          "stages, smem "
          f"{record['smem']} "
          f"bytes, blocks per SM {record['blocks_per_sm']}, registers "
          f"{record['registers']}, spills {record['spill_stores']} / "
          f"{record['spill_loads']} bytes")
    if configs:
        for depth in cm.VPU_V2_STAGES:
            fn = cases(s, tables, depth)["vpu_v2"]
            same(fn(), v1, f"K2 v2 at {depth} stages")
            rec = {**layout_record(s, depth), "ms": ekb.cuda_ms(fn, reps)}
            record["configs"].append(rec)
            print(f"  {depth} stages: {rec['ms']:.4f} ms, smem "
                  f"{rec['smem']}, blocks per SM {rec['blocks_per_sm']}")
    return record


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nsamples", type=int, default=NSAMPLES)
    parser.add_argument("--configs", action="store_true",
                        help="also time every ring depth")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_vpu_v2: CUDA is not available")
    _build.load_library()
    print(torch.cuda.get_device_name(0))
    run(setup(opts.nsamples), configs=opts.configs)


if __name__ == "__main__":
    sys.exit(main())
