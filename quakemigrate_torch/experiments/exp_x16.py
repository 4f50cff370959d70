# -*- coding: utf-8 -*-
"""
The shifted-copy ("X16") detect kernel on the card, at the day-scale
Icequake window (71 x 64 x 57 nodes, 24 onsets, 30,000 samples) and the
TPU experiment's plan (tile 512, bricks 8 x 8 x 8).

The counterpart of the TPU experiment ``experiments/exp_x16.py``
(``main``), with the CUDA kernel of :mod:`quakemigrate_torch.ops.cuda_x16`.
Cases, as there:

- ``ref``: the pipelined kernel at 2 stages (the counterpart of
  ``run_deep(n_slots=2)``, which the TPU ``main`` runs as its reference);
- ``x16a`` and ``x16b``: the shifted-copy kernel in its copy-major and
  onset-major layouts;
- ``x16a_v2`` and ``x16b_v2``: its redesign on K1 v2's slab, E2 v2
  (``csrc/migrate_detect_x16_v2.cu``), in both layouts, timed in turns
  with v1's layouts, K1 and K1 v2 at the same plan (:data:`TURNS`), with
  its NOGATHER and NOREDUCE ablations held bit for bit to K1 v2's and
  timed.

K1 (``full``) runs first at the same plan: every
case is held to its outputs (the shifted-copy kernels and K1 v2 bit for
bit, tmax, targ and tsum; the pipelined kernel as the breakdown holds
it), and its time is the yardstick. Each line gives CUDA-event
milliseconds per launch, G/s = nodes x onsets x samples per second,
microseconds per (tile, 128-sample) step, the checksum drift
``tmax.sum() + tsum.sum() + targ.sum()`` against ``ref`` as the TPU
experiment prints it, and the resident blocks per SM the occupancy API
reports (for v2 also its registers and spills from ptxas). Requires
CUDA; exits non-zero without it.

    python3 -m quakemigrate_torch.experiments.exp_x16

"""

import argparse
import sys

import torch

from quakemigrate_torch import _build
from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
from quakemigrate_torch.ops import cuda_breakdown as cb
from quakemigrate_torch.ops import cuda_x16 as cx
from quakemigrate_torch.ops.cuda_migrate import (
    detect_blocks_per_sm,
    detect_v2_blocks_per_sm,
    migrate_detect_cuda,
    migrate_detect_v2_cuda,
)

NSAMPLES = ekb.NSAMPLES
TILE, BRICK = 512, (8, 8, 8)
CASES = ("ref", "x16a", "x16b")
# E2 v2 in each layout, and the cases timed in turns with it
V2_CASES = ("x16a_v2", "x16b_v2")
TURNS = V2_CASES + ("x16a", "x16b", "full", "k1_v2")
# The mangled name of E2 v2's FULL kernel (its ptxas report, its census)
V2_KERNEL = "qm_x16_v2_kernelILi0E"


def setup(nsamples=NSAMPLES, device="cuda"):
    """The day-scale workload on ``device`` at the TPU experiment's plan
    (:func:`exp_kernel_breakdown.setup` at tile 512, bricks 8^3)."""

    return ekb.setup(nsamples, device, tile=TILE, brick=BRICK)


def checksum(outs):
    """``tmax.sum() + tsum.sum() + targ.sum()``, in float64."""

    tmax, targ, tsum = (x.double() for x in outs)
    return float(tmax.sum() + tsum.sum() + targ.sum())


def same_as_full(full, outs, name):
    """tmax, targ and tsum bit-equal to K1's."""

    for what, want, got in zip(("tmax", "targ", "tsum"), full, outs):
        if not torch.equal(got, want):
            raise RuntimeError(f"{name}: {what} differs from the production "
                               "kernel's")


def case(s, name):
    """The launch of case ``name`` on the setup ``s``."""

    plan = s.plan
    if name == "full":
        return lambda: migrate_detect_cuda(*s.args, plan.r_span)
    if name == "ref":
        offs = cb.span_offsets(plan.r_spans, per_onset=False)
        span_off = torch.from_numpy(offs).to(s.device)
        return lambda: cb.migrate_detect_pipelined_cuda(
            *s.args, span_off, int(offs[-1]), 2, 0)
    return lambda: cx.migrate_detect_x16_cuda(
        *s.args, plan.r_span, plan.max_shift, name)


def v2_case(s, tables, variant="full"):
    """The launch of E2 v2 with ``tables`` and ``variant``."""

    a = s.args
    return lambda: cx.migrate_detect_x16_v2_cuda(a[0], a[1], *a[3:], tables,
                                                 variant)


def k1_v2_case(s, variant="full"):
    """The launch of K1 v2 (or its ablation ``variant``) at the plan of
    the setup ``s``."""

    plan, a = s.plan, s.args
    v2_args = (*a[:2], torch.from_numpy(plan.fine16).to(s.device), *a[3:],
               torch.from_numpy(plan.span_off).to(s.device), plan.win_floats)
    if variant == "full":
        return lambda: migrate_detect_v2_cuda(*v2_args)
    return lambda: cb.migrate_detect_v2_ablate_cuda(*v2_args, variant)


def run_v2(s, full, full_ms):
    """E2 v2 on the setup ``s``: both layouts and K1 v2 bit for bit to
    K1's outputs ``full``; the cases of :data:`TURNS` timed in turns;
    E2 v2's NOGATHER and NOREDUCE in both layouts bit for bit to K1 v2's
    and timed beside them. Returns the records of E2 v2's layouts and of
    K1 v2."""

    plan = s.plan
    tables = {layout: cx.x16_v2_tables(plan, s.args[5], s.device, layout)
              for layout in cx.LAYOUTS}
    fns = {f"{layout}_v2": v2_case(s, t) for layout, t in tables.items()}
    fns["k1_v2"] = k1_v2_case(s)
    for name, fn in fns.items():
        same_as_full(full, fn(), name)
    fns.update((name, case(s, name)) for name in ("x16a", "x16b", "full"))
    turns = ekb.in_turns({name: fns[name] for name in TURNS})
    mean = {name: sum(ms) / len(ms) for name, ms in turns.items()}
    resources = next(iter(_build.kernel_resources(V2_KERNEL).values()))
    ablations = {}
    for variant in ("nogather", "noreduce"):
        want = k1_v2_case(s, variant)()
        ablations[f"k1_v2_{variant}_ms"] = ekb.cuda_ms(k1_v2_case(s, variant))
        for layout in cx.LAYOUTS:
            fn = v2_case(s, tables[layout], variant)
            same_as_full(want, fn(), f"{layout}_v2 {variant} and K1 v2's")
            ablations[f"{layout}_{variant}_ms"] = ekb.cuda_ms(fn)
    records = [ekb._record(
        s, "k1_v2", mean["k1_v2"], full_ms, turns_ms=turns["k1_v2"],
        blocks_per_sm=detect_v2_blocks_per_sm(plan.n_onsets, plan.tile,
                                              plan.win_floats, s.device),
        nogather_ms=ablations["k1_v2_nogather_ms"],
        noreduce_ms=ablations["k1_v2_noreduce_ms"],
    )]
    for name in V2_CASES:
        layout = name[:-3]
        t = tables[layout]
        records.append(ekb._record(
            s, name, mean[name], full_ms, turns_ms=turns[name],
            v1_ms=mean[layout], v1_turns_ms=turns[layout],
            k1_ms=mean["full"], k1_turns_ms=turns["full"],
            k1_v2_ms=mean["k1_v2"],
            nogather_ms=ablations[f"{layout}_nogather_ms"],
            noreduce_ms=ablations[f"{layout}_noreduce_ms"],
            copy_floats=t.copy_floats,
            smem=cx.x16_v2_smem(plan.n_onsets, plan.tile, t.copy_floats),
            blocks_per_sm=cx.x16_v2_blocks_per_sm(
                plan.n_onsets, plan.tile, t.copy_floats, s.device),
            **resources,
        ))
    print("  in turns (ms): " + ", ".join(
        f"{name} {ms[0]:.4f} / {ms[1]:.4f}" for name, ms in turns.items()))
    for rec in records:
        print(f"  {rec['name']}: nogather {rec['nogather_ms']:.4f} ms, "
              f"noreduce {rec['noreduce_ms']:.4f} ms, blocks per SM "
              f"{rec['blocks_per_sm']}"
              + (f", smem {rec['smem']} bytes, registers "
                 f"{rec['registers']}, spills {rec['spill_stores']} / "
                 f"{rec['spill_loads']} bytes" if "smem" in rec else ""))
    return records


def run(s):
    """Run FULL and the cases on the setup ``s``, each held to FULL's
    outputs and timed, then E2 v2 (:func:`run_v2`); returns their
    records, FULL's first."""

    plan = s.plan
    print(f"x16: tile {plan.tile}, {plan.n_tiles} tiles, {s.nsamples} "
          f"samples, r_span {plan.r_span}, K = {sum(plan.r_spans)}, "
          f"{s.n_steps} steps, {cx.x16_smem(plan.n_onsets, plan.r_span)} "
          "bytes of shared memory a block")
    full = case(s, "full")()
    records = [ekb._record(
        s, "full", ekb.cuda_ms(case(s, "full")),
        blocks_per_sm=detect_blocks_per_sm(plan.n_onsets, plan.r_span,
                                           s.device),
    )]
    full_ms = records[0]["ms"]
    ref_sum = None
    for name in CASES:
        fn = case(s, name)
        outs = fn()
        if name == "ref":
            ekb._same_as(full, outs, name)
            occupancy = {}
        else:
            same_as_full(full, outs, name)
            occupancy = {"blocks_per_sm": cx.x16_blocks_per_sm(
                plan.n_onsets, plan.r_span, name, s.device)}
        chk = checksum(outs)
        ref_sum = chk if ref_sum is None else ref_sum
        records.append(ekb._record(
            s, name, ekb.cuda_ms(fn), full_ms,
            drift=abs(chk - ref_sum) / abs(ref_sum), **occupancy,
        ))
    for rec in records:
        print(f"  {rec['name']}: drift {rec.get('drift', 0.0):.2e}, "
              f"blocks per SM {rec.get('blocks_per_sm', 'n/a')}")
    records += run_v2(s, full, full_ms)
    torch.cuda.synchronize()
    return records


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_x16: CUDA is not available")
    print(torch.cuda.get_device_name(0))
    run(setup())


if __name__ == "__main__":
    sys.exit(main())
