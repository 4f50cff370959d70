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
  onset-major layouts.

K1 (``full``) runs first at the same plan: every
case is held to its outputs (the shifted-copy kernel bit for bit, tmax,
targ and tsum; the pipelined kernel as the breakdown holds it), and its
time is the yardstick. Each line gives CUDA-event milliseconds per launch,
G/s = nodes x onsets x samples per second, microseconds per (tile,
128-sample) step, the checksum drift ``tmax.sum() + tsum.sum() +
targ.sum()`` against ``ref`` as the TPU experiment prints it, and the
resident blocks per SM the occupancy API reports. Requires CUDA; exits
non-zero without it.

    python3 -m quakemigrate_torch.experiments.exp_x16

"""

import argparse
import sys

import torch

from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
from quakemigrate_torch.ops import cuda_breakdown as cb
from quakemigrate_torch.ops import cuda_x16 as cx
from quakemigrate_torch.ops.cuda_migrate import (
    detect_blocks_per_sm,
    migrate_detect_cuda,
)

NSAMPLES = ekb.NSAMPLES
TILE, BRICK = 512, (8, 8, 8)
CASES = ("ref", "x16a", "x16b")


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


def run(s):
    """Run FULL and the cases on the setup ``s``, each held to FULL's
    outputs and timed; returns their records, FULL's first."""

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
