# -*- coding: utf-8 -*-
"""
Cost breakdown of the detect kernel on the card, at the day-scale
Icequake window (71 x 64 x 57 nodes, 24 onsets, 30,000 samples) and the
production plan (tile 256, bricks 8 x 8 x 4, 128-sample blocks).

The counterpart of the TPU experiment ``experiments/exp_kernel_breakdown.py``
(``main``, ``main_resident``, ``main_deep``, ``main_pspan``), with the CUDA
kernels of :mod:`quakemigrate_torch.ops.cuda_breakdown`:

- default: K1 and its ablations (pieces removed:
  exp, argmax, the whole reduction, the per-node gather), and the time
  each removes;
- ``--resident``: tiles grouped so that each onset's union window is
  staged once per group instead of once per tile; v1 at groups 2, 8 and
  32, then E1b v2 (K1 v2's gather core, TMA-fed union windows) at the
  group its host picks;
- ``--deep``: a persistent grid with a 2-, 3- or 4-deep cp.async ring
  (v1), then E1c v2 (K1 v2's gather core, a TMA ring, tile-major) at 2,
  3 and 4 stages;
- ``--pspan``: the pipelined kernel staging per-onset spans against the
  uniform span.

Times are CUDA-event milliseconds per launch (mean over the timed
launches after a warm-up), with rates in G/s = nodes x onsets x samples
per second, as the TPU experiment prints them; each v2 record also
carries its resident blocks per SM. The resident and
pipelined kernels' outputs (v1 and v2) are held against K1's on
the same inputs (they share its contract and its reduction order, so
tmax and targ must be equal). Requires CUDA; exits non-zero without it.

    python3 -m quakemigrate_torch.experiments.exp_kernel_breakdown \\
        [--resident | --deep | --pspan | --all]

"""

import argparse
import sys
from types import SimpleNamespace

import numpy as np
import torch

from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.experiments.workload import workload
from quakemigrate_torch.ops import cuda_breakdown as cb
from quakemigrate_torch.ops.cuda_migrate import SBLK, DetectPlan
from quakemigrate_torch.ops.migrate import _prepare_onsets

N_ONSETS, FSMP, NSAMPLES = 24, 500, 30_000
TILE, BRICK = 256, (8, 8, 4)
REPS, WARMUP = 5, 2
RESIDENT_GROUPS = (2, 8, 32)
BLOCKS_PER_SM = (2, 0)  # 0: as many as fit


def setup(nsamples=NSAMPLES, device="cuda", tile=TILE, brick=BRICK):
    """The workload and its plan on ``device``: a namespace with the
    kernels' common arguments ``args`` and the plan's geometry."""

    device = resolve_device(device)
    dims, tt, onsets = workload(nsamples, n_onsets=N_ONSETS, fsmp=FSMP)
    plan = DetectPlan(tt, dims, tile=tile, brick_shape=brick)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    mask = torch.ones(N_ONSETS, dtype=torch.float32, device=device)
    onsets_log = _prepare_onsets(put(onsets), mask).contiguous()
    inv_available = torch.full((1,), 1.0 / N_ONSETS, dtype=torch.float32,
                               device=device)
    base, fine, valid = put(plan.base), put(plan.fine), put(plan.valid)
    return SimpleNamespace(
        device=device, plan=plan, nsamples=nsamples,
        args=(onsets_log, base, fine, valid, inv_available, FSMP, nsamples),
        units=int(np.prod(dims)) * N_ONSETS * nsamples,
        n_steps=plan.n_tiles * -(-nsamples // SBLK),
    )


def cuda_ms(fn, reps=REPS, warmup=WARMUP):
    """Mean milliseconds of ``fn()`` per call on the current stream,
    from CUDA events around ``reps`` calls after ``warmup`` calls."""

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


# The first hold of queued_ms, in the card's clock cycles (~10 ms at the
# H100's boost clock), doubled while the device drains the queue first
HOLD_CYCLES = 20_000_000
HOLD_TRIES = 4


def queued_ms(fn, reps=REPS, warmup=WARMUP):
    """Mean milliseconds of ``fn()``'s device work per call, from CUDA
    events around ``reps`` calls that the host enqueues behind a spinning
    kernel (``torch.cuda._sleep``): the calls then run back to back, and
    the time is the kernels' and not the host's enqueue, which
    :func:`cuda_ms` measures instead where the host is the slower. The
    hold is doubled and the calls timed again while the start event has
    completed before the last call was enqueued (the queue drained)."""

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = HOLD_CYCLES
    for _ in range(HOLD_TRIES):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        drained = start.query()
        end.synchronize()
        if not drained:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError(f"queued_ms: the device drained a hold of {cycles // 2}"
                       f" cycles before {reps} calls were enqueued")


def in_turns(fns, reps=REPS, warmup=WARMUP, queued=False):
    """CUDA-event milliseconds of each callable of ``fns`` (name ->
    callable), timed in turns a, b, ..., b, a: {name: [first, second]};
    with ``queued``, the calls enqueued behind a hold (:func:`queued_ms`),
    else as the host issues them (:func:`cuda_ms`)."""

    timer = queued_ms if queued else cuda_ms
    order = list(fns) + list(fns)[::-1]
    ms = {name: [] for name in fns}
    for name in order:
        ms[name].append(timer(fns[name], reps, warmup))
    return ms


def _record(s, name, ms, full_ms=None, **extra):
    rec = {"name": name, "ms": ms, "gps": s.units / (ms * 1e6),
           "us_per_step": ms * 1e3 / s.n_steps, **extra}
    delta = "" if full_ms is None else f"  ({ms - full_ms:+.4f} ms vs full)"
    print(f"{name:24s} {ms:10.4f} ms {rec['gps']:8.1f} G/s "
          f"{rec['us_per_step']:8.4f} us/step{delta}")
    return rec


def _same_as(reference, outs, name):
    """The production contract, held exactly: same tmax and targ as the
    production kernel, and the same sums within 1e-6 relative."""

    tmax, targ, tsum = reference
    if not torch.equal(outs[0], tmax) or not torch.equal(outs[1], targ):
        raise RuntimeError(f"{name}: tmax or targ differ from the "
                           "production kernel's")
    rel = ((outs[2] - tsum).abs() / tsum.abs()).max().item()
    if not rel <= 1e-6:
        raise RuntimeError(f"{name}: tsum differs by {rel} relative")


def main_ablate(s):
    """K1 and its ablations, each timed; the delta of
    each against FULL."""

    r_span = s.plan.r_span
    print(f"ablations: tile {s.plan.tile}, {s.plan.n_tiles} tiles, "
          f"{s.nsamples} samples, r_span {r_span}, {s.n_steps} steps")
    records, full_ms = [], None
    for variant in cb.ABLATIONS:
        ms = cuda_ms(lambda: cb.migrate_detect_ablate_cuda(
            *s.args, r_span, variant))
        records.append(_record(s, variant, ms, full_ms, variant=variant))
        if variant == "full":
            full_ms = ms
    return records


def main_resident(s, reference):
    """Resident staging, one union window per group of tiles: v1 at each
    of RESIDENT_GROUPS, then E1b v2."""

    records = []
    base = s.args[1]
    for max_group in RESIDENT_GROUPS:
        group, gbase, gwidth = cb.resident_groups(base, s.plan.r_span,
                                                  max_group)

        def run():
            return cb.migrate_detect_resident_cuda(*s.args, group, gbase,
                                                   gwidth)

        _same_as(reference, run(), f"resident group {group}")
        ms = cuda_ms(run)
        records.append(_record(
            s, f"resident group={group} w={gwidth}", ms, group=group,
            gwidth=gwidth, smem=cb.resident_smem(s.plan.n_onsets, gwidth),
        ))
    t = cb.resident_v2_tables(s.plan, FSMP, s.device)

    def run_v2():
        return cb.migrate_detect_resident_v2_cuda(s.args[0], *s.args[3:], t)

    name = f"resident v2 group={t.group} w={t.win_floats}"
    _same_as(reference, run_v2(), name)
    records.append(_record(
        s, name, cuda_ms(run_v2), group=t.group, win_floats=t.win_floats,
        smem=cb.resident_v2_smem(s.plan.n_onsets, s.plan.tile,
                                 t.win_floats),
        blocks_per_sm=cb.resident_v2_blocks_per_sm(
            s.plan.n_onsets, s.plan.tile, t.win_floats, s.device),
    ))
    return records


def _pipelined(s, reference, per_onset, n_stages, blocks_per_sm, name):
    offs = cb.span_offsets(s.plan.r_spans, per_onset)
    span_off = torch.from_numpy(offs).to(s.device)
    slot = int(offs[-1])

    def run():
        return cb.migrate_detect_pipelined_cuda(
            *s.args, span_off, slot, n_stages, blocks_per_sm)

    _same_as(reference, run(), name)
    ms = cuda_ms(run)
    return _record(s, name, ms, n_stages=n_stages,
                   blocks_per_sm=blocks_per_sm, per_onset=per_onset,
                   slot_floats=slot)


def main_deep(s, reference):
    """The pipelined kernel at 2, 3 and 4 stages, with two blocks per SM
    and with as many as fit; then E1c v2 at 2, 3 and 4 stages."""

    records = [
        _pipelined(s, reference, False, n_stages, bps,
                   f"deep stages={n_stages} bps={bps or 'max'}")
        for n_stages in cb.STAGES for bps in BLOCKS_PER_SM
    ]
    t = cb.pipelined_v2_tables(s.plan, FSMP, s.device)
    for n_stages in cb.PIPELINED_V2_STAGES:
        def run_v2():
            return cb.migrate_detect_pipelined_v2_cuda(
                s.args[0], s.args[1], *s.args[3:], t, n_stages)

        name = f"deep v2 stages={n_stages}"
        _same_as(reference, run_v2(), name)
        records.append(_record(
            s, name, cuda_ms(run_v2), n_stages=n_stages, stride=t.stride,
            box=t.box,
            smem=cb.pipelined_v2_smem(s.plan.n_onsets, s.plan.tile,
                                      t.stride, n_stages),
            blocks_per_sm=cb.pipelined_v2_blocks_per_sm(
                s.plan.n_onsets, s.plan.tile, t.stride, n_stages, s.device),
        ))
    return records


def main_pspan(s, reference):
    """Uniform span against per-onset spans, 3 stages."""

    return [
        _pipelined(s, reference, per_onset, 3, BLOCKS_PER_SM[0],
                   f"pspan {'per-onset' if per_onset else 'uniform'} "
                   f"slot={cb.span_offsets(s.plan.r_spans, per_onset)[-1]}")
        for per_onset in (False, True)
    ]


def run(s, parts=("ablate", "resident", "deep", "pspan")):
    """Run the requested parts on the setup ``s``; returns their records
    by part. K1's outputs, the reference of the
    resident and pipelined kernels, come from one FULL launch."""

    reference = cb.migrate_detect_ablate_cuda(*s.args, s.plan.r_span, "full")
    out = {}
    for part in parts:
        if part == "ablate":
            out[part] = main_ablate(s)
        else:
            out[part] = globals()[f"main_{part}"](s, reference)
    torch.cuda.synchronize()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = parser.add_mutually_exclusive_group()
    for part in ("resident", "deep", "pspan", "all"):
        group.add_argument(f"--{part}", action="store_true")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_kernel_breakdown: CUDA is not available")
    if opts.all:
        parts = ("ablate", "resident", "deep", "pspan")
    else:
        parts = [p for p in ("resident", "deep", "pspan")
                 if getattr(opts, p)] or ["ablate"]
    print(torch.cuda.get_device_name(0))
    run(setup(), parts)


if __name__ == "__main__":
    sys.exit(main())
