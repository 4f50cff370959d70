# -*- coding: utf-8 -*-
"""
Staging and streaming probes of the detect kernel on the card, at the
day-scale Icequake window and the TPU experiment's plan (tile 512, bricks
8 x 8 x 8, 30,000 samples).

The counterpart of the TPU experiment ``experiments/exp_dma_probe.py``,
with the CUDA kernels of :mod:`quakemigrate_torch.ops.cuda_probe`:

- default (``main_probe``): the pipelined kernel at 2 stages (``ref``)
  against its two probes, ``static2`` (the step loop unrolled to static
  slots; held bit for bit to K1) and ``packed`` (one
  contiguous 16-byte cp.async run per step from a zero table; held to
  its closed form). K1 (``full``) at the same plan
  is timed first as the yardstick. Then their redesign on E1c v2's TMA
  ring, E4b v2 (``csrc/migrate_detect_probe_v2.cu``): ``static2_v2``
  (every slot, barrier and phase parity a constant; bit for bit to K1)
  and ``packed_v2`` (one bulk copy a step from a zero table; held to the
  closed form), timed in turns with E1c v2 at the same plan
  (``ref_v2``, bit for bit to K1) and v1's two modes (:data:`TURNS`);

- ``--stream`` (``main_stream``): device memory -> shared memory
  streaming with no compute, from a seeded random bf16 source of 512 MiB
  looped to 16 GiB streamed, at rows 64, 256 and 1024 a chunk; the output
  is held to its plain version, and ``torch.sum`` over the same bytes is
  timed beside it.

Times are CUDA-event milliseconds per launch, with G/s = nodes x onsets x
samples per second for the probes and GB/s streamed for the stream, as
the TPU experiment prints them. Requires CUDA; exits non-zero without it.

    python3 -m quakemigrate_torch.experiments.exp_dma_probe [--stream]

"""

import argparse
import sys

import torch

from quakemigrate_torch import _build
from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
from quakemigrate_torch.experiments.exp_x16 import same_as_full, setup
from quakemigrate_torch.ops import cuda_breakdown as cb
from quakemigrate_torch.ops import cuda_probe as cp
from quakemigrate_torch.ops.cuda_migrate import migrate_detect_cuda

# E4b v2's modes, E1c v2 at the same plan, and v1's modes, timed in turns
TURNS = ("static2_v2", "packed_v2", "ref_v2", "static2", "packed")
# The mangled name of E4b v2's static2 kernel (its ptxas report)
V2_KERNEL = "qm_probe_v2_kernelILb0E"


def main_probe(s):
    """FULL, the 2-stage pipelined kernel and the two probes on the setup
    ``s``, each held to its contract and timed, then E4b v2
    (:func:`main_probe_v2`); returns their records."""

    plan = s.plan
    # a uniform span rounded to 4 floats: the packed copy is 16-byte runs
    offs = cb.span_offsets(plan.r_spans, per_onset=False, align=4)
    span_off = torch.from_numpy(offs).to(s.device)
    slot = int(offs[-1])
    zeros = cp.packed_zeros(s.nsamples, slot, s.device)
    print(f"probe: tile {plan.tile}, {plan.n_tiles} tiles, {s.nsamples} "
          f"samples, {s.n_steps} steps, slot {slot} floats")

    def full_fn():
        return migrate_detect_cuda(*s.args, plan.r_span)

    def ref_fn():
        return cb.migrate_detect_pipelined_cuda(*s.args, span_off, slot, 2, 0)

    def probe_fn(mode):
        return lambda: cp.migrate_detect_probe_cuda(
            *s.args, span_off, slot, mode, zeros)

    full = full_fn()
    closed = cp.packed_reference(s.args[3], s.nsamples)
    ekb._same_as(full, ref_fn(), "ref")
    same_as_full(full, probe_fn("static2")(), "static2")
    same_as_full(closed, probe_fn("packed")(), "packed")

    records = [ekb._record(s, "full", ekb.cuda_ms(full_fn))]
    full_ms = records[0]["ms"]
    records.append(ekb._record(s, "ref", ekb.cuda_ms(ref_fn), full_ms))
    for mode in cp.PROBE_MODES:
        records.append(ekb._record(s, mode, ekb.cuda_ms(probe_fn(mode)),
                                   full_ms, slot_floats=slot))
    records += main_probe_v2(s, full, closed, full_ms,
                             {mode: probe_fn(mode) for mode in cp.PROBE_MODES})
    torch.cuda.synchronize()
    return records


def main_probe_v2(s, full, closed, full_ms, v1_fns):
    """E4b v2 on the setup ``s``: static2 and E1c v2 bit for bit to K1's
    outputs ``full``, packed to its closed form ``closed``; the cases of
    :data:`TURNS` (``v1_fns``: v1's modes) timed in turns. Returns the
    records of E4b v2's modes and E1c v2."""

    plan, a = s.plan, s.args
    t = cb.pipelined_v2_tables(plan, a[5], s.device)
    zeros = cp.packed_v2_zeros(s.nsamples, plan.n_onsets, t.stride,
                               s.device)

    def probe_v2_fn(mode):
        return lambda: cp.migrate_detect_probe_v2_cuda(
            a[0], a[1], *a[3:], t, mode, zeros)

    def ref_v2_fn():
        return cb.migrate_detect_pipelined_v2_cuda(a[0], a[1], *a[3:], t)

    same_as_full(full, probe_v2_fn("static2")(), "static2_v2")
    same_as_full(closed, probe_v2_fn("packed")(), "packed_v2")
    same_as_full(full, ref_v2_fn(), "ref_v2 (E1c v2)")
    fns = {"static2_v2": probe_v2_fn("static2"),
           "packed_v2": probe_v2_fn("packed"), "ref_v2": ref_v2_fn, **v1_fns}
    turns = ekb.in_turns({name: fns[name] for name in TURNS})
    mean = {name: sum(ms) / len(ms) for name, ms in turns.items()}
    layout = {"stride": t.stride, "box": t.box,
              "smem": cb.pipelined_v2_smem(plan.n_onsets, plan.tile, t.stride,
                                           2)}
    records = [ekb._record(
        s, "ref_v2", mean["ref_v2"], full_ms, turns_ms=turns["ref_v2"],
        blocks_per_sm=cb.pipelined_v2_blocks_per_sm(
            plan.n_onsets, plan.tile, t.stride, 2, s.device), **layout)]
    resources = next(iter(_build.kernel_resources(V2_KERNEL).values()))
    for mode in cp.PROBE_MODES:
        name = f"{mode}_v2"
        records.append(ekb._record(
            s, name, mean[name], full_ms, turns_ms=turns[name],
            v1_ms=mean[mode], v1_turns_ms=turns[mode],
            ref_v2_ms=mean["ref_v2"],
            blocks_per_sm=cp.probe_v2_blocks_per_sm(
                plan.n_onsets, plan.tile, t.stride, s.device),
            **layout, **resources))
    print("  in turns (ms): " + ", ".join(
        f"{name} {ms[0]:.4f} / {ms[1]:.4f}" for name, ms in turns.items()))
    for rec in records:
        print(f"  {rec['name']}: blocks per SM {rec['blocks_per_sm']}, smem "
              f"{rec['smem']} bytes"
              + (f", registers {rec['registers']}, spills "
                 f"{rec['spill_stores']} / {rec['spill_loads']} bytes"
                 if "registers" in rec else ""))
    return records


def main_stream(device="cuda", stream_bytes=cp.STREAM_BYTES):
    """The streaming probe at each rows value of ``cp.STREAM_ROWS``, from
    a source of seed 0, ``stream_bytes`` streamed; returns one record each
    with its ms, GB/s, plain version's ms and ``torch.sum``'s ms over the
    same bytes (None where the stream is not a whole number of sources)."""

    device = resolve_device(device)
    records = []
    for rows in cp.STREAM_ROWS:
        g = cp.stream_geometry(rows, stream_bytes=stream_bytes)
        src = cp.stream_source(g, device)
        out = cp.stream_probe_cuda(src, g.n_total)
        plain = cp.stream_probe_reference(src, g.n_total)
        if not torch.equal(out, plain):
            raise RuntimeError(f"stream rows={rows}: output differs from "
                               "its plain version")
        ms = ekb.cuda_ms(lambda: cp.stream_probe_cuda(src, g.n_total),
                         reps=3, warmup=1)
        plain_ms = ekb.cuda_ms(
            lambda: cp.stream_probe_reference(src, g.n_total), reps=3,
            warmup=1)
        # torch.sum over the source once, and over the source looped to
        # the streamed bytes (one call over the same bytes)
        source_sum_ms = ekb.cuda_ms(src.sum, reps=3, warmup=1)
        library_ms = None
        if g.n_total % g.n_chunks == 0:
            looped = src.unsqueeze(0).expand(g.n_total // g.n_chunks,
                                             *src.shape)
            library_ms = ekb.cuda_ms(looped.sum, reps=3, warmup=1)
        source_bytes = src.numel() * src.element_size()
        rec = {"rows": rows, "ms": ms, "gbps": g.stream_bytes / (ms * 1e6),
               "us_per_step": ms * 1e3 / g.n_total, "plain_ms": plain_ms,
               "library_ms": library_ms, "source_sum_ms": source_sum_ms,
               "source_sum_gbps": source_bytes / (source_sum_ms * 1e6),
               "stream_bytes": g.stream_bytes,
               "max_abs_err": (out - plain).abs().max().item()}
        lib = ("" if library_ms is None else
               f"; torch.sum over the same bytes {library_ms:.4f} ms, "
               f"{g.stream_bytes / (library_ms * 1e6):.1f} GB/s")
        print(f"stream rows={rows:5d} {g.stream_bytes / 2**20:6.0f} MiB "
              f"{rec['gbps']:7.1f} GB/s {rec['us_per_step']:7.3f} us/step "
              f"({ms:.4f} ms){lib}; torch.sum over the source "
              f"{rec['source_sum_gbps']:.1f} GB/s")
        records.append(rec)
        del src, out, plain
        torch.cuda.empty_cache()
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--stream", action="store_true",
                        help="the streaming probe instead of the staging "
                             "probes")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_dma_probe: CUDA is not available")
    print(torch.cuda.get_device_name(0))
    if opts.stream:
        main_stream()
    else:
        main_probe(setup())


if __name__ == "__main__":
    sys.exit(main())
