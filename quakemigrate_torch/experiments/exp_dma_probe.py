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
  is timed first as the yardstick;
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

from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
from quakemigrate_torch.experiments.exp_x16 import same_as_full, setup
from quakemigrate_torch.ops import cuda_breakdown as cb
from quakemigrate_torch.ops import cuda_probe as cp
from quakemigrate_torch.ops.cuda_migrate import migrate_detect_cuda


def main_probe(s):
    """FULL, the 2-stage pipelined kernel and the two probes on the setup
    ``s``, each held to its contract and timed; returns their records."""

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
    torch.cuda.synchronize()
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
