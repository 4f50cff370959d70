# -*- coding: utf-8 -*-
"""
The one-hot product layouts on the card's tensor cores: the counterpart
of the TPU experiment ``experiments/exp_dot_layout.py`` (``main``), with
the kernel of :mod:`quakemigrate_torch.ops.cuda_dot_layout`.

Every mode (``kk``, ``kk1``, ``mk``, ``mk1``, ``kkT``) at every (K, M, N)
of the TPU ``main`` and 4096 steps: the whole run timed with CUDA events
(fill included, as there), microseconds per step and TFLOP/s with the TPU
formula (4 K M N a step, 2 K M N for ``kkT``), its output held to the
plain version (rtol 1e-6: only the f32 sum over M may round), and
``torch.matmul`` (cuBLAS, bf16 output) on the same bf16 operands for the
same products a step makes, 64 steps captured in a CUDA graph and timed
per step, as the library yardstick.
Requires CUDA; exits non-zero without it.

    python3 -m quakemigrate_torch.experiments.exp_dot_layout

"""

import argparse
import sys

import torch

from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.experiments.exp_kernel_breakdown import cuda_ms
from quakemigrate_torch.ops import cuda_dot_layout as cdl
from quakemigrate_torch.ops import dot_layout as dl

RTOL = 1e-6
LIBRARY_REPS = 64


def max_rel_err(got, want):
    """Largest |got - want| / |want| (0 where both are 0)."""

    diff = (got - want).abs()
    return (diff / want.abs().clamp(min=1e-30)).max().item()


def library_step_ms(mode, K, M, N, device, reps=LIBRARY_REPS):
    """Device milliseconds of one library step: ``reps`` steps captured in
    a CUDA graph and replayed, so that the host's launch overhead (about
    as long as one product at the smaller shapes) is not timed."""

    step = cdl.library_step(mode, K, M, N, device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for _ in range(3):
            step()
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            step()
    return cuda_ms(graph.replay, reps=3, warmup=1) / reps


def run_case(mode, K, M, N, steps, device, reps=3):
    """One mode and shape: the kernel held to its plain version and
    timed, beside the library's step. Returns a record."""

    out = cdl.dot_layout_cuda(mode, K, M, N, steps, device)
    ref = dl.dot_layout_reference(mode, K, M, N, steps, device)
    err = max_rel_err(out, ref)
    abs_err = (out - ref).abs().max().item()
    if not err <= RTOL:
        raise RuntimeError(f"dot_layout {mode} {K}x{M}x{N}: rel err {err}")
    ms = cuda_ms(lambda: cdl.dot_layout_cuda(mode, K, M, N, steps, device),
                 reps=reps, warmup=1)
    plain_ms = cuda_ms(lambda: dl.dot_layout_reference(mode, K, M, N, steps,
                                                       device), reps=3)
    lib_step_ms = library_step_ms(mode, K, M, N, device)
    rec = {
        "mode": mode, "K": K, "M": M, "N": N, "steps": steps, "ms": ms,
        "us_per_step": ms * 1e3 / steps,
        "tflops": dl.tflops(mode, K, M, N, steps, ms / 1e3),
        "library_ms": lib_step_ms * steps,
        "library_us_per_step": lib_step_ms * 1e3,
        "library_tflops": dl.tflops(mode, K, M, N, 1, lib_step_ms / 1e3),
        "plain_ms": plain_ms, "max_rel_err": err, "max_abs_err": abs_err,
        "checksum": float(dl.checksum(out.double())),
    }
    print(f"{mode:4s} K={K} M={M} N={N}: {rec['us_per_step']:8.3f} us/step "
          f"{rec['tflops']:6.1f} TFLOP/s; torch.matmul "
          f"{rec['library_us_per_step']:8.3f} us/step "
          f"{rec['library_tflops']:6.1f} TFLOP/s; rel err {err:.2e}")
    return rec


def run(device, steps=dl.STEPS, shapes=dl.SHAPES):
    """Every mode at every shape; returns the records."""

    records = [run_case(mode, K, M, N, steps, device)
               for mode in dl.MODES for K, M, N in shapes]
    torch.cuda.synchronize()
    return records


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_dot_layout: CUDA is not available")
    print(torch.cuda.get_device_name(0))
    run(resolve_device("cuda"))


if __name__ == "__main__":
    sys.exit(main())
