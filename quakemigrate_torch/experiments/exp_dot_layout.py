# -*- coding: utf-8 -*-
"""
The one-hot product layouts on the card's tensor cores: the counterpart
of the TPU experiment ``experiments/exp_dot_layout.py`` (``main``), with
the kernels of :mod:`quakemigrate_torch.ops.cuda_dot_layout`: v2
(``wgmma`` fed by a TMA ring, the kernel of record) and v1 (``mma.sync``,
the yardstick).

Every mode (``kk``, ``kk1``, ``mk``, ``mk1``, ``kkT``) at every (K, M, N)
of the TPU ``main`` and 4096 steps: both kernels' outputs held to the
plain version (rtol 1e-6: only the f32 sum over M may round); the whole
run of each timed with CUDA events (fill included, as there) in turns
v2, v1, v1, v2, in microseconds per step and TFLOP/s with the TPU
formula (4 K M N a step, 2 K M N for ``kkT``); the bytes each stages
from L2 a step and the rate that implies; and ``torch.matmul`` (cuBLAS,
bf16 output) on the same bf16 operands for the same products a step
makes, 64 steps captured in a CUDA graph and timed per step, as the
library yardstick.
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


def held(kernel, mode, K, M, N, steps, device, ref):
    """Run ``kernel`` once and hold it to the plain output ``ref``:
    (max relative error, max absolute error, checksum)."""

    out = kernel(mode, K, M, N, steps, device)
    err = max_rel_err(out, ref)
    if not err <= RTOL:
        raise RuntimeError(
            f"{kernel.__name__} {mode} {K}x{M}x{N}: rel err {err}")
    return err, (out - ref).abs().max().item(), float(
        dl.checksum(out.double()))


def run_case(mode, K, M, N, steps, device, reps=3):
    """One mode and shape: v2 and v1 held to the plain version and timed
    in turns (v2, v1, v1, v2), beside the library's step. Returns a
    record: v2's numbers under the plain keys, v1's under ``v1_``; each
    time is the mean of its two turns."""

    ref = dl.dot_layout_reference(mode, K, M, N, steps, device)
    err, abs_err, total = held(cdl.dot_layout_v2_cuda, mode, K, M, N, steps,
                               device, ref)
    v1_err, v1_abs_err, _ = held(cdl.dot_layout_cuda, mode, K, M, N, steps,
                                 device, ref)
    kernels = {"v2": cdl.dot_layout_v2_cuda, "v1": cdl.dot_layout_cuda}
    turns = {name: [] for name in kernels}
    for name in ("v2", "v1", "v1", "v2"):
        turns[name].append(cuda_ms(
            lambda: kernels[name](mode, K, M, N, steps, device), reps=reps,
            warmup=1))
    ms = sum(turns["v2"]) / 2
    v1_ms = sum(turns["v1"]) / 2
    plain_ms = cuda_ms(lambda: dl.dot_layout_reference(mode, K, M, N, steps,
                                                       device), reps=3)
    lib_step_ms = library_step_ms(mode, K, M, N, device)
    staged = cdl.staged_bytes_v2(mode, K, M, N)
    v1_staged = cdl.staged_bytes_v1(mode, K, M, N)
    rec = {
        "mode": mode, "K": K, "M": M, "N": N, "steps": steps, "ms": ms,
        "turns_ms": turns["v2"],
        "us_per_step": ms * 1e3 / steps,
        "tflops": dl.tflops(mode, K, M, N, steps, ms / 1e3),
        "staged_bytes_per_step": staged,
        "staged_tbps": staged * steps / (ms / 1e3) / 1e12,
        "v1_ms": v1_ms, "v1_turns_ms": turns["v1"],
        "v1_us_per_step": v1_ms * 1e3 / steps,
        "v1_tflops": dl.tflops(mode, K, M, N, steps, v1_ms / 1e3),
        "v1_staged_bytes_per_step": v1_staged,
        "v1_staged_tbps": v1_staged * steps / (v1_ms / 1e3) / 1e12,
        "library_ms": lib_step_ms * steps,
        "library_us_per_step": lib_step_ms * 1e3,
        "library_tflops": dl.tflops(mode, K, M, N, 1, lib_step_ms / 1e3),
        "plain_ms": plain_ms, "max_rel_err": err, "max_abs_err": abs_err,
        "v1_max_rel_err": v1_err, "v1_max_abs_err": v1_abs_err,
        "checksum": total,
    }
    print(f"{mode:4s} K={K} M={M} N={N}: v2 {rec['us_per_step']:8.3f} us/step "
          f"{rec['tflops']:6.1f} TFLOP/s ({rec['staged_tbps']:.2f} TB/s "
          f"staged); v1 {rec['v1_us_per_step']:8.3f} us/step "
          f"{rec['v1_tflops']:6.1f} TFLOP/s ({rec['v1_staged_tbps']:.2f} TB/s)"
          f"; torch.matmul {rec['library_us_per_step']:8.3f} us/step "
          f"{rec['library_tflops']:6.1f} TFLOP/s; rel err {err:.2e} / "
          f"{v1_err:.2e}")
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
