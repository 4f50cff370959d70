# -*- coding: utf-8 -*-
"""
FE1 and FE2's own source, ``quakemigrate_torch/csrc/front_end.cu``,
compiled for the CPU, so the CPU tests can hold the kernels' code (their
blocked scan, walkers, term order and indexing) to the plain versions
bit for bit where there is no card and no nvcc.

A shim stands in for CUDA: each block's threads run as host threads
(``FE_THREADS`` of them), ``__syncthreads`` is a barrier across them,
dynamic shared memory is one static buffer (the blocks run one after
another), and the ``_rn`` intrinsics are the plain operators, compiled
with ``-ffp-contract=off`` so that each rounds once, as the intrinsics
do on the card. The launch syntax is rewritten into a call of the shim's
launcher. What the shim cannot show is what nvcc itself does; the card
run (chip_smoke.py's front_end_path) holds the compiled kernels to the
same plain versions.

"""

import ctypes
import hashlib
import pathlib
import re
import shutil
import subprocess

import numpy as np

from quakemigrate_torch import _build
from quakemigrate_torch.ops import cuda_front_end

SOURCE = _build.CSRC_DIR / "front_end.cu"

CUDA_RUNTIME = r"""
#pragma once
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = %(smem)d;
  return 0;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
"""

SHIM = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <thread>
#include <vector>
struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n)
#define __launch_bounds__(n)
#define __restrict__ __restrict
using std::max;
using std::min;
inline std::barrier<>* emu_barrier;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
alignas(16) unsigned char fe_smem[%(smem)d];
template <typename... P, typename... A>
void emu_launch(void (*kernel)(P...), int grid, int block, size_t,
                cudaStream_t, A... args) {
  blockDim.x = block;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    emu_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(args...);
      });
    }
    for (auto& th : threads) th.join();
  }
}
"""

_LAUNCH = re.compile(r"(\w+<\w+>)\s*<<<(.*?)>>>\(", re.S)
ENTRIES = [f"qm_front_end_{kind}_{suffix}" for kind in ("stalta", "kurtosis")
           for suffix in ("f32", "f64")]


def build(directory):
    """Compile the source with the shim into ``directory``; returns the
    loaded library (its four C entries typed)."""

    compiler = shutil.which("c++")
    if compiler is None:
        raise RuntimeError("no host C++ compiler (c++) on PATH")
    directory = pathlib.Path(directory)
    smem = cuda_front_end.MAX_STAGE_BYTES
    text = SOURCE.read_text()
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    lib_path = directory / f"front_end_host_{tag}.so"
    if not lib_path.is_file():
        (directory / "cuda_runtime.h").write_text(CUDA_RUNTIME % {
            "smem": smem})
        unit = directory / "front_end_host.cpp"
        unit.write_text('#include "cuda_runtime.h"\n' + SHIM % {"smem": smem}
                        + _LAUNCH.sub(r"emu_launch(\1, \2, ", text))
        subprocess.run([compiler, "-std=c++20", "-O2", "-ffp-contract=off",
                        "-shared", "-fPIC", "-pthread", "-I", str(directory),
                        "-o", str(lib_path), str(unit)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _suffix(dtype):
    return {np.float32: "f32", np.float64: "f64"}[np.dtype(dtype).type]


def fe1(lib, channels, chan_mask, slot_mask, nsta, nlta, position,
        transform, min_onset_value):
    """FE1's code on numpy arrays (the envelope for "env" and
    "env_squared" given as ``channels`` with transform "env"'s mode by
    the caller); returns (combined, available)."""

    channels = np.ascontiguousarray(channels)
    n_slots, c_max, t = channels.shape
    out = np.full((n_slots, t), -7.0, channels.dtype)
    available = np.zeros(1, channels.dtype)
    arrays = [channels, np.ascontiguousarray(chan_mask, channels.dtype),
              np.ascontiguousarray(slot_mask, channels.dtype),
              np.ascontiguousarray(nsta, np.int32),
              np.ascontiguousarray(nlta, np.int32), out, available]
    err = getattr(lib, f"qm_front_end_stalta_{_suffix(channels.dtype)}")(
        *map(_ptr, arrays), n_slots, c_max, t,
        cuda_front_end._POSITIONS[position],
        cuda_front_end._MODES[transform],
        *cuda_front_end._double_halves(min_onset_value), None)
    assert err == 0, err
    return out, available[0]


def fe2(lib, channels, chan_mask, slot_mask, nkurt, nsmooth, taper_pad,
        min_onset_value):
    """FE2's code on numpy arrays; returns (combined, available)."""

    channels = np.ascontiguousarray(channels)
    n_slots, c_max, t = channels.shape
    out = np.full((n_slots, t), -7.0, channels.dtype)
    work = np.full(channels.shape, -7.0, channels.dtype)
    available = np.zeros(1, channels.dtype)
    arrays = [channels, np.ascontiguousarray(chan_mask, channels.dtype),
              np.ascontiguousarray(slot_mask, channels.dtype),
              np.ascontiguousarray(nkurt, np.int32), work, out, available]
    err = getattr(lib, f"qm_front_end_kurtosis_{_suffix(channels.dtype)}")(
        *map(_ptr, arrays), n_slots, c_max, t, nsmooth, taper_pad,
        *cuda_front_end._double_halves(min_onset_value), None)
    assert err == 0, err
    return out, available[0]
