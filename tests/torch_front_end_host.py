# -*- coding: utf-8 -*-
"""
The onset front ends' own sources compiled for the CPU, so the CPU tests
can hold the kernels' code (their blocked scans, term order, indexing and,
for FE1 v2 and FE2 v2, their tiles' publication and waits) to the plain
versions bit for bit where there is no card and no nvcc:
``quakemigrate_torch/csrc/front_end.cu`` (FE1, FE2; :func:`build`),
``csrc/front_end_v2.cu`` (FE1 v2, FE2 v2; :func:`build_v2`) and
``csrc/locate_onsets.cu`` (ON1, ON2, locate's onsets; :func:`build_onsets`).

A shim stands in for CUDA: a block's threads run as host threads
(``FE_THREADS`` or ``FV_THREADS`` of them, or as many as
``emu_set_threads`` says, since the kernels stride every loop by the
block's size), which run the grid's blocks one after another in block
order, so tiles take the launch's counter in that order;
``__syncthreads`` is a barrier across them, dynamic shared memory is one
static buffer, the ``_rn`` intrinsics are the plain operators, compiled
with ``-ffp-contract=off`` so that each rounds once, as the intrinsics do
on the card, and the flags' acquire and release are the compiler's
atomics. A tile that waits on a flag no earlier tile has set (on a later
tile: the card could deadlock there) makes the launch return an error.
The launch syntax is rewritten into a call of the shim's launcher. What
the shim cannot show is what nvcc itself does, or tiles running at once;
the card run (chip_smoke.py's front_end_path) holds the compiled kernels
to the same plain versions.

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

CUDA_RUNTIME = r"""
#pragma once
#include <atomic>
#include <cstring>
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline std::atomic<bool> emu_failed{false};
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? %(sms)d : %(smem)d;
  return 0;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
inline cudaError_t cudaGetLastError() { return emu_failed.exchange(false); }
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
#define __launch_bounds__(...)
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
template <typename T> inline T __ldcg(const T* p) { return *p; }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void fv_release(int* p, int v) {
  __atomic_store_n(p, v, __ATOMIC_RELEASE);
}
// Blocks run in counter order, so every flag a tile waits on is set
inline void fv_wait(const int* flag, int at_least) {
  if (__atomic_load_n(flag, __ATOMIC_ACQUIRE) < at_least) emu_failed = true;
}
inline void ov_release(int* p, int v) { fv_release(p, v); }
inline void ov_wait(const int* flag, int at_least) { fv_wait(flag, at_least); }
alignas(16) unsigned char %(smem_name)s[%(smem)d];
inline int emu_threads = 0;
extern "C" void emu_set_threads(int n) { emu_threads = n; }
template <typename... P, typename... A>
void emu_launch(void (*kernel)(P...), int grid, int block, size_t smem,
                cudaStream_t, A... args) {
  if (smem > sizeof %(smem_name)s) {
    emu_failed = true;
    return;
  }
  if (emu_threads > 0) block = emu_threads;
  blockDim.x = block;
  gridDim.x = grid;
  std::barrier<> bar(block);
  emu_barrier = &bar;
  std::vector<std::thread> threads;
  for (int t = 0; t < block; ++t) {
    threads.emplace_back([=, &bar] {
      threadIdx.x = t;
      for (int b = 0; b < grid; ++b) {
        blockIdx.x = b;
        kernel(args...);
        bar.arrive_and_wait();
      }
    });
  }
  for (auto& th : threads) th.join();
}
"""

_LAUNCH = re.compile(r"(\w+<\w+>)\s*<<<(.*?)>>>\(", re.S)
ENTRIES = [f"qm_front_end_{kind}_{suffix}" for kind in ("stalta", "kurtosis")
           for suffix in ("f32", "f64")]
ENTRIES_V2 = [f"qm_front_end_{kind}_v2_{suffix}"
              for kind in ("stalta", "kurtosis") for suffix in ("f32", "f64")]
# Shared memory the shim holds for FE1 v2 and FE2 v2 (a launch asks for
# at most 16 bytes, 256 values and FV_BUDGET)
V2_SMEM = 48 * 1024
ENTRIES_ONSETS = [f"qm_onset_{kind}_{suffix}" for kind in ("stalta", "kurtosis")
                  for suffix in ("f32", "f64")]
# Shared memory the shim holds for ON1 and ON2 (a tile of ON_STAGE doubles)
ONSETS_SMEM = 4352 * 8
ENTRIES_ONSETS_V2 = [f"qm_onset_{kind}_v2_{suffix}"
                     for kind in ("stalta", "kurtosis")
                     for suffix in ("f32", "f64")]
# Shared memory the shim holds for ON1 v2 and ON2 v2 (a launch asks for at
# most ~110 KB)
ONSETS_V2_SMEM = 128 * 1024
# SMs the shim reports (the H100's), from which ON1 v2 and ON2 v2 pick
# their short rows' segments
SMS = 132


def _compile(directory, source, smem_name, smem, entries):
    compiler = shutil.which("c++")
    if compiler is None:
        raise RuntimeError("no host C++ compiler (c++) on PATH")
    directory = pathlib.Path(directory)
    text = (_build.CSRC_DIR / source).read_text()
    digest = hashlib.sha256(text.encode())
    digest.update((_build.CSRC_DIR / "front_end_math.cuh").read_bytes())
    digest.update((CUDA_RUNTIME + SHIM).encode())
    stem = pathlib.Path(source).stem
    lib_path = directory / f"{stem}_host_{digest.hexdigest()[:12]}.so"
    if not lib_path.is_file():
        (directory / "cuda_runtime.h").write_text(CUDA_RUNTIME % {
            "smem": smem, "sms": SMS})
        unit = directory / f"{stem}_host.cpp"
        unit.write_text('#include "cuda_runtime.h"\n'
                        + SHIM % {"smem": smem, "smem_name": smem_name}
                        + _LAUNCH.sub(r"emu_launch(\1, \2, ", text))
        subprocess.run([compiler, "-std=c++20", "-O2", "-ffp-contract=off",
                        "-shared", "-fPIC", "-pthread", "-I", str(directory),
                        "-I", str(_build.CSRC_DIR),
                        "-o", str(lib_path), str(unit)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.emu_set_threads.argtypes = [ctypes.c_int]
    lib.emu_set_threads.restype = None
    return lib


def build(directory):
    """Compile FE1 and FE2's source with the shim into ``directory``;
    returns the loaded library (its four C entries typed)."""

    return _compile(directory, "front_end.cu", "fe_smem",
                    cuda_front_end.MAX_STAGE_BYTES, ENTRIES)


def build_v2(directory):
    """Compile FE1 v2 and FE2 v2's source with the shim into
    ``directory``; returns the loaded library (its four launches, its
    workspace size and ``emu_set_threads`` typed)."""

    lib = _compile(directory, "front_end_v2.cu", "fv_smem", V2_SMEM,
                   ENTRIES_V2)
    name = "qm_front_end_v2_workspace_bytes"
    getattr(lib, name).argtypes = _build.SIGNATURES[name]
    getattr(lib, name).restype = ctypes.c_longlong
    return lib


def build_onsets(directory):
    """Compile ON1 and ON2's source with the shim into ``directory``;
    returns the loaded library (its four launches and ``emu_set_threads``
    typed)."""

    return _compile(directory, "locate_onsets.cu", "on_smem", ONSETS_SMEM,
                    ENTRIES_ONSETS)


def build_onsets_v2(directory):
    """Compile ON1 v2 and ON2 v2's source with the shim into
    ``directory``; returns the loaded library (its four launches, its
    workspace size and ``emu_set_threads`` typed)."""

    lib = _compile(directory, "locate_onsets_v2.cu", "ov_smem",
                   ONSETS_V2_SMEM, ENTRIES_ONSETS_V2)
    name = "qm_onset_v2_workspace_bytes"
    getattr(lib, name).argtypes = _build.SIGNATURES[name]
    getattr(lib, name).restype = ctypes.c_longlong
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _suffix(dtype):
    return {np.float32: "f32", np.float64: "f64"}[np.dtype(dtype).type]


def _arrays(channels, chan_mask, slot_mask, lengths):
    """The block's arrays as the C entries take them, and the outputs
    (filled with -7)."""

    channels = np.ascontiguousarray(channels)
    n_slots, _, t = channels.shape
    out = np.full((n_slots, t), -7.0, channels.dtype)
    available = np.zeros(1, channels.dtype)
    arrays = [channels, np.ascontiguousarray(chan_mask, channels.dtype),
              np.ascontiguousarray(slot_mask, channels.dtype),
              *(np.ascontiguousarray(n, np.int32) for n in lengths)]
    return channels, out, available, arrays


def fe1(lib, channels, chan_mask, slot_mask, nsta, nlta, position,
        transform, min_onset_value):
    """FE1's code on numpy arrays (the envelope for "env" and
    "env_squared" given as ``channels`` with transform "env"'s mode by
    the caller); returns (combined, available)."""

    channels, out, available, arrays = _arrays(channels, chan_mask,
                                               slot_mask, (nsta, nlta))
    err = getattr(lib, f"qm_front_end_stalta_{_suffix(channels.dtype)}")(
        *map(_ptr, arrays + [out, available]), *channels.shape,
        cuda_front_end._POSITIONS[position],
        cuda_front_end._MODES[transform],
        *cuda_front_end._double_halves(min_onset_value), None)
    assert err == 0, err
    return out, available[0]


def fe2(lib, channels, chan_mask, slot_mask, nkurt, nsmooth, taper_pad,
        min_onset_value):
    """FE2's code on numpy arrays; returns (combined, available)."""

    channels, out, available, arrays = _arrays(channels, chan_mask,
                                               slot_mask, (nkurt,))
    work = np.full(channels.shape, -7.0, channels.dtype)
    err = getattr(lib, f"qm_front_end_kurtosis_{_suffix(channels.dtype)}")(
        *map(_ptr, arrays + [work, out, available]), *channels.shape,
        nsmooth, taper_pad, *cuda_front_end._double_halves(min_onset_value),
        None)
    assert err == 0, err
    return out, available[0]


def _workspace(lib, kurtosis, channels):
    """A launch's workspace, filled with a byte pattern: the kernels zero
    what they wait on and write what they read."""

    nbytes = lib.qm_front_end_v2_workspace_bytes(
        kurtosis, *channels.shape, channels.itemsize)
    assert nbytes > 0, nbytes
    return np.full(nbytes, 0x5A, np.uint8)


def fe1_v2(lib, channels, chan_mask, slot_mask, nsta, nlta, position,
           transform, min_onset_value, threads=0):
    """FE1 v2's code on numpy arrays, as :func:`fe1`; ``threads`` a
    block's threads (0: the launch's own, FV_THREADS)."""

    channels, out, available, arrays = _arrays(channels, chan_mask,
                                               slot_mask, (nsta, nlta))
    lib.emu_set_threads(threads)
    err = getattr(lib, f"qm_front_end_stalta_v2_{_suffix(channels.dtype)}")(
        *map(_ptr, arrays + [out, available,
                             _workspace(lib, 0, channels)]),
        *channels.shape, cuda_front_end._POSITIONS[position],
        cuda_front_end._MODES[transform],
        *cuda_front_end._double_halves(min_onset_value), None)
    assert err == 0, err
    return out, available[0]


def fe2_v2(lib, channels, chan_mask, slot_mask, nkurt, nsmooth, taper_pad,
           min_onset_value, threads=0):
    """FE2 v2's code on numpy arrays, as :func:`fe2`; ``threads`` as
    :func:`fe1_v2`'s."""

    channels, out, available, arrays = _arrays(channels, chan_mask,
                                               slot_mask, (nkurt,))
    lib.emu_set_threads(threads)
    err = getattr(
        lib, f"qm_front_end_kurtosis_v2_{_suffix(channels.dtype)}")(
        *map(_ptr, arrays + [out, available,
                             _workspace(lib, 1, channels)]),
        *channels.shape, nsmooth, taper_pad,
        *cuda_front_end._double_halves(min_onset_value), None)
    assert err == 0, err
    return out, available[0]


def _onset_call(lib, kind, x, offsets, kurtosis, threads, settings):
    """One launch of ON1 or ON2's code on rows ``x`` [rows, t] (offsets
    None: rows mode); the workspace filled with -7 (the kernels write what
    they read), the output with -9."""

    from quakemigrate_torch.ops import cuda_onsets

    x = np.ascontiguousarray(x)
    rows, t = x.shape
    units = rows if offsets is None else len(offsets) - 1
    out = np.full((units, t), -9.0, x.dtype)
    ws_unit = cuda_onsets.unit_values(t, kurtosis)
    ws = np.full(units * ws_unit, -7.0, x.dtype)
    offsets_c = (None if offsets is None
                 else _ptr(np.ascontiguousarray(offsets, np.int32)))
    lib.emu_set_threads(threads)
    err = getattr(lib, f"qm_onset_{kind}_{_suffix(x.dtype)}")(
        _ptr(x), offsets_c, _ptr(out), _ptr(ws), units, t, ws_unit,
        *settings, None)
    assert err == 0, err
    return out


def on1(lib, x, nsta, nlta, position, mode, offsets=None, edges=None,
        min_onset_value=1.0, threads=0):
    """ON1's code on numpy rows ``x`` [rows, t]: rows mode (``offsets``
    None, the samples taken as they are: ``mode`` "env") or stations mode
    (``mode`` the transform's, "energy", "abs" or "env" for a given
    envelope); ``threads`` a block's threads (0: ON_THREADS)."""

    lo, hi = edges if edges is not None else (0, x.shape[-1])
    return _onset_call(lib, "stalta", x, offsets, False, threads, (
        nsta, nlta, cuda_front_end._POSITIONS[position],
        cuda_front_end._MODES[mode], lo, hi,
        *cuda_front_end._double_halves(nlta / nsta),
        *cuda_front_end._double_halves(min_onset_value)))


def on2(lib, x, nkurt, nsmooth, offsets=None, edges=None,
        min_onset_value=1.0, threads=0):
    """ON2's code on numpy rows ``x`` [rows, t], as :func:`on1`."""

    lo, hi = edges if edges is not None else (0, x.shape[-1])
    return _onset_call(lib, "kurtosis", x, offsets, True, threads, (
        nkurt, nsmooth, lo, hi,
        *cuda_front_end._double_halves(min_onset_value)))


def _onset_v2_call(lib, kind, x, offsets, kurtosis, threads, settings):
    """One launch of ON1 v2 or ON2 v2's code on rows ``x`` [rows, t]
    (offsets None: rows mode); the workspace, where the rows need one,
    filled with a byte pattern (the kernels zero what they wait on and
    write what they read), the output with -9."""

    x = np.ascontiguousarray(x)
    rows, t = x.shape
    units = rows if offsets is None else len(offsets) - 1
    out = np.full((units, t), -9.0, x.dtype)
    nbytes = lib.qm_onset_v2_workspace_bytes(int(kurtosis), units, rows, t,
                                             x.itemsize)
    assert nbytes >= 0, nbytes
    ws = np.full(max(nbytes, 16), 0x5A, np.uint8) if nbytes else None
    offsets_c = (None if offsets is None
                 else _ptr(np.ascontiguousarray(offsets, np.int32)))
    lib.emu_set_threads(threads)
    err = getattr(lib, f"qm_onset_{kind}_v2_{_suffix(x.dtype)}")(
        _ptr(x), offsets_c, _ptr(out), None if ws is None else _ptr(ws),
        units, rows, t, *settings, None)
    assert err == 0, err
    return out


def on1_v2(lib, x, nsta, nlta, position, mode, offsets=None, edges=None,
           min_onset_value=1.0, threads=0):
    """ON1 v2's code on numpy rows ``x`` [rows, t], as :func:`on1`;
    ``threads`` a block's threads (0: OV_THREADS)."""

    lo, hi = edges if edges is not None else (0, x.shape[-1])
    return _onset_v2_call(lib, "stalta", x, offsets, False, threads, (
        nsta, nlta, cuda_front_end._POSITIONS[position],
        cuda_front_end._MODES[mode], lo, hi,
        *cuda_front_end._double_halves(nlta / nsta),
        *cuda_front_end._double_halves(min_onset_value)))


def on2_v2(lib, x, nkurt, nsmooth, offsets=None, edges=None,
           min_onset_value=1.0, threads=0):
    """ON2 v2's code on numpy rows ``x`` [rows, t], as :func:`on2`."""

    lo, hi = edges if edges is not None else (0, x.shape[-1])
    return _onset_v2_call(lib, "kurtosis", x, offsets, True, threads, (
        nkurt, nsmooth, lo, hi,
        *cuda_front_end._double_halves(min_onset_value)))
