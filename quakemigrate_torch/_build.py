# -*- coding: utf-8 -*-
"""
Build and load the CUDA kernels of ``csrc/`` and the host C library of
``csrc/host/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (sm_90a),
one process per source, all started together, and links the objects into
one shared library with a plain C interface, under ``_build/`` in the
package (not versioned). The file name carries a hash of the sources,
their headers and the flags, so an edited kernel is rebuilt and an
unchanged one is reused. The library is loaded with ctypes: pointers and
the stream go over as ``c_void_p``. A missing ``nvcc`` or a failed build
raises.

The host library (the STEIM1/2 miniSEED codec and the fast-marching
eikonal solver, ``csrc/host/*.c``) is built the same way at its first
use, with the host C compiler ``cc`` instead of ``nvcc``, so the CPU path
needs no CUDA toolkit (:func:`build_host`). A missing ``cc`` or a failed
build raises.

"""

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
HOST_DIR = CSRC_DIR / "host"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17")
COMPILE_FLAGS = (*ARCH_FLAGS, "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The STEIM codec's difference and accumulator arithmetic relies on int32
# wraparound, which is undefined without -fwrapv.
HOST_FLAGS = ("-O2", "-fwrapv", "-shared", "-fPIC")

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int

# Argument types of the C API, per symbol (csrc/*.cu, extern "C").
_PLAN = [_VOID_P, _INT, _VOID_P, _VOID_P, _VOID_P, _VOID_P]  # L .. inv_avail
_OUTS = [_VOID_P, _VOID_P, _VOID_P]  # tmax, targ, tsum
SIGNATURES = {
    # ... O, tiles, tile, fsmp, S, span, stream
    "qm_migrate_detect": _PLAN + _OUTS + [_INT] * 6 + [_VOID_P],
    "qm_migrate_detect_vpu": _PLAN + _OUTS + [_INT] * 6 + [_VOID_P],
    # ... O, tiles, tile, fsmp, S, span, variant, stream
    "qm_migrate_detect_ablate": _PLAN + _OUTS + [_INT] * 7 + [_VOID_P],
    # L .. inv_avail, span_off, outs, O, tiles, tile, fsmp, S, win_floats,
    # (variant,) stream
    "qm_migrate_detect_v2": _PLAN + [_VOID_P] + _OUTS + [_INT] * 6 + [_VOID_P],
    "qm_migrate_detect_v2_ablate": (
        _PLAN + [_VOID_P] + _OUTS + [_INT] * 7 + [_VOID_P]
    ),
    # L, t_len, base, gbase, fine, valid, inv_avail, outs,
    # O, tiles, tile, group, fsmp, S, gwidth, stream
    "qm_migrate_detect_resident": (
        [_VOID_P, _INT, _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P] + _OUTS
        + [_INT] * 7 + [_VOID_P]
    ),
    # L, t_len, base, span_off, fine, valid, inv_avail, outs,
    # O, tiles, tile, fsmp, S, slot_floats, n_stages, blocks_per_sm, stream
    "qm_migrate_detect_pipelined": (
        [_VOID_P, _INT, _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P] + _OUTS
        + [_INT] * 8 + [_VOID_P]
    ),
    # L, t_len, ld, base, slab, valid, inv_avail, outs, O, tiles, tile,
    # fsmp, S, stride, box, n_stages, variant, stream
    "qm_migrate_detect_pipelined_v2": (
        [_VOID_P, _INT, _INT] + [_VOID_P] * 4 + _OUTS + [_INT] * 9
        + [_VOID_P]
    ),
    # L, t_len, ld, gbase, uoff, slab, valid, woff, inv_avail, outs, O,
    # tiles, tile, group, fsmp, S, win_floats, variant, stream
    "qm_migrate_detect_resident_v2": (
        [_VOID_P, _INT, _INT] + [_VOID_P] * 6 + _OUTS + [_INT] * 8
        + [_VOID_P]
    ),
    # L, t_len, ld, base, res, valid, inv_avail, outs, O, tiles, tile,
    # fsmp, S, stride, box, n_boxes, n_stages, stream
    "qm_migrate_detect_vpu_v2": (
        [_VOID_P, _INT, _INT] + [_VOID_P] * 4 + _OUTS + [_INT] * 9
        + [_VOID_P]
    ),
    # L, t_len, ld, base, slab, valid, tab, inv_avail, outs, O, tiles, tile,
    # fsmp, S, copy_floats, variant, stream
    "qm_migrate_detect_x16_v2": (
        [_VOID_P, _INT, _INT] + [_VOID_P] * 5 + _OUTS + [_INT] * 7
        + [_VOID_P]
    ),
    # L, t_len, ld, base, slab, valid, inv_avail, zeros, outs, O, tiles,
    # tile, fsmp, S, stride, box, packed, stream
    "qm_migrate_detect_probe_v2": (
        [_VOID_P, _INT, _INT] + [_VOID_P] * 5 + _OUTS + [_INT] * 8
        + [_VOID_P]
    ),
    # L, t_len, base, span_off, fine, valid, inv_available, zeros, outs,
    # O, tiles, tile, fsmp, S, slot_floats, packed, stream
    "qm_migrate_detect_probe": (
        [_VOID_P, _INT] + [_VOID_P] * 6 + _OUTS + [_INT] * 7 + [_VOID_P]
    ),
    # ... O, tiles, tile, fsmp, S, r_span, layout, stream
    "qm_migrate_detect_x16": _PLAN + _OUTS + [_INT] * 7 + [_VOID_P],
    # src, n_chunks, rows, n_total, out, stream
    "qm_stream_probe": [_VOID_P, _INT, _INT, _INT, _VOID_P, _VOID_P],
    # lhs, rhs, mode, K, M, N, stream
    "qm_dot_layout_fill": [_VOID_P, _VOID_P] + [_INT] * 4 + [_VOID_P],
    # lhs, rhs, out, mode, K, M, N, steps, stream
    "qm_dot_layout": [_VOID_P] * 3 + [_INT] * 5 + [_VOID_P],
    # lhs, rhs, rhs_half, out, mode, K, M, N, steps, stream
    "qm_dot_layout_v2": [_VOID_P] * 4 + [_INT] * 5 + [_VOID_P],
    # hi, lo, width, want, m_pad, a_off, fine, valid, inv_available, outs,
    # O, tiles, tile, S, a_sum, a_max, fuse, ablate, stream
    "qm_migrate_detect_x16g": (
        [_VOID_P, _VOID_P, _INT, _VOID_P, _INT] + [_VOID_P] * 4 + _OUTS
        + [_INT] * 8 + [_VOID_P]
    ),
    # hi, lo, width, want, m_pad, a_off (host), fine, valid, inv_available,
    # outs, O, tiles, tile, S, a_sum, ablate, stream
    "qm_migrate_detect_x16g_v2": (
        [_VOID_P, _VOID_P, _INT, _VOID_P, _INT] + [_VOID_P] * 4 + _OUTS
        + [_INT] * 6 + [_VOID_P]
    ),
    # L, t_len, tt, inv_available, outs, n_nodes, O, tile, fsmp, S, stream
    # (float32, and float64 for precision="double")
    "qm_migrate_detect_global": (
        [_VOID_P, _INT, _VOID_P, _VOID_P] + _OUTS + [_INT] * 5 + [_VOID_P]
    ),
    "qm_migrate_detect_global_f64": (
        [_VOID_P, _INT, _VOID_P, _VOID_P] + _OUTS + [_INT] * 5 + [_VOID_P]
    ),
    # L, ld, base, res, flat, win, inv_available, outs, O, tiles, fsmp,
    # S, group, stage_floats, n_stages, warps, npp, stream
    "qm_migrate_detect_global_v2": (
        [_VOID_P, _INT] + [_VOID_P] * 5 + _OUTS + [_INT] * 9 + [_VOID_P]
    ),
    "qm_migrate_detect_global_v2_f64": (
        [_VOID_P, _INT] + [_VOID_P] * 5 + _OUTS + [_INT] * 9 + [_VOID_P]
    ),
    # L, ld, base, res, flat, win, inv_available, outs, O, tiles, fsmp,
    # S, group, stage_floats, stage_passes, n_stages, npp, unroll, stream
    "qm_migrate_detect_global_v3_f64": (
        [_VOID_P, _INT] + [_VOID_P] * 5 + _OUTS + [_INT] * 10 + [_VOID_P]
    ),
    # L, t_len, base, fine, valid, perm, inv_available, out, partial,
    # partial_rows, n_nodes, O, tiles, tile, col0, len, stream
    "qm_migrate_marginalise": (
        [_VOID_P, _INT] + [_VOID_P] * 7 + [_INT] * 7 + [_VOID_P]
    ),
    "qm_migrate_marginalise_f64": (
        [_VOID_P, _INT] + [_VOID_P] * 7 + [_INT] * 7 + [_VOID_P]
    ),
    # L, t_len, base, fine16, valid, perm, inv_available, span_off, out,
    # partial, partial_rows, n_nodes, O, tiles, tile, col0, len,
    # win_floats, stream
    "qm_migrate_marginalise_v2": (
        [_VOID_P, _INT] + [_VOID_P] * 8 + [_INT] * 8 + [_VOID_P]
    ),
    # L, t_len, base, fine, valid, perm, inv_available, map, O, tiles,
    # tile, col0, S, stream
    "qm_migrate_map": [_VOID_P, _INT] + [_VOID_P] * 6 + [_INT] * 5 + [_VOID_P],
    "qm_migrate_map_f64": (
        [_VOID_P, _INT] + [_VOID_P] * 6 + [_INT] * 5 + [_VOID_P]
    ),
    # L, t_len, base, fine16, valid, perm, inv_available, span_off, map,
    # O, tiles, tile, col0, S, win_floats, stream
    "qm_migrate_map_v2": (
        [_VOID_P, _INT] + [_VOID_P] * 7 + [_INT] * 6 + [_VOID_P]
    ),
    # L, ld, base, res, flat, win, inv_available, out, partial,
    # partial_rows, n_nodes, O, tiles, tile, fsmp, start, len, group,
    # stage_floats, n_stages, warps, npp, split, stream
    "qm_migrate_marginalise_ring": (
        [_VOID_P, _INT] + [_VOID_P] * 7 + [_INT] * 14 + [_VOID_P]
    ),
    "qm_migrate_marginalise_ring_f64": (
        [_VOID_P, _INT] + [_VOID_P] * 7 + [_INT] * 14 + [_VOID_P]
    ),
    # L, ld, base, res, flat, win, inv_available, map, O, tiles, tile,
    # fsmp, S, group, stage_floats, n_stages, warps, npp, split, stream
    "qm_migrate_map_ring": (
        [_VOID_P, _INT] + [_VOID_P] * 6 + [_INT] * 11 + [_VOID_P]
    ),
    "qm_migrate_map_ring_f64": (
        [_VOID_P, _INT] + [_VOID_P] * 6 + [_INT] * 11 + [_VOID_P]
    ),
    # L, ld, base, res, flat, items, woff, inv_available, map, counter, O,
    # n_items, runs, parts, npi, fsmp, S, stage_floats, n_stages, nif, spn,
    # minb, variant, stream
    "qm_migrate_map_persistent": (
        [_VOID_P, _INT] + [_VOID_P] * 8 + [_INT] * 13 + [_VOID_P]
    ),
    # fine16, base, valid, perm, woff, res, flat, O, tiles, tile, parts,
    # npi, fsmp, t_len4, stream
    "qm_migrate_map_persistent_tables": (
        [_VOID_P] * 7 + [_INT] * 7 + [_VOID_P]
    ),
    # occupancy queries: (O, r_span), (O, tile, win_floats) and
    # (O, r_span, layout)
    "qm_migrate_detect_blocks_per_sm": [_INT] * 2,
    "qm_migrate_detect_v2_blocks_per_sm": [_INT] * 3,
    "qm_migrate_detect_x16_blocks_per_sm": [_INT] * 3,
    # (O, tile, stride, n_stages) and (O, tile, win_floats)
    "qm_migrate_detect_pipelined_v2_blocks_per_sm": [_INT] * 4,
    "qm_migrate_detect_resident_v2_blocks_per_sm": [_INT] * 3,
    # (O, tile, copy_floats) and (O, tile, stride)
    "qm_migrate_detect_x16_v2_blocks_per_sm": [_INT] * 3,
    "qm_migrate_detect_probe_v2_blocks_per_sm": [_INT] * 3,
    # (tile, stride, n_stages)
    "qm_migrate_detect_vpu_v2_blocks_per_sm": [_INT] * 3,
    # (warps, npp, group, stage_floats, n_stages)
    "qm_migrate_detect_global_v2_blocks_per_sm": [_INT] * 5,
    "qm_migrate_detect_global_v2_f64_blocks_per_sm": [_INT] * 5,
    # (npp, unroll, group, stage_floats, stage_passes, n_stages)
    "qm_migrate_detect_global_v3_f64_blocks_per_sm": [_INT] * 6,
    # (O, a_sum, a_max, fuse) and (a_sum)
    "qm_migrate_detect_x16g_blocks_per_sm": [_INT] * 4,
    "qm_migrate_detect_x16g_v2_blocks_per_sm": [_INT],
    # (O, tile, win_floats, len)
    "qm_migrate_marginalise_v2_blocks_per_sm": [_INT] * 4,
    # (warps, npp, slots, map, group, stage_floats, n_stages)
    "qm_migrate_ring_blocks_per_sm": [_INT] * 7,
    "qm_migrate_ring_f64_blocks_per_sm": [_INT] * 7,
    # (nif, spn, minb, O, npi, stage_floats, n_stages)
    "qm_migrate_map_persistent_blocks_per_sm": [_INT] * 7,
    # x, out, rows, n, nsta, nlta, stream
    "qm_recursive_stalta_f32": [_VOID_P, _VOID_P] + [_INT] * 4 + [_VOID_P],
    "qm_recursive_stalta_f64": [_VOID_P, _VOID_P] + [_INT] * 4 + [_VOID_P],
    # channels, chan_mask, slot_mask, nsta, nlta, out, available, n_slots,
    # c_max, t, centred, mode, min_onset (low, high halves), stream
    "qm_front_end_stalta_f32": [_VOID_P] * 7 + [_INT] * 7 + [_VOID_P],
    "qm_front_end_stalta_f64": [_VOID_P] * 7 + [_INT] * 7 + [_VOID_P],
    # channels, chan_mask, slot_mask, nkurt, work, out, available, n_slots,
    # c_max, t, nsmooth, taper_pad, min_onset (low, high halves), stream
    "qm_front_end_kurtosis_f32": [_VOID_P] * 7 + [_INT] * 7 + [_VOID_P],
    "qm_front_end_kurtosis_f64": [_VOID_P] * 7 + [_INT] * 7 + [_VOID_P],
    # channels, chan_mask, slot_mask, nsta, nlta, out, available,
    # workspace, n_slots, c_max, t, centred, mode, min_onset (low, high
    # halves), stream
    "qm_front_end_stalta_v2_f32": [_VOID_P] * 8 + [_INT] * 7 + [_VOID_P],
    "qm_front_end_stalta_v2_f64": [_VOID_P] * 8 + [_INT] * 7 + [_VOID_P],
    # channels, chan_mask, slot_mask, nkurt, out, available, workspace,
    # n_slots, c_max, t, nsmooth, taper_pad, min_onset (low, high halves),
    # stream
    "qm_front_end_kurtosis_v2_f32": [_VOID_P] * 7 + [_INT] * 7 + [_VOID_P],
    "qm_front_end_kurtosis_v2_f64": [_VOID_P] * 7 + [_INT] * 7 + [_VOID_P],
    # x, offsets, out, ws, units, t, ws_unit, nsta, nlta, centred, mode,
    # lo_edge, hi_edge, frac (low, high halves), min_onset (low, high
    # halves), stream
    "qm_onset_stalta_f32": [_VOID_P] * 4 + [_INT] * 13 + [_VOID_P],
    "qm_onset_stalta_f64": [_VOID_P] * 4 + [_INT] * 13 + [_VOID_P],
    # x, offsets, out, ws, units, t, ws_unit, nkurt, nsmooth, lo_edge,
    # hi_edge, min_onset (low, high halves), stream
    "qm_onset_kurtosis_f32": [_VOID_P] * 4 + [_INT] * 9 + [_VOID_P],
    "qm_onset_kurtosis_f64": [_VOID_P] * 4 + [_INT] * 9 + [_VOID_P],
    # (kurtosis, f64)
    "qm_onset_blocks_per_sm": [_INT] * 2,
    # x, offsets, out, workspace, units, rows, t, nsta, nlta, centred, mode,
    # lo_edge, hi_edge, frac (low, high halves), min_onset (low, high
    # halves), stream
    "qm_onset_stalta_v2_f32": [_VOID_P] * 4 + [_INT] * 13 + [_VOID_P],
    "qm_onset_stalta_v2_f64": [_VOID_P] * 4 + [_INT] * 13 + [_VOID_P],
    # x, offsets, out, workspace, units, rows, t, nkurt, nsmooth, lo_edge,
    # hi_edge, min_onset (low, high halves), stream
    "qm_onset_kurtosis_v2_f32": [_VOID_P] * 4 + [_INT] * 9 + [_VOID_P],
    "qm_onset_kurtosis_v2_f64": [_VOID_P] * 4 + [_INT] * 9 + [_VOID_P],
    # (kurtosis, units, rows, t, itemsize); returns long long bytes
    "qm_onset_v2_workspace_bytes": [_INT] * 5,
    # (kurtosis, f64)
    "qm_onset_v2_blocks_per_sm": [_INT] * 2,
    # (kurtosis, n_slots, c_max, t, itemsize); returns long long bytes
    "qm_front_end_v2_workspace_bytes": [_INT] * 5,
    # (kurtosis, f64, c_max)
    "qm_front_end_v2_blocks_per_sm": [_INT] * 3,
    # err; returns a C string
    "qm_error_string": [_INT],
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.access(candidate, os.X_OK):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
        "quakemigrate_torch cannot be built"
    )


def _run_all(cmds, tool="nvcc"):
    """Start every command at once, wait for all; raise on the first
    failure with its output. Returns the outputs in order."""

    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for cmd in cmds
    ]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"{tool} failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
            )
    return outputs


def build():
    """
    Compile ``csrc/*.cu`` unless the library for these sources and flags
    exists. Returns its path. The compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside it
    with suffix ``.log``.

    """

    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libqm_torch_{digest.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    logs = _run_all([
        [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
        for src, obj in zip(sources, objects)
    ])
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objects)]])
    for obj in objects:
        obj.unlink()
    lib_path.with_suffix(".log").write_text("".join(
        f"== {src.name}\n{log}" for src, log in zip(sources, logs)
    ))
    os.replace(tmp, lib_path)
    return lib_path


def build_host():
    """
    Compile ``csrc/host/*.c`` with the host C compiler unless the library
    for these sources and flags exists; returns its path. Built into a
    temporary file and renamed into place, so concurrent processes never
    load a half-written library.

    """

    sources = sorted(HOST_DIR.glob("*.c"))
    if not sources:
        raise RuntimeError(f"no host C sources in {HOST_DIR}")
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libqm_host_{digest.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path
    cc = shutil.which("cc")
    if cc is None:
        raise RuntimeError(
            "cc not found on PATH; the host library of quakemigrate_torch "
            "(the STEIM codec, csrc/host/steimlib.c, and the fast-marching "
            "solver, csrc/host/fmmlib.c) cannot be built"
        )
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    _run_all([[cc, *HOST_FLAGS, "-o", str(tmp), *map(str, sources), "-lm"]],
             tool="cc")
    os.replace(tmp, lib_path)
    return lib_path


@functools.lru_cache(maxsize=None)
def load_library():
    """Build if needed, load once per process, and declare the C API."""

    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    lib.qm_error_string.restype = ctypes.c_char_p
    lib.qm_front_end_v2_workspace_bytes.restype = ctypes.c_longlong
    lib.qm_onset_v2_workspace_bytes.restype = ctypes.c_longlong
    return lib


def ptxas_report(log, kernel):
    """
    What ``-Xptxas -v`` says in the build log ``log`` (text) of each
    compiled entry function whose mangled name contains ``kernel``: {name:
    {"registers", "spill_stores", "spill_loads" (bytes), "wgmma_serialized"
    (ptxas's warning that it serialized the function's wgmma)}}.

    """

    report, current, serialized = {}, None, []
    for line in log.splitlines():
        if "wgmma" in line and "serialized" in line:
            serialized.append(line)
            continue
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            current = m.group(1) if kernel in m.group(1) else None
            if current is not None and current not in report:
                report[current] = {"registers": None, "spill_stores": None,
                                   "spill_loads": None,
                                   "wgmma_serialized": False}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[current]["spill_stores"] = int(m.group(1))
            report[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[current]["registers"] = int(m.group(1))
    for name, entry in report.items():
        entry["wgmma_serialized"] = any(name in line for line in serialized)
    return report


def kernel_resources(kernel):
    """:func:`ptxas_report` of the built library's log (building it if
    needed)."""

    return ptxas_report(build().with_suffix(".log").read_text(), kernel)
