# -*- coding: utf-8 -*-
"""
Build and load the CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (sm_90a)
into one shared library with a plain C interface, under ``_build/`` in
the package (not versioned). The file name carries a hash of the sources
and flags, so an edited kernel is rebuilt and an unchanged one is
reused. The library is loaded with ctypes: pointers and the stream go
over as ``c_void_p``. A missing ``nvcc`` or a failed build raises.

"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int


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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libqm_torch_{digest.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path


@functools.lru_cache(maxsize=None)
def load_library():
    """Build if needed, load once per process, and declare the C API."""

    lib = ctypes.CDLL(str(build()))
    lib.qm_migrate_detect.argtypes = [
        _VOID_P, _INT, _VOID_P, _VOID_P, _VOID_P, _VOID_P,  # L .. inv_avail
        _VOID_P, _VOID_P, _VOID_P,  # tmax, targ, tsum
        _INT, _INT, _INT, _INT, _INT, _INT,  # O, tiles, tile, fsmp, S, span
        _VOID_P,  # stream
    ]
    lib.qm_migrate_detect.restype = _INT
    lib.qm_error_string.argtypes = [_INT]
    lib.qm_error_string.restype = ctypes.c_char_p
    return lib
