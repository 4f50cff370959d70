# -*- coding: utf-8 -*-
"""
Where ON1 v2's long-row tiles spend their time, and what its forms cost:
copies of ``csrc/locate_onsets_v2.cu`` built apart from the kernel library.

- Forms: the source with its block size, ON1 v2's outputs a pass and its
  resident blocks an SM changed (the ``FORMS`` below), each built with
  nvcc, its registers and spills from ptxas, and timed queued behind a
  hold (``exp_kernel_breakdown.queued_ms``) in turns (forms in order, then
  reversed) at core.compat's (256, 360,000) float32 rows (classic, nsta
  200, nlta 5,000) and at 120,000 float32 samples (3 rows, 2 stations),
  each held bit for bit to the plain version.
- Phases: the shipped form with a timestamp (``%globaltimer``) written by
  each tile at its phases' ends, at compat's rows: a tile's time from its
  ticket to its level-3 values (local), to its wait's end (publish and
  wait), to its C_2 published, to its windows staged (copies, flags and
  C_1), to its running sums, to its outputs; medians and 90th
  percentiles over the tiles.

    python3 -m quakemigrate_torch.experiments.onset_trace [--out PATH]

Run from the root of a checkout on a machine with CUDA and nvcc; prints
the card's name and power limit and one JSON line, also written to
``--out`` where given. Exits non-zero without CUDA.

"""

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from quakemigrate_torch import _build
from quakemigrate_torch.experiments.exp_kernel_breakdown import queued_ms
from quakemigrate_torch.ops import cuda_front_end as cfe
from quakemigrate_torch.ops import stalta as sops

SOURCE = _build.CSRC_DIR / "locate_onsets_v2.cu"
# name: {constant: value}; the first is the shipped form
FORMS = {
    "shipped": {},
    "4 blocks": {"OV1_MIN_BLOCKS_F32": 4},
    "128 threads, 2,048 a pass": {"OV_THREADS": 128, "OV_CH1": 2048,
                                  "OV1_MIN_BLOCKS_F32": 6},
}
# The phases' ends a tile stamps (after its ticket: stamp 0)
PHASES = ("local", "publish and wait", "C_2 published", "windows staged",
          "running sums", "outputs")
STAMPS = 8
_TRACE = """
__device__ unsigned long long ov_trace[%(n)d * %(s)d];
__shared__ int ov_slot;
__device__ __forceinline__ unsigned long long ov_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define OV_STAMP(k)                                       \\
  do {                                                    \\
    if (threadIdx.x == 0) ov_trace[ov_slot * %(s)d + (k)] = ov_now(); \\
  } while (0)
extern "C" int ov_trace_get(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, ov_trace,
                                   (size_t)n * %(s)d * 8);
}
"""
# (anchor in the source, where the hook goes: before or after it, or
# "inside": the hook replaces it and repeats it)
_HOOKS = [
    ("  int k = blockIdx.x;\n", "after",
     "  if (threadIdx.x == 0) ov_slot = blockIdx.x;\n  OV_STAMP(0);\n"),
    ("  ov_publish(flags + g, 1);\n", "before", "  OV_STAMP(1);\n"),
    ("  __syncthreads();\n  // C_2 of the level-2 value before", "inside",
     "  __syncthreads();\n  OV_STAMP(2);\n"
     "  // C_2 of the level-2 value before"),
    ("  ov_publish(flag_c1 + g, 1);\n", "after", "  OV_STAMP(3);\n"),
    ("    ov_stage(f, row, t, w, 3, sums, st, st.xs != nullptr);\n", "after",
     "    OV_STAMP(4);\n"),
    ("    ov_sums(f, w, 3, st, sums.outer);\n    __syncthreads();\n", "after",
     "    OV_STAMP(5);\n"),
    ("  ov_tile_work(OvTransform<T>{mode}, op, x, offsets, out, ints, vals, "
     "ws, gr,\n               units, t, lo_edge, hi_edge, min_onset, "
     "ov_smem);\n", "after", "  __syncthreads();\n  OV_STAMP(7);\n"),
]


def form_source(text, constants):
    """The source with each ``#define NAME value`` of ``constants``
    replaced."""

    for name, value in constants.items():
        text, n = re.subn(rf"#define {name} \d+", f"#define {name} {value}",
                          text)
        if n != 1:
            raise RuntimeError(f"onset_trace: no #define {name} in {SOURCE}")
    return text


def traced_source(text, tiles):
    """The source with OV_STAMP hooks at the phases' ends of ON1 v2."""

    head = '#include "front_end_math.cuh"\n'
    text = text.replace(head, head + _TRACE % {"n": tiles, "s": STAMPS}, 1)
    for anchor, where, hook in _HOOKS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"onset_trace: hook anchor not found once: "
                               f"{anchor!r}")
        new = {"before": hook + anchor, "after": anchor + hook,
               "inside": hook}[where]
        text = text.replace(anchor, new)
    return text


def build(sources, directory):
    """nvcc each {name: text} into a shared library at once; returns
    {name: (ctypes library, ptxas report of ON1 v2 and ON2 v2)}."""

    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = pathlib.Path(directory) / f"form{i}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, "-shared", "-I",
             str(_build.CSRC_DIR), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"onset_trace: nvcc failed for {name}:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for entry in ("qm_onset_stalta_v2_f32", "qm_onset_stalta_v2_f64"):
            getattr(handle, entry).argtypes = _build.SIGNATURES[entry]
            getattr(handle, entry).restype = ctypes.c_int
        handle.qm_onset_v2_workspace_bytes.argtypes = [ctypes.c_int] * 5
        handle.qm_onset_v2_workspace_bytes.restype = ctypes.c_longlong
        report = {k: {kk: v[kk] for kk in ("registers", "spill_stores",
                                           "spill_loads")}
                  for k, v in _build.ptxas_report(log, "qm_ov").items()}
        out[name] = (handle, report)
    return out


def on1_call(lib, x, offsets, nsta, nlta):
    """A call of the library's ON1 v2 (classic, the samples as they are in
    rows mode, else energy) on rows ``x``: a function that launches it and
    returns the output."""

    rows, t = x.shape
    units = rows if offsets is None else len(offsets) - 1
    nbytes = lib.qm_onset_v2_workspace_bytes(0, units, rows, t,
                                             x.element_size())
    ws = torch.empty(max(nbytes, 16), dtype=torch.uint8, device=x.device)
    out = torch.empty(units, t, dtype=x.dtype, device=x.device)
    off = (None if offsets is None else
           torch.tensor(offsets, dtype=torch.int32, device=x.device))
    entry = getattr(lib, "qm_onset_stalta_v2_"
                         + ("f64" if x.dtype == torch.float64 else "f32"))
    mode = cfe._MODES["env" if offsets is None else "energy"]
    settings = (nsta, nlta, 0, mode, 0, t, *cfe._double_halves(nlta / nsta),
                *cfe._double_halves(1.0 if offsets is None else 0.4))

    def call():
        err = entry(x.data_ptr(), None if off is None else off.data_ptr(),
                    out.data_ptr(), ws.data_ptr() if nbytes else None, units,
                    rows, t, *settings,
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"onset_trace: launch failed ({err})")
        return out

    return call


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("onset_trace: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(2060)
    compat = torch.from_numpy(
        rng.standard_normal((256, 360_000), dtype=np.float32) ** 2).to(device)
    long = torch.from_numpy(
        rng.standard_normal((3, 120_000), dtype=np.float32)).to(device)
    cases = {
        "compat (256, 360000) float32":
            (compat, None, 200, 5000,
             sops.overlapping_sta_lta_plain(compat, 200, 5000)),
        "120000 float32, 2 stations":
            (long, [0, 1, 3], 250, 2500,
             sops.station_sta_lta_plain(long, [0, 1, 3], 250, 2500,
                                        "classic", "energy", None, 0.4)),
    }
    text = SOURCE.read_text()
    tiles = 256 * -(-360_000 // 4096)
    sources = {name: form_source(text, c) for name, c in FORMS.items()}
    sources["traced"] = traced_source(text, tiles)
    record = {"card": smi, "forms": {}, "phases_us": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        for name in FORMS:
            record["forms"][name] = {"constants": FORMS[name],
                                     "resources": libs[name][1], "ms": {}}
        for label, (x, offsets, nsta, nlta, want) in cases.items():
            calls = {}
            for name in FORMS:
                calls[name] = on1_call(libs[name][0], x, offsets, nsta, nlta)
                torch.cuda.synchronize()
                equal = bool(torch.equal(calls[name](), want))
                record["forms"][name]["ms"][label] = {"equal": equal,
                                                      "turns": []}
            reps = 5 if x.numel() > 10**7 else 20
            for name in list(FORMS) + list(reversed(FORMS)):
                record["forms"][name]["ms"][label]["turns"].append(
                    queued_ms(calls[name], reps))
        lib = libs["traced"][0]
        lib.ov_trace_get.argtypes = [ctypes.c_void_p, ctypes.c_int]
        call = on1_call(lib, compat, None, 200, 5000)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        stamps = np.zeros((tiles, STAMPS), np.uint64)
        if lib.ov_trace_get(stamps.ctypes.data, tiles) != 0:
            raise RuntimeError("onset_trace: trace copy failed")
        stamps = stamps.astype(np.int64)
        ends = [1, 2, 3, 4, 5, 7]
        for i, (name, end) in enumerate(zip(PHASES, ends)):
            begin = 0 if i == 0 else ends[i - 1]
            us = (stamps[:, end] - stamps[:, begin]) / 1e3
            record["phases_us"][name] = {
                "median": float(np.median(us)),
                "p90": float(np.percentile(us, 90))}
        tile_us = (stamps[:, 7] - stamps[:, 0]) / 1e3
        record["phases_us"]["tile"] = {"median": float(np.median(tile_us)),
                                       "p90": float(np.percentile(tile_us,
                                                                  90))}
        record["traced_span_us"] = float(
            (stamps[:, 7].max() - stamps[:, 0].min()) / 1e3)
    if args.out is not None:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
