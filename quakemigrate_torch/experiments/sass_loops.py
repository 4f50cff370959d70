# -*- coding: utf-8 -*-
"""
Loop census of the detect kernels' machine code (SASS), to read what a
kernel's inner loop issues per (node, onset): for each kernel whose
mangled name contains one of the patterns, every loop (a backward
branch and the instructions it jumps over) with its instruction count,
its shared-memory loads by width (LDS, LDS.64, LDS.128), its global
loads (LDG) and its float adds (FADD).

It reads the library that ``quakemigrate_torch._build.build()`` makes
(built first if needed) through ``cuobjdump -sass`` from the CUDA toolkit,
so it needs nvcc and cuobjdump but no card.

    python3 -m quakemigrate_torch.experiments.sass_loops [PATTERN ...]

The default patterns are K1 FULL, K1 v2 FULL (the production kernel),
the shifted-copy kernel in both layouts and its redesign E2 v2 FULL. ``--e1-v2`` adds the gather
loops of the kernels built on K1 v2's core: E1c v2 FULL at 2 stages and
E1b v2 FULL (:data:`E1_V2_PATTERNS`). ``--vpu`` adds the VPU-plan
kernels at tile 512: K2 v1 and K2 v2
(:data:`VPU_PATTERNS`). Each loop line also gives its instructions per
node-onset-sample (instructions / FADD: every kernel here adds one float
per node, onset and sample), the unit in which kernels that hold one
sample a thread (K2 v1) and four (K1 v2, K2 v2) compare.

    python3 -m quakemigrate_torch.experiments.sass_loops --e1-v2
    python3 -m quakemigrate_torch.experiments.sass_loops --vpu

"""

import argparse
import os
import re
import shutil
import subprocess
import sys

DEFAULT_PATTERNS = ("qm_migrate_detect_kernelILi0E",
                    "qm_migrate_detect_v2_kernelILi0E",
                    "qm_migrate_detect_x16",
                    "qm_x16_v2_kernelILi0E")
E1_V2_PATTERNS = ("qm_pipelined_v2_kernelILi0ELi2E",
                  "qm_resident_v2_kernelILi0E")
VPU_PATTERNS = ("qm_vpu_kernelILi32E", "qm_vpu_v2_kernelILi32ELi8E")

_FUNCTION = re.compile(r"^\s*Function : (\S+)", re.M)
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_BRANCH = re.compile(r"\bBRA\s+(?:`\(\S+\)|(0x[0-9a-f]+))")


def parse_sass(text):
    """``cuobjdump -sass`` output -> {kernel name: [(address, instruction
    text)]} in address order."""

    kernels = {}
    marks = list(_FUNCTION.finditer(text))
    for mark, nxt in zip(marks, marks[1:] + [None]):
        body = text[mark.end():nxt.start() if nxt else len(text)]
        kernels[mark.group(1)] = [
            (int(m.group(1), 16), " ".join(m.group(2).split()))
            for m in _INSTR.finditer(body)
        ]
    return kernels


def loops(instrs):
    """Every backward branch of ``instrs`` as a loop record: its first
    and last address, its instruction count, its loads and adds, and its
    instructions per node-onset (``n / (FADD / 4)``; None without
    FADD)."""

    found = []
    for addr, ins in instrs:
        m = _BRANCH.search(ins)
        if not m or not m.group(1) or int(m.group(1), 16) >= addr:
            continue
        start = int(m.group(1), 16)
        body = [i for a, i in instrs if start <= a <= addr]
        ops = [i.split()[1] if i.startswith("@") else i.split()[0]
               for i in body]
        found.append({
            "start": start, "end": addr, "n": len(body),
            "lds32": sum(o == "LDS" for o in ops),
            "lds64": sum(o == "LDS.64" for o in ops),
            "lds128": sum(o == "LDS.128" for o in ops),
            "ldg": sum(o.startswith("LDG") for o in ops),
            "fadd": sum(o == "FADD" for o in ops),
        })
        fadd = found[-1]["fadd"]
        found[-1]["per_node_onset"] = 4 * len(body) / fadd if fadd else None
    return found


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    if os.access(candidate, os.X_OK):
        return candidate
    raise SystemExit("sass_loops: cuobjdump not found on PATH or under "
                     "CUDA_HOME")


def census(patterns):
    """Loops of every built kernel whose mangled name contains one of
    ``patterns``: {name: (instructions, [loop records with shared-memory
    loads])}, from ``cuobjdump -sass`` of the built library."""

    from quakemigrate_torch import _build

    text = subprocess.run(
        [_cuobjdump(), "-sass", str(_build.build())], capture_output=True,
        text=True, check=True,
    ).stdout
    return {
        name: (len(instrs), [rec for rec in loops(instrs)
                             if rec["lds32"] + rec["lds64"] + rec["lds128"]])
        for name, instrs in parse_sass(text).items()
        if any(p in name for p in patterns)
    }


def print_census(found):
    """Print :func:`census`'s records, one line a loop."""

    for name, (n_instrs, recs) in found.items():
        print(f"{name}: {n_instrs} instructions")
        for rec in recs:
            per = rec["per_node_onset"]
            print(f"  loop {rec['start']:#06x}-{rec['end']:#06x}: "
                  f"{rec['n']} instructions, LDS {rec['lds32']}, LDS.64 "
                  f"{rec['lds64']}, LDS.128 {rec['lds128']}, LDG "
                  f"{rec['ldg']}, FADD {rec['fadd']}"
                  + ("" if per is None else
                     f", {per:.2f} instructions a node-onset, "
                     f"{rec['n'] / rec['fadd']:.3f} a node-onset-sample"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("patterns", nargs="*", default=DEFAULT_PATTERNS,
                        help="substrings of the mangled kernel names")
    parser.add_argument("--e1-v2", action="store_true",
                        help="also census E1c v2 and E1b v2")
    parser.add_argument("--vpu", action="store_true",
                        help="also census K2 v1 and K2 v2")
    opts = parser.parse_args(argv)
    patterns = (list(opts.patterns) + list(E1_V2_PATTERNS if opts.e1_v2
                                            else ())
                + list(VPU_PATTERNS if opts.vpu else ()))
    print_census(census(patterns))


if __name__ == "__main__":
    sys.exit(main())
