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
(:data:`VPU_PATTERNS`); ``--global`` K3 and K3 v2's shapes
(:data:`GLOBAL_PATTERNS`). Each loop line also gives its instructions per
node-onset-sample (instructions / FADD: every kernel here adds one float
per node, onset and sample), the unit in which kernels that hold one
sample a thread (K2 v1) and four (K1 v2, K2 v2) compare, and its local
loads and stores (LDL, STL: register spills).

    python3 -m quakemigrate_torch.experiments.sass_loops --e1-v2
    python3 -m quakemigrate_torch.experiments.sass_loops --vpu

``--compare DIR`` prints instead which kernels' machine code differs
between this tree's library and the one the checkout at DIR (another
commit of the repository) builds, kernel by kernel.

    python3 -m quakemigrate_torch.experiments.sass_loops --compare DIR

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
GLOBAL_PATTERNS = ("qm_migrate_detect_global_kernel", "qm_global_v2_kernel")

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


def kernels_sass(lib):
    """``parse_sass`` of ``cuobjdump -sass`` of the library ``lib``."""

    return parse_sass(subprocess.run(
        [_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
        check=True,
    ).stdout)


def census(patterns):
    """Loops of every built kernel whose mangled name contains one of
    ``patterns``: {name: (instructions, [loop records with shared-memory
    loads])}, from ``cuobjdump -sass`` of the built library."""

    from quakemigrate_torch import _build

    found = {}
    for name, instrs in kernels_sass(_build.build()).items():
        if not any(p in name for p in patterns):
            continue
        recs = [rec for rec in loops(instrs)
                if rec["lds32"] + rec["lds64"] + rec["lds128"]]
        for rec in recs:
            rec["local"] = local_ops(instrs, rec)
        found[name] = (len(instrs), recs)
    return found


def local_ops(instrs, rec):
    """The local loads and stores (LDL, STL: register spills) inside the
    loop ``rec`` of :func:`loops` over ``instrs``."""

    ops = [ins.split()[1] if ins.startswith("@") else ins.split()[0]
           for a, ins in instrs if rec["start"] <= a <= rec["end"]]
    return sum(o.startswith(("LDL", "STL")) for o in ops)


def print_census(found):
    """Print :func:`census`'s records, one line a loop."""

    for name, (n_instrs, recs) in found.items():
        print(f"{name}: {n_instrs} instructions")
        for rec in recs:
            per = rec["per_node_onset"]
            print(f"  loop {rec['start']:#06x}-{rec['end']:#06x}: "
                  f"{rec['n']} instructions, LDS {rec['lds32']}, LDS.64 "
                  f"{rec['lds64']}, LDS.128 {rec['lds128']}, LDG "
                  f"{rec['ldg']}, FADD {rec['fadd']}, LDL/STL "
                  f"{rec['local']}"
                  + ("" if per is None else
                     f", {per:.2f} instructions a node-onset, "
                     f"{rec['n'] / rec['fadd']:.3f} a node-onset-sample"))


def compare(other_root):
    """This tree's kernels against those of the library that the checkout
    at ``other_root`` builds (its own ``_build``, in a subprocess): {"same",
    "differ", "only_here", "only_there": sorted kernel names}, a kernel
    the same where its instructions are equal one for one."""

    from quakemigrate_torch import _build

    other_lib = subprocess.run(
        [sys.executable, "-c", "from quakemigrate_torch import _build; "
         "print(_build.build())"], cwd=other_root,
        env={**os.environ, "PYTHONPATH": str(other_root)},
        capture_output=True, text=True, check=True).stdout.split()[-1]
    here, there = kernels_sass(_build.build()), kernels_sass(other_lib)
    both = set(here) & set(there)
    return {"same": sorted(k for k in both if here[k] == there[k]),
            "differ": sorted(k for k in both if here[k] != there[k]),
            "only_here": sorted(set(here) - set(there)),
            "only_there": sorted(set(there) - set(here))}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("patterns", nargs="*", default=DEFAULT_PATTERNS,
                        help="substrings of the mangled kernel names")
    parser.add_argument("--e1-v2", action="store_true",
                        help="also census E1c v2 and E1b v2")
    parser.add_argument("--vpu", action="store_true",
                        help="also census K2 v1 and K2 v2")
    parser.add_argument("--global", dest="global_", action="store_true",
                        help="also census K3 and K3 v2")
    parser.add_argument("--compare", metavar="DIR",
                        help="compare every kernel's machine code with "
                             "the library of the checkout at DIR")
    opts = parser.parse_args(argv)
    if opts.compare:
        diff = compare(opts.compare)
        print({k: len(v) for k, v in diff.items()})
        for key in ("differ", "only_here", "only_there"):
            for name in diff[key]:
                print(f"{key}: {name}")
        return
    patterns = (list(opts.patterns) + list(E1_V2_PATTERNS if opts.e1_v2
                                            else ())
                + list(VPU_PATTERNS if opts.vpu else ())
                + list(GLOBAL_PATTERNS if opts.global_ else ()))
    print_census(census(patterns))


if __name__ == "__main__":
    sys.exit(main())
