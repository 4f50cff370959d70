# -*- coding: utf-8 -*-
"""
The main path's window time from two checkouts of the repository, timed
in turns (a, b, b, a) on one card. Each turn is a fresh process that
runs ``chip_smoke.run_slice`` of that checkout (16 Icequake windows
through ``DetectScan`` with its production kernel) twice and reports
the warm wall and the device median per window of each pass. A change
that does not touch the main path leaves both within their turn-to-turn
spread.

    python3 -m quakemigrate_torch.experiments.window_turns A_DIR B_DIR

Each directory holds a checkout with ``chip_smoke.py`` at its root and
builds its own kernel library at first use. Requires CUDA; exits
non-zero without it.

"""

import argparse
import json
import re
import subprocess
import sys

import torch

PASSES = 2

# Run in the checkout's root: the same traveltimes and windows as
# chip_smoke.py's main path (seed 2024 after its small plan's draw).
_SLICE = f"""
import sys
import numpy as np
sys.path.insert(0, ".")
import chip_smoke as cs
from quakemigrate_torch import _build
from quakemigrate_torch.device import resolve_device
_build.load_library()
device = resolve_device("cuda")
rng = np.random.default_rng(2024)
rng.integers(0, 40, size=(10 * 9 * 8, 6))
tt = cs.icequake_traveltimes(rng)
for _ in range({PASSES}):
    cs.run_slice(tt, np.random.default_rng(7), device)
"""

_WARM = re.compile(r"slice \(warm\): ([0-9.]+) ms wall per window, device "
                   r"([0-9.]+) ms median per window")


def parse_warm(text):
    """[(wall ms, device median ms)] of each warm pass printed in
    ``text``."""

    return [(float(a), float(b)) for a, b in _WARM.findall(text)]


def one_turn(checkout):
    proc = subprocess.run([sys.executable, "-c", _SLICE], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"slice in {checkout} failed:\n{proc.stderr}")
    passes = parse_warm(proc.stdout)
    if len(passes) != PASSES:
        raise RuntimeError(f"slice in {checkout}: no warm line\n"
                           f"{proc.stdout}")
    return passes


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("a", help="first checkout (e.g. the parent)")
    parser.add_argument("b", help="second checkout (e.g. the change)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("window_turns: CUDA is not available")
    print(torch.cuda.get_device_name(0))
    turns = {"a": [], "b": []}
    for name in ("a", "b", "b", "a"):
        passes = one_turn(getattr(args, name))
        turns[name].append(passes)
        print(f"{name} ({getattr(args, name)}): " + ", ".join(
            f"wall {w:.3f} ms, device {d:.3f} ms" for w, d in passes))
    print(json.dumps({"window_turns": {
        name: {"checkout": getattr(args, name), "passes": turns[name]}
        for name in turns}}))


if __name__ == "__main__":
    sys.exit(main())
