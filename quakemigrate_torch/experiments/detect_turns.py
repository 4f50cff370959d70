# -*- coding: utf-8 -*-
"""
``QuakeScan.detect`` over the synthetic Icequake archive from two
checkouts of the repository, timed in turns (a, b, b, a) on one card.
Each turn is a fresh process that builds ``chip_smoke.archive_workspace``
(13 stations, 259,008 nodes, 26 onsets, 250 Hz) in a temporary directory
and runs detect over ARCHIVE_SPAN_S seconds (24 windows of 2.5 s) with
the example's STA/LTA onset and with chip_smoke's KurtosisOnset, each
cold then warm: the wall, the host split of the loop
(``detect_batch_attrib``: read wait, prepare, dispatch, drain) and the
median of the windows' device ms (CUDA events from the upload to the
copy back). Used to see whether a change to the window's device work
moves the detect's wall.

    python3 -m quakemigrate_torch.experiments.detect_turns A_DIR B_DIR

Each directory holds a checkout with ``chip_smoke.py`` at its root and
builds its own kernel library at first use. Prints one JSON line a turn
and the card's name and power limit. Requires CUDA; exits non-zero
without it.

"""

import argparse
import json
import subprocess
import sys

import torch

# Run in the checkout's root
_DETECT = """
import json, pathlib, sys, tempfile
import numpy as np
sys.path.insert(0, ".")
import chip_smoke as cs
from quakemigrate_torch import _build
from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.io import Archive
from quakemigrate_torch.seis import UTCDateTime
from quakemigrate_torch.signal.scan import QuakeScan
_build.load_library()
device = resolve_device("cuda")
out = {}
with tempfile.TemporaryDirectory() as tmp:
    root = pathlib.Path(tmp)
    lut, stations, archive_path, _, _, _ = cs.archive_workspace(root)
    archive = Archive(archive_path, stations,
                      archive_format="YEAR/JD/STATION")
    start = UTCDateTime(cs.ARCHIVE_START) + cs.ARCHIVE_SPAN_S / 2
    end = start + cs.ARCHIVE_SPAN_S
    for kind, onset in (("stalta", cs.archive_onset()),
                        ("kurtosis", cs.kurtosis_onset_for())):
        scan = QuakeScan(archive, lut, onset, str(root / "runs"), kind,
                         device=device, timestep=cs.ARCHIVE_TIMESTEP)
        for run in ("cold", "warm"):
            _, wall = cs.quiet(root, f"{kind}_{run}",
                               lambda: scan.detect(start, end))
            rows = scan.detect_batch_attrib
            out[f"{kind}_{run}"] = {
                "wall_s": wall,
                **{k: sum(r[k] for r in rows)
                   for k in ("read_wait", "prepare", "dispatch", "drain")},
                "window_ms": float(np.median(scan.detect_scan.window_ms)),
                "windows": len(scan.detect_scan.window_ms)}
print("DETECT " + json.dumps(out))
"""


def one_turn(checkout):
    proc = subprocess.run([sys.executable, "-c", _DETECT], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"detect in {checkout} failed:\n{proc.stderr}")
    lines = [l for l in proc.stdout.splitlines() if l.startswith("DETECT ")]
    if len(lines) != 1:
        raise RuntimeError(f"detect in {checkout}: no result\n{proc.stdout}")
    return json.loads(lines[0][len("DETECT "):])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("a", help="first checkout (e.g. the parent)")
    parser.add_argument("b", help="second checkout (e.g. the change)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("detect_turns: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(smi)
    for name in ("a", "b", "b", "a"):
        print(json.dumps({"turn": name, **one_turn(getattr(args, name))}),
              flush=True)


if __name__ == "__main__":
    main()
