# -*- coding: utf-8 -*-
"""
``QuakeScan.locate`` of one event of the synthetic Icequake archive from
two checkouts of the repository, timed in turns (a, b, b, a) on one card.
Each turn is a fresh process that builds ``chip_smoke.archive_workspace``
(13 stations, 259,008 nodes, 250 Hz, one planted source) in a temporary
directory, detects over DOUBLE_SPAN_S seconds about the planted origin,
triggers the planted event, then locates it with archive_locate's
centred STA/LTA onset and with chip_smoke's KurtosisOnset, each once cold
and three times warm: the wall and the host split of each event
(``locate_event_attrib``: its onsets span, the passes, the location,
picks and writes). Used to see what a change to locate's onsets moves in
the onsets span and the wall.

    python3 -m quakemigrate_torch.experiments.locate_turns A_DIR B_DIR

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
_LOCATE = """
import json, pathlib, sys, tempfile
sys.path.insert(0, ".")
import chip_smoke as cs
from quakemigrate_torch import _build
from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.io import Archive
from quakemigrate_torch.seis import UTCDateTime
from quakemigrate_torch.signal.onsets import STALTAOnset
from quakemigrate_torch.signal.scan import QuakeScan
_build.load_library()
device = resolve_device("cuda")
KEYS = ("onsets", "pass1", "pass2", "location", "picks", "writes")
out = {}
with tempfile.TemporaryDirectory() as tmp:
    root = pathlib.Path(tmp)
    lut, stations, archive_path, _, _, origin = cs.archive_workspace(root)
    archive = Archive(archive_path, stations,
                      archive_format="YEAR/JD/STATION")
    start = (UTCDateTime(cs.ARCHIVE_START) + cs.ARCHIVE_SPAN_S
             - cs.DOUBLE_SPAN_S / 2)
    end = start + cs.DOUBLE_SPAN_S
    scan = QuakeScan(archive, lut, cs.archive_onset(), str(root / "runs"),
                     "detect", device=device, timestep=cs.ARCHIVE_TIMESTEP,
                     plot_event_summary=False)
    cs.quiet(root, "detect", lambda: scan.detect(start, end))
    trigger_file = cs.trigger_one(root, scan, lut, start, end, origin,
                                  "detect")
    stalta = STALTAOnset(position="centred", sampling_rate=cs.RATE)
    stalta.phases = ["P", "S"]
    stalta.bandpass_filters = {"P": [10, 124, 4], "S": [10, 124, 4]}
    stalta.sta_lta_windows = {p: list(w) for p, w in cs.STA_LTA.items()}
    for kind, onset in (("stalta", stalta),
                        ("kurtosis", cs.kurtosis_onset_for())):
        loc = QuakeScan(archive, lut, onset, str(root / "runs"),
                        f"locate_{kind}", device=device,
                        marginal_window=cs.LOCATE_MARGINAL_WINDOW,
                        plot_event_summary=False)
        for run in ("cold", "warm1", "warm2", "warm3"):
            _, wall = cs.quiet(root, f"{kind}_{run}", lambda: loc.locate(
                trigger_file=str(trigger_file)))
            rows = loc.locate_event_attrib
            out[f"{kind}_{run}"] = {
                "wall_s": wall, "events": len(rows),
                **{k: sum(r.get(k) or 0.0 for r in rows) for k in KEYS}}
print("LOCATE " + json.dumps(out))
"""


def one_turn(checkout):
    proc = subprocess.run([sys.executable, "-c", _LOCATE], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"locate in {checkout} failed:\n{proc.stderr}")
    lines = [l for l in proc.stdout.splitlines() if l.startswith("LOCATE ")]
    if len(lines) != 1:
        raise RuntimeError(f"locate in {checkout}: no result\n{proc.stdout}")
    return json.loads(lines[0][len("LOCATE "):])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("a", help="first checkout (e.g. the parent)")
    parser.add_argument("b", help="second checkout (e.g. the change)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("locate_turns: CUDA is not available")
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
