# -*- coding: utf-8 -*-
"""
Locate's onset kernels alone on one card: ``chip_smoke.locate_onsets_path``
run by itself. It builds the kernel library, holds ON1 v2 and ON2 v2
(``csrc/locate_onsets_v2.cu``) and ON1 and ON2 (``csrc/locate_onsets.cu``)
bit for bit to their plain versions at every hold, times v2, v1 and the
plain chain in turns at locate's S phase (13 stations, 26 float64 rows of
1,474 samples), compat's (26, 2,038) and (256, 360,000) float32 rows and
120,000 samples in float32 and float64, and reports the four kernels'
registers, spills and blocks per SM.

    python3 -m quakemigrate_torch.experiments.onset_turns [--out PATH]

Run from the root of a checkout (it imports ``chip_smoke``). Prints the
card's name and power limit, each timing line and the record as one JSON
line, also written to ``--out`` where given. Requires CUDA; exits
non-zero without it.

"""

import argparse
import json
import os
import pathlib
import sys
import time

import torch

# locate_onsets_path's row lengths at archive_locate and vt_locate_mags
LOCATE_SAMPLES = 1474
VT_SAMPLES = 1431


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("onset_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from quakemigrate_torch import _build

    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(smi)
    t0 = time.perf_counter()
    record = cs.locate_onsets_path(device, LOCATE_SAMPLES, VT_SAMPLES)
    record.update({"build_s": build_s, "phase_s": time.perf_counter() - t0,
                   "card": smi})
    if args.out is not None:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record))
    print(json.dumps({"times": record["times"],
                      "resources": record["resources"],
                      "hold_launches": record["hold_launches"],
                      "holds": len(record["holds"]),
                      "build_s": build_s, "phase_s": record["phase_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
