# -*- coding: utf-8 -*-
"""
The first map call of a fresh detector against the calls after it, on the
card, for the quakemigrate_torch of a checkout: the cost that locate's
map path (``QuakeScan.locate(write_coalescence=True)``, the event video)
pays once a detector, for tables that the route's map kernel builds at its
first call. At the Icequake workload plan (the 71 x 64 x 57 grid, 26
onsets, 61 samples: ``experiments/workload.py``), ``--detectors`` fresh
``CudaDetect`` in turn: each one's first ``map`` call (host seconds to
the end of its work on the card) and the median of ``--reps`` calls after
it, and the launches of each call by kernel. Only ``CudaDetect``,
``prepare``, ``map`` and the launch counts are used, so a checkout of an
older commit is measured the same way. Run it as a file, so that the
package is imported from ``--root`` (by default the checkout that holds
this file); run two checkouts in turns to compare them:

    python3 quakemigrate_torch/experiments/map_first_call.py \
        [--root DIR] [--detectors N] [--reps N]

Prints one JSON line with the card's name and power limit. Requires CUDA;
exits non-zero without it.

"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

FSMP = 413
NSAMPLES = 61
N_ONSETS = 26


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=pathlib.Path,
                        default=pathlib.Path(__file__).resolve().parents[2])
    parser.add_argument("--detectors", type=int, default=3)
    parser.add_argument("--reps", type=int, default=10)
    opts = parser.parse_args(argv)
    sys.path.insert(0, str(opts.root.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("map_first_call: CUDA is not available")
    from quakemigrate_torch import _build
    from quakemigrate_torch.experiments.workload import workload
    from quakemigrate_torch.ops import cuda_migrate as cm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    _build.load_library()
    dims, tt, onsets = workload(NSAMPLES, n_onsets=N_ONSETS, fsmp=FSMP)
    device = torch.device("cuda")
    onsets = torch.from_numpy(onsets).to(device)
    mask = torch.ones(N_ONSETS, dtype=torch.float32, device=device)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    runs = []
    for _ in range(opts.detectors):
        det = cm.CudaDetect(tt, dims, FSMP, NSAMPLES, device)
        onsets_log, inv = det.prepare(onsets, mask, float(N_ONSETS))
        before = dict(cm.launches)
        out, first_ms = timed(lambda: det.map(onsets_log, inv))
        first_launches = {k: n - before.get(k, 0)
                          for k, n in cm.launches.items()
                          if n != before.get(k, 0)}
        shape, finite = list(out.shape), bool(torch.isfinite(out).all())
        del out
        after = [timed(lambda: det.map(onsets_log, inv))[1]
                 for _ in range(opts.reps)]
        tables = getattr(det, "_map_tables", {})
        runs.append({
            "first_ms": first_ms, "next_ms": float(np.median(after)),
            "first_extra_ms": first_ms - float(np.median(after)),
            "first_launches": first_launches, "shape": shape,
            "finite": finite,
            "table_build_s": [getattr(t, "build_s", None)
                              for t in tables.values()],
            "table_bytes": [getattr(t, "nbytes", None)
                            for t in tables.values()]})
        del det, onsets_log, inv
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "root": str(opts.root),
                      "first_ms": [r["first_ms"] for r in runs],
                      "next_ms": [r["next_ms"] for r in runs],
                      "runs": runs}))
    if not all(r["finite"] for r in runs):
        raise SystemExit("map_first_call: the map is not finite")


if __name__ == "__main__":
    sys.exit(main())
