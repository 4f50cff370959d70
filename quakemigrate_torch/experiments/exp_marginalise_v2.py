# -*- coding: utf-8 -*-
"""
M1 v2, locate's marginalisation on K1 v2's gather core
(``csrc/migrate_marginalise_v2.cu``), on the card beside M1
(``csrc/migrate_marginalise.cu``) at one plan: the Icequake grid (71 x
64 x 57 nodes at 25 m) with 26 onsets (13 stations x P/S, the example's
count; ``experiments/workload.py``'s traveltimes and gamma onsets), tile
256, bricks 8 x 8 x 4 (``DetectPlan``'s defaults, pass 1's plan), over a
scan of 2,038 samples after fsmp 413 (the Icequake archive scan's detect
window).

At each window length of ``WINDOWS`` (30, the locate window; 61, pass
1's; 128, one chunk; 300, three; 2,038, the whole scan), M1 v2 (the
shape built for that length's slot count, ``M1_V2_NODES_IN_FLIGHT``) and
M1 are each held to the plain version (within 1e-5 of the map's
maximum, the same peak node) and M1 v2, up to one chunk (128 samples),
bit for bit to M1; then the two are timed in turns (v2, v1, v1, v2),
with M1 v2's resident blocks per SM (occupancy API) and registers and
spills (ptxas). CUDA-event milliseconds per launch. Requires CUDA;
exits non-zero without it.

    python3 -m quakemigrate_torch.experiments.exp_marginalise_v2 [--reps N]

"""

import argparse
import json
import sys
from types import SimpleNamespace

import numpy as np
import torch

from quakemigrate_torch import _build
from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
from quakemigrate_torch.experiments.workload import workload
from quakemigrate_torch.ops import cuda_migrate as cm
from quakemigrate_torch.ops.migrate import migrate_marginalise

N_ONSETS, FSMP, NSAMPLES = 26, 413, 2038
WINDOWS = (30, 61, 128, 300, 2038)
REPS = 20
# M1 v2 against the plain version: sums of the window's coalescence in
# another order than the plain version's (chip_smoke.py's M1_RTOL_OF_MAX)
RTOL_OF_MAX = 1e-5
# Mangled name of M1 v2's kernels (their ptxas report)
KERNEL = "qm_migrate_marginalise_v2_kernel"


def setup(device="cuda", nsamples=NSAMPLES, n_onsets=N_ONSETS, fsmp=FSMP):
    """The workload, pass 1's plan and detector (K1 v2's tables) and the
    prepared onsets on ``device``."""

    device = resolve_device(device)
    dims, tt, onsets = workload(nsamples, n_onsets=n_onsets, fsmp=fsmp)
    detector = cm.CudaDetect(tt, dims, fsmp, nsamples, device)
    onsets = torch.from_numpy(onsets).to(device)
    mask = torch.ones(n_onsets, dtype=torch.float32, device=device)
    onsets_log, inv = detector.prepare(onsets, mask, float(n_onsets))
    return SimpleNamespace(
        device=device, detector=detector, onsets=onsets, mask=mask,
        onsets_log=onsets_log, inv=inv, n_onsets=n_onsets,
        tt=torch.from_numpy(tt).to(device), fsmp=fsmp, nsamples=nsamples)


def kernels(s, start, length):
    """{name: callable} of M1 v2 ("v2") and M1 ("v1") over the window,
    on the setup ``s``."""

    d = s.detector
    return {
        "v2": lambda: d.marginalise(s.onsets_log, s.inv, start, length),
        "v1": lambda: cm.migrate_marginalise_cuda(
            s.onsets_log, d.base, d.fine, d.valid, d.perm, s.inv, s.fsmp,
            s.nsamples, start, length, d.n_nodes, d._max_shift),
    }


def resources(spn):
    """ptxas's registers and spills of M1 v2's kernel of a slot count."""

    tag = f"ILi{cm.M1_V2_NODES_IN_FLIGHT[spn]}ELi{spn}E"
    return next(v for name, v in _build.kernel_resources(KERNEL).items()
                if tag in name)


def case(s, length, reps=REPS):
    """M1 v2 and M1 at a window of ``length`` samples (the scan's
    middle, or its start for the whole scan): each held to the plain
    version and M1 v2, up to one chunk, bit for bit to M1, then timed in
    turns. Returns a record."""

    start = (s.nsamples - length) // 2
    fns = kernels(s, start, length)
    want = migrate_marginalise(s.onsets, s.tt, s.mask, float(s.n_onsets),
                               s.fsmp, s.nsamples, start, length)
    v1 = fns["v1"]()
    peak = int(torch.argmax(want))
    d = s.detector
    spn = cm.m1_v2_slots(length)
    record = {"window": [start, length], "slots": spn,
              "nodes_in_flight": cm.M1_V2_NODES_IN_FLIGHT[spn],
              "kernels": {}}
    for name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        err = float((got - want).abs().max() / want.abs().max())
        ok = (bool(torch.isfinite(got).all()) and err <= RTOL_OF_MAX
              and int(torch.argmax(got)) == peak)
        if not ok:
            raise RuntimeError(f"exp_marginalise_v2: {name} at {length} "
                               f"samples: {err} of the maximum")
        rec = {"max_err_of_max": err,
               "max_abs_err": float((got - want).abs().max())}
        if name != "v1":
            equal = bool(torch.equal(got, v1))
            if length <= cm.M1_V2_CHUNK and not equal:
                raise RuntimeError(f"exp_marginalise_v2: {name} at {length} "
                                   "samples differs from M1")
            rec.update(
                equal_to_v1=equal,
                max_rel_diff_v1=float(((got - v1).abs() / v1.abs()).max()),
                blocks_per_sm=cm.marginalise_v2_blocks_per_sm(
                    s.n_onsets, d.tile, d.win_floats, length, s.device),
                smem=cm.m1_v2_smem_bytes(s.n_onsets, d.tile, d.win_floats,
                                         length),
                **resources(spn))
        record["kernels"][name] = rec
    turns = ekb.in_turns(fns, reps)
    for name, ms in turns.items():
        record["kernels"][name].update(ms=float(np.mean(ms)), turns_ms=ms)
    print(f"m1 v2 at {length} samples ({record['nodes_in_flight']} nodes "
          f"in flight, {spn} slots a node): "
          + "; ".join(
              f"{name} {r['turns_ms'][0]:.4f} / {r['turns_ms'][1]:.4f} ms"
              + (f" (equal to v1 {r['equal_to_v1']}, blocks per SM "
                 f"{r['blocks_per_sm']}, {r['registers']} registers, spills "
                 f"{r['spill_stores']} / {r['spill_loads']})"
                 if name != "v1" else "")
              for name, r in record["kernels"].items()))
    return record


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=REPS)
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_marginalise_v2: CUDA is not available")
    _build.load_library()
    print(torch.cuda.get_device_name(0))
    s = setup()
    d = s.detector
    print(f"plan: {d.n_nodes} nodes, tile {d.tile}, "
          f"{d.base.shape[0]} tiles, {s.n_onsets} onsets, r_span "
          f"{d.r_span}, win_floats {d.win_floats}")
    records = [case(s, length, opts.reps) for length in WINDOWS]
    print(json.dumps({"exp_marginalise_v2": records}))


if __name__ == "__main__":
    sys.exit(main())
