# -*- coding: utf-8 -*-
"""
M2 v2, locate's map on K1 v2's route redesigned as a persistent ring
(``csrc/migrate_map_persistent.cu``), on the card beside M2
(``csrc/migrate_marginalise_v2.cu``), M1 v2 and K1 v2 at two plans:

- "icequake": the Icequake grid (71 x 64 x 57 nodes at 25 m) with 26
  onsets (``experiments/workload.py``'s traveltimes and gamma onsets), the
  map over 61 samples (the Icequake locate window), M1 v2 over 30;
- "vt": a grid of the VT example's size (57 x 56 x 38 nodes at 0.5 km,
  121,296 nodes), 24 onsets of 12 random surface stations at 50 Hz with
  P at 5.0 and S at 2.8 km/s, the map over 201 samples, M1 v2 over 100.

Both on ``CudaDetect``'s plan (tile 256, bricks 8 x 8 x 4). At each: M2 v2
held to M2 bit for bit, to its plain version
(``migrate_map_persistent_reference``) within 1e-5 and its per-sample max
to K1 v2's tmax bit for bit; then timed in turns with M2, M1 v2 and K1 v2
(CUDA events, milliseconds a launch), and its tables' kernel held to its
plain build and timed in turns with it; then, each in turns with M2 v2 as
the route runs it, its ablations (no store: every value computed, one sum
a thread kept live; no gather: staging and stores of exp(0); staging
only), the parts a tile is split into (1, 2, 4), the ring's depth (2, 3,
4) and any other shape built for the scan's slots, each on tables of its
own (``map_persistent_layout``, ``map_persistent_tables``). Prints each
record as JSON with the card's name and power limit, blocks per SM,
ptxas's registers and spills, and the bound and gather floor; ends with
all the records on one JSON line, also written to ``--out`` where given.
Requires CUDA; exits non-zero without it.

    python3 -m quakemigrate_torch.experiments.exp_map_v2 [--check] \
        [--route N] [--reps N] [--out PATH]

``--check`` builds, holds each plan's route once and stops (a first run of
a new build). ``--route N`` holds each plan's route, then times M2 v2
against M2 in N rounds of turns by both clocks (CUDA events around the
calls as the host issues them, and around calls enqueued behind a hold,
``exp_kernel_breakdown.queued_ms``) with their medians, and stops.

"""

import argparse
import json
import pathlib
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from quakemigrate_torch import _build
from quakemigrate_torch.device import resolve_device
from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
from quakemigrate_torch.experiments import exp_ring
from quakemigrate_torch.experiments.workload import workload
from quakemigrate_torch.ops import cuda_migrate as cm

REPS = 20
RTOL = 1e-5
FSMP = 413
# (nsamples, M1 v2's window) of each plan
PLANS = {"icequake": (61, (15, 30)), "vt": (201, (50, 100))}
VT_NODES, VT_SPACING_KM, VT_RATE, VT_V = (57, 56, 38), 0.5, 50.0, (5.0, 2.8)
# Mangled name of M2 v2's kernels (their ptxas report)
KERNEL = "qm_map_persistent_kernel"
SHARED_BYTES_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12


def vt_workload(nsamples, n_stations=12, lsmp=None):
    """(node_count, traveltimes int32 [N, 2 n_stations], onsets f32 [O, T])
    of the VT-sized grid: stations at random surface points, P then S."""

    rng = np.random.default_rng(1)
    axes = [np.arange(n) * VT_SPACING_KM for n in VT_NODES]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    stations = rng.uniform([0, 0], [axes[0][-1], axes[1][-1]],
                           (n_stations, 2))
    tt = np.stack([np.sqrt((x - sx) ** 2 + (y - sy) ** 2 + z ** 2) / v
                   for v in VT_V for sx, sy in stations], -1)
    tt = np.rint(tt.reshape(-1, 2 * n_stations) * VT_RATE).astype(np.int32)
    lsmp = int(tt.max()) + 8 if lsmp is None else lsmp
    onsets = rng.gamma(2.0, 1.5, (2 * n_stations, FSMP + nsamples + lsmp))
    return VT_NODES, tt, onsets.astype(np.float32)


def setup(name, device="cuda"):
    """The plan's detector (K1 v2's route), prepared onsets and M1 v2's
    window on ``device``."""

    device = resolve_device(device)
    nsamples, window = PLANS[name]
    if name == "icequake":
        dims, tt, onsets = workload(nsamples, n_onsets=26, fsmp=FSMP)
    else:
        dims, tt, onsets = vt_workload(nsamples)
    detector = cm.CudaDetect(tt, dims, FSMP, nsamples, device)
    n_onsets = tt.shape[1]
    mask = torch.ones(n_onsets, dtype=torch.float32, device=device)
    onsets_log, inv = detector.prepare(torch.from_numpy(onsets).to(device),
                                       mask, float(n_onsets))
    return SimpleNamespace(name=name, device=device, detector=detector,
                           onsets_log=onsets_log, inv=inv, tt=tt,
                           t_len=onsets_log.shape[1],
                           nsamples=nsamples, window=window,
                           n_onsets=n_onsets)


def m2_v2(s, tables=None, variant="full"):
    d = s.detector
    tables = d.map_tables(s.t_len) if tables is None else tables
    return lambda: cm.migrate_map_persistent_cuda(
        s.onsets_log, d.base, s.inv, d.fsmp, d.nsamples, d.n_nodes, tables,
        d._max_shift, variant=variant)


def bound(s):
    """The map's bounds at the plan: the output's bytes at the memory
    rate, the gather floor (real nodes x O x S 4-byte shared reads at
    33.5 TB/s) and the reads M2 v2 issues (32 x slots a node-onset and
    run, and one entry load a group and onset)."""

    d, lay = s.detector, s.detector.map_tables(s.t_len).layout
    n_real = d.n_nodes
    slots = lay.runs * lay.run
    reads = n_real * s.n_onsets * slots
    return {"output_ms": 4 * n_real * s.nsamples / HBM_BYTES_PER_S * 1e3,
            "gather_floor_ms": 4 * n_real * s.n_onsets * s.nsamples
            / SHARED_BYTES_PER_S * 1e3,
            "slots": slots, "wasted_slot_share": 1 - s.nsamples / slots,
            "issued_floor_ms": 4 * reads * (1 + 1 / (lay.shape[0]
                                                    * lay.shape[1]))
            / SHARED_BYTES_PER_S * 1e3}


def resources(shape, variant=0):
    """ptxas's registers and spills of M2 v2's kernel of a shape."""

    tag = "".join(f"ILi{n}E" if i == 0 else f"Li{n}E"
                  for i, n in enumerate((*shape, variant)))
    return next(v for name, v in _build.kernel_resources(KERNEL).items()
                if tag in name)


def build_args(s):
    """The arguments of M2 v2's tables' kernel and its plain version at
    the route's layout."""

    d = s.detector
    tables = d.map_tables(s.t_len)
    return (d.fine16, d.base, d.valid, d.perm, tables.woff, tables.layout,
            d.fsmp, s.t_len)


def hold(s):
    """M2 v2 on the route against M2 (bit for bit), its plain version
    (within RTOL) and K1 v2's tmax (its max, bit for bit); its tables
    (built by their kernel) against their plain build (equal). Returns a
    record; raises where it does not hold."""

    d = s.detector
    tables = d.map_tables(s.t_len)
    ref_res, ref_flat = cm.map_persistent_tables_reference(*build_args(s))
    tables_equal = bool(
        torch.equal(ref_res.view(torch.int16), tables.res.view(torch.int16))
        and torch.equal(ref_flat, tables.flat))
    del ref_res, ref_flat
    got = m2_v2(s)()
    m2 = d.map_m2(s.onsets_log, s.inv)
    ref = cm.migrate_map_persistent_reference(
        s.onsets_log, d.base, s.inv, d.fsmp, d.nsamples, d.n_nodes, tables)
    tmax = cm.combine_tiles(*d.launch(s.onsets_log, s.inv), d.perm,
                            d.tile)[0]
    torch.cuda.synchronize()
    rel = float(((got - ref).abs() / ref.abs()).max())
    record = {
        "equal_to_m2": bool(torch.equal(got, m2)),
        "max_equal_to_k1_v2": bool(torch.equal(got.max(dim=0).values, tmax)),
        "rel_err_plain": rel,
        "max_abs_err": float((got - ref).abs().max()),
        "finite": bool(torch.isfinite(got).all()),
        "tables_equal_to_plain": tables_equal}
    if not (record["equal_to_m2"] and record["max_equal_to_k1_v2"]
            and record["finite"] and rel <= RTOL and tables_equal):
        raise RuntimeError(f"exp_map_v2 {s.name}: M2 v2 does not hold "
                           f"{record}")
    return record


def variants(s):
    """{name: (tables, variant)} of the comparisons against the route's
    M2 v2: its ablations, the other parts, depths and shapes. Layouts
    that refuse the plan are left out."""

    d = s.detector
    route = d.map_tables(s.t_len).layout
    out = {}
    if route.shape in cm.MAP_PERSISTENT_ABLATED:
        for v in ("nostore", "nogather", "stage"):
            out[v] = (d.map_tables(s.t_len), v)
    options = {}
    for parts in (1, 2, 4):
        if parts != route.parts:
            options[f"parts {parts}"] = {"parts": parts}
    for n in cm.MAP_PERSISTENT_STAGES:
        if n != route.n_stages:
            options[f"stages {n}"] = {"n_stages": n}
    for shape in cm.MAP_PERSISTENT_SHAPES:
        if shape != route.shape and shape[1] == route.shape[1]:
            options[f"shape {shape}"] = {"shape": shape}
    for name, option in options.items():
        try:
            layout = cm.map_persistent_layout(d.plan.r_spans, d.tile,
                                              d.nsamples, **option)
        except ValueError:
            continue
        if layout is not None:
            out[name] = (cm.map_persistent_tables(
                d.fine16, d.base, d.valid, d.perm, layout, d.fsmp, s.t_len,
                cm.map_persistent_items(d.plan.valid, layout)), "full")
    return out


def route_rounds(s, reps, rounds):
    """M2 v2 against M2 in ``rounds`` rounds of turns, timed as the host
    issues the calls ("issued") and enqueued behind a hold ("queued"):
    {clock: {"turns_ms": {name: [...]}, "median_ms": {name: ms}}}."""

    d = s.detector
    fns = {"m2_v2": m2_v2(s),
           "m2": lambda: d.map_m2(s.onsets_log, s.inv)}
    out = {}
    for clock, queued in (("issued", False), ("queued", True)):
        turns = {k: [] for k in fns}
        for _ in range(rounds):
            for k, ms in ekb.in_turns(fns, reps, queued=queued).items():
                turns[k] += ms
        out[clock] = {"turns_ms": turns,
                      "median_ms": {k: float(np.median(v))
                                    for k, v in turns.items()},
                      "faster_share": float(np.mean(
                          np.array(turns["m2_v2"]) < np.array(turns["m2"])))}
    return out


def run_plan(s, reps, check_only=False, rounds=0):
    d = s.detector
    tables = d.map_tables(s.t_len)
    lay = tables.layout
    record = {"plan": s.name, "nodes": d.n_nodes, "tiles": d.base.shape[0],
              "onsets": s.n_onsets, "nsamples": s.nsamples,
              "r_span": d.r_span,
              "layout": {k: getattr(lay, k) for k in (
                  "shape", "run", "runs", "parts", "npi", "stage_floats",
                  "n_stages", "smem")},
              "items": int(tables.items.numel()) * lay.runs,
              "table_build_s": tables.build_s, "table_bytes": tables.nbytes,
              "blocks_per_sm": cm.map_persistent_blocks_per_sm(lay,
                                                               s.device),
              "m2_blocks_per_sm": cm.marginalise_v2_blocks_per_sm(
                  s.n_onsets, d.tile, d.win_floats, s.nsamples, s.device),
              **resources(lay.shape), **bound(s), "hold": hold(s)}
    print(f"exp_map_v2 {s.name}: " + json.dumps(record))
    if check_only:
        return record
    if rounds:
        record["route_rounds"] = route_rounds(s, reps, rounds)
        print(f"exp_map_v2 {s.name}: M2 v2 against M2 in {rounds} rounds "
              + json.dumps(record["route_rounds"]))
        return record
    start, length = s.window
    fns = {
        "m2_v2": m2_v2(s),
        "m2": lambda: d.map_m2(s.onsets_log, s.inv),
        "m1_v2": lambda: d.marginalise(s.onsets_log, s.inv, start, length),
        "k1_v2": lambda: d.launch(s.onsets_log, s.inv)}
    turns = ekb.in_turns(fns, reps)
    record["turns_ms"] = turns
    record["ms"] = {k: float(np.mean(v)) for k, v in turns.items()}
    # The kernels alone (torch.profiler's device time) and the host's
    # seconds a call without a wait (the wrapper's enqueue)
    record["device_ms"] = {k: exp_ring.device_ms(fn, reps)
                           for k, fn in fns.items()}
    record["host_ms"] = {k: host_ms(fn, reps) for k, fn in fns.items()}
    record["gather_floor_rate"] = (record["gather_floor_ms"]
                                   / record["ms"]["m2_v2"])
    # The tables' kernel in turns with its plain build
    args = build_args(s)
    record["tables_turns_ms"] = ekb.in_turns({
        "kernel": lambda: cm.map_persistent_tables_cuda(*args),
        "plain": lambda: cm.map_persistent_tables_reference(*args)}, reps)
    record["tables_ms"] = {k: float(np.mean(v)) for k, v in
                           record["tables_turns_ms"].items()}
    split = {}
    for name, (tab, variant) in variants(s).items():
        t = ekb.in_turns({"route": m2_v2(s), name: m2_v2(s, tab, variant)},
                         reps)
        split[name] = {"ms": float(np.mean(t[name])),
                       "route_ms": float(np.mean(t["route"])),
                       "device_ms": exp_ring.device_ms(
                           m2_v2(s, tab, variant), reps),
                       "turns_ms": t,
                       "layout": {k: getattr(tab.layout, k) for k in (
                           "shape", "parts", "n_stages", "smem")}}
        split[name].update(resources(tab.layout.shape,
                                     cm.MAP_PERSISTENT_VARIANTS[variant]))
        if variant == "full":
            split[name]["blocks_per_sm"] = cm.map_persistent_blocks_per_sm(
                tab.layout, s.device)
        del tab
    record["split"] = split
    print(f"exp_map_v2 {s.name}: M2 v2 {record['ms']['m2_v2']:.4f} ms, M2 "
          f"{record['ms']['m2']:.4f}, M1 v2 {record['ms']['m1_v2']:.4f} at "
          f"{length} samples, K1 v2 {record['ms']['k1_v2']:.4f}; gather "
          f"floor {record['gather_floor_ms']:.4f} ms "
          f"({record['gather_floor_rate']:.1%} of its rate); tables "
          f"{record['tables_ms']}; device "
          f"{record['device_ms']}, host {record['host_ms']}; "
          + "; ".join(f"{k} {v['ms']:.4f} (route {v['route_ms']:.4f}; "
                      f"device {v['device_ms']})"
                      for k, v in split.items()))
    return record


def host_ms(fn, reps=REPS):
    """The host's milliseconds a call of ``fn()`` enqueued ``reps`` times
    without a wait (after one warm-up call and a synchronize)."""

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def nvidia_smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=REPS)
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--route", type=int, default=0)
    parser.add_argument("--plans", nargs="*", default=list(PLANS))
    parser.add_argument("--out", type=pathlib.Path)
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_map_v2: CUDA is not available")
    _build.load_library()
    smi = nvidia_smi()
    print(smi)
    records = []
    for name in opts.plans:
        s = setup(name)
        records.append(run_plan(s, opts.reps, opts.check, opts.route))
        del s
        torch.cuda.empty_cache()
    line = json.dumps({"card": smi, "exp_map_v2": records})
    if opts.out is not None:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(line)
    print(smi)
    print(line)


if __name__ == "__main__":
    sys.exit(main())
