# -*- coding: utf-8 -*-
"""
The float64 kernels of the "k3" route, which
``QuakeScan(precision="double")`` runs, on the card: K3 v3 f64, its
yardstick K3 v2 f64 and K3 f64 (``csrc/migrate_detect_global_v3.cu``,
``csrc/migrate_detect_global_v2.cu``, ``csrc/migrate_detect_global.cu``:
the reference's ``detect_reduce`` in float64), M1 f64 and M2 simple f64
(``csrc/migrate_marginalise.cu``: ``migrate_marginalise`` and
``migrate_map``). Each case holds the float64 kernel to its plain float64
version on the same inputs on the card and times it in turns with its
float32 form on the same case (the onsets cast to float32):

- detect at the Icequake window (71 x 64 x 57 nodes, 24 onsets, 625
  samples) and at F3 (40 x 40 x 16 nodes at 10 km, 24 onsets, 1,000
  samples): K3 v3 f64, K3 v2 f64, K3 v2, K3 f64, K3 in turns, K3 v3
  f64's tmax and targ bit for bit K3 v2 f64's;
- detect on the Icequake window's table as the routed ``ops`` plan it
  (runs of 256 flat nodes, ``ops/routed.py``): the same kernels;
- detect on a plan too wide for K3 v2 f64's ring of doubles (a
  15,000-sample span on a 4 x 4 x 4 grid): K3 f64 and K3;
- locate's pass 2 in double on the Icequake plan at 30 and 300 samples:
  M1 ring f64 (``csrc/migrate_marginalise_ring.cu`` on K3 v2 f64's
  tables, the route's kernel) through ``exp_ring.m1_case``, in turns
  with M1 f64, its other grid, M1 ring and M1; the map in double over 61
  samples: M2 ring f64 through ``exp_ring.m2_case``, in turns with M2
  simple f64, its other grid, M2 ring and M2 simple.

Holds: detect's max and sum within 1e-12 relative of the plain version
(which divides by ``available`` where the kernels multiply by its
inverse, and sums the tiles in another order), its argmax equal or
tie-consistent (the float64 coalescence at the kernel's node within
1e-12 of the maximum); M1 ring f64 and M1 f64 within 1e-12 of the
marginal maximum and the same peak node, M2 ring f64 and M2 simple f64
within 1e-12 relative (exp_ring then holds the rings bit for bit to M1
f64 at a window of one chunk, to M2 simple f64 and to K3 v2 f64's tmax).
Bounds: the bytes the function moves (inputs read once, outputs written
once) at 3.35 TB/s, and its operations at 34 TFLOP/s, the H100 SXM's
float64 rate outside the tensor cores (NVIDIA's data sheet; its float32
forms at 67 TFLOP/s): K3 f64, M1 f64 and M2 simple f64 on their int32
traveltimes, K3 v3 f64 and K3 v2 f64 on their tables, with detect's
gather floor (real nodes x O x S reads of the element at 33.5 TB/s), the
rings on theirs (``exp_ring.bound``, with the gather floor). Times are
CUDA-event milliseconds per launch. Requires CUDA; exits non-zero
without it.

    python3 -m quakemigrate_torch.experiments.exp_double [OPTION]

Options: ``--detect``, the detect cases alone; ``--align``, the Icequake
window's :func:`alignment_probe` alone; ``--forms``, :func:`form_probe`
at the Icequake window and F3 alone.

"""

import functools
import json
import sys
from types import SimpleNamespace

import numpy as np
import torch

from quakemigrate_torch import _build
from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
from quakemigrate_torch.experiments import exp_ring
from quakemigrate_torch.experiments.exp_global_v2 import (
    F3_FSMP, F3_NODES, F3_NSAMPLES, ICEQUAKE_NSAMPLES, f3_traveltimes)
from quakemigrate_torch.experiments.workload import workload
from quakemigrate_torch.ops import cuda_migrate as cm
from quakemigrate_torch.ops import migrate

REPS = 20
RTOL = 1e-12
HBM_BYTES_PER_S = 3.35e12
# Peak rates outside the tensor cores (H100 SXM data sheet)
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
# Shared-memory bandwidth of the H100 SXM (32 banks x 4 bytes x 132 SMs x
# 1980 MHz): detect's gather floor
SMEM_BYTES_PER_S = 33.5e12
F64 = torch.float64
# ptxas's names of the float64 kernels (mangled, with the element type)
F64_KERNELS = {"k3_v3_f64": "qm_global_v3_f64_kernelILi4ELi2EE",
               "k3_v3_f64_streamed": "qm_global_v3_f64_kernelILi8ELi1EE",
               "k3_v2_f64": "qm_global_v2_kernelILi16ELi8ELi1EdE",
               "k3_f64": "qm_migrate_detect_global_kernelIdE",
               "m1_f64": "qm_migrate_marginalise_kernelIdE",
               "m2_simple_f64": "qm_migrate_map_kernelIdE"}
# A span past K3 v2 f64's ring of doubles (and within float32's)
WIDE_SPAN = 15_000


def setup(tt, node_count, fsmp, nsamples, device, onsets=None, rng=None,
          n_masked=2, plan=None):
    """A case on ``device``: the plan of ``tt`` (or ``plan``), float64
    onsets (``onsets``,
    or gamma onsets from ``rng`` long enough for the plan) with
    ``n_masked`` rows masked out, and CudaDetectGlobal's float64 and
    float32 detectors on the plan with their prepared onsets."""

    device = torch.device(device)
    if plan is None:
        plan = cm.DetectPlan(tt, node_count)
    if onsets is None:
        onsets = rng.gamma(2.0, 1.5, size=(
            plan.n_onsets, fsmp + nsamples + plan.max_shift + 7))
    mask = np.ones(plan.n_onsets)
    mask[:n_masked] = 0.0
    s = SimpleNamespace(
        device=device, plan=plan, node_count=node_count, tt=tt,
        tt_dev=torch.from_numpy(np.ascontiguousarray(tt, np.int32)).to(
            device),
        onsets=torch.from_numpy(np.asarray(onsets, np.float64)).to(device),
        mask=torch.from_numpy(mask).to(device),
        available=float(mask.sum()), fsmp=fsmp, nsamples=nsamples)
    s.det = {dtype: cm.CudaDetectGlobal(tt, node_count, fsmp, nsamples,
                                        device, plan=plan, dtype=dtype)
             for dtype in (F64, torch.float32)}
    s.prepared = {dtype: det.prepare(s.onsets.to(dtype), s.mask.to(dtype),
                                     s.available)
                  for dtype, det in s.det.items()}
    return s


def roofline(nbytes, flops, flop_per_s):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flop_per_s * 1e3
    if bytes_ms >= ops_ms:
        return {"bound_ms": bytes_ms, "bound_by": "bytes"}
    return {"bound_ms": ops_ms, "bound_by": "operations"}


def _rate(itemsize):
    return FP64_FLOP_PER_S if itemsize == 8 else FP32_FLOP_PER_S


def detect_bound(s, itemsize=8, v2=True):
    """Detect's bound in elements of ``itemsize`` bytes: the onset rows,
    the kernel's tables (K3 v2: the plan's base, uint16 residuals, flat
    table and windows; K3: the flat int32 traveltimes) and inv_available
    read once, the three [n_tiles, S] outputs written once; O adds and
    four more operations a real node and sample; and the gather floor,
    the real nodes' O x S reads of ``itemsize`` bytes from shared
    memory."""

    plan = s.plan
    n_onsets, t_len = s.onsets.shape
    n_real = int(plan.valid.sum())
    if v2:
        tiles = plan.n_tiles
        tables = (4 * tiles * n_onsets + 2 * tiles * cm.GLOBAL_V2_TILE
                  * n_onsets + 4 * tiles * cm.GLOBAL_V2_TILE + 8 * n_onsets)
    else:
        tiles = -(-plan.n_nodes // cm.K3_TILE)
        tables = 4 * plan.n_nodes * n_onsets
    nbytes = (itemsize * n_onsets * t_len + tables + itemsize
              + (2 * itemsize + 4) * tiles * s.nsamples)
    return {**roofline(nbytes, n_real * s.nsamples * (n_onsets + 4),
                       _rate(itemsize)),
            "gather_floor_ms": itemsize * n_real * n_onsets * s.nsamples
            / SMEM_BYTES_PER_S * 1e3}


def _columns(s, length):
    """Onset samples a window of ``length`` touches, over the rows."""

    tt = np.asarray(s.tt)
    return int((tt.max(axis=0).astype(np.int64) - tt.min(axis=0)
                + length).sum())


def plan_bytes(s):
    """The plan's int32 residuals of the real nodes and its base."""

    return (4 * int(s.plan.valid.sum()) * s.plan.n_onsets
            + 4 * s.plan.base.size)


def marginalise_bound(s, length, itemsize=8):
    """M1's bound: the plan's int32 traveltimes, the onset columns the
    window touches and the mask read once, the [n_nodes] output written
    once; O adds and three more operations a node and window sample."""

    n_onsets, n_nodes = s.plan.n_onsets, s.plan.n_nodes
    nbytes = plan_bytes(s) + itemsize * (_columns(s, length) + n_onsets
                                         + n_nodes)
    return roofline(nbytes, n_nodes * length * (n_onsets + 3),
                    _rate(itemsize))


def map_bound(s, itemsize=8):
    """M2 simple's bound: as M1's, with the [n_nodes, S] map written."""

    n_onsets, n_nodes = s.plan.n_onsets, s.plan.n_nodes
    nbytes = plan_bytes(s) + itemsize * (_columns(s, s.nsamples) + n_onsets
                                         + n_nodes * s.nsamples)
    return roofline(nbytes, n_nodes * s.nsamples * (n_onsets + 3),
                    _rate(itemsize))


def rel(got, ref):
    return float(((got.double() - ref.double()).abs()
                  / ref.double().abs()).max())


def coa_at(s, idx):
    """The float64 coalescence at node ``idx[t]`` for each scan sample t,
    ``exp(sum_o L[o, fsmp + tt[idx, o] + t] / available)`` in order."""

    onsets_log = migrate._prepare_onsets(s.onsets, s.mask)
    rows = s.tt_dev[idx.long()].long()
    t = torch.arange(s.nsamples, device=s.device)
    acc = torch.zeros(s.nsamples, dtype=F64, device=s.device)
    for o in range(onsets_log.shape[0]):
        acc = acc + onsets_log[o][s.fsmp + rows[:, o] + t]
    return torch.exp(acc / s.available)


def hold_detect(s, got, ref=None):
    """A float64 detect result ``got`` (max_coa, max_idx, coa_sum) against
    the plain version on the card (``ref``, computed where None): {"max",
    "sum" relative errors, "argmax_equal" share, "tie" (the coalescence at
    the kernel's node against the max where they differ), "max_abs_err",
    "ok"}."""

    if ref is None:
        ref = plain_detect(s)
    torch.cuda.synchronize()
    differ = got[1] != ref[1]
    tie = 0.0
    if bool(differ.any()):
        at = coa_at(s, got[1])
        tie = rel(at[differ], ref[0][differ])
    rec = {"max": rel(got[0], ref[0]), "sum": rel(got[2], ref[2]),
           "argmax_equal": float((~differ).double().mean()), "tie": tie,
           "max_abs_err": float((got[0] - ref[0]).abs().max())}
    rec["ok"] = bool(got[0].dtype == F64 and rec["max"] <= RTOL
                     and rec["sum"] <= RTOL and rec["tie"] <= RTOL)
    return rec


def plain_detect(s):
    """The plain float64 version on the card: ``detect_reduce``."""

    return migrate.detect_reduce(s.onsets, s.tt_dev, s.mask, s.available,
                                 s.fsmp, s.nsamples, s.plan.n_nodes)


def plain_ms(fn, reps=2):
    return float(np.median([ekb.cuda_ms(fn, 1, warmup=1)
                            for _ in range(reps)]))


def resources(name):
    """ptxas's registers and spills of a float64 kernel."""

    report = _build.kernel_resources(F64_KERNELS[name])
    return {k: v for entry in report.values() for k, v in entry.items()
            if k != "wgmma_serialized"}


def v3_form(det):
    """The F64_KERNELS name of K3 v3 f64's form on the detector's tables:
    one stage an item, or streamed."""

    ring = cm.global_v3_layout(det.layout)
    return "k3_v3_f64" if ring.stage_passes == 2 else "k3_v3_f64_streamed"


def detect_case(s, label, reps=REPS):
    """Detect on the case: the route's float64 kernel (where K3 v2 f64's
    ring holds the plan K3 v3 f64 if one stage holds an item, else K3 v2
    f64; elsewhere K3 f64) and the other two held to the plain version,
    K3 v3 f64's per-tile tmax and targ to K3 v2 f64's bit for bit, then
    all timed in turns with the float32 forms. ``v3_launches`` counts the
    route's one call. Returns a record."""

    det, det32 = s.det[F64], s.det[torch.float32]
    log64, inv64 = s.prepared[F64]
    log32, inv32 = s.prepared[torch.float32]
    ref = plain_detect(s)
    record = {"label": label, "nodes": s.plan.n_nodes,
              "onsets": s.plan.n_onsets, "nsamples": s.nsamples,
              "r_span": s.plan.r_span, "v2_refusal": det.v2_refusal,
              "k3_f64": hold_detect(s, cm.combine_flat_tiles(
                  *det.launch_v1(log64, inv64)), ref),
              "k3_f64_bound": detect_bound(s, 8, v2=False),
              "k3_bound": detect_bound(s, 4, v2=False),
              "k3_f64_resources": resources("k3_f64")}
    fns = {"k3_f64": lambda: det.launch_v1(log64, inv64),
           "k3": lambda: det32.launch_v1(log32, inv32)}
    if det.tables is not None:
        cm.reset_launches()
        got = det.reduce_log(log64, inv64)
        torch.cuda.synchronize()
        launched = {k: n for k, n in cm.launches.items() if n}
        route = ("migrate_detect_global_v3_f64" if det.v3_route
                 else "migrate_detect_global_v2_f64")
        record["route_kernel"] = route
        record["k3_v3_f64"] = hold_detect(
            s, got if det.v3_route else cm.combine_brick_tiles(
                *det.launch_v3(log64, inv64)), ref)
        record["k3_v2_f64"] = hold_detect(s, cm.combine_brick_tiles(
            *det.launch_v2(log64, inv64)), ref)
        v3, v2 = det.launch_v3(log64, inv64), det.launch_v2(log64, inv64)
        torch.cuda.synchronize()
        ring = cm.global_v3_layout(det.layout)
        record.update(
            v3_launches=launched,
            v3_equal_to_v2={"tmax": torch.equal(v3[0], v2[0]),
                            "targ": torch.equal(v3[1], v2[1]),
                            "tsum": rel(v3[2], v2[2])},
            k3_v3_f64_bound=detect_bound(s, 8),
            k3_v2_f64_bound=detect_bound(s, 8),
            k3_v2_bound=detect_bound(s, 4),
            layout={k: getattr(det.layout, k) for k in (
                "shape", "group", "n_stages", "stage_floats", "smem")},
            v3_ring=vars(ring),
            v3_blocks_per_sm=cm.global_v3_blocks_per_sm(det.layout,
                                                        s.device),
            blocks_per_sm=cm.global_v2_blocks_per_sm(det.layout, s.device),
            k3_v3_f64_resources=resources(v3_form(det)),
            k3_v2_f64_resources=resources("k3_v2_f64"))
        record["k3_v3_f64"]["ok"] = bool(
            record["k3_v3_f64"]["ok"] and launched == {route: 1}
            and record["v3_equal_to_v2"]["tmax"]
            and record["v3_equal_to_v2"]["targ"]
            and record["v3_equal_to_v2"]["tsum"] <= RTOL)
        del got, v3, v2
        fns = {"k3_v3_f64": lambda: det.launch_v3(log64, inv64),
               "k3_v2_f64": lambda: det.launch_v2(log64, inv64),
               "k3_v2": lambda: det32.launch(log32, inv32), **fns}
        if det32.tables is None:
            del fns["k3_v2"]
    turns = ekb.in_turns(fns, reps)
    if det.tables is not None:
        # The launches since K3 v3 f64's hold: K3 v2 f64's as its yardstick
        record["case_launches"] = {k: n for k, n in cm.launches.items()
                                   if n}
    record["turns_ms"] = turns
    record["ms"] = {name: float(np.mean(ms)) for name, ms in turns.items()}
    record["plain_ms"] = plain_ms(lambda: plain_detect(s))
    record["ok"] = all(record[k]["ok"] for k in (
        "k3_f64", "k3_v2_f64", "k3_v3_f64") if k in record)
    print(f"{label}: " + json.dumps({k: v for k, v in record.items()
                                     if k != "turns_ms"}))
    return record


def _m1(det, prepared, start, length):
    """M1 (M1 f64 on float64 onsets) on the detector's plan: the yardstick
    of the ring, and locate's pass 2 where the ring refuses the plan."""

    return lambda: cm.migrate_marginalise_cuda(
        prepared[0], det.base, det.fine, det.valid, det.perm, prepared[1],
        det.fsmp, det.nsamples, start, length, det.n_nodes, det._max_shift)


def _m2_simple(det, prepared):
    return lambda: cm.migrate_map_cuda(
        prepared[0], det.base, det.fine, det.valid, det.perm, prepared[1],
        det.fsmp, det.nsamples, det.n_nodes, det._max_shift)


def _in_turns(s, ring_case, old_name, old, f32, reps, **held):
    """The turns of a locate case: where the ring takes the plan,
    ``ring_case`` (exp_ring's m1_case or m2_case: the ring held to its
    plain version and to the old float64 kernel, timed in turns with it
    as ``old_name``, with its other grid and with the float32 forms
    ``f32``); else the old float64 kernel ``old`` in turns with ``f32``.
    Returns (the ring's record or None, {name: mean ms})."""

    det = s.det[F64]
    if det.ring_refusal is None:
        rec = ring_case(exp_ring.setup(det, *s.prepared[F64], "double"),
                        reps=reps, extra=f32, **held)
        turns = rec["turns_ms"]
    else:
        rec, turns = None, ekb.in_turns({old_name: old, **f32}, reps)
    return rec, {name: float(np.mean(ms)) for name, ms in turns.items()}


def marginalise_case(s, start, length, reps=REPS):
    """Locate's pass 2 in double over ``[start, start + length)``: the
    route's kernel (M1 ring f64 where K3 v2 f64's tables hold the plan,
    else M1 f64) and M1 f64 held to the plain ``migrate_marginalise`` in
    float64 (within 1e-12 of its maximum, the same peak node); then M1
    ring f64 through ``exp_ring.m1_case`` (held to its plain version and
    to M1 f64, bit for bit at a window of one chunk; its own bound and
    gather floor), in turns with M1 f64 and, on the float32 detector, M1
    ring and M1. Returns a record: ``ring`` exp_ring's, ``ms`` the means
    in turns ("ring" M1 ring f64, "m1" M1 f64, "ring_other" the ring's
    other grid, "m1_ring_f32", "m1_f32")."""

    det, det32 = s.det[F64], s.det[torch.float32]
    p64, p32 = s.prepared[F64], s.prepared[torch.float32]
    ring = det.ring_refusal is None
    cm.reset_launches()
    got = det.marginalise(*p64, start, length)
    torch.cuda.synchronize()
    launched = {k: n for k, n in cm.launches.items() if n}
    m1_f64 = _m1(det, p64, start, length)()
    ref = migrate.migrate_marginalise(s.onsets, s.tt_dev, s.mask,
                                      s.available, s.fsmp, s.nsamples, start,
                                      length)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max() / ref.max())
    m1_err = float((m1_f64 - ref).abs().max() / ref.max())
    same_peak = int(torch.argmax(got)) == int(torch.argmax(ref))
    dtype = got.dtype
    record = {"window": [start, length], "launches": launched,
              "err_of_max": err,
              "max_abs_err": float((got - ref).abs().max()),
              "m1_f64_err_of_max": m1_err,
              "m1_f64_max_abs_err": float((m1_f64 - ref).abs().max()),
              "same_peak": same_peak}
    del got, m1_f64, ref
    f32 = {"m1_f32": _m1(det32, p32, start, length)}
    if det32.ring_refusal is None:
        f32["m1_ring_f32"] = lambda: det32.marginalise(*p32, start, length)
    record["ring"], record["ms"] = _in_turns(
        s, lambda c, **kw: exp_ring.m1_case(c, (start, length), **kw),
        "m1", _m1(det, p64, start, length), f32, reps)
    record.update(
        plain_ms=plain_ms(lambda: migrate.migrate_marginalise(
            s.onsets, s.tt_dev, s.mask, s.available, s.fsmp, s.nsamples,
            start, length)),
        m1_f64_bound=marginalise_bound(s, length, 8),
        m1_bound=marginalise_bound(s, length, 4),
        resources=resources("m1_f64"),
        ok=bool(dtype == F64 and err <= RTOL and m1_err <= RTOL
                and same_peak
                and launched == {cm.typed("migrate_marginalise_ring" if ring
                                          else "migrate_marginalise",
                                          F64): 1}))
    print(f"m1 f64 {start}+{length}: " + json.dumps(
        {k: v for k, v in record.items() if k != "ring"}))
    return record


def map_case(s, reps=REPS):
    """The map path in double over the case's samples: the route's kernel
    (M2 ring f64 where K3 v2 f64's tables hold the plan, else M2 simple
    f64) and M2 simple f64 held to the plain ``migrate_map`` in float64
    (within 1e-12 relative); then M2 ring f64 through ``exp_ring.m2_case``
    (held to its plain version, to M2 simple f64 bit for bit and its
    per-sample max to K3 v2 f64's tmax bit for bit; its own bound and
    gather floor), in turns with M2 simple f64 and, on the float32
    detector, M2 ring and M2 simple. Returns a record as
    :func:`marginalise_case`'s ("ring", "m2_simple" M2 simple f64,
    "ring_other", "m2_ring_f32", "m2_simple_f32")."""

    det, det32 = s.det[F64], s.det[torch.float32]
    p64, p32 = s.prepared[F64], s.prepared[torch.float32]
    ring = det.ring_refusal is None
    cm.reset_launches()
    got = det.map(*p64)
    torch.cuda.synchronize()
    launched = {k: n for k, n in cm.launches.items() if n}
    ref = migrate.migrate_map(s.onsets, s.tt_dev, s.mask, s.available,
                              s.fsmp, s.nsamples)
    record = {"nsamples": s.nsamples, "launches": launched,
              "dtype": str(got.dtype), "max_rel_err": rel(got, ref),
              "max_abs_err": float((got - ref).abs().max())}
    del got
    simple = _m2_simple(det, p64)()
    record["m2_simple_f64_max_rel_err"] = rel(simple, ref)
    del simple, ref
    torch.cuda.empty_cache()
    f32 = {"m2_simple_f32": _m2_simple(det32, p32)}
    if det32.ring_refusal is None:
        f32["m2_ring_f32"] = lambda: det32.map(*p32)
    tmax = (cm.combine_brick_tiles(*det.launch_v2(*p64))[0] if ring
            else None)
    record["ring"], record["ms"] = _in_turns(
        s, exp_ring.m2_case, "m2_simple", _m2_simple(det, p64), f32, reps,
        tmax=tmax)
    record.update(
        plain_ms=plain_ms(lambda: migrate.migrate_map(
            s.onsets, s.tt_dev, s.mask, s.available, s.fsmp, s.nsamples)),
        m2_simple_f64_bound=map_bound(s, 8),
        m2_simple_bound=map_bound(s, 4),
        resources=resources("m2_simple_f64"),
        ok=bool(record["dtype"] == str(F64) and record["max_rel_err"] <= RTOL
                and record["m2_simple_f64_max_rel_err"] <= RTOL
                and launched == {cm.typed("migrate_map_ring" if ring
                                          else "migrate_map", F64): 1}))
    print(f"m2 f64 {s.nsamples}: " + json.dumps(
        {k: v for k, v in record.items() if k != "ring"}))
    return record


def wide_traveltimes(span=WIDE_SPAN):
    """A 4 x 4 x 4 grid of two onsets with one traveltime of ``span`` - 1
    samples: a residual span past K3 v2 f64's ring."""

    tt = np.zeros((64, 2), np.int32)
    tt[1, 1] = span - 1
    return tt, (4, 4, 4)


def icequake_setup(nsamples, device):
    dims, tt, onsets = workload(nsamples, fsmp=ekb.FSMP)
    return setup(tt, dims, ekb.FSMP, nsamples, device,
                 onsets=onsets.astype(np.float64))


def flat_setup(nsamples, device):
    """The Icequake window's traveltimes as a flat table, planned as the
    routed ``ops`` functions plan it: an (N, 1, 1) grid of 256-node flat
    runs."""

    dims, tt, onsets = workload(nsamples, fsmp=ekb.FSMP)
    grid = (tt.shape[0], 1, 1)
    plan = cm.DetectPlan(tt, grid, tile=cm.GLOBAL_V2_TILE,
                         brick_shape=(cm.GLOBAL_V2_TILE, 1, 1))
    return setup(tt, grid, ekb.FSMP, nsamples, device,
                 onsets=onsets.astype(np.float64), plan=plan)


def alignment_probe(s, reps=REPS):
    """Where a warp's shared-memory reads of a window start: K3 v3 f64,
    K3 v2 f64 and K3 v2 on the case's tables as built (each read at the
    node's entry, any element), and on copies of them whose entries are
    rounded down to a multiple of 2 doubles (16 bytes) or of 128 bytes (16
    doubles, 32 floats), in turns. The rounded tables read other samples,
    so only their times are kept: the cost of a read's alignment in the
    gather. Returns {name: mean ms}."""

    det, det32 = s.det[F64], s.det[torch.float32]
    log64, inv64 = s.prepared[F64]
    log32, inv32 = s.prepared[torch.float32]

    def rounded(tables, unit):
        res = tables.res.to(torch.int32)
        return SimpleNamespace(**{**vars(tables), "res": (
            res - res % unit).to(torch.uint16).contiguous()})

    fns = {}
    for name, unit in (("as_built", 1), ("16_bytes", 2), ("128_bytes", 16)):
        t64 = det.tables if unit == 1 else rounded(det.tables, unit)
        t32 = det32.tables if unit == 1 else rounded(det32.tables,
                                                     2 * unit)
        fns[f"k3_v3_f64_{name}"] = functools.partial(
            cm.migrate_detect_global_v3_f64_cuda, log64, det.base, inv64,
            s.fsmp, s.nsamples, t64, det._max_shift)
        fns[f"k3_v2_f64_{name}"] = functools.partial(
            cm.migrate_detect_global_v2_cuda, log64, det.base, inv64, s.fsmp,
            s.nsamples, t64, det._max_shift)
        fns[f"k3_v2_{name}"] = functools.partial(
            cm.migrate_detect_global_v2_cuda, log32, det32.base, inv32,
            s.fsmp, s.nsamples, t32, det32._max_shift)
    turns = ekb.in_turns(fns, reps)
    ms = {name: float(np.mean(t)) for name, t in turns.items()}
    print("alignment probe: " + json.dumps(ms))
    return ms


def form_probe(s, reps=REPS):
    """K3 v3 f64 on the case in each form it is built for
    (``GLOBAL_V3_FORMS``: nodes a warp a round and the onset loop's
    unrolling) on its ring, in turns with K3 v2 f64; each held
    to K3 v2 f64's max and argmax bit for bit. Returns {name: mean ms}."""

    det = s.det[F64]
    log64, inv64 = s.prepared[F64]
    fns = {f"k3_v3_f64_npp{npp}_unroll{unroll}": functools.partial(
        cm.migrate_detect_global_v3_f64_cuda, log64, det.base, inv64,
        s.fsmp, s.nsamples, det.tables, det._max_shift, (npp, unroll))
        for npp, unroll in cm.GLOBAL_V3_FORMS}
    fns["k3_v2_f64"] = lambda: det.launch_v2(log64, inv64)
    want = fns["k3_v2_f64"]()
    for name in list(fns)[:-1]:
        got = fns[name]()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    turns = ekb.in_turns(fns, reps)
    ms = {name: float(np.mean(t)) for name, t in turns.items()}
    print("form probe: " + json.dumps(ms))
    return ms


def run(device="cuda", detect_only=False):
    """Every case (the detect cases alone with ``detect_only``); returns
    {name: record}."""

    rng = np.random.default_rng(2040)
    out = {}
    ice = icequake_setup(ICEQUAKE_NSAMPLES, device)
    out["icequake"] = detect_case(ice, "icequake")
    del ice
    out["flat"] = detect_case(flat_setup(ICEQUAKE_NSAMPLES, device),
                              "icequake flat table")
    torch.cuda.empty_cache()
    out["f3"] = detect_case(setup(f3_traveltimes(rng), F3_NODES, F3_FSMP,
                                  F3_NSAMPLES, device, rng=rng), "f3")
    if detect_only:
        return out
    tt, dims = wide_traveltimes()
    out["wide"] = detect_case(setup(tt, dims, 200, 300, device, rng=rng,
                                    n_masked=0), f"span {WIDE_SPAN}")
    locate = icequake_setup(61, device)
    out["m1_30"] = marginalise_case(locate, 15, 30)
    out["m2_61"] = map_case(locate)
    out["m1_300"] = marginalise_case(icequake_setup(300, device), 0, 300)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("exp_double: CUDA is not available")
    _build.load_library()
    print(torch.cuda.get_device_name(0))
    print(json.dumps({name: resources(name) for name in F64_KERNELS}))
    if "--align" in argv:
        alignment_probe(icequake_setup(ICEQUAKE_NSAMPLES, "cuda"))
        return
    if "--forms" in argv:
        form_probe(icequake_setup(ICEQUAKE_NSAMPLES, "cuda"))
        rng = np.random.default_rng(2040)
        form_probe(setup(f3_traveltimes(rng), F3_NODES, F3_FSMP,
                         F3_NSAMPLES, "cuda", rng=rng))
        return
    records = run(detect_only="--detect" in argv)
    bad = [name for name, r in records.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"exp_double: {bad} do not hold")


if __name__ == "__main__":
    sys.exit(main())
