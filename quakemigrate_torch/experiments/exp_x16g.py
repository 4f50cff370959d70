# -*- coding: utf-8 -*-
"""
The stride-16 table detect kernel on the tensor cores ("X16G"), at the
day-scale Icequake window (71 x 64 x 57 nodes, 24 onsets, 30,000 samples)
and the TPU experiment's plan (tile 512, bricks 8 x 8 x 8).

The counterpart of the TPU experiment ``experiments/exp_x16g.py``
(``main``), with the CUDA kernel of :mod:`quakemigrate_torch.ops.cuda_x16g`.
K1 (``full`` of the breakdown) runs first at the
same plan as the yardstick. Then the hi/lo tables are built on the card
(timed apart), and the cases run:

- ``expand`` and ``fuse``: the full contract in the two forms of the B
  operand, each held to K1's outputs within the hi/lo bound
  (:func:`~quakemigrate_torch.ops.x16g.hilo_bound`), argmax
  tie-consistent at that bound;
- ``onlymain``, ``nomain``, ``noreduce``: the TPU ``main``'s ablations
  (with ``aligned``, which launches the same kernel as without), and
  ``nosel``, ``noonehot``, ``noexp``, the TPU kernel's other ablations,
  in the expand form; ``noreduce`` is held to its plain version, and the
  ablations that zero an operand of the products (``onlymain``,
  ``nosel``, ``noonehot``, ``noexp``) exactly to their closed form
  (:func:`~quakemigrate_torch.ops.x16g.zero_acc_reference`);
- ``v2`` (``csrc/migrate_detect_x16g_v2.cu``, ``wgmma``), held as
  ``expand`` and ``fuse`` are, with the share of its outputs equal to
  ``expand``'s; its ablations ``v2_nomain`` (no products: exactly the
  closed form) and ``v2_noreduce`` (held to its plain version). Then
  ``v2``, ``fuse`` and ``expand`` timed in turns (v2, fuse, expand,
  expand, fuse, v2), with v2's share of the tensor-core floor and its
  registers and spills from the compiler's report.

Each line gives CUDA-event milliseconds per launch, G/s = nodes x onsets
x samples per second, microseconds per (tile, 128-sample) step, TFLOP/s of
the one-hot products (4 K flop per padded node and padded sample, K = 16
sum A_o), and the checksum drift ``tmax.sum() + tsum.sum() + targ.sum()``
against K1's, as the TPU experiment prints it; then the resident blocks
per SM of every form. Requires CUDA; exits non-zero without it.

    python3 -m quakemigrate_torch.experiments.exp_x16g

"""

import argparse
import sys

import torch

from quakemigrate_torch import _build
from quakemigrate_torch.experiments import exp_kernel_breakdown as ekb
from quakemigrate_torch.experiments import exp_x16
from quakemigrate_torch.ops import cuda_x16g as cg
from quakemigrate_torch.ops import x16g
from quakemigrate_torch.ops.cuda_migrate import (
    SBLK,
    detect_blocks_per_sm,
    migrate_detect_cuda,
)
from quakemigrate_torch.util import round_up

NSAMPLES = ekb.NSAMPLES
TILE, BRICK = exp_x16.TILE, exp_x16.BRICK
# name -> (fuse, ablate)
CASES = {
    "expand": (False, "full"),
    "fuse": (True, "full"),
    "onlymain": (False, "onlymain"),
    "nomain": (False, "nomain"),
    "noreduce": (False, "noreduce"),
    "nosel": (False, "nosel"),
    "noonehot": (False, "noonehot"),
    "noexp": (False, "noexp"),
}
ABLATION_CASES = tuple(name for name, (_, ablate) in CASES.items()
                       if ablate != "full")
# v2's cases: name -> ablate
V2_CASES = {"v2": "full", "v2_nomain": "nomain", "v2_noreduce": "noreduce"}
# v2 and v1's full forms, timed in turns
TURNS = ("v2", "fuse", "expand")
TIE_RTOL = 1e-5
# Dense bf16 tensor-core peak of one H100 SXM at 700 W (NVIDIA's data
# sheet): the floor of the one-hot products
TC_FLOP_PER_S = 989e12
V2_KERNEL = "qm_migrate_detect_x16g_v2_kernel"


def setup(nsamples=NSAMPLES, device="cuda"):
    """The day-scale workload at the TPU experiment's plan
    (:func:`exp_x16.setup`) with its 16-aligned plan ``p`` on the card."""

    s = exp_x16.setup(nsamples, device)
    s.p = cg.plan_on_device(s.plan, s.device)
    s.k = 16 * s.p.a_sum
    s.flops = 4 * s.k * s.plan.n_tiles * s.plan.tile * round_up(nsamples,
                                                                 SBLK)
    return s


def tables(s):
    """(hi, lo, want, a_pad) of the setup's onsets, built on the card."""

    onsets_log, _, _, _, _, fsmp, nsamples = s.args
    return cg.build_inputs(s.p, onsets_log, fsmp, nsamples)


def launch(s, inputs, name):
    """The launch of case ``name`` on the setup's tables ``inputs``."""

    hi, lo, want, _ = inputs
    if name in V2_CASES:
        return cg.migrate_detect_x16g_v2_cuda(s.p, hi, lo, want, s.args[4],
                                              s.nsamples,
                                              ablate=V2_CASES[name])
    fuse, ablate = CASES[name]
    return cg.migrate_detect_x16g_cuda(s.p, hi, lo, want, s.args[4],
                                       s.nsamples, fuse=fuse, ablate=ablate)


def coa_at(args, idx):
    """The float32 contract's coalescence at the local node idx[tile, t]
    of each tile, from the kernel arguments ``args``."""

    onsets_log, base, fine, valid, inv_available, fsmp, nsamples = args
    t = torch.arange(nsamples, device=onsets_log.device)
    idx = idx.long()
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for o in range(base.shape[1]):
        cols = fsmp + base[:, o, None] + fine[:, o, :].gather(1, idx)
        acc = acc + onsets_log[o][cols + t]
    return torch.exp(acc * inv_available) * valid.gather(1, idx)


def hold_to_full(full, outs, args, bound, name):
    """tmax and tsum within ``bound`` of K1's, relative; the contract's
    coalescence at the kernel's argmax within 2 bound + TIE_RTOL of K1's
    max. Returns (tmax err, tsum err, tie err)."""

    def rel(a, b):
        return ((a - b).abs() / b.abs()).max().item()

    errs = (rel(outs[0], full[0]), rel(outs[2], full[2]),
            rel(coa_at(args, outs[1]), full[0]))
    limits = (bound, bound, 2 * bound + TIE_RTOL)
    for what, err, limit in zip(("tmax", "tsum", "argmax tie"), errs, limits):
        if not err <= limit:
            raise RuntimeError(f"x16g {name}: {what} differs from K1 by {err} "
                               f"relative, over {limit}")
    return errs


def hold_noreduce(s, inputs, outs):
    """``noreduce`` against its plain version: acc of nodes 0 and 2 within
    1e-5 relative (or absolute below 1), node 1's truncation within 1.
    Returns the largest absolute error."""

    hi, lo, want, a_pad = inputs
    ref = x16g.detect_reduce_x16g_reference(
        hi, lo, a_pad, s.p.base16_dev, s.p.fine16, s.p.valid, s.args[4],
        s.nsamples, ablate="noreduce")
    err = max(((o - r).abs() / r.abs().clamp(min=1.0)).max().item()
              for o, r in ((outs[0], ref[0]), (outs[2], ref[2])))
    arg_err = (outs[1] - ref[1]).abs().max().item()
    if not (err <= 1e-5 and arg_err <= 1):
        raise RuntimeError(f"x16g noreduce: error {err}, node 1 {arg_err}")
    return max((o.float() - r.float()).abs().max().item()
               for o, r in zip(outs, ref))


def hold_zero_acc(s, outs, name):
    """An ablation that zeroes an operand of the products against its
    closed form, exactly. Returns the largest absolute error (0)."""

    ref = x16g.zero_acc_reference(s.p.valid, s.nsamples)
    for what, o, r in zip(("tmax", "targ", "tsum"), outs, ref):
        if not torch.equal(o, r):
            raise RuntimeError(f"x16g {name}: {what} differs from its closed "
                               "form")
    return 0.0


def in_turns(s, inputs, names=TURNS):
    """CUDA-event milliseconds of each case of ``names``, timed in turns
    a, b, c, c, b, a: {name: [first, second]}."""

    ms = {name: [] for name in names}
    for name in list(names) + list(names)[::-1]:
        ms[name].append(ekb.cuda_ms(lambda: launch(s, inputs, name)))
    return ms


def v2_resources():
    """Registers and spill bytes of v2's compiled kernels (the compiler's
    report), the largest over its ablations, and whether ptxas serialized
    any of their wgmma."""

    report = _build.kernel_resources(V2_KERNEL)
    if not report:
        raise RuntimeError(f"no {V2_KERNEL} in the compiler's report")
    return {key: max(r[key] for r in report.values())
            for key in ("registers", "spill_stores", "spill_loads",
                        "wgmma_serialized")}


def run(s):
    """K1 FULL, then the table build and every case, held and timed;
    then v2 and v1's forms in turns. Returns (records by name, inputs)."""

    plan, p = s.plan, s.p
    print(f"x16g: tile {plan.tile}, {plan.n_tiles} tiles, {s.nsamples} "
          f"samples, K = 16 x {p.a_sum} = {s.k}, A_o in "
          f"{sorted(set(p.a_counts))}, {s.n_steps} steps; shared memory "
          f"{cg.x16g_smem(p.n_onsets, p.a_sum, p.a_max, False)} (expand), "
          f"{cg.x16g_smem(p.n_onsets, p.a_sum, p.a_max, True)} (fuse), "
          f"{cg.x16g_v2_smem(p.a_sum)} (v2) bytes")
    full = migrate_detect_cuda(*s.args, plan.r_span)
    records = {"full": ekb._record(
        s, "full (K1)", ekb.cuda_ms(lambda: migrate_detect_cuda(
            *s.args, plan.r_span)),
        blocks_per_sm=detect_blocks_per_sm(plan.n_onsets, plan.r_span,
                                           s.device))}
    full_ms = records["full"]["ms"]
    ref_sum = exp_x16.checksum(full)
    inputs = tables(s)
    table_ms = ekb.cuda_ms(lambda: tables(s))
    print(f"tables: {table_ms:.4f} ms (hi and lo, {tuple(inputs[0].shape)} "
          "bf16 each)")
    bound = x16g.hilo_bound(s.args[0], s.args[4])
    cases = {name: ablate for name, (_, ablate) in CASES.items()}
    cases.update(V2_CASES)
    expand_outs = None
    for name, ablate in cases.items():
        outs = launch(s, inputs, name)
        extra = {}
        if ablate == "full":
            errs = hold_to_full(full, outs, s.args, bound, name)
            blocks = (cg.x16g_v2_blocks_per_sm(p.a_sum, s.device)
                      if name in V2_CASES else cg.x16g_blocks_per_sm(
                          p.n_onsets, p.a_sum, p.a_max, CASES[name][0],
                          s.device))
            extra = {"max_rel_err_tmax": errs[0], "max_rel_err_tsum": errs[1],
                     "tie_rel_err": errs[2], "bound": bound,
                     "max_abs_err": (outs[0] - full[0]).abs().max().item(),
                     "blocks_per_sm": blocks}
            if name == "expand":
                expand_outs = outs
            elif name == "v2":
                extra["equal_to_expand"] = [
                    (a == b).float().mean().item()
                    for a, b in zip(outs, expand_outs)]
        elif ablate == "noreduce":
            extra = {"max_abs_err": hold_noreduce(s, inputs, outs)}
        elif ablate in x16g.ZERO_ACC_ABLATIONS or name == "v2_nomain":
            extra = {"max_abs_err": hold_zero_acc(s, outs, name)}
        chk = exp_x16.checksum(outs)
        ms = ekb.cuda_ms(lambda: launch(s, inputs, name))
        records[name] = ekb._record(
            s, name, ms, full_ms, drift=abs(chk - ref_sum) / abs(ref_sum),
            tflops=s.flops / (ms * 1e9), **extra)
    turns = in_turns(s, inputs)
    floor_ms = s.flops / TC_FLOP_PER_S * 1e3
    v2 = records["v2"]
    v2.update(turns_ms=turns["v2"], ms=sum(turns["v2"]) / 2,
              v1_turns_ms={name: turns[name] for name in TURNS[1:]},
              tc_floor_ms=floor_ms, **v2_resources())
    v2["tflops"] = s.flops / (v2["ms"] * 1e9)
    v2["tc_floor_share"] = floor_ms / v2["ms"]
    for name, rec in records.items():
        print(f"  {name}: drift {rec.get('drift', 0.0):.2e}, "
              f"{rec.get('tflops', 0.0):.1f} TFLOP/s, blocks per SM "
              f"{rec.get('blocks_per_sm', 'n/a')}")
    print("  in turns (ms): " + ", ".join(
        f"{name} {ms[0]:.4f} / {ms[1]:.4f}" for name, ms in turns.items()))
    print(f"  v2: {v2['ms']:.4f} ms, {v2['tflops']:.1f} TFLOP/s, "
          f"{100 * v2['tc_floor_share']:.1f} % of the tensor-core floor "
          f"({floor_ms:.4f} ms); {v2['registers']} registers, spills "
          f"{v2['spill_stores']} / {v2['spill_loads']} bytes, wgmma "
          f"serialized: {v2['wgmma_serialized']}; outputs equal to expand "
          f"(tmax, targ, tsum) {v2['equal_to_expand']}")
    print(f"  hi/lo bound {bound:.3e}")
    records["tables"] = {"name": "tables", "ms": table_ms}
    torch.cuda.synchronize()
    return records, inputs


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_x16g: CUDA is not available")
    print(torch.cuda.get_device_name(0))
    run(setup())


if __name__ == "__main__":
    sys.exit(main())
