# -*- coding: utf-8 -*-
"""
Cost breakdown of the detect kernel on the card: the wrappers of its
ablations (of K1 and of K1 v2), of a resident-staging variant and of a
pipelined variant, and their plain PyTorch versions.

Counterpart of the TPU experiment ``experiments/exp_kernel_breakdown.py``
and its three kernels:

- ``_kernel`` (K1 with pieces removed) ->
  :func:`migrate_detect_ablate_cuda`, ``csrc/migrate_detect.cu`` as a
  template on the variant, so FULL is K1 itself;
- ``_resident_kernel`` (a column block staged once per sweep) ->
  :func:`migrate_detect_resident_cuda`, ``csrc/migrate_detect_resident.cu``;
- ``_deep_kernel`` (an n-deep prefetch queue) ->
  :func:`migrate_detect_pipelined_cuda`, ``csrc/migrate_detect_pipelined.cu``.

The resident and pipelined kernels keep K1's contract
exactly, so their plain version is
:func:`~quakemigrate_torch.ops.cuda_migrate.detect_reduce_plan_reference`.
Each ablation has its own contract (:data:`ABLATIONS`,
:func:`detect_reduce_ablate_reference`). Every wrapper takes CUDA tensors
only and counts its launches in :data:`launches`.

"""

import torch

from .cuda_migrate import (
    NWARPS,
    SBLK,
    SMEM_LIMIT,
    check_kernel_args,
    check_smem,
    detect_reduce_plan_reference,
    empty_outputs,
    launch_kernel,
    launch_staged,
    launch_v2,
    plan_acc_chunks,
    span_offsets,
)

# Ablation variants, in the order of csrc/detect_core.cuh's QmVariant:
#   full      the production contract
#   noexp     coa = acc * inv_available * valid (no exp)
#   noargmax  the contract with targ = 0
#   noreduce  tmax = acc of local node 0, tsum = acc of node 1, targ = 0
#             (no exp, no valid, no reduction over nodes)
#   nogather  tmax = tsum = sum_o L[o, fsmp + base[i, o] + t], targ = 0
#             (the staged windows at residual 0; no per-node reads)
# The TPU experiment's ``k128`` (the bf16 hi/lo halves fused into one
# contraction) has no counterpart: the port keeps no split table.
ABLATIONS = ("full", "noexp", "noargmax", "noreduce", "nogather")

# The ablations K1 v2 (csrc/migrate_detect_v2.cu) is built for.
V2_ABLATIONS = ("full", "noreduce", "nogather")

# Pipeline depths the pipelined kernel is built for.
STAGES = (2, 3, 4)

# Launches of each kernel, counted by its wrapper where it launches.
launches = {
    "migrate_detect_ablate": 0,
    "migrate_detect_v2_ablate": 0,
    "migrate_detect_resident": 0,
    "migrate_detect_pipelined": 0,
}

_RED_FLOATS = 3 * NWARPS * SBLK


def reset_launches():
    for name in launches:
        launches[name] = 0


def detect_reduce_ablate_reference(onsets_log, base, fine, valid,
                                   inv_available, fsmp, nsamples, variant,
                                   max_elements=2**23):
    """
    Plain PyTorch version of the ablation ``variant`` (one of
    :data:`ABLATIONS`) of the detect kernel, with the contract listed
    there. Returns (tmax f32, targ int32, tsum f32), each
    [n_tiles, nsamples].

    """

    if variant not in ABLATIONS:
        raise ValueError(f"unknown variant {variant!r}; one of {ABLATIONS}")
    if variant == "full":
        return detect_reduce_plan_reference(
            onsets_log, base, fine, valid, inv_available, fsmp, nsamples,
            max_elements,
        )
    n_tiles = base.shape[0]
    zeros = torch.zeros((n_tiles, nsamples), dtype=torch.int32,
                        device=onsets_log.device)
    if variant == "nogather":
        t = torch.arange(nsamples, device=onsets_log.device)
        acc = torch.zeros((n_tiles, nsamples), dtype=onsets_log.dtype,
                          device=onsets_log.device)
        for o in range(base.shape[1]):
            acc = acc + onsets_log[o][fsmp + base[:, o, None].long() + t]
        return acc, zeros, acc.clone()

    tmax, targ, tsum = [], [], []
    for c0, acc in plan_acc_chunks(onsets_log, base, fine, fsmp, nsamples,
                                   max_elements):
        if variant == "noreduce":
            tmax.append(acc[:, 0])
            tsum.append(acc[:, 1])
            continue
        coa = acc * inv_available
        if variant != "noexp":
            coa = torch.exp(coa)
        coa = coa * valid[c0:c0 + len(acc), :, None]
        if variant == "noargmax":
            tmax.append(torch.amax(coa, dim=1))
        else:
            arg = torch.argmax(coa, dim=1)
            tmax.append(coa.gather(1, arg[:, None])[:, 0])
            targ.append(arg.to(torch.int32))
        tsum.append(torch.sum(coa, dim=1))
    targ = torch.cat(targ) if targ else zeros
    return torch.cat(tmax), targ, torch.cat(tsum)


def _check_geometry(tile, nsamples):
    if tile % NWARPS:
        raise ValueError(f"tile ({tile}) must be a multiple of {NWARPS}")
    if nsamples < 1:
        raise ValueError(f"bad geometry: nsamples {nsamples}")


def migrate_detect_ablate_cuda(onsets_log, base, fine, valid, inv_available,
                               fsmp, nsamples, r_span, variant):
    """
    Launch K1's ablation ``variant`` (one of
    :data:`ABLATIONS`; "full" is K1) on tensors on the
    card. Returns (tmax f32, targ int32, tsum f32), each [n_tiles,
    nsamples], asynchronously on the current stream.

    """

    if variant not in ABLATIONS:
        raise ValueError(f"unknown variant {variant!r}; one of {ABLATIONS}")
    outs = launch_staged(
        "qm_migrate_detect_ablate", onsets_log, base, fine, valid,
        inv_available, fsmp, nsamples, r_span, ABLATIONS.index(variant),
    )
    launches["migrate_detect_ablate"] += 1
    return outs


def v2_ablate_reference(onsets_log, base, fine, valid, inv_available, fsmp,
                        nsamples, variant):
    """
    Plain PyTorch version of K1 v2's ablation ``variant`` (one of
    :data:`V2_ABLATIONS`): K1's (:func:`detect_reduce_ablate_reference`),
    except that ``noreduce`` gives 0 where local node 0 (tmax) or node 1
    (tsum) is padding, whose gather K1 v2 skips.

    """

    if variant not in V2_ABLATIONS:
        raise ValueError(f"unknown variant {variant!r}; one of "
                         f"{V2_ABLATIONS}")
    tmax, targ, tsum = detect_reduce_ablate_reference(
        onsets_log, base, fine, valid, inv_available, fsmp, nsamples, variant)
    if variant == "noreduce":
        tmax = torch.where(valid[:, :1] != 0, tmax, 0.0)
        tsum = torch.where(valid[:, 1:2] != 0, tsum, 0.0)
    return tmax, targ, tsum


def migrate_detect_v2_ablate_cuda(onsets_log, base, fine16, valid,
                                  inv_available, fsmp, nsamples, span_off,
                                  win_floats, variant):
    """
    Launch K1 v2's ablation ``variant`` (one of :data:`V2_ABLATIONS`;
    "full" is K1 v2 itself) on tensors on the card, with the arguments of
    :func:`~quakemigrate_torch.ops.cuda_migrate.migrate_detect_v2_cuda`.
    Returns (tmax f32, targ int32, tsum f32), each [n_tiles, nsamples],
    asynchronously on the current stream.

    """

    if variant not in V2_ABLATIONS:
        raise ValueError(f"unknown variant {variant!r}; one of "
                         f"{V2_ABLATIONS}")
    outs = launch_v2(
        "qm_migrate_detect_v2_ablate", onsets_log, base, fine16, valid,
        inv_available, fsmp, nsamples, span_off, win_floats,
        ABLATIONS.index(variant),
    )
    launches["migrate_detect_v2_ablate"] += 1
    return outs


def resident_smem(n_onsets, gwidth):
    """Shared-memory bytes of one resident-staging block."""

    return 4 * (n_onsets * gwidth + _RED_FLOATS + n_onsets)


def resident_groups(base, r_span, max_group=8):
    """
    Group size of the resident-staging kernel for a plan's ``base``
    ([n_tiles, O] int32 tensor, any device): the largest power of two up
    to ``max_group`` whose union windows fit one block's shared memory.
    A group is ``group`` consecutive tiles (brick order); its union window
    of onset o starts at the group's smallest base, and ``gwidth`` is the
    one stride of every window: the largest base spread of any group and
    onset, plus ``r_span + SBLK``. Returns (group, gbase int32 [n_groups,
    O] on base's device, gwidth). Raises if even one tile per group does
    not fit.

    """

    n_tiles, n_onsets = base.shape
    group = 1 << (max(1, int(max_group)).bit_length() - 1)
    while group >= 1:
        n_groups = -(-n_tiles // group)
        pad = n_groups * group - n_tiles
        # padding repeats the last tile: no effect on a group's min or max
        b = torch.cat([base, base[-1:].expand(pad, n_onsets)])
        b = b.reshape(n_groups, group, n_onsets)
        gbase = b.amin(dim=1)
        gwidth = int((b.amax(dim=1) - gbase).max()) + r_span + SBLK
        if resident_smem(n_onsets, gwidth) <= SMEM_LIMIT:
            return group, gbase.to(torch.int32).contiguous(), gwidth
        group //= 2
    raise ValueError(
        f"resident staging needs {resident_smem(n_onsets, gwidth)} bytes of "
        f"shared memory even for one tile per group ({n_onsets} onsets x "
        f"{gwidth} floats), over the {SMEM_LIMIT} a block may use"
    )


def migrate_detect_resident_cuda(onsets_log, base, fine, valid, inv_available,
                                 fsmp, nsamples, group, gbase, gwidth):
    """
    Launch the resident-staging kernel on tensors on the card, with the
    group geometry of :func:`resident_groups`. K1's
    contract; returns (tmax f32, targ int32, tsum f32), each [n_tiles,
    nsamples], asynchronously on the current stream.

    """

    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine, valid, inv_available
    )
    _check_geometry(tile, nsamples)
    n_groups = -(-n_tiles // group)
    if (gbase.device != onsets_log.device or gbase.dtype != torch.int32
            or gbase.shape != (n_groups, n_onsets)
            or not gbase.is_contiguous()):
        raise ValueError(
            f"gbase must be a contiguous int32 [{n_groups}, {n_onsets}] "
            f"tensor on {onsets_log.device}"
        )
    if gwidth <= SBLK:
        raise ValueError(f"gwidth ({gwidth}) must exceed {SBLK}")
    check_smem(resident_smem(n_onsets, gwidth),
               f"union windows ({n_onsets} onsets x {gwidth} floats)")
    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        "qm_migrate_detect_resident", onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), gbase.data_ptr(),
        fine.data_ptr(), valid.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, group, fsmp,
        nsamples, gwidth,
    )
    launches["migrate_detect_resident"] += 1
    return outs


def pipelined_smem(n_onsets, slot_floats, n_stages):
    """Shared-memory bytes of one pipelined block."""

    return 4 * (((n_onsets + 4) & ~3) + _RED_FLOATS + n_stages * slot_floats)


def check_pipelined_args(onsets_log, base, fine, valid, inv_available,
                         nsamples, span_off, slot_floats, n_stages):
    """The checks of :func:`check_kernel_args`, and the slot layout and
    shared memory of the pipelined kernel at ``n_stages``. Returns
    (n_onsets, t_len, n_tiles, tile)."""

    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine, valid, inv_available
    )
    _check_geometry(tile, nsamples)
    if (span_off.device != onsets_log.device or span_off.dtype != torch.int32
            or span_off.shape != (n_onsets + 1,)):
        raise ValueError(
            f"span_off must be an int32 [{n_onsets + 1}] tensor on "
            f"{onsets_log.device}"
        )
    if slot_floats < n_onsets * (SBLK + 1):
        raise ValueError(f"slot_floats ({slot_floats}) is too small")
    check_smem(pipelined_smem(n_onsets, slot_floats, n_stages),
               f"{n_stages} slots of {slot_floats} floats")
    return n_onsets, t_len, n_tiles, tile


def migrate_detect_pipelined_cuda(onsets_log, base, fine, valid,
                                  inv_available, fsmp, nsamples, span_off,
                                  slot_floats, n_stages, blocks_per_sm=2):
    """
    Launch the pipelined kernel on tensors on the card: a persistent grid
    of at most ``blocks_per_sm`` blocks per SM (0: as many as fit), each
    with an ``n_stages``-deep cp.async ring of staged windows laid out by
    ``span_off`` (the int32 [O + 1] of :func:`span_offsets`, on the card;
    ``slot_floats`` its last entry, passed so that sizing the launch
    reads nothing back from the card). K1's contract;
    returns (tmax f32, targ int32, tsum f32), each [n_tiles, nsamples],
    asynchronously on the current stream.

    """

    if n_stages not in STAGES:
        raise ValueError(f"n_stages ({n_stages}) must be one of {STAGES}")
    n_onsets, t_len, n_tiles, tile = check_pipelined_args(
        onsets_log, base, fine, valid, inv_available, nsamples, span_off,
        slot_floats, n_stages,
    )
    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        "qm_migrate_detect_pipelined", onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), span_off.data_ptr(),
        fine.data_ptr(), valid.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, fsmp,
        nsamples, slot_floats, n_stages, blocks_per_sm,
    )
    launches["migrate_detect_pipelined"] += 1
    return outs
