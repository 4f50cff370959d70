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
  :func:`migrate_detect_resident_cuda`, ``csrc/migrate_detect_resident.cu``,
  and its redesign on K1 v2's gather core with TMA-fed staging,
  :func:`migrate_detect_resident_v2_cuda`,
  ``csrc/migrate_detect_resident_v2.cu`` (E1b v2);
- ``_deep_kernel`` (an n-deep prefetch queue) ->
  :func:`migrate_detect_pipelined_cuda`, ``csrc/migrate_detect_pipelined.cu``,
  and its redesign, :func:`migrate_detect_pipelined_v2_cuda`,
  ``csrc/migrate_detect_pipelined_v2.cu`` (E1c v2).

The resident and pipelined kernels keep K1's contract
exactly, so their plain version is
:func:`~quakemigrate_torch.ops.cuda_migrate.detect_reduce_plan_reference`.
The v2 kernels read a host slab of window offsets built once per plan
(:func:`pipelined_v2_tables`, :func:`resident_v2_tables`); their plain
versions (:func:`pipelined_v2_reference`, :func:`resident_v2_reference`)
gather through the same slab and window layout.
Each ablation has its own contract (:data:`ABLATIONS`,
:func:`detect_reduce_ablate_reference`). Every wrapper takes CUDA tensors
only and counts its launches in :data:`launches`.

"""

from types import SimpleNamespace

import numpy as np
import torch

from quakemigrate_torch.util import round_up
from .cuda_migrate import (
    NWARPS,
    SBLK,
    SMEM_LIMIT,
    TMA_ALIGN,
    blocks_per_sm,
    check_kernel_args,
    check_smem,
    detect_reduce_plan_reference,
    empty_outputs,
    launch_kernel,
    launch_staged,
    launch_v2,
    plan_acc_chunks,
    reduce_acc_chunks,
    row_pitch,
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

# The v2 kernels on K1 v2's gather core (csrc/migrate_detect_pipelined_v2.cu,
# csrc/migrate_detect_resident_v2.cu): a tiled TMA load lands 128-byte
# aligned, so every staged window starts at a multiple of TMA_ALIGN
# floats; the resident kernel stages its union windows in boxes of
# RESIDENT_V2_BOX floats. E1c v2 is built for 2, 3 and 4 stages (its
# ablations for 2).
RESIDENT_V2_BOX = 32
PIPELINED_V2_STAGES = (2, 3, 4)

# Shared memory of one SM on Hopper (228 KB) and what the card reserves
# of it for each resident block: how many blocks of a size fit an SM. E1b
# v2's group is the largest that keeps RESIDENT_V2_MIN_BLOCKS blocks (32
# warps) an SM.
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024
RESIDENT_V2_MIN_BLOCKS = 4

# Launches of each kernel, counted by its wrapper where it launches.
launches = {
    "migrate_detect_ablate": 0,
    "migrate_detect_v2_ablate": 0,
    "migrate_detect_resident": 0,
    "migrate_detect_pipelined": 0,
    "migrate_detect_pipelined_v2": 0,
    "migrate_detect_resident_v2": 0,
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


def blocks_that_fit(smem):
    """Blocks of ``smem`` bytes of dynamic shared memory that shared
    memory lets one SM hold."""

    return SM_SMEM // (smem + BLOCK_RESERVED_SMEM)


def _slab(entry, what):
    """The uint16 slab [n_tiles, tile, round_up(O, 8)] of window offsets
    ``entry`` (int64 [n_tiles, tile, O]); padding entries 0. Raises if an
    entry does not fit 16 bits."""

    n_tiles, tile, n_onsets = entry.shape
    if entry.max() >= 2**16:
        raise ValueError(
            f"{what}: a window offset reaches {int(entry.max())}, beyond the "
            "uint16 slab (2**16); use fewer onsets or smaller bricks"
        )
    slab = np.zeros((n_tiles, tile, round_up(n_onsets, 8)), np.uint16)
    slab[..., :n_onsets] = entry
    return slab


def pipelined_v2_layout(r_spans):
    """
    Window layout of E1c v2 for a plan's per-onset residual spans: (stride,
    box). Each onset's window is one TMA box of ``box`` floats at ``o *
    stride`` in a ring slot: the largest ``r_spans[o] + SBLK``, + 3 for a
    start rounded down to a multiple of 4 floats (TMA's inner coordinate
    is 16-byte aligned), rounded up to 4; ``stride`` is ``box`` rounded up
    to :data:`TMA_ALIGN`. Raises where a box would exceed TMA's 256
    elements.

    """

    box = round_up(max(r_spans) + 3 + SBLK, 4)
    if box > 256:
        raise ValueError(
            f"E1c v2 stages a window of {box} floats per onset, over TMA's "
            f"256-element box; the plan's residual span {max(r_spans)} must "
            f"be at most {253 - SBLK}"
        )
    return round_up(box, TMA_ALIGN), box


def pipelined_v2_slab(fine16, base, fsmp, stride, box):
    """
    E1c v2's slab for scans that start at ``fsmp``: uint16 [n_tiles, tile,
    round_up(O, 8)], entry ``o * stride + a[i, o] + fine[n, o]``, where
    ``a = (fsmp + base) & 3`` is how far the window's first column, fsmp
    + base[i, o] (+ a multiple of SBLK), lies past the multiple of 4 that
    the kernel loads from; ``fine16`` is the node-major residual table of
    :class:`~quakemigrate_torch.ops.cuda_migrate.DetectPlan`. Raises if an
    entry reaches 2**16 or a read (entry + SBLK) leaves its window of
    ``box`` floats.

    """

    fine = np.asarray(fine16).astype(np.int64)
    n_onsets = fine.shape[2]
    local = (fsmp + np.asarray(base).astype(np.int64))[:, None, :] % 4 + fine
    if fine.min() < 0 or local.max() + SBLK > box:
        raise ValueError(
            f"a read at offset {int(local.max())} leaves its {box}-float "
            "window"
        )
    return _slab(np.arange(n_onsets) * stride + local, "E1c v2")


def pipelined_v2_tables(plan, fsmp, device):
    """E1c v2's tables for a
    :class:`~quakemigrate_torch.ops.cuda_migrate.DetectPlan` and scans
    starting at ``fsmp``: a namespace with the slab (on ``device``),
    stride, box and fsmp."""

    stride, box = pipelined_v2_layout(plan.r_spans)
    slab = pipelined_v2_slab(plan.fine16, plan.base, fsmp, stride, box)
    return SimpleNamespace(slab=torch.from_numpy(slab).to(device),
                           stride=stride, box=box, fsmp=fsmp)


def resident_v2_smem(n_onsets, tile, win_floats):
    """Shared-memory bytes of one E1b v2 block: 128 bytes of alignment
    slack, ``win_floats`` of union windows, two slab buffers (each the
    larger of the slab and the reduction scratch), two valid buffers and
    3 mbarriers."""

    buf = max(2 * tile * round_up(n_onsets, 8), 4 * _RED_FLOATS)
    return 128 + 4 * win_floats + 2 * buf + 8 * tile + 24


def resident_v2_groups(base, r_spans, tile, max_group=8):
    """
    Group size and union layout of E1b v2 for a plan's ``base`` (int32
    [n_tiles, O]): the largest power of two up to ``max_group`` whose
    block fits :data:`RESIDENT_V2_MIN_BLOCKS` to an SM
    (:func:`blocks_that_fit`).
    A group is ``group`` consecutive tiles; its union window of onset o
    starts near ``gbase[g, o]``, the group's smallest base, and spans the
    largest base spread of onset o over the groups + 3 (the start is
    rounded down to a multiple of 4 floats) + ``r_spans[o] + SBLK``
    floats, rounded up to :data:`TMA_ALIGN`. Returns (group, gbase int32
    [n_groups, O], uoff int32 [O + 1], the windows' offsets; uoff[O] is
    their size in floats). Raises if not even one tile per group fits.

    """

    base = np.asarray(base)
    n_tiles, n_onsets = base.shape
    group = 1 << (max(1, int(max_group)).bit_length() - 1)
    while group >= 1:
        n_groups = -(-n_tiles // group)
        # padding repeats the last tile: no effect on a group's min or max
        b = np.concatenate([base, np.repeat(base[-1:], n_groups * group
                                            - n_tiles, axis=0)])
        b = b.reshape(n_groups, group, n_onsets)
        gbase = b.min(axis=1)
        spread = (b.max(axis=1) - gbase).max(axis=0)
        widths = round_up(spread + 3 + np.asarray(r_spans) + SBLK, TMA_ALIGN)
        uoff = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
        smem = resident_v2_smem(n_onsets, tile, int(uoff[-1]))
        if (blocks_that_fit(smem) >= RESIDENT_V2_MIN_BLOCKS
                and uoff[-1] < 2**16
                and smem <= SMEM_LIMIT):
            return group, gbase.astype(np.int32), uoff
        group //= 2
    raise ValueError(
        f"E1b v2 needs {smem} bytes of shared memory a block even for one "
        f"tile a group, so fewer than {RESIDENT_V2_MIN_BLOCKS} blocks fit "
        "an SM"
    )


def resident_v2_slab(fine16, base, gbase, uoff, group, fsmp):
    """
    E1b v2's slab and window table for scans that start at ``fsmp``: (slab
    uint16 [n_tiles, tile, round_up(O, 8)], entry ``woff[i, o] + fine[n,
    o]``; woff int32 [n_tiles, O] = ``uoff[o] + fsmp + base[i, o] - c``,
    tile i's window of onset o inside the union, whose first column c is
    ``fsmp + gbase[i // group, o]`` rounded down to a multiple of 4).
    Raises if an entry reaches 2**16 or a read (entry + SBLK) leaves its
    union window.

    """

    base = np.asarray(base).astype(np.int64)
    uoff = np.asarray(uoff).astype(np.int64)
    gcol = (fsmp + np.asarray(gbase).astype(np.int64)) // 4 * 4
    woff = uoff[:-1] + fsmp + base - gcol[np.arange(len(base)) // group]
    entry = woff[:, None, :] + np.asarray(fine16).astype(np.int64)
    if (woff < uoff[:-1]).any() or (
            entry.max(axis=1) + SBLK > uoff[1:]).any():
        raise ValueError("a read leaves its union window")
    return _slab(entry, "E1b v2"), woff.astype(np.int32)


def resident_v2_tables(plan, fsmp, device, max_group=8):
    """E1b v2's tables for a
    :class:`~quakemigrate_torch.ops.cuda_migrate.DetectPlan` and scans
    starting at ``fsmp``: a namespace with group, gbase, uoff, slab and
    woff (tensors on ``device``), win_floats (``uoff[-1]``) and fsmp."""

    group, gbase, uoff = resident_v2_groups(plan.base, plan.r_spans,
                                            plan.tile, max_group)
    slab, woff = resident_v2_slab(plan.fine16, plan.base, gbase, uoff, group,
                                  fsmp)

    def put(a):
        return torch.from_numpy(a).to(device)

    return SimpleNamespace(group=group, gbase=put(gbase), uoff=put(uoff),
                           slab=put(slab), woff=put(woff),
                           win_floats=int(uoff[-1]), fsmp=fsmp)


def _slab_acc_chunks(onsets_log, col0, local, nsamples, max_elements):
    """The v2 kernels' gather in plain PyTorch: ``(c0, acc)`` chunks of
    ``acc[c, n, t] = sum_o L[o, col0[c0+c, o] + local[c0+c, n, o] + t]``,
    onsets in order o = 0..O-1, where ``col0`` is a window's first column
    and ``local`` a read's offset inside it."""

    n_tiles, tile, n_onsets = local.shape
    t = torch.arange(nsamples, device=onsets_log.device)
    chunk = max(1, max_elements // (tile * nsamples))
    for c0 in range(0, n_tiles, chunk):
        b = col0[c0:c0 + chunk].long()
        f = local[c0:c0 + chunk]
        acc = torch.zeros((b.shape[0], tile, nsamples),
                          dtype=onsets_log.dtype, device=onsets_log.device)
        for o in range(n_onsets):
            cols = b[:, o, None, None] + f[:, :, o, None] + t
            acc = acc + onsets_log[o][cols]
        yield c0, acc


def _check_tables_fsmp(tables, fsmp):
    if tables.fsmp != fsmp:
        raise ValueError(f"the tables were built for fsmp {tables.fsmp}, "
                         f"not {fsmp}")


def pipelined_v2_reference(onsets_log, base, valid, inv_available, fsmp,
                           nsamples, tables, max_elements=2**23):
    """
    Plain PyTorch version of E1c v2 (K1's contract) through its tables
    (:func:`pipelined_v2_tables`): onset o's window starts at column
    ``(fsmp + base[i, o]) & ~3`` (+ s0) and sits at ``o * stride``, so a
    read's offset in it is the slab entry less ``o * stride``. Returns
    (tmax f32, targ int32, tsum f32), each [n_tiles, nsamples].

    """

    _check_tables_fsmp(tables, fsmp)
    n_onsets = base.shape[1]
    col0 = (fsmp + base.long()) // 4 * 4
    local = (tables.slab[..., :n_onsets].long()
             - torch.arange(n_onsets, device=base.device) * tables.stride)
    return reduce_acc_chunks(
        _slab_acc_chunks(onsets_log, col0, local, nsamples, max_elements),
        valid, inv_available,
    )


def resident_v2_reference(onsets_log, valid, inv_available, fsmp, nsamples,
                          tables, max_elements=2**23):
    """
    Plain PyTorch version of E1b v2 (K1's contract) through its tables
    (:func:`resident_v2_tables`): the union window of onset o starts at
    column ``(fsmp + gbase[i // group, o]) & ~3`` (+ s0) and sits at
    ``uoff[o]``, so a read's offset in it is the slab entry less
    ``uoff[o]``. Returns (tmax f32, targ int32, tsum f32), each [n_tiles,
    nsamples].

    """

    _check_tables_fsmp(tables, fsmp)
    t = tables
    n_tiles, n_onsets = t.woff.shape
    gbase = t.gbase[torch.arange(n_tiles, device=t.gbase.device) // t.group]
    col0 = (fsmp + gbase.long()) // 4 * 4
    local = t.slab[..., :n_onsets].long() - t.uoff[:-1].long()
    return reduce_acc_chunks(
        _slab_acc_chunks(onsets_log, col0, local, nsamples, max_elements),
        valid, inv_available,
    )


def pipelined_v2_smem(n_onsets, tile, stride, n_stages):
    """Shared-memory bytes of one E1c v2 block: 128 bytes of alignment
    slack, ``n_stages`` ring slots (each the larger of the O windows of
    ``stride`` floats and the reduction scratch that aliases them), the
    slab, valid and 2 n_stages + 1 mbarriers."""

    slot = max(4 * n_onsets * stride, 4 * _RED_FLOATS)
    return (128 + n_stages * slot + 2 * tile * round_up(n_onsets, 8)
            + 4 * tile + 8 * (2 * n_stages + 1))


def _check_slab_kernel_args(onsets_log, valid, inv_available, nsamples,
                            tables):
    """
    Checks of the v2 kernels' arguments: dtypes, contiguity, shapes that
    agree, 16-byte alignment (TMA and bulk copies), one CUDA device;
    ``tables`` maps each table's name to (tensor, dtype, shape). Returns
    (n_onsets, t_len, n_tiles, tile).

    """

    device = onsets_log.device
    n_onsets, t_len = onsets_log.shape
    n_tiles, tile = valid.shape
    expected = [
        ("onsets_log", onsets_log, torch.float32, (n_onsets, t_len)),
        ("valid", valid, torch.float32, (n_tiles, tile)),
        ("inv_available", inv_available, torch.float32, (1,)),
    ] + [(name, *spec) for name, spec in tables.items()]
    for name, x, dtype, shape in expected:
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be a {dtype} tensor, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if tile % (2 * NWARPS):
        raise ValueError(f"tile ({tile}) must be a multiple of {2 * NWARPS}")
    if nsamples < 1 or -(-nsamples // SBLK) > 65535:
        raise ValueError(f"bad geometry: nsamples {nsamples}")
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    return n_onsets, t_len, n_tiles, tile


def _variant_index(variant):
    if variant not in V2_ABLATIONS:
        raise ValueError(f"unknown variant {variant!r}; one of "
                         f"{V2_ABLATIONS}")
    return ABLATIONS.index(variant)


def migrate_detect_pipelined_v2_cuda(onsets_log, base, valid, inv_available,
                                     fsmp, nsamples, tables, n_stages=2,
                                     variant="full"):
    """
    Launch E1c v2 (``csrc/migrate_detect_pipelined_v2.cu``) on tensors on
    the card: a persistent, tile-major grid with an ``n_stages``-deep TMA
    ring of windows, through the ``tables`` of
    :func:`pipelined_v2_tables` (built for this ``fsmp``). ``variant`` is
    one of :data:`V2_ABLATIONS` ("full": K1's contract, bit for bit; the
    ablations at 2 stages). Returns (tmax f32, targ int32, tsum f32), each
    [n_tiles, nsamples], asynchronously on the current stream.

    """

    index = _variant_index(variant)
    if n_stages not in PIPELINED_V2_STAGES or (
            variant != "full" and n_stages != 2):
        raise ValueError(
            f"n_stages ({n_stages}) must be one of {PIPELINED_V2_STAGES}, "
            "and 2 for an ablation"
        )
    _check_tables_fsmp(tables, fsmp)
    n_tiles, tile = valid.shape
    n_onsets = onsets_log.shape[0]
    n_onsets, t_len, n_tiles, tile = _check_slab_kernel_args(
        onsets_log, valid, inv_available, nsamples, {
            "base": (base, torch.int32, (n_tiles, n_onsets)),
            "slab": (tables.slab, torch.uint16,
                     (n_tiles, tile, round_up(n_onsets, 8))),
        })
    stride, box = tables.stride, tables.box
    if stride % TMA_ALIGN or not SBLK < box <= min(stride, 256) or box % 4:
        raise ValueError(f"bad window layout: stride {stride}, box {box}")
    check_smem(pipelined_v2_smem(n_onsets, tile, stride, n_stages),
               f"{n_stages} slots of {n_onsets} x {stride} floats")
    rows, pitch = row_pitch(onsets_log)
    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        "qm_migrate_detect_pipelined_v2", onsets_log.device,
        rows.data_ptr(), t_len, pitch, base.data_ptr(),
        tables.slab.data_ptr(), valid.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, fsmp,
        nsamples, stride, box, n_stages, index,
    )
    launches["migrate_detect_pipelined_v2"] += 1
    return outs


def migrate_detect_resident_v2_cuda(onsets_log, valid, inv_available, fsmp,
                                    nsamples, tables, variant="full"):
    """
    Launch E1b v2 (``csrc/migrate_detect_resident_v2.cu``) on tensors on
    the card: one block per (group of tiles, sample block), its union
    windows staged once by TMA, through the ``tables`` of
    :func:`resident_v2_tables` (built for this ``fsmp``). ``variant`` is
    one of :data:`V2_ABLATIONS`. Returns (tmax f32, targ int32, tsum
    f32), each [n_tiles, nsamples], asynchronously on the current stream.

    """

    index = _variant_index(variant)
    _check_tables_fsmp(tables, fsmp)
    t = tables
    n_tiles, tile = valid.shape
    n_onsets = onsets_log.shape[0]
    n_groups = -(-n_tiles // max(1, t.group))
    n_onsets, t_len, n_tiles, tile = _check_slab_kernel_args(
        onsets_log, valid, inv_available, nsamples, {
            "gbase": (t.gbase, torch.int32, (n_groups, n_onsets)),
            "uoff": (t.uoff, torch.int32, (n_onsets + 1,)),
            "slab": (t.slab, torch.uint16,
                     (n_tiles, tile, round_up(n_onsets, 8))),
            "woff": (t.woff, torch.int32, (n_tiles, n_onsets)),
        })
    if (t.group < 1 or t.win_floats % TMA_ALIGN
            or not n_onsets * (SBLK + 1) <= t.win_floats < 2**16):
        raise ValueError(f"bad union layout: group {t.group}, win_floats "
                         f"{t.win_floats}")
    check_smem(resident_v2_smem(n_onsets, tile, t.win_floats),
               f"union windows ({t.win_floats} floats)")
    rows, pitch = row_pitch(onsets_log)
    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        "qm_migrate_detect_resident_v2", onsets_log.device,
        rows.data_ptr(), t_len, pitch, t.gbase.data_ptr(), t.uoff.data_ptr(),
        t.slab.data_ptr(), valid.data_ptr(), t.woff.data_ptr(),
        inv_available.data_ptr(), *(x.data_ptr() for x in outs), n_onsets,
        n_tiles, tile, t.group, fsmp, nsamples, t.win_floats, index,
    )
    launches["migrate_detect_resident_v2"] += 1
    return outs


def pipelined_v2_blocks_per_sm(n_onsets, tile, stride, n_stages, device):
    """Resident blocks per SM of E1c v2 (FULL) at a layout and depth."""

    return blocks_per_sm("qm_migrate_detect_pipelined_v2_blocks_per_sm",
                         device, n_onsets, tile, stride, n_stages)


def resident_v2_blocks_per_sm(n_onsets, tile, win_floats, device):
    """Resident blocks per SM of E1b v2 (FULL) at a union layout."""

    return blocks_per_sm("qm_migrate_detect_resident_v2_blocks_per_sm",
                         device, n_onsets, tile, win_floats)
