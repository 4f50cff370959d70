# -*- coding: utf-8 -*-
"""
The shifted-copy detect kernel on the card: v1
(``csrc/migrate_detect_x16.cu``) and its redesign on K1 v2's slab, E2 v2
(``csrc/migrate_detect_x16_v2.cu``); their wrappers, host tables,
shared-memory sizing and occupancy.

Counterpart of the TPU experiment kernel ``_x16_kernel``
(``experiments/exp_x16.py``): each onset's staged window is kept in four
copies shifted by 0..3 floats, so every lane reads four consecutive
samples of a node with one aligned 16-byte load. K1's
contract, exactly; its plain version is
:func:`~quakemigrate_torch.ops.x16.detect_reduce_stride_reference`. The
two layouts of the copies are those of the TPU operand: ``x16a``
(copy-major) and ``x16b`` (onset-major).

E2 v2 reads each node-onset through a host slab of copy offsets
(:func:`x16_v2_tables`), one per layout: the layout lives only in the
slab and in the copy-offset table, and the kernel is the same for both.
Its plain version,
:func:`~quakemigrate_torch.ops.x16.x16_v2_reference`, gathers through
the same slab and layout. Every wrapper takes CUDA tensors only and
counts its launches in :data:`launches`.

"""

from types import SimpleNamespace

import numpy as np
import torch

from quakemigrate_torch.util import round_up
from . import cuda_breakdown as cb
from .cuda_migrate import (
    NWARPS,
    SBLK,
    _check_onset_length,
    blocks_per_sm,
    check_kernel_args,
    check_smem,
    empty_outputs,
    launch_kernel,
)

LAYOUTS = ("x16a", "x16b")

# E2 v2 stages copy 0 of each window by TMA in boxes of X16_V2_BOX floats,
# each landing 128-byte aligned (csrc/migrate_detect_x16_v2.cu: QX2_BOX).
X16_V2_BOX = 32

# Launches of each kernel, counted by its wrapper where it launches.
launches = {"migrate_detect_x16": 0, "migrate_detect_x16_v2": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


def x16_window_floats(r_span):
    """Floats of one shifted copy of a staged window: ``r_span + SBLK``
    rounded up to a multiple of 4, so every copy starts 16-byte aligned."""

    return round_up(r_span + SBLK, 4)


def x16_smem(n_onsets, r_span):
    """Shared-memory bytes of one block, the same in both layouts: four
    copies of every onset's window (the cross-warp reduction reuses
    them). Raises when a block may not have that much."""

    wp = x16_window_floats(r_span)
    smem = 4 * max(4 * n_onsets * wp, 3 * NWARPS * SBLK)
    check_smem(smem, f"four shifted copies of {n_onsets} windows of {wp} "
                     "floats")
    return smem


def x16_blocks_per_sm(n_onsets, r_span, layout, device):
    """Resident blocks per SM of the layout's kernel at a plan, from the
    occupancy API."""

    return blocks_per_sm("qm_migrate_detect_x16_blocks_per_sm", device,
                         n_onsets, r_span, LAYOUTS.index(layout))


def migrate_detect_x16_cuda(onsets_log, base, fine, valid, inv_available,
                            fsmp, nsamples, r_span, max_shift, layout="x16a"):
    """
    Launch the shifted-copy kernel in ``layout`` (one of :data:`LAYOUTS`)
    on tensors on the card. ``max_shift`` is the plan's largest traveltime
    (``DetectPlan.max_shift``): the onset block must hold ``fsmp +
    nsamples + max_shift`` samples. Returns (tmax f32, targ int32, tsum
    f32), each [n_tiles, nsamples], asynchronously on the current stream.

    """

    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
    n_onsets, t_len, n_tiles, tile = check_kernel_args(
        onsets_log, base, fine, valid, inv_available
    )
    if tile % NWARPS:
        raise ValueError(f"tile ({tile}) must be a multiple of {NWARPS}")
    if nsamples < 1 or r_span < 1:
        raise ValueError(f"bad geometry: nsamples {nsamples}, r_span {r_span}")
    _check_onset_length(onsets_log, fsmp, nsamples, max_shift)
    x16_smem(n_onsets, r_span)
    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        "qm_migrate_detect_x16", onsets_log.device,
        onsets_log.data_ptr(), t_len, base.data_ptr(), fine.data_ptr(),
        valid.data_ptr(), inv_available.data_ptr(),
        *(x.data_ptr() for x in outs), n_onsets, n_tiles, tile, fsmp,
        nsamples, r_span, LAYOUTS.index(layout),
    )
    launches["migrate_detect_x16"] += 1
    return outs


def x16_v2_layout(r_spans, layout):
    """
    Where E2 v2 keeps the four shifted copies of each onset's window in
    shared memory, for a plan's per-onset residual spans: (coff int32
    [4, O], the float offset of copy c of onset o; widths int32 [O];
    copy_floats, the copies' size in floats). Copy c of onset o holds
    ``widths[o] = round_up(r_spans[o] + 3 + SBLK, 4)`` floats (the window,
    + 3 for a start rounded down to a multiple of 4 floats); copy 0 is
    loaded in boxes of :data:`X16_V2_BOX` floats, so it starts at a
    multiple of 32 floats and has room for its width rounded up to 32.
    ``x16a`` (copy-major) puts every onset's copy 0 first, then copies 1,
    2 and 3; ``x16b`` (onset-major) puts onset o's four copies together,
    each group starting at a multiple of 32 floats.

    """

    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
    widths = round_up(np.asarray(r_spans, np.int64) + 3 + SBLK, 4)
    room0 = round_up(widths, X16_V2_BOX)

    def starts(sizes):
        return np.concatenate([[0], np.cumsum(sizes)[:-1]])

    coff = np.zeros((4, len(widths)), np.int64)
    if layout == "x16a":
        coff[0] = starts(room0)
        for c in (1, 2, 3):
            coff[c] = room0.sum() + (c - 1) * widths.sum() + starts(widths)
        copy_floats = round_up(int(room0.sum() + 3 * widths.sum()),
                               X16_V2_BOX)
    else:
        group = round_up(room0 + 3 * widths, X16_V2_BOX)
        coff[0] = starts(group)
        for c in (1, 2, 3):
            coff[c] = coff[0] + room0 + (c - 1) * widths
        copy_floats = int(group.sum())
    return coff.astype(np.int32), widths.astype(np.int32), copy_floats


def x16_v2_slab(fine16, base, fsmp, coff, widths):
    """
    E2 v2's slab for scans that start at ``fsmp``: uint16 [n_tiles, tile,
    round_up(O, 8)], entry ``coff[c, o] + u - c`` with ``u = a + fine[n,
    o]``, ``a = (fsmp + base[i, o]) & 3`` (how far the window's first
    column lies past the multiple of 4 that the kernel loads from) and
    ``c = u & 3``: the aligned 16-byte read of copy c whose lanes hold
    window samples u + 4 lane .. + 3. Raises if an entry reaches 2**16 or
    a read (u + SBLK) leaves its copy's ``widths[o]`` floats.

    """

    fine = np.asarray(fine16).astype(np.int64)
    u = (fsmp + np.asarray(base).astype(np.int64))[:, None, :] % 4 + fine
    widths = np.asarray(widths).astype(np.int64)
    if fine.min() < 0 or (u + SBLK > widths).any():
        raise ValueError(
            f"a read at offset {int(u.max())} leaves its window of "
            f"{int(widths.min())}-{int(widths.max())} floats"
        )
    c = u % 4
    onset = np.arange(fine.shape[2])
    entry = np.asarray(coff).astype(np.int64)[c, onset] + u - c
    return cb._slab(entry, "E2 v2")


def x16_v2_tables(plan, fsmp, device, layout="x16a"):
    """E2 v2's tables for a
    :class:`~quakemigrate_torch.ops.cuda_migrate.DetectPlan`, scans
    starting at ``fsmp`` and a copy ``layout``: a namespace with the slab
    and ``tab`` (int32 [5, O]: coff [4, O], then the widths) on
    ``device``, copy_floats, layout and fsmp."""

    coff, widths, copy_floats = x16_v2_layout(plan.r_spans, layout)
    slab = x16_v2_slab(plan.fine16, plan.base, fsmp, coff, widths)
    tab = np.concatenate([coff, widths[None]]).astype(np.int32)
    return SimpleNamespace(
        slab=torch.from_numpy(slab).to(device),
        tab=torch.from_numpy(tab).to(device),
        copy_floats=copy_floats, layout=layout, fsmp=fsmp,
    )


def x16_v2_smem(n_onsets, tile, copy_floats):
    """Shared-memory bytes of one E2 v2 block: 128 bytes of alignment
    slack, the copies (or the reduction scratch that aliases them,
    whichever is larger), valid, the block's copy of the table (5 O ints,
    rounded up to 4) and one mbarrier."""

    copies = max(copy_floats, 3 * NWARPS * SBLK)
    return 128 + 4 * copies + 4 * tile + 4 * round_up(5 * n_onsets, 4) + 8


def migrate_detect_x16_v2_cuda(onsets_log, base, valid, inv_available, fsmp,
                               nsamples, tables, variant="full"):
    """
    Launch E2 v2 (``csrc/migrate_detect_x16_v2.cu``) on tensors on the
    card: one block per (node tile, SBLK-sample block), copy 0 of every
    window by TMA, copies 1-3 shifted in shared memory, one 16-byte read
    a node-onset through the ``tables`` of :func:`x16_v2_tables` (built
    for this ``fsmp``; their layout decides where the copies sit).
    ``variant`` is one of ``cuda_breakdown.V2_ABLATIONS`` ("full": K1's
    contract, bit for bit). Returns (tmax f32, targ int32, tsum f32), each
    [n_tiles, nsamples], asynchronously on the current stream.

    """

    index = cb._variant_index(variant)
    cb._check_tables_fsmp(tables, fsmp)
    n_tiles, tile = valid.shape
    n_onsets = onsets_log.shape[0]
    n_onsets, t_len, n_tiles, tile = cb._check_slab_kernel_args(
        onsets_log, valid, inv_available, nsamples, {
            "base": (base, torch.int32, (n_tiles, n_onsets)),
            "slab": (tables.slab, torch.uint16,
                     (n_tiles, tile, round_up(n_onsets, 8))),
            "tab": (tables.tab, torch.int32, (5, n_onsets)),
        })
    copy_floats = tables.copy_floats
    if (copy_floats % X16_V2_BOX
            or not 4 * n_onsets * SBLK <= copy_floats <= 2**16):
        raise ValueError(f"bad copy layout: copy_floats {copy_floats}")
    check_smem(x16_v2_smem(n_onsets, tile, copy_floats),
               f"four shifted copies of {n_onsets} windows ({copy_floats} "
               "floats)")
    rows, pitch = cb._row_pitch(onsets_log)
    outs = empty_outputs(n_tiles, nsamples, onsets_log.device)
    launch_kernel(
        "qm_migrate_detect_x16_v2", onsets_log.device,
        rows.data_ptr(), t_len, pitch, base.data_ptr(),
        tables.slab.data_ptr(), valid.data_ptr(), tables.tab.data_ptr(),
        inv_available.data_ptr(), *(x.data_ptr() for x in outs), n_onsets,
        n_tiles, tile, fsmp, nsamples, copy_floats, index,
    )
    launches["migrate_detect_x16_v2"] += 1
    return outs


def x16_v2_blocks_per_sm(n_onsets, tile, copy_floats, device):
    """Resident blocks per SM of E2 v2 (FULL) at a copy layout, from the
    occupancy API."""

    return blocks_per_sm("qm_migrate_detect_x16_v2_blocks_per_sm", device,
                         n_onsets, tile, copy_floats)
